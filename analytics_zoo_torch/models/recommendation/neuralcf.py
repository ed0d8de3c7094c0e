"""Neural Collaborative Filtering (port of
``models/recommendation/neuralcf.py``).

Reference: zoo/models/recommendation/NeuralCF.scala:45-138 — GMF branch
(elementwise product of user/item embeddings) + MLP branch (concat
embeddings through hidden layers), merged into ``class_num`` logits.
The graph is the reference's, layer for layer, so the auto-names and
the variables' key paths agree (``interop.load_jax_variables``).  Ids
are 1-based; each table has one row more than its id count.  The
embedding gathers are ``index_select`` and their backward a scatter-add
(``index_add_``), XLA's own work in the reference, not a kernel of it.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from analytics_zoo_torch.models.recommendation.recommender import Recommender
from analytics_zoo_torch.pipeline.api.keras import Input, Model
from analytics_zoo_torch.pipeline.api.keras.layers import (
    Dense, Embedding, Flatten, Merge,
)


class NeuralCF(Recommender):
    def __init__(self, user_count: int, item_count: int, class_num: int = 2,
                 user_embed: int = 20, item_embed: int = 20,
                 hidden_layers: Sequence[int] = (40, 20, 10),
                 include_mf: bool = True, mf_embed: int = 20):
        self.user_count = int(user_count)
        self.item_count = int(item_count)
        self.class_num = int(class_num)
        self.user_embed = int(user_embed)
        self.item_embed = int(item_embed)
        self.hidden_layers = list(hidden_layers)
        self.include_mf = include_mf
        self.mf_embed = int(mf_embed)
        super().__init__()

    def build_model(self):
        # ids arrive 1-based as in the reference; tables sized +1
        user_in = Input(shape=(1,))
        item_in = Input(shape=(1,))

        mlp_user = Flatten()(Embedding(
            self.user_count + 1, self.user_embed, init="normal")(user_in))
        mlp_item = Flatten()(Embedding(
            self.item_count + 1, self.item_embed, init="normal")(item_in))
        mlp = Merge(mode="concat")([mlp_user, mlp_item])
        for units in self.hidden_layers:
            mlp = Dense(units, activation="relu")(mlp)

        if self.include_mf:
            mf_user = Flatten()(Embedding(
                self.user_count + 1, self.mf_embed, init="normal")(user_in))
            mf_item = Flatten()(Embedding(
                self.item_count + 1, self.mf_embed, init="normal")(item_in))
            mf = Merge(mode="mul")([mf_user, mf_item])
            joined = Merge(mode="concat")([mf, mlp])
        else:
            joined = mlp
        out = Dense(self.class_num)(joined)   # logits; pair with *_with_logits
        return Model([user_in, item_in], out)

    def pair_features(self, user_ids: np.ndarray, item_ids: np.ndarray):
        return [user_ids.reshape(-1, 1).astype(np.int32),
                item_ids.reshape(-1, 1).astype(np.int32)]
