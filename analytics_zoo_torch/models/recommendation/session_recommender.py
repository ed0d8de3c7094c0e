"""Session-based RNN recommender (port of
``models/recommendation/session_recommender.py``).

Reference: zoo/models/recommendation/SessionRecommender.scala:45-209 —
GRU over the item-click session (optionally + a mean-pooled purchase
history through an MLP), logits over the item vocabulary;
``recommend_for_session`` returns the top-k next items with their
softmax probabilities.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from analytics_zoo_torch.models.common import ZooModel
from analytics_zoo_torch.pipeline.api.keras import Input, Model
from analytics_zoo_torch.pipeline.api.keras.layers import (
    GRU, Dense, Embedding, Lambda, Merge,
)


def _mean_over_time(t):
    return t.mean(dim=1)


class SessionRecommender(ZooModel):
    def __init__(self, item_count: int, item_embed: int = 100,
                 rnn_hidden_layers: Sequence[int] = (40, 20),
                 session_length: int = 5, include_history: bool = False,
                 mlp_hidden_layers: Sequence[int] = (40, 20),
                 history_length: int = 10):
        self.item_count = int(item_count)
        self.item_embed = int(item_embed)
        self.rnn_hidden_layers = list(rnn_hidden_layers)
        self.session_length = int(session_length)
        self.include_history = include_history
        self.mlp_hidden_layers = list(mlp_hidden_layers)
        self.history_length = int(history_length)
        super().__init__()

    def build_model(self):
        session_in = Input(shape=(self.session_length,))
        x = Embedding(self.item_count + 1, self.item_embed,
                      init="uniform")(session_in)
        for h in self.rnn_hidden_layers[:-1]:
            x = GRU(h, return_sequences=True)(x)
        rnn_out = GRU(self.rnn_hidden_layers[-1])(x)
        inputs = [session_in]
        if self.include_history:
            his_in = Input(shape=(self.history_length,))
            inputs.append(his_in)
            h = Embedding(self.item_count + 1, self.item_embed,
                          init="uniform")(his_in)
            # mean-pool purchase history then MLP
            h = Lambda(_mean_over_time, output_shape=(self.item_embed,))(h)
            for units in self.mlp_hidden_layers:
                h = Dense(units, activation="relu")(h)
            rnn_out = Merge(mode="concat")([rnn_out, h])
        out = Dense(self.item_count + 1)(rnn_out)   # logits over items
        return Model(inputs, out)

    # ------------------------------------------------------------ inference
    def recommend_for_session(self, sessions: np.ndarray, max_items: int = 5,
                              zero_based_label: bool = False,
                              history: Optional[np.ndarray] = None,
                              batch_size: int = 1024
                              ) -> List[List[Tuple[int, float]]]:
        """Top ``max_items`` (item id, probability) per session, item ids
        1-based as the model's inputs are (``zero_based_label`` is kept
        for the reference's signature and changes nothing)."""
        x = [sessions.astype(np.int32)]
        if self.include_history:
            if history is None:
                raise ValueError("model was built with history input: "
                                 "pass history=")
            x.append(history.astype(np.int32))
        logits = np.asarray(self.predict(x, batch_size=batch_size))
        e = np.exp(logits - logits.max(axis=-1, keepdims=True))
        probs = e / e.sum(axis=-1, keepdims=True)
        top = np.argsort(-probs, axis=-1)[:, :max_items]
        return [[(int(i), float(p[i])) for i in row]
                for row, p in zip(top, probs)]
