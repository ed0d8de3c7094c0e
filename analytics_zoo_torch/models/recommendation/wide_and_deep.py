"""Wide & Deep recommender (port of
``models/recommendation/wide_and_deep.py``).

Reference: zoo/models/recommendation/WideAndDeep.scala:101 and the
feature engineering in Utils.scala:325 — a "wide" linear part over
sparse crossed/base features and a "deep" part over category embeddings
+ continuous columns, joined into class logits.  ``ColumnFeatureInfo``
mirrors the reference's column-spec object.

The wide weights are an embedding table gathered by active-feature
indices and summed, as in the reference.  The graph is the reference's,
layer for layer; its two ``Lambda``s are torch ops on tensors, module
functions rather than closures, so the built net pickles (an NNFrames
``save``).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import List, Sequence

import numpy as np

from analytics_zoo_torch.models.recommendation.recommender import Recommender
from analytics_zoo_torch.pipeline.api.keras import Input, Model
from analytics_zoo_torch.pipeline.api.keras.layers import (
    Dense, Embedding, Flatten, Lambda, Merge,
)


def _sum_columns(t):
    return t.sum(dim=1)


def _column(t, j):
    return t[:, j:j + 1]


@dataclasses.dataclass
class ColumnFeatureInfo:
    """Column spec (ref WideAndDeep ColumnFeatureInfo, Utils.scala)."""
    wide_base_cols: Sequence[str] = ()
    wide_base_dims: Sequence[int] = ()
    wide_cross_cols: Sequence[str] = ()
    wide_cross_dims: Sequence[int] = ()
    indicator_cols: Sequence[str] = ()
    indicator_dims: Sequence[int] = ()
    embed_cols: Sequence[str] = ()
    embed_in_dims: Sequence[int] = ()
    embed_out_dims: Sequence[int] = ()
    continuous_cols: Sequence[str] = ()

    @property
    def wide_dims(self) -> List[int]:
        return list(self.wide_base_dims) + list(self.wide_cross_dims)


class WideAndDeep(Recommender):
    """model_type: "wide_n_deep" | "wide" | "deep"."""

    def __init__(self, class_num: int, column_info: ColumnFeatureInfo,
                 model_type: str = "wide_n_deep",
                 hidden_layers: Sequence[int] = (40, 20, 10)):
        self.class_num = int(class_num)
        self.column_info = column_info
        self.model_type = model_type
        self.hidden_layers = list(hidden_layers)
        super().__init__()

    # ------------------------------------------------------------ building
    def build_model(self):
        info = self.column_info
        inputs = []
        parts = []

        if self.model_type in ("wide", "wide_n_deep"):
            n_wide = len(info.wide_dims)
            if n_wide == 0:
                raise ValueError("wide model needs wide_base/cross cols")
            # one index per wide column, pre-offset into a shared table
            wide_in = Input(shape=(n_wide,))
            inputs.append(wide_in)
            total = int(sum(info.wide_dims)) + 1
            wide_emb = Embedding(total, self.class_num, init="zero")(wide_in)
            wide_out = Lambda(_sum_columns,
                              output_shape=(self.class_num,))(wide_emb)
            parts.append(wide_out)

        if self.model_type in ("deep", "wide_n_deep"):
            deep_parts = []
            n_ind = len(info.indicator_cols)
            n_emb = len(info.embed_cols)
            n_cont = len(info.continuous_cols)
            if n_ind:
                ind_in = Input(shape=(int(sum(info.indicator_dims)),))
                inputs.append(ind_in)
                deep_parts.append(ind_in)
            if n_emb:
                emb_in = Input(shape=(n_emb,))
                inputs.append(emb_in)
                for j in range(n_emb):
                    col = Lambda(functools.partial(_column, j=j),
                                 output_shape=(1,))(emb_in)
                    e = Embedding(int(info.embed_in_dims[j]) + 1,
                                  int(info.embed_out_dims[j]),
                                  init="normal")(col)
                    deep_parts.append(Flatten()(e))
            if n_cont:
                cont_in = Input(shape=(n_cont,))
                inputs.append(cont_in)
                deep_parts.append(cont_in)
            deep = deep_parts[0] if len(deep_parts) == 1 else \
                Merge(mode="concat")(deep_parts)
            for units in self.hidden_layers:
                deep = Dense(units, activation="relu")(deep)
            deep_out = Dense(self.class_num)(deep)
            parts.append(deep_out)

        out = parts[0] if len(parts) == 1 else \
            Merge(mode="sum")(parts)
        return Model(inputs, out)

    # -------------------------------------------------------------- features
    def wide_indices(self, columns: dict) -> np.ndarray:
        """Map raw per-column category ids to offsets into the shared
        wide table (+1 reserves 0 as padding)."""
        info = self.column_info
        cols = list(info.wide_base_cols) + list(info.wide_cross_cols)
        dims = info.wide_dims
        out = []
        offset = 1
        for name, dim in zip(cols, dims):
            v = np.asarray(columns[name]).astype(np.int64) % dim
            out.append(v + offset)
            offset += dim
        return np.stack(out, axis=1).astype(np.int32)

    def features_from_columns(self, columns: dict) -> List[np.ndarray]:
        """Assemble model inputs from a dict of named columns (the
        DataFrame-row → feature path of Utils.scala:325)."""
        info = self.column_info
        feats = []
        if self.model_type in ("wide", "wide_n_deep"):
            feats.append(self.wide_indices(columns))
        if self.model_type in ("deep", "wide_n_deep"):
            if info.indicator_cols:
                blocks = []
                for name, dim in zip(info.indicator_cols,
                                     info.indicator_dims):
                    v = np.asarray(columns[name]).astype(np.int64) % dim
                    oh = np.zeros((len(v), dim), np.float32)
                    oh[np.arange(len(v)), v] = 1.0
                    blocks.append(oh)
                feats.append(np.concatenate(blocks, axis=1))
            if info.embed_cols:
                feats.append(np.stack(
                    [np.asarray(columns[c]).astype(np.int32)
                     for c in info.embed_cols], axis=1))
            if info.continuous_cols:
                feats.append(np.stack(
                    [np.asarray(columns[c]).astype(np.float32)
                     for c in info.continuous_cols], axis=1))
        return feats

    def pair_features(self, user_ids, item_ids):
        raise NotImplementedError(
            "WideAndDeep consumes arbitrary feature columns; use "
            "features_from_columns")
