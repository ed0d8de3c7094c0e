"""KNRM — kernel-pooling neural ranking model (port of
``models/textmatching/knrm.py``).

Reference: zoo/models/textmatching/KNRM.scala:60-192: shared word
embedding for query and doc, cosine translation matrix, RBF kernel
pooling (mu from 0.9 to -0.9 plus exact-match kernel), log-kernel sum
over the query axis, linear score head.

The translation matrix is one batched product (B, Q, D) in float32, as
in the reference (its einsum takes no compute-dtype rounding); the 21
kernels run together on a trailing kernel axis, each element computed as
the reference's loop computes it: ``mu`` and ``2 sigma^2`` are Python
floats rounded to float32 at use.  The norm is the reference's arithmetic,
``sqrt(sum(x * x))`` clamped below at 1e-8, so a zero embedding row has
the reference's backward (not ``F.normalize``'s).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from analytics_zoo_torch.models.common import ZooModel
from analytics_zoo_torch.pipeline.api.keras import Input, Model
from analytics_zoo_torch.pipeline.api.keras.engine import Layer
from analytics_zoo_torch.pipeline.api.keras.layers import (
    Dense, Embedding, WordEmbedding,
)


def _unit_rows(x):
    """``x / max(||x||, 1e-8)`` along the last axis, the norm as
    ``jnp.linalg.norm`` computes it."""
    norm = torch.sqrt(torch.sum(x * x, dim=-1, keepdim=True))
    return x / torch.clamp(norm, min=1e-8)


class KernelPooling(Layer):
    """Cosine translation + RBF kernel pooling."""

    def __init__(self, text1_length: int, kernel_num: int = 21,
                 sigma: float = 0.1, exact_sigma: float = 0.001, **kwargs):
        super().__init__(**kwargs)
        self.text1_length = text1_length
        self.kernel_num = int(kernel_num)
        self.sigma = float(sigma)
        self.exact_sigma = float(exact_sigma)

    def _kernels(self) -> List[Tuple[float, float]]:
        """``(mu, sigma)`` of each kernel, in the reference's order."""
        out = []
        for i in range(self.kernel_num):
            mu = 1.0 / (self.kernel_num - 1) + (2.0 * i) / (
                self.kernel_num - 1) - 1.0
            sigma = self.sigma
            if mu > 1.0 - 1e-6:
                sigma = self.exact_sigma
                mu = 1.0
            out.append((mu, sigma))
        return out

    def _constants(self, device):
        """The kernels' means and 2 sigma^2 on ``device``, made once (a
        host-to-device copy cannot be captured into a CUDA graph)."""
        cache = self.__dict__.setdefault("_consts", {})
        if device not in cache:
            ks = self._kernels()
            cache[device] = (
                torch.tensor([m for m, _ in ks], dtype=torch.float32,
                             device=device),
                torch.tensor([2 * s * s for _, s in ks],
                             dtype=torch.float32, device=device))
        return cache[device]

    def call(self, params, inputs, training=False, rng=None):
        q, d = inputs                       # (B, Q, E), (B, D, E)
        trans = torch.bmm(_unit_rows(q.float()),
                          _unit_rows(d.float()).transpose(1, 2))
        mu, denom = self._constants(trans.device)
        k = torch.exp(-torch.square(trans.unsqueeze(-1) - mu) / denom)
        kq = torch.sum(k, dim=2)                         # (B, Q, K)
        return torch.sum(torch.log1p(kq), dim=1)         # (B, K)

    def compute_output_shape(self, input_shape):
        return (input_shape[0][0], self.kernel_num)


class KNRM(ZooModel):
    def __init__(self, text1_length: int, text2_length: int,
                 vocab_size: int = 10000, embed_size: int = 50,
                 embedding_matrix: Optional[np.ndarray] = None,
                 train_embed: bool = True, kernel_num: int = 21,
                 sigma: float = 0.1, exact_sigma: float = 0.001,
                 target_mode: str = "ranking"):
        self.text1_length = int(text1_length)
        self.text2_length = int(text2_length)
        self.vocab_size = int(vocab_size)
        self.embed_size = int(embed_size)
        self.embedding_matrix = embedding_matrix
        self.train_embed = train_embed
        self.kernel_num = int(kernel_num)
        self.sigma = float(sigma)
        self.exact_sigma = float(exact_sigma)
        assert target_mode in ("ranking", "classification")
        self.target_mode = target_mode
        super().__init__()

    def build_model(self):
        q_in = Input(shape=(self.text1_length,))
        d_in = Input(shape=(self.text2_length,))
        if self.embedding_matrix is not None:
            embed = WordEmbedding(self.embedding_matrix,
                                  trainable=self.train_embed)
        else:
            embed = Embedding(self.vocab_size + 1, self.embed_size,
                              init="uniform")
        q = embed(q_in)
        d = embed(d_in)
        pooled = KernelPooling(self.text1_length, self.kernel_num,
                               self.sigma, self.exact_sigma)([q, d])
        out = Dense(1, activation=(
            "sigmoid" if self.target_mode == "classification" else None))(
            pooled)
        return Model([q_in, d_in], out)

    def score_pairs(self, query_ids: np.ndarray, doc_ids: np.ndarray,
                    batch_size: int = 1024) -> np.ndarray:
        return np.asarray(self.predict(
            [query_ids.astype(np.int32), doc_ids.astype(np.int32)],
            batch_size=batch_size)).ravel()
