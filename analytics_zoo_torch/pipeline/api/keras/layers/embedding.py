"""Embedding layers (port of ``pipeline/api/keras/layers/embedding.py``):
a gather of rows from a device-resident table; ``WordEmbedding`` takes
its table from pretrained vectors; ``SparseEmbedding`` combines the rows
of each example's id list.

``SparseEmbedding`` keeps the reference's contract: its ids are a dense
(B, T) array padded with -1, not a ``torch.sparse`` tensor, and
``max_norm`` renormalises only the rows looked up, never the table.

``Embedding(parallel_mode="dim")`` splits the embedding dim over the
mesh's ``model`` axis: each rank gathers its columns of the rows looked
up, and the pieces are gathered whole."""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from analytics_zoo_torch.ops.dtypes import get_policy
from analytics_zoo_torch.pipeline.api.keras.engine import Layer, Params


def _take(table: torch.Tensor, x: torch.Tensor):
    """(ids, the rows of ``table`` at ``x``) as the reference's
    ``jnp.take`` gives them: ids cast to int32, a negative id wrapped to
    ``rows + id``, and a NaN row where the id still lies outside the table
    (its gradient dropped).  ids index in int64 here."""
    ids = x.to(torch.int32).long()
    rows = table.shape[0]
    at = torch.where(ids < 0, ids + rows, ids)
    inside = (at >= 0) & (at < rows)
    out = table.index_select(0, at.clamp(0, rows - 1).reshape(-1)).reshape(
        *ids.shape, table.shape[-1])
    return ids, torch.where(inside.unsqueeze(-1), out, float("nan"))


class Embedding(Layer):
    """Integer ids (B, T) -> vectors (B, T, D)."""

    def __init__(self, input_dim: int, output_dim: int, init="uniform",
                 W_regularizer=None, mask_zero: bool = False,
                 parallel_mode: Optional[str] = None, **kwargs):
        super().__init__(**kwargs)
        if parallel_mode not in (None, "dim"):
            raise ValueError("parallel_mode must be None|dim")
        self.parallel_mode = parallel_mode
        self.input_dim = int(input_dim)
        self.output_dim = int(output_dim)
        self.kernel_init = init
        self.mask_zero = mask_zero
        self.W_regularizer = W_regularizer

    def build(self, rng, input_shape) -> Params:
        params: Params = {}
        self.add_weight(params, rng, "embeddings",
                        (self.input_dim, self.output_dim),
                        init=self.kernel_init,
                        regularizer=self.W_regularizer)
        if self.parallel_mode == "dim":
            from analytics_zoo_torch.parallel.mesh import MODEL_AXIS, Shard
            self.param_pspecs["embeddings"] = Shard(MODEL_AXIS, 1)
        return params

    def call(self, params, x, training=False, rng=None):
        table = params["embeddings"]
        group = None
        if self.parallel_mode == "dim":
            from analytics_zoo_torch.parallel import comm
            from analytics_zoo_torch.parallel.mesh import (
                MODEL_AXIS, current_mesh)
            group = current_mesh().group(MODEL_AXIS)
            if group is not None and table.shape[1] == self.output_dim:
                table = comm.local_part(table, group, 1)
        ids, out = _take(table, x)
        if self.mask_zero:
            out = out * (ids != 0).unsqueeze(-1).to(out.dtype)
        if group is not None:
            out = comm.gather_from_group(out, group, -1)
        return out

    def compute_output_shape(self, input_shape):
        return tuple(input_shape) + (self.output_dim,)


class WordEmbedding(Embedding):
    """Embedding initialised from pretrained vectors (GloVe and the
    like), frozen unless ``trainable``: the table carries no gradient."""

    def __init__(self, embedding_matrix, trainable: bool = False, **kwargs):
        mat = np.asarray(embedding_matrix)
        super().__init__(mat.shape[0], mat.shape[1], **kwargs)
        self._pretrained = mat
        self.trainable = trainable

    def build(self, rng, input_shape) -> Params:
        return {"embeddings": torch.as_tensor(
            np.array(self._pretrained), dtype=get_policy().param_dtype)}

    def call(self, params, x, training=False, rng=None):
        emb = params["embeddings"]
        return _take(emb if self.trainable else emb.detach(), x)[1]


class SparseEmbedding(Layer):
    """Combiner embedding over variable-length id lists: ids (B, T)
    padded with -1; the rows of the valid ids reduced by ``combiner``
    ("sum" | "mean" | "sqrtn") to (B, D).  With ``max_norm`` > 0 each
    looked-up row is scaled to an L2 norm of at most ``max_norm``."""

    def __init__(self, input_dim: int, output_dim: int,
                 combiner: str = "sum", max_norm: float = -1.0,
                 init="uniform", W_regularizer=None, **kwargs):
        super().__init__(**kwargs)
        if combiner not in ("sum", "mean", "sqrtn"):
            raise ValueError("combiner must be sum|mean|sqrtn")
        self.input_dim = int(input_dim)
        self.output_dim = int(output_dim)
        self.combiner = combiner
        self.max_norm = float(max_norm)
        self.kernel_init = init
        self.W_regularizer = W_regularizer

    def build(self, rng, input_shape) -> Params:
        params: Params = {}
        self.add_weight(params, rng, "embeddings",
                        (self.input_dim, self.output_dim),
                        init=self.kernel_init,
                        regularizer=self.W_regularizer)
        return params

    def call(self, params, x, training=False, rng=None):
        ids = x.to(torch.int32)
        valid = ids >= 0
        _, rows = _take(params["embeddings"], torch.clamp(ids, min=0))
        if self.max_norm > 0:
            norms = torch.linalg.vector_norm(rows, dim=-1, keepdim=True)
            rows = rows * torch.clamp(
                self.max_norm / torch.clamp(norms, min=1e-12), max=1.0)
        rows = rows * valid.unsqueeze(-1).to(rows.dtype)
        out = rows.sum(dim=-2)
        count = torch.clamp(valid.sum(dim=-1, keepdim=True), min=1)
        if self.combiner == "mean":
            out = out / count
        elif self.combiner == "sqrtn":
            out = out / torch.sqrt(count.to(out.dtype))
        return out

    def compute_output_shape(self, input_shape):
        return tuple(input_shape[:-1]) + (self.output_dim,)
