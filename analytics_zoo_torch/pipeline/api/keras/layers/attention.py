"""Transformer layers (port of ``pipeline/api/keras/layers/attention.py``):
``MultiHeadSelfAttention``, ``PositionwiseFeedForward``, the post-LN
``transformer_block``, the ``BERT`` encoder and the GPT-style
``TransformerLayer``.

QKV is one fused product and heads live in a reshaped axis.  Attention
takes the flash kernel for a CUDA tensor with no mask and a head_dim the
kernel takes (64 or 128); every other case takes the dense plain path,
as the reference takes dense XLA attention.  ``BERT`` always feeds its
attention mask, so its blocks take the dense path, as the reference's
do; ``TransformerLayer`` feeds none.

On a mesh, ``tensor_parallel`` and ``sequence_parallel`` route as in the
reference ("auto": whether the ``model``/``seq`` axis has more than one
rank; True/False force it):

- tensor parallel (Megatron): the QKV kernel is split by heads (column),
  the output kernel by rows; each rank attends over its own heads and
  the output products are summed over ``model``; the FFN's up product is
  split by columns and its down product by rows, the same way;
- sequence parallel (no mask): each rank takes its block of the
  sequence, runs ring attention (``parallel/ring_attention.py``) over
  ``seq`` and its block of the output product; the blocks are gathered.

The reference takes its flash kernel only on a one-device mesh
(``pallas_call`` cannot be partitioned by GSPMD) and dense attention on
a larger one; each port rank attends over its own rows or heads, so it
keeps the kernel.  The attention dropout mask is always the one a single
device draws for the whole batch and every head (this rank's part of
it).
"""

from __future__ import annotations

from typing import Optional

import torch

from analytics_zoo_torch.ops import activations as acts
from analytics_zoo_torch.ops.attention import scaled_dot_product_attention
from analytics_zoo_torch.ops.dtypes import matmul as _mm
from analytics_zoo_torch.pipeline.api.keras.engine import (
    Input, Layer, Params,
)
from analytics_zoo_torch.pipeline.api.keras.layers.core import (
    Dense, Dropout, Lambda,
)
from analytics_zoo_torch.pipeline.api.keras.layers.embedding import (
    Embedding,
)
from analytics_zoo_torch.pipeline.api.keras.layers.merge import Merge
from analytics_zoo_torch.pipeline.api.keras.layers.normalization import (
    LayerNorm,
)
from analytics_zoo_torch.pipeline.api.keras.topology import Model


def _check_parallel(kind: str, value) -> None:
    if value not in ("auto", True, False, None):
        raise ValueError(f"{kind} must be 'auto', True or False")


def _uses(value, axis: str) -> bool:
    """The reference's routing: "auto" when the mesh's axis has more than
    one rank, or True."""
    from analytics_zoo_torch.parallel.mesh import current_mesh
    return (value == "auto" and current_mesh().size(axis) > 1) or \
        value is True


def _model_group():
    from analytics_zoo_torch.parallel.mesh import MODEL_AXIS, current_mesh
    return current_mesh().group(MODEL_AXIS)


class MultiHeadSelfAttention(Layer):
    """Self-attention over (B, T, D); optional (B, T) 0/1 mask as a
    second input."""

    def __init__(self, hidden_size: int, n_head: int,
                 attn_dropout: float = 0.0, causal: bool = False,
                 sequence_parallel="auto", tensor_parallel="auto",
                 **kwargs):
        super().__init__(**kwargs)
        if hidden_size % n_head:
            raise ValueError(f"hidden_size {hidden_size} must divide into "
                             f"n_head {n_head} heads")
        _check_parallel("sequence_parallel", sequence_parallel)
        _check_parallel("tensor_parallel", tensor_parallel)
        self.hidden_size = int(hidden_size)
        self.n_head = int(n_head)
        self.head_dim = self.hidden_size // self.n_head
        self.attn_dropout = float(attn_dropout)
        self.causal = causal
        self.sequence_parallel = sequence_parallel
        self.tensor_parallel = tensor_parallel

    def _use_sp(self) -> bool:
        from analytics_zoo_torch.parallel.mesh import SEQ_AXIS
        return _uses(self.sequence_parallel, SEQ_AXIS)

    def _use_tp(self) -> bool:
        from analytics_zoo_torch.parallel.mesh import MODEL_AXIS
        return _uses(self.tensor_parallel, MODEL_AXIS)

    def build(self, rng, input_shape) -> Params:
        if isinstance(input_shape, list):
            input_shape = input_shape[0]
        d = input_shape[-1]
        params: Params = {}
        self.add_weight(params, rng, "qkv_kernel",
                        (d, 3 * self.hidden_size))
        self.add_weight(params, rng, "qkv_bias", (3 * self.hidden_size,),
                        init="zero")
        self.add_weight(params, rng, "out_kernel",
                        (self.hidden_size, d))
        self.add_weight(params, rng, "out_bias", (d,), init="zero")
        if self._use_tp():
            from analytics_zoo_torch.parallel.mesh import MODEL_AXIS, Shard
            # the QKV columns by heads: each of the q, k, v blocks split
            self.param_pspecs["qkv_kernel"] = Shard(MODEL_AXIS, 1, 3)
            self.param_pspecs["qkv_bias"] = Shard(MODEL_AXIS, 0, 3)
            self.param_pspecs["out_kernel"] = Shard(MODEL_AXIS, 0)
        return params

    def call(self, params, inputs, training=False, rng=None):
        from analytics_zoo_torch.parallel import comm
        from analytics_zoo_torch.parallel.mesh import (
            SEQ_AXIS, current_mesh)
        if isinstance(inputs, (list, tuple)):
            x, mask = inputs[0], inputs[1]
        else:
            x, mask = inputs, None
        b, t, _ = x.shape
        mesh = current_mesh()
        qkv_k, qkv_b, out_k = (params["qkv_kernel"], params["qkv_bias"],
                               params["out_kernel"])
        # tensor parallel: this rank's heads (pieces of a whole kernel
        # when the layer is called outside a trainer)
        tp = _model_group() if self._use_tp() else None
        heads, head0 = self.n_head, 0
        x_in = x
        if tp is not None:
            n = comm.group_size(tp)
            heads = self.n_head // n
            head0 = comm.group_rank(tp) * heads
            if qkv_k.shape[1] == 3 * self.hidden_size:
                qkv_k = comm.local_part(qkv_k, tp, 1, 3)
                qkv_b = comm.local_part(qkv_b, tp, 0, 3)
                out_k = comm.local_part(out_k, tp, 0)
            x_in = comm.copy_to_group(x_in, tp)
        # sequence parallel: this rank's block of the positions
        use_sp = self._use_sp() and mask is None
        sp = mesh.group(SEQ_AXIS) if use_sp else None
        t0, tl = 0, t
        out_b = params["out_bias"]
        if sp is not None:
            tl = t // comm.group_size(sp)
            t0 = comm.group_rank(sp) * tl
            x_in = comm.local_part(comm.copy_to_group(x_in, sp), sp, 1)
            # each rank's block gives part of the weights' gradients
            qkv_k, qkv_b, out_k, out_b = (
                comm.copy_to_group(w, sp) for w in (qkv_k, qkv_b, out_k,
                                                    out_b))
        qkv = _mm(x_in, qkv_k) + qkv_b
        qkv = qkv.reshape(b, tl, 3, heads, self.head_dim)
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))

        from analytics_zoo_torch.ops import flash_attention as fa
        from analytics_zoo_torch.ops.fused import fused_enabled
        use_flash = (not use_sp and mask is None and x.is_cuda and
                     fused_enabled() and fa.kernel_supports(q))
        if use_flash:
            ctx = fa.flash_attention(q, k, v, causal=self.causal)
        elif use_sp:
            from analytics_zoo_torch.parallel.ring_attention import (
                ring_attention)
            ctx = ring_attention(q, k, v, mesh, causal=self.causal)
        else:
            attn_mask = None
            if mask is not None:
                attn_mask = mask[:, None, None, :]   # (B,1,1,Tk)
            ctx = scaled_dot_product_attention(
                q, k, v, mask=attn_mask, causal=self.causal)

        if training and self.attn_dropout > 0:
            if rng is None:
                raise ValueError(f"{self.name} needs rng when training")
            from analytics_zoo_torch.parallel.mesh import rand_rows
            keep = 1.0 - self.attn_dropout
            m = rand_rows((b, self.n_head, t, self.head_dim), rng,
                          ctx.device)
            m = m[:, head0:head0 + heads, t0:t0 + tl]
            ctx = ctx * (m < keep).to(ctx.dtype) / keep

        ctx = ctx.transpose(1, 2).reshape(b, tl, heads * self.head_dim)
        y = _mm(ctx, out_k)
        if tp is not None:
            y = comm.reduce_from_group(y, tp)
        y = (y + out_b).to(x.dtype)
        if sp is not None:
            y = comm.gather_from_group(y, sp, 1)
        return y

    def compute_output_shape(self, input_shape):
        if isinstance(input_shape, list):
            return tuple(input_shape[0])
        return tuple(input_shape)


class PositionwiseFeedForward(Layer):
    """Transformer FFN: up-proj → gelu → down-proj."""

    def __init__(self, hidden_size: int, intermediate_size: int,
                 activation="gelu", tensor_parallel="auto", **kwargs):
        super().__init__(**kwargs)
        _check_parallel("tensor_parallel", tensor_parallel)
        self.hidden_size = int(hidden_size)
        self.intermediate_size = int(intermediate_size)
        self.activation = acts.get(activation)
        self.tensor_parallel = tensor_parallel

    def _use_tp(self) -> bool:
        from analytics_zoo_torch.parallel.mesh import MODEL_AXIS
        return _uses(self.tensor_parallel, MODEL_AXIS)

    def build(self, rng, input_shape) -> Params:
        d = input_shape[-1]
        params: Params = {}
        self.add_weight(params, rng, "up_kernel",
                        (d, self.intermediate_size))
        self.add_weight(params, rng, "up_bias",
                        (self.intermediate_size,), init="zero")
        self.add_weight(params, rng, "down_kernel",
                        (self.intermediate_size, self.hidden_size))
        self.add_weight(params, rng, "down_bias",
                        (self.hidden_size,), init="zero")
        if self._use_tp():
            from analytics_zoo_torch.parallel.mesh import MODEL_AXIS, Shard
            self.param_pspecs["up_kernel"] = Shard(MODEL_AXIS, 1)
            self.param_pspecs["up_bias"] = Shard(MODEL_AXIS, 0)
            self.param_pspecs["down_kernel"] = Shard(MODEL_AXIS, 0)
        return params

    def call(self, params, x, training=False, rng=None):
        from analytics_zoo_torch.parallel import comm
        up_k, up_b, down_k = (params["up_kernel"], params["up_bias"],
                              params["down_kernel"])
        tp = _model_group() if self._use_tp() else None
        x_in = x
        if tp is not None:
            if up_k.shape[1] == self.intermediate_size:
                up_k = comm.local_part(up_k, tp, 1)
                up_b = comm.local_part(up_b, tp, 0)
                down_k = comm.local_part(down_k, tp, 0)
            x_in = comm.copy_to_group(x, tp)
        up = _mm(x_in, up_k)
        if self.activation is acts.gelu:
            # fused bias→GeLU epilogue; the unfused form is gelu(up + bias)
            from analytics_zoo_torch.ops import fused
            if fused.fused_enabled():
                h = fused.bias_gelu(up, up_b)
            else:
                h = acts.gelu(up + up_b)
        else:
            h = up + up_b
            if self.activation is not None:
                h = self.activation(h)
        y = _mm(h, down_k)
        if tp is not None:
            y = comm.reduce_from_group(y, tp)
        return (y + params["down_bias"]).to(x.dtype)


def transformer_block(x, mask, hidden_size: int, n_head: int,
                      intermediate_size: int, dropout: float = 0.1,
                      causal: bool = False, activation="gelu",
                      ln_eps: float = 1e-5,
                      hidden_dropout: Optional[float] = None):
    """Post-LN transformer encoder block (BERT-style)."""
    if hidden_dropout is None:
        hidden_dropout = dropout
    attn_in = [x, mask] if mask is not None else x
    a = MultiHeadSelfAttention(hidden_size, n_head,
                               attn_dropout=dropout,
                               causal=causal)(attn_in)
    a = Dropout(hidden_dropout)(a)
    x = Merge(mode="sum")([x, a])
    x = LayerNorm(epsilon=ln_eps)(x)
    f = PositionwiseFeedForward(hidden_size, intermediate_size,
                                activation=activation)(x)
    f = Dropout(hidden_dropout)(f)
    x = Merge(mode="sum")([x, f])
    return LayerNorm(epsilon=ln_eps)(x)


def _pooled(x, hidden_size: int):
    """The pooler: tanh Dense over the first token's state."""
    first_tok = Lambda(lambda t: t[:, 0], output_shape=(hidden_size,))(x)
    return Dense(hidden_size, activation="tanh")(first_tok)


class BERT:
    """BERT encoder: ``build()`` makes a graph Model with inputs
    [token_ids, token_type_ids, position_ids, attention_mask] and outputs
    [sequence_output, pooled_output]."""

    def __init__(self, vocab: int = 40990, hidden_size: int = 768,
                 n_block: int = 12, n_head: int = 12,
                 seq_len: int = 512, intermediate_size: int = 3072,
                 max_position_len: int = 512, type_vocab_size: int = 2,
                 hidden_drop: float = 0.1, attn_drop: float = 0.1,
                 hidden_act: str = "gelu", ln_eps: float = 1e-12):
        # "gelu" is the tanh approximation; checkpoints trained with the
        # erf gelu import with hidden_act="gelu_erf"
        self.cfg = dict(vocab=vocab, hidden_size=hidden_size,
                        n_block=n_block, n_head=n_head, seq_len=seq_len,
                        intermediate_size=intermediate_size,
                        max_position_len=max_position_len,
                        type_vocab_size=type_vocab_size,
                        hidden_drop=hidden_drop, attn_drop=attn_drop,
                        hidden_act=hidden_act, ln_eps=ln_eps)

    def build(self) -> Model:
        c = self.cfg
        ids, seg, pos, mask = (Input(shape=(c["seq_len"],))
                               for _ in range(4))
        tok_e = Embedding(c["vocab"], c["hidden_size"], init="normal")(ids)
        seg_e = Embedding(c["type_vocab_size"], c["hidden_size"],
                          init="normal")(seg)
        pos_e = Embedding(c["max_position_len"], c["hidden_size"],
                          init="normal")(pos)
        x = Merge(mode="sum")([tok_e, seg_e, pos_e])
        x = LayerNorm(epsilon=c["ln_eps"])(x)
        x = Dropout(c["hidden_drop"])(x)
        for _ in range(c["n_block"]):
            x = transformer_block(x, mask, c["hidden_size"], c["n_head"],
                                  c["intermediate_size"],
                                  dropout=c["attn_drop"],
                                  hidden_dropout=c["hidden_drop"],
                                  activation=c["hidden_act"],
                                  ln_eps=c["ln_eps"])
        return Model([ids, seg, pos, mask],
                     [x, _pooled(x, c["hidden_size"])])


class TransformerLayer:
    """GPT-style decoder stack: ``build()`` makes a graph Model with
    inputs [token_ids, position_ids] and outputs [last block states,
    pooled first-token output].  ``bidirectional=False`` makes every
    block causal.

    Tokens and positions share ONE ``vocab``-row table: position ids are
    offset ids in ``[vocab - seq_len, vocab)`` (vocab = n_tokens +
    n_position_slots), and both lookups go through the same Embedding
    instance, so the model holds one entry for it and its gradient is
    the sum of both uses'."""

    def __init__(self, n_block: int = 12, hidden_drop: float = 0.1,
                 attn_drop: float = 0.1, n_head: int = 12,
                 bidirectional: bool = False,
                 vocab: int = 40990, seq_len: int = 77,
                 hidden_size: int = 768, intermediate_size: int = 0):
        self.cfg = dict(n_block=n_block, hidden_drop=hidden_drop,
                        attn_drop=attn_drop, n_head=n_head,
                        bidirectional=bidirectional, vocab=vocab,
                        seq_len=seq_len, hidden_size=hidden_size,
                        intermediate_size=intermediate_size or
                        4 * hidden_size)

    @classmethod
    def init_with_default_embedding(cls, vocab: int = 40990,
                                    seq_len: int = 77, n_block: int = 12,
                                    hidden_drop: float = 0.1,
                                    attn_drop: float = 0.1,
                                    n_head: int = 12,
                                    bidirectional: bool = False,
                                    hidden_size: int = 768):
        return cls(n_block=n_block, hidden_drop=hidden_drop,
                   attn_drop=attn_drop, n_head=n_head,
                   bidirectional=bidirectional, vocab=vocab,
                   seq_len=seq_len, hidden_size=hidden_size)

    def build(self) -> Model:
        c = self.cfg
        ids = Input(shape=(c["seq_len"],))
        pos = Input(shape=(c["seq_len"],))
        shared = Embedding(c["vocab"], c["hidden_size"], init="normal")
        x = Merge(mode="sum")([shared(ids), shared(pos)])
        x = Dropout(c["hidden_drop"])(x)
        for _ in range(c["n_block"]):
            x = transformer_block(x, None, c["hidden_size"], c["n_head"],
                                  c["intermediate_size"],
                                  dropout=c["attn_drop"],
                                  hidden_dropout=c["hidden_drop"],
                                  causal=not c["bidirectional"])
        return Model([ids, pos], [x, _pooled(x, c["hidden_size"])])
