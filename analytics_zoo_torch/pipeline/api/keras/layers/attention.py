"""Transformer layers (port of ``pipeline/api/keras/layers/attention.py``):
``MultiHeadSelfAttention``, ``PositionwiseFeedForward``, the post-LN
``transformer_block``, the ``BERT`` encoder and the GPT-style
``TransformerLayer``.

QKV is one fused product and heads live in a reshaped axis.  Attention
takes the flash kernel for a CUDA tensor with no mask and a head_dim the
kernel takes (64 or 128); every other case takes the dense plain path,
as the reference takes dense XLA attention.  ``BERT`` always feeds its
attention mask, so its blocks take the dense path, as the reference's
do; ``TransformerLayer`` feeds none.  Sequence and tensor parallelism
come with the multi-GPU slice and raise here.
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


def _no_parallel(kind: str, value) -> None:
    if value is True:
        raise NotImplementedError(
            f"{kind}=True: ring/sequence and tensor parallelism come with "
            "the multi-GPU slice of the port (ROADMAP.md)")
    if value not in ("auto", False, None):
        raise ValueError(f"{kind} must be 'auto', True or False")


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
        _no_parallel("sequence_parallel", sequence_parallel)
        _no_parallel("tensor_parallel", tensor_parallel)
        self.hidden_size = int(hidden_size)
        self.n_head = int(n_head)
        self.head_dim = self.hidden_size // self.n_head
        self.attn_dropout = float(attn_dropout)
        self.causal = causal

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
        return params

    def call(self, params, inputs, training=False, rng=None):
        if isinstance(inputs, (list, tuple)):
            x, mask = inputs[0], inputs[1]
        else:
            x, mask = inputs, None
        b, t, _ = x.shape
        qkv = _mm(x, params["qkv_kernel"]) + params["qkv_bias"]
        qkv = qkv.reshape(b, t, 3, self.n_head, self.head_dim)
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))

        from analytics_zoo_torch.ops import flash_attention as fa
        from analytics_zoo_torch.ops.fused import fused_enabled
        use_flash = (mask is None and x.is_cuda and fused_enabled() and
                     fa.kernel_supports(q))
        if use_flash:
            ctx = fa.flash_attention(q, k, v, causal=self.causal)
        else:
            attn_mask = None
            if mask is not None:
                attn_mask = mask[:, None, None, :]   # (B,1,1,Tk)
            ctx = scaled_dot_product_attention(
                q, k, v, mask=attn_mask, causal=self.causal)

        if training and self.attn_dropout > 0:
            if rng is None:
                raise ValueError(f"{self.name} needs rng when training")
            keep = 1.0 - self.attn_dropout
            m = torch.rand(tuple(ctx.shape), generator=rng,
                           device=ctx.device)
            ctx = ctx * (m < keep).to(ctx.dtype) / keep

        ctx = ctx.transpose(1, 2).reshape(b, t, self.hidden_size)
        return (_mm(ctx, params["out_kernel"]) +
                params["out_bias"]).to(x.dtype)

    def compute_output_shape(self, input_shape):
        if isinstance(input_shape, list):
            return tuple(input_shape[0])
        return tuple(input_shape)


class PositionwiseFeedForward(Layer):
    """Transformer FFN: up-proj → gelu → down-proj."""

    def __init__(self, hidden_size: int, intermediate_size: int,
                 activation="gelu", tensor_parallel="auto", **kwargs):
        super().__init__(**kwargs)
        _no_parallel("tensor_parallel", tensor_parallel)
        self.hidden_size = int(hidden_size)
        self.intermediate_size = int(intermediate_size)
        self.activation = acts.get(activation)

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
        return params

    def call(self, params, x, training=False, rng=None):
        up = _mm(x, params["up_kernel"])
        if self.activation is acts.gelu:
            # fused bias→GeLU epilogue; the unfused form is gelu(up + bias)
            from analytics_zoo_torch.ops import fused
            if fused.fused_enabled():
                h = fused.bias_gelu(up, params["up_bias"])
            else:
                h = acts.gelu(up + params["up_bias"])
        else:
            h = up + params["up_bias"]
            if self.activation is not None:
                h = self.activation(h)
        return (_mm(h, params["down_kernel"]) +
                params["down_bias"]).to(x.dtype)


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
