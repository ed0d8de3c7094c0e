"""Recurrent layers: SimpleRNN / LSTM / GRU / Bidirectional (port of
``pipeline/api/keras/layers/recurrent.py``).

Reference: zoo/pipeline/api/keras/layers/Recurrent.scala (LSTM, GRU,
SimpleRNN, Bidirectional wrappers over BigDL Recurrent containers).

The input projection ``x @ W + b`` for all timesteps is one product
outside the loop; only the recurrent ``h @ U`` runs inside a Python loop
over the timesteps (the reference's ``lax.scan``).  Every product goes
through ``ops.dtypes.matmul``: operands rounded to the compute dtype, a
float32 result, and ``h`` rounded the same way at every step.  The
recurrent kernel is rounded once before the loop, which gives the same
values as rounding it at each step.

The gates are the reference's, not ``torch.nn``'s: LSTM orders them i, f,
c, o with one bias and any ``activation``/``inner_activation``; GRU
orders them z, r, h and applies the reset before the recurrent product
(``(r * h) @ U_h``, Keras-1), where ``torch.nn.GRU`` orders r, z, n and
resets after it.  So neither ``torch.nn.LSTM``/``GRU`` nor cuDNN's RNN
computes these layers.

A calibrated int8 tree (``ops/quant.py``) may hold an int8 ``kernel`` for
a recurrent layer: as in the reference, the product takes its raw int8
values and applies no scale.
"""

from __future__ import annotations

import copy

import torch

from analytics_zoo_torch.ops import activations as acts
from analytics_zoo_torch.ops.dtypes import get_policy, matmul
from analytics_zoo_torch.pipeline.api.keras.engine import (
    Layer, Params, fold_name,
)


def _identity(v):
    return v


def _carry_device(device) -> torch.device:
    if device is not None:
        return torch.device(device)
    from analytics_zoo_torch.common.zoo_context import get_zoo_context
    return get_zoo_context().device


class _RNNBase(Layer):
    def __init__(self, output_dim: int, activation="tanh",
                 inner_activation="sigmoid", return_sequences: bool = False,
                 go_backwards: bool = False, init="glorot_uniform",
                 inner_init="orthogonal", W_regularizer=None,
                 U_regularizer=None, b_regularizer=None, **kwargs):
        super().__init__(**kwargs)
        self.output_dim = int(output_dim)
        self.activation = acts.get(activation) or _identity
        self.inner_activation = acts.get(inner_activation) or _identity
        self.return_sequences = return_sequences
        self.go_backwards = go_backwards
        self.kernel_init = init
        self.inner_init = inner_init
        self.W_regularizer = W_regularizer
        self.U_regularizer = U_regularizer
        self.b_regularizer = b_regularizer

    n_gates = 1

    def build(self, rng, input_shape) -> Params:
        d = input_shape[-1]
        h = self.output_dim
        params: Params = {}
        self.add_weight(params, rng, "kernel", (d, self.n_gates * h),
                        init=self.kernel_init,
                        regularizer=self.W_regularizer)
        self.add_weight(params, rng, "recurrent_kernel",
                        (h, self.n_gates * h), init=self.inner_init,
                        regularizer=self.U_regularizer)
        self.add_weight(params, rng, "bias", (self.n_gates * h,),
                        init="zero", regularizer=self.b_regularizer)
        return params

    def initial_carry(self, batch: int, device=None):
        """Zero float32 carry on ``device`` (default: the zoo context's)."""
        return torch.zeros((batch, self.output_dim), dtype=torch.float32,
                           device=_carry_device(device))

    def step(self, params, u, carry, x_proj):
        """One timestep: the recurrent kernel ``u`` already rounded to the
        compute dtype, the carry and the pre-projected input slice ->
        (new carry, output)."""
        raise NotImplementedError

    def run(self, params, x, initial_carry=None, collect_outputs=True):
        """Run the full sequence; returns (outputs or None, final carry).

        Exposed for encoder/decoder wiring (Seq2seq bridges the encoder's
        final carry into the decoder's initial carry)."""
        x_proj = matmul(x, params["kernel"]) + params["bias"]
        seq = x_proj.transpose(0, 1)              # (T, B, G*H)
        if self.go_backwards:
            seq = seq.flip(0)
        u = params["recurrent_kernel"].to(get_policy().compute_dtype)
        carry = self.initial_carry(x.shape[0], x.device) \
            if initial_carry is None else initial_carry
        outs = []
        for t in range(seq.shape[0]):
            carry, out = self.step(params, u, carry, seq[t])
            if collect_outputs:
                outs.append(out)
        if not collect_outputs:
            return None, carry
        outs = torch.stack(outs, dim=1)           # (B, T, H)
        if self.go_backwards:
            outs = outs.flip(1)
        return outs, carry

    def call(self, params, x, training=False, rng=None):
        outs, last_carry = self.run(
            params, x, collect_outputs=self.return_sequences)
        if self.return_sequences:
            return outs
        return last_carry[0] if isinstance(last_carry, tuple) \
            else last_carry

    def compute_output_shape(self, input_shape):
        if self.return_sequences:
            return (input_shape[0], input_shape[1], self.output_dim)
        return (input_shape[0], self.output_dim)


class SimpleRNN(_RNNBase):
    n_gates = 1

    def step(self, params, u, h, xt):
        new_h = self.activation(xt + matmul(h, u))
        return new_h, new_h


class LSTM(_RNNBase):
    """Gate order i, f, c, o (Keras-1 / Recurrent.scala LSTM).

    ``unit_forget_bias``: initialise the forget-gate bias slice to 1
    (Jozefowicz et al.; the Keras-2 default — Keras-1 zero-init stays
    the default here)."""
    n_gates = 4

    def __init__(self, output_dim, *args,
                 unit_forget_bias: bool = False, **kwargs):
        # keyword-only: keras-1 callers use the positional slots for
        # activation etc. (LSTM(128, "relu") must keep meaning that)
        super().__init__(output_dim, *args, **kwargs)
        self.unit_forget_bias = unit_forget_bias

    def build(self, rng, input_shape):
        params = super().build(rng, input_shape)
        if self.unit_forget_bias:
            h = self.output_dim
            params["bias"][h:2 * h] = 1.0
        return params

    def initial_carry(self, batch: int, device=None):
        z = super().initial_carry(batch, device)
        return (z, z)

    def step(self, params, u, carry, xt):
        h_prev, c_prev = carry
        gates = xt + matmul(h_prev, u)
        i, f, g, o = gates.chunk(4, dim=-1)
        i = self.inner_activation(i)
        f = self.inner_activation(f)
        g = self.activation(g)
        o = self.inner_activation(o)
        c = f * c_prev + i * g
        h = o * self.activation(c)
        return (h, c), h


class GRU(_RNNBase):
    """Gate order z, r, h (Keras-1 / Recurrent.scala GRU), the reset
    applied before the recurrent product."""
    n_gates = 3

    def step(self, params, u, h_prev, xt):
        hdim = self.output_dim
        xz, xr, xh = xt.chunk(3, dim=-1)
        # z and r in one product: each output column is its own dot
        # product, the same as the reference's two
        zr = matmul(h_prev, u[:, :2 * hdim])
        z = self.inner_activation(xz + zr[:, :hdim])
        r = self.inner_activation(xr + zr[:, hdim:])
        hh = self.activation(xh + matmul(r * h_prev, u[:, 2 * hdim:]))
        h = z * h_prev + (1.0 - z) * hh
        return h, h


def _split(rng):
    """Two generators from ``rng``, one per direction: sharing one would
    give both directions the same dropout masks."""
    return fold_name(rng, "fwd"), fold_name(rng, "bwd")


class Bidirectional(Layer):
    """Run a copy of ``layer`` in each direction and merge
    (Recurrent.scala Bidirectional; merge_mode concat/sum/mul/ave)."""

    def __init__(self, layer: _RNNBase, merge_mode: str = "concat",
                 **kwargs):
        super().__init__(**kwargs)
        self.forward_layer = layer
        self.backward_layer = copy.deepcopy(layer)
        self.backward_layer.name = layer.name + "_bwd"
        self.backward_layer.go_backwards = not layer.go_backwards
        self.merge_mode = merge_mode

    def build(self, rng, input_shape) -> Params:
        f_rng, b_rng = _split(rng)
        return {
            "forward": self.forward_layer.init(f_rng, input_shape)["params"],
            "backward": self.backward_layer.init(b_rng,
                                                 input_shape)["params"],
        }

    def call(self, params, x, training=False, rng=None):
        f_rng = b_rng = None
        if rng is not None:
            f_rng, b_rng = _split(rng)
        f = self.forward_layer.call(params["forward"], x,
                                    training=training, rng=f_rng)
        b = self.backward_layer.call(params["backward"], x,
                                     training=training, rng=b_rng)
        if self.merge_mode == "concat":
            return torch.cat([f, b], dim=-1)
        if self.merge_mode == "sum":
            return f + b
        if self.merge_mode == "mul":
            return f * b
        if self.merge_mode == "ave":
            return 0.5 * (f + b)
        raise ValueError(f"unknown merge_mode {self.merge_mode}")

    def compute_output_shape(self, input_shape):
        base = self.forward_layer.compute_output_shape(input_shape)
        if self.merge_mode == "concat":
            return tuple(base[:-1]) + (2 * base[-1],)
        return base
