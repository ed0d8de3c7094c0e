"""Convolutional LSTMs (port of ``pipeline/api/keras/layers/convlstm.py``;
ref: keras/layers/ConvLSTM2D.scala, ConvLSTM3D.scala) — one shared cell
over N-D spatial sequences.

As in the reference, the input convolution for all timesteps is one
convolution with the time axis folded into the batch; only the recurrent
convolution runs inside the loop over timesteps (the reference's
``lax.scan``, here a Python loop).  Both go through the conv layers'
``conv_nd``: operands rounded to the compute dtype, XLA's ``"SAME"``
padding split (PyTorch's ``padding="same"`` refuses a stride above 1),
HWIO/DHWIO kernels; each result is widened to float32.  The gates split
``i, f, g, o`` along the last axis; the recurrent kernel is drawn by
``orthogonal``.
"""

from __future__ import annotations

import torch

from analytics_zoo_torch.ops import activations as acts
from analytics_zoo_torch.pipeline.api.keras.engine import Layer, Params
from analytics_zoo_torch.pipeline.api.keras.layers.conv import conv_nd


class _ConvLSTMND(Layer):
    """Shared ConvLSTM cell; subclasses set ``spatial`` = 2 or 3.
    Input is (B, T, *spatial, C); output (B, *spatial, F) or the full
    sequence with ``return_sequences``."""

    spatial = 2

    def __init__(self, nb_filter: int, nb_kernel: int,
                 activation="tanh", inner_activation="sigmoid",
                 border_mode: str = "same", subsample=1,
                 return_sequences: bool = False,
                 go_backwards: bool = False, **kwargs):
        super().__init__(**kwargs)
        self.nb_filter = int(nb_filter)
        self.k = int(nb_kernel)
        self.activation = acts.get(activation) or (lambda v: v)
        self.inner_activation = acts.get(inner_activation) or (lambda v: v)
        assert border_mode == "same", \
            f"{type(self).__name__} supports border_mode='same' " \
            "(state shapes)"
        if isinstance(subsample, int):
            subsample = (subsample,) * self.spatial
        self.subsample = tuple(int(s) for s in subsample)
        assert len(self.subsample) == self.spatial
        self.return_sequences = return_sequences
        self.go_backwards = go_backwards

    def _conv(self, x, w, stride=None):
        ones = (1,) * self.spatial
        return conv_nd(x, w, stride or ones, "SAME", ones).float()

    def build(self, rng, input_shape) -> Params:
        c = input_shape[-1]
        f = self.nb_filter
        kshape = (self.k,) * self.spatial
        params: Params = {}
        self.add_weight(params, rng, "kernel", kshape + (c, 4 * f))
        self.add_weight(params, rng, "recurrent_kernel",
                        kshape + (f, 4 * f), init="orthogonal")
        self.add_weight(params, rng, "bias", (4 * f,), init="zero")
        return params

    def call(self, params, x, training=False, rng=None):
        b, t = x.shape[0], x.shape[1]
        f = self.nb_filter
        # all-timestep input conv: fold T into batch
        flat = x.reshape((b * t,) + tuple(x.shape[2:]))
        xp = self._conv(flat, params["kernel"], self.subsample) \
            + params["bias"]
        out_spatial = tuple(xp.shape[1:-1])
        seq = xp.reshape((b, t) + out_spatial + (4 * f,)).transpose(0, 1)
        if self.go_backwards:
            seq = seq.flip(0)
        h = c = torch.zeros((b,) + out_spatial + (f,), dtype=torch.float32,
                            device=x.device)
        outs = []
        for xt in seq:
            gates = xt + self._conv(h, params["recurrent_kernel"])
            i, fg, g, o = torch.chunk(gates, 4, dim=-1)
            i = self.inner_activation(i)
            fg = self.inner_activation(fg)
            g = self.activation(g)
            o = self.inner_activation(o)
            c = fg * c + i * g
            h = o * self.activation(c)
            if self.return_sequences:
                outs.append(h)
        if self.return_sequences:
            outs = torch.stack(outs, dim=1)
            return outs.flip(1) if self.go_backwards else outs
        return h

    def compute_output_shape(self, s):
        dims = tuple(None if v is None else -(-v // st)
                     for v, st in zip(s[2:2 + self.spatial],
                                      self.subsample))
        if self.return_sequences:
            return (s[0], s[1]) + dims + (self.nb_filter,)
        return (s[0],) + dims + (self.nb_filter,)


class ConvLSTM2D(_ConvLSTMND):
    """ConvLSTM over (B, T, H, W, C) images (ConvLSTM2D.scala)."""
    spatial = 2


class ConvLSTM3D(_ConvLSTMND):
    """ConvLSTM over (B, T, D, H, W, C) volumes (ConvLSTM3D.scala)."""
    spatial = 3
