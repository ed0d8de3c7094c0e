"""Locally-connected layers (port of ``pipeline/api/keras/layers/local.py``;
ref keras/layers/LocallyConnected1D/2D.scala): an unshared convolution,
every output position with its own kernel.

The patches are gathered by index in the reference's element order,
(KH, KW, C) within a patch and output positions row-major, so that a
kernel ``(positions, KH * KW * C, filters)`` carried over from the JAX
package lines up; then one batched contraction over the positions.
"""

from __future__ import annotations

import torch

from analytics_zoo_torch.ops import activations as acts
from analytics_zoo_torch.pipeline.api.keras.engine import Layer, Params


def _windows(n_out: int, k: int, stride: int, device):
    """(n_out, k) input indices of each output position's window."""
    return (torch.arange(n_out, device=device)[:, None] * stride +
            torch.arange(k, device=device)[None, :])


class LocallyConnected1D(Layer):
    def __init__(self, nb_filter: int, filter_length: int,
                 activation=None, subsample_length: int = 1,
                 bias: bool = True, **kwargs):
        super().__init__(**kwargs)
        self.nb_filter = int(nb_filter)
        self.k = int(filter_length)
        self.stride = int(subsample_length)
        self.activation = acts.get(activation)
        self.use_bias = bias

    def _out_len(self, n):
        return None if n is None else (n - self.k) // self.stride + 1

    def build(self, rng, input_shape) -> Params:
        t, c = input_shape[1], input_shape[2]
        ot = self._out_len(t)
        params: Params = {}
        self.add_weight(params, rng, "kernel",
                        (ot, self.k * c, self.nb_filter))
        if self.use_bias:
            self.add_weight(params, rng, "bias", (ot, self.nb_filter),
                            init="zero")
        return params

    def call(self, params, x, training=False, rng=None):
        b, t, c = x.shape
        ot = self._out_len(t)
        patches = x[:, _windows(ot, self.k, self.stride, x.device)]
        patches = patches.reshape(b, ot, self.k * c)   # (B, OT, K*C)
        y = torch.einsum("bok,okf->bof", patches, params["kernel"])
        if self.use_bias:
            y = y + params["bias"]
        if self.activation is not None:
            y = self.activation(y)
        return y

    def compute_output_shape(self, s):
        return (s[0], self._out_len(s[1]), self.nb_filter)


class LocallyConnected2D(Layer):
    def __init__(self, nb_filter: int, nb_row: int, nb_col: int,
                 activation=None, subsample=(1, 1), bias: bool = True,
                 **kwargs):
        super().__init__(**kwargs)
        self.nb_filter = int(nb_filter)
        self.kh, self.kw = int(nb_row), int(nb_col)
        self.stride = tuple(subsample)
        self.activation = acts.get(activation)
        self.use_bias = bias

    def _out_hw(self, h, w):
        oh = None if h is None else (h - self.kh) // self.stride[0] + 1
        ow = None if w is None else (w - self.kw) // self.stride[1] + 1
        return oh, ow

    def build(self, rng, input_shape) -> Params:
        h, w, c = input_shape[1:4]
        oh, ow = self._out_hw(h, w)
        params: Params = {}
        self.add_weight(params, rng, "kernel",
                        (oh * ow, self.kh * self.kw * c, self.nb_filter))
        if self.use_bias:
            self.add_weight(params, rng, "bias",
                            (oh * ow, self.nb_filter), init="zero")
        return params

    def call(self, params, x, training=False, rng=None):
        b, h, w, c = x.shape
        oh, ow = self._out_hw(h, w)
        ri = _windows(oh, self.kh, self.stride[0], x.device)
        ci = _windows(ow, self.kw, self.stride[1], x.device)
        patches = x[:, ri][:, :, :, ci]       # (B, OH, KH, OW, KW, C)
        patches = patches.movedim(2, 3)       # (B, OH, OW, KH, KW, C)
        patches = patches.reshape(b, oh * ow, self.kh * self.kw * c)
        y = torch.einsum("bok,okf->bof", patches, params["kernel"])
        if self.use_bias:
            y = y + params["bias"]
        if self.activation is not None:
            y = self.activation(y)
        return y.reshape(b, oh, ow, self.nb_filter)

    def compute_output_shape(self, s):
        oh, ow = self._out_hw(s[1], s[2])
        return (s[0], oh, ow, self.nb_filter)
