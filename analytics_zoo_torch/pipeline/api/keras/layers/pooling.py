"""Pooling layers (port of ``pipeline/api/keras/layers/pooling.py``):
Max/Average pooling 1/2/3D and their global variants, channels-last.

``"same"`` pads as XLA's ``reduce_window`` does: ``max((out - 1) *
stride + window - n, 0)`` a dim, the low side taking the smaller half
(``ops.quant.conv_padding``), which PyTorch's symmetric ``padding=``
cannot express.  So the input is padded explicitly: with ``-inf`` for
max pooling (a padded cell never wins), with zeros for average pooling,
whose SAME cells divide by the count of their in-bounds inputs.  The
pooling runs on a channels-first view of the channels-last tensor; the
pad keeps its channels-last strides.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from analytics_zoo_torch.ops.quant import conv_padding, pad_arg
from analytics_zoo_torch.pipeline.api.keras.engine import Layer
from analytics_zoo_torch.pipeline.api.keras.layers.conv import (
    _out_len, _same_or_valid,
)


def _window_sum(xc, window, strides):
    """Sum over each window of a channels-first ``xc`` (no padding)."""
    if len(window) == 1:    # avg_pool1d takes no divisor_override
        return F.avg_pool2d(xc.unsqueeze(-2), (1,) + window, (1,) + strides,
                            divisor_override=1).squeeze(-2)
    return getattr(F, f"avg_pool{len(window)}d")(xc, window, strides,
                                                 divisor_override=1)


class _PoolND(Layer):
    spatial = 2
    op = "max"

    def __init__(self, pool_size=None, strides=None, border_mode="valid",
                 **kwargs):
        super().__init__(**kwargs)
        s = self.spatial
        if pool_size is None:
            pool_size = (2,) * s
        if np.isscalar(pool_size):
            pool_size = (int(pool_size),) * s
        self.pool_size = tuple(int(p) for p in pool_size)
        self.strides = tuple(int(v) for v in (strides or self.pool_size))
        self.border_mode = border_mode
        _same_or_valid(border_mode)

    def call(self, params, x, training=False, rng=None):
        s = self.spatial
        pads = conv_padding(x.shape[1:1 + s], self.pool_size, self.strides,
                            (1,) * s, _same_or_valid(self.border_mode))
        padded = any(lo or hi for lo, hi in pads)
        xc = x.movedim(-1, 1)
        if self.op == "max":
            if padded:
                xc = F.pad(xc, pad_arg(pads), value=-math.inf)
            y = getattr(F, f"max_pool{s}d")(xc, self.pool_size, self.strides)
            return y.movedim(1, -1)
        if padded:
            xc = F.pad(xc, pad_arg(pads))
        total = _window_sum(xc, self.pool_size, self.strides)
        if not padded:
            return (total / float(np.prod(self.pool_size))).movedim(1, -1)
        # SAME average pooling: divide by the true window size per cell
        ones = torch.ones((1, 1) + tuple(x.shape[1:1 + s]), dtype=x.dtype,
                          device=x.device)
        counts = _window_sum(F.pad(ones, pad_arg(pads)), self.pool_size,
                             self.strides)
        return (total / counts).movedim(1, -1)

    def compute_output_shape(self, s):
        spatial = tuple(
            _out_len(s[1 + i], self.pool_size[i], self.strides[i],
                     self.border_mode)
            for i in range(self.spatial))
        return (s[0],) + spatial + (s[-1],)


class MaxPooling1D(_PoolND):
    spatial, op = 1, "max"

    def __init__(self, pool_length=2, stride=None, **kwargs):
        super().__init__((pool_length,),
                         None if stride is None else (stride,), **kwargs)


class MaxPooling2D(_PoolND):
    spatial, op = 2, "max"


class MaxPooling3D(_PoolND):
    spatial, op = 3, "max"


class AveragePooling1D(_PoolND):
    spatial, op = 1, "avg"

    def __init__(self, pool_length=2, stride=None, **kwargs):
        super().__init__((pool_length,),
                         None if stride is None else (stride,), **kwargs)


class AveragePooling2D(_PoolND):
    spatial, op = 2, "avg"


class AveragePooling3D(_PoolND):
    spatial, op = 3, "avg"


class _GlobalPoolND(Layer):
    """(B, *S, C) -> (B, C): the max or the mean over the spatial dims."""
    spatial = 2
    op = "max"

    def call(self, params, x, training=False, rng=None):
        dims = tuple(range(1, 1 + self.spatial))
        if self.op == "max":
            return x.amax(dim=dims)
        return x.mean(dim=dims)

    def compute_output_shape(self, s):
        return (s[0], s[-1])


class GlobalMaxPooling1D(_GlobalPoolND):
    spatial, op = 1, "max"


class GlobalAveragePooling1D(_GlobalPoolND):
    spatial, op = 1, "avg"


class GlobalMaxPooling2D(_GlobalPoolND):
    spatial, op = 2, "max"


class GlobalAveragePooling2D(_GlobalPoolND):
    spatial, op = 2, "avg"


class GlobalMaxPooling3D(_GlobalPoolND):
    spatial, op = 3, "max"


class GlobalAveragePooling3D(_GlobalPoolND):
    spatial, op = 3, "avg"
