"""Convolution layers (port of ``pipeline/api/keras/layers/conv.py``):
``Convolution1D/2D/3D`` and ``AtrousConvolution1D/2D`` on ``_ConvND``.

The layers keep the reference's channels-last layouts (NWC/NHWC/NDHWC
inputs, WIO/HWIO/DHWIO kernels); the ``"th"`` (channels-first)
``dim_ordering`` is handled by transposition at the boundary.  The float
route rounds both operands to the compute dtype and returns that dtype,
as ``lax.conv_general_dilated`` does (it takes no
``preferred_element_type`` here): on the card ``conv{1,2,3}d`` in the
compute dtype (under a float32 compute dtype cuDNN takes TF32 products
while ``torch.backends.cudnn.allow_tf32`` is set, PyTorch's default), on
the CPU the same on the rounded operands widened to float32, the result
rounded back.  ``"same"`` pads as XLA does, the low side taking the
smaller half (``ops.quant.conv_padding``).  A layer whose params carry
``kernel_scale``/``act_scale`` runs the int8 convolution
(``ops.quant.quantized_conv``).

``ZeroPadding1D/2D/3D`` and ``SpaceToDepth2D`` reshape the channels-last
input as the reference does.  The other classes of the reference's
module (separable, deconvolution, cropping, up-sampling, share) are not
ported yet.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F

from analytics_zoo_torch.ops import activations as acts
from analytics_zoo_torch.ops.dtypes import get_policy
from analytics_zoo_torch.ops.quant import (
    conv_padding, pad_arg, quantized_conv,
)
from analytics_zoo_torch.pipeline.api.keras.engine import Layer, Params


def _same_or_valid(border_mode: str) -> str:
    if border_mode not in ("same", "valid"):
        raise ValueError(f"border_mode must be same|valid, got {border_mode}")
    return border_mode.upper()


def _out_len(n, k, stride, mode, dilation=1):
    if n is None:
        return None
    eff = (k - 1) * dilation + 1
    if mode == "same":
        return -(-n // stride)
    return -(-(n - eff + 1) // stride)


def conv_nd(x, kernel, strides, padding: str, dilation, groups: int = 1):
    """Channels-last convolution, the float route: ``x`` (N, *S, C),
    ``kernel`` (*K, C / groups, O), both rounded to the compute dtype;
    the result (N, *out, O) in the compute dtype."""
    spatial = kernel.ndim - 2
    cd = get_policy().compute_dtype
    xc, kc = x.to(cd), kernel.to(cd)
    if not x.is_cuda and cd != torch.float32:
        xc, kc = xc.float(), kc.float()
    pads = conv_padding(x.shape[1:1 + spatial], kernel.shape[:spatial],
                        strides, dilation, padding)
    xc = xc.movedim(-1, 1)
    if all(lo == hi for lo, hi in pads):
        pad = tuple(lo for lo, _ in pads)
    else:
        xc = F.pad(xc, pad_arg(pads))
        pad = 0
    w = kc.permute(spatial + 1, spatial, *range(spatial))
    y = getattr(F, f"conv{spatial}d")(xc, w, stride=tuple(strides),
                                      padding=pad, dilation=tuple(dilation),
                                      groups=groups)
    return y.movedim(1, -1).to(cd)


class _ConvND(Layer):
    spatial = 2

    def __init__(self, nb_filter: int, kernel_size: Sequence[int],
                 strides: Sequence[int] = None, border_mode: str = "valid",
                 activation=None, dilation: Sequence[int] = None,
                 init="glorot_uniform", bias: bool = True,
                 dim_ordering: str = "tf", groups: int = 1, **kwargs):
        super().__init__(**kwargs)
        s = self.spatial
        self.nb_filter = int(nb_filter)
        self.kernel_size = tuple(int(k) for k in kernel_size)
        assert len(self.kernel_size) == s
        self.strides = tuple(int(v) for v in (strides or (1,) * s))
        self.dilation = tuple(int(v) for v in (dilation or (1,) * s))
        self.border_mode = border_mode
        _same_or_valid(border_mode)
        self.activation = acts.get(activation)
        self.kernel_init = init
        self.use_bias = bias
        self.dim_ordering = dim_ordering
        self.groups = int(groups)

    def _to_tf(self, shape):
        """Normalise a batch-incl. shape to channels-last ordering."""
        if self.dim_ordering == "th":
            return (shape[0],) + tuple(shape[2:]) + (shape[1],)
        return tuple(shape)

    def _from_tf(self, shape):
        if self.dim_ordering == "th":
            return (shape[0], shape[-1]) + tuple(shape[1:-1])
        return tuple(shape)

    def build(self, rng, input_shape) -> Params:
        in_ch = self._to_tf(input_shape)[-1]
        params: Params = {}
        kshape = self.kernel_size + (in_ch // self.groups, self.nb_filter)
        self.add_weight(params, rng, "kernel", kshape, init=self.kernel_init)
        if self.use_bias:
            self.add_weight(params, rng, "bias", (self.nb_filter,),
                            init="zero")
        return params

    def _convolve(self, x, kernel, quant=None):
        padding = _same_or_valid(self.border_mode)
        if quant is not None:
            # calibrated int8 path (ops/quant.py)
            return quantized_conv(
                x, kernel, quant["kernel_scale"], quant["act_scale"],
                strides=self.strides, padding=padding,
                rhs_dilation=self.dilation,
                feature_group_count=self.groups)
        return conv_nd(x, kernel, self.strides, padding, self.dilation,
                       self.groups)

    def call(self, params, x, training=False, rng=None):
        if self.dim_ordering == "th":
            x = x.movedim(1, -1)
        y = self._convolve(x, params["kernel"],
                           quant=params if "kernel_scale" in params
                           else None)
        if self.use_bias:
            y = y + params["bias"]
        if self.activation is not None:
            y = self.activation(y)
        if self.dim_ordering == "th":
            y = y.movedim(-1, 1)
        return y

    def compute_output_shape(self, input_shape):
        tf_shape = self._to_tf(input_shape)
        spatial = [
            _out_len(tf_shape[1 + i], self.kernel_size[i], self.strides[i],
                     self.border_mode, self.dilation[i])
            for i in range(self.spatial)
        ]
        out_tf = (tf_shape[0],) + tuple(spatial) + (self.nb_filter,)
        return self._from_tf(out_tf)


class Convolution1D(_ConvND):
    spatial = 1

    def __init__(self, nb_filter, filter_length, **kwargs):
        super().__init__(nb_filter, (filter_length,), **kwargs)


class Convolution2D(_ConvND):
    spatial = 2

    def __init__(self, nb_filter, nb_row, nb_col, subsample=(1, 1),
                 **kwargs):
        super().__init__(nb_filter, (nb_row, nb_col), strides=subsample,
                         **kwargs)


class Convolution3D(_ConvND):
    spatial = 3

    def __init__(self, nb_filter, kernel_dim1, kernel_dim2, kernel_dim3,
                 subsample=(1, 1, 1), **kwargs):
        super().__init__(nb_filter, (kernel_dim1, kernel_dim2, kernel_dim3),
                         strides=subsample, **kwargs)


class AtrousConvolution2D(_ConvND):
    """Dilated 2D convolution."""
    spatial = 2

    def __init__(self, nb_filter, nb_row, nb_col, subsample=(1, 1),
                 atrous_rate=(1, 1), **kwargs):
        super().__init__(nb_filter, (nb_row, nb_col), strides=subsample,
                         dilation=atrous_rate, **kwargs)


class AtrousConvolution1D(_ConvND):
    """Dilated 1D convolution."""
    spatial = 1

    def __init__(self, nb_filter, filter_length, subsample_length=1,
                 atrous_rate=1, **kwargs):
        super().__init__(nb_filter, (filter_length,),
                         strides=(subsample_length,),
                         dilation=(atrous_rate,), **kwargs)


# ------------------------------------------------------ shape-change layers
def _zero_pad(x, pads):
    """``x`` (N, *S, C) zero-padded by ``pads``, one (low, high) a
    spatial dim."""
    return F.pad(x, (0, 0) + pad_arg(pads))


class ZeroPadding1D(Layer):
    def __init__(self, padding=1, **kwargs):
        super().__init__(**kwargs)
        self.padding = (padding, padding) if np.isscalar(padding) \
            else tuple(padding)

    def call(self, params, x, training=False, rng=None):
        return _zero_pad(x, (self.padding,))

    def compute_output_shape(self, s):
        n = None if s[1] is None else s[1] + sum(self.padding)
        return (s[0], n, s[2])


class ZeroPadding2D(Layer):
    def __init__(self, padding=(1, 1), **kwargs):
        super().__init__(**kwargs)
        p = padding
        if len(p) == 2:
            self.padding = ((p[0], p[0]), (p[1], p[1]))
        else:
            self.padding = ((p[0], p[1]), (p[2], p[3]))

    def call(self, params, x, training=False, rng=None):
        return _zero_pad(x, self.padding)

    def compute_output_shape(self, s):
        h = None if s[1] is None else s[1] + sum(self.padding[0])
        w = None if s[2] is None else s[2] + sum(self.padding[1])
        return (s[0], h, w, s[3])


class ZeroPadding3D(Layer):
    def __init__(self, padding=(1, 1, 1), **kwargs):
        super().__init__(**kwargs)
        self.padding = tuple((p, p) for p in padding)

    def call(self, params, x, training=False, rng=None):
        return _zero_pad(x, self.padding)

    def compute_output_shape(self, s):
        dims = tuple(None if s[i + 1] is None
                     else s[i + 1] + sum(self.padding[i]) for i in range(3))
        return (s[0],) + dims + (s[4],)


class SpaceToDepth2D(Layer):
    """Pack ``block_size x block_size`` spatial blocks into channels:
    (B, H, W, C) -> (B, H/bs, W/bs, bs*bs*C), each block's pixels in
    row-major order, channels innermost (the reference's
    MLPerf-ResNet stem)."""

    def __init__(self, block_size: int = 2, **kwargs):
        super().__init__(**kwargs)
        self.block_size = int(block_size)

    def call(self, params, x, training=False, rng=None):
        b, h, w, c = x.shape
        s = self.block_size
        x = x.reshape(b, h // s, s, w // s, s, c)
        x = x.permute(0, 1, 3, 2, 4, 5)
        return x.reshape(b, h // s, w // s, s * s * c)

    def compute_output_shape(self, input_shape):
        b, h, w, c = input_shape
        s = self.block_size
        return (b, h // s, w // s, s * s * c)
