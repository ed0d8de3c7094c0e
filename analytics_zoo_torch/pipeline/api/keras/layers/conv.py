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

``SeparableConvolution2D`` is a depthwise convolution (one group a
channel) then a 1x1 one, both on ``conv_nd``.  ``Deconvolution2D`` is the
reference's ``lax.conv_transpose(..., transpose_kernel=True)`` with its
``(kh, kw, out, in)`` kernel: ``conv_transpose2d`` at no padding, then
each spatial axis cropped (or, where XLA pads past the kernel, extended
by zeros) to the padding ``lax.conv_transpose`` gives SAME or VALID.
``ShareConvolution2D`` is ``Convolution2D`` after explicit zero padding.

``ZeroPadding1D/2D/3D``, ``Cropping1D/2D/3D``, ``UpSampling1D/2D/3D`` and
``SpaceToDepth2D`` reshape the channels-last input as the reference
does.
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
                 dim_ordering: str = "tf", W_regularizer=None,
                 b_regularizer=None, groups: int = 1, **kwargs):
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
        self.W_regularizer = W_regularizer
        self.b_regularizer = b_regularizer

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
        self.add_weight(params, rng, "kernel", kshape, init=self.kernel_init,
                        regularizer=self.W_regularizer)
        if self.use_bias:
            self.add_weight(params, rng, "bias", (self.nb_filter,),
                            init="zero", regularizer=self.b_regularizer)
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


class ShareConvolution2D(_ConvND):
    """Weight-shared 2D convolution: sharing across applications is
    implicit (one params dict, any number of applies), so this is
    Convolution2D after (pad_h, pad_w) zero padding."""
    spatial = 2

    def __init__(self, nb_filter, nb_row, nb_col, subsample=(1, 1),
                 pad_h: int = 0, pad_w: int = 0, **kwargs):
        super().__init__(nb_filter, (nb_row, nb_col), strides=subsample,
                         **kwargs)
        self.pad_h = int(pad_h)
        self.pad_w = int(pad_w)

    def _pad_shape(self, shape):
        b, h, w, c = shape
        return (b, None if h is None else h + 2 * self.pad_h,
                None if w is None else w + 2 * self.pad_w, c)

    def _convolve(self, x, kernel, quant=None):
        # x arrives channels-last from _ConvND.call
        if self.pad_h or self.pad_w:
            x = _zero_pad(x, ((self.pad_h, self.pad_h),
                              (self.pad_w, self.pad_w)))
        return super()._convolve(x, kernel, quant=quant)

    def compute_output_shape(self, input_shape):
        padded = self._from_tf(self._pad_shape(self._to_tf(input_shape)))
        return super().compute_output_shape(padded)


class SeparableConvolution2D(Layer):
    """Depthwise convolution (``depth_multiplier`` filters a channel) then
    a pointwise 1x1 convolution, channels-last."""

    def __init__(self, nb_filter: int, nb_row: int, nb_col: int,
                 subsample=(1, 1), border_mode: str = "valid",
                 depth_multiplier: int = 1, activation=None,
                 init="glorot_uniform", bias: bool = True, **kwargs):
        super().__init__(**kwargs)
        self.nb_filter = int(nb_filter)
        self.kernel_size = (int(nb_row), int(nb_col))
        self.strides = tuple(subsample)
        self.border_mode = border_mode
        self.depth_multiplier = int(depth_multiplier)
        self.activation = acts.get(activation)
        self.kernel_init = init
        self.use_bias = bias

    def build(self, rng, input_shape) -> Params:
        in_ch = input_shape[-1]
        params: Params = {}
        self.add_weight(params, rng, "depthwise_kernel",
                        self.kernel_size + (1,
                                            in_ch * self.depth_multiplier),
                        init=self.kernel_init)
        self.add_weight(params, rng, "pointwise_kernel",
                        (1, 1, in_ch * self.depth_multiplier,
                         self.nb_filter), init=self.kernel_init)
        if self.use_bias:
            self.add_weight(params, rng, "bias", (self.nb_filter,),
                            init="zero")
        return params

    def call(self, params, x, training=False, rng=None):
        y = conv_nd(x, params["depthwise_kernel"], self.strides,
                    _same_or_valid(self.border_mode), (1, 1),
                    groups=x.shape[-1])
        y = conv_nd(y, params["pointwise_kernel"], (1, 1), "VALID", (1, 1))
        if self.use_bias:
            y = y + params["bias"]
        if self.activation is not None:
            y = self.activation(y)
        return y

    def compute_output_shape(self, input_shape):
        h = _out_len(input_shape[1], self.kernel_size[0], self.strides[0],
                     self.border_mode)
        w = _out_len(input_shape[2], self.kernel_size[1], self.strides[1],
                     self.border_mode)
        return (input_shape[0], h, w, self.nb_filter)


def _transpose_pads(k: int, s: int, padding: str):
    """``lax.conv_transpose``'s (low, high) padding of the stride-dilated
    input along one axis, for a kernel of ``k`` taps at stride ``s``."""
    if padding == "SAME":
        pad_len = k + s - 2
        pad_a = k - 1 if s > k - 1 else -(-pad_len // 2)
    else:
        pad_len = k + s - 2 + max(k - s, 0)
        pad_a = k - 1
    return pad_a, pad_len - pad_a


def conv_transpose_2d(x, kernel, strides, padding: str):
    """``lax.conv_transpose(x, kernel, strides, padding, ("NHWC", "HWIO",
    "NHWC"), transpose_kernel=True)`` on the float route: ``x`` (N, H, W,
    C), ``kernel`` (kh, kw, O, C), both rounded to the compute dtype; the
    result (N, OH, OW, O) in the compute dtype.  ``conv_transpose2d`` at
    no padding pads the dilated input by k - 1 on each side; each axis
    is then cropped to the reference's padding, or extended by zeros
    where that padding exceeds k - 1 (VALID at a stride above the
    kernel)."""
    cd = get_policy().compute_dtype
    xc, kc = x.to(cd), kernel.to(cd)
    if not x.is_cuda and cd != torch.float32:
        xc, kc = xc.float(), kc.float()
    y = F.conv_transpose2d(xc.movedim(-1, 1), kc.permute(3, 2, 0, 1),
                           stride=tuple(strides))
    for i, (k, s) in enumerate(zip(kernel.shape[:2], strides)):
        lo, hi = _transpose_pads(k, s, padding)
        axis = 2 + i
        n = y.shape[axis]
        y = y.narrow(axis, k - 1 - lo, n - (k - 1 - lo) - max(k - 1 - hi, 0))
        extra = hi - (k - 1)
        if extra > 0:
            pad = [0, 0, 0, 0]
            pad[2 * (1 - i) + 1] = extra
            y = F.pad(y, pad)
    return y.movedim(1, -1).to(cd)


class Deconvolution2D(Layer):
    """Transposed convolution with Keras / tf ``Conv2DTranspose``
    semantics (the gradient of a convolution), kernel ``(kh, kw,
    nb_filter, in)``."""

    def __init__(self, nb_filter: int, nb_row: int, nb_col: int,
                 subsample=(1, 1), border_mode: str = "valid",
                 activation=None, init="glorot_uniform", bias: bool = True,
                 **kwargs):
        super().__init__(**kwargs)
        self.nb_filter = int(nb_filter)
        self.kernel_size = (int(nb_row), int(nb_col))
        self.strides = tuple(subsample)
        self.border_mode = border_mode
        self.activation = acts.get(activation)
        self.kernel_init = init
        self.use_bias = bias

    def build(self, rng, input_shape) -> Params:
        in_ch = input_shape[-1]
        params: Params = {}
        self.add_weight(params, rng, "kernel",
                        self.kernel_size + (self.nb_filter, in_ch),
                        init=self.kernel_init)
        if self.use_bias:
            self.add_weight(params, rng, "bias", (self.nb_filter,),
                            init="zero")
        return params

    def call(self, params, x, training=False, rng=None):
        y = conv_transpose_2d(x, params["kernel"], self.strides,
                              _same_or_valid(self.border_mode))
        if self.use_bias:
            y = y + params["bias"]
        if self.activation is not None:
            y = self.activation(y)
        return y

    def compute_output_shape(self, input_shape):
        def up(n, k, s):
            if n is None:
                return None
            if self.border_mode == "same":
                return n * s
            return n * s + max(k - s, 0)
        h = up(input_shape[1], self.kernel_size[0], self.strides[0])
        w = up(input_shape[2], self.kernel_size[1], self.strides[1])
        return (input_shape[0], h, w, self.nb_filter)


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


class Cropping1D(Layer):
    def __init__(self, cropping=(1, 1), **kwargs):
        super().__init__(**kwargs)
        self.cropping = tuple(cropping)

    def call(self, params, x, training=False, rng=None):
        a, b = self.cropping
        return x[:, a:x.shape[1] - b]

    def compute_output_shape(self, s):
        n = None if s[1] is None else s[1] - sum(self.cropping)
        return (s[0], n, s[2])


class Cropping2D(Layer):
    def __init__(self, cropping=((0, 0), (0, 0)), **kwargs):
        super().__init__(**kwargs)
        self.cropping = tuple(tuple(c) for c in cropping)

    def call(self, params, x, training=False, rng=None):
        (t, b), (l, r) = self.cropping
        return x[:, t:x.shape[1] - b, l:x.shape[2] - r]

    def compute_output_shape(self, s):
        h = None if s[1] is None else s[1] - sum(self.cropping[0])
        w = None if s[2] is None else s[2] - sum(self.cropping[1])
        return (s[0], h, w, s[3])


class Cropping3D(Layer):
    def __init__(self, cropping=((1, 1), (1, 1), (1, 1)), **kwargs):
        super().__init__(**kwargs)
        self.cropping = tuple(tuple(c) for c in cropping)

    def call(self, params, x, training=False, rng=None):
        (a1, b1), (a2, b2), (a3, b3) = self.cropping
        return x[:, a1:x.shape[1] - b1, a2:x.shape[2] - b2,
                 a3:x.shape[3] - b3]

    def compute_output_shape(self, s):
        dims = tuple(None if s[i + 1] is None
                     else s[i + 1] - sum(self.cropping[i]) for i in range(3))
        return (s[0],) + dims + (s[4],)


class UpSampling1D(Layer):
    def __init__(self, length=2, **kwargs):
        super().__init__(**kwargs)
        self.length = int(length)

    def call(self, params, x, training=False, rng=None):
        return x.repeat_interleave(self.length, dim=1)

    def compute_output_shape(self, s):
        n = None if s[1] is None else s[1] * self.length
        return (s[0], n, s[2])


class UpSampling2D(Layer):
    def __init__(self, size=(2, 2), **kwargs):
        super().__init__(**kwargs)
        self.size = tuple(size)

    def call(self, params, x, training=False, rng=None):
        return x.repeat_interleave(self.size[0], dim=1) \
            .repeat_interleave(self.size[1], dim=2)

    def compute_output_shape(self, s):
        h = None if s[1] is None else s[1] * self.size[0]
        w = None if s[2] is None else s[2] * self.size[1]
        return (s[0], h, w, s[3])


class UpSampling3D(Layer):
    def __init__(self, size=(2, 2, 2), **kwargs):
        super().__init__(**kwargs)
        self.size = tuple(size)

    def call(self, params, x, training=False, rng=None):
        for i, r in enumerate(self.size):
            x = x.repeat_interleave(r, dim=1 + i)
        return x

    def compute_output_shape(self, s):
        dims = tuple(None if s[i + 1] is None else s[i + 1] * self.size[i]
                     for i in range(3))
        return (s[0],) + dims + (s[4],)
