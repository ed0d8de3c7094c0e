"""Element-wise, threshold, learnable-scale and normalization layers
(port of ``pipeline/api/keras/layers/elementwise.py``).

Reference surface: zoo/pipeline/api/keras/layers/{AddConstant, MulConstant,
Exp, Log, Sqrt, Square, Power, Negative, Identity, Threshold,
BinaryThreshold, HardShrink, SoftShrink, HardTanh, RReLU, CAdd, CMul, Mul,
Scale, LRN2D, WithinChannelLRN2D, ResizeBilinear, GaussianSampler}.scala.

``RReLU`` (in training) and ``GaussianSampler`` draw on the input's
device from the ``torch.Generator`` they are given, which must live
there; they never draw from a global generator.  ``ResizeBilinear``
computes the reference's ``jax.image.resize(method="bilinear")``: per
axis an (out, in) weight matrix with half-pixel centres and, when it
shrinks the axis, the triangle kernel stretched by the scale
(antialiasing), each column normalised; the image is contracted with one
matrix per resized axis.  ``F.interpolate`` computes neither form.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F

from analytics_zoo_torch.ops.quant import conv_padding, pad_arg
from analytics_zoo_torch.pipeline.api.keras.engine import Layer, Params


class _Elementwise(Layer):
    """Base for parameter-free identity-shaped layers."""

    def compute_output_shape(self, input_shape):
        return tuple(input_shape)


class AddConstant(_Elementwise):
    """y = x + constant."""

    def __init__(self, constant: float, **kwargs):
        super().__init__(**kwargs)
        self.constant = float(constant)

    def call(self, params, x, training=False, rng=None):
        return x + self.constant


class MulConstant(_Elementwise):
    """y = x * constant."""

    def __init__(self, constant: float, **kwargs):
        super().__init__(**kwargs)
        self.constant = float(constant)

    def call(self, params, x, training=False, rng=None):
        return x * self.constant


class Exp(_Elementwise):
    def call(self, params, x, training=False, rng=None):
        return torch.exp(x)


class Log(_Elementwise):
    def call(self, params, x, training=False, rng=None):
        return torch.log(x)


class Sqrt(_Elementwise):
    def call(self, params, x, training=False, rng=None):
        return torch.sqrt(x)


class Square(_Elementwise):
    def call(self, params, x, training=False, rng=None):
        return torch.square(x)


class Power(_Elementwise):
    """y = (shift + scale * x) ** power, with IEEE ``pow``'s values, as
    ``jnp.power`` gives them: the exponent is a 0-dim tensor in the input's
    dtype on the input's device, because ``torch.pow`` with a Python
    exponent (or, on a CUDA input, a CPU one) of 0.5 or -0.5 takes ``sqrt``
    or ``rsqrt``, which give NaN at -inf and keep the sign of -0.0."""

    def __init__(self, power: float, scale: float = 1.0,
                 shift: float = 0.0, **kwargs):
        super().__init__(**kwargs)
        self.power = float(power)
        self.scale = float(scale)
        self.shift = float(shift)

    def call(self, params, x, training=False, rng=None):
        base = self.shift + self.scale * x
        return torch.pow(base, base.new_full((), self.power))


class Negative(_Elementwise):
    def call(self, params, x, training=False, rng=None):
        return -x


class Identity(_Elementwise):
    """y = x: graph plumbing and debugging."""

    def call(self, params, x, training=False, rng=None):
        return x


class Threshold(_Elementwise):
    """y = x if x > th else v."""

    def __init__(self, th: float = 1e-6, v: float = 0.0, **kwargs):
        super().__init__(**kwargs)
        self.th = float(th)
        self.v = float(v)

    def call(self, params, x, training=False, rng=None):
        return torch.where(x > self.th, x, torch.full_like(x, self.v))


class BinaryThreshold(_Elementwise):
    """y = 1 if x > value else 0."""

    def __init__(self, value: float = 1e-6, **kwargs):
        super().__init__(**kwargs)
        self.value = float(value)

    def call(self, params, x, training=False, rng=None):
        return (x > self.value).to(x.dtype)


class HardShrink(_Elementwise):
    """y = x if |x| > value else 0."""

    def __init__(self, value: float = 0.5, **kwargs):
        super().__init__(**kwargs)
        self.value = float(value)

    def call(self, params, x, training=False, rng=None):
        return torch.where(x.abs() > self.value, x, torch.zeros_like(x))


class SoftShrink(_Elementwise):
    """y = sign(x) * max(|x| - value, 0)."""

    def __init__(self, value: float = 0.5, **kwargs):
        super().__init__(**kwargs)
        self.value = float(value)

    def call(self, params, x, training=False, rng=None):
        return torch.sign(x) * torch.clamp(x.abs() - self.value, min=0.0)


class HardTanh(_Elementwise):
    """y = clip(x, min_value, max_value)."""

    def __init__(self, min_value: float = -1.0, max_value: float = 1.0,
                 **kwargs):
        super().__init__(**kwargs)
        self.min_value = float(min_value)
        self.max_value = float(max_value)

    def call(self, params, x, training=False, rng=None):
        return torch.clamp(x, self.min_value, self.max_value)


class RReLU(_Elementwise):
    """Randomized leaky ReLU: in training with an rng, negative slopes
    drawn from U(lower, upper) per element; otherwise the mean slope."""

    def __init__(self, lower: float = 1.0 / 8, upper: float = 1.0 / 3,
                 **kwargs):
        super().__init__(**kwargs)
        self.lower = float(lower)
        self.upper = float(upper)

    def call(self, params, x, training=False, rng=None):
        if training and rng is not None:
            slope = torch.rand(tuple(x.shape), generator=rng,
                               device=x.device, dtype=x.dtype)
            slope = slope * (self.upper - self.lower) + self.lower
        else:
            slope = (self.lower + self.upper) / 2
        return torch.where(x >= 0, x, slope * x)


class CAdd(_Elementwise):
    """Learnable bias of broadcastable ``size`` (the reference's
    ``size`` includes the batch dim: use 1 there)."""

    def __init__(self, size: Sequence[int], b_regularizer=None, **kwargs):
        super().__init__(**kwargs)
        self.size = tuple(int(s) for s in size)
        self.b_regularizer = b_regularizer

    def build(self, rng, input_shape) -> Params:
        params: Params = {}
        self.add_weight(params, rng, "bias", self.size, init="zero",
                        regularizer=self.b_regularizer)
        return params

    def call(self, params, x, training=False, rng=None):
        return x + params["bias"]


class CMul(_Elementwise):
    """Learnable scale of broadcastable ``size``."""

    def __init__(self, size: Sequence[int], W_regularizer=None, **kwargs):
        super().__init__(**kwargs)
        self.size = tuple(int(s) for s in size)
        self.W_regularizer = W_regularizer

    def build(self, rng, input_shape) -> Params:
        params: Params = {}
        self.add_weight(params, rng, "weight", self.size, init="one",
                        regularizer=self.W_regularizer)
        return params

    def call(self, params, x, training=False, rng=None):
        return x * params["weight"]


class Mul(_Elementwise):
    """One learnable scalar multiplier."""

    def build(self, rng, input_shape) -> Params:
        params: Params = {}
        self.add_weight(params, rng, "weight", (1,), init="one")
        return params

    def call(self, params, x, training=False, rng=None):
        return x * params["weight"][0]


class Scale(_Elementwise):
    """CMul then CAdd, both of ``size``."""

    def __init__(self, size: Sequence[int], **kwargs):
        super().__init__(**kwargs)
        self.size = tuple(int(s) for s in size)

    def build(self, rng, input_shape) -> Params:
        params: Params = {}
        self.add_weight(params, rng, "weight", self.size, init="one")
        self.add_weight(params, rng, "bias", self.size, init="zero")
        return params

    def call(self, params, x, training=False, rng=None):
        return x * params["weight"] + params["bias"]


def _to_channels_last(x, dim_ordering):
    return x.movedim(1, -1) if dim_ordering == "th" else x


def _from_channels_last(x, dim_ordering):
    return x.movedim(-1, 1) if dim_ordering == "th" else x


class LRN2D(Layer):
    """Cross-channel local response normalization:
    y = x / (k + alpha/n * sum_{local n channels} x^2) ** beta, the window
    zero-padded at the ends of the channel axis."""

    def __init__(self, alpha: float = 1e-4, k: float = 1.0,
                 beta: float = 0.75, n: int = 5,
                 dim_ordering: str = "tf", **kwargs):
        super().__init__(**kwargs)
        self.alpha = float(alpha)
        self.k = float(k)
        self.beta = float(beta)
        self.n = int(n)
        self.dim_ordering = dim_ordering

    def compute_output_shape(self, input_shape):
        return tuple(input_shape)

    def call(self, params, x, training=False, rng=None):
        y = _to_channels_last(x, self.dim_ordering)
        sq = torch.square(y)
        c = y.shape[-1]
        # the reference's order of summation: the centre, then the pair
        # of channels at each offset, the higher one first
        acc = sq
        for off in range(1, self.n // 2 + 1):
            acc = acc + F.pad(sq[..., off:], (0, off))
            acc = acc + F.pad(sq[..., :c - off], (off, 0))
        denom = torch.pow(self.k + self.alpha / self.n * acc, self.beta)
        return _from_channels_last(y / denom, self.dim_ordering)


class WithinChannelLRN2D(Layer):
    """Within-channel LRN over a size x size spatial window of an NHWC
    input: y = x / (1 + alpha * mean(x^2 over the window)) ** beta, the
    mean over the window's positions inside the image."""

    def __init__(self, size: int = 5, alpha: float = 1.0,
                 beta: float = 0.75, **kwargs):
        super().__init__(**kwargs)
        self.size = int(size)
        self.alpha = float(alpha)
        self.beta = float(beta)

    def compute_output_shape(self, input_shape):
        return tuple(input_shape)

    def _window_sum(self, v):
        """The sums over each position's SAME window (XLA's split)."""
        k = (self.size, self.size)
        pads = conv_padding(v.shape[1:3], k, (1, 1), (1, 1), "SAME")
        v = F.pad(v.movedim(-1, 1), pad_arg(pads))
        s = F.avg_pool2d(v, k, stride=1, divisor_override=1)
        return s.movedim(1, -1)

    def call(self, params, x, training=False, rng=None):
        sq = torch.square(x)
        summed = self._window_sum(sq)
        counts = self._window_sum(torch.ones_like(sq))
        denom = torch.pow(1.0 + self.alpha * summed / counts, self.beta)
        return x / denom


def resize_weights(in_len: int, out_len: int, device=None,
                   dtype=torch.float32):
    """The (in, out) weight matrix of ``jax.image.resize``'s linear kernel
    along one axis (``scale_and_translate`` with no translation,
    antialiased): half-pixel sample positions, the triangle kernel
    widened by 1/scale when shrinking, columns normalised, samples
    outside the input zeroed.  Computed in float32, as the reference."""
    scale = out_len / in_len
    inv_scale = 1.0 / scale
    kernel_scale = max(inv_scale, 1.0)
    sample = ((torch.arange(out_len, dtype=torch.float32) + 0.5)
              * inv_scale - 0.5)
    x = (sample[None, :] - torch.arange(in_len, dtype=torch.float32)[:, None]
         ).abs() / kernel_scale
    w = torch.clamp(1 - x.abs(), min=0.0)
    total = w.sum(dim=0, keepdim=True)
    eps = 1000.0 * float(torch.finfo(torch.float32).eps)
    w = torch.where(total.abs() > eps,
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= in_len - 0.5)
    w = torch.where(inside[None, :], w, torch.zeros_like(w))
    return w.to(device=device, dtype=dtype)


class ResizeBilinear(Layer):
    """Bilinear spatial resize to (output_height, output_width).  Without
    ``align_corners`` it is ``jax.image.resize(method="bilinear")``
    (antialiased when shrinking; see the module docstring); with it, a
    corner-aligned grid src = dst * (in - 1) / (out - 1) and linear
    interpolation between the two nearest rows and columns."""

    def __init__(self, output_height: int, output_width: int,
                 align_corners: bool = False, dim_ordering: str = "tf",
                 **kwargs):
        super().__init__(**kwargs)
        self.output_height = int(output_height)
        self.output_width = int(output_width)
        self.align_corners = bool(align_corners)
        self.dim_ordering = dim_ordering

    def compute_output_shape(self, input_shape):
        b, h, w, c = (input_shape if self.dim_ordering == "tf"
                      else (input_shape[0], input_shape[2],
                            input_shape[3], input_shape[1]))
        out = (b, self.output_height, self.output_width, c)
        if self.dim_ordering == "th":
            out = (b, c, self.output_height, self.output_width)
        return out

    def call(self, params, x, training=False, rng=None):
        y = _to_channels_last(x, self.dim_ordering)
        if self.align_corners:
            y = self._resize_align_corners(y)
        else:
            y = self._resize_half_pixel(y)
        return _from_channels_last(y, self.dim_ordering)

    def _resize_half_pixel(self, y):
        # an axis whose size does not change is left as it is, as in
        # jax.image.resize
        _, h, w, _ = y.shape
        if h != self.output_height:
            wh = resize_weights(h, self.output_height, y.device, y.dtype)
            y = torch.einsum("bhwc,ho->bowc", y, wh)
        if w != self.output_width:
            ww = resize_weights(w, self.output_width, y.device, y.dtype)
            y = torch.einsum("bhwc,wo->bhoc", y, ww)
        return y

    def _resize_align_corners(self, y):
        def lerp_axis(arr, axis, out_len):
            in_len = arr.shape[axis]
            if out_len == 1 or in_len == 1:
                idx = torch.zeros(out_len, dtype=torch.long,
                                  device=arr.device)
                return arr.index_select(axis, idx)
            # jnp.linspace's float32 arithmetic: (in - 1) * (i / div),
            # the endpoint exact
            div = out_len - 1
            step = torch.arange(div, dtype=torch.float32,
                                device=arr.device) / div
            src = torch.cat([(in_len - 1.0) * step,
                             torch.full((1,), in_len - 1.0,
                                        device=arr.device)])
            lo = torch.floor(src).long()
            hi = torch.clamp(lo + 1, max=in_len - 1)
            frac = (src - lo).to(arr.dtype)
            shape = [1] * arr.ndim
            shape[axis] = out_len
            frac = frac.reshape(shape)
            return (arr.index_select(axis, lo) * (1 - frac)
                    + arr.index_select(axis, hi) * frac)

        y = lerp_axis(y, 1, self.output_height)
        return lerp_axis(y, 2, self.output_width)


class GaussianSampler(Layer):
    """VAE reparameterisation: inputs [mean, log_var] ->
    mean + exp(log_var / 2) * eps, eps drawn whenever an rng is given.
    Without one the layer returns the mean in eval and refuses to train
    (a fixed generator would repeat the same noise every step)."""

    def compute_output_shape(self, input_shape):
        return tuple(input_shape[0])

    def call(self, params, inputs, training=False, rng=None):
        mean, log_var = inputs
        if rng is None:
            if training:
                raise ValueError(
                    "GaussianSampler needs an rng when training "
                    "(pass rng= through apply/fit)")
            return mean
        eps = torch.randn(tuple(mean.shape), generator=rng,
                          device=mean.device, dtype=mean.dtype)
        return mean + torch.exp(log_var * 0.5) * eps
