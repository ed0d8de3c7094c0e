"""int8 products and the calibrated quantization workflow (port of
``ops/quant.py``).

Symmetric per-tensor ACTIVATION scales (recorded by a calibration pass)
and per-output-channel WEIGHT scales; a product runs int8 x int8 ->
int32 and rescales to float32 in the epilogue,
``acc.float() * (act_scale * kernel_scale)``, the two scales multiplied
first as the reference does.  The quantized path is params-driven: a
layer whose params carry ``kernel_scale``/``act_scale`` (with an int8
``kernel``) executes quantized, so the same model object serves float32
and int8.

Each integer product has two routes, chosen by the device of its
operands and the ``ops.fused`` mode:

* on the card, ``torch._int_mm`` (an int8 GEMM with an int32 result).
  Its CUDA shape rules (more than 16 rows, inner and output dimensions
  multiples of 8) are met by zero padding, which is exact in integer
  arithmetic, and the result is sliced back.  Its second operand goes in
  column-major (cuBLASLt's "TN" int8 layout): row-major, cuBLASLt
  refuses many shapes on an H100 (``CUBLAS_STATUS_NOT_SUPPORTED``;
  ``scripts/probe_int_mm.py`` sweeps them), so ``quantize_model`` stores
  int8 kernels with their output channels outermost
  (``int8_kernel_layout``).  A convolution is the same
  product over its unfolded input: every kernel tap's strided, dilated
  view of the padded input side by side (``_unfold``), one product a
  group.
* on the CPU, or under ``ops.fused=torch`` ("the plain versions
  everywhere"), the plain route: the operands widened to float64, the
  product or ``conv{1,2,3}d`` taken there and the result cast back to
  int32.  Every partial sum is an integer below 2^53 for inner dimensions
  below 2^53 / 127^2, so the result is exact in any order of summation.

The card route never falls back to the plain one.  All layouts are
channels-last, as the conv layers pass them.
"""

from __future__ import annotations

import itertools
from typing import Dict, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from analytics_zoo_torch.pipeline.api.keras.topology import (
    tree_leaves, tree_map,
)

#: the shape rules of ``torch._int_mm`` on CUDA
_MIN_ROWS = 17
_MULTIPLE = 8


def quantize_activation(x: torch.Tensor, act_scale) -> torch.Tensor:
    """Symmetric int8 quantization with a calibrated scale: ±127, never
    -128; rounding half to even.  ``act_scale`` is a 0-d float32 tensor on
    ``x``'s device (a true division: CUDA takes a host scalar's
    reciprocal instead)."""
    return torch.clamp(torch.round(x.float() / act_scale),
                       -127, 127).to(torch.int8)


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def int8_kernel_layout(kq: torch.Tensor) -> torch.Tensor:
    """``kq`` with its last (output channel) dim outermost in memory, the
    same shape and values: its (K, N) matrix view is column-major, which
    the card route hands ``torch._int_mm`` without a copy."""
    return kq.movedim(-1, 0).contiguous().movedim(0, -1)


def _column_major(b: torch.Tensor) -> torch.Tensor:
    return b if b.t().is_contiguous() else b.t().contiguous().t()


def _int_mm_card(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(M, K) int8 @ (K, N) int8 -> (M, N) int32 by ``torch._int_mm``,
    zero padded to its shape rules, ``b`` column-major."""
    m, k = a.shape
    n = b.shape[1]
    mp, kp, np_ = max(m, _MIN_ROWS), _round_up(k, _MULTIPLE), \
        _round_up(n, _MULTIPLE)
    if (mp, kp) != (m, k):
        a = F.pad(a, (0, kp - k, 0, mp - m))
    if (kp, np_) != (k, n):
        b = F.pad(b, (0, np_ - n, 0, kp - k))
    out = torch._int_mm(a.contiguous(), _column_major(b))
    return out if (mp, np_) == (m, n) else out[:m, :n]


def _int_mm_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a.double() @ b.double()).to(torch.int32)


def _card_route(t: torch.Tensor) -> bool:
    from analytics_zoo_torch.ops.fused import _mode
    return t.is_cuda and _mode() != "torch"


def int8_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact ``a @ b`` over the last dim of int8 ``a`` and dim 0 of the
    (K, N) int8 ``b``, as int32: ``torch._int_mm`` for CUDA tensors, the
    plain route for CPU tensors or under ``ops.fused=torch``."""
    lead = a.shape[:-1]
    a2 = a.reshape(-1, a.shape[-1])
    mm = _int_mm_card if _card_route(a) else _int_mm_plain
    return mm(a2, b).reshape(*lead, b.shape[-1])


def _epilogue(acc, kernel_scale, act_scale):
    scale = act_scale * kernel_scale.reshape(
        (1,) * (acc.ndim - 1) + (-1,))
    return acc.float() * scale


def quantized_matmul(x, kernel_q, kernel_scale, act_scale):
    """int8 x int8 -> int32 contraction over the last dim of ``x`` and
    the first of ``kernel_q``, float32 rescale epilogue.
    ``kernel_scale`` has keepdims shape (1, ..., out)."""
    xq = quantize_activation(x, act_scale)
    return _epilogue(int8_matmul(xq, kernel_q), kernel_scale, act_scale)


# ----------------------------------------------------------- convolution
def conv_padding(in_sizes: Sequence[int], kernel_size: Sequence[int],
                 strides: Sequence[int], dilation: Sequence[int],
                 padding: str) -> Tuple[Tuple[int, int], ...]:
    """(low, high) zero padding per spatial dim of XLA's ``"SAME"`` or
    ``"VALID"``: SAME pads ``max((out - 1) * stride + window - n, 0)`` with
    ``out = ceil(n / stride)``, the low side taking the smaller half."""
    if padding == "VALID":
        return tuple((0, 0) for _ in in_sizes)
    pads = []
    for n, k, s, d in zip(in_sizes, kernel_size, strides, dilation):
        window = (k - 1) * d + 1
        total = max((-(-n // s) - 1) * s + window - n, 0)
        pads.append((total // 2, total - total // 2))
    return tuple(pads)


def pad_arg(pads) -> Tuple[int, ...]:
    """``F.pad``'s argument for channels-first spatial pads: last dim
    first."""
    return tuple(v for lo_hi in reversed(pads) for v in lo_hi)


def _unfold(x, kernel_size, strides, dilation, pads):
    """(N, *S, C) -> (N, *out, taps, C): each kernel tap's strided and
    dilated view of the zero-padded input, in the kernel's row-major tap
    order."""
    spatial = len(kernel_size)
    x = F.pad(x, (0, 0) + pad_arg(pads))
    out = [(x.shape[1 + i] - (kernel_size[i] - 1) * dilation[i] - 1)
           // strides[i] + 1 for i in range(spatial)]
    taps = []
    for offs in itertools.product(*(range(k) for k in kernel_size)):
        idx = tuple(slice(o * d, o * d + (n - 1) * s + 1, s)
                    for o, d, n, s in zip(offs, dilation, out, strides))
        taps.append(x[(slice(None),) + idx])
    return torch.stack(taps, dim=-2), out


def _int_conv_card(xq, kq, strides, pads, dilation, groups):
    spatial = kq.ndim - 2
    cols, out = _unfold(xq, kq.shape[:spatial], strides, dilation, pads)
    n_taps, cin = cols.shape[-2], cols.shape[-1]
    cols = cols.reshape(-1, n_taps, groups, cin // groups)
    cout = kq.shape[-1]
    w = kq.reshape(n_taps * (cin // groups), cout)
    og = cout // groups
    parts = [_int_mm_card(cols[:, :, g].reshape(cols.shape[0], -1),
                          w[:, g * og:(g + 1) * og])
             for g in range(groups)]
    acc = parts[0] if groups == 1 else torch.cat(parts, dim=-1)
    return acc.reshape(xq.shape[0], *out, cout)


def _int_conv_plain(xq, kq, strides, pads, dilation, groups):
    spatial = kq.ndim - 2
    x = F.pad(xq.double().movedim(-1, 1), pad_arg(pads))
    w = kq.double().permute(spatial + 1, spatial, *range(spatial))
    y = getattr(F, f"conv{spatial}d")(x, w, stride=tuple(strides),
                                      dilation=tuple(dilation), groups=groups)
    return y.movedim(1, -1).to(torch.int32)


def int8_conv(xq, kq, strides, padding: str, rhs_dilation,
              groups: int = 1) -> torch.Tensor:
    """Exact int8 convolution with an int32 result, channels-last: ``xq``
    (N, *S, C), ``kq`` (*K, C / groups, O); ``padding`` "SAME" or "VALID"
    as XLA reads them."""
    spatial = kq.ndim - 2
    pads = conv_padding(xq.shape[1:1 + spatial], kq.shape[:spatial],
                        strides, rhs_dilation, padding)
    conv = _int_conv_card if _card_route(xq) else _int_conv_plain
    return conv(xq, kq, tuple(strides), pads, tuple(rhs_dilation), groups)


def quantized_conv(x, kernel_q, kernel_scale, act_scale, *, strides,
                   padding, rhs_dilation, feature_group_count: int = 1):
    """int8 conv -> int32 accumulation, float32 rescale epilogue."""
    xq = quantize_activation(x, act_scale)
    acc = int8_conv(xq, kernel_q, strides, padding, rhs_dilation,
                    feature_group_count)
    return _epilogue(acc, kernel_scale, act_scale)


# -------------------------------------------------- model-level workflow
def _variables_device(variables) -> torch.device:
    for leaf in tree_leaves(variables["params"]):
        if isinstance(leaf, torch.Tensor):
            return leaf.device
    return torch.device("cpu")


def calibrate_model(model, calib_data, batch_size: int = 32,
                    max_batches: int = 8) -> Dict[str, float]:
    """Calibration pass: forwards over ``calib_data`` recording each
    layer's input absmax through the engine's activation taps.
    ``calib_data`` is an array, a list of arrays (one per model input) or
    a FeatureSet; returns ``{layer_name: max |input|}``."""
    from analytics_zoo_torch.feature.feature_set import FeatureSet
    from analytics_zoo_torch.pipeline.api.keras.engine import (
        record_activations)
    variables = model.get_variables()
    device = _variables_device(variables)
    if isinstance(calib_data, FeatureSet):
        batches = (b[0] for b in calib_data.epoch_batches(
            0, batch_size, train=False))
    else:
        n = len(tree_leaves(calib_data)[0])
        batches = (tree_map(lambda a: a[i:i + batch_size], calib_data)
                   for i in range(0, n, batch_size))

    def put(a):
        return torch.as_tensor(np.ascontiguousarray(a)).to(device) \
            if not isinstance(a, torch.Tensor) else a.to(device)

    ranges: Dict[str, float] = {}
    with record_activations() as taps, torch.inference_mode():
        for i, xb in enumerate(batches):
            if i >= max_batches:
                break
            model.apply(variables["params"], tree_map(put, xb),
                        state=variables["state"], training=False)
        ranges.update(taps)
    return ranges


def weight_scale(arr: np.ndarray) -> np.ndarray:
    """Per-last-axis scales with keepdims shape (1, ..., out), on the
    host in numpy as the reference computes them."""
    axes = tuple(range(arr.ndim - 1))
    return np.maximum(np.max(np.abs(arr), axis=axes, keepdims=True)
                      / 127.0, 1e-12).astype(np.float32)


def quantize_weight(arr: np.ndarray, scale: np.ndarray) -> np.ndarray:
    return np.clip(np.round(arr / scale), -127, 127).astype(np.int8)


def quantize_model(variables, act_ranges, min_size: int = 1024):
    """The params-driven int8 layout from calibrated ranges: per layer an
    int8 ``kernel`` (output channels outermost in memory,
    ``int8_kernel_layout``), a per-output-channel ``kernel_scale`` (keepdims,
    shape ``(1, ..., out)``) and a 0-d ``act_scale``, each on the
    kernel's device.  Layers whose params carry those keys execute
    ``quantized_matmul``/``quantized_conv``; everything else is left as
    it is."""
    params = variables["params"]
    qparams = {}
    for lname, p in params.items():
        qp = dict(p) if isinstance(p, dict) else p
        k = p.get("kernel") if isinstance(p, dict) else None
        rng_max = act_ranges.get(lname, 0.0)
        if k is not None and rng_max > 0.0 and k.dtype == torch.float32 \
                and k.ndim >= 2 and k.numel() >= min_size:
            arr = k.detach().cpu().numpy()
            w_scale = weight_scale(arr)
            qp["kernel"] = int8_kernel_layout(torch.from_numpy(
                quantize_weight(arr, w_scale)).to(k.device))
            qp["kernel_scale"] = torch.from_numpy(w_scale).to(k.device)
            # the scale in Python doubles, then float32, as the reference
            qp["act_scale"] = torch.from_numpy(np.asarray(
                np.float32(max(rng_max / 127.0, 1e-12)))).to(k.device)
        qparams[lname] = qp
    return {"params": qparams, "state": variables["state"]}


