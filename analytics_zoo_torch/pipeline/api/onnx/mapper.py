"""ONNX op → port layer converters (port of the JAX package's
``pipeline/api/onnx/mapper.py``).

Each ONNX node becomes an :class:`OnnxOp` — a framework ``Layer`` whose
forward is the ONNX semantics written in PyTorch ops on NCHW tensors
(ONNX broadcast rules), and whose weights (pulled from graph
initializers) are real params: the imported ``Model`` trains and serves
like any native graph.  The reference's rules carry over where torch and
ONNX commonly disagree: SAME_UPPER/SAME_LOWER pad splits (``_pads_pairs``),
ceil-mode pooling (the end pad widened), average pooling that excludes
pads (a window sum over the padded input, divided by the count of real
positions), softmax before opset 13 (flattened to 2-D), LRN's window sum
over the channel axis, and ``Resize``/``Upsample`` as ``jax.image.resize``
computes it (half-pixel nearest indices; antialiased triangle and Keys
cubic weights).  Constant folding on numpy constants stays on the host.

A weight's dtype is the reference's: 64-bit integers and floats are
stored 32-bit, as JAX stores them without x64.

Output shapes are inferred by running the op on the ``meta`` device (the
batch dim probed with 2 and restored to ``None``), so every converter
only has to state the math once.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from analytics_zoo_torch.pipeline.api.keras.engine import Layer

CONVERTERS: Dict[str, Callable] = {}

# 64-bit numpy dtypes narrowed as JAX narrows them without x64
_NARROW = {np.dtype(np.int64): np.int32, np.dtype(np.uint64): np.uint32,
           np.dtype(np.float64): np.float32,
           np.dtype(np.complex128): np.complex64}


def canonical(arr) -> np.ndarray:
    """``arr`` with the dtype ``jnp.asarray`` would give it."""
    arr = np.asarray(arr)
    to = _NARROW.get(arr.dtype)
    return arr.astype(to) if to is not None else arr


def _tensor(arr, device=None) -> torch.Tensor:
    return torch.from_numpy(np.array(canonical(arr), copy=True)).to(device)


def _torch_dtype(np_dtype) -> torch.dtype:
    return _tensor(np.zeros((), np_dtype)).dtype


def converts(*op_types):
    def deco(fn):
        for op in op_types:
            CONVERTERS[op] = fn
        return fn
    return deco


class OnnxOp(Layer):
    """One ONNX node as a framework layer.

    ``fn(params, inputs, training, rng) -> output`` where ``inputs`` is
    always a list of tensors; ``weights`` become the layer's params.
    """

    def __init__(self, fn, weights: Optional[Dict[str, np.ndarray]] = None,
                 n_outputs: int = 1, **kwargs):
        super().__init__(**kwargs)
        self.fn = fn
        self.weights = {k: canonical(v) for k, v in (weights or {}).items()}
        self.n_outputs = n_outputs

    def build(self, rng, input_shape):
        return {k: _tensor(v) for k, v in self.weights.items()}

    def call(self, params, inputs, training=False, rng=None):
        ins = inputs if isinstance(inputs, (list, tuple)) else [inputs]
        return self.fn(params, list(ins), training, rng)

    def compute_output_shape(self, input_shape):
        shapes = (input_shape if isinstance(input_shape, list)
                  else [input_shape])
        dynamic = [s[0] is None if len(s) else False for s in shapes]
        probe = [torch.empty(tuple(2 if d is None else int(d) for d in s),
                             dtype=torch.float32, device="meta")
                 for s in shapes]
        pprobe = {k: torch.empty(v.shape, dtype=_torch_dtype(v.dtype),
                                 device="meta")
                  for k, v in self.weights.items()}
        out = self.fn(pprobe, probe, False, None)
        any_dyn = any(dynamic)

        def restore(o):
            s = tuple(int(d) for d in o.shape)
            if any_dyn and len(s) and s[0] == 2:
                return (None,) + s[1:]
            return s
        if isinstance(out, (list, tuple)):
            return [restore(o) for o in out]
        return restore(out)


# --------------------------------------------------------------------------
# helpers


def _as_list(v, n, default):
    if v is None:
        return [default] * n
    return [int(x) for x in v]


def _pads_pairs(pads, nsp, auto_pad, in_shape=None, kernel=None,
                strides=None, dilations=None):
    """ONNX pads [b1..bn, e1..en] -> [(b, e), ...]; resolve auto_pad."""
    if auto_pad in ("SAME_UPPER", "SAME_LOWER"):
        out = []
        for i in range(nsp):
            k = kernel[i]
            d = (dilations or [1] * nsp)[i]
            s = (strides or [1] * nsp)[i]
            eff = (k - 1) * d + 1
            in_d = in_shape[i]
            out_d = -(-in_d // s)  # ceil
            total = max(0, (out_d - 1) * s + eff - in_d)
            lo = total // 2 if auto_pad == "SAME_UPPER" else total - total // 2
            out.append((lo, total - lo))
        return out
    if auto_pad == "VALID" or pads is None:
        return [(0, 0)] * nsp
    pads = [int(p) for p in pads]
    return list(zip(pads[:nsp], pads[nsp:]))


def _torch_pad(pairs):
    """[(lo, hi)] over the trailing dims -> ``F.pad``'s last-dim-first
    list."""
    out = []
    for lo, hi in reversed(pairs):
        out += [int(lo), int(hi)]
    return out


def _spatial_reshape(v, ndim):
    return v.reshape((1, -1) + (1,) * (ndim - 2))


_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}
_CONV_T = {1: F.conv_transpose1d, 2: F.conv_transpose2d,
           3: F.conv_transpose3d}
_MAX_POOL = {1: F.max_pool1d, 2: F.max_pool2d, 3: F.max_pool3d}


def _conv_fn(nsp):
    fn = _CONV.get(nsp)
    if fn is None:
        raise ValueError(f"unsupported conv rank {nsp}")
    return fn


def _window_sum(x, kernel, strides):
    """The sum over each VALID window of the trailing ``len(kernel)``
    dims (a ``reduce_window`` add)."""
    nsp = len(kernel)
    if nsp == 1:
        return F.avg_pool2d(x.unsqueeze(-2), (1, kernel[0]), (1, strides[0]),
                            divisor_override=1).squeeze(-2)
    pool = F.avg_pool2d if nsp == 2 else F.avg_pool3d
    return pool(x, tuple(kernel), tuple(strides), divisor_override=1)


# --------------------------------------------------------------------------
# compute ops with weights


@converts("Conv")
def _conv(ctx, node, attrs, ins):
    w = np.asarray(ins[1])
    b = np.asarray(ins[2]) if len(ins) > 2 and ins[2] is not None else None
    nsp = w.ndim - 2
    kernel = attrs.get("kernel_shape") or list(w.shape[2:])
    strides = _as_list(attrs.get("strides"), nsp, 1)
    dilations = _as_list(attrs.get("dilations"), nsp, 1)
    group = int(attrs.get("group", 1))
    auto_pad = attrs.get("auto_pad", "NOTSET")
    pads_attr = attrs.get("pads")
    conv = _conv_fn(nsp)
    weights = {"kernel": w}
    if b is not None:
        weights["bias"] = b

    def fn(p, xs, training, rng):
        xx = xs[0]
        pads = _pads_pairs(pads_attr, nsp, auto_pad,
                           in_shape=xx.shape[2:], kernel=kernel,
                           strides=strides, dilations=dilations)
        if all(lo == hi for lo, hi in pads):
            padding = [lo for lo, _ in pads]
        else:
            xx = F.pad(xx, _torch_pad(pads))
            padding = 0
        out = conv(xx, p["kernel"], None, strides, padding, dilations, group)
        if "bias" in p:
            out = out + _spatial_reshape(p["bias"], out.ndim)
        return out

    return ctx.emit(node, fn, [ins[0]], weights)


@converts("ConvTranspose")
def _conv_transpose(ctx, node, attrs, ins):
    w = np.asarray(ins[1])  # (C_in, C_out/group, *k)
    b = np.asarray(ins[2]) if len(ins) > 2 and ins[2] is not None else None
    nsp = w.ndim - 2
    kernel = list(w.shape[2:])
    strides = _as_list(attrs.get("strides"), nsp, 1)
    dilations = _as_list(attrs.get("dilations"), nsp, 1)
    group = int(attrs.get("group", 1))
    if group != 1:
        raise NotImplementedError("ConvTranspose group>1")
    out_pad = _as_list(attrs.get("output_padding"), nsp, 0)
    pads_attr = attrs.get("pads")
    pads = _pads_pairs(pads_attr, nsp, attrs.get("auto_pad", "NOTSET"))
    _conv_fn(nsp)
    # the reference stores the fractional-stride conv's kernel: (I, O, *k)
    # -> (O, I, *k), spatially flipped; the transposed conv takes it back
    wt = np.swapaxes(w, 0, 1)[(slice(None), slice(None))
                              + (slice(None, None, -1),) * nsp]
    weights = {"kernel": wt}
    if b is not None:
        weights["bias"] = b
    spatial = tuple(range(2, 2 + nsp))

    def fn(p, xs, training, rng):
        k = torch.flip(p["kernel"], spatial).transpose(0, 1)
        full = _CONV_T[nsp](xs[0], k, None, strides, 0, 0, 1, dilations)
        # crop the pads; output_padding beyond them is zero rows at the end
        pairs = []
        for i in range(nsp):
            pairs.append((-pads[i][0], out_pad[i] - pads[i][1]))
        out = F.pad(full, _torch_pad(pairs))
        if "bias" in p:
            out = out + _spatial_reshape(p["bias"], out.ndim)
        return out

    return ctx.emit(node, fn, [ins[0]], weights)


@converts("Gemm")
def _gemm(ctx, node, attrs, ins):
    alpha = float(attrs.get("alpha", 1.0))
    beta = float(attrs.get("beta", 1.0))
    trans_a = int(attrs.get("transA", 0))
    trans_b = int(attrs.get("transB", 0))
    weights = {}
    names = {}
    graph_ins = [ins[0]]
    for idx, key in ((1, "b"), (2, "c")):
        if idx < len(ins) and ins[idx] is not None:
            if isinstance(ins[idx], np.ndarray):
                weights[key] = ins[idx]
            else:
                names[key] = len(graph_ins)
                graph_ins.append(ins[idx])

    def fn(p, xs, training, rng):
        a = xs[0]
        bm = p["b"] if "b" in p else xs[names["b"]]
        if trans_a:
            a = a.T
        if trans_b:
            bm = bm.T
        out = alpha * (a @ bm)
        c = p["c"] if "c" in p else (
            xs[names["c"]] if "c" in names else None)
        if c is not None:
            out = out + beta * c
        return out

    return ctx.emit(node, fn, graph_ins, weights)


@converts("MatMul")
def _matmul(ctx, node, attrs, ins):
    weights = {}
    graph_ins = []
    pattern = []
    for i, v in enumerate(ins[:2]):
        if isinstance(v, np.ndarray):
            key = f"w{i}"
            weights[key] = v
            pattern.append(("p", key))
        else:
            pattern.append(("x", len(graph_ins)))
            graph_ins.append(v)

    def fn(p, xs, training, rng):
        ops = [p[k] if kind == "p" else xs[k] for kind, k in pattern]
        return torch.matmul(ops[0], ops[1])

    return ctx.emit(node, fn, graph_ins, weights)


@converts("BatchNormalization")
def _batchnorm(ctx, node, attrs, ins):
    eps = float(attrs.get("epsilon", 1e-5))
    weights = {"scale": ins[1], "bias": ins[2],
               "mean": ins[3], "var": ins[4]}

    def fn(p, xs, training, rng):
        x = xs[0]
        inv = torch.rsqrt(_spatial_reshape(p["var"], x.ndim) + eps)
        return ((x - _spatial_reshape(p["mean"], x.ndim)) * inv
                * _spatial_reshape(p["scale"], x.ndim)
                + _spatial_reshape(p["bias"], x.ndim))

    return ctx.emit(node, fn, [ins[0]], weights)


@converts("InstanceNormalization")
def _instancenorm(ctx, node, attrs, ins):
    eps = float(attrs.get("epsilon", 1e-5))
    weights = {"scale": ins[1], "bias": ins[2]}

    def fn(p, xs, training, rng):
        x = xs[0]
        axes = tuple(range(2, x.ndim))
        mean = torch.mean(x, dim=axes, keepdim=True)
        var = torch.var(x, dim=axes, keepdim=True, correction=0)
        return ((x - mean) * torch.rsqrt(var + eps)
                * _spatial_reshape(p["scale"], x.ndim)
                + _spatial_reshape(p["bias"], x.ndim))

    return ctx.emit(node, fn, [ins[0]], weights)


@converts("PRelu")
def _prelu(ctx, node, attrs, ins):
    weights = {"slope": ins[1]}

    def fn(p, xs, training, rng):
        x = xs[0]
        slope = p["slope"]
        if slope.ndim == 1 and x.ndim > 1:
            slope = _spatial_reshape(slope, x.ndim)
        return torch.where(x >= 0, x, slope * x)

    return ctx.emit(node, fn, [ins[0]], weights)


# --------------------------------------------------------------------------
# elementwise / activations

_UNARY = {
    "Relu": torch.relu,
    "Sigmoid": torch.sigmoid,
    "Tanh": torch.tanh,
    "Exp": torch.exp,
    "Log": torch.log,
    "Sqrt": torch.sqrt,
    "Neg": torch.neg,
    "Abs": torch.abs,
    "Reciprocal": lambda x: 1.0 / x,
    "Floor": torch.floor,
    "Ceil": torch.ceil,
    "Erf": torch.erf,
    "Softplus": lambda x: torch.logaddexp(x, torch.zeros_like(x)),
    "Softsign": lambda x: x / (1 + torch.abs(x)),
    "Sin": torch.sin,
    "Cos": torch.cos,
    "Identity": lambda x: x,
    "Sign": torch.sign,
}


@converts(*_UNARY.keys())
def _unary(ctx, node, attrs, ins):
    op = _UNARY[node.op_type]

    def fn(p, xs, training, rng):
        return op(xs[0])

    if isinstance(ins[0], np.ndarray):  # constant fold
        return [op(_tensor(ins[0])).numpy()]
    return ctx.emit(node, fn, [ins[0]], {})


@converts("LeakyRelu")
def _leaky(ctx, node, attrs, ins):
    alpha = float(attrs.get("alpha", 0.01))
    return ctx.emit(node,
                    lambda p, xs, t, r: torch.where(xs[0] >= 0, xs[0],
                                                    alpha * xs[0]),
                    [ins[0]], {})


@converts("Elu")
def _elu(ctx, node, attrs, ins):
    alpha = float(attrs.get("alpha", 1.0))
    return ctx.emit(node,
                    lambda p, xs, t, r: torch.where(
                        xs[0] >= 0, xs[0], alpha * torch.expm1(xs[0])),
                    [ins[0]], {})


@converts("Selu")
def _selu(ctx, node, attrs, ins):
    alpha = float(attrs.get("alpha", 1.6732632423543772))
    gamma = float(attrs.get("gamma", 1.0507009873554805))
    return ctx.emit(node,
                    lambda p, xs, t, r: gamma * torch.where(
                        xs[0] >= 0, xs[0], alpha * torch.expm1(xs[0])),
                    [ins[0]], {})


@converts("Clip")
def _clip(ctx, node, attrs, ins):
    lo = attrs.get("min")
    hi = attrs.get("max")
    if lo is None and len(ins) > 1 and ins[1] is not None:
        lo = float(np.asarray(ins[1]))
    if hi is None and len(ins) > 2 and ins[2] is not None:
        hi = float(np.asarray(ins[2]))

    def fn(p, xs, training, rng):
        if lo is None and hi is None:
            return xs[0]
        return torch.clamp(xs[0], lo, hi)

    return ctx.emit(node, fn, [ins[0]], {})


@converts("HardSigmoid")
def _hardsigmoid(ctx, node, attrs, ins):
    alpha = float(attrs.get("alpha", 0.2))
    beta = float(attrs.get("beta", 0.5))
    return ctx.emit(node,
                    lambda p, xs, t, r: torch.clamp(alpha * xs[0] + beta,
                                                    0, 1),
                    [ins[0]], {})


_BINARY = {
    "Add": (np.add, torch.add), "Sub": (np.subtract, torch.sub),
    "Mul": (np.multiply, torch.mul), "Div": (np.true_divide, torch.div),
    "Pow": (np.power, torch.pow),
}


def _split_inputs(ins):
    """Numpy constants become weights ``c{i}``; the rest are graph
    inputs: (weights, graph inputs, [("p", key) | ("x", index)])."""
    weights, graph_ins, pattern = {}, [], []
    for i, v in enumerate(ins):
        if isinstance(v, np.ndarray):
            weights[f"c{i}"] = v
            pattern.append(("p", f"c{i}"))
        else:
            pattern.append(("x", len(graph_ins)))
            graph_ins.append(v)
    return weights, graph_ins, pattern


def _operands(pattern, p, xs):
    return [p[k] if kind == "p" else xs[k] for kind, k in pattern]


@converts("Add", "Sub", "Mul", "Div", "Pow")
def _binary(ctx, node, attrs, ins):
    np_op, op = _BINARY[node.op_type]
    if all(isinstance(v, np.ndarray) for v in ins[:2]):
        return [canonical(np_op(canonical(ins[0]), canonical(ins[1])))]
    weights, graph_ins, pattern = _split_inputs(ins[:2])

    def fn(p, xs, training, rng):
        a, b = _operands(pattern, p, xs)
        return op(a, b)

    return ctx.emit(node, fn, graph_ins, weights)


@converts("Min", "Max", "Sum", "Mean")
def _variadic(ctx, node, attrs, ins):
    op_type = node.op_type
    if all(isinstance(v, np.ndarray) for v in ins):   # constant fold
        out = ins[0]
        for o in ins[1:]:
            if op_type == "Min":
                out = np.minimum(out, o)
            elif op_type == "Max":
                out = np.maximum(out, o)
            else:
                out = out + o
        if op_type == "Mean":
            out = out / len(ins)
        return [np.asarray(out)]
    weights, graph_ins, pattern = _split_inputs(ins)

    def fn(p, xs, training, rng):
        ops = _operands(pattern, p, xs)
        out = ops[0]
        for o in ops[1:]:
            if op_type == "Min":
                out = torch.minimum(out, o)
            elif op_type == "Max":
                out = torch.maximum(out, o)
            else:
                out = out + o
        if op_type == "Mean":
            out = out / len(ops)
        return out

    return ctx.emit(node, fn, graph_ins, weights)


@converts("Softmax", "LogSoftmax")
def _softmax(ctx, node, attrs, ins):
    # default axis changed from 1 (flatten semantics) to -1 in opset 13
    axis = int(attrs.get("axis", 1 if ctx.opset < 13 else -1))
    log = node.op_type == "LogSoftmax"
    opset = ctx.opset

    def fn(p, xs, training, rng):
        x = xs[0]
        if opset < 13:
            # pre-13: softmax over the flattened trailing dims [axis:)
            ax = axis if axis >= 0 else x.ndim + axis
            shape = x.shape
            flat = x.reshape(tuple(shape[:ax]) + (-1,))
            out = (torch.log_softmax(flat, dim=-1) if log
                   else torch.softmax(flat, dim=-1))
            return out.reshape(shape)
        return (torch.log_softmax(x, dim=axis) if log
                else torch.softmax(x, dim=axis))

    return ctx.emit(node, fn, [ins[0]], {})


# --------------------------------------------------------------------------
# pooling


def _pool(ctx, node, attrs, ins, average=False):
    kernel = [int(k) for k in attrs["kernel_shape"]]
    nsp = len(kernel)
    strides = _as_list(attrs.get("strides"), nsp, 1)
    pads_attr = attrs.get("pads")
    auto_pad = attrs.get("auto_pad", "NOTSET")
    count_include_pad = int(attrs.get("count_include_pad", 0))
    ceil_mode = int(attrs.get("ceil_mode", 0))
    if not average and nsp not in _MAX_POOL:
        raise ValueError(f"unsupported pool rank {nsp}")

    def fn(p, xs, training, rng):
        x = xs[0]
        base = _pads_pairs(pads_attr, nsp, auto_pad, in_shape=x.shape[2:],
                           kernel=kernel, strides=strides)
        pads = base
        if ceil_mode:
            # widen the end pad so the last partial window is emitted
            pads = []
            for i, (lo, hi) in enumerate(base):
                span = x.shape[2 + i] + lo + hi - kernel[i]
                out_d = -(-span // strides[i]) + 1
                need = (out_d - 1) * strides[i] + kernel[i]
                pads.append((lo, hi + need - (x.shape[2 + i] + lo + hi)))
        if not average:
            xp = F.pad(x, _torch_pad(pads), value=float("-inf"))
            return _MAX_POOL[nsp](xp, kernel, strides)
        out = _window_sum(F.pad(x, _torch_pad(pads)), kernel, strides)
        if count_include_pad and not ceil_mode:
            return out / float(np.prod(kernel))
        if count_include_pad:
            # count positions in the base-padded extent, not the
            # ceil-mode spill-over
            ones = F.pad(torch.ones_like(x), _torch_pad(base), value=1.0)
            extra = [(0, pads[i][1] - base[i][1]) for i in range(nsp)]
            denom = _window_sum(F.pad(ones, _torch_pad(extra)), kernel,
                                strides)
        else:
            denom = _window_sum(F.pad(torch.ones_like(x), _torch_pad(pads)),
                                kernel, strides)
        return out / denom

    return ctx.emit(node, fn, [ins[0]], {})


@converts("MaxPool")
def _maxpool(ctx, node, attrs, ins):
    return _pool(ctx, node, attrs, ins)


@converts("AveragePool")
def _avgpool(ctx, node, attrs, ins):
    return _pool(ctx, node, attrs, ins, average=True)


@converts("GlobalAveragePool")
def _gap(ctx, node, attrs, ins):
    return ctx.emit(node,
                    lambda p, xs, t, r: torch.mean(
                        xs[0], dim=tuple(range(2, xs[0].ndim)),
                        keepdim=True),
                    [ins[0]], {})


@converts("GlobalMaxPool")
def _gmp(ctx, node, attrs, ins):
    return ctx.emit(node,
                    lambda p, xs, t, r: torch.amax(
                        xs[0], dim=tuple(range(2, xs[0].ndim)),
                        keepdim=True),
                    [ins[0]], {})


@converts("LRN")
def _lrn(ctx, node, attrs, ins):
    alpha = float(attrs.get("alpha", 1e-4))
    beta = float(attrs.get("beta", 0.75))
    bias = float(attrs.get("bias", 1.0))
    size = int(attrs["size"])

    def fn(p, xs, training, rng):
        x = xs[0]
        sq = torch.square(x)
        lo = (size - 1) // 2
        hi = size - 1 - lo
        # the window sum over channels, the channel axis padded (lo, hi)
        pad = _torch_pad([(lo, hi)] + [(0, 0)] * (x.ndim - 2))
        ssum = F.pad(sq, pad).unfold(1, size, 1).sum(-1)
        return x / torch.pow(bias + alpha / size * ssum, beta)

    return ctx.emit(node, fn, [ins[0]], {})


# --------------------------------------------------------------------------
# shape ops


@converts("Flatten")
def _flatten(ctx, node, attrs, ins):
    axis = int(attrs.get("axis", 1))

    def fn(p, xs, training, rng):
        x = xs[0]
        ax = axis if axis >= 0 else x.ndim + axis
        lead = 1
        for d in x.shape[:ax]:
            lead *= d
        return x.reshape((lead, -1))

    return ctx.emit(node, fn, [ins[0]], {})


@converts("Reshape")
def _reshape(ctx, node, attrs, ins):
    shape = attrs.get("shape")
    if shape is None:
        if len(ins) < 2 or not isinstance(ins[1], np.ndarray):
            raise NotImplementedError("Reshape with dynamic shape input")
        shape = [int(v) for v in np.asarray(ins[1]).ravel()]
    shape = [int(v) for v in shape]

    if isinstance(ins[0], np.ndarray):   # constant fold
        tgt = [ins[0].shape[i] if v == 0 else v
               for i, v in enumerate(shape)]
        return [ins[0].reshape(tuple(tgt))]

    def fn(p, xs, training, rng):
        x = xs[0]
        tgt = [x.shape[i] if v == 0 else v for i, v in enumerate(shape)]
        # dim 0 is the batch: exports bake the traced batch size into the
        # shape constant, so re-derive it from the runtime input instead
        if tgt and -1 not in tgt[1:]:
            tgt[0] = -1
        return x.reshape(tuple(tgt))

    return ctx.emit(node, fn, [ins[0]], {})


@converts("Transpose")
def _transpose(ctx, node, attrs, ins):
    perm = attrs.get("perm")
    if isinstance(ins[0], np.ndarray):
        return [np.transpose(ins[0], perm)]

    def fn(p, xs, training, rng):
        x = xs[0]
        return x.permute(*(perm if perm is not None
                           else reversed(range(x.ndim))))

    return ctx.emit(node, fn, [ins[0]], {})


@converts("Squeeze")
def _squeeze(ctx, node, attrs, ins):
    axes = attrs.get("axes")
    if axes is None and len(ins) > 1 and isinstance(ins[1], np.ndarray):
        axes = [int(v) for v in np.asarray(ins[1]).ravel()]
    axes = tuple(int(a) for a in axes) if axes else None
    if isinstance(ins[0], np.ndarray):
        return [np.squeeze(ins[0], axis=axes)]

    def fn(p, xs, training, rng):
        x = xs[0]
        return x.squeeze() if axes is None else x.squeeze(axes)

    return ctx.emit(node, fn, [ins[0]], {})


@converts("Unsqueeze")
def _unsqueeze(ctx, node, attrs, ins):
    axes = attrs.get("axes")
    if axes is None and len(ins) > 1 and isinstance(ins[1], np.ndarray):
        axes = [int(v) for v in np.asarray(ins[1]).ravel()]
    axes = sorted(int(a) for a in axes)

    def expand(x):
        for a in axes:
            x = np.expand_dims(x, a) if isinstance(x, np.ndarray) \
                else x.unsqueeze(a)
        return x

    if isinstance(ins[0], np.ndarray):
        return [expand(ins[0])]
    return ctx.emit(node, lambda p, xs, t, r: expand(xs[0]), [ins[0]], {})


@converts("Concat")
def _concat(ctx, node, attrs, ins):
    axis = int(attrs.get("axis", 0))
    if all(isinstance(v, np.ndarray) for v in ins):
        return [np.concatenate(ins, axis=axis)]
    weights, graph_ins, pattern = _split_inputs(ins)

    def fn(p, xs, training, rng):
        return torch.cat(_operands(pattern, p, xs), dim=axis)

    return ctx.emit(node, fn, graph_ins, weights)


@converts("Split")
def _split(ctx, node, attrs, ins):
    axis = int(attrs.get("axis", 0))
    split = attrs.get("split")
    if split is None and len(ins) > 1 and isinstance(ins[1], np.ndarray):
        split = [int(v) for v in np.asarray(ins[1]).ravel()]
    n_out = len(node.output)

    def fn(p, xs, training, rng):
        x = xs[0]
        if split is None:
            if x.shape[axis] % n_out:
                raise ValueError(
                    f"Split: dim {x.shape[axis]} does not divide into "
                    f"{n_out} equal parts")
            return list(torch.tensor_split(x, n_out, dim=axis))
        idx = np.cumsum(split)[:-1].tolist()
        return list(torch.tensor_split(x, idx, dim=axis))

    return ctx.emit(node, fn, [ins[0]], {}, n_outputs=n_out)


@converts("Slice")
def _slice(ctx, node, attrs, ins):
    starts = attrs.get("starts")
    ends = attrs.get("ends")
    axes = attrs.get("axes")
    steps = None
    if starts is None:  # opset >= 10: inputs
        starts = [int(v) for v in np.asarray(ins[1]).ravel()]
        ends = [int(v) for v in np.asarray(ins[2]).ravel()]
        if len(ins) > 3 and ins[3] is not None:
            axes = [int(v) for v in np.asarray(ins[3]).ravel()]
        if len(ins) > 4 and ins[4] is not None:
            steps = [int(v) for v in np.asarray(ins[4]).ravel()]
    if axes is None:
        axes = list(range(len(starts)))

    def make_slices(ndim):
        sl = [slice(None)] * ndim
        for i, ax in enumerate(axes):
            st = steps[i] if steps else 1
            sl[ax] = slice(int(starts[i]), int(ends[i]), st)
        return sl

    if isinstance(ins[0], np.ndarray):
        return [ins[0][tuple(make_slices(ins[0].ndim))]]

    def fn(p, xs, training, rng):
        x = xs[0]
        for ax, sl in enumerate(make_slices(x.ndim)):
            if sl == slice(None):
                continue
            # torch slices take no negative step: gather the indices
            idx = range(*sl.indices(x.shape[ax]))
            x = torch.index_select(
                x, ax, torch.tensor(list(idx), dtype=torch.long,
                                    device=x.device))
        return x

    return ctx.emit(node, fn, [ins[0]], {})


def _take(a, idx, axis):
    """``jnp.take(a, idx, axis)``: negative indices wrap."""
    axis = axis if axis >= 0 else a.ndim + axis
    idx = idx.long()
    idx = torch.where(idx < 0, idx + a.shape[axis], idx)
    out = torch.index_select(a, axis, idx.reshape(-1))
    return out.reshape(tuple(a.shape[:axis]) + tuple(idx.shape)
                       + tuple(a.shape[axis + 1:]))


@converts("Gather")
def _gather(ctx, node, attrs, ins):
    axis = int(attrs.get("axis", 0))
    if all(isinstance(v, np.ndarray) for v in ins[:2]):
        return [np.take(ins[0], ins[1].astype(np.int64), axis=axis)]
    if isinstance(ins[0], np.ndarray):
        # embedding lookup: table is a param, indices flow in
        def fn(p, xs, training, rng):
            return _take(p["table"], xs[0], axis)
        return ctx.emit(node, fn, [ins[1]], {"table": ins[0]})
    idx = np.asarray(ins[1]).astype(np.int64) \
        if isinstance(ins[1], np.ndarray) else None

    def fn(p, xs, training, rng):
        indices = torch.from_numpy(idx).to(xs[0].device) \
            if idx is not None else xs[1]
        return _take(xs[0], indices, axis)

    graph_ins = [ins[0]] if idx is not None else [ins[0], ins[1]]
    return ctx.emit(node, fn, graph_ins, {})


@converts("Shape")
def _shape(ctx, node, attrs, ins):
    x = ins[0]
    if isinstance(x, np.ndarray):
        return [np.asarray(x.shape, dtype=np.int64)]
    shape = x.shape
    if any(d is None for d in shape):
        raise NotImplementedError("Shape of tensor with dynamic dims")
    return [np.asarray(shape, dtype=np.int64)]


@converts("Constant")
def _constant(ctx, node, attrs, ins):
    for key in ("value", "value_float", "value_int", "value_floats",
                "value_ints"):
        if key in attrs and attrs[key] is not None:
            return [np.asarray(attrs[key])]
    raise ValueError("Constant node without value")


@converts("ConstantOfShape")
def _constant_of_shape(ctx, node, attrs, ins):
    shape = tuple(int(v) for v in np.asarray(ins[0]).ravel())
    value = attrs.get("value")
    fill = np.asarray(value).ravel()[0] if value is not None else 0.0
    return [np.full(shape, fill)]


@converts("Cast")
def _cast(ctx, node, attrs, ins):
    from analytics_zoo_torch.pipeline.api.onnx.onnx_pb import _NP_BY_DTYPE
    to = _NP_BY_DTYPE[int(attrs["to"])]
    if isinstance(ins[0], np.ndarray):
        return [ins[0].astype(to)]
    dtype = _torch_dtype(to)
    return ctx.emit(node,
                    lambda p, xs, t, r: xs[0].to(dtype), [ins[0]], {})


@converts("Pad")
def _pad(ctx, node, attrs, ins):
    mode = attrs.get("mode", "constant")
    pads = attrs.get("pads")
    cval = float(attrs.get("value", 0.0))
    if pads is None and len(ins) > 1 and isinstance(ins[1], np.ndarray):
        pads = [int(v) for v in np.asarray(ins[1]).ravel()]
        if len(ins) > 2 and ins[2] is not None:
            cval = float(np.asarray(ins[2]).ravel()[0])
    tmode = {"constant": "constant", "reflect": "reflect",
             "edge": "replicate"}[mode]

    def fn(p, xs, training, rng):
        x = xs[0]
        n = x.ndim
        pw = list(zip(pads[:n], pads[n:]))
        if tmode == "constant":
            return F.pad(x, _torch_pad(pw), value=cval)
        # reflect/replicate pad the trailing dims from the first padded one
        first = next((i for i, pr in enumerate(pw) if pr != (0, 0)), n)
        return F.pad(x, _torch_pad(pw[first:]), mode=tmode)

    return ctx.emit(node, fn, [ins[0]], {})


def _reduce(op_type, x, axes, keepdims):
    dims = tuple(range(x.ndim)) if axes is None else tuple(
        a % x.ndim for a in axes)
    if op_type == "ReduceProd":
        out = x
        for d in sorted(dims, reverse=True):
            out = torch.prod(out, dim=d, keepdim=keepdims)
        return out
    op = {"ReduceMean": torch.mean, "ReduceSum": torch.sum,
          "ReduceMax": torch.amax, "ReduceMin": torch.amin}[op_type]
    return op(x, dim=dims, keepdim=keepdims)


@converts("ReduceMean", "ReduceSum", "ReduceMax", "ReduceMin", "ReduceProd")
def _reduce_op(ctx, node, attrs, ins):
    op_type = node.op_type
    axes = attrs.get("axes")
    if axes is None and len(ins) > 1 and isinstance(ins[1], np.ndarray):
        axes = [int(v) for v in np.asarray(ins[1]).ravel()]
    axes = tuple(axes) if axes is not None else None
    keepdims = bool(attrs.get("keepdims", 1))
    return ctx.emit(node,
                    lambda p, xs, t, r: _reduce(op_type, xs[0], axes,
                                                keepdims),
                    [ins[0]], {})


@converts("ArgMax", "ArgMin")
def _argminmax(ctx, node, attrs, ins):
    op = torch.argmax if node.op_type == "ArgMax" else torch.argmin
    axis = int(attrs.get("axis", 0))
    keepdims = bool(attrs.get("keepdims", 1))

    def fn(p, xs, training, rng):
        # int32, as JAX returns it without x64
        return op(xs[0], dim=axis, keepdim=keepdims).to(torch.int32)

    return ctx.emit(node, fn, [ins[0]], {})


@converts("Dropout")
def _dropout(ctx, node, attrs, ins):
    rate = float(attrs.get("ratio", 0.5))

    def fn(p, xs, training, rng):
        x = xs[0]
        if not training or rng is None or rate <= 0.0:
            return x
        keep = 1.0 - rate
        mask = torch.rand(x.shape, generator=rng, device=x.device) < keep
        return torch.where(mask, x / keep, torch.zeros_like(x))

    return ctx.emit(node, fn, [ins[0]], {})


# ------------------------------------------------- jax.image.resize's math
def _triangle(x):
    return np.maximum(0, 1 - np.abs(x))


def _keys_cubic(x):
    out = ((1.5 * x - 2.5) * x) * x + 1.
    out = np.where(x >= 1., ((-0.5 * x + 2.5) * x - 4.) * x + 2., out)
    return np.where(x >= 2., 0., out)


def _weight_mat(input_size: int, output_size: int, kernel) -> np.ndarray:
    """(input_size, output_size) float32 resampling weights, antialiased,
    as ``jax.image.scale_and_translate`` computes them (no translation)."""
    f32 = np.float32
    scale = f32(output_size / input_size)
    inv_scale = f32(1.0) / scale
    kernel_scale = max(inv_scale, f32(1.0))
    sample_f = ((np.arange(output_size, dtype=f32) + f32(0.5)) * inv_scale
                - f32(0.5))
    x = (np.abs(sample_f[None, :] - np.arange(input_size, dtype=f32)[:, None])
         / kernel_scale).astype(f32)
    weights = kernel(x).astype(f32)
    total = np.sum(weights, axis=0, keepdims=True, dtype=f32)
    weights = np.where(np.abs(total) > 1000. * float(np.finfo(f32).eps),
                       weights / np.where(total != 0, total, 1), 0)
    inside = (sample_f >= -0.5) & (sample_f <= input_size - 0.5)
    return np.where(inside[None, :], weights, 0).astype(f32)


def _resize(x, new_shape, method):
    if method == "nearest":
        for d, (m, n) in enumerate(zip(x.shape, new_shape)):
            if m == n:
                continue
            offsets = np.floor((np.arange(n, dtype=np.float32) + 0.5)
                               * m / n).astype(np.int64)
            x = torch.index_select(x, d, torch.from_numpy(offsets).to(
                x.device))
        return x
    kernel = _triangle if method == "linear" else _keys_cubic
    for d, (m, n) in enumerate(zip(x.shape, new_shape)):
        if m == n:
            continue
        w = torch.from_numpy(_weight_mat(m, n, kernel)).to(x.device, x.dtype)
        x = torch.movedim(torch.tensordot(x, w, dims=([d], [0])), -1, d)
    return x


@converts("Upsample", "Resize")
def _resize_op(ctx, node, attrs, ins):
    mode = attrs.get("mode", "nearest")
    scales = attrs.get("scales")
    sizes = None
    if scales is None:
        if node.op_type == "Upsample":        # inputs: (X, scales)
            if len(ins) > 1 and isinstance(ins[1], np.ndarray):
                scales = [float(v) for v in np.asarray(ins[1]).ravel()]
        else:                                  # Resize: (X, roi, scales, sizes)
            if len(ins) > 2 and isinstance(ins[2], np.ndarray) \
                    and np.asarray(ins[2]).size:
                scales = [float(v) for v in np.asarray(ins[2]).ravel()]
            elif len(ins) > 3 and isinstance(ins[3], np.ndarray) \
                    and np.asarray(ins[3]).size:
                sizes = [int(v) for v in np.asarray(ins[3]).ravel()]
    if scales is None and sizes is None:
        raise NotImplementedError(
            f"{node.op_type} node without static scales/sizes")
    method = {"nearest": "nearest", "linear": "linear",
              "cubic": "cubic"}[mode.split("_")[0] if mode else "nearest"]

    def fn(p, xs, training, rng):
        x = xs[0]
        if sizes is not None:
            new_shape = tuple(sizes)
        else:
            new_shape = tuple(int(round(d * s))
                              for d, s in zip(x.shape, scales))
        return _resize(x, new_shape, method)

    return ctx.emit(node, fn, [ins[0]], {})


@converts("Expand")
def _expand(ctx, node, attrs, ins):
    shape = tuple(int(v) for v in np.asarray(ins[1]).ravel())

    def fn(p, xs, training, rng):
        return torch.broadcast_to(xs[0], torch.broadcast_shapes(
            xs[0].shape, shape))

    return ctx.emit(node, fn, [ins[0]], {})


@converts("Where")
def _where(ctx, node, attrs, ins):
    if all(isinstance(v, np.ndarray) for v in ins[:3]):   # constant fold
        return [np.where(ins[0].astype(bool), ins[1], ins[2])]
    weights, graph_ins, pattern = _split_inputs(ins[:3])

    def fn(p, xs, training, rng):
        c, a, b = _operands(pattern, p, xs)
        return torch.where(c.bool(), a, b)

    return ctx.emit(node, fn, graph_ins, weights)
