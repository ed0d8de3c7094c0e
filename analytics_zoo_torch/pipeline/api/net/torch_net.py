"""TorchNet: a PyTorch ``nn.Module`` as a native framework layer (port of
the JAX package's ``pipeline/api/net/torch_net.py``).

``torch.fx`` traces the module once into an op graph, and ``_Emitter``
walks that graph and emits each node as a PyTorch op on the layer's own
params: the module itself is never called.  The result is a first-class
framework Layer whose params train under the zoo optimizer like any
other layer's.  The supported modules, functions and methods are the
reference's, and the reference's arithmetic is kept where it is not
torch's (``nn.GELU`` is the tanh approximation, ``nn.LayerNorm``
normalizes the last axis, ``nn.AvgPool2d`` and ``F.avg_pool2d`` take no
padding); anything else raises ``NotImplementedError`` naming it.

The params are the module's ``named_parameters()`` and
``named_buffers()`` under the same names, with the reference's dtypes
(BatchNorm's int64 ``num_batches_tracked`` is stored int32, as JAX stores
it without x64), so a module with BatchNorm serves but cannot train: the
trainer refuses the integer leaf with a ``TypeError``, as ``jax.grad``
does in the reference.
"""

from __future__ import annotations

import operator
from typing import Any, Callable, Dict

import numpy as np
import torch
import torch.nn.functional as F

from analytics_zoo_torch.pipeline.api.keras.engine import (Layer, Params,
                                                           fold_name)

# 64-bit dtypes narrowed as JAX narrows them without x64
_NARROW = {torch.int64: torch.int32, torch.float64: torch.float32,
           torch.complex128: torch.complex64}


def _to_param(t) -> torch.Tensor:
    t = t.detach().to("cpu")
    return t.to(_NARROW.get(t.dtype, t.dtype)).clone()


def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


def _make_loss(elem_fn):
    """An elementwise-residual torch loss functional, as the reference
    computes it."""
    def loss(a, b, reduction="mean", **legacy):
        bad = {k: v for k, v in legacy.items() if v is not None}
        if bad:
            raise NotImplementedError(
                f"TorchCriterion: unsupported loss kwargs {sorted(bad)}")
        r = elem_fn(a - b)
        if reduction == "mean":
            return torch.mean(r)
        if reduction == "sum":
            return torch.sum(r)
        if reduction == "none":
            return r
        raise NotImplementedError(
            f"TorchCriterion: unsupported reduction {reduction!r}")
    return loss


def _reshape_from(x, start):
    return x.reshape(tuple(x.shape[:start]) + (-1,))


def _mean(a, dim=None, keepdim=False):
    return torch.mean(a) if dim is None and not keepdim else \
        torch.mean(a, dim=dim, keepdim=keepdim)


def _sum(a, dim=None, keepdim=False):
    return torch.sum(a) if dim is None and not keepdim else \
        torch.sum(a, dim=dim, keepdim=keepdim)


class _Emitter:
    """Evaluate an fx graph with the reference's op semantics on NCHW
    tensors."""

    def __init__(self, gm, params: Dict[str, torch.Tensor]):
        self.gm = gm
        self.params = params

    # ------------------------------------------------------ module calls
    def call_module(self, mod, x, extra_args, training, rng):
        import torch.nn as nn
        p = self.params
        name = self.current_target
        if isinstance(mod, nn.Conv2d):
            w = p[f"{name}.weight"]          # (O, I, kh, kw)
            pad = mod.padding
            padding = pad if isinstance(pad, str) else _pair(pad)
            out = F.conv2d(x, w, None, _pair(mod.stride), padding,
                           _pair(mod.dilation), mod.groups)
            if mod.bias is not None:
                out = out + p[f"{name}.bias"][None, :, None, None]
            return out
        if isinstance(mod, nn.Linear):
            out = x @ p[f"{name}.weight"].T
            if mod.bias is not None:
                out = out + p[f"{name}.bias"]
            return out
        if isinstance(mod, (nn.BatchNorm1d, nn.BatchNorm2d)):
            mean = p[f"{name}.running_mean"]
            var = p[f"{name}.running_var"]
            shape = [1, -1] + [1] * (x.ndim - 2)
            out = (x - mean.reshape(shape)) / torch.sqrt(
                var.reshape(shape) + mod.eps)
            if mod.affine:
                out = out * p[f"{name}.weight"].reshape(shape) + \
                    p[f"{name}.bias"].reshape(shape)
            return out
        if isinstance(mod, nn.LayerNorm):
            mean = torch.mean(x, dim=-1, keepdim=True)
            var = torch.var(x, dim=-1, keepdim=True, correction=0)
            out = (x - mean) / torch.sqrt(var + mod.eps)
            if mod.elementwise_affine:
                out = out * p[f"{name}.weight"] + p[f"{name}.bias"]
            return out
        if isinstance(mod, nn.Embedding):
            return p[f"{name}.weight"][x.long()]
        if isinstance(mod, nn.MaxPool2d):
            k = _pair(mod.kernel_size)
            s = _pair(mod.stride or mod.kernel_size)
            ph, pw = _pair(mod.padding)
            neg = (float("-inf") if x.is_floating_point()
                   else torch.iinfo(x.dtype).min)
            xp = F.pad(x, [pw, pw, ph, ph], value=neg)
            return F.max_pool2d(xp, k, s)
        if isinstance(mod, nn.AvgPool2d):
            k = _pair(mod.kernel_size)
            s = _pair(mod.stride or mod.kernel_size)
            out = F.avg_pool2d(x, k, s, divisor_override=1)
            return out / float(np.prod(k))
        if isinstance(mod, nn.AdaptiveAvgPool2d):
            osz = mod.output_size
            osz = (osz, osz) if isinstance(osz, int) else osz
            if tuple(osz) == (1, 1):
                return torch.mean(x, dim=(2, 3), keepdim=True)
            raise NotImplementedError("adaptive pool only to (1,1)")
        if isinstance(mod, nn.ReLU):
            return torch.relu(x)
        if isinstance(mod, nn.GELU):
            return F.gelu(x, approximate="tanh")
        if isinstance(mod, nn.Sigmoid):
            return torch.sigmoid(x)
        if isinstance(mod, nn.Tanh):
            return torch.tanh(x)
        if isinstance(mod, nn.Softmax):
            return torch.softmax(x, dim=mod.dim if mod.dim is not None
                                 else -1)
        if isinstance(mod, nn.Dropout):
            if not training or mod.p == 0:
                return x
            if rng is None:
                raise ValueError("TorchNet training needs rng")
            keep = 1.0 - mod.p
            mask = torch.rand(x.shape, generator=self._rng_next(rng),
                              device=x.device) < keep
            return torch.where(mask, x / keep, torch.zeros_like(x))
        if isinstance(mod, nn.Flatten):
            return _reshape_from(x, mod.start_dim)
        if isinstance(mod, nn.Identity):
            return x
        raise NotImplementedError(
            f"TorchNet: unsupported module {type(mod).__name__}; "
            "extend _Emitter.call_module")

    def call_function(self, fn, args, kwargs):
        table: Dict[Any, Callable] = {
            operator.add: torch.add, torch.add: torch.add,
            operator.sub: torch.sub, operator.mul: torch.mul,
            operator.truediv: torch.div,
            operator.getitem: lambda a, idx: a[idx],
            torch.relu: torch.relu, F.relu: torch.relu,
            F.gelu: lambda a: F.gelu(a, approximate="tanh"),
            torch.sigmoid: torch.sigmoid, torch.tanh: torch.tanh,
            torch.flatten: lambda a, start_dim=0, end_dim=-1:
                _reshape_from(a, start_dim),
            torch.cat: lambda ts, dim=0: torch.cat(ts, dim=dim),
            torch.matmul: torch.matmul,
            torch.mean: _mean,
            torch.sum: _sum,
            F.softmax: lambda a, dim=-1: torch.softmax(a, dim=dim),
            F.log_softmax: lambda a, dim=-1: torch.log_softmax(a, dim=dim),
            # losses (TorchCriterion path); extra kwargs are torch's
            # deprecated legacy aliases (size_average/reduce/weight),
            # traced through as None and ignored when unset
            F.mse_loss: _make_loss(torch.square),
            F.l1_loss: _make_loss(torch.abs),
            torch.abs: torch.abs, torch.square: torch.square,
            torch.pow: torch.pow, operator.pow: torch.pow,
            torch.exp: torch.exp, torch.log: torch.log,
            torch.clamp: lambda a, min=None, max=None:
                a if min is None and max is None else
                torch.clamp(a, min, max),
        }
        if fn in table:
            return table[fn](*args, **kwargs)
        if fn is F.avg_pool2d:
            # the reference's: a VALID window of the kernel, strided by it
            x, k = args[0], _pair(args[1])
            out = F.avg_pool2d(x, k, k, divisor_override=1)
            return out / float(np.prod(k))
        raise NotImplementedError(f"TorchNet: unsupported function {fn}")

    def call_method(self, method, args, kwargs):
        x = args[0]
        rest = args[1:]
        if method == "view" or method == "reshape":
            shape = rest[0] if len(rest) == 1 and \
                isinstance(rest[0], (list, tuple)) else rest
            return x.reshape(tuple(int(s) for s in shape))
        if method == "flatten":
            start = rest[0] if rest else 0
            return _reshape_from(x, start)
        if method == "mean":
            return _mean(x, rest[0] if rest else None, **kwargs)
        if method == "permute":
            perm = rest[0] if len(rest) == 1 and \
                isinstance(rest[0], (list, tuple)) else rest
            return x.permute(*perm)
        if method == "transpose":
            d0, d1 = rest
            return torch.transpose(x, d0, d1)
        if method == "contiguous" or method == "clone":
            return x
        if method == "size":
            return tuple(x.shape) if not rest else x.shape[rest[0]]
        if method == "unsqueeze":
            return x.unsqueeze(rest[0])
        if method == "squeeze":
            return x.squeeze(rest[0]) if rest else x.squeeze()
        raise NotImplementedError(f"TorchNet: unsupported method {method}")

    def _rng_next(self, rng):
        self._rng_count += 1
        return fold_name(rng, str(self._rng_count))

    def run(self, params, x, training=False, rng=None):
        import torch.fx
        self.params = params
        self._rng_count = 0
        env: Dict[str, Any] = {}
        inputs = x if isinstance(x, (list, tuple)) else [x]
        in_i = 0
        modules = dict(self.gm.named_modules())

        def resolve(a):
            if isinstance(a, torch.fx.Node):
                return env[a.name]
            if isinstance(a, (list, tuple)):
                return type(a)(resolve(v) for v in a)
            return a
        result = None
        for node in self.gm.graph.nodes:
            if node.op == "placeholder":
                env[node.name] = inputs[in_i]
                in_i += 1
            elif node.op == "get_attr":
                env[node.name] = self.params[node.target]
            elif node.op == "call_module":
                self.current_target = node.target
                args = [resolve(a) for a in node.args]
                env[node.name] = self.call_module(
                    modules[node.target], args[0],
                    args[1:], training, rng)
            elif node.op == "call_function":
                env[node.name] = self.call_function(
                    node.target, [resolve(a) for a in node.args],
                    {k: resolve(v) for k, v in node.kwargs.items()})
            elif node.op == "call_method":
                env[node.name] = self.call_method(
                    node.target, [resolve(a) for a in node.args],
                    {k: resolve(v) for k, v in node.kwargs.items()})
            elif node.op == "output":
                result = resolve(node.args[0])
        return result


class TorchNet(Layer):
    """A torch ``nn.Module`` emitted as a native framework layer.

    ``TorchNet.from_pytorch(model, input_shape)`` mirrors the reference
    Python surface: the module is fx-traced once; its weights become the
    layer's params (trainable end to end under the zoo optimizer).
    """

    def __init__(self, torch_module, **kwargs):
        super().__init__(**kwargs)
        import torch.fx
        self.gm = torch.fx.symbolic_trace(torch_module.eval())
        self._initial_params = self._extract_params(torch_module)
        self._emitter = _Emitter(self.gm, self._initial_params)

    @classmethod
    def from_pytorch(cls, model, input_shape=None, **kwargs) -> "TorchNet":
        net = cls(model, **kwargs)
        if input_shape is not None:
            net.batch_input_shape = (None,) + tuple(input_shape)
        return net

    @staticmethod
    def _extract_params(module) -> Dict[str, torch.Tensor]:
        params = {n: _to_param(p) for n, p in module.named_parameters()}
        params.update({n: _to_param(b) for n, b in module.named_buffers()})
        return params

    def build(self, rng, input_shape) -> Params:
        return {k: v.clone() for k, v in self._initial_params.items()}

    def call(self, params, x, training=False, rng=None):
        return self._emitter.run(params, x, training=training, rng=rng)

    def compute_output_shape(self, input_shape):
        concrete = tuple(2 if d is None else d for d in input_shape)
        meta = {k: torch.empty(v.shape, dtype=v.dtype, device="meta")
                for k, v in self._initial_params.items()}
        out = self._emitter.run(meta, torch.empty(concrete, device="meta"))
        return (None,) + tuple(out.shape[1:])


class TorchCriterion:
    """A torch loss module as a zoo Objective: ``loss(y_true, y_pred)``.

    The module is fx-traced once and emitted with the same ops as
    ``TorchNet``.  The torch convention is ``forward(input, target)``;
    the zoo loss convention is ``(y_true, y_pred)`` — the adapter swaps
    them, and takes the mean of what the loss returns.
    """

    def __init__(self, torch_module):
        import torch.fx
        self.gm = torch.fx.symbolic_trace(torch_module.eval())
        self._params = TorchNet._extract_params(torch_module)
        self._emitter = _Emitter(self.gm, self._params)
        # objectives.get reads __name__ for the Objective label
        self.name = self.__name__ = type(torch_module).__name__

    @classmethod
    def from_pytorch(cls, criterion) -> "TorchCriterion":
        return cls(criterion)

    def __call__(self, y_true, y_pred):
        params = {k: v.to(y_pred.device) if v.device != y_pred.device
                  else v for k, v in self._params.items()}
        out = self._emitter.run(params, [y_pred, y_true])
        return torch.mean(out)   # scalarise any per-element remainder
