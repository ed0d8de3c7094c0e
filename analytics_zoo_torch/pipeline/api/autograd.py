"""Autograd API: symbolic ``Variable`` algebra over the layer graph (port
of ``pipeline/api/autograd.py``).

Reference: zoo/pipeline/api/autograd/ (math.scala:32-378 ``AutoGrad``
ops + ``Variable`` operator overloads, KerasParameter.scala:73
``Parameter``, Lambda.scala:49 variable-function layers,
CustomLoss.scala:66).

A Variable wraps a symbolic ``KTensor``; every op records a ``Lambda``
node whose function is plain tensor code, so PyTorch's autograd is the
engine and this module is API sugar.  ``Parameter`` carries trainable
weights into expressions (a non-trainable one enters detached);
``Constant`` carries a fixed array, moved to the input's device at use;
``CustomLoss`` compiles a ``(y_true, y_pred) -> Variable`` function into
an objective.  The reductions keep the reference's defaults: ``mean`` and
``sum`` reduce ``axis=0`` with ``keep_dims=False``.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np
import torch

from analytics_zoo_torch.pipeline.api.keras.engine import (
    Input, KTensor, Layer, Params,
)
from analytics_zoo_torch.pipeline.api.keras.layers.core import Lambda
from analytics_zoo_torch.pipeline.api.keras.topology import Model

# numpy arrays enter as the reference's jnp.asarray leaves them (64-bit
# values narrowed: JAX runs without x64)
_NARROW = {np.dtype(np.float64): np.float32, np.dtype(np.int64): np.int32}


def _as_tensor(v, like: torch.Tensor):
    """A Python scalar as a tensor of ``like``'s dtype and device."""
    if isinstance(v, torch.Tensor):
        return v
    return torch.tensor(v, dtype=like.dtype, device=like.device)


def _add(a, b):
    return a + b


def _sub(a, b):
    return a - b


def _mul(a, b):
    return a * b


def _div(a, b):
    return a / b


def _maximum(a, b):
    a = _as_tensor(a, b)
    return torch.maximum(a, _as_tensor(b, a))


def _minimum(a, b):
    a = _as_tensor(a, b)
    return torch.minimum(a, _as_tensor(b, a))


class Variable:
    """Symbolic tensor with operator overloads."""

    def __init__(self, input_shape=None, ktensor: Optional[KTensor] = None,
                 name: Optional[str] = None):
        if ktensor is None:
            if input_shape is None:
                raise ValueError("Variable needs input_shape or ktensor")
            ktensor = Input(shape=input_shape, name=name)
        self.node = ktensor

    @property
    def shape(self):
        return self.node.shape

    # ------------------------------------------------------------ operators
    def __add__(self, other):
        return _binary(_add, self, other)

    __radd__ = __add__

    def __sub__(self, other):
        return _binary(_sub, self, other)

    def __rsub__(self, other):
        return _binary(lambda a, b: b - a, self, other)

    def __mul__(self, other):
        return _binary(_mul, self, other)

    __rmul__ = __mul__

    def __truediv__(self, other):
        return _binary(_div, self, other)

    def __rtruediv__(self, other):
        return _binary(lambda a, b: b / a, self, other)

    def __pow__(self, p):
        return pow(self, p)

    def __neg__(self):
        return _unary(torch.neg, self)

    def __getitem__(self, key):
        return _unary(lambda x: x[key], self)

    def index_select(self, dim: int, index: int):
        """(ref Variable.indexSelect)"""
        return _unary(lambda x: x.select(dim, index), self)

    def slice(self, dim: int, start: int, length: int):
        return _unary(lambda x: x.narrow(dim, start, length), self)


def _to_variable(x) -> "Variable":
    if isinstance(x, Variable):
        return x
    raise TypeError(f"expected Variable, got {type(x)}")


def _unary(fn: Callable, v: Variable) -> Variable:
    return Variable(ktensor=Lambda(fn)(v.node))


def _binary(fn: Callable, a, b) -> Variable:
    if isinstance(a, (Parameter, Constant)) or \
            isinstance(b, (Parameter, Constant)):
        return _param_binary(fn, a, b)
    if np.isscalar(b):
        return _unary(lambda x: fn(x, b), a)
    if np.isscalar(a):
        return _unary(lambda x: fn(a, x), b)
    layer = Lambda(lambda xs: fn(xs[0], xs[1]))
    return Variable(ktensor=layer([a.node, b.node]))


# ------------------------------------------------------------------ params
class _ParamLayer(Layer):
    """A Lambda-like layer carrying trainable weights referenced by the
    expression (how Parameter enters the graph)."""

    def __init__(self, fn: Callable, param_specs, **kwargs):
        super().__init__(**kwargs)
        self.fn = fn                       # fn(weights: dict, inputs: list)
        self.param_specs = param_specs     # name -> (shape, init)

    def build(self, rng, input_shape) -> Params:
        params: Params = {}
        for pname, (shape, init) in self.param_specs.items():
            self.add_weight(params, rng, pname, shape, init=init)
        return params

    def call(self, params, x, training=False, rng=None):
        xs = x if isinstance(x, (list, tuple)) else [x]
        return self.fn(params, xs)

    def compute_output_shape(self, input_shape):
        shapes = input_shape if isinstance(input_shape, list) \
            else [input_shape]

        def concrete(s):
            return tuple(1 if d is None else d for d in s)
        probes = [torch.zeros(concrete(s)) for s in shapes]
        zero_params = {n: torch.zeros(spec[0])
                       for n, spec in self.param_specs.items()}
        out = self.fn(zero_params, probes)
        return (None,) + tuple(out.shape[1:])


class Parameter(Variable):
    """Trainable weight usable in variable expressions
    (KerasParameter.scala:73).  Enters the graph when combined with a
    graph-connected Variable."""

    def __init__(self, shape: Sequence[int], init="glorot_uniform",
                 trainable: bool = True, name: Optional[str] = None):
        self.param_shape = tuple(int(d) for d in shape)
        self.param_init = init
        self.trainable = trainable
        self._name = name
        self.node = None    # bound lazily

    @property
    def shape(self):
        return self.param_shape


class Constant(Variable):
    """Non-trainable constant in expressions (KerasConstant)."""

    def __init__(self, data, name: Optional[str] = None):
        arr = np.asarray(data)
        self.data = torch.as_tensor(arr.astype(_NARROW.get(arr.dtype,
                                                           arr.dtype)))
        self.node = None

    @property
    def shape(self):
        return tuple(self.data.shape)


def _param_binary(fn: Callable, a, b) -> Variable:
    specs = {}
    inputs = []

    def encode(v, tag):
        if isinstance(v, Parameter):
            specs[tag] = (v.param_shape, v.param_init)
            return ("param", tag, v.trainable)
        if isinstance(v, Constant):
            return ("const", v.data, None)
        if np.isscalar(v):
            return ("scalar", v, None)
        inputs.append(_to_variable(v).node)
        return ("input", len(inputs) - 1, None)

    ea = encode(a, "w_a")
    eb = encode(b, "w_b")
    if not inputs:
        raise ValueError(
            "an expression of only Parameters/Constants has no batch "
            "input; combine with a graph Variable first")

    def run(params, xs):
        def fetch(e):
            kind, v, trainable = e
            if kind == "param":
                w = params[v]
                return w if trainable else w.detach()
            if kind == "const":
                return v.to(xs[0].device)
            if kind == "scalar":
                return v
            return xs[v]
        return fn(fetch(ea), fetch(eb))

    layer = _ParamLayer(run, specs)
    kt = layer(inputs if len(inputs) > 1 else inputs[0])
    return Variable(ktensor=kt)


# ---------------------------------------------------------------- AutoGrad
def _dims(x, axis):
    return tuple(range(x.ndim)) if axis is None else axis


def mean(v: Variable, axis=0, keep_dims: bool = False) -> Variable:
    return _unary(lambda x: torch.mean(x, dim=_dims(x, axis),
                                       keepdim=keep_dims), v)


def sum(v: Variable, axis=0, keep_dims: bool = False) -> Variable:  # noqa: A001
    return _unary(lambda x: torch.sum(x, dim=_dims(x, axis),
                                      keepdim=keep_dims), v)


def abs(v: Variable) -> Variable:  # noqa: A001
    return _unary(torch.abs, v)


def clip(v: Variable, min: float, max: float) -> Variable:  # noqa: A002
    return _unary(lambda x: torch.clamp(x, min, max), v)


def square(v: Variable) -> Variable:
    return _unary(torch.square, v)


def sqrt(v: Variable) -> Variable:
    return _unary(torch.sqrt, v)


def exp(v: Variable) -> Variable:
    return _unary(torch.exp, v)


def log(v: Variable) -> Variable:
    return _unary(torch.log, v)


def pow(v: Variable, p: float) -> Variable:  # noqa: A001
    return _unary(lambda x: torch.pow(x, p), v)


def maximum(a, b) -> Variable:
    return _binary(_maximum, a, b)


def minimum(a, b) -> Variable:
    return _binary(_minimum, a, b)


def softsign(v: Variable) -> Variable:
    return _unary(lambda x: x / (torch.abs(x) + 1), v)


def softplus(v: Variable) -> Variable:
    return _unary(lambda x: torch.logaddexp(x, torch.zeros_like(x)), v)


def expand_dims(v: Variable, axis: int) -> Variable:
    return _unary(lambda x: torch.unsqueeze(x, axis), v)


def contiguous(v: Variable) -> Variable:
    return _unary(lambda x: x, v)


def l2_normalize(v: Variable, axis: int = -1) -> Variable:
    return _unary(
        lambda x: x / torch.clamp(torch.sqrt(torch.sum(
            x * x, dim=axis, keepdim=True)), min=1e-12), v)


def mm(a: Variable, b: Variable, axes=None) -> Variable:
    """Batched tensor contraction (math.scala mm)."""
    if axes is None:
        return _binary(torch.matmul, a, b)
    return _binary(lambda x, y: torch.tensordot(x, y, dims=axes), a, b)


def batch_dot(a: Variable, b: Variable, axes=(2, 1)) -> Variable:
    ax_a, ax_b = axes

    def f(x, y):
        return torch.einsum("b...i,bi...->b...", torch.movedim(x, ax_a, -1),
                            torch.movedim(y, ax_b, 1))
    return _binary(f, a, b)


def dot(a: Variable, b: Variable) -> Variable:
    return _binary(lambda x, y: torch.sum(x * y, dim=-1, keepdim=True),
                   a, b)


def stack(vars: Sequence[Variable], axis: int = 1) -> Variable:  # noqa: A002
    layer = Lambda(lambda xs: torch.stack(list(xs), dim=axis))
    return Variable(ktensor=layer([v.node for v in vars]))


def concatenate(vars: Sequence[Variable], axis: int = -1) -> Variable:
    layer = Lambda(lambda xs: torch.cat(list(xs), dim=axis))
    return Variable(ktensor=layer([v.node for v in vars]))


# ------------------------------------------------------------- CustomLoss
class CustomLoss:
    """Compile ``fn(y_true, y_pred) -> Variable`` into an Objective
    (CustomLoss.scala:66)."""

    def __init__(self, loss_fn: Callable, y_pred_shape,
                 y_true_shape=None):
        yt = Variable(input_shape=tuple(y_true_shape or y_pred_shape))
        yp = Variable(input_shape=tuple(y_pred_shape))
        out = loss_fn(yt, yp)
        self.model = Model([yt.node, yp.node], out.node)
        self.variables = self.model.init(torch.Generator().manual_seed(17))
        self.name = "custom_loss"

    def __call__(self, y_true, y_pred):
        out, _ = self.model.apply(self.variables["params"],
                                  [y_true, y_pred], state={})
        return torch.mean(out)


def create_lambda(fn: Callable, input_shapes) -> Model:
    """Build a Keras-compatible layer from a Variable function
    (Lambda.scala:49 — autograd Lambda)."""
    single = not isinstance(input_shapes[0], (list, tuple))
    shapes = [input_shapes] if single else list(input_shapes)
    vs = [Variable(input_shape=tuple(s)) for s in shapes]
    out = fn(*vs)
    return Model([v.node for v in vs], out.node)
