"""Keras-style layer engine (port of ``pipeline/api/keras/engine.py``).

The reference's functional contract carries over unchanged, because the
weight carry-over depends on it:

- a ``Layer`` owns no tensors; ``build`` returns its params as a dict
  ``{param_name: tensor}`` and a container's params are
  ``{layer_name: {param_name: tensor}}``,
- ``apply(params, inputs, state, training, rng) -> (outputs, state)`` is
  a pure function of its arguments,
- layers are auto-named ``f"{cls}_{n}".lower()`` from a process-global
  counter, reset by ``Layer.reset_name_counters()``,
- graph construction is symbolic: calling a layer on a ``KTensor``
  records a ``Node``; ``Model(input, output)`` sorts the node graph.

Random numbers come from explicit ``torch.Generator``s: ``fold_name``
derives a layer's generator from its parent's seed and the layer's name,
as the reference folds the name into a ``jax.random`` key.

Shapes follow Keras convention: ``input_shape`` excludes the batch dim;
internally shapes are batch-inclusive with ``None`` in dim 0.
"""

from __future__ import annotations

import zlib
from collections import defaultdict
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from analytics_zoo_torch.ops import initializers as inits
from analytics_zoo_torch.ops.dtypes import get_policy

Shape = Tuple[Optional[int], ...]
Params = Dict[str, Any]
State = Dict[str, Any]

_SEED_MOD = 2 ** 63


def to_batch_shape(shape) -> Shape:
    """Normalise a user shape (no batch dim) to (None, ...)."""
    shape = tuple(shape)
    if len(shape) > 0 and shape[0] is None:
        return shape
    return (None,) + shape


def fold_name(rng: torch.Generator, name: str) -> torch.Generator:
    """Deterministic per-layer generator (stable across runs): a fresh
    generator on ``rng``'s device, seeded from ``rng``'s seed and the CRC
    of ``name`` (through ``compile.engine.derived_generator``, so that a
    captured step re-seeds it on every replay)."""
    from analytics_zoo_torch.compile.engine import derived_generator
    crc = zlib.crc32(name.encode()) & 0x7FFFFFFF

    def seed_of(parent: int) -> int:
        return (parent * 0x9E3779B97F4A7C15 + crc) % _SEED_MOD
    return derived_generator(rng, seed_of)


# ------------------------------------------------------- activation taps
# Calibration hook (int8 activation quantization, ops/quant.py): inside
# ``record_activations()`` the containers report each layer's INPUT
# absmax.  With no recorder active a tap returns at once: no reduction,
# no host read.
_ACT_TAP: Optional[Dict[str, float]] = None


class record_activations:
    """``with record_activations() as ranges:`` — run forwards;
    ``ranges`` maps layer name -> max |input| seen."""

    def __enter__(self) -> Dict[str, float]:
        global _ACT_TAP
        self._prev = _ACT_TAP
        _ACT_TAP = {}
        return _ACT_TAP

    def __exit__(self, *exc):
        global _ACT_TAP
        _ACT_TAP = self._prev
        return False


def tap_activation(name: str, x) -> None:
    if _ACT_TAP is None:
        return
    for leaf in (x if isinstance(x, (list, tuple)) else (x,)):
        if isinstance(leaf, torch.Tensor) and leaf.is_floating_point():
            m = float(leaf.abs().max())
            _ACT_TAP[name] = max(_ACT_TAP.get(name, 0.0), m)


def _is_shape(x) -> bool:
    return isinstance(x, (tuple, list)) and all(
        v is None or isinstance(v, (int, np.integer)) for v in x)


class KTensor:
    """Symbolic tensor flowing through the layer graph."""

    __slots__ = ("shape", "dtype", "node", "index")

    def __init__(self, shape: Shape, dtype=torch.float32,
                 node: Optional["Node"] = None, index: int = 0):
        self.shape = tuple(shape)
        self.dtype = dtype
        self.node = node        # producing Node (None for placeholders)
        self.index = index      # position among the node's outputs

    def __repr__(self):
        return f"KTensor(shape={self.shape}, dtype={self.dtype})"


class Node:
    """One application of a layer to a set of input tensors."""

    __slots__ = ("layer", "inbound", "outputs", "call_kwargs")

    def __init__(self, layer: "Layer", inbound: List[KTensor],
                 outputs: List[KTensor], call_kwargs: Optional[dict] = None):
        self.layer = layer
        self.inbound = inbound
        self.outputs = outputs
        self.call_kwargs = call_kwargs or {}


def Input(shape=None, dtype=torch.float32,
          name: Optional[str] = None) -> KTensor:
    """Placeholder tensor — entry point of a graph ``Model``."""
    if shape is None:
        raise ValueError("Input(shape=...) is required")
    return KTensor(to_batch_shape(shape), dtype=dtype, node=None)


class Layer:
    """Base layer: pure-functional params + symbolic graph building."""

    _counters: Dict[str, int] = defaultdict(int)

    @classmethod
    def reset_name_counters(cls) -> None:
        """Reset auto-naming (e.g. before rebuilding a model that must
        produce checkpoint-compatible parameter names)."""
        Layer._counters.clear()

    def __init__(self, input_shape=None, name: Optional[str] = None,
                 input_dtype=torch.float32):
        cls = type(self).__name__
        if name is None:
            Layer._counters[cls] += 1
            name = f"{cls}_{Layer._counters[cls]}".lower()
        self.name = name
        self.built = False
        # transfer-learning freeze flag: a frozen layer's params enter the
        # containers' forward detached, and the training engine keeps them
        # bit-identical through the update
        self.trainable = True
        self.batch_input_shape: Optional[Shape] = (
            to_batch_shape(input_shape) if input_shape is not None else None)
        self.input_dtype = input_dtype
        self._output_shape: Optional[Shape] = None
        self._nodes: List[Node] = []
        # param_name -> (l1, l2) weight-decay coefficients
        self.param_regularizers: Dict[str, Tuple[float, float]] = {}
        # param_name -> parallel.mesh.Shard: the tensor-parallel specs a
        # layer declares in ``build`` (parallel/sharding.py reads them)
        self.param_pspecs: Dict[str, object] = {}

    # ---------------------------------------------------------------- numeric
    def build(self, rng, input_shape) -> Params:
        """Create the parameter dict for ``input_shape`` (batch-incl.)."""
        return {}

    def init_state(self, input_shape) -> State:
        """Create the non-trainable state dict (e.g. BN moving stats)."""
        return {}

    def call(self, params: Params, inputs, training: bool = False,
             rng=None):
        """Stateless forward. Stateful layers override ``apply`` instead."""
        raise NotImplementedError(type(self).__name__)

    def apply(self, params: Params, inputs, state: Optional[State] = None,
              training: bool = False, rng=None):
        """Pure forward returning ``(outputs, new_state)``."""
        return self.call(params, inputs, training=training, rng=rng), state

    def compute_output_shape(self, input_shape):
        return input_shape

    # ------------------------------------------------------------- lifecycle
    def init(self, rng, input_shape=None):
        """Build params+state. Returns ``{"params": ..., "state": ...}``."""
        shape = self._resolve_input_shape(input_shape)
        self._mark_built(shape)
        return {"params": self.build(rng, shape),
                "state": self.init_state(shape)}

    def _resolve_input_shape(self, input_shape):
        if input_shape is None:
            if self.batch_input_shape is None:
                raise ValueError(
                    f"layer {self.name}: no input shape available")
            return self.batch_input_shape
        if _is_shape(input_shape):
            return to_batch_shape(input_shape)
        # multi-input: list of shapes
        return [to_batch_shape(s) for s in input_shape]

    def _mark_built(self, input_shape):
        self.built = True
        self._built_input_shape = input_shape
        self._output_shape = self.compute_output_shape(input_shape)

    # ------------------------------------------------------ shape accessors
    def get_output_shape(self) -> Shape:
        if self._output_shape is None:
            if self.batch_input_shape is not None:
                self._output_shape = self.compute_output_shape(
                    self.batch_input_shape)
            else:
                raise ValueError(f"layer {self.name} has no known shape yet")
        return self._output_shape

    def get_input_shape(self) -> Shape:
        if self.batch_input_shape is not None:
            return self.batch_input_shape
        if getattr(self, "_built_input_shape", None) is not None:
            return self._built_input_shape
        raise ValueError(f"layer {self.name} has no known input shape")

    # ------------------------------------------------------------- symbolic
    def __call__(self, inputs, **call_kwargs):
        single = not isinstance(inputs, (list, tuple))
        in_list = [inputs] if single else list(inputs)
        for t in in_list:
            if not isinstance(t, KTensor):
                raise TypeError(
                    f"layer {self.name} called on non-KTensor {type(t)}; "
                    "use .apply/.call for numeric execution")
        shapes = [t.shape for t in in_list]
        in_shape = shapes[0] if (single or len(shapes) == 1) else shapes
        if self.batch_input_shape is None and _is_shape(in_shape):
            self.batch_input_shape = in_shape
        out_shape = self.compute_output_shape(in_shape)
        self._output_shape = out_shape
        multi_out = isinstance(out_shape, list)
        out_shapes = out_shape if multi_out else [out_shape]
        dtype = in_list[0].dtype
        outs = [KTensor(s, dtype=dtype, index=i) for i, s in
                enumerate(out_shapes)]
        node = Node(self, in_list, outs, call_kwargs)
        for t in outs:
            t.node = node
        self._nodes.append(node)
        return outs[0] if not multi_out else outs

    # --------------------------------------------------------------- params
    def add_weight(self, params: Params, rng, name: str, shape,
                   init="glorot_uniform", dtype=None, regularizer=None):
        """Helper used inside ``build`` implementations: draws on the CPU
        from a generator folded from ``rng`` and the param name, and
        registers ``regularizer`` (an ``(l1, l2)`` pair) for the param."""
        dtype = dtype or get_policy().param_dtype
        params[name] = inits.get(init)(fold_name(rng, name), tuple(shape),
                                       dtype)
        if regularizer is not None:
            self.param_regularizers[name] = regularizer
        return params

    def regularization_loss(self, params: Params):
        """Sum of the L1/L2 penalties registered on this layer's params
        (a float 0.0 when there are none); a registered name the params
        lack is skipped."""
        total = 0.0
        for pname, (l1, l2) in self.param_regularizers.items():
            if pname not in params:
                continue
            w = params[pname]
            if l1:
                total = total + l1 * w.abs().sum()
            if l2:
                total = total + l2 * w.square().sum()
        return total

    def __repr__(self):
        return f"{type(self).__name__}(name={self.name})"


class Container(Layer):
    """A layer composed of sub-layers; params keyed by sub-layer name.
    Layer names must be unique."""

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self.layers: List[Layer] = []

    def _check_duplicate(self):
        seen = set()
        for l in self.layers:
            if l.name in seen:
                raise ValueError(f"duplicate layer name: {l.name}")
            seen.add(l.name)

    def regularization_loss_tree(self, params: Params):
        """The penalties of every layer below this container, nested
        containers included."""
        total = 0.0
        for l in self.layers:
            sub = params.get(l.name, {})
            if isinstance(l, Container):
                total = total + l.regularization_loss_tree(sub)
            else:
                total = total + l.regularization_loss(sub)
        return total

    def regularization_loss(self, params: Params):
        return self.regularization_loss_tree(params)
