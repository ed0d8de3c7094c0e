"""Graph ``Model`` container and the KerasNet variables surface (port of
``pipeline/api/keras/topology.py``).

This slice serves: ``init``/``get_variables``/``set_variables``/
``get_weights``/``set_weights`` and the graph ``Model.apply``.
``compile``/``fit``/``evaluate`` come with the training slice.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from analytics_zoo_torch.pipeline.api.keras.engine import (
    Container, KTensor, Node, Params, Shape, State, fold_name,
)


def tree_map(fn: Callable, tree):
    """Map ``fn`` over the leaves of a nest of dicts/lists/tuples."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def tree_leaves(tree) -> List[Any]:
    """Leaves in the reference's order (dict keys sorted, as jax's
    pytree flattening does)."""
    if isinstance(tree, dict):
        return [l for k in sorted(tree) for l in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [l for v in tree for l in tree_leaves(v)]
    return [tree]


def _tree_replace(tree, leaves_iter):
    if isinstance(tree, dict):
        return {k: _tree_replace(tree[k], leaves_iter) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_replace(v, leaves_iter) for v in tree)
    return next(leaves_iter)


def to_device(tree, device):
    return tree_map(lambda t: t.to(device) if isinstance(t, torch.Tensor)
                    else t, tree)


class KerasNet(Container):
    """Variables facade shared by the containers."""

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self._variables = None           # {"params":..., "state":...}
        self._rng = torch.Generator().manual_seed(0)

    # ------------------------------------------------------------ variables
    def init(self, rng: Optional[torch.Generator] = None, input_shape=None):
        """Draw the variables on the CPU, then place them on the zoo
        context's device."""
        from analytics_zoo_torch.common.zoo_context import get_zoo_context
        rng = rng if rng is not None else self._rng
        variables = super().init(rng, input_shape)
        self._variables = to_device(variables, get_zoo_context().device)
        return self._variables

    def get_variables(self):
        if self._variables is None:
            self.init()
        return self._variables

    def set_variables(self, variables):
        self._variables = variables

    def get_weights(self) -> List[np.ndarray]:
        return [w.detach().cpu().numpy()
                for w in tree_leaves(self.get_variables()["params"])]

    def set_weights(self, weights: Sequence[np.ndarray]):
        variables = self.get_variables()
        leaves = tree_leaves(variables["params"])
        if len(leaves) != len(weights):
            raise ValueError(
                f"expected {len(leaves)} arrays, got {len(weights)}")
        new = iter([torch.as_tensor(np.asarray(w)).reshape(l.shape)
                    .to(device=l.device, dtype=l.dtype)
                    for l, w in zip(leaves, weights)])
        variables["params"] = _tree_replace(variables["params"], new)
        self._variables = variables


class Model(KerasNet):
    """Multi-input/multi-output static graph."""

    def __init__(self, input, output, name: Optional[str] = None):
        super().__init__(name=name)
        self.inputs: List[KTensor] = (
            list(input) if isinstance(input, (list, tuple)) else [input])
        self.outputs: List[KTensor] = (
            list(output) if isinstance(output, (list, tuple)) else [output])
        self._single_input = not isinstance(input, (list, tuple))
        self._single_output = not isinstance(output, (list, tuple))
        self._topo: List[Node] = self._topological_sort()
        self.layers = []
        seen = set()
        for node in self._topo:
            if node.layer.name not in seen:
                seen.add(node.layer.name)
                self.layers.append(node.layer)
        self._check_duplicate()
        in_shapes = [t.shape for t in self.inputs]
        self.batch_input_shape = in_shapes[0] if self._single_input \
            else in_shapes
        out_shapes = [t.shape for t in self.outputs]
        self._output_shape = out_shapes[0] if self._single_output \
            else out_shapes

    def _topological_sort(self) -> List[Node]:
        order: List[Node] = []
        visited = set()
        input_ids = {id(t) for t in self.inputs}

        def visit(t: KTensor):
            if id(t) in input_ids or t.node is None:
                if t.node is None and id(t) not in input_ids:
                    raise ValueError(
                        "graph reaches a placeholder not listed in inputs")
                return
            node = t.node
            if id(node) in visited:
                return
            visited.add(id(node))
            for src in node.inbound:
                visit(src)
            order.append(node)

        for t in self.outputs:
            visit(t)
        return order

    def compute_output_shape(self, input_shape):
        return self._output_shape

    def build(self, rng, input_shape) -> Params:
        params: Params = {}
        self._sub_state: State = {}
        shapes: Dict[int, Shape] = {id(t): t.shape for t in self.inputs}
        built = set()
        for node in self._topo:
            in_shapes = [shapes[id(t)] for t in node.inbound]
            l = node.layer
            if l.name not in built:
                built.add(l.name)
                shape_arg = in_shapes[0] if len(in_shapes) == 1 else in_shapes
                sub = l.init(fold_name(rng, l.name), shape_arg)
                params[l.name] = sub["params"]
                self._sub_state[l.name] = sub["state"]
            for t in node.outputs:
                shapes[id(t)] = t.shape
        return params

    def init_state(self, input_shape) -> State:
        return getattr(self, "_sub_state", {})

    def apply(self, params, inputs, state=None, training=False, rng=None):
        state = state or {}
        new_state = dict(state)
        in_list = [inputs] if not isinstance(inputs, (list, tuple)) \
            else list(inputs)
        if len(in_list) != len(self.inputs):
            raise ValueError(
                f"model {self.name} expects {len(self.inputs)} inputs, "
                f"got {len(in_list)}")
        values: Dict[int, Any] = {
            id(t): v for t, v in zip(self.inputs, in_list)}
        for node in self._topo:
            l = node.layer
            args = [values[id(t)] for t in node.inbound]
            x = args[0] if len(args) == 1 else args
            sub_rng = fold_name(rng, l.name) if rng is not None else None
            out, s = l.apply(params[l.name], x, state=state.get(l.name),
                             training=training, rng=sub_rng,
                             **node.call_kwargs)
            if s is not None:
                new_state[l.name] = s
            outs = out if isinstance(out, (list, tuple)) else [out]
            for t, v in zip(node.outputs, outs):
                values[id(t)] = v
        results = [values[id(t)] for t in self.outputs]
        return (results[0] if self._single_output else results), new_state
