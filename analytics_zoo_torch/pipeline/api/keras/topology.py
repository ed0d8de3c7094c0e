"""Graph ``Model`` container and the KerasNet surface (port of
``pipeline/api/keras/topology.py``).

Ported: ``init``/``get_variables``/``set_variables``/``get_weights``/
``set_weights``, the graph ``Model.apply``, and the training surface
``compile``/``fit`` (on ndarrays or a FeatureSet, with validation)/
``evaluate``/``predict``/``predict_classes`` with the gradient-clipping
setters, which run the single-device ``Estimator``; ``set_checkpoint``
(``fit`` then snapshots into that directory every epoch, or on the given
trigger, and resumes from its latest snapshot); ``save_model``/
``load_weights`` (the JAX package's file layout, ``utils/
serialization.py``); ``quantize`` (the calibrated int8 conversion,
``ops/quant.py``); the transfer-learning surgery (``freeze``/``unfreeze``/
``init_from``, ``Model.freeze_up_to``/``new_graph``: a frozen layer's
params enter the forward detached, the counterpart of ``stop_gradient``,
and the trainer keeps them bit-identical through the update); and the
``Sequential`` stack.  Both containers report each layer's input to the
calibration taps (``engine.tap_activation``).  TensorBoard is not ported
yet.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from analytics_zoo_torch.pipeline.api.keras.engine import (
    Container, KTensor, Layer, Node, Params, Shape, State, _is_shape,
    fold_name, tap_activation,
)


def tree_map(fn: Callable, tree, *rest):
    """Map ``fn`` over the leaves of a nest of dicts/lists/tuples (and over
    the matching leaves of ``rest``, trees of the same structure)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_leaves(tree) -> List[Any]:
    """Leaves in the reference's order (dict keys sorted, as jax's
    pytree flattening does)."""
    out: List[Any] = []
    _collect_leaves(tree, out)
    return out


_NESTS = (dict, list, tuple)


def _collect_leaves(node, out: List[Any]) -> None:
    # one list for the whole walk, and no call a leaf: the fused update
    # flattens its trees every step
    if isinstance(node, dict):
        for k in sorted(node):
            v = node[k]
            if isinstance(v, _NESTS):
                _collect_leaves(v, out)
            else:
                out.append(v)
    elif isinstance(node, (list, tuple)):
        for v in node:
            if isinstance(v, _NESTS):
                _collect_leaves(v, out)
            else:
                out.append(v)
    else:
        out.append(node)


def tree_replace(tree, leaves):
    """``tree`` with its leaves replaced, in ``tree_leaves`` order, by
    ``leaves``."""
    it = iter(leaves)

    def rebuild(node):
        if isinstance(node, dict):
            return {k: rebuild(node[k]) for k in sorted(node)}
        if isinstance(node, (list, tuple)):
            return type(node)(rebuild(v) for v in node)
        return next(it)
    return rebuild(tree)


def to_device(tree, device):
    return tree_map(lambda t: t.to(device) if isinstance(t, torch.Tensor)
                    else t, tree)


class KerasNet(Container):
    """Variables facade shared by the containers."""

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self.optim_method = None
        self.loss = None
        self.metrics = None
        self._checkpoint_path = None
        self._checkpoint_trigger = None
        self._overwrite_checkpoint = True
        self._gradient_clipping = None   # ("const", min, max) | ("l2norm", v)
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
        new = [torch.as_tensor(np.asarray(w)).reshape(l.shape)
               .to(device=l.device, dtype=l.dtype)
               for l, w in zip(leaves, weights)]
        variables["params"] = tree_replace(variables["params"], new)
        self._variables = variables


    # -------------------------------------------------------------- compile
    def compile(self, optimizer, loss, metrics=None):
        """Configure training: ``optimizer`` a name ("sgd"/"adam") or an
        ``optimizers.OptimMethod``; ``loss`` a name, ``Objective`` or
        callable; ``metrics`` a list of names or ``metrics.Metric``."""
        from analytics_zoo_torch.pipeline.api.keras import metrics as met
        from analytics_zoo_torch.pipeline.api.keras import objectives
        from analytics_zoo_torch.pipeline.api.keras import optimizers
        self.optim_method = optimizers.get(optimizer)
        self.loss = objectives.get(loss)
        self.metrics = [met.get(m) for m in (metrics or [])]
        return self

    def set_checkpoint(self, path: str, over_write: bool = True,
                       trigger=None):
        """Snapshot ``fit`` into the directory ``path`` when ``trigger``
        fires (default ``EveryEpoch()``); a later ``fit`` resumes from
        the latest snapshot there."""
        self._checkpoint_path = path
        self._overwrite_checkpoint = over_write
        self._checkpoint_trigger = trigger

    def set_constant_gradient_clipping(self, min_value: float,
                                       max_value: float):
        self._gradient_clipping = ("const", float(min_value),
                                   float(max_value))

    def set_gradient_clipping_by_l2_norm(self, clip_norm: float):
        self._gradient_clipping = ("l2norm", float(clip_norm))

    def clear_gradient_clipping(self):
        self._gradient_clipping = None

    # ------------------------------------------------------------------ fit
    def fit(self, x, y=None, batch_size: int = 32, nb_epoch: int = 10,
            validation_data=None, validation_split: float = 0.0,
            shuffle: bool = True, rng: Optional[int] = None):
        """Train on ndarrays, a FeatureSet or a resumable DataPipeline
        (``data/``; its own batch size replaces ``batch_size``); returns
        the per-epoch history
        ``[{"epoch", "loss", "throughput", "wall_s"[, "val"]}, ...]``.
        ``validation_data`` (``(x, y)``, a FeatureSet or a DataPipeline
        built with ``remainder="pad"``), or the last
        ``validation_split`` of ndarray data, is scored after each epoch
        with the compiled metrics (the loss when none was compiled).
        ``rng`` is the integer seed the dropout generators derive from
        (default: ``data.shuffle_seed``)."""
        from analytics_zoo_torch.common.triggers import EveryEpoch, MaxEpoch
        from analytics_zoo_torch.data import DataPipeline
        from analytics_zoo_torch.feature.feature_set import FeatureSet
        from analytics_zoo_torch.pipeline.api.keras.metrics import Loss
        from analytics_zoo_torch.pipeline.estimator import Estimator
        if isinstance(x, (FeatureSet, DataPipeline)):
            if validation_split:
                raise ValueError(
                    "validation_split is not supported when x is a "
                    "FeatureSet/DataPipeline; pass validation_data "
                    "instead")
            train_set = x
        else:
            if validation_split and validation_data is None:
                n = len(tree_leaves(x)[0])
                cut = int(n * (1 - validation_split))
                validation_data = (
                    tree_map(lambda a: a[cut:], x),
                    tree_map(lambda a: a[cut:], y))
                x = tree_map(lambda a: a[:cut], x)
                y = tree_map(lambda a: a[:cut], y)
            train_set = FeatureSet.from_ndarrays(x, y, shuffle=shuffle)
        val_set = None
        if validation_data is not None:
            if isinstance(validation_data, (FeatureSet, DataPipeline)):
                val_set = validation_data
            else:
                vx, vy = validation_data
                val_set = FeatureSet.from_ndarrays(vx, vy, shuffle=False)
        # at least the validation loss is reported, Keras-style
        validation_method = list(self.metrics or [])
        if val_set is not None and not validation_method:
            validation_method = [Loss(self.loss)]
        estimator = Estimator(self, optim_method=self.optim_method,
                              model_dir=self._checkpoint_path)
        if self._gradient_clipping is not None:
            kind, *args = self._gradient_clipping
            if kind == "const":
                estimator.set_constant_gradient_clipping(*args)
            else:
                estimator.set_l2_norm_gradient_clipping(*args)
        estimator.train(train_set, self.loss,
                        end_trigger=MaxEpoch(nb_epoch),
                        checkpoint_trigger=(self._checkpoint_trigger or
                                            EveryEpoch()),
                        validation_set=val_set,
                        validation_method=validation_method,
                        batch_size=batch_size, rng=rng)
        self._variables = estimator.variables
        return estimator.history

    def evaluate(self, x, y=None, batch_size: int = 32):
        """Loss and metrics over a dataset: ``{"loss": ..., metric: ...}``."""
        from analytics_zoo_torch.feature.feature_set import FeatureSet
        data = x if isinstance(x, FeatureSet) else \
            FeatureSet.from_ndarrays(x, y, shuffle=False)
        return self._infer_estimator().evaluate(
            data, self.loss, validation_method=self.metrics or [],
            batch_size=batch_size)

    def _infer_estimator(self):
        """The inference Estimator, kept on the model: its evaluate and
        predict programs are captured once per model, not once per call."""
        if getattr(self, "_cached_infer_estimator", None) is None:
            from analytics_zoo_torch.pipeline.estimator import Estimator
            self._cached_infer_estimator = Estimator(self)
        return self._cached_infer_estimator

    def predict(self, x, batch_size: int = 256):
        """Batched inference on the zoo context's device; host numpy out."""
        return self._infer_estimator().predict(x, batch_size=batch_size)

    def predict_classes(self, x, batch_size: int = 256,
                        zero_based_label: bool = True):
        """Arg-max class of each prediction (1-based unless
        ``zero_based_label``)."""
        classes = np.argmax(self.predict(x, batch_size=batch_size), axis=-1)
        return classes if zero_based_label else classes + 1

    # ------------------------------------------------------- quantization
    def quantize(self, calib_data, batch_size: int = 32,
                 max_batches: int = 8, min_size: int = 1024):
        """Calibrated int8 conversion IN PLACE: record per-layer input
        ranges over ``calib_data``, rewrite eligible kernels to int8 with
        per-output-channel scales in the params-driven layout
        (``ops/quant.py``), and install the quantized variables on this
        model; every later ``predict`` or serving call runs the int8
        products.  Training a quantized model is not supported: re-``init``
        or reload weights to go back to float32.  Returns self."""
        from analytics_zoo_torch.ops.quant import (
            calibrate_model, quantize_model)
        ranges = calibrate_model(self, calib_data, batch_size=batch_size,
                                 max_batches=max_batches)
        self.set_variables(quantize_model(
            self.get_variables(), ranges, min_size=min_size))
        return self

    @property
    def is_quantized(self) -> bool:
        params = (self._variables or {}).get("params", {})
        return any("kernel_scale" in p for p in params.values()
                   if isinstance(p, dict))

    # ------------------------------------------- transfer-learning surgery
    def freeze(self, *names: str) -> "KerasNet":
        """Mark layers non-trainable (NetUtils.scala:267 ``freeze``); no
        names freezes every layer.  A frozen layer's params enter the
        forward detached and the trainer keeps them bit-identical through
        the update.  Call before ``fit``."""
        targets = self._layers_by_names(names) if names else self.layers
        for l in targets:
            l.trainable = False
        return self

    def unfreeze(self, *names: str) -> "KerasNet":
        """Re-enable training (NetUtils.scala:276 ``unFreeze``); no names
        = all layers."""
        targets = self._layers_by_names(names) if names else self.layers
        for l in targets:
            l.trainable = True
        return self

    def frozen_layer_names(self):
        return {l.name for l in self.layers
                if not getattr(l, "trainable", True)}

    def init_from(self, donor: "KerasNet", rng=None):
        """Init this net, then adopt the donor's variables (the same
        tensors) for every layer shared by name: stack a new head on
        ``new_graph(...)`` outputs, then ``ft.init_from(pretrained)``."""
        self.init(rng)
        dv = donor.get_variables()
        for l in self.layers:
            if l.name in dv["params"]:
                self._variables["params"][l.name] = dv["params"][l.name]
                if l.name in dv.get("state", {}):
                    self._variables["state"][l.name] = dv["state"][l.name]
        return self._variables

    def _layers_by_names(self, names):
        by_name = {l.name: l for l in self.layers}
        missing = [n for n in names if n not in by_name]
        if missing:
            raise ValueError(
                f"no such layer(s): {missing}; have {sorted(by_name)}")
        return [by_name[n] for n in names]

    @staticmethod
    def _layer_params(params, layer):
        """The layer's params, detached when it is frozen."""
        p = params[layer.name]
        if not getattr(layer, "trainable", True):
            p = tree_map(lambda t: t.detach()
                         if isinstance(t, torch.Tensor) else t, p)
        return p

    # ------------------------------------------------------------ save/load
    def save_model(self, path: str, over_write: bool = True):
        """The variables to ``path`` in the JAX package's layout (atomic;
        ``over_write=False`` refuses an existing file).  On a mesh of
        several ranks every rank calls it: rank 0 writes (the variables
        are whole after training) and the others wait for the file."""
        from analytics_zoo_torch.common.zoo_context import get_zoo_context
        from analytics_zoo_torch.utils.serialization import save_variables
        mesh = get_zoo_context().mesh
        if mesh.rank == 0:
            save_variables(path, self.get_variables(), over_write=over_write)
        if mesh.world_size > 1:
            from analytics_zoo_torch.parallel import comm
            comm.barrier()

    def load_weights(self, path: str):
        """The variables from a file either package's ``save_model``
        wrote, onto this model's device; a missing, unreadable or
        mismatched file raises."""
        from analytics_zoo_torch.utils.serialization import load_variables
        self._variables = load_variables(path, like=self.get_variables())
        return self


class Sequential(KerasNet):
    """Layer stack with shape inference on ``add``."""

    def __init__(self, name: Optional[str] = None):
        super().__init__(name=name)
        self._running_shape = None

    def add(self, layer: Layer) -> "Sequential":
        if not self.layers:
            shape = layer.batch_input_shape
            if shape is None and isinstance(layer, Sequential):
                shape = layer.layers[0].batch_input_shape if layer.layers \
                    else None
            if shape is None:
                raise ValueError(
                    f"first layer {layer.name} needs input_shape")
            self.batch_input_shape = shape
            self._running_shape = shape
        elif layer.batch_input_shape is None:
            layer.batch_input_shape = (
                self._running_shape if _is_shape(self._running_shape)
                else None)
        self._running_shape = layer.compute_output_shape(
            layer.batch_input_shape if layer.batch_input_shape is not None
            else self._running_shape)
        self.layers.append(layer)
        self._check_duplicate()
        self._output_shape = self._running_shape
        return self

    def compute_output_shape(self, input_shape):
        shape = input_shape
        for l in self.layers:
            shape = l.compute_output_shape(shape)
        return shape

    def build(self, rng, input_shape) -> Params:
        params: Params = {}
        self._sub_state: State = {}
        shape = input_shape
        for l in self.layers:
            sub = l.init(fold_name(rng, l.name), shape)
            params[l.name] = sub["params"]
            self._sub_state[l.name] = sub["state"]
            shape = l.compute_output_shape(shape)
        return params

    def init_state(self, input_shape) -> State:
        return getattr(self, "_sub_state", {})

    def apply(self, params, inputs, state=None, training=False, rng=None):
        state = state or {}
        new_state = dict(state)
        x = inputs
        for l in self.layers:
            sub_rng = fold_name(rng, l.name) if rng is not None else None
            tap_activation(l.name, x)
            x, s = l.apply(self._layer_params(params, l), x,
                           state=state.get(l.name),
                           training=training, rng=sub_rng)
            if s is not None:
                new_state[l.name] = s
        return x, new_state


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

    # ------------------------------------------- transfer-learning surgery
    def freeze_up_to(self, *names: str) -> "Model":
        """Freeze every layer from the inputs up to AND including the
        named layers (NetUtils.scala:267 ``freezeUpTo``)."""
        self._layers_by_names(names)   # validate
        targets = set(names)
        frozen_layers = set()
        visited = set()   # node ids: each node of a shared layer is walked

        def visit(node: Node):
            if id(node) in visited:
                return
            visited.add(id(node))
            frozen_layers.add(node.layer.name)
            for t in node.inbound:
                if t.node is not None:
                    visit(t.node)

        for node in self._topo:
            if node.layer.name in targets:
                visit(node)
        for l in self.layers:
            if l.name in frozen_layers:
                l.trainable = False
        return self

    def new_graph(self, outputs) -> "Model":
        """Subgraph extraction (NetUtils.scala:82 ``newGraph``): a new
        Model over the SAME layer objects whose outputs are the named
        layers' outputs.  The retained layers' variables are the source's
        tensors, not copies, and the freeze flags are shared (same layer
        objects).  For a layer applied more than once, the last call's
        output is used."""
        names = [outputs] if isinstance(outputs, str) else list(outputs)
        tensor_of = {}
        for node in self._topo:
            tensor_of[node.layer.name] = (
                node.outputs[0] if len(node.outputs) == 1
                else list(node.outputs))
        missing = [n for n in names if n not in tensor_of]
        if missing:
            raise ValueError(
                f"no such layer(s): {missing}; have {sorted(tensor_of)}")
        outs: List[KTensor] = []
        for n in names:
            t = tensor_of[n]
            outs.extend(t if isinstance(t, list) else [t])
        sub = Model(self.inputs if not self._single_input
                    else self.inputs[0],
                    outs if len(outs) > 1 else outs[0])
        if self._variables is not None:
            params = self._variables["params"]
            state = self._variables["state"]
            sub._variables = {
                "params": {l.name: params[l.name] for l in sub.layers
                           if l.name in params},
                "state": {l.name: state[l.name] for l in sub.layers
                          if l.name in state},
            }
        return sub

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
            tap_activation(l.name, x)
            out, s = l.apply(self._layer_params(params, l), x,
                             state=state.get(l.name),
                             training=training, rng=sub_rng,
                             **node.call_kwargs)
            if s is not None:
                new_state[l.name] = s
            outs = out if isinstance(out, (list, tuple)) else [out]
            for t, v in zip(node.outputs, outs):
                values[id(t)] = v
        results = [values[id(t)] for t in self.outputs]
        return (results[0] if self._single_output else results), new_state
