"""tf.keras → native-layer conversion (port of the JAX package's
``tfpark/converter.py``).

The architecture converts to framework layers and the weights are
copied, so the converted model trains under the zoo engine with no TF in
the loop.  Two topologies convert:

* a Sequential model → native ``Sequential`` (layer list);
* a functional model → native graph ``Model``: the ``get_config()``
  layer graph is walked node by node (``inbound_nodes`` /
  ``keras_history`` references, in Keras 3's ``__keras_tensor__`` dicts
  and Keras 2's inline lists), with shared layers (one native layer per
  tf layer, applied at every call node), multi-input/multi-output
  models, and arbitrary merge topology.

The converter reads only what the model object offers: ``get_config()``,
``get_layer(name)``, ``layers``, and each layer's ``get_config()``,
``get_build_config()``, ``get_weights()`` and class name.  It imports no
TensorFlow: Sequential against functional is decided from the model's
config (a functional config lists ``input_layers``; a Sequential's has
``layers`` and none), so a stand-in object with those methods converts
where TensorFlow is not installed.

Covered layer set (the reference's): InputLayer, Dense, Conv1D/2D,
(Max/Average/Global)Pooling, Flatten, Dropout, BatchNormalization,
Activation, ReLU/LeakyReLU/ELU/Softmax, Embedding, LSTM, GRU, Reshape,
LayerNormalization, ZeroPadding2D, and the merge family
(Add/Subtract/Multiply/Average/Maximum/Minimum/Concatenate/Dot).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from analytics_zoo_torch.pipeline.api.keras import Model, Sequential
from analytics_zoo_torch.pipeline.api.keras import layers as L
from analytics_zoo_torch.pipeline.api.keras.engine import Input


def _act_name(act) -> Optional[str]:
    name = getattr(act, "__name__", str(act))
    return {"linear": None}.get(name, name)


_MERGE_MODES = {
    "Add": "sum",
    "Subtract": "sub",
    "Multiply": "mul",
    "Average": "ave",
    "Maximum": "max",
    "Minimum": "min",
}


def _make_layer(cls: str, cfg: dict, kw: dict,
                input_shape=None):
    """Build the native layer for one tf.keras layer config; returns
    None for InputLayer (handled by the caller).  ``input_shape`` is
    the serialized build shape when known (used where conversion
    depends on input rank, e.g. Dot axes)."""
    if cls == "InputLayer":
        return None
    if cls == "Dense":
        return L.Dense(cfg["units"],
                       activation=_act_name(cfg["activation"]),
                       bias=cfg["use_bias"], **kw)
    if cls == "Conv2D":
        return L.Convolution2D(
            cfg["filters"], *cfg["kernel_size"],
            subsample=tuple(cfg["strides"]),
            border_mode=cfg["padding"],
            activation=_act_name(cfg["activation"]),
            bias=cfg["use_bias"], **kw)
    if cls == "Conv1D":
        return L.Convolution1D(
            cfg["filters"], cfg["kernel_size"][0],
            strides=tuple(cfg["strides"]),
            border_mode=cfg["padding"],
            activation=_act_name(cfg["activation"]),
            bias=cfg["use_bias"], **kw)
    if cls == "MaxPooling2D":
        return L.MaxPooling2D(pool_size=tuple(cfg["pool_size"]),
                              strides=tuple(cfg["strides"]),
                              border_mode=cfg["padding"], **kw)
    if cls == "AveragePooling2D":
        return L.AveragePooling2D(pool_size=tuple(cfg["pool_size"]),
                                  strides=tuple(cfg["strides"]),
                                  border_mode=cfg["padding"], **kw)
    if cls == "GlobalAveragePooling2D":
        return L.GlobalAveragePooling2D(**kw)
    if cls == "GlobalMaxPooling2D":
        return L.GlobalMaxPooling2D(**kw)
    if cls == "GlobalAveragePooling1D":
        return L.GlobalAveragePooling1D(**kw)
    if cls == "GlobalMaxPooling1D":
        return L.GlobalMaxPooling1D(**kw)
    if cls == "Flatten":
        return L.Flatten(**kw)
    if cls == "Dropout":
        return L.Dropout(cfg["rate"], **kw)
    if cls == "BatchNormalization":
        return L.BatchNormalization(epsilon=cfg["epsilon"],
                                    momentum=cfg["momentum"],
                                    axis=cfg.get("axis", -1),
                                    scale=cfg.get("scale", True),
                                    center=cfg.get("center", True), **kw)
    if cls == "LayerNormalization":
        return L.LayerNorm(epsilon=cfg["epsilon"], **kw)
    if cls == "Activation":
        return L.Activation(cfg["activation"], **kw)
    if cls == "ReLU":
        return L.Activation("relu", **kw)
    if cls == "LeakyReLU":
        return L.LeakyReLU(cfg.get("negative_slope",
                                   cfg.get("alpha", 0.3)), **kw)
    if cls == "ELU":
        return L.ELU(cfg.get("alpha", 1.0), **kw)
    if cls == "Softmax":
        return L.Softmax(**kw)
    if cls == "Embedding":
        return L.Embedding(cfg["input_dim"], cfg["output_dim"], **kw)
    if cls == "LSTM":
        return L.LSTM(cfg["units"],
                      return_sequences=cfg["return_sequences"], **kw)
    if cls == "GRU":
        return L.GRU(cfg["units"],
                     return_sequences=cfg["return_sequences"], **kw)
    if cls == "Reshape":
        return L.Reshape(cfg["target_shape"], **kw)
    if cls == "ZeroPadding2D":
        return L.ZeroPadding2D(cfg["padding"], **kw)
    if cls == "Concatenate":
        return L.Merge(mode="concat", concat_axis=cfg.get("axis", -1),
                       **kw)
    if cls in _MERGE_MODES:
        return L.Merge(mode=_MERGE_MODES[cls], **kw)
    if cls == "Dot":
        axes = cfg.get("axes", -1)
        ax_set = {axes} if isinstance(axes, int) else set(axes)
        # last axis may be spelled -1 or rank-1 (rank from the build
        # shape of either input when available)
        last_axes = {-1}
        if input_shape:
            shp = input_shape[0] if isinstance(
                input_shape[0], (list, tuple)) else input_shape
            last_axes.add(len(shp) - 1)
        if not ax_set <= last_axes:
            raise NotImplementedError(
                f"tfpark converter: Dot(axes={axes}) — only last-axis "
                "dot products convert")
        return L.Merge(mode="cosine" if cfg.get("normalize") else "dot",
                       **kw)
    raise NotImplementedError(
        f"tfpark converter: unsupported layer {cls}; extend _make_layer")


def is_sequential(tf_model) -> bool:
    """Whether ``tf_model`` is a Sequential model, decided from its config
    alone (what ``isinstance(m, tf.keras.Sequential)`` decides in the
    reference): a Sequential config holds ``layers`` and no
    ``input_layers``; a functional one holds both; a model whose config
    cannot be read is neither."""
    try:
        cfg = tf_model.get_config()
    except Exception:   # noqa: BLE001 — the functional path names it
        return False
    return isinstance(cfg, dict) and "layers" in cfg and \
        "input_layers" not in cfg


def convert_keras_model(tf_model):
    """Convert a tf.keras model (Sequential or functional graph) to a
    native model with identical weights."""
    if is_sequential(tf_model):
        return _convert_sequential(tf_model)
    return _convert_functional(tf_model)


# ------------------------------------------------------------- sequential
def _convert_sequential(tf_model) -> Sequential:
    model = Sequential()
    first = True
    pairs = []

    def input_shape_of(layer):
        shape = layer.get_build_config()["input_shape"]
        return tuple(shape[1:])

    for tfl in tf_model.layers:
        kw = {}
        if first:
            kw["input_shape"] = input_shape_of(tfl)
        try:
            build_shape = tfl.get_build_config()["input_shape"]
        except Exception:
            build_shape = None
        nl = _make_layer(type(tfl).__name__, tfl.get_config(), kw,
                         input_shape=build_shape)
        if nl is None:          # InputLayer
            continue
        model.add(nl)
        pairs.append((tfl, nl))
        first = False

    _copy_weights(pairs, model)
    return model


# ------------------------------------------------------------- functional
def _tensor_refs(obj) -> List[Tuple[str, int, int]]:
    """All keras_history references inside one serialized call-arg."""
    refs = []
    if isinstance(obj, dict):
        if obj.get("class_name") == "__keras_tensor__":
            h = obj["config"]["keras_history"]
            refs.append((h[0], int(h[1]), int(h[2])))
        else:
            for v in obj.values():
                refs.extend(_tensor_refs(v))
    elif isinstance(obj, (list, tuple)):
        # keras-2 style inline ref: [layer_name, node_idx, tensor_idx,
        # kwargs?]
        if (len(obj) >= 3 and isinstance(obj[0], str)
                and isinstance(obj[1], int) and isinstance(obj[2], int)):
            refs.append((obj[0], int(obj[1]), int(obj[2])))
        else:
            for v in obj:
                refs.extend(_tensor_refs(v))
    return refs


def _resolve_arg(obj, tensors):
    """Serialized call-arg → KTensor / list / literal."""
    if isinstance(obj, dict):
        if obj.get("class_name") == "__keras_tensor__":
            h = obj["config"]["keras_history"]
            return tensors[(h[0], int(h[1]), int(h[2]))]
        return {k: _resolve_arg(v, tensors) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        if (len(obj) >= 3 and isinstance(obj[0], str)
                and isinstance(obj[1], int) and isinstance(obj[2], int)):
            return tensors[(obj[0], int(obj[1]), int(obj[2]))]
        return [_resolve_arg(v, tensors) for v in obj]
    return obj


def _node_io(node) -> Tuple[list, dict]:
    """Normalise one serialized inbound node to (args, kwargs) across
    keras-3 ({"args": [...], "kwargs": {...}}) and keras-2 (list of
    inline refs) formats."""
    if isinstance(node, dict):
        return list(node.get("args", [])), dict(node.get("kwargs", {}))
    # keras-2: a node is a list of inline refs; multiple refs mean the
    # layer was called on a list of tensors
    return ([list(node)] if len(node) > 1 else [node[0]]), {}


def _norm_spec(spec) -> List[Tuple[str, int, int]]:
    """input_layers/output_layers entry → list of (name, node, idx):
    keras flattens a single spec to ["name", 0, 0]."""
    if not spec:
        return []
    if isinstance(spec[0], str):
        return [(spec[0], int(spec[1]), int(spec[2]))]
    return [(s[0], int(s[1]), int(s[2])) for s in spec]


def _convert_functional(tf_model) -> Model:
    try:
        cfg = tf_model.get_config()
    except Exception as e:
        raise NotImplementedError(
            "tfpark converter: model has no serializable config "
            "(subclassed tf.keras.Model?) — only Sequential and "
            "functional models convert") from e
    if "layers" not in cfg or "input_layers" not in cfg:
        raise NotImplementedError(
            "tfpark converter: expected a functional-model config with "
            f"layers/input_layers, got keys {sorted(cfg)}")

    tensors: Dict[Tuple[str, int, int], object] = {}
    native_by_name: Dict[str, object] = {}

    work = []
    for lc in cfg["layers"]:
        if lc["class_name"] == "InputLayer":
            c = lc["config"]
            shape = c.get("batch_shape") or c.get("batch_input_shape")
            tensors[(lc["name"], 0, 0)] = Input(shape=tuple(shape[1:]),
                                                name=lc["name"])
        else:
            for node_idx, node in enumerate(lc["inbound_nodes"]):
                work.append((lc, node_idx, node))

    # Fixpoint walk: apply every call node whose input tensors exist.
    # A shared layer's later nodes may consume tensors produced after
    # its first node, so a single topological pass over `layers` is not
    # enough.
    while work:
        remaining = []
        progress = False
        for lc, node_idx, node in work:
            args, kwargs = _node_io(node)
            tensor_kwargs = _tensor_refs(kwargs)
            if tensor_kwargs:
                raise NotImplementedError(
                    f"tfpark converter: layer {lc['name']} receives "
                    "tensors via keyword arguments — unsupported call "
                    "signature")
            refs = _tensor_refs(args)
            if not all(r in tensors for r in refs):
                remaining.append((lc, node_idx, node))
                continue
            nl = native_by_name.get(lc["name"])
            if nl is None:
                nl = _make_layer(
                    lc["class_name"], lc["config"], {"name": lc["name"]},
                    input_shape=lc.get("build_config", {}).get(
                        "input_shape"))
                native_by_name[lc["name"]] = nl
            resolved = [_resolve_arg(a, tensors) for a in args]
            if len(resolved) != 1:
                raise NotImplementedError(
                    f"tfpark converter: layer {lc['name']} called with "
                    f"{len(resolved)} positional args — unsupported "
                    "call signature")
            out = nl(resolved[0])
            outs = out if isinstance(out, (list, tuple)) else [out]
            for t_idx, t in enumerate(outs):
                tensors[(lc["name"], node_idx, t_idx)] = t
            progress = True
        if not progress:
            stuck = sorted({lc["name"] for lc, _, _ in remaining})
            raise ValueError(
                "tfpark converter: could not resolve the layer graph "
                f"(unresolvable nodes for layers {stuck}) — cyclic or "
                "truncated model config")
        work = remaining

    inputs = [tensors[r] for r in _norm_spec(cfg["input_layers"])]
    outputs = [tensors[r] for r in _norm_spec(cfg["output_layers"])]
    model = Model(inputs if len(inputs) > 1 else inputs[0],
                  outputs if len(outputs) > 1 else outputs[0])

    pairs = [(tf_model.get_layer(name), nl)
             for name, nl in native_by_name.items()]
    _copy_weights(pairs, model)
    return model


# ----------------------------------------------------------- weight copy
def _copy_weights(pairs, native) -> None:
    """Copy per-layer weights (tf layer, native layer) pairs into the
    native model, translating layout conventions."""
    from analytics_zoo_torch.common.zoo_context import get_zoo_context
    variables = native.init()
    params = variables["params"]
    state = variables["state"]
    for tfl, nl in pairs:
        w = [np.asarray(v) for v in tfl.get_weights()]
        cls = type(tfl).__name__
        tgt = params.get(nl.name, {})
        if cls == "Dense" and w:
            tgt["kernel"] = w[0]
            if len(w) > 1:
                tgt["bias"] = w[1]
        elif cls in ("Conv2D", "Conv1D") and w:
            tgt["kernel"] = w[0]      # HWIO already
            if len(w) > 1:
                tgt["bias"] = w[1]
        elif cls == "BatchNormalization" and w:
            # weight order shrinks when scale/center are off
            c = tfl.get_config()
            i = 0
            if c.get("scale", True):
                tgt["gamma"] = w[i]
                i += 1
            if c.get("center", True):
                tgt["beta"] = w[i]
                i += 1
            state[nl.name]["moving_mean"] = w[i]
            state[nl.name]["moving_var"] = w[i + 1]
        elif cls == "LayerNormalization" and w:
            tgt["gamma"], tgt["beta"] = w[0], w[1]
        elif cls == "Embedding" and w:
            tgt["embeddings"] = w[0]
        elif cls in ("LSTM", "GRU") and w:
            tgt["kernel"], tgt["recurrent_kernel"] = w[0], w[1]
            if len(w) > 2:
                b = w[2]
                tgt["bias"] = b.sum(0) if b.ndim == 2 else b

    dev = get_zoo_context().device

    def conv(t):
        if isinstance(t, dict):
            return {k: conv(v) for k, v in t.items()}
        if torch.is_tensor(t):
            return t
        return torch.from_numpy(np.array(t, dtype=np.float32, copy=True)
                                ).to(dev)
    variables["params"] = conv(params)
    variables["state"] = conv(state)
    native.set_variables(variables)
