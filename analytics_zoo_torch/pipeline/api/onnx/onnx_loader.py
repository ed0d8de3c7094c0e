"""ONNX model importer (port of the JAX package's
``pipeline/api/onnx/onnx_loader.py``).

``load(path)`` parses the model with the in-repo protobuf wire codec (no
``onnx`` dependency) and assembles a native graph :class:`Model` whose
layers execute the ONNX semantics in PyTorch (``mapper.py``); initializer
tensors become trainable params, so the imported model can be fine-tuned
with ``fit`` or served through ``InferenceModel``.  Layer names follow
the reference's ``_GraphContext`` naming, so that the param key paths are
the reference's and ``interop.load_jax_variables`` takes its variables.
"""

from __future__ import annotations

from typing import Dict, List, Union

import numpy as np
import torch

from analytics_zoo_torch.pipeline.api.keras.engine import Input, KTensor
from analytics_zoo_torch.pipeline.api.keras.topology import Model
from analytics_zoo_torch.pipeline.api.onnx.mapper import CONVERTERS, OnnxOp
from analytics_zoo_torch.pipeline.api.onnx.onnx_pb import (
    GraphProto, ModelProto, TensorProto, tensor_to_ndarray)

_INT_DTYPES = {TensorProto.INT32, TensorProto.INT64, TensorProto.UINT8,
               TensorProto.INT8, TensorProto.BOOL}


class _GraphContext:
    """Build-state shared with converters via ``ctx.emit``."""

    def __init__(self, opset: int):
        self.opset = opset
        self._names = {}

    def _unique(self, base: str) -> str:
        n = self._names.get(base, 0)
        self._names[base] = n + 1
        return base if n == 0 else f"{base}_{n}"

    def emit(self, node, fn, graph_ins: List[KTensor],
             weights: Dict[str, np.ndarray], n_outputs: int = 1):
        name = self._unique(node.name or
                            f"{node.op_type.lower()}_{node.output[0]}")
        layer = OnnxOp(fn, weights=weights, n_outputs=n_outputs, name=name)
        out = layer(graph_ins if len(graph_ins) > 1 else graph_ins[0])
        return out if isinstance(out, list) else [out]


def load_graph(graph: GraphProto, opset: int = 11):
    """GraphProto -> (Model, input names, output names)."""
    constants: Dict[str, np.ndarray] = {
        t.name: tensor_to_ndarray(t) for t in graph.initializer}
    tensors: Dict[str, KTensor] = {}
    ctx = _GraphContext(opset)

    input_names = []
    model_inputs = []
    for vi in graph.input:
        if vi.name in constants:
            continue
        dims = vi.shape()
        if not dims:
            raise ValueError(f"graph input {vi.name} has no shape info")
        shape = [None if d is None else int(d) for d in dims]
        if shape[0] is not None:
            # treat dim 0 as batch (reference does the same for NCHW nets)
            shape[0] = None
        elem = (vi.type.tensor_type.elem_type
                if vi.type and vi.type.tensor_type else TensorProto.FLOAT)
        dtype = torch.int32 if elem in _INT_DTYPES else torch.float32
        t = Input(shape=tuple(shape[1:]), dtype=dtype, name=vi.name)
        tensors[vi.name] = t
        input_names.append(vi.name)
        model_inputs.append(t)

    def resolve(name: str):
        if name == "":
            return None
        if name in tensors:
            return tensors[name]
        if name in constants:
            return constants[name]
        raise KeyError(f"tensor {name!r} referenced before definition")

    for node in graph.node:
        conv = CONVERTERS.get(node.op_type)
        if conv is None:
            raise NotImplementedError(
                f"ONNX op {node.op_type!r} is not supported "
                f"({sorted(CONVERTERS)} are)")
        ins = [resolve(n) for n in node.input]
        outs = conv(ctx, node, node.attrs(), ins)
        for out_name, val in zip(node.output, outs):
            if isinstance(val, KTensor):
                tensors[out_name] = val
            else:
                constants[out_name] = np.asarray(val)

    output_names = [vi.name for vi in graph.output]
    outputs = []
    for n in output_names:
        if n in tensors:
            outputs.append(tensors[n])
        else:
            raise ValueError(
                f"graph output {n!r} folded to a constant "
                f"{constants.get(n)}; nothing to execute")
    model = Model(input=model_inputs if len(model_inputs) > 1
                  else model_inputs[0],
                  output=outputs if len(outputs) > 1 else outputs[0],
                  name=graph.name or "onnx_model")
    return model, input_names, output_names


def load_model_proto(model_proto: ModelProto):
    opset = 11
    for op in model_proto.opset_import:
        if op.domain in ("", "ai.onnx"):
            opset = int(op.version)
    model, _, _ = load_graph(model_proto.graph, opset=opset)
    return model


def load(path_or_bytes: Union[str, bytes]):
    """Load an ``.onnx`` file (or serialized ModelProto bytes) into a
    native graph ``Model`` (the analogue of
    ``zoo.pipeline.api.onnx.load``)."""
    if isinstance(path_or_bytes, (bytes, bytearray)):
        data = bytes(path_or_bytes)
    else:
        with open(path_or_bytes, "rb") as f:
            data = f.read()
    return load_model_proto(ModelProto.decode(data))
