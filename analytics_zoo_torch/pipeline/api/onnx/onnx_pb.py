"""ONNX protobuf schema (subset) over the generic wire codec (port of the
JAX package's ``pipeline/api/onnx/onnx_pb.py``, the same code: numpy and
``utils/pbwire`` only, so that a message encodes to the same bytes in both
packages).

Field numbers follow the public ``onnx.proto3`` schema; only the
messages/fields the loader needs are declared (unknown fields in real
model files are skipped harmlessly by the codec).
"""

from __future__ import annotations

from typing import List

import numpy as np

from analytics_zoo_torch.utils.pbwire import Field, Message


class TensorProto(Message):
    # onnx.TensorProto.DataType
    FLOAT = 1
    UINT8 = 2
    INT8 = 3
    UINT16 = 4
    INT16 = 5
    INT32 = 6
    INT64 = 7
    STRING = 8
    BOOL = 9
    FLOAT16 = 10
    DOUBLE = 11
    UINT32 = 12
    UINT64 = 13

    FIELDS = [
        Field(1, "dims", "int64", repeated=True),
        Field(2, "data_type", "enum"),
        Field(4, "float_data", "float", repeated=True),
        Field(5, "int32_data", "int64", repeated=True),
        Field(6, "string_data", "bytes", repeated=True),
        Field(7, "int64_data", "int64", repeated=True),
        Field(8, "name", "string"),
        Field(9, "raw_data", "bytes"),
        Field(10, "double_data", "double", repeated=True),
        Field(11, "uint64_data", "uint64", repeated=True),
    ]


_NP_BY_DTYPE = {
    TensorProto.FLOAT: np.float32,
    TensorProto.UINT8: np.uint8,
    TensorProto.INT8: np.int8,
    TensorProto.UINT16: np.uint16,
    TensorProto.INT16: np.int16,
    TensorProto.INT32: np.int32,
    TensorProto.INT64: np.int64,
    TensorProto.BOOL: np.bool_,
    TensorProto.FLOAT16: np.float16,
    TensorProto.DOUBLE: np.float64,
    TensorProto.UINT32: np.uint32,
    TensorProto.UINT64: np.uint64,
}


def tensor_to_ndarray(t: TensorProto) -> np.ndarray:
    """Materialise a TensorProto initializer as a numpy array."""
    shape = tuple(int(d) for d in t.dims)
    np_dtype = _NP_BY_DTYPE.get(t.data_type)
    if np_dtype is None:
        raise ValueError(f"unsupported ONNX tensor dtype {t.data_type}")
    if t.raw_data:
        arr = np.frombuffer(t.raw_data, dtype=np_dtype)
    elif t.data_type == TensorProto.FLOAT16 and t.int32_data:
        # fp16 payloads without raw_data are uint16 bit patterns stored
        # in int32_data — reinterpret, don't value-cast
        arr = np.asarray(t.int32_data, dtype=np.uint16).view(np.float16)
    elif t.float_data:
        arr = np.asarray(t.float_data, dtype=np.float32).astype(np_dtype)
    elif t.int64_data:
        arr = np.asarray(t.int64_data, dtype=np.int64).astype(np_dtype)
    elif t.int32_data:
        arr = np.asarray(t.int32_data, dtype=np.int64).astype(np_dtype)
    elif t.double_data:
        arr = np.asarray(t.double_data, dtype=np.float64).astype(np_dtype)
    elif t.uint64_data:
        arr = np.asarray(t.uint64_data, dtype=np.uint64).astype(np_dtype)
    else:
        arr = np.zeros(int(np.prod(shape)) if shape else 0, dtype=np_dtype)
    return arr.reshape(shape)


def ndarray_to_tensor(arr: np.ndarray, name: str = "") -> TensorProto:
    """Build a TensorProto (raw_data encoding) from a numpy array."""
    arr = np.asarray(arr)
    inv = {v: k for k, v in _NP_BY_DTYPE.items()}
    dt = inv.get(arr.dtype.type)
    if dt is None:
        raise ValueError(f"unsupported numpy dtype {arr.dtype}")
    return TensorProto(dims=list(arr.shape), data_type=dt, name=name,
                       raw_data=arr.tobytes())


class AttributeProto(Message):
    UNDEFINED = 0
    FLOAT = 1
    INT = 2
    STRING = 3
    TENSOR = 4
    GRAPH = 5
    FLOATS = 6
    INTS = 7
    STRINGS = 8
    TENSORS = 9
    GRAPHS = 10

    FIELDS = [
        Field(1, "name", "string"),
        Field(2, "f", "float"),
        Field(3, "i", "int64"),
        Field(4, "s", "bytes"),
        Field(5, "t", "msg", msg_cls=TensorProto),
        Field(7, "floats", "float", repeated=True),
        Field(8, "ints", "int64", repeated=True),
        Field(9, "strings", "bytes", repeated=True),
        Field(10, "tensors", "msg", repeated=True, msg_cls=TensorProto),
        Field(20, "type", "enum"),
    ]

    def value(self):
        """Return the attribute's payload based on its declared type; if
        the type field is missing (some writers omit it), infer from
        whichever payload is set."""
        ty = self.type
        if ty == self.FLOAT or (not ty and self.f):
            return float(self.f)
        if ty == self.INT or (not ty and self.i):
            return int(self.i)
        if ty == self.STRING or (not ty and self.s):
            return self.s.decode("utf-8", "replace")
        if ty == self.TENSOR or (not ty and self.t is not None):
            return tensor_to_ndarray(self.t)
        if ty == self.FLOATS or (not ty and self.floats):
            return [float(v) for v in self.floats]
        if ty == self.INTS or (not ty and self.ints):
            return [int(v) for v in self.ints]
        if ty == self.STRINGS or (not ty and self.strings):
            return [v.decode("utf-8", "replace") for v in self.strings]
        if ty == self.TENSORS:
            return [tensor_to_ndarray(t) for t in self.tensors]
        return None


class NodeProto(Message):
    FIELDS = [
        Field(1, "input", "string", repeated=True),
        Field(2, "output", "string", repeated=True),
        Field(3, "name", "string"),
        Field(4, "op_type", "string"),
        Field(5, "attribute", "msg", repeated=True, msg_cls=AttributeProto),
        Field(7, "domain", "string"),
    ]

    def attrs(self) -> dict:
        return {a.name: a.value() for a in self.attribute}


class TensorShapeDim(Message):
    FIELDS = [
        Field(1, "dim_value", "int64"),
        Field(2, "dim_param", "string"),
    ]


class TensorShapeProto(Message):
    FIELDS = [Field(1, "dim", "msg", repeated=True, msg_cls=TensorShapeDim)]


class TypeProtoTensor(Message):
    FIELDS = [
        Field(1, "elem_type", "enum"),
        Field(2, "shape", "msg", msg_cls=TensorShapeProto),
    ]


class TypeProto(Message):
    FIELDS = [Field(1, "tensor_type", "msg", msg_cls=TypeProtoTensor)]


class ValueInfoProto(Message):
    FIELDS = [
        Field(1, "name", "string"),
        Field(2, "type", "msg", msg_cls=TypeProto),
    ]

    def shape(self) -> List:
        """Dims as a list; unknown/symbolic dims -> None."""
        tt = self.type.tensor_type if self.type else None
        if tt is None or tt.shape is None:
            return []
        out = []
        for d in tt.shape.dim:
            out.append(int(d.dim_value) if d.dim_value else None)
        return out


class GraphProto(Message):
    FIELDS = [
        Field(1, "node", "msg", repeated=True, msg_cls=NodeProto),
        Field(2, "name", "string"),
        Field(5, "initializer", "msg", repeated=True, msg_cls=TensorProto),
        Field(11, "input", "msg", repeated=True, msg_cls=ValueInfoProto),
        Field(12, "output", "msg", repeated=True, msg_cls=ValueInfoProto),
        Field(13, "value_info", "msg", repeated=True, msg_cls=ValueInfoProto),
    ]


class OperatorSetIdProto(Message):
    FIELDS = [
        Field(1, "domain", "string"),
        Field(2, "version", "int64"),
    ]


class ModelProto(Message):
    FIELDS = [
        Field(1, "ir_version", "int64"),
        Field(2, "producer_name", "string"),
        Field(3, "producer_version", "string"),
        Field(4, "domain", "string"),
        Field(5, "model_version", "int64"),
        Field(7, "graph", "msg", msg_cls=GraphProto),
        Field(8, "opset_import", "msg", repeated=True,
              msg_cls=OperatorSetIdProto),
    ]


def make_value_info(name: str, shape, elem_type=TensorProto.FLOAT
                    ) -> ValueInfoProto:
    dims = [TensorShapeDim(dim_value=d) if d else TensorShapeDim(dim_param="N")
            for d in shape]
    return ValueInfoProto(
        name=name,
        type=TypeProto(tensor_type=TypeProtoTensor(
            elem_type=elem_type,
            shape=TensorShapeProto(dim=dims))))
