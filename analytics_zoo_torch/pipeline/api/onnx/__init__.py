"""ONNX import (port of the JAX package's ``pipeline/api/onnx``)."""

from analytics_zoo_torch.pipeline.api.onnx.onnx_loader import (  # noqa: F401
    load, load_graph, load_model_proto)
from analytics_zoo_torch.pipeline.api.onnx.mapper import (  # noqa: F401
    CONVERTERS, OnnxOp)
