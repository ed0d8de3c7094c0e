"""``Net`` — unified model-loading facade (port of the JAX package's
``pipeline/api/net/net.py``).

One entry point that dispatches to the framework's importers and returns
a native, trainable model: the zoo format (``load``/``load_bigdl``),
ONNX, TensorFlow and PyTorch.  Caffe waits for its importer
(``load_caffe`` raises).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence


class Net:
    """Static loaders mirroring the reference's ``Net`` object."""

    @staticmethod
    def load(path: str, into):
        """Restore weights saved with ``model.save_model`` into ``into``
        (a freshly built model of the same architecture) and return it."""
        return into.load_weights(path)

    # the reference aliases loadBigDL to the engine-native format; here
    # the engine-native format IS the zoo format
    load_bigdl = load

    @staticmethod
    def load_caffe(def_path: str, model_path: Optional[str] = None,
                   input_shapes: Optional[Dict[str, Sequence[int]]] = None,
                   outputs: Optional[Sequence[str]] = None):
        """Caffe prototxt+caffemodel → graph Model: not ported yet."""
        raise NotImplementedError(
            "Net.load_caffe: the Caffe importer (models/caffe) is not ported "
            "to the PyTorch package yet (ROADMAP.md, port queue 1 item 7)")

    @staticmethod
    def load_onnx(path: str):
        """ONNX file (or serialized ModelProto bytes) → graph Model."""
        from analytics_zoo_torch.pipeline.api.onnx import load as _load
        return _load(path)

    @staticmethod
    def load_tf(path: str, **kwargs):
        """TF SavedModel dir → TFNet layer."""
        from analytics_zoo_torch.pipeline.api.net.tf_net import TFNet
        return TFNet.from_saved_model(path, **kwargs)

    @staticmethod
    def load_torch(module_or_path, example_input=None):
        """torch.nn.Module (or TorchScript file) → TorchNet layer."""
        from analytics_zoo_torch.pipeline.api.net.torch_net import TorchNet
        if isinstance(module_or_path, str):
            import torch
            module = torch.jit.load(module_or_path)
        else:
            module = module_or_path
        return TorchNet.from_pytorch(module, example_input)
