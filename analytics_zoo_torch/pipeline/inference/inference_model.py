"""InferenceModel — concurrency-bounded inference facade (port of
``pipeline/inference/inference_model.py``).

One model serves all threads; a semaphore bounds the requests in
flight, as the reference bounds its pool of model copies.  ``load_zoo``
places the weights on the zoo context's device once; ``predict`` splits
the input into batches, pads the last one to the batch shape, and runs
the model's pure ``apply`` under ``torch.inference_mode()``.

The int8 path (``quantize=``), ``load_torch`` and ``load_tf`` are not
ported yet and raise.
"""

from __future__ import annotations

import threading
from typing import Optional

import numpy as np
import torch

from analytics_zoo_torch.pipeline.api.keras.topology import (
    to_device, tree_leaves, tree_map,
)


def _not_ported(what: str):
    return NotImplementedError(
        f"InferenceModel.{what} is not ported to the PyTorch package yet "
        "(ROADMAP.md, port queue); use the f32 load_zoo path")


class InferenceModel:
    """Concurrency-bounded predictor over a loaded model."""

    def __init__(self, supported_concurrent_num: int = 1):
        self.concurrency = int(supported_concurrent_num)
        self._sem = threading.Semaphore(self.concurrency)
        self._predict_fn = None
        self._variables = None
        self.model = None
        self.device = None

    # ------------------------------------------------------------- loaders
    def load_zoo(self, model, quantize: bool = False,
                 **calibration) -> "InferenceModel":
        """Load a native model (KerasNet/ZooModel), f32 weights.

        The weights are snapshotted onto the device at load time; later
        ``set_weights`` calls are not seen until ``load_zoo`` runs again.
        """
        if quantize or calibration:
            raise _not_ported("load_zoo(quantize=...)")
        from analytics_zoo_torch.common.zoo_context import get_zoo_context
        from analytics_zoo_torch.models.common import ZooModel
        if isinstance(model, ZooModel):
            model = model.model
        self.model = model
        self.device = get_zoo_context().device
        self._variables = to_device(model.get_variables(), self.device)

        def fn(params, state, x):
            out, _ = model.apply(params, x, state=state, training=False)
            return out

        self._predict_fn = fn
        return self

    def load_torch(self, *args, **kwargs):
        raise _not_ported("load_torch")

    def load_tf(self, *args, **kwargs):
        raise _not_ported("load_tf")

    # -------------------------------------------------------------- predict
    def _to_device(self, a) -> torch.Tensor:
        return torch.as_tensor(np.ascontiguousarray(a)).to(self.device)

    def predict(self, x, batch_size: Optional[int] = None) -> np.ndarray:
        """Thread-safe batched prediction; ``x`` is an array or a list of
        arrays (one per model input) with the batch in dim 0."""
        if self._predict_fn is None:
            raise RuntimeError("no model loaded")
        from analytics_zoo_torch.pipeline.estimator.estimator import (
            predict_in_batches)
        with self._sem, torch.inference_mode():
            n = len(tree_leaves(x)[0])
            return predict_in_batches(
                lambda xb: self._predict_fn(
                    self._variables["params"], self._variables["state"],
                    tree_map(self._to_device, xb)),
                x, batch_size or n)
