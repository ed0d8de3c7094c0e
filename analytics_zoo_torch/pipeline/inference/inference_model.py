"""InferenceModel — concurrency-bounded inference facade (port of
``pipeline/inference/inference_model.py``).

One model serves all threads; a semaphore bounds the requests in
flight, as the reference bounds its pool of model copies.  ``load_zoo``
places the weights on the zoo context's device once; ``predict`` splits
the input into batches, pads the last one to the batch shape, and runs
the model's pure ``apply`` in eval mode (BatchNormalization reads its
moving statistics, so a row's answer does not depend on the rows padded
beside it) under ``torch.inference_mode()``, built through
``compile.engine_jit`` (a CUDA graph a batch shape on the card, captured
at the first request of that shape or by ``warm``), recording
the reference's ``inference_predict`` span and its three metrics.
``predict`` and ``warm`` run under ``torch.cuda.device`` of the model's
device: the current CUDA device is per host thread, and serving calls
them from its batcher thread.

Two int8 paths, as in the reference: ``quantize=True`` is weight-only
(every float32 leaf of rank ≥ 2 and ≥ 1024 elements stored int8 on the
device with per-last-axis scales, dequantized inside each predict call;
no float32 copy is kept); ``quantize="calibrated"`` records per-layer
input ranges over ``calib_set`` and runs the Dense/conv products
int8 x int8 -> int32 (``ops/quant.py``).  Both label the span and the
metrics ``backend="int8"``.

``load_torch`` serves a ``torch.nn.Module`` as a ``TorchNet`` in a
``Sequential`` through ``load_zoo`` (captured like any model);
``load_tf`` serves a TensorFlow SavedModel or tf.keras model through
``TFNet``'s host round trip, which a CUDA graph cannot capture: its
predict runs eagerly and says so in ``compile.engine.CAPTURE_LOG``.
"""

from __future__ import annotations

import contextlib
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Optional

import numpy as np
import torch

from analytics_zoo_torch.ops.quant import (
    quantize_weight, weight_scale,
)
from analytics_zoo_torch.pipeline.api.keras.topology import (
    to_device, tree_leaves, tree_map, tree_replace,
)


def quantize_params(params, min_size: int = 1024):
    """Per-tensor int8 weight quantization with per-last-axis scales.

    Returns (quantized tree, scales): each float32 leaf of rank ≥ 2 and at
    least ``min_size`` elements becomes int8 on its device, its keepdims
    float32 scale in the flat ``scales`` list (in ``tree_leaves`` order);
    every other leaf is kept as it is, with None in the list.  The scales
    are computed in numpy on the host, as the reference computes them."""
    def q(leaf):
        if leaf.dtype != torch.float32 or leaf.numel() < min_size or \
                leaf.ndim < 2:
            return leaf, None
        arr = leaf.detach().cpu().numpy()
        scale = weight_scale(arr)
        return (torch.from_numpy(quantize_weight(arr, scale)).to(leaf.device),
                torch.from_numpy(scale).to(leaf.device))

    out = [q(leaf) for leaf in tree_leaves(params)]
    return (tree_replace(params, [o[0] for o in out]),
            [o[1] for o in out])


def dequantize_params(qparams, scales):
    """``scales`` is the flat list from ``quantize_params``: each int8
    leaf times its scale, one multiply a leaf (int8 promotes to float32
    exactly)."""
    leaves = tree_leaves(qparams)
    return tree_replace(qparams, [l if s is None else torch.mul(l, s)
                                  for l, s in zip(leaves, scales)])


def calibrate_activations(model, calib_data, batch_size: int = 32,
                          max_batches: int = 8) -> Dict[str, float]:
    """``ops.quant.calibrate_model`` under the reference's older name."""
    from analytics_zoo_torch.ops.quant import calibrate_model
    return calibrate_model(model, calib_data, batch_size=batch_size,
                           max_batches=max_batches)


def quantize_params_calibrated(model, variables, act_ranges,
                               min_size: int = 1024):
    """``ops.quant.quantize_model`` under the reference's older name and
    signature (``model`` is not read)."""
    del model
    from analytics_zoo_torch.ops.quant import quantize_model
    return quantize_model(variables, act_ranges, min_size=min_size)


class InferenceModel:
    """Concurrency-bounded predictor over a loaded model."""

    def __init__(self, supported_concurrent_num: int = 1):
        from analytics_zoo_torch.observability import get_registry
        self.concurrency = int(supported_concurrent_num)
        self._sem = threading.Semaphore(self.concurrency)
        self._predict_fn = None
        self._variables = None
        self._scales = None
        self._quantized = False
        self._warmed = set()
        self.model = None
        self.device = None
        # metric handles resolved once — predict is the serving hot path
        reg = get_registry()
        self._m_latency = reg.histogram(
            "inference_predict_latency_seconds",
            "wall time per InferenceModel.predict call",
            labels=("backend",))
        self._m_calls = reg.counter(
            "inference_predict_total", "InferenceModel.predict calls",
            labels=("backend",))
        self._m_records = reg.counter(
            "inference_records_total",
            "records predicted by InferenceModel", labels=("backend",))

    # ------------------------------------------------------------- loaders
    def load_zoo(self, model, quantize=False, calib_set=None,
                 calib_batch_size: int = 32, calib_batches: int = 8,
                 quant_min_size: int = 1024) -> "InferenceModel":
        """Load a native model (KerasNet/ZooModel).

        ``quantize=True``: the int8 weight-only path, dequantized inside
        each predict call (4x less weight memory on the device).
        ``quantize="calibrated"`` with ``calib_set`` (an array, a list of
        arrays or a FeatureSet of representative inputs): per-layer input
        ranges recorded over ``calib_batches`` batches of
        ``calib_batch_size``, then the Dense/conv kernels of at least
        ``quant_min_size`` elements run int8 x int8 -> int32 with a
        float32 rescale.

        The weights are snapshotted onto the device at load time; later
        ``set_weights`` calls are not seen until ``load_zoo`` runs again.
        """
        from analytics_zoo_torch.common.zoo_context import get_zoo_context
        from analytics_zoo_torch.models.common import ZooModel
        if isinstance(model, ZooModel):
            model = model.model
        device = get_zoo_context().device
        scales_of = None
        variables = model.get_variables()
        if quantize == "calibrated":
            if calib_set is None:
                raise ValueError(
                    "quantize='calibrated' needs calib_set= (an array, a "
                    "list of arrays or a FeatureSet of representative "
                    "inputs)")
            ranges = calibrate_activations(
                model, calib_set, batch_size=calib_batch_size,
                max_batches=calib_batches)
            variables = quantize_params_calibrated(
                model, variables, ranges, min_size=quant_min_size)
        elif quantize:
            qp, scales = quantize_params(variables["params"])
            variables = {"params": qp, "state": variables["state"]}
            scales_of = [None if s is None else s.to(device)
                         for s in scales]

        def fn(params, state, x):
            if scales_of is not None:
                params = dequantize_params(params, scales_of)
            out, _ = model.apply(params, x, state=state, training=False)
            return out

        # the weights are read, never written: the graphs read the loaded
        # tensors themselves (borrowed positions), one copy for all buckets
        from analytics_zoo_torch.compile import engine_jit
        return self._serve(model, device, variables,
                           engine_jit(fn, borrow_argnums=(0, 1),
                                      key_hint="inference_predict"),
                           scales=scales_of, quantized=bool(quantize))

    def _serve(self, model, device, variables, predict_fn, scales=None,
               quantized: bool = False) -> "InferenceModel":
        """What every loader sets for ``predict``: the model, its device,
        its variables placed there, the predict program, the int8 scales,
        and no warmed batch shape."""
        self.model = model
        self.device = device
        self._warmed = set()
        self._scales = scales
        self._quantized = quantized
        self._variables = to_device(variables, device)
        self._predict_fn = predict_fn
        return self

    def load_zoo_file(self, model, path: str,
                      quantize=False) -> "InferenceModel":
        """Weights from a saved checkpoint (either package's
        ``save_model``) into a built architecture, then ``load_zoo``; a
        missing or mismatched file raises."""
        model.load_weights(path)
        return self.load_zoo(model, quantize=quantize)

    def load_torch(self, torch_module, input_shape,
                   quantize: bool = False) -> "InferenceModel":
        """A ``torch.nn.Module`` served as a ``TorchNet`` (its fx graph
        emitted on its own params; ref InferenceModel.doLoadPyTorch)."""
        from analytics_zoo_torch.pipeline.api.keras import Sequential
        from analytics_zoo_torch.pipeline.api.net import TorchNet
        m = Sequential()
        m.add(TorchNet.from_pytorch(torch_module,
                                    input_shape=input_shape))
        m.init()
        return self.load_zoo(m, quantize=quantize)

    def load_tf(self, source, **kwargs) -> "InferenceModel":
        """SavedModel dir path or tf.keras model (ref
        InferenceModel.doLoadTF).  Each predict is a host round trip into
        TensorFlow: eager, never captured."""
        from analytics_zoo_torch.common.zoo_context import get_zoo_context
        from analytics_zoo_torch.compile.engine import log_eager
        from analytics_zoo_torch.pipeline.api.net import TFNet
        if isinstance(source, str):
            net = TFNet.from_saved_model(source, **kwargs)
        else:
            net = TFNet.from_keras(source, **kwargs)
        log_eager("inference_tf_predict",
                  "a host round trip into TensorFlow (TFNet) is not "
                  "captured into a CUDA graph")
        return self._serve(net, get_zoo_context().device,
                           {"params": {}, "state": {}},
                           lambda p, s, x: net.tf_fn(x))

    # -------------------------------------------------------------- predict
    def _to_device(self, a) -> torch.Tensor:
        return torch.as_tensor(np.ascontiguousarray(a)).to(self.device)

    def _on_device(self):
        """Make the model's card the calling thread's current CUDA
        device (the kernels launch on the current device's stream)."""
        if self.device is not None and self.device.type == "cuda":
            return torch.cuda.device(self.device)
        return contextlib.nullcontext()

    def _forward(self, xb) -> torch.Tensor:
        return self._predict_fn(self._variables["params"],
                                self._variables["state"],
                                tree_map(self._to_device, xb))

    def warm(self, input_shape, batch_size: int,
             dtype=np.float32) -> bool:
        """Warm-start the batch shape ``(batch_size,) + input_shape``
        before the first request arrives, so a serving replica pays its
        cold start at spawn instead of inside a client's request.

        On the card this (1) builds the kernels a forward pass launches
        and (2) captures the predict program for that bucket into a CUDA
        graph (``compile.engine_jit``), as the reference compiles its XLA
        program ahead of time: nothing is executed on the weights, no
        metric is recorded and no record counted, and later requests of
        that shape replay the graph.  On the CPU, with
        ``compile.aot=false``, or where the capture fails, it runs one
        forward on a zero batch of that shape instead, its output
        discarded.  The work runs on a thread of its own that ends before
        this returns: CUDA's libraries set up state per host thread (a
        first predict on a new thread paid ~100 ms on an H100) and hand it
        on when the thread ends, so the serving batcher's thread inherits
        it.  Returns True when it succeeded; a shape already warmed
        returns True at once.  A failed build raises
        (``ClusterServing.warm_start`` logs it per bucket, and the first
        predict raises it again)."""
        if self._predict_fn is None:
            raise RuntimeError("no model loaded")
        key = ((int(batch_size),) + tuple(int(d) for d in input_shape),
               np.dtype(dtype).str)
        if key in self._warmed:
            return True
        with self._sem:
            if self.device.type == "cuda":
                from analytics_zoo_torch.ops import kernels
                kernels.build_all(list(kernels.FORWARD_KERNELS))
            with ThreadPoolExecutor(1, thread_name_prefix="zoo-warm") as ex:
                ex.submit(self._warm_forward,
                          np.zeros(key[0], np.dtype(dtype))).result()
        self._warmed.add(key)
        return True

    def _warm_forward(self, x) -> None:
        with self._on_device(), torch.inference_mode():
            args = (self._variables["params"], self._variables["state"],
                    tree_map(self._to_device, x))
            capture = getattr(self._predict_fn, "warm", None)
            if capture is None or not capture(*args):
                self._predict_fn(*args)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)

    @property
    def aot_signatures(self) -> int:
        """Buckets whose predict replays a captured graph."""
        return int(getattr(self._predict_fn, "aot_signatures", 0))

    def predict(self, x, batch_size: Optional[int] = None) -> np.ndarray:
        """Thread-safe batched prediction; ``x`` is an array or a list of
        arrays (one per model input) with the batch in dim 0."""
        if self._predict_fn is None:
            raise RuntimeError("no model loaded")
        from analytics_zoo_torch.observability import get_tracer
        from analytics_zoo_torch.pipeline.estimator.estimator import (
            predict_in_batches)
        backend = "int8" if self._quantized else "f32"
        t0 = time.perf_counter()
        with self._sem, get_tracer().span("inference_predict",
                                          backend=backend), \
                self._on_device(), torch.inference_mode():
            n = len(tree_leaves(x)[0])
            result = predict_in_batches(self._forward, x, batch_size or n)
        self._m_latency.labels(backend).observe(time.perf_counter() - t0)
        self._m_calls.labels(backend).inc()
        self._m_records.labels(backend).inc(n)
        return result

    @property
    def is_quantized(self) -> bool:
        return self._quantized
