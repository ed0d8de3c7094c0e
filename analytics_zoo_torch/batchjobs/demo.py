"""Canned builders for batch jobs — the demo/CI/test fixtures (port of
the JAX package's ``batchjobs/demo.py``; the demo data, the numpy
``LinearModel`` and so the demo job's output are the same bytes).

Builder refs in a :class:`~analytics_zoo_torch.batchjobs.spec.BatchJobSpec`
name functions by ``module:attr``; these are the stock ones.  All are
deterministic by construction (fixed seeds, no wall-clock input) —
the property the exactly-once protocol's bit-identical guarantee is
stated against.

The CLI's ``demo`` runs ``demo_job`` end to end; the kill-and-resume
drill runs the same builders with a chaos plan armed.
"""

from __future__ import annotations

import numpy as np

from .spec import BatchJobSpec


def demo_data(num_rows: int = 1024, dim: int = 8,
              seed: int = 7) -> np.ndarray:
    return np.asarray(
        np.random.RandomState(seed).randn(num_rows, dim),
        dtype=np.float32)


def demo_source(num_rows: int = 1024, dim: int = 8, seed: int = 7):
    """ArraySource over a fixed random matrix."""
    from analytics_zoo_torch.data.source import ArraySource
    return ArraySource(demo_data(num_rows, dim, seed))


class LinearModel:
    """Deterministic numpy predictor: ``y = relu(x @ W + b)``.

    The fast stand-in for tests and the CI demo job — per-batch
    ``delay_s`` stretches shard wall time so chaos drills can land a
    kill mid-shard reliably."""

    def __init__(self, w: np.ndarray, b: np.ndarray,
                 delay_s: float = 0.0):
        self.w = w
        self.b = b
        self.delay_s = float(delay_s)

    def predict(self, x, batch_size=None):
        if self.delay_s > 0:
            import time
            time.sleep(self.delay_s)
        x = np.asarray(x, dtype=np.float32)
        return np.maximum(x @ self.w + self.b, 0.0)


def demo_model(dim: int = 8, out_dim: int = 4, seed: int = 7,
               delay_s: float = 0.0) -> LinearModel:
    rng = np.random.RandomState(seed + 1)
    return LinearModel(
        np.asarray(rng.randn(dim, out_dim), dtype=np.float32),
        np.asarray(rng.randn(out_dim), dtype=np.float32),
        delay_s=delay_s)


def demo_keras_model(dim: int = 8, out_dim: int = 4, device=None):
    """The device path: a ``Sequential`` of one ``Dense`` behind
    ``InferenceModel``, on ``device`` (default: the zoo context's, the
    card).  Its ``warm()`` captures the predict program and, in a fleet
    worker, builds the kernel libraries through the compile farm.  The
    weights are drawn from a generator seeded ``seed`` (and the layer
    named, as the reference names it), so every incarnation in every
    process builds the same weights bit for bit."""
    import torch

    from analytics_zoo_torch.common.zoo_context import init_zoo_context
    from analytics_zoo_torch.pipeline.api.keras import Sequential
    from analytics_zoo_torch.pipeline.api.keras.layers import Dense
    from analytics_zoo_torch.pipeline.inference import InferenceModel
    if device is not None:
        init_zoo_context(device=device)
    model = Sequential()
    model.add(Dense(out_dim, input_shape=(dim,), name="demo_dense"))
    model.init(torch.Generator().manual_seed(7))
    model.compile("adam", "mse")
    return InferenceModel().load_zoo(model)


def write_demo_npy(path: str, num_rows: int = 1024, dim: int = 8,
                   seed: int = 7) -> str:
    """Materialize the demo matrix as an ``NpyDirSource`` directory
    (the zero-copy memory-mapped input path)."""
    import os
    os.makedirs(path, exist_ok=True)
    x = demo_data(num_rows, dim, seed)
    np.save(os.path.join(path, "x.npy"), x)
    return path


def demo_job(output_dir: str, *, num_rows: int = 1024, dim: int = 8,
             rows_per_shard: int = 128, batch_size: int = 32,
             seed: int = 7, delay_s: float = 0.0,
             lease_timeout_s: float = 5.0,
             keras: bool = False, device=None) -> BatchJobSpec:
    """The demo job; ``keras`` scores through ``demo_keras_model`` on
    ``device`` (given, it rides the model's builder args)."""
    model_ref = ("analytics_zoo_torch.batchjobs.demo:demo_keras_model"
                 if keras else
                 "analytics_zoo_torch.batchjobs.demo:demo_model")
    model_args = ({"dim": dim} if keras
                  else {"dim": dim, "seed": seed, "delay_s": delay_s})
    if keras and device is not None:
        model_args["device"] = str(device)
    return BatchJobSpec(
        name="demo-batch-scoring",
        source={"kind": "builder",
                "ref": "analytics_zoo_torch.batchjobs.demo:demo_source",
                "args": {"num_rows": num_rows, "dim": dim,
                         "seed": seed}},
        model={"kind": "builder", "ref": model_ref,
               "args": model_args},
        output_dir=output_dir,
        num_rows=num_rows,
        rows_per_shard=rows_per_shard,
        batch_size=batch_size,
        lease_timeout_s=lease_timeout_s,
        target_deadline_s=60.0,
    )
