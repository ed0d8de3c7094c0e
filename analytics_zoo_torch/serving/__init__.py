"""Cluster Serving (port of the JAX package's ``serving/``): the Redis
stream and HTTP transports, the continuous batcher and the executor over
the port's ``InferenceModel``.  The fleet supervisor, the autoscaler,
``loadgen`` and ``quick_start`` are not ported yet (ROADMAP.md,
queue 1)."""

from analytics_zoo_torch.serving.client import (
    InputQueue, OutputQueue, ServingHttpClient, predict_http)
from analytics_zoo_torch.serving.engine import ServingEngine
from analytics_zoo_torch.serving.server import ClusterServing

__all__ = ["InputQueue", "OutputQueue", "ServingHttpClient",
           "predict_http", "ServingEngine", "ClusterServing"]
