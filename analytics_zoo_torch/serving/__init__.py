"""Cluster Serving (port of the JAX package's ``serving/``): the Redis
stream and HTTP transports, the continuous batcher and the executor over
the port's ``InferenceModel``; the replica fleet's supervisor and
autoscaler (``supervisor.py``), the open-loop load generator with its
scenarios and verdict (``loadgen/``) and the quick-start demo."""

from analytics_zoo_torch.serving.client import (
    InputQueue, OutputQueue, ServingHttpClient, predict_http)
from analytics_zoo_torch.serving.engine import ServingEngine
from analytics_zoo_torch.serving.server import ClusterServing
from analytics_zoo_torch.serving.supervisor import (
    ServingSupervisor, cli_worker_factory)

__all__ = ["InputQueue", "OutputQueue", "ServingHttpClient",
           "predict_http", "ServingEngine", "ClusterServing",
           "ServingSupervisor", "cli_worker_factory"]
