"""Serving engine — the transport / batcher / executor split (port of
the JAX package's ``serving/engine/``).

* **transport** — where requests come from and results go back: the
  Redis-stream bulk path (``ClusterServing`` in ``serving.server``) and
  the stdlib HTTP/JSON fast path (:class:`HttpTransport`).  Both feed
  ONE shared request queue, so an HTTP single rides the same device
  batch as a Redis bulk group.
* **batcher** — :class:`ContinuousBatcher`: the moment the executor
  frees, a batch is formed from whatever is queued and padded to the
  nearest of a small ladder of warmed bucket sizes; ``max_wait_ms``
  bounds how long a lone request may wait for co-riders.
* **executor** — :class:`EndpointRegistry` + :class:`ModelExecutor`:
  endpoint name → ``InferenceModel``, per-endpoint queues with weighted
  scheduling, per-bucket warm-up at model load, top-N postprocess.

The generative layer (``decode.py``: :class:`DecodeSlotPool`,
:class:`GenerativeEndpoint`) schedules sequences one decode iteration at
a time over a device-resident slot pool
(``ServingEngine.register_generative``).

:class:`ServingEngine` composes the layers for embedders.
"""

from analytics_zoo_torch.serving.engine.batcher import (
    ContinuousBatcher, Request)
from analytics_zoo_torch.serving.engine.executor import (
    Endpoint, EndpointRegistry, ModelExecutor, default_buckets)
from analytics_zoo_torch.serving.engine.core import ServingEngine
from analytics_zoo_torch.serving.engine.decode import (
    DecodeSlotPool, GenerativeEndpoint)
from analytics_zoo_torch.serving.engine.transport import HttpTransport

__all__ = [
    "ContinuousBatcher", "Request", "Endpoint", "EndpointRegistry",
    "ModelExecutor", "ServingEngine", "HttpTransport",
    "default_buckets", "DecodeSlotPool", "GenerativeEndpoint",
]
