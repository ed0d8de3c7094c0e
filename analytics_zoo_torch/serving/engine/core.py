"""ServingEngine — the composition root of the three layers.

Transports (the Redis loop in ``serving.server``, the HTTP fast path
in ``engine.transport``, or any embedder) share one engine: they
build :class:`~.batcher.Request` objects, ``submit()`` them as atomic
groups, and wait for completion.  The batcher thread does every
predict, so requests from different transports co-ride the same
bucket-padded device batches.
"""

from __future__ import annotations

import logging
import time
from typing import Dict, List, Optional, Sequence

from analytics_zoo_torch.serving.engine.batcher import (
    ContinuousBatcher, Request)
from analytics_zoo_torch.serving.engine.executor import (
    EndpointRegistry, ModelExecutor)

log = logging.getLogger("analytics_zoo_torch.serving.engine")

#: the endpoint a record with no ``endpoint`` field routes to — and
#: the name a single-model ``ClusterServing`` registers its model as
DEFAULT_ENDPOINT = "default"


class ServingEngine:
    """Endpoint registry + executor + continuous batcher, one handle."""

    def __init__(self, *, max_wait_ms: float = 0.0,
                 default_timeout_s: float = 60.0):
        self.registry = EndpointRegistry()
        self.executor = ModelExecutor()
        self.batcher = ContinuousBatcher(
            self.registry, self.executor, max_wait_ms=max_wait_ms)
        #: upper bound a transport waits on a submitted request before
        #: declaring it failed (guards client threads against a dead
        #: batcher — generous: a cold compile may hide behind it)
        self.default_timeout_s = float(default_timeout_s)

    # ------------------------------------------------------------ endpoints
    def register(self, name: str, model, **kwargs):
        """Register a model under an endpoint name (see
        :class:`~.executor.Endpoint` for kwargs: top_n, buckets,
        batch_size, input_shape, weight)."""
        return self.registry.register(name, model, **kwargs)

    def register_generative(self, name: str, model, *, enc_len: int,
                            start_sign: int,
                            stop_sign: Optional[int] = None,
                            max_seq_len: int = 32, slots: int = 4,
                            buckets=(), weight: int = 1,
                            request_deadline_ms: float = 0.0):
        """Register a *generative* model (the ``Seq2seq`` decode
        contract: ``decode_params``/``prefill``/``decode_step``/
        ``initial_carries``) under an endpoint name.  Requests to it
        are SEQUENCES — admitted into a device-resident slot pool and
        decoded one iteration at a time, with EOS early-exit and
        same-iteration backfill (see ``engine.decode``).  ``slots``
        sizes the pool (the generative analog of ``batch_size``);
        ``request_deadline_ms`` > 0 sheds sequences still queued past
        the deadline before they burn a slot (the stateless path's
        admission-control contract, applied at the slot-pool gate)."""
        from analytics_zoo_torch.serving.engine.decode import (
            GenerativeEndpoint)
        return self.registry.add(GenerativeEndpoint(
            name, model, enc_len=enc_len, start_sign=start_sign,
            stop_sign=stop_sign, max_seq_len=max_seq_len, slots=slots,
            buckets=buckets, weight=weight,
            request_deadline_ms=request_deadline_ms))

    def endpoints(self) -> List[str]:
        return self.registry.names()

    def warm_start(self) -> Dict[str, int]:
        """Warm every endpoint's full bucket ladder."""
        return self.registry.warm_all()

    # ------------------------------------------------------------ lifecycle
    def start(self) -> "ServingEngine":
        self.batcher.start()
        return self

    def stop(self) -> None:
        self.batcher.stop()

    @property
    def alive(self) -> bool:
        return self.batcher.alive

    # -------------------------------------------------------------- serving
    def submit(self, requests: Sequence[Request]) -> List[Request]:
        """Enqueue one atomic group (auto-starts the batcher — a
        stopped engine must fail loud-and-finished, not hang its
        transports)."""
        if not self.batcher.alive:
            self.start()
        return self.batcher.submit(requests)

    def wait_all(self, requests: Sequence[Request],
                 timeout_s: Optional[float] = None) -> List[Request]:
        """Block until every request completes under ONE deadline;
        stragglers are failed with :class:`TimeoutError` (they are
        also dropped by the batcher at compose time, so a timed-out
        request never burns a device predict later).  Shared by
        ``submit_wait`` and the Redis transport."""
        if timeout_s is None:
            timeout_s = self.default_timeout_s
        requests = list(requests)
        deadline = time.monotonic() + timeout_s
        for r in requests:
            if not r.wait(max(deadline - time.monotonic(), 0.0)) \
                    and not r.done:
                r.fail(TimeoutError(
                    f"serving engine gave no result within "
                    f"{timeout_s:.1f}s (endpoint {r.endpoint!r})"))
        return requests

    def submit_wait(self, requests: Sequence[Request],
                    timeout_s: Optional[float] = None
                    ) -> List[Request]:
        """Submit a group and block until every request completes (or
        the deadline passes — see :meth:`wait_all`)."""
        return self.wait_all(self.submit(requests),
                             timeout_s=timeout_s)

    def predict(self, endpoint: str, data, *,
                uri: str = "", request_id: Optional[str] = None,
                timeout_s: Optional[float] = None):
        """One-record convenience (the HTTP fast path's core): returns
        the top-N result or raises the request's error."""
        req = Request(endpoint=endpoint, uri=uri, data=data,
                      request_id=request_id)
        self.submit_wait([req], timeout_s=timeout_s)
        if req.error is not None:
            raise req.error
        return req.result

    def generate(self, endpoint: str, enc_ids, *,
                 max_tokens: Optional[int] = None,
                 on_token=None, uri: str = "",
                 request_id: Optional[str] = None,
                 timeout_s: Optional[float] = None) -> List[int]:
        """One-sequence convenience against a generative endpoint:
        returns the emitted token list (EOS included when emitted).
        ``on_token(index, token)`` streams each token as the decode
        scheduler emits it."""
        req = Request(endpoint=endpoint, uri=uri, data=enc_ids,
                      request_id=request_id, max_tokens=max_tokens,
                      on_token=on_token)
        self.submit_wait([req], timeout_s=timeout_s)
        if req.error is not None:
            raise req.error
        return req.result
