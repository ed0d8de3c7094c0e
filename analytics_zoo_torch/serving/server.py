"""Cluster Serving engine.

Reference: zoo/serving/ClusterServing.scala:33-342 — a streaming loop:
Redis stream ``image_stream`` → base64 JPEG decode → batched
InferenceModel predict → top-N postprocess → write to the ``result``
table with backpressure retry; Redis OOM guard via XTRIM (:128-134);
throughput scalars to the inference summary (:294-317).  Config comes
from config.yaml (ClusterServingHelper).

Port of the JAX package's ``serving/server.py`` (serving engine v2):
``ClusterServing`` is the Redis *transport* — it owns the stream read /
shed / decode-pool / ack / reclaim / dead-letter lifecycle — composed
over the ``serving.engine`` batcher/executor layers: decoded records
are submitted as atomic groups to a :class:`~analytics_zoo_torch.
serving.engine.ServingEngine`, whose continuous batcher pads each
in-flight batch to the nearest warmed bucket size and co-batches them
with the HTTP fast path's singles (``params.http_port``).  Multi-model:
every record may carry an ``endpoint`` field routing it to a registered
model (``register_endpoint`` / ``params.endpoints``).  The stream
fields and the result JSON are the JAX package's, byte for byte, so a
client of either package talks to a server of the other.

An ``image`` record (base64 JPEG or PNG) is decoded on the decode pool to
BGR float32, as the reference's OpenCV path does; an undecodable one gets
the per-record error result.  Inside a launcher's or a supervisor's run
dir the replica flushes its registry, trace, request log, TSDB and
recorder into its ``host-<k>/`` slot when its loop ends (the drain), so
the fleet's tools see its final counts.
"""

from __future__ import annotations

import base64
import itertools
import json
import logging
import os
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

import numpy as np

from analytics_zoo_torch.common.config import get_config
from analytics_zoo_torch.common.fsutil import atomic_write_text
from analytics_zoo_torch.data.stages import WorkerPool
from analytics_zoo_torch.observability import flightrec
from analytics_zoo_torch.observability import (
    MetricsServer, TelemetrySampler, get_registry, get_tracer)
from analytics_zoo_torch.observability.reqtrace import (
    TRACE_FIELD, TraceContext, get_request_log)
from analytics_zoo_torch.resilience.chaos import (
    SITE_SERVING_DECODE, SITE_SERVING_PREDICT, active_chaos)
from analytics_zoo_torch.resilience.detector import HostHeartbeat
from analytics_zoo_torch.serving.engine.batcher import (Request,
                                                      ShedError)
from analytics_zoo_torch.serving.engine.core import (
    DEFAULT_ENDPOINT, ServingEngine)
from analytics_zoo_torch.serving.engine.transport import HttpTransport
from analytics_zoo_torch.serving.redis_client import (
    BREAKER_OPEN, CircuitOpenError, _breaker_failure_excs, connect,
    with_breaker)
from analytics_zoo_torch.utils.summary import InferenceSummary

log = logging.getLogger("analytics_zoo_torch.serving")

INPUT_STREAM = "serving_stream"
RESULT_PREFIX = "result:"
STOP_KEY = "zoo-serving-stop"   # cross-process stop signal
                                # (ClusterServingManager.listenTermination)
# results whose write was abandoned after the bounded backoff, shed
# requests, and quarantined poison records: the request_id/uri land
# here with a ``reason`` field (write_abandoned | shed | poison) so an
# operator (or a replaying client) can find every record the fleet
# gave up on — losing a result beats losing the worker loop
DEAD_LETTER_STREAM = "serving_dead_letter"
# delivery-attempt counts for records on the crash-recovery (reclaim)
# path, keyed by request_id (entry id when absent) — the poison-
# quarantine bookkeeping must survive the very worker deaths it counts
POISON_ATTEMPTS_KEY = "serving_poison_attempts"

# the broker-outage class: breaker fast-fails plus the transport
# failures the breaker counts (socket errors, injected serving.redis
# faults) — the run loop idles on these instead of crashing
_BROKER_OUTAGE_EXCS = (CircuitOpenError,) + _breaker_failure_excs()


def decode_field(fields: Dict[str, bytes]):
    """Decode one stream record: 'data' (b64 ndarray .npy bytes) or
    'image' (b64 JPEG) + 'uri' [+ optional 'request_id' for
    cross-process correlation].  Returns ``(uri, array, request_id)``
    (request_id None for records enqueued without one)."""
    uri = fields["uri"].decode() if isinstance(fields["uri"], bytes) \
        else fields["uri"]
    rid = fields.get("request_id")
    if isinstance(rid, bytes):
        rid = rid.decode()
    if "image" in fields:
        from analytics_zoo_torch.feature.image import decode_image_bytes
        raw = base64.b64decode(fields["image"])
        # serving consumes BGR, as the reference's OpenCV path does
        # (ImageProcessing.scala:24); astype copies PIL's reversed view
        # into a contiguous array
        img = decode_image_bytes(raw, to_rgb=False, context=uri)
        return uri, img.astype(np.float32, order="C"), rid
    raw = base64.b64decode(fields["data"])
    import io
    arr = np.load(io.BytesIO(raw), allow_pickle=False)
    return uri, arr, rid


class ServingConfig:
    """config.yaml contract (scripts/cluster-serving/config.yaml)."""

    def __init__(self, redis_url: Optional[str] = None,
                 batch_size: int = 4, top_n: int = 1,
                 max_stream_len: int = 100000,
                 log_dir: Optional[str] = None,
                 consumer_group: Optional[str] = None,
                 consumer_name: str = "worker-0",
                 pipeline_depth: int = 2,
                 metrics_port: Optional[int] = None,
                 metrics_host: Optional[str] = None,
                 healthz_max_queue: Optional[int] = None,
                 healthz_max_error_rate: Optional[float] = None,
                 result_write_retries: Optional[int] = None,
                 request_deadline_ms: Optional[int] = None,
                 reclaim_min_idle_ms: Optional[int] = None,
                 poison_max_attempts: Optional[int] = None,
                 breaker_failures: Optional[int] = None,
                 breaker_cooldown_s: Optional[float] = None,
                 input_shape=None,
                 batch_buckets=None,
                 batch_max_wait_ms: Optional[float] = None,
                 http_port: Optional[int] = None,
                 http_timeout_s: Optional[float] = None,
                 endpoints: Optional[str] = None,
                 extra: Optional[Dict[str, str]] = None):
        self.redis_url = redis_url
        self.batch_size = int(batch_size)
        self.top_n = int(top_n)
        self.max_stream_len = int(max_stream_len)
        self.log_dir = log_dir
        # Prometheus scrape endpoint: None = off, 0 = ephemeral port
        # (tests / multi-worker hosts), N = fixed port.  The endpoint
        # is UNAUTHENTICATED — on shared networks bind metrics_host to
        # 127.0.0.1 (or a scrape-only interface) instead of all
        # interfaces.  None defers to observability.bind_host.
        self.metrics_port = (None if metrics_port is None
                             else int(metrics_port))
        if metrics_host is None:
            from analytics_zoo_torch.observability.exporter import (
                default_bind_host)
            metrics_host = default_bind_host()
        self.metrics_host = metrics_host
        # how many batches may be read-ahead into the decode pipeline.
        # Each read-ahead batch waits ~1 predict before its own turn, so
        # depth trades tail latency for decode/predict overlap: 2 keeps
        # the overlap (decode N+1 under predict N) at roughly half the
        # queue-wait p50 of deeper pipelines.  Clamped to >= 1: depth 0
        # would make the run loop read nothing, forever.
        self.pipeline_depth = max(1, int(pipeline_depth))
        # /healthz readiness thresholds (0 = that check disabled):
        # the probe flips to 503 when the input-stream backlog exceeds
        # healthz_max_queue, or when the error fraction over the most
        # recent records exceeds healthz_max_error_rate — so an
        # orchestrator stops routing to a drowning/poisoned worker
        # instead of killing a merely-busy one
        if healthz_max_queue is None:
            healthz_max_queue = get_config().get(
                "serving.healthz_max_queue", 0)
        if healthz_max_error_rate is None:
            healthz_max_error_rate = get_config().get(
                "serving.healthz_max_error_rate", 0.0)
        self.healthz_max_queue = int(healthz_max_queue or 0)
        self.healthz_max_error_rate = float(healthz_max_error_rate or 0.0)
        # bounded result-write backpressure: attempts before a result
        # is abandoned to the dead-letter stream (never < 1)
        if result_write_retries is None:
            result_write_retries = get_config().get(
                "serving.result_write_retries", 8)
        self.result_write_retries = max(int(result_write_retries), 1)
        # admission control: a record older than request_deadline_ms
        # is shed (dead-lettered reason=shed + error result) instead
        # of burning predict capacity on a response nobody is waiting
        # for.  0 disables shedding entirely.  While the stream
        # backlog exceeds healthz_max_queue (the worker is already
        # 503-not-ready), records past HALF the deadline are shed too:
        # behind a >threshold queue they would age out before their
        # predict anyway.
        if request_deadline_ms is None:
            request_deadline_ms = get_config().get(
                "serving.request_deadline_ms", 0)
        self.request_deadline_ms = int(request_deadline_ms or 0)
        # crash recovery: minimum idle time before another worker's
        # un-acked pending entries are claimed.  Must comfortably
        # exceed one worst-case batch (decode + predict + result
        # writes) so an alive-but-slow replica is not robbed, and
        # should stay BELOW the supervisor's restart window (backoff +
        # respawn + warm start): then a dead replica's in-flight
        # records are already re-served by its peers by the time its
        # replacement comes up.  The reclaim poll tick is derived from
        # it (min_idle/2, clamped to [0.25s, 10s]).
        if reclaim_min_idle_ms is None:
            reclaim_min_idle_ms = get_config().get(
                "serving.reclaim_min_idle_ms", 30000)
        self.reclaim_min_idle_ms = max(int(reclaim_min_idle_ms or 0), 0)
        # poison quarantine: total delivery attempts (the original
        # XREADGROUP delivery + reclaim re-deliveries, tracked by
        # request_id in POISON_ATTEMPTS_KEY) before a record that
        # keeps killing its worker is quarantined to the dead-letter
        # stream with reason=poison instead of being served again
        if poison_max_attempts is None:
            poison_max_attempts = get_config().get(
                "serving.poison_max_attempts", 2)
        self.poison_max_attempts = max(int(poison_max_attempts or 0), 1)
        # circuit breaker around broker ops: open after k consecutive
        # transport failures, half-open probe after cooldown.  0
        # disables (raw broker, pre-PR-9 behavior).
        if breaker_failures is None:
            breaker_failures = get_config().get(
                "serving.breaker_failures", 5)
        self.breaker_failures = int(breaker_failures or 0)
        if breaker_cooldown_s is None:
            breaker_cooldown_s = get_config().get(
                "serving.breaker_cooldown_s", 2.0)
        self.breaker_cooldown_s = max(float(breaker_cooldown_s or 0.0),
                                      0.05)
        # consumer_group set → multiple workers SHARE the stream, each
        # record served exactly once (the reference parallelizes per
        # Spark partition; redis-native scale-out uses XREADGROUP)
        self.consumer_group = consumer_group
        self.consumer_name = consumer_name
        # per-record input shape (no batch dim), e.g. (512,) tokens:
        # when set, the worker warms every bucket at startup (builds
        # the kernels the model launches and runs one zero batch, see
        # InferenceModel.warm) instead of paying that inside the first
        # client's request (config.yaml ``params.input_shape: 512``)
        if isinstance(input_shape, str):
            input_shape = tuple(
                int(d) for d in input_shape.replace("x", ",").split(",")
                if d.strip())
        self.input_shape = tuple(input_shape) if input_shape else None
        # continuous-batching knobs (serving engine v2): the bucket
        # ladder the batcher pads in-flight batches to ("1,4,16"; None
        # = powers of two up to batch_size), and how long the
        # empty-queue edge may wait for co-riders before dispatching a
        # partial bucket (0 = dispatch immediately — a lone request is
        # always served within batch_max_wait_ms plus one predict)
        if batch_max_wait_ms is None:
            batch_max_wait_ms = get_config().get(
                "serving.batch_max_wait_ms", 0.0)
        self.batch_max_wait_ms = max(float(batch_max_wait_ms or 0.0),
                                     0.0)
        self.batch_buckets = batch_buckets or None
        # HTTP/JSON fast path beside the Redis bulk path (None = off,
        # 0 = ephemeral port).  Binds metrics_host — the same
        # unauthenticated-endpoint caveat applies.
        self.http_port = None if http_port is None else int(http_port)
        if http_timeout_s is None:
            http_timeout_s = get_config().get(
                "serving.http_timeout_s", 30.0)
        self.http_timeout_s = float(http_timeout_s or 30.0)
        # multi-model endpoint spec: "name=pkg.module:builder" entries
        # separated by commas/whitespace, built + registered by the
        # CLI beside the primary model (which serves as 'default')
        self.endpoints = endpoints or None
        self.extra = extra or {}   # raw section.key entries (model.* etc)

    @classmethod
    def from_yaml(cls, path: str) -> "ServingConfig":
        cfg: Dict[str, Any] = {}
        section = None
        with open(path) as f:
            for line in f:
                raw = line.rstrip()
                if not raw or raw.lstrip().startswith("#"):
                    continue
                if not raw.startswith(" "):
                    section = raw.rstrip(":").strip()
                    continue
                k, _, v = raw.strip().partition(":")
                cfg[f"{section}.{k.strip()}"] = v.strip()
        return cls(
            redis_url=cfg.get("data.src"),
            batch_size=int(cfg.get("params.batch_size", 4) or 4),
            top_n=int(cfg.get("params.top_n", 1) or 1),
            log_dir=cfg.get("params.log_dir") or None,
            consumer_group=cfg.get("params.consumer_group") or None,
            consumer_name=cfg.get("params.consumer_name", "worker-0")
            or "worker-0",
            pipeline_depth=int(cfg.get("params.pipeline_depth", 2) or 2),
            metrics_port=(int(cfg["params.metrics_port"])
                          if cfg.get("params.metrics_port") not in
                          (None, "") else None),
            metrics_host=cfg.get("params.metrics_host") or None,
            healthz_max_queue=int(
                cfg.get("params.healthz_max_queue") or 0) or None,
            healthz_max_error_rate=float(
                cfg.get("params.healthz_max_error_rate") or 0.0) or None,
            result_write_retries=int(
                cfg.get("params.result_write_retries") or 0) or None,
            request_deadline_ms=int(
                cfg.get("params.request_deadline_ms") or 0) or None,
            reclaim_min_idle_ms=(
                int(cfg["params.reclaim_min_idle_ms"])
                if cfg.get("params.reclaim_min_idle_ms")
                not in (None, "") else None),   # explicit 0 = claim
                                                # stale entries now
            poison_max_attempts=int(
                cfg.get("params.poison_max_attempts") or 0) or None,
            breaker_failures=(int(cfg["params.breaker_failures"])
                              if cfg.get("params.breaker_failures")
                              not in (None, "") else None),
            breaker_cooldown_s=(
                float(cfg["params.breaker_cooldown_s"])
                if cfg.get("params.breaker_cooldown_s")
                not in (None, "") else None),   # explicit 0 clamps to
                                                # the 0.05s floor
            input_shape=cfg.get("params.input_shape") or None,
            batch_buckets=cfg.get("params.batch_buckets") or None,
            batch_max_wait_ms=(
                float(cfg["params.batch_max_wait_ms"])
                if cfg.get("params.batch_max_wait_ms")
                not in (None, "") else None),
            http_port=(int(cfg["params.http_port"])
                       if cfg.get("params.http_port")
                       not in (None, "") else None),   # explicit 0 =
                                                       # ephemeral port
            http_timeout_s=float(
                cfg.get("params.http_timeout_s") or 0.0) or None,
            endpoints=cfg.get("params.endpoints") or None,
            extra=cfg,
        )


class ClusterServing:
    """The Redis transport + composition root of the serving engine.

    The worker loop owns broker IO (read / shed / ack / reclaim /
    result writes); predicts happen on the engine's batcher thread,
    which continuously batches this transport's bulk groups with the
    HTTP fast path's singles and pads to warmed buckets."""

    def __init__(self, inference_model, config: ServingConfig = None,
                 broker=None):
        self.model = inference_model
        self.config = config or ServingConfig()
        cfg = self.config
        # ---- engine: batcher + executor + endpoint registry --------
        self.engine = ServingEngine(
            max_wait_ms=cfg.batch_max_wait_ms,
            default_timeout_s=max(cfg.http_timeout_s, 60.0))
        if inference_model is not None:
            self.engine.register(
                DEFAULT_ENDPOINT, inference_model, top_n=cfg.top_n,
                buckets=cfg.batch_buckets, batch_size=cfg.batch_size,
                input_shape=cfg.input_shape)
        self.engine.start()
        # ---- HTTP/JSON fast path (shares the engine queue) ---------
        self.http_transport: Optional[HttpTransport] = None
        if cfg.http_port is not None:
            self.http_transport = HttpTransport(
                self.engine, port=cfg.http_port,
                host=cfg.metrics_host or "127.0.0.1",
                timeout_s=cfg.http_timeout_s).start()
        # breaker-wrapped broker (serving.breaker_failures=0 for the
        # raw connection): a broker outage opens the circuit and every
        # op fast-fails until a half-open probe reconnects — the run
        # loop idles on CircuitOpenError instead of crash-looping
        self.broker = with_breaker(
            url=self.config.redis_url, broker=broker,
            failures=self.config.breaker_failures,
            cooldown_s=self.config.breaker_cooldown_s)
        self.summary = (InferenceSummary(self.config.log_dir, "serving")
                        if self.config.log_dir else None)
        self._stop = threading.Event()
        self._last_id = "0-0"
        self.total_records = 0
        self._group_ready = not self.config.consumer_group
        if self.config.consumer_group:
            try:
                self._ensure_group()
            except _BROKER_OUTAGE_EXCS as e:
                # broker down at bring-up: crashing here would make
                # the supervisor restart-loop the replica against a
                # dead broker — exactly what the breaker exists to
                # prevent.  The group is created lazily by the first
                # successful read attempt once the probe reconnects;
                # until then reads fail into the run loop's outage
                # idle path like any other broker op.
                log.warning(
                    "broker unavailable at startup (%s: %s); consumer "
                    "group %r will be created once it recovers",
                    type(e).__name__, e, self.config.consumer_group)
        # per-record arrival→result latencies (seconds), bounded
        self.latencies: deque = deque(maxlen=10000)
        self._serve_start: Optional[float] = None
        # entry ids read by THIS worker and not yet acked (in the
        # decode/predict pipeline) — the reclaim pass must not treat
        # them as another worker's stale pending
        self._inflight: set = set()
        # last time the (extra-broker-op) group-lag gauge refreshed
        self._backlog_obs_at = 0.0
        # THIS worker's last observed backlog.  /healthz and admission
        # control read this instance field, not the shared
        # ``serving_queue_depth`` gauge: the gauge is one registry-wide
        # series, so any other serving instance still draining in the
        # same process (tests, embedded multi-worker setups) could
        # overwrite it between a refresh and a readiness probe —
        # flipping this worker's verdict on someone else's traffic
        self._backlog_seen = 0.0
        # ---- observability: shared-registry instruments + /metrics --
        reg = get_registry()
        self._m_latency = reg.histogram(
            "serving_request_latency_seconds",
            "stream-arrival to result-write latency per record")
        self._m_records = reg.counter(
            "serving_records_total", "records served")
        self._m_errors = reg.counter(
            "serving_errors_total",
            "records acked with an error result (decode/poison)")
        self._m_queue = reg.gauge(
            "serving_queue_depth", "input stream length at last poll")
        self._m_redis_retry = reg.counter(
            "serving_redis_retry_total",
            "result-write attempts retried after a broker error")
        self._m_write_abandoned = reg.counter(
            "serving_result_write_abandoned_total",
            "results abandoned (dead-lettered) after the bounded "
            "write-backoff was exhausted")
        self._m_reclaimed = reg.counter(
            "serving_reclaimed_total",
            "stale pending records reclaimed from dead workers")
        self._m_shed = reg.counter(
            "serving_shed_total",
            "records shed by admission control instead of predicted",
            labels=("cause",))
        self._m_quarantined = reg.counter(
            "serving_quarantined_total",
            "poison records quarantined to the dead-letter stream "
            "after repeatedly killing their worker")
        self._m_dead_letter = reg.counter(
            "serving_dead_letter_total",
            "records written to the serving_dead_letter stream, by "
            "reason", labels=("reason",))
        self._tracer = get_tracer()
        self._telemetry: Optional[TelemetrySampler] = None
        # readiness window: 1 per recently served record, 0 per record
        # acked with an error result — the error-rate half of /healthz.
        # The lock pairs the worker thread's extend with the /healthz
        # thread's snapshot: list(deque) raises if the deque mutates
        # mid-iteration, which would flip a healthy worker to 503.
        self._recent_outcomes: deque = deque(maxlen=200)
        self._outcomes_lock = threading.Lock()
        # True while warm_start() warms the bucket ladder:
        # /healthz answers 503 warming_up (alive, not routable)
        self._warming = False
        # chaos-site step counters (decode runs in the pool →
        # itertools.count.__next__ is atomic under the GIL)
        self._decode_seq = itertools.count()
        self._predict_seq = itertools.count()
        self.metrics_server: Optional[MetricsServer] = None
        if self.config.metrics_port is not None:
            self.metrics_server = MetricsServer(
                port=self.config.metrics_port,
                host=self.config.metrics_host,
                health_check=self.readiness).start()

    # ------------------------------------------------------------ endpoints
    def register_endpoint(self, name: str, model, *,
                          top_n: Optional[int] = None,
                          buckets=None, input_shape=None,
                          weight: int = 1):
        """Register an additional model under ``name`` (multi-model
        serving): records carrying an ``endpoint`` field — and HTTP
        ``POST /predict/<name>`` — route to it.  Per-endpoint knobs
        default to this worker's config."""
        cfg = self.config
        return self.engine.register(
            name, model,
            top_n=cfg.top_n if top_n is None else top_n,
            buckets=buckets or cfg.batch_buckets,
            batch_size=cfg.batch_size,
            input_shape=input_shape or cfg.input_shape,
            weight=weight)

    def register_generative_endpoint(self, name: str, model, *,
                                     enc_len: int, start_sign: int,
                                     stop_sign: Optional[int] = None,
                                     max_seq_len: int = 32,
                                     slots: Optional[int] = None,
                                     buckets=None, weight: int = 1):
        """Register a *generative* model (``Seq2seq``'s decode
        contract) under ``name``: records routed to it are token
        SEQUENCES served by the decode-step scheduler — admitted into
        a device-resident slot pool, decoded one iteration at a time
        with EOS early-exit and same-iteration backfill, their results
        written as the emitted token list.  Stream records may carry a
        ``max_tokens`` field (client ``enqueue(..., max_tokens=)``)
        to cap their own sequence."""
        cfg = self.config
        # the worker's request_deadline_ms covers this endpoint too:
        # queued (not-yet-admitted) sequences past the deadline are
        # shed at the slot-pool gate, as the stateless path sheds
        return self.engine.register_generative(
            name, model, enc_len=enc_len, start_sign=start_sign,
            stop_sign=stop_sign, max_seq_len=max_seq_len,
            slots=cfg.batch_size if slots is None else slots,
            buckets=buckets or cfg.batch_buckets or (),
            weight=weight,
            request_deadline_ms=cfg.request_deadline_ms)

    # ----------------------------------------------------------- warm-start
    def warm_start(self) -> bool:
        """Warm-start EVERY endpoint's full bucket ladder (the batcher
        pads in-flight batches to the nearest bucket, so each rung is
        its own batch shape): ``InferenceModel.warm`` builds the
        kernels the model launches and runs one zero batch of the
        rung, so the first client's request pays neither the kernel
        build nor the card's first-call setup.  Best-effort per bucket
        (a failed build surfaces again at the first predict, through
        the executor's failure path).  No-op for endpoints without an
        ``input_shape``; True when any bucket warmed."""
        t0 = time.perf_counter()
        warmed = self.engine.warm_start()
        total = sum(warmed.values())
        if total:
            log.info("predict warm start: %d bucket program(s) ready "
                     "in %.2fs (%s)", total, time.perf_counter() - t0,
                     warmed)
        return total > 0

    # ----------------------------------------------------------- dead letter
    def dead_letter(self, reason: str, *, uri: Optional[str] = None,
                    request_id: Optional[str] = None,
                    cause: Optional[str] = None,
                    error: Optional[BaseException] = None,
                    extra: Optional[Dict[str, str]] = None) -> bool:
        """The ONE write path to the ``serving_dead_letter`` stream
        (reasons: ``write_abandoned`` | ``shed`` | ``poison``): builds
        the entry, counts it under
        ``serving_dead_letter_total{reason}``, and absorbs broker
        failures — giving up on a record must never also kill the
        worker loop.  Returns whether the entry landed."""
        entry: Dict[str, str] = {
            "uri": uri or "",
            "request_id": request_id or "",
            "reason": reason,
        }
        if cause:
            entry["cause"] = cause
        if error is not None:
            entry["error"] = f"{type(error).__name__}: {error}"
        entry.update(extra or {})
        self._m_dead_letter.labels(reason).inc()
        if reason != "shed":
            # flight-record the rare, diagnosis-bearing dead letters
            # (write_abandoned = broker trouble, poison = quarantine);
            # shed is normal overload control and would flood the ring
            flightrec.record_event(
                "dead_letter", reason=reason, uri=uri or "",
                request_id=request_id or "")
        try:
            self.broker.xadd(DEAD_LETTER_STREAM, entry)
            return True
        except Exception:   # noqa: BLE001 — the broker may be down
            log.exception(
                "dead-letter write failed for %s (reason=%s; broker "
                "down?); the request_id above is the only record",
                uri, reason)
            return False

    # ------------------------------------------------------------ main loop
    def run_once(self, block_ms: int = 100) -> int:
        """One poll/predict/write cycle; returns #records served."""
        # zoolint: disable=RACE016 — serve-loop confined: run()/run_once() are driven by exactly ONE thread (foreground main or the single background runner), never both
        self._serve_start = self._serve_start or time.perf_counter()
        entries = self._read_entries(self.config.batch_size, block_ms)
        if not entries:
            return 0
        t0 = time.perf_counter()
        real = self._serve_entries(entries, t0)
        if self.summary is not None and real:
            self.summary.add_scalar(
                "Serving Throughput",
                real / max(time.perf_counter() - t0, 1e-9),
                # zoolint: disable=RACE016 — serve-loop confined counter (single loop thread)
                self.total_records)
        self._observe_queue()
        return real

    def _backlog(self) -> int:
        """The input-stream BACKLOG this worker group still owes:
        undelivered + pending via ``xlag`` in consumer-group mode
        (served entries stay in the stream until trimmed, so ``XLEN``
        reads high forever), stream length otherwise (a solo reader
        advances ``_last_id`` but legacy dashboards key on length).
        Transport failures propagate like any broker op."""
        cfg = self.config
        if cfg.consumer_group:
            xlag = getattr(self.broker, "xlag", None)
            if xlag is not None:
                try:
                    return int(xlag(INPUT_STREAM, cfg.consumer_group))
                except _BROKER_OUTAGE_EXCS:
                    raise
                except Exception:   # noqa: BLE001 — duck broker
                    pass
        return self.broker.xlen(INPUT_STREAM)

    def _observe_queue(self) -> None:
        """Refresh ``serving_queue_depth`` (the /healthz, shedding,
        and autoscaler signal) and apply the stream OOM guard
        (ClusterServing.scala:128-134).  In consumer-group mode the
        gauge is the true lag (``xlag`` = one extra broker op), so it
        is throttled to ~4 Hz — the per-batch hot path stays at the
        single XLEN round trip it always paid; solo-reader mode keeps
        xlen, which the XLEN below already fetched."""
        qlen = self.broker.xlen(INPUT_STREAM)
        if not self.config.consumer_group:
            self._note_backlog(qlen)
        elif time.perf_counter() - self._backlog_obs_at >= 0.25:
            self._note_backlog(self._backlog())
            # zoolint: disable=ATOM017 — serve-loop confined throttle clock: only the single loop thread runs _observe_queue
            self._backlog_obs_at = time.perf_counter()
        if qlen > self.config.max_stream_len:
            self.broker.xtrim(INPUT_STREAM, self.config.max_stream_len)

    def _note_backlog(self, depth: float) -> None:
        """Record an observed input-stream backlog: the exported gauge
        (autoscaler / dashboards) AND this worker's own readiness/
        admission view of it."""
        self._backlog_seen = float(depth)
        self._m_queue.set(depth)

    def _write_result(self, uri: str, value: str,
                      retries: Optional[int] = None,
                      request_id: Optional[str] = None) -> bool:
        """Write one result with BOUNDED backpressure (ref :254-289
        retried "infinite-ish" and then raised, killing the worker
        loop with the rest of the batch un-acked): exponential backoff
        with jitter between attempts (jitter de-synchronizes the
        worker fleet hammering a recovering broker), then the record
        is ABANDONED — counted, logged, and dead-lettered with its
        request_id — so one unwritable result can never crash the
        loop.  The request_id from the matching enqueue is echoed
        beside the result so a client can correlate response <->
        request across processes.  Returns True when the write
        landed."""
        fields = {"value": value}
        if request_id:
            fields["request_id"] = request_id
        if retries is None:
            retries = self.config.result_write_retries
        attempts = max(int(retries), 1)
        delay = 0.05
        last_exc: Optional[Exception] = None
        for attempt in range(attempts):
            try:
                self.broker.hset(RESULT_PREFIX + uri, fields)
                return True
            except Exception as e:   # noqa: BLE001 — broker flake class
                last_exc = e
                self._m_redis_retry.inc()
                if attempt + 1 >= attempts:
                    break
                import random
                time.sleep(delay * (0.5 + random.random()))
                delay = min(delay * 2.0, 2.0)
        self._m_write_abandoned.inc()
        log.error("abandoning result write for %s after %d attempts "
                  "(%s: %s); dead-lettering", uri, attempts,
                  type(last_exc).__name__, last_exc)
        self.dead_letter("write_abandoned", uri=uri,
                         request_id=request_id, error=last_exc,
                         extra={"abandoned_unix": f"{time.time():.3f}"})
        return False

    # -------------------------------------------------- pipelined serving
    def _ensure_group(self) -> None:
        """Create the consumer group if this worker has not managed to
        yet (idempotent; deferred past __init__ when the broker was
        down at bring-up)."""
        if not self._group_ready:
            self.broker.xgroup_create(INPUT_STREAM,
                                      self.config.consumer_group)
            # zoolint: disable=ATOM017 — serve-loop confined lazy init (and xgroup_create is idempotent MKSTREAM)
            self._group_ready = True

    def _read_entries(self, count: int, block_ms: int):
        """Read the next batch: plain XREAD (single worker owns the
        stream) or XREADGROUP (workers share it, exactly-once
        delivery)."""
        cfg = self.config
        if cfg.consumer_group:
            self._ensure_group()
            return self.broker.xreadgroup(
                cfg.consumer_group, cfg.consumer_name, INPUT_STREAM,
                count=count, block_ms=block_ms)
        entries = self.broker.xread(INPUT_STREAM, self._last_id,
                                    count=count, block_ms=block_ms)
        for entry_id, _f in entries:
            self._last_id = entry_id
        return entries

    def _ack(self, entries) -> None:
        if self.config.consumer_group and entries:
            self.broker.xack(INPUT_STREAM, self.config.consumer_group,
                             *[i for i, _ in entries])

    def _reclaim_stale(self, min_idle_ms: Optional[int] = None):
        """Crash recovery: claim entries another worker read but never
        acknowledged (died between XREADGROUP and XACK) and serve them
        — without this, records in a dead worker's pending list would
        wait forever.

        Reclaimed records are served ONE AT A TIME under the poison-
        quarantine contract: a record on this path has already been
        delivered and never acknowledged (its worker likely died on
        it), so before each individual serve its delivery count is
        persisted to ``POISON_ATTEMPTS_KEY`` — a crash mid-serve still
        counts.  A record whose total deliveries would exceed
        ``poison_max_attempts`` is quarantined to the dead-letter
        stream (reason=poison) instead of killing this replica too.
        Individual serving also shields the innocent co-batched
        records: they are served (and their count cleared) before or
        after the poison one dies, instead of sharing its fate
        forever."""
        cfg = self.config
        if not cfg.consumer_group:
            return 0
        if min_idle_ms is None:
            min_idle_ms = cfg.reclaim_min_idle_ms
        try:
            entries = self.broker.xautoclaim(
                INPUT_STREAM, cfg.consumer_group, cfg.consumer_name,
                min_idle_ms, count=cfg.batch_size)
        except Exception:
            log.exception("xautoclaim failed")
            return 0
        # XAUTOCLAIM does not exclude the caller: under a deep backlog
        # (pipeline_depth batches waiting > min_idle_ms) it hands back
        # THIS worker's own un-acked in-flight entries — serving those
        # here would double-predict and double-write them.
        entries = [e for e in entries if e[0] not in self._inflight]
        if not entries:
            return 0
        try:
            counts = self.broker.hgetall(POISON_ATTEMPTS_KEY)
        except Exception:   # noqa: BLE001 — count-less reclaim is fine
            counts = {}
        real = served = 0
        for entry_id, fields in entries:
            key = self._rid_of(fields) or str(entry_id)
            # idempotent completion (found by the storm
            # harness): a record whose result ALREADY sits in the
            # result table under its own request_id was fully served
            # by a pass whose ACK the broker outage swallowed — the
            # only thing left to do is finish the ack.  Re-serving it
            # would double-predict; worse, letting it ride the poison
            # judgment would eventually QUARANTINE an innocent record
            # and overwrite its delivered result with an error (the
            # mark-before-serve attempt count below persists across
            # the interrupted pass by design — a crash mid-serve must
            # count — so outage-interrupted passes accumulate blame
            # the record never earned).
            if self._reclaim_already_served(entry_id, fields, key):
                served += 1
                continue
            attempts = int(counts.get(key, 0) or 0)
            # total deliveries so far = the original XREADGROUP
            # delivery + `attempts` reclaim re-serves; would this
            # re-serve exceed the budget?
            if attempts + 1 >= cfg.poison_max_attempts:
                self._quarantine(entry_id, fields, attempts + 1)
                continue
            try:
                self.broker.hset(POISON_ATTEMPTS_KEY,
                                 {key: str(attempts + 1)})
            except Exception:   # noqa: BLE001 — serve counts anyway
                log.exception("poison-attempt mark failed for %s", key)
            # a reclaimed record can be the very poison that killed
            # its original worker — an in-process failure is absorbed
            # by _serve_entries' poison contract; a process-killing
            # one leaves the count above persisted for the NEXT
            # reclaimer's verdict
            real += self._serve_entries([(entry_id, fields)],
                                        time.perf_counter())
            served += 1
            try:
                self.broker.hdel(POISON_ATTEMPTS_KEY, key)
            except Exception:   # noqa: BLE001 — stale count is benign
                pass
        self._m_reclaimed.inc(served)
        log.info("reclaimed %d stale pending records (%d served, "
                 "%d error-resulted, %d quarantined)", len(entries),
                 real, served - real, len(entries) - served)
        return real

    def _reclaim_already_served(self, entry_id, fields,
                                key: str) -> bool:
        """Whether this reclaimed record's result is already written
        UNDER ITS OWN request_id — i.e. an earlier serve completed
        and only the ack was lost to a broker outage.  If so, finish
        the ack and clear the poison-attempt mark; returns True
        (nothing left to serve).  Records without a request_id cannot
        be safely matched (result keys are per-uri, and a client may
        legitimately reuse a uri), so they take the normal path.
        Broker failures while CHECKING propagate like any reclaim op
        — the run loop's outage idle handles them."""
        rid = self._rid_of(fields)
        uri = self._uri_of(fields)
        if not rid or not uri:
            return False
        existing = self.broker.hgetall(RESULT_PREFIX + uri)
        got = existing.get("request_id",
                           existing.get(b"request_id"))
        if isinstance(got, bytes):
            got = got.decode()
        if got != rid:
            return False
        log.info("reclaimed record %s (request_id=%s) was already "
                 "served; finishing its lost ack instead of "
                 "re-serving", entry_id, rid)
        self._ack([(entry_id, fields)])
        try:
            self.broker.hdel(POISON_ATTEMPTS_KEY, key)
        except Exception:   # noqa: BLE001 — orphan count is benign
            pass            # once the record is acked out of the PEL
        return True

    def _quarantine(self, entry_id, fields, deliveries: int) -> None:
        """Dead-letter a record that keeps killing its workers
        (reason=poison), give its client an explicit error result, and
        ack it out of the PEL so it can never be delivered again."""
        uri, rid = self._uri_of(fields), self._rid_of(fields)
        log.error("quarantining poison record %s (uri=%s, request_id="
                  "%s) after %d deliveries", entry_id, uri, rid,
                  deliveries)
        self.dead_letter(
            "poison", uri=uri, request_id=rid,
            extra={"entry_id": str(entry_id),
                   "deliveries": str(deliveries),
                   "quarantined_unix": f"{time.time():.3f}"})
        flightrec.record_event(
            "quarantine", entry_id=str(entry_id), uri=uri or "",
            request_id=rid or "", deliveries=deliveries)
        if uri:
            self._write_result(uri, json.dumps({
                "error": f"poison: quarantined after "
                         f"{deliveries} deliveries"}),
                request_id=rid)
        self._m_quarantined.inc()
        self._m_errors.inc()
        ctx = TraceContext.from_wire(self._trace_of(fields),
                                     request_id=rid)
        if ctx is not None:
            reqlog = get_request_log()
            reqlog.begin(ctx, transport="redis",
                         station="transport_receive")
            reqlog.finish(ctx, "quarantined", station="result_write",
                          deliveries=deliveries)
        with self._outcomes_lock:
            self._recent_outcomes.append(0)
        self._ack([(entry_id, fields)])
        try:
            self.broker.hdel(POISON_ATTEMPTS_KEY,
                             rid or str(entry_id))
        except Exception:   # noqa: BLE001 — stale count is benign
            pass

    def _decode_batch(self, entries):
        """Decode one batch of raw stream entries (runs in the decode
        pool — pure CPU, no broker IO, so no connection sharing across
        threads).  Undecodable records are collected into ``failed``
        (uri, request_id, exception) rather than silently dropped —
        the serve path writes them an error result, because acking
        consumes the record and a consumed record with no result
        strands its client."""
        chaos = active_chaos()
        if chaos is not None:
            chaos.trip(SITE_SERVING_DECODE, next(self._decode_seq))
        uris, arrays, rids, eps, mts, failed = [], [], [], [], [], []
        traces = []
        for entry_id, fields in entries:
            try:
                uri, arr, rid = decode_field(fields)
            except Exception as e:
                log.exception("undecodable record %s", entry_id)
                failed.append((self._uri_of(fields),
                               self._rid_of(fields), e))
                ctx = TraceContext.from_wire(
                    self._trace_of(fields),
                    request_id=self._rid_of(fields))
                if ctx is not None:
                    reqlog = get_request_log()
                    reqlog.begin(ctx, transport="redis",
                                 station="transport_receive")
                    reqlog.finish(ctx, "error",
                                  station="result_write")
                continue
            uris.append(uri)
            arrays.append(arr)
            rids.append(rid)
            eps.append(self._endpoint_of(fields))
            mts.append(self._max_tokens_of(fields))
            traces.append(self._trace_of(fields))
        return uris, arrays, failed, rids, eps, mts, traces

    @staticmethod
    def _uri_of(fields) -> str:
        uri = fields.get("uri", b"") if hasattr(fields, "get") else b""
        return uri.decode() if isinstance(uri, bytes) else uri

    @staticmethod
    def _rid_of(fields):
        rid = fields.get("request_id") if hasattr(fields, "get") \
            else None
        return rid.decode() if isinstance(rid, bytes) else rid

    @staticmethod
    def _trace_of(fields):
        """The record's ``trace`` wire string (client-stamped
        TraceContext); None for records enqueued without one.  Rides
        XAUTOCLAIM unchanged, so a reclaimed record keeps its original
        trace_id."""
        tw = fields.get(TRACE_FIELD) if hasattr(fields, "get") \
            else None
        return tw.decode() if isinstance(tw, bytes) else tw

    @staticmethod
    def _endpoint_of(fields) -> str:
        """Multi-model routing: the record's ``endpoint`` field (the
        client's ``enqueue(..., endpoint=)``), defaulting to the
        single-model endpoint."""
        ep = fields.get("endpoint") if hasattr(fields, "get") else None
        if isinstance(ep, bytes):
            ep = ep.decode()
        return ep or DEFAULT_ENDPOINT

    @staticmethod
    def _max_tokens_of(fields) -> Optional[int]:
        """Generative records may cap their own sequence length
        (client ``enqueue(..., max_tokens=)``); None elsewhere."""
        mt = fields.get("max_tokens") if hasattr(fields, "get") \
            else None
        if isinstance(mt, bytes):
            mt = mt.decode()
        try:
            return int(mt) if mt else None
        except (TypeError, ValueError):
            return None

    # ------------------------------------------------- admission control
    @staticmethod
    def _entry_age_ms(entry_id, now_ms: float) -> Optional[float]:
        """Age of a stream entry from the ms half of its id (stream
        ids are ``<epoch-ms>-<seq>``); None when unparseable."""
        if isinstance(entry_id, bytes):
            entry_id = entry_id.decode()
        try:
            ms = int(str(entry_id).partition("-")[0])
        except (TypeError, ValueError):
            return None
        return now_ms - ms

    def _shed_expired(self, entries):
        """Deadline-aware load shedding (``params.request_deadline_ms``
        > 0 opts in): a record older than its deadline is shed —
        dead-lettered with reason=shed + an explicit error result +
        acked — instead of burning predict capacity on a response its
        client stopped waiting for.  While the backlog at the last
        poll exceeds ``params.healthz_max_queue`` (the same threshold
        that 503s `/healthz`), records past HALF the deadline are shed
        too: behind a >threshold queue they would age out before their
        own predict anyway — shedding them is what lets a drowning
        worker catch back up to fresh traffic.  Returns the admitted
        entries."""
        cfg = self.config
        deadline = float(cfg.request_deadline_ms)
        if not entries or deadline <= 0:
            return entries
        overloaded = (cfg.healthz_max_queue > 0
                      and self._backlog_seen > cfg.healthz_max_queue)
        cut = deadline / 2.0 if overloaded else deadline
        now_ms = time.time() * 1000.0
        keep, shed = [], []
        for entry_id, fields in entries:
            age = self._entry_age_ms(entry_id, now_ms)
            if age is None or age <= cut:
                keep.append((entry_id, fields))
            else:
                cause = "deadline" if age > deadline else "overload"
                shed.append((entry_id, fields, age, cause))
        for entry_id, fields, age, cause in shed:
            uri, rid = self._uri_of(fields), self._rid_of(fields)
            self.dead_letter(
                "shed", uri=uri, request_id=rid, cause=cause,
                extra={"age_ms": f"{age:.0f}",
                       "deadline_ms": f"{deadline:.0f}"})
            if uri:
                self._write_result(uri, json.dumps({
                    "error": f"shed: {cause} ({age:.0f}ms old, "
                             f"deadline {deadline:.0f}ms)"}),
                    request_id=rid)
            self._m_shed.labels(cause).inc()
            ctx = TraceContext.from_wire(self._trace_of(fields),
                                         request_id=rid)
            if ctx is not None:
                reqlog = get_request_log()
                reqlog.begin(ctx, transport="redis",
                             station="transport_receive")
                reqlog.finish(ctx, "shed", station="result_write",
                              cause=cause, age_ms=round(age, 1))
        if shed:
            # shed records are deliberate drops, not worker errors —
            # they are acked (consumed) but kept OUT of the /healthz
            # error-rate window: admission control under overload must
            # not also flip the probe that is already watching the
            # queue-depth threshold
            self._ack([(i, f) for i, f, _a, _c in shed])
            log.warning("shed %d records (%s)", len(shed),
                        ", ".join(sorted({c for *_x, c in shed})))
        return keep

    def _serve_entries(self, entries, t_arrival: float) -> int:
        """Decode + serve one raw batch with admission control and the
        poison-batch contract applied (shared by run_once and
        _reclaim_stale; the pipelined loop sheds BEFORE submitting
        decode work instead, so an expired record costs no decode
        either).  Returns #served."""
        entries = self._shed_expired(entries)
        if not entries:
            return 0
        try:
            decoded = self._decode_batch(entries)
        except Exception as e:
            log.exception("decode failed for batch (%d records)",
                          len(entries))
            decoded = ([], [], [(self._uri_of(f), self._rid_of(f), e)
                                for _, f in entries])
        return self._serve_decoded(decoded, t_arrival, entries)

    def _serve_decoded(self, decoded, t_arrival: float, entries) -> int:
        """Predict + write a decoded batch, then ack it.  The poison
        contract: NO failure in predict/write may escape (it would kill
        the worker loop with the batch un-acked), and every record that
        is acked without a prediction gets an explicit ERROR result so
        its client never blocks forever on a consumed record.
        ``decoded`` is (uris, arrays[, failed[, request_ids[,
        endpoints[, max_tokens[, traces]]]]])."""
        uris, arrays, *rest = decoded
        failed = list(rest[0]) if rest else []
        rids = list(rest[1]) if len(rest) > 1 else [None] * len(uris)
        eps = list(rest[2]) if len(rest) > 2 else \
            [DEFAULT_ENDPOINT] * len(uris)
        mts = list(rest[3]) if len(rest) > 3 else [None] * len(uris)
        traces = list(rest[4]) if len(rest) > 4 else [None] * len(uris)
        real = 0
        try:
            real = self._predict_write(uris, arrays, t_arrival, rids,
                                       eps, mts, traces)
        except Exception as e:
            log.exception("poison batch skipped (%d records)",
                          len(entries))
            failed += [(u, r, e) for u, r in zip(uris, rids)]
        for uri, rid, exc in failed:
            try:
                if uri:
                    self._write_result(uri, json.dumps(
                        {"error": f"{type(exc).__name__}: {exc}"}),
                        request_id=rid)
            except Exception:
                log.exception("could not write error result for %s", uri)
        self._m_errors.inc(len(failed))
        # readiness window: successes then failures, per record
        with self._outcomes_lock:
            self._recent_outcomes.extend([1] * real + [0] * len(failed))
        self._ack(entries)
        return real

    def _predict_write(self, uris, arrays, t_arrival: float,
                       rids=None, endpoints=None,
                       max_tokens=None, traces=None) -> int:
        """Submit one decoded bulk batch to the engine as atomic
        per-endpoint groups, wait for the batcher's bucket-padded
        predicts, and write every result; returns #served.

        The engine fails (rather than raises) model errors, so a
        poisoned group costs error results for exactly its own
        records; a non-``Exception`` escape (the simulated-process-
        death class) re-raises here so the loop dies with the batch
        un-acked — the PEL-reclaim trigger, exactly as before the
        engine split."""
        if not arrays:
            return 0
        if rids is None:
            rids = [None] * len(uris)
        if endpoints is None:
            endpoints = [DEFAULT_ENDPOINT] * len(uris)
        if max_tokens is None:
            max_tokens = [None] * len(uris)
        if traces is None:
            traces = [None] * len(uris)
        real = len(arrays)
        # the chaos site fires BEFORE the engine hand-off: a ``kill``
        # here is a replica dying mid-batch with the batch un-acked —
        # the scripted trigger for PEL reclaim and poison quarantine
        chaos = active_chaos()
        if chaos is not None:
            chaos.trip(SITE_SERVING_PREDICT, next(self._predict_seq))
        # group by endpoint (a bulk read may interleave models); each
        # group rides the engine as one atomic unit
        reqlog = get_request_log()
        now = time.perf_counter()
        groups: Dict[str, List[Request]] = {}
        for uri, arr, rid, ep, mt, tw in zip(uris, arrays, rids,
                                             endpoints, max_tokens,
                                             traces):
            ctx = None
            if reqlog.enabled:
                # a client-stamped trace rides the record's ``trace``
                # field; untraced records get a server-side context so
                # the replica's forensics cover ALL traffic (malformed
                # wires stay untraced, per from_wire's contract)
                ctx = (TraceContext.from_wire(tw, request_id=rid)
                       if tw else TraceContext.new(rid))
                if ctx is not None:
                    reqlog.begin(
                        ctx, transport="redis",
                        endpoint=ep or DEFAULT_ENDPOINT,
                        station="transport_receive", t=t_arrival)
                    reqlog.mark(ctx, "decode", t=now)
            groups.setdefault(ep or DEFAULT_ENDPOINT, []).append(
                Request(endpoint=ep or DEFAULT_ENDPOINT, uri=uri,
                        data=arr, request_id=rid, arrival=t_arrival,
                        max_tokens=mt, trace=ctx))
        # the span carries the batch's request ids, so a trace viewer
        # (or the merged cluster timeline) can follow one request from
        # client enqueue through its predict to its result write
        with self._tracer.span(
                "serving_predict", records=real,
                request_ids=[r for r in rids if r][:16]):
            requests: List[Request] = []
            for reqs in groups.values():
                requests.extend(self.engine.submit(reqs))
            self.engine.wait_all(requests)
        fatal = next((r.error for r in requests
                      if r.error is not None
                      and not isinstance(r.error, Exception)), None)
        if fatal is not None:
            raise fatal
        done = time.perf_counter()
        written = predicted = failed = 0
        for req in requests:
            if req.error is not None:
                if isinstance(req.error, ShedError):
                    # an ENGINE-level admission drop (generative
                    # queue-wait past request_deadline_ms): the same
                    # contract as the stream path's _shed_expired —
                    # dead-lettered with its age/deadline evidence
                    # (the verdict proves every shed was
                    # deadline-earned from these fields), an explicit
                    # error result, and kept OUT of the error
                    # accounting/readiness window: a deliberate drop
                    # is not a worker failure
                    self.dead_letter(
                        "shed", uri=req.uri,
                        request_id=req.request_id, cause="deadline",
                        extra={
                            "age_ms": f"{req.error.age_ms:.0f}",
                            "deadline_ms":
                                f"{req.error.deadline_ms:.0f}"})
                    # serving_shed_total{deadline} was already
                    # counted by the engine at the moment it shed
                    try:
                        if req.uri:
                            self._write_result(req.uri, json.dumps(
                                {"error": str(req.error)}),
                                request_id=req.request_id)
                    except Exception:
                        log.exception("could not write shed result "
                                      "for %s", req.uri)
                    reqlog.finish(req.trace, "shed",
                                  station="result_write")
                    continue
                # predict failed for this record's group: explicit
                # error result, error accounting, readiness window 0
                # — same consumed-record contract as a decode failure
                failed += 1
                try:
                    if req.uri:
                        self._write_result(req.uri, json.dumps(
                            {"error": f"{type(req.error).__name__}: "
                                      f"{req.error}"}),
                            request_id=req.request_id)
                except Exception:
                    log.exception("could not write error result "
                                  "for %s", req.uri)
                reqlog.finish(req.trace, "error",
                              station="result_write")
                continue
            predicted += 1
            if self._write_result(req.uri, json.dumps(req.result),
                                  request_id=req.request_id):
                written += 1
                self.latencies.append(done - t_arrival)
                self._m_latency.observe(done - t_arrival,
                                        exemplar=req.trace_id)
                reqlog.finish(req.trace, "ok",
                              station="result_write")
            else:
                # abandoned write: the client never sees this result
                reqlog.finish(req.trace, "error",
                              station="result_write")
        if failed:
            self._m_errors.inc(failed)
            with self._outcomes_lock:
                self._recent_outcomes.extend([0] * failed)
        abandoned = predicted - written
        if abandoned:
            # a dead-lettered result is a FAILURE to error accounting
            # and the /healthz error-rate window — the bounded path
            # must keep the readiness probe honest during a result-
            # write outage (an orchestrator should pull a worker whose
            # results never land)
            self._m_errors.inc(abandoned)
            with self._outcomes_lock:
                self._recent_outcomes.extend([0] * abandoned)
        # total_records counts records PROCESSED (drain/progress
        # bookkeeping); the return value counts records actually
        # DELIVERED — the outcome window gets its 1s from the caller
        self.total_records += predicted
        self._m_records.inc(predicted)
        if self.summary is not None:
            self.summary.add_scalar("Total Records Number",
                                    self.total_records,
                                    self.total_records)
        return written

    def readiness(self) -> Optional[Dict[str, Any]]:
        """The /healthz readiness probe (wired into the
        MetricsServer): None when ready, else a JSON-able reason dict
        — the endpoint answers 503 with it.  Thresholds come from
        config.yaml ``params.healthz_max_queue`` /
        ``params.healthz_max_error_rate`` (0 = check disabled).  An
        OPEN circuit breaker is always not-ready: the broker is down,
        so routing here is pointless — but the process is alive and
        fast-failing, which is exactly why the supervisor watches
        /healthz for liveness yet only restarts on *unreachable*
        (restarting cannot fix a dead broker)."""
        cfg = self.config
        if self._warming:
            # predict program compiling / cache-loading: alive (the
            # supervisor must not no-port kill a cold replica) but
            # not ready for routing yet
            return {"reason": "warming_up"}
        breaker = getattr(self.broker, "breaker", None)
        if breaker is not None and breaker.state == BREAKER_OPEN:
            return {"reason": "breaker_open",
                    "cooldown_s": breaker.cooldown_s}
        if cfg.healthz_max_queue > 0:
            depth = self._backlog_seen
            if depth > cfg.healthz_max_queue:
                return {"reason": "queue_depth",
                        "queue_depth": int(depth),
                        "threshold": cfg.healthz_max_queue}
        if cfg.healthz_max_error_rate > 0 and self._recent_outcomes:
            with self._outcomes_lock:
                outcomes = list(self._recent_outcomes)
            rate = 1.0 - sum(outcomes) / len(outcomes)
            if rate > cfg.healthz_max_error_rate:
                return {"reason": "error_rate",
                        "error_rate": round(rate, 4),
                        "window": len(outcomes),
                        "threshold": cfg.healthz_max_error_rate}
        return None

    def stats(self) -> Dict[str, float]:
        """Throughput + latency percentiles over the records served so
        far (the reference's TensorBoard serving scalars, :294-317,
        plus percentiles)."""
        lat = sorted(self.latencies)
        pct = lambda p: (lat[min(int(p / 100 * len(lat)),
                                 len(lat) - 1)] * 1e3) if lat else 0.0
        wall = (time.perf_counter() - self._serve_start) \
            if self._serve_start else 0.0
        return {
            "total_records": self.total_records,
            "throughput_rps": self.total_records / wall if wall else 0.0,
            "latency_p50_ms": pct(50),
            "latency_p95_ms": pct(95),
            "latency_p99_ms": pct(99),
        }

    def _should_stop(self, started: float) -> bool:
        if self._stop.is_set():
            return True
        try:
            sig = self.broker.hgetall(STOP_KEY)
        except _BROKER_OUTAGE_EXCS:
            # the cross-process stop signal is unreadable during an
            # outage; the local stop() path above still works
            return False
        if sig:
            raw = sig.get(b"stop", sig.get("stop", b"0"))
            try:
                ts = float(raw)
            except (TypeError, ValueError):
                ts = float("inf")   # unparseable → explicit stop
            if ts >= started - 1.0:   # small clock-skew allowance
                log.info("stop signal received; shutting down")
                self.broker.delete(STOP_KEY)
                return True
        return False

    def install_signal_handlers(self, signals=None) -> bool:
        """SIGTERM → graceful drain: ``stop()`` is set, the run loop
        finishes + acks every in-flight batch, flushes metrics, and
        returns normally (exit 0 from the CLI) — no request stranded
        in the PEL.  Signal handlers are a main-thread-only facility;
        returns False when this is not the main thread (background
        serving keeps using ``stop()`` directly)."""
        import signal as _signal
        if signals is None:
            signals = (_signal.SIGTERM,)
        try:
            for s in signals:
                _signal.signal(s, lambda _sig, _frame: self.stop())
            return True
        except ValueError:
            return False

    def run(self, poll_ms: int = 100, decode_workers: int = 2,
            pipeline_depth: Optional[int] = None) -> None:
        """Pipelined loop: the decode POOL works batch N+1..N+depth
        while the device predicts batch N (the reference parallelizes
        decode per partition, ClusterServing.scala:156-237; here decode
        threads overlap the device predict, which releases the GIL).  All
        broker IO stays on this thread — the RESP socket is not
        thread-safe.

        Broker-outage contract: transport failures (and the circuit
        breaker's fast-fails once it opens) never kill the loop — the
        worker idles, keeps heartbeating and answering ``/healthz``
        (503 ``breaker_open``), and resumes when a half-open probe
        reconnects.  Un-acked records ride the PEL through the outage.
        """
        if pipeline_depth is None:
            pipeline_depth = self.config.pipeline_depth
        log.info("cluster serving started (batch=%d, decode_workers=%d, "
                 "depth=%d)", self.config.batch_size, decode_workers,
                 pipeline_depth)
        # wall clock for the cross-process stop-signal comparison
        # (clients stamp STOP_KEY with time.time()); monotonic clock
        # for every interval below
        started = time.time()
        self._serve_start = self._serve_start or time.perf_counter()
        # publish /healthz BEFORE the warm start: a cold kernel build can
        # outlast a supervisor's startup grace — the port must be
        # discoverable and answering (503 warming_up = alive,
        # deliberately not-ready) while the kernels build, or a cold
        # replica would be no-port killed mid-build and respawned into
        # the same build
        if self.metrics_server is not None:
            self.metrics_server.start()   # no-op if already listening
        # the engine layers restart too (a closed worker can serve
        # again): batcher thread + HTTP fast-path listener
        self.engine.start()
        if self.http_transport is not None:
            self.http_transport.start()
        self._publish_port()
        # the queue gauge must be honest BEFORE the (possibly
        # minutes-long) warm start: /metrics is already answering, and
        # a supervisor reading a never-set 0 while a real backlog
        # waits behind the compile would scale the fleet DOWN at the
        # exact moment it needs capacity
        try:
            self._observe_queue()
        except _BROKER_OUTAGE_EXCS:
            pass          # broker down at boot: gauge stays unset
        # pre-pay the kernel build and first-call setup BEFORE polling:
        # the first client's request must not carry the cold start
        self._warming = True
        try:
            self.warm_start()
        finally:
            self._warming = False
        # replica liveness for the supervisor / launcher plane
        # (ZOO_TPU_METRICS_DIR names this worker's host-<k>/ slot)
        heartbeat = HostHeartbeat.from_env()
        # zoolint: disable=RACE016 — serve-loop confined: run() holds the sampler, close() runs on the same thread (run's finally / the context owner)
        self._telemetry = TelemetrySampler(
            float(get_config().get(
                "observability.telemetry_interval_s", 10.0))).start()
        # the input-pipeline worker pool (data/stages.py): serving's
        # decode stage is the same shape of work as a train pipeline's
        # map stage — CPU-bound host transforms overlapping the chip
        pool = WorkerPool(decode_workers, name="serving-decode")
        pending: deque = deque()   # (future, t_arrival, entries)
        reclaim_tick = max(0.25, min(
            10.0, self.config.reclaim_min_idle_ms / 2000.0))
        last_reclaim = time.perf_counter()
        # the queue gauge must keep tracking the backlog while IDLE
        # too: it naturally refreshes per consumed batch, but once
        # traffic stops it would freeze at the last busy value — and
        # the autoscaler's idle detection (queue == 0) would never
        # fire, pinning the fleet at its peak forever
        queue_obs_tick = 0.5
        last_queue_obs = 0.0
        outage = False
        try:
            while True:
                if heartbeat is not None:
                    heartbeat.beat(step=self.total_records)
                try:
                    if time.perf_counter() - last_reclaim \
                            > reclaim_tick:
                        self._reclaim_stale()
                        last_reclaim = time.perf_counter()
                    # keep the decode pipeline full (admission control
                    # BEFORE the decode submit: an expired record
                    # costs neither decode nor predict)
                    while len(pending) < pipeline_depth:
                        entries = self._read_entries(
                            self.config.batch_size,
                            0 if pending else poll_ms)
                        if not entries:
                            break
                        entries = self._shed_expired(entries)
                        if not entries:
                            # fully-shed batch: yield to the OUTER
                            # loop instead of reading again — purging
                            # a deep expired backlog must not starve
                            # the heartbeat, the stop/drain check, or
                            # reclaim (a supervisor would TERM a
                            # replica whose beat stalls mid-purge)
                            break
                        self._inflight.update(i for i, _ in entries)
                        pending.append((pool.submit(self._decode_batch,
                                                    entries),
                                        time.perf_counter(), entries))
                    if pending:
                        fut, t_arrival, entries = pending.popleft()
                        self._consume_batch(fut, t_arrival, entries)
                        if self.summary is not None and self.latencies:
                            s = self.stats()
                            self.summary.add_scalar(
                                "Serving Throughput",
                                s["throughput_rps"],
                                self.total_records)
                        self._observe_queue()
                        last_queue_obs = time.perf_counter()
                    elif time.perf_counter() - last_queue_obs \
                            > queue_obs_tick:
                        self._observe_queue()
                        last_queue_obs = time.perf_counter()
                    if outage:
                        outage = False
                        log.warning("broker recovered; serving resumed")
                except _BROKER_OUTAGE_EXCS as e:
                    # fast-fail idle: one bounded sleep per failed
                    # attempt (the breaker already swallowed the
                    # per-op connect cost), not a crash that would
                    # make the supervisor restart-loop the replica
                    # against a dead broker
                    if not outage:
                        outage = True
                        log.warning(
                            "broker unavailable (%s: %s); idling until "
                            "the breaker's half-open probe reconnects",
                            type(e).__name__, e)
                    time.sleep(min(
                        0.25, self.config.breaker_cooldown_s / 2.0))
                if self._should_stop(started):
                    self._drain(pending)
                    break
        finally:
            pool.shutdown(wait=False)
            self._flush_observability()
            self.close()

    def _flush_observability(self) -> None:
        """Drain-time metrics flush: inside a launcher-managed run dir
        the worker's registry snapshot is persisted so fleet
        aggregation sees the final counts (no-op anywhere else —
        ``flush_worker_observability`` guards on its own init)."""
        if not os.environ.get("ZOO_TPU_METRICS_DIR"):
            return
        try:
            from analytics_zoo_torch.observability.aggregator import (
                flush_worker_observability)
            flush_worker_observability()
        except Exception:   # noqa: BLE001 — flush is best-effort
            log.exception("observability flush failed")

    def _drain(self, pending: deque) -> None:
        """Graceful drain: every batch already read past (_last_id
        advanced / PEL-delivered) MUST still be predicted, written,
        and acked, or its clients wait forever.  Under a broker
        outage the remaining batches are left UN-acked — the PEL keeps
        them for the surviving replicas to reclaim, which beats
        blocking shutdown on a dead broker."""
        while pending:
            fut, t_arrival, entries = pending.popleft()
            try:
                self._consume_batch(fut, t_arrival, entries)
            except _BROKER_OUTAGE_EXCS:
                log.warning(
                    "drain: broker unavailable; leaving %d batch(es) "
                    "in the PEL for peer reclaim", len(pending) + 1)
                break

    def _publish_port(self) -> None:
        """Replica→supervisor port discovery: atomically write the
        bound /metrics (+/healthz) port to the file named by
        ``ZOO_TPU_SERVING_PORT_FILE`` (the supervisor injects it and
        polls readiness on the discovered port — metrics_port=0 keeps
        replicas collision-free on one host)."""
        path = os.environ.get("ZOO_TPU_SERVING_PORT_FILE")
        if path and self.metrics_server is not None \
                and self.metrics_server.port:
            try:
                atomic_write_text(path, str(self.metrics_server.port))
            except OSError:
                log.exception("could not publish serving port to %s",
                              path)
        # the HTTP fast path publishes its own (ephemeral) port the
        # same way, for supervisors / load balancers fronting it
        http_path = os.environ.get("ZOO_TPU_SERVING_HTTP_PORT_FILE")
        if http_path and self.http_transport is not None \
                and self.http_transport.port:
            try:
                atomic_write_text(http_path,
                                  str(self.http_transport.port))
            except OSError:
                log.exception("could not publish serving http port "
                              "to %s", http_path)

    def _consume_batch(self, fut, t_arrival, entries) -> None:
        """Serve one pipelined batch whose decode ran in the pool:
        resolve the decode future (a future that raised becomes an
        all-failed decode) and hand off to the shared poison-safe serve
        path, then clear the batch's in-flight ids."""
        try:
            try:
                decoded = fut.result()
            except Exception as e:
                log.exception("decode future failed (%d records)",
                              len(entries))
                decoded = ([], [],
                           [(self._uri_of(f), self._rid_of(f), e)
                            for _, f in entries])
            self._serve_decoded(decoded, t_arrival, entries)
        finally:
            self._inflight.difference_update(i for i, _ in entries)

    def start_background(self) -> threading.Thread:
        t = threading.Thread(target=self.run, daemon=True)
        t.start()
        return t

    def stop(self) -> None:
        """(ref ClusterServingManager.listenTermination :335)"""
        self._stop.set()

    def close(self) -> None:
        """Release held resources: summary file handles, the telemetry
        sampler, the /metrics listener, the HTTP fast path, and the
        engine's batcher thread.  Idempotent; called by ``run()`` on
        every exit path.  A closed engine can serve again (summaries
        reopen on write; ``run()`` restarts the listeners and the
        batcher)."""
        if self.summary is not None:
            self.summary.close()
        if self._telemetry is not None:
            self._telemetry.stop()
            # zoolint: disable=ATOM017 — idempotent teardown: a second closer re-stops an already-stopped sampler, which is a no-op
            self._telemetry = None
        if self.metrics_server is not None:
            self.metrics_server.stop()
        if self.http_transport is not None:
            self.http_transport.stop()
        self.engine.stop()

    def __enter__(self) -> "ClusterServing":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.stop()
        self.close()
