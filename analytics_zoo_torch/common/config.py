"""Layered configuration for the framework.

The PyTorch port keeps its own copy of the reference package's config
module (the port imports nothing of ``analytics_zoo_tpu``); keys, layers
and precedence are unchanged, so one conf file or ``ZOO_TPU_*``
environment serves both packages.

The reference stacks four config layers (SURVEY.md §5 "Config / flag
system"): a conf file of perf-critical defaults
(zoo/src/main/resources/spark-analytics-zoo.conf, read by
NNContext.readConf NNContext.scala:188-200), Java system properties
(``bigdl.*``), environment variables (KMP_*/OMP_*), and per-example CLI
flags.  We reproduce the same layering TPU-natively:

    defaults  <  conf file (zoo-tpu.conf)  <  env (ZOO_TPU_*)  <  code overrides

Keys use dotted lowercase names, e.g. ``train.retry_times`` mirrors the
reference's ``bigdl.failure.retryTimes`` system property
(Topology.scala:1179-1261).
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional

# Perf-critical defaults: the analogue of spark-analytics-zoo.conf.
_DEFAULTS: Dict[str, Any] = {
    # Numerics ---------------------------------------------------------
    # Params kept in f32, matmul/conv compute in bf16 on the MXU.
    "dtype.param": "float32",
    "dtype.compute": "bfloat16",
    # Matmul precision passed to jax ops ("default"|"high"|"highest").
    "dtype.matmul_precision": "default",
    # Kernel suite (ops/fused.py): "auto" = the hand-written CUDA
    # kernels for CUDA tensors and their plain PyTorch versions for CPU
    # tensors; "torch" forces the plain versions everywhere; "off"
    # disables the suite (call sites revert to their unfused paths).
    "ops.fused": "auto",
    # Mesh / distribution ---------------------------------------------
    # Default mesh shape; "auto" = all devices on the data axis,
    # else "data:4,model:2"-style axis sizes.
    "mesh.shape": "auto",
    # Seconds a collective may wait before the group raises (a lost rank
    # then fails the step instead of hanging it).
    "parallel.timeout_s": 1800.0,
    # Training engine --------------------------------------------------
    # Failure-retry loop, mirroring bigdl.failure.retryTimes /
    # retryTimeInterval (Topology.scala:1179-1261).
    "train.retry_times": 5,
    "train.retry_interval_s": 120,
    # Donate input buffers in the jitted train step (saves HBM).
    "train.donate": True,
    # Gradient allreduce in bf16 (the analogue of BigDL's compressed
    # FP16 gradient serialization during sync, SURVEY.md §2.4).
    "train.grad_sync_dtype": "float32",
    # Steps fused into one device dispatch by the training engine when
    # triggers are epoch-scoped (a lax.scan over k stacked batches):
    # per-step host/dispatch overhead drops ~k-fold while HBM holds
    # only k x batch rows. 1 = classic per-step dispatch.
    "train.steps_per_dispatch": 16,
    # HBM epoch-cache budget (MB): when a FeatureSet's whole epoch
    # (source + one permuted copy, so 2x its nbytes) fits this budget,
    # fit() places the data on device ONCE and reshuffles it on-device
    # per epoch — zero per-epoch H2D — instead of re-transferring every
    # epoch through the chunked/per-step paths. The device tier of the
    # reference's cache hierarchy (FeatureSet.scala:585-662). 0 = off.
    "train.hbm_cache_mb": 2048,
    # Rematerialise the forward pass in the backward (jax.checkpoint):
    # trades ~33% more forward FLOPs for not storing/re-reading most
    # activations — a win when the step is HBM-bandwidth-bound, and
    # the standard lever for fitting longer sequences / bigger batches.
    "train.remat": False,
    # Fused optimizer update (ops/fused.py): grad clip + moment update
    # + param apply in one pass per leaf — replaces the optax
    # global_norm → update → apply_updates triple traversal (three full
    # HBM sweeps of params+grads) for SGD/Adam.  Numerically the optax
    # step (tests/test_fused_kernels.py); unsupported combinations
    # (optimizer groups, other optimizers) fall back automatically.
    "train.fused_optimizer": True,
    # Resilience -------------------------------------------------------
    # Elastic recovery: on a classified lost-host failure, re-form the
    # device mesh on the surviving topology, reshard, and resume from
    # the last snapshot + pipeline position (resilience/recovery.py).
    # Off = lost-host failures fall back to the plain retry budget.
    "train.elastic": True,
    # How many times one train() call may shrink onto a smaller
    # topology before it degrades to checkpoint-and-queue instead.
    "train.max_mesh_reformations": 2,
    # Worker liveness heartbeat (launcher run-dir slots): at most one
    # heartbeat file write per interval; the launcher flags a host
    # whose heartbeat is older than the timeout (ZooCluster
    # .check_health) BEFORE a collective hangs on it.
    "resilience.heartbeat_interval_s": 5.0,
    "resilience.heartbeat_timeout_s": 30.0,
    # AOT compilation / executable cache ------------------------------
    # Route engine-built jits through the AOT fast path (lower once,
    # compile explicitly, dispatch the Compiled).  Off = every
    # engine_jit degrades to plain jax.jit dispatch.
    "compile.aot": True,
    # Persistent executable-cache directory ("" = no explicit dir; the
    # ZOO_TPU_COMPILE_CACHE env overrides, and farm mode below may
    # derive one from the launcher run dir).  A warm directory turns
    # the 141s ResNet-50 cold compile (BENCH_r05) into a ~seconds
    # deserialize.
    "compile.cache_dir": "",
    # Whether this process persists entries (reads are always on when
    # a dir resolves).  Farm mode forces workers read-only.
    "compile.cache_write": True,
    # Cache-directory size cap in MB; oldest-by-recency entries are
    # LRU-evicted past it (compile_cache_evictions_total). 0 = no cap.
    "compile.cache_max_mb": 2048,
    # Compile-farm mode: inside a launcher run dir (ZOO_TPU_RUN_DIR)
    # with no explicit cache dir, host 0 compiles + persists into
    # <run_dir>/compile-cache and workers deserialize instead of
    # recompiling (rides the PR 4 run-dir env contract).
    "compile.farm": True,
    # Input pipeline ---------------------------------------------------
    # Device-batch prefetch depth (background thread overlapping host
    # batch assembly + H2D copy with device compute); 0 places each batch
    # inline.  The port defaults to 0: its eager steps hold the interpreter
    # lock, and on an H100 the thread cost NeuralCF 0.43 ms a step (5.26
    # against 4.83 ms) and BERT-base training nothing it gained
    # (scripts/time_prefetch.py).
    "data.prefetch": 0,
    "data.shuffle_seed": 1,
    # Checkpointing ----------------------------------------------------
    "checkpoint.keep": 5,
    # Logging ----------------------------------------------------------
    "log.level": "INFO",
    # Observability ----------------------------------------------------
    # Span-tracer ring buffer size (complete events kept in memory for
    # /trace and export_chrome_trace).
    "observability.trace_events": 200000,
    # Record the global L2 grad norm as a gauge each step (adds an
    # in-jit norm + a host callback per step — opt-in).
    "observability.grad_norm": False,
    # Background device-telemetry sampling period for long-running
    # services (serving); one-shot samples are free-form.
    "observability.telemetry_interval_s": 10.0,
    # Fold a jnp.isfinite(loss + sum(grads)) reduction into the jitted
    # train step and surface non-finite steps through a host callback
    # (the grad-norm callback path) — the watchdog's NaN detector.
    "observability.check_finite": True,
    # Training-health watchdog: what to do when an unhealthy signal
    # (non-finite loss/grad, loss divergence) fires.
    #   "warn"                log + metrics, keep training
    #   "checkpoint_and_halt" snapshot via the Estimator's checkpoint
    #                         machinery, then raise TrainingHalted
    "observability.watchdog_policy": "warn",
    # Plateau detection: no new best loss (improvement > min_delta *
    # max(|best|, 1)) within this many observed losses => plateau.
    "observability.watchdog_window": 50,
    "observability.watchdog_min_delta": 1e-4,
    # Divergence: loss - best > divergence * max(|best|, 1).
    "observability.watchdog_divergence": 10.0,
    # Stall heartbeat: flag when no train step completes within this
    # many seconds (0 = heartbeat thread off).
    "observability.watchdog_stall_s": 0.0,
    # CompileMonitor: signatures compiled within the first N calls of a
    # wrapped function are expected warmup; a NEW abstract signature
    # after that is recompilation churn (loud structured warning).
    "observability.compile_warmup_calls": 3,
    # Pull XLA cost_analysis() FLOPs/bytes for each newly compiled
    # monitored function into gauges (feeds the live MFU estimate).
    "observability.cost_analysis": True,
    # Sample the dispatch->block_until_ready device bracket every N
    # dispatched steps for step-time attribution + MFU (0 = off; the
    # sampled step pays one device sync).
    "observability.device_time_every": 16,
    # MFU denominator override in FLOP/s (0 = derive from the device
    # kind via benchmarks.PEAK_FLOPS; set explicitly on backends whose
    # peak is unknown, e.g. CPU smoke runs).
    "observability.peak_flops": 0.0,
    # Interface the /metrics endpoint binds (MetricsServer default).
    # UNAUTHENTICATED endpoint: on shared networks set 127.0.0.1 or a
    # scrape-only interface.
    "observability.bind_host": "0.0.0.0",
    # Per-metric label-cardinality ceiling: label combinations past
    # this are accepted but not exported (counted in
    # zoo_metrics_dropped_series_total) so an unbounded label can
    # never OOM the exporter.  0 disables the cap.
    "observability.max_series_per_metric": 1000,
    # Multi-host: at every sampled device step (device_time_every),
    # time a cross-host barrier — the wait measures step skew (the
    # FASTEST host waits longest; the straggler waits ~0).  Feeds
    # train_barrier_wait_seconds and the aggregator's straggler
    # attribution.  Single-process runs never pay it.
    "observability.barrier_probe": True,
    # Account sharding-implied collective traffic (gradient psum, FSDP
    # all-gather, pipeline ppermute) into collective_bytes_total{op}.
    "observability.collectives": True,
    # Per-link interconnect bandwidth in GB/s used to turn collective
    # bytes into estimated collective_seconds_total{op}; 0 disables the
    # time estimate (bytes are still counted).
    "observability.ici_gbps": 0.0,
    # Embedded telemetry time-series store (observability/tsdb.py):
    # a background sampler appends registry snapshots to ring-retained
    # segment files under the worker's run-dir slot — the memory the
    # SLO burn-rate engine and the drift watch read.  Off = the run
    # dir keeps only point-in-time snapshots.
    "observability.tsdb": True,
    # Scrape period (jittered ±20% so a fleet never thunders in
    # phase); flush_worker_observability always appends one more.
    "observability.tsdb_interval_s": 10.0,
    # Ring retention: oldest closed segments are deleted past either
    # bound (bytes across the segment dir / age of the segment).
    "observability.tsdb_retention_mb": 64,
    "observability.tsdb_retention_age_s": 86400.0,
    # Serving readiness (/healthz -> 503): input-stream backlog above
    # which the worker reports not-ready (0 = disabled) and the error
    # fraction over the most recent records (0 = disabled).
    "serving.healthz_max_queue": 0,
    "serving.healthz_max_error_rate": 0.0,
    # Result-write backpressure: bounded attempts (exponential backoff
    # with jitter between them) before a result write is abandoned to
    # the dead-letter stream instead of crashing the worker loop.
    "serving.result_write_retries": 8,
}

_ENV_PREFIX = "ZOO_TPU_"


def _parse_value(raw: str) -> Any:
    s = raw.strip()
    low = s.lower()
    if low in ("true", "false"):
        return low == "true"
    try:
        return int(s)
    except ValueError:
        pass
    try:
        return float(s)
    except ValueError:
        pass
    return s


def _read_conf_file(path: str) -> Dict[str, Any]:
    """Read a ``key value`` / ``key=value`` conf file (same shape as the
    reference's spark-analytics-zoo.conf)."""
    out: Dict[str, Any] = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            if "=" in line:
                k, v = line.split("=", 1)
            else:
                parts = line.split(None, 1)
                if len(parts) != 2:
                    continue
                k, v = parts
            out[k.strip()] = _parse_value(v)
    return out


class ZooConfig:
    """Resolved configuration with the four-layer precedence."""

    def __init__(self, conf_file: Optional[str] = None,
                 overrides: Optional[Dict[str, Any]] = None):
        self._values: Dict[str, Any] = dict(_DEFAULTS)
        # Layer 2: conf file.
        if conf_file is None:
            for cand in ("zoo-tpu.conf", os.path.expanduser("~/.zoo-tpu.conf")):
                if os.path.isfile(cand):
                    conf_file = cand
                    break
        if conf_file and os.path.isfile(conf_file):
            self._values.update(_read_conf_file(conf_file))
        # Layer 3: environment. ZOO_TPU_TRAIN_RETRY_TIMES → train.retry_times
        for env_key, raw in os.environ.items():
            if env_key.startswith(_ENV_PREFIX):
                key = env_key[len(_ENV_PREFIX):].lower().replace("_", ".", 1)
                # Only the first underscore becomes a dot; the rest stay.
                self._values[key] = _parse_value(raw)
        # Layer 4: programmatic overrides. Tracked separately so a
        # later context (re-)init can carry them into its fresh config
        # — a user's get_config().set(...) must survive the lazy
        # init_zoo_context that a first fit() triggers.
        self._programmatic: Dict[str, Any] = {}
        if overrides:
            self._values.update(overrides)
            self._programmatic.update(overrides)

    def get(self, key: str, default: Any = None) -> Any:
        return self._values.get(key, default)

    def __getitem__(self, key: str) -> Any:
        return self._values[key]

    def __contains__(self, key: str) -> bool:
        return key in self._values

    def set(self, key: str, value: Any) -> None:
        self._values[key] = value
        self._programmatic[key] = value

    def as_dict(self) -> Dict[str, Any]:
        return dict(self._values)


_global_config: Optional[ZooConfig] = None


def get_config() -> ZooConfig:
    global _global_config
    if _global_config is None:
        _global_config = ZooConfig()
    return _global_config


def reset_config() -> None:
    """Drop the global config so the next get_config() starts from
    defaults/conf/env with no programmatic layer (test helper)."""
    global _global_config
    _global_config = None


def set_config(cfg: ZooConfig) -> None:
    global _global_config
    _global_config = cfg
