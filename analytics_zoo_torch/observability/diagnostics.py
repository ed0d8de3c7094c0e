"""Training-health diagnostics, the compile half (port of
``observability/diagnostics.py``).

* :class:`CompileMonitor` wraps engine-built programs and counts
  compilations (new abstract signatures; in the port a capture into a
  CUDA graph, with its first call's wall seconds) per function, warns
  loudly on recompilation churn after a warm-up, and accounts the
  persistent cache's hits and misses (``record_cache_event``).
* :func:`step_attribution_histogram`: the shared
  ``train_step_time_seconds{component}`` family.

Not ported: the MFU half (``publish_mfu`` needs the benchmarks' peak
table, ROADMAP queue 1 item 9) and the cost analysis: XLA's
``cost_analysis`` has no counterpart on a CUDA graph, so ``flops``
returns None.  Everything here degrades to "fewer gauges", never to an
exception on a hot path.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Any, Dict, Optional, Tuple

from analytics_zoo_torch.observability.metrics import (
    MetricsRegistry, get_registry)

log = logging.getLogger("analytics_zoo_torch.observability")

# Components of one wall-clock training step.
STEP_COMPONENTS = ("data_wait", "host_dispatch", "device")


def step_attribution_histogram(registry: Optional[MetricsRegistry] = None):
    """The shared step-time attribution family."""
    reg = registry if registry is not None else get_registry()
    return reg.histogram(
        "train_step_time_seconds",
        "wall-clock step decomposition: data_wait = host wait for the "
        "next device batch; host_dispatch = python + dispatch wall; "
        "device = dispatch->synchronize bracket",
        labels=("component",))


def _short_signature(sig: Tuple, limit: int = 400) -> str:
    s = repr(sig)
    return s if len(s) <= limit else s[:limit] + "..."


def _tree_leaves(tree, out):
    if isinstance(tree, dict):
        for k in sorted(tree):
            _tree_leaves(tree[k], out)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _tree_leaves(v, out)
    else:
        out.append(tree)
    return out


def abstract_signature(args: Tuple) -> Tuple:
    """Shape/dtype key of a call's arguments.  Cheap: no device sync."""
    leaves = []
    for a in _tree_leaves(args, []):
        if a is None:
            leaves.append(None)
        elif hasattr(a, "shape") and hasattr(a, "dtype"):
            leaves.append((tuple(a.shape), str(a.dtype)))
        else:
            leaves.append(type(a).__name__)
    return tuple(leaves)


class _MonitoredJit:
    """An engine-built callable with per-signature compile tracking;
    unknown attributes (``warm``, ``aot``, ``aot_signatures``,
    ``captures``) forward to it."""

    STABLE_STREAK = 32
    CHECK_EVERY = 8

    def __init__(self, monitor: "CompileMonitor", name: str, fn):
        self._monitor = monitor
        self._name = name
        self._fn = fn
        self._signatures: set = set()
        self._calls = 0
        self._stable_streak = 0

    def __call__(self, *args):
        mon, name = self._monitor, self._name
        check = (self._stable_streak < self.STABLE_STREAK
                 or self._calls % self.CHECK_EVERY == 0)
        is_new = False
        key = None
        if check:
            try:
                key = abstract_signature(args)
                is_new = key not in self._signatures
            except Exception:   # noqa: BLE001
                key, is_new = None, False
        t0 = time.perf_counter()
        out = self._fn(*args)
        if is_new:
            self._signatures.add(key)
            self._stable_streak = 0
            mon._record_compile(
                name, key, time.perf_counter() - t0,
                calls_before=self._calls,
                warmed_up=self._calls >= mon.warmup_calls,
                n_signatures=len(self._signatures))
        elif check:
            self._stable_streak += 1
        self._calls += 1
        return out

    def __getattr__(self, item):
        return getattr(self._fn, item)


class CompileMonitor:
    """Per-function compile accounting over the shared registry: each
    call whose abstract signature the wrapper has not seen counts as a
    compilation (``jax_compiles_total`` and ``jax_compile_seconds_total``,
    the reference's names; the seconds are the first call's wall, which
    in the port holds the warm-up and the capture); signatures after
    ``warmup_calls`` calls are recompilation churn and warn once each."""

    def __init__(self, warmup_calls: Optional[int] = None,
                 cost_analysis: Optional[bool] = None,
                 registry: Optional[MetricsRegistry] = None):
        if warmup_calls is None:
            try:
                from analytics_zoo_torch.common.config import get_config
                warmup_calls = int(get_config().get(
                    "observability.compile_warmup_calls", 3))
            except Exception:   # noqa: BLE001
                warmup_calls = 3
        self.warmup_calls = int(warmup_calls)
        # no cost analysis exists for a CUDA graph; kept for the signature
        self.cost_analysis = bool(cost_analysis)
        self._registry = registry
        self._lock = threading.Lock()
        self._stats: Dict[str, Dict[str, Any]] = {}

    def _reg(self) -> MetricsRegistry:
        return self._registry if self._registry is not None \
            else get_registry()

    def wrap(self, name: str, jitted) -> _MonitoredJit:
        return _MonitoredJit(self, name, jitted)

    def _state(self, name: str) -> Dict[str, Any]:
        st = self._stats.get(name)
        if st is None:
            st = self._stats.setdefault(name, {
                "compiles": 0, "recompiles_after_warmup": 0,
                "compile_seconds": 0.0, "flops": None, "bytes": None})
        return st

    def _record_compile(self, name: str, key, wall_s: float,
                        calls_before: int, warmed_up: bool,
                        n_signatures: int) -> None:
        reg = self._reg()
        with self._lock:
            st = self._state(name)
            st["compiles"] += 1
            st["compile_seconds"] += wall_s
            if warmed_up:
                st["recompiles_after_warmup"] += 1
        reg.counter(
            "jax_compiles_total",
            "compilations observed per monitored function (new abstract "
            "signatures; a CUDA-graph capture in the port)",
            labels=("fn",)).labels(name).inc()
        reg.counter(
            "jax_compile_seconds_total",
            "first-call wall seconds per new signature (upper bound on "
            "compile time; includes the first execution)",
            labels=("fn",)).labels(name).inc(wall_s)
        if warmed_up:
            reg.counter(
                "jax_recompiles_total",
                "compilations AFTER the warmup — recompilation churn",
                labels=("fn",)).labels(name).inc()
            log.warning(
                "recompilation churn: %r compiled signature #%d on call %d "
                "(after its %d-call warmup), %.2fs — a shape/dtype is "
                "drifting between steps; offending abstract signature: %s",
                name, n_signatures, calls_before + 1, self.warmup_calls,
                wall_s, _short_signature(key))
        else:
            log.info("compiled %r signature #%d in %.2fs (call %d)",
                     name, n_signatures, wall_s, calls_before + 1)

    def record_cache_event(self, name: str, hit: bool,
                           seconds: Optional[float] = None) -> None:
        """Persistent-cache accounting: hits and misses per artifact, and
        the load seconds on hits (the warm-start cost that replaces a
        build)."""
        reg = self._reg()
        with self._lock:
            st = self._state(name)
            st["cache_hits"] = st.get("cache_hits", 0) + (1 if hit else 0)
            st["cache_misses"] = st.get("cache_misses", 0) + \
                (0 if hit else 1)
            if hit and seconds is not None:
                st["cache_load_seconds"] = \
                    st.get("cache_load_seconds", 0.0) + seconds
        if hit:
            reg.counter(
                "compile_cache_hits_total",
                "persistent cache hits (loaded instead of built)",
                labels=("fn",)).labels(name).inc()
            if seconds is not None:
                reg.counter(
                    "compile_cache_load_seconds",
                    "seconds spent loading cached artifacts",
                    labels=("fn",)).labels(name).inc(seconds)
        else:
            reg.counter(
                "compile_cache_misses_total",
                "persistent cache misses (full build paid)",
                labels=("fn",)).labels(name).inc()

    def flops(self, name: str) -> Optional[float]:
        """None: a CUDA graph has no cost analysis."""
        return None

    def stats(self, name: Optional[str] = None) -> Dict[str, Any]:
        with self._lock:
            if name is not None:
                return dict(self._stats.get(name, {}))
            return {k: dict(v) for k, v in self._stats.items()}


_global_monitor: Optional[CompileMonitor] = None
_monitor_lock = threading.Lock()


def get_compile_monitor() -> CompileMonitor:
    """The process-wide monitor the training engine wraps through."""
    global _global_monitor
    if _global_monitor is None:
        with _monitor_lock:
            if _global_monitor is None:
                _global_monitor = CompileMonitor()
    return _global_monitor


def reset_compile_monitor() -> None:
    """Drop the process-wide monitor (test helper)."""
    global _global_monitor
    with _monitor_lock:
        _global_monitor = None
