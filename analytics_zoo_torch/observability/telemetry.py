"""Device telemetry: sample accelerator memory into registry gauges.

Answers "where does the memory go" — the half of the ROADMAP north-star
the step timers can't see.  The JAX package reads ``memory_stats()`` of
each device, a census of live ``jax.Array`` objects and the size of its
jit cache; here the CUDA caching allocator's counters of the zoo
context's device take their place: ``torch.cuda.memory_allocated``,
``memory_reserved`` and ``max_memory_allocated``.  A context on the CPU
(the tests) has no device gauges, and a process with no context yet
samples nothing — telemetry must degrade to "fewer gauges", never to an
exception on a hot path.
"""

from __future__ import annotations

import logging
import threading
from typing import Dict, Optional

from analytics_zoo_torch.observability.metrics import (
    MetricsRegistry, get_registry)

log = logging.getLogger("analytics_zoo_torch.observability")

# torch.cuda allocator counters worth exporting, mapped to gauge names
_MEM_FNS = {
    "memory_allocated": "device_bytes_in_use",
    "max_memory_allocated": "device_peak_bytes_in_use",
    "memory_reserved": "device_pool_bytes",
}


def _context_device():
    """The zoo context's device when one is initialised, else None
    (sampling never creates a context: that would claim a card)."""
    from analytics_zoo_torch.common import zoo_context
    ctx = zoo_context._context
    return ctx.device if ctx is not None else None


def sample_device_telemetry(registry: Optional[MetricsRegistry] = None
                            ) -> Dict[str, float]:
    """One sampling pass: set the gauges and return what was sampled
    (a plain dict, handy for logging/tests).  Never raises; a context
    on the CPU samples nothing."""
    reg = registry if registry is not None else get_registry()
    sampled: Dict[str, float] = {}
    try:
        device = _context_device()
        if device is None or device.type != "cuda":
            return sampled
        import torch
        label = str(device.index or 0)
        for fn_name, gname in _MEM_FNS.items():
            value = float(getattr(torch.cuda, fn_name)(device))
            reg.gauge(gname, f"torch.cuda.{fn_name}() of the device",
                      labels=("device",)).labels(label).set(value)
            sampled[f"{gname}{{{label}}}"] = value
    except Exception:
        log.debug("device telemetry sample failed", exc_info=True)
    return sampled


class TelemetrySampler:
    """Background sampler: calls :func:`sample_device_telemetry` every
    ``interval_s`` until stopped.  Daemon thread, safe to abandon."""

    def __init__(self, interval_s: float = 10.0,
                 registry: Optional[MetricsRegistry] = None):
        self.interval_s = float(interval_s)
        self.registry = registry
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "TelemetrySampler":
        if self._thread is not None:
            return self
        self._stop.clear()   # restartable after stop()
        self._thread = threading.Thread(
            target=self._run, daemon=True,
            name="zoo-telemetry-sampler")
        self._thread.start()
        return self

    def _run(self) -> None:
        while not self._stop.is_set():
            sample_device_telemetry(self.registry)
            self._stop.wait(self.interval_s)

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
