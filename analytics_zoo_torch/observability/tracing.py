"""Span tracer: nested, thread-safe ``span("name")`` context managers
exported as Chrome-trace-format JSON (load in Perfetto / chrome://tracing).

The reference's time visibility was coarse Spark-side ``Utils.timeIt``
log lines; ``torch.profiler`` covers the device side but not host
orchestration (batch assembly, checkpoint IO, Redis round trips).  Spans
fill that gap: a bounded in-memory ring of complete ("ph":"X") events,
cheap enough to leave on in production (two perf_counter reads and a
deque append per span).

Interval math uses ``time.perf_counter`` (monotonic); the wall-clock
epoch is recorded once so exported timestamps still line up with log
timestamps.

``span(..., device_annotation=True)`` additionally brackets the block
with ``torch.profiler.record_function`` so the same name shows up inside
a captured device profile, and :meth:`Tracer.profiler_trace` brackets a
block with a ``torch.profiler`` capture.  They replace the JAX package's
``jax_annotation=`` keyword (``jax.profiler.TraceAnnotation``) and its
``jax_trace`` method (``jax.profiler.start_trace``).
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from collections import deque
from typing import Dict, List, Optional


class Tracer:
    """Collects complete-span events into a bounded ring buffer.

    Nesting is tracked per-thread (a thread-local span stack) so
    concurrent serving/prefetch threads trace independently; Perfetto
    renders nesting from timestamp containment per tid, which the
    stack discipline guarantees.
    """

    def __init__(self, max_events: int = 200_000):
        self._events: deque = deque(maxlen=max_events)
        self._local = threading.local()
        self._lock = threading.Lock()
        # perf_counter origin pinned to a wall-clock instant so exported
        # ts values are "us since tracer start" and displayable
        self._t0 = time.perf_counter()
        self._wall0 = time.time()
        self.enabled = True

    # ------------------------------------------------------------- spans
    def _stack(self) -> List[str]:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    @contextlib.contextmanager
    def span(self, name: str, device_annotation: bool = False, **args):
        """Time a block as one trace event.  ``args`` become the
        event's Chrome-trace ``args`` dict (values must be
        JSON-serializable)."""
        if not self.enabled:
            yield self
            return
        ctx = contextlib.nullcontext()
        if device_annotation:
            try:
                import torch.profiler
                ctx = torch.profiler.record_function(name)
            except Exception:  # profiler unavailable — span still records
                pass
        stack = self._stack()
        stack.append(name)
        start = time.perf_counter()
        try:
            with ctx:
                yield self
        finally:
            dur = time.perf_counter() - start
            stack.pop()
            # the ring lock pairs with events()/clear(): appends must
            # not rely on the GIL for exclusion (free-threaded builds)
            with self._lock:
                self._events.append({
                    "name": name,
                    "ph": "X",
                    "ts": (start - self._t0) * 1e6,
                    "dur": dur * 1e6,
                    "pid": os.getpid(),
                    "tid": threading.get_ident(),
                    **({"args": args} if args else {}),
                })

    def complete(self, name: str, start_perf: float, duration_s: float,
                 **args) -> None:
        """Record a complete span from explicit timing (non-lexical
        scopes — e.g. an epoch whose end is reached via several code
        paths).  ``start_perf`` is a ``time.perf_counter()`` reading."""
        if not self.enabled:
            return
        with self._lock:
            self._events.append({
                "name": name, "ph": "X",
                "ts": (start_perf - self._t0) * 1e6,
                "dur": duration_s * 1e6,
                "pid": os.getpid(), "tid": threading.get_ident(),
                **({"args": args} if args else {}),
            })

    def instant(self, name: str, **args) -> None:
        """A zero-duration marker event (``ph: "i"``)."""
        if not self.enabled:
            return
        with self._lock:
            self._events.append({
                "name": name, "ph": "i", "s": "t",
                "ts": (time.perf_counter() - self._t0) * 1e6,
                "pid": os.getpid(), "tid": threading.get_ident(),
                **({"args": args} if args else {}),
            })

    def flow_start(self, name: str, flow_id: str, **args) -> None:
        """Open a flow (``ph: "s"``) — a causal arrow OUT of the
        enclosing slice on this thread.  Pair with :meth:`flow_end`
        under the same ``flow_id`` on the receiving thread and
        Perfetto draws the arrow across the two lanes (e.g. a serving
        request handed from its transport thread to the batcher's
        executor thread).  ``cat`` is mandatory on flow events."""
        self._flow(name, flow_id, "s", args)

    def flow_end(self, name: str, flow_id: str, **args) -> None:
        """Close a flow (``ph: "f"`` with ``bp: "e"`` — bind to the
        ENCLOSING slice, the post-Chrome-M47 convention Perfetto
        expects)."""
        self._flow(name, flow_id, "f", args)

    def _flow(self, name: str, flow_id: str, ph: str, args) -> None:
        if not self.enabled:
            return
        ev = {
            "name": name, "ph": ph, "cat": "flow",
            "id": str(flow_id),
            "ts": (time.perf_counter() - self._t0) * 1e6,
            "pid": os.getpid(), "tid": threading.get_ident(),
        }
        if ph == "f":
            ev["bp"] = "e"
        if args:
            ev["args"] = dict(args)
        with self._lock:
            self._events.append(ev)

    def current_span(self) -> Optional[str]:
        stack = self._stack()
        return stack[-1] if stack else None

    def depth(self) -> int:
        return len(self._stack())

    # ------------------------------------------------------------ export
    def events(self) -> List[Dict]:
        with self._lock:
            return list(self._events)

    def chrome_trace(self) -> Dict:
        """The Chrome trace 'JSON Object Format': Perfetto and
        chrome://tracing both load it directly."""
        return {
            "traceEvents": self.events(),
            "displayTimeUnit": "ms",
            "otherData": {
                "wall_time_origin": self._wall0,
                "producer": "analytics_zoo_torch.observability",
            },
        }

    def export_chrome_trace(self, path: str) -> str:
        """Write the trace JSON; returns the path (``.json`` — open in
        https://ui.perfetto.dev or chrome://tracing)."""
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.chrome_trace(), f)
        return path

    def clear(self) -> None:
        with self._lock:
            self._events.clear()

    # ------------------------------------------------- torch profiler tie
    @contextlib.contextmanager
    def profiler_trace(self, log_dir: str, name: str = "torch_profile"):
        """Bracket a block with BOTH a span and a ``torch.profiler``
        capture (CPU, and CUDA when a card is present): the span records
        where the capture sits in host time; ``<log_dir>/<name>.json``
        holds the profiler's Chrome trace with the device timeline (view
        either in Perfetto)."""
        import torch
        from torch.profiler import ProfilerActivity, profile
        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        os.makedirs(log_dir, exist_ok=True)
        with self.span(name, log_dir=log_dir):
            with profile(activities=activities) as prof:
                yield prof
            prof.export_chrome_trace(os.path.join(log_dir, f"{name}.json"))


_global_tracer: Optional[Tracer] = None
_tracer_lock = threading.Lock()


def get_tracer() -> Tracer:
    global _global_tracer
    if _global_tracer is None:
        with _tracer_lock:
            if _global_tracer is None:
                max_events = 200_000
                try:
                    from analytics_zoo_torch.common.config import get_config
                    max_events = int(get_config().get(
                        "observability.trace_events", 200_000))
                except Exception:
                    pass
                _global_tracer = Tracer(max_events=max_events)
    return _global_tracer


def reset_tracer() -> None:
    """Drop the process-wide tracer (test helper)."""
    global _global_tracer
    with _tracer_lock:
        _global_tracer = None


def span(name: str, **kwargs):
    """Module-level convenience: ``with span("train_step"): ...`` on
    the process-wide tracer."""
    return get_tracer().span(name, **kwargs)
