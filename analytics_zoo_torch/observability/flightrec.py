"""Black-box flight recorder: structured lifecycle events.

The platform's control planes already *narrate* their decisions —
replica restarts, mesh reformations, lease steals, breaker trips,
scale decisions, quarantines — but as ad-hoc log lines and counters
scattered across processes.  This module gives those narrations one
structured spine: every subsystem reports lifecycle events through
:func:`record_event`, which

* keeps a bounded in-memory **ring** (the last-N context a blackbox
  dump embeds),
* spools each event **incrementally** to a crash-safe append-only
  ``host-<k>/events.jsonl`` journal with the same torn-tail
  discipline as ``tsdb.py`` — one flushed line per event, reopen
  seals a torn final line, readers skip unparseable lines — so even
  ``SIGKILL`` (chaos ``kill`` uses ``os._exit``; no atexit runs)
  leaves the journal readable up to the torn tail, and
* on orderly shutdown / fatal signal / unhandled exception dumps an
  enriched ``host-<k>/blackbox.json`` — last-N events, final registry
  snapshot, active request timelines, all-thread stacks (the
  ``faulthandler`` view, captured via ``sys._current_frames`` so it
  lands in JSON; genuinely fatal C-level signals are covered by
  ``faulthandler.enable`` into ``fatal.log``) — via atomic
  write-then-rename.

Journal format: the first line of each writer session is a header
(``{"events_schema": 1, ...}``) carrying pid/role/clock anchor; event
lines carry ``t`` (wall clock, clamped non-decreasing per session),
``seq`` (strictly increasing per session), ``kind`` (from the closed
:data:`EVENT_KINDS` vocabulary — ``metrics_lint --events`` enforces
it) and a ``d`` detail dict.  A respawn into the same slot appends a
new header; readers treat each header as a new session.

CONTRACT: stdlib-only at module level, loadable by file path (the
``aggregator.py``/``tsdb.py`` contract) so ``zoo-doctor`` and
``obs_report --incident`` read journals without importing jax.
"""

from __future__ import annotations

import atexit
import json
import os
import signal as _signal
import sys
import threading
import time
import traceback
from collections import deque
from typing import Any, Callable, Dict, List, Optional

__all__ = [
    "EVENTS_SCHEMA",
    "EVENTS_FILENAME",
    "BLACKBOX_FILENAME",
    "EVENT_KINDS",
    "FlightRecorder",
    "flush_active_flightrec",
    "get_active_flightrec",
    "init_flightrec",
    "install_blackbox_hooks",
    "read_events",
    "read_journal",
    "record_event",
    "reset_flightrec",
]

EVENTS_SCHEMA = 1
EVENTS_FILENAME = "events.jsonl"
BLACKBOX_FILENAME = "blackbox.json"
FATAL_LOG_FILENAME = "fatal.log"

# local twins of the launcher's env contract (stdlib-only module: no
# package imports) — names must match parallel/launcher.py
ENV_METRICS_DIR = "ZOO_TPU_METRICS_DIR"
ENV_PROCESS_ID = "ZOO_TPU_PROCESS_ID"
ENV_CLOCK_ANCHOR = "ZOO_TPU_CLOCK_ANCHOR"

# The closed event vocabulary.  ``metrics_lint --events`` flags any
# journal line whose kind is not listed here — add the kind AND its
# docs/observability.md row when a new subsystem joins.
EVENT_KINDS = frozenset({
    # serving fleet lifecycle (serving/supervisor.py)
    "replica.spawn",        # a replica process (re)spawned
    "replica.exit",         # a replica exited, with classification
    "replica.retire",       # deliberate scale-down retirement
    "replica.kill",         # supervisor killed a replica (wedge/retire)
    "fleet.degraded",       # restart budget exhausted -> degraded.json
    "scale.up",             # autoscale decision, with its signals
    "scale.down",
    # serving data plane (serving/redis_client.py, serving/server.py)
    "breaker.transition",   # circuit breaker state change
    "quarantine",           # poison record -> dead-letter stream
    "dead_letter",          # non-shed dead letter (write_abandoned/poison)
    # elastic training (pipeline/estimator recovery loop)
    "train.failure",        # step failure, with detector classification
    "train.retry",          # policy decided RETRY
    "mesh.reform",          # mesh re-formed on the survivors
    "train.degraded",       # policy decided DEGRADE (checkpoint+queue)
    # batch tier (batchjobs/coordinator.py, batchjobs/manifest.py)
    "worker.respawn",       # coordinator respawned a dead worker
    "lease.claim",          # shard lease claimed (O_EXCL winner)
    "lease.steal",          # expired lease stolen, with recompute debt
    "lease.lost",           # renewal discovered the lease was stolen
    # watchdog + chaos (observability/watchdog.py, resilience/chaos.py)
    "watchdog.episode",     # nonfinite/divergence/plateau/stall/drift
    "chaos.trip",           # an armed fault fired at its site
    # recorder lifecycle
    "recorder.start",
    "blackbox.dump",
})


def _jsonable(value: Any) -> Any:
    """Best-effort coercion so a recorder call can never raise on an
    exotic detail value (events are forensics — drop fidelity, not
    the event)."""
    if isinstance(value, (str, int, float, bool)) or value is None:
        return value
    if isinstance(value, dict):
        return {str(k): _jsonable(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [_jsonable(v) for v in value]
    return str(value)


# ------------------------------------------------------------- recorder
class FlightRecorder:
    """Bounded event ring + append-only journal for one process.

    One recorder owns one directory (conventionally the worker's
    ``<run_dir>/host-<k>`` slot; control planes like the supervisor
    and batch coordinator point one at the run dir itself).  With no
    directory the ring still records — blackbox-on-demand and tests
    work without a run dir.  Thread-safe."""

    def __init__(self, directory: Optional[str] = None, *,
                 ring_size: int = 512,
                 role: str = "worker",
                 process_index: Optional[int] = None,
                 clock_anchor: Optional[float] = None,
                 clock: Callable[[], float] = time.time):
        self.dir = directory
        self.role = role
        self.process_index = process_index
        self.clock_anchor = clock_anchor
        self._clock = clock
        self._lock = threading.Lock()
        self._ring: deque = deque(maxlen=int(ring_size))
        self._seq = 0
        self._last_t = 0.0
        self._f = None
        self.path: Optional[str] = None
        self.events_total = 0
        self.dropped_writes = 0
        self._costs: deque = deque(maxlen=512)
        self._dumped_fatal = False
        if directory:
            self.path = os.path.join(directory, EVENTS_FILENAME)
            self._open_journal()

    # -- journal lifecycle -------------------------------------------
    def _open_journal(self) -> None:
        try:
            os.makedirs(self.dir, exist_ok=True)
            self._f = open(self.path, "a")
            self._seal_torn_line()
            header: Dict[str, Any] = {
                "events_schema": EVENTS_SCHEMA,
                "created": self._clock(),
                "pid": os.getpid(),
                "role": self.role,
            }
            if self.process_index is not None:
                header["process_index"] = int(self.process_index)
            if self.clock_anchor is not None:
                header["clock_anchor"] = float(self.clock_anchor)
            self._f.write(json.dumps(header, sort_keys=True) + "\n")
            self._f.flush()
        except OSError:
            # a broken spool must never break the subsystem recording
            # into it — fall back to ring-only
            self._f = None
            self.dropped_writes += 1

    def _seal_torn_line(self) -> None:
        """Same discipline as ``TsdbWriter``: a crash mid-append can
        leave a torn final line; start this writer's records on a fresh line so
        the torn record corrupts only itself."""
        try:
            if self._f is not None and self._f.tell() > 0:
                with open(self.path, "rb") as rf:
                    rf.seek(-1, os.SEEK_END)
                    if rf.read(1) != b"\n":
                        self._f.write("\n")
                        self._f.flush()
        except OSError:
            pass

    # -- appends ------------------------------------------------------
    def record(self, kind: str, /, **detail: Any) -> Dict[str, Any]:
        """Record one lifecycle event: ring + one flushed journal
        line.  Returns the event record (its ``seq`` is the id
        evidence citations use).  Never raises."""
        t0 = time.perf_counter()
        now = self._clock()
        with self._lock:
            self._seq += 1
            # non-decreasing within a session: the lint checks it, and
            # a small NTP step must not make the journal look torn
            if now < self._last_t:
                now = self._last_t
            self._last_t = now
            rec: Dict[str, Any] = {
                "t": round(now, 6), "seq": self._seq, "kind": str(kind)}
            if detail:
                rec["d"] = _jsonable(detail)
            self._ring.append(rec)
            self.events_total += 1
            if self._f is not None:
                try:
                    self._f.write(json.dumps(rec, sort_keys=True) + "\n")
                    self._f.flush()
                except (OSError, ValueError):
                    self.dropped_writes += 1
        self._costs.append(time.perf_counter() - t0)
        return rec

    def recent_events(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._ring)

    def overhead_p50(self) -> float:
        """Median wall cost of one ``record()`` — the bench
        ``flightrec_p50_overhead_fraction`` self-gate input."""
        if not self._costs:
            return 0.0
        costs = sorted(self._costs)
        return costs[len(costs) // 2]

    # -- blackbox -----------------------------------------------------
    def dump_blackbox(self, reason: str, *,
                      registry_snapshot: Optional[Dict[str, Any]] = None,
                      request_snapshot: Optional[Dict[str, Any]] = None,
                      error: Optional[str] = None,
                      fatal: bool = False) -> Optional[str]:
        """Write the enriched ``blackbox.json`` via atomic
        write-then-rename; returns its path (None without a spool
        dir).  A fatal dump (exception/signal) wins over a later
        orderly-shutdown dump — atexit skips once a fatal dump
        landed, so the crash picture is never papered over."""
        if self.dir is None:
            return None
        with self._lock:
            if fatal:
                self._dumped_fatal = True
            elif self._dumped_fatal:
                return None
            events = list(self._ring)
            doc: Dict[str, Any] = {
                "blackbox_schema": 1,
                "written": self._clock(),
                "reason": reason,
                "pid": os.getpid(),
                "role": self.role,
                "process_index": self.process_index,
                "clock_anchor": self.clock_anchor,
                "events_total": self.events_total,
                "dropped_writes": self.dropped_writes,
                "events": events,
            }
        if error:
            doc["error"] = error
        if registry_snapshot is not None:
            doc["registry"] = _jsonable(registry_snapshot)
        if request_snapshot is not None:
            doc["requests"] = _jsonable(request_snapshot)
        doc["stacks"] = _thread_stacks()
        path = os.path.join(self.dir, BLACKBOX_FILENAME)
        tmp = f"{path}.tmp.{os.getpid()}"
        try:
            with open(tmp, "w") as f:
                json.dump(doc, f, sort_keys=True, default=str)
            os.replace(tmp, path)
        except OSError:
            return None
        return path

    def close(self) -> None:
        with self._lock:
            if self._f is not None:
                try:
                    self._f.close()
                except OSError:
                    pass
                self._f = None


def _thread_stacks() -> Dict[str, List[str]]:
    """Every live thread's Python stack, JSON-shaped — the same view
    ``faulthandler.dump_traceback`` prints, via
    ``sys._current_frames`` so it embeds in the blackbox document."""
    names = {t.ident: t.name for t in threading.enumerate()}
    out: Dict[str, List[str]] = {}
    for ident, frame in sys._current_frames().items():
        label = f"{names.get(ident, 'thread')}:{ident}"
        out[label] = [line.rstrip("\n")
                      for line in traceback.format_stack(frame)]
    return out


# -------------------------------------------------------------- reader
def read_journal(path: str) -> Dict[str, Any]:
    """Parse one ``events.jsonl``: header sessions, events, and the
    torn-tail verdict.  A torn FINAL line is the crash-safety
    contract working (``torn_tail`` True, not an error); unparseable
    non-final lines are counted in ``skipped``."""
    headers: List[Dict[str, Any]] = []
    events: List[Dict[str, Any]] = []
    skipped = 0
    torn_tail = False
    try:
        with open(path) as f:
            raw = f.read()
    except OSError:
        return {"headers": headers, "events": events,
                "skipped": 0, "torn_tail": False}
    ends_complete = raw.endswith("\n")
    lines = [ln for ln in raw.split("\n") if ln.strip()]
    for i, line in enumerate(lines):
        try:
            rec = json.loads(line)
        except json.JSONDecodeError:
            if i == len(lines) - 1 and not ends_complete:
                torn_tail = True
            else:
                skipped += 1
            continue
        if not isinstance(rec, dict):
            skipped += 1
            continue
        if "events_schema" in rec:
            headers.append(rec)
        elif "t" in rec and "kind" in rec:
            if headers:
                rec["session"] = len(headers) - 1
            events.append(rec)
        else:
            skipped += 1
    return {"headers": headers, "events": events,
            "skipped": skipped, "torn_tail": torn_tail}


def journal_paths(directory: str) -> List[tuple]:
    """``(stream, path)`` pairs for every journal under a run dir (the
    control plane's top-level ``events.jsonl`` plus each
    ``host-<k>/events.jsonl``), or a single host slot / file."""
    out: List[tuple] = []
    if os.path.isfile(directory):
        return [(os.path.basename(os.path.dirname(directory)) or "run",
                 directory)]
    top = os.path.join(directory, EVENTS_FILENAME)
    if os.path.isfile(top):
        out.append(("run", top))
    try:
        names = sorted(os.listdir(directory))
    except OSError:
        return out
    for name in names:
        if not name.startswith("host-"):
            continue
        p = os.path.join(directory, name, EVENTS_FILENAME)
        if os.path.isfile(p):
            out.append((name, p))
    return out


def read_events(directory: str) -> List[Dict[str, Any]]:
    """All events under a run dir (or host slot, or single journal),
    time-ordered, each tagged ``stream`` (source journal) and ``id``
    (``<stream>/e<seq>`` — the citation key ``zoo-doctor`` evidence
    uses)."""
    out: List[Dict[str, Any]] = []
    for stream, path in journal_paths(directory):
        parsed = read_journal(path)
        for ev in parsed["events"]:
            ev = dict(ev)
            ev["stream"] = stream
            ev["id"] = f"{stream}/e{ev.get('seq', '?')}"
            out.append(ev)
    out.sort(key=lambda e: (float(e.get("t", 0.0)), e.get("id", "")))
    return out


# ----------------------------------------------------- process wiring
_active_lock = threading.Lock()
_active_recorder: Optional[FlightRecorder] = None
_hooks_installed = False
_prev_excepthook = None


def init_flightrec(directory: Optional[str], *,
                   ring_size: int = 512,
                   role: str = "worker",
                   process_index: Optional[int] = None,
                   clock_anchor: Optional[float] = None,
                   install_hooks: bool = True) -> FlightRecorder:
    """Install the process-wide recorder (idempotent per dir) —
    called by ``init_worker_observability`` for the worker's run-dir
    slot.  Control planes owning their own run dir (supervisor, batch
    coordinator) construct private :class:`FlightRecorder` instances
    instead and leave the process-wide slot to the worker."""
    global _active_recorder
    with _active_lock:
        if (_active_recorder is not None
                and _active_recorder.dir == directory):
            return _active_recorder
        if _active_recorder is not None:
            _active_recorder.close()
        _active_recorder = FlightRecorder(
            directory, ring_size=ring_size, role=role,
            process_index=process_index, clock_anchor=clock_anchor)
    _active_recorder.record(
        "recorder.start", role=role,
        process_index=process_index if process_index is not None else -1)
    if install_hooks:
        install_blackbox_hooks()
    return _active_recorder


def get_active_flightrec(create: bool = True) -> Optional[FlightRecorder]:
    """The process-wide recorder; lazily created on first use so a
    subprocess that never ran ``init_worker_observability`` (batch
    worker, chaos victim) still journals into its
    ``ZOO_TPU_METRICS_DIR`` slot — or ring-only without one."""
    global _active_recorder
    with _active_lock:
        if _active_recorder is not None or not create:
            return _active_recorder
    directory = os.environ.get(ENV_METRICS_DIR) or None
    proc_id: Optional[int] = None
    anchor: Optional[float] = None
    try:
        if os.environ.get(ENV_PROCESS_ID):
            proc_id = int(os.environ[ENV_PROCESS_ID])
        if os.environ.get(ENV_CLOCK_ANCHOR):
            anchor = float(os.environ[ENV_CLOCK_ANCHOR])
    except ValueError:
        pass
    with _active_lock:
        if _active_recorder is None:
            _active_recorder = FlightRecorder(
                directory, process_index=proc_id, clock_anchor=anchor)
        return _active_recorder


def record_event(kind: str, /, **detail: Any) -> Dict[str, Any]:
    """THE one API every subsystem reports lifecycle events through.
    Cheap (one dict + one flushed line), thread-safe, never raises."""
    rec = get_active_flightrec()
    return rec.record(kind, **detail)


def flush_active_flightrec(reason: str = "flush",
                           registry_snapshot: Optional[Dict] = None,
                           request_snapshot: Optional[Dict] = None
                           ) -> Optional[str]:
    """Orderly-shutdown hook (``flush_worker_observability``): dump
    the blackbox for the spooling recorder, if any."""
    with _active_lock:
        rec = _active_recorder
    if rec is None or rec.dir is None:
        return None
    return rec.dump_blackbox(reason,
                             registry_snapshot=registry_snapshot,
                             request_snapshot=request_snapshot)


def _default_registry_snapshot() -> Optional[Dict[str, Any]]:
    try:
        from analytics_zoo_torch.observability.metrics import get_registry
        return get_registry().snapshot()
    except Exception:   # noqa: BLE001 — standalone (path-loaded) use
        return None


def _default_request_snapshot() -> Optional[Dict[str, Any]]:
    try:
        from analytics_zoo_torch.observability.reqtrace import \
            get_request_log
        return get_request_log().snapshot()
    except Exception:   # noqa: BLE001 — standalone (path-loaded) use
        return None


def _dump_active(reason: str, *, error: Optional[str] = None,
                 fatal: bool = False) -> None:
    with _active_lock:
        rec = _active_recorder
    if rec is None or rec.dir is None:
        return
    rec.dump_blackbox(reason,
                      registry_snapshot=_default_registry_snapshot(),
                      request_snapshot=_default_request_snapshot(),
                      error=error, fatal=fatal)


def _atexit_dump() -> None:
    _dump_active("shutdown")


def _excepthook(exc_type, exc, tb) -> None:
    try:
        err = "".join(traceback.format_exception_only(exc_type, exc))
        _dump_active(f"exception:{exc_type.__name__}",
                     error=err.strip(), fatal=True)
    except Exception:   # noqa: BLE001 — forensics must not mask the crash
        pass
    hook = _prev_excepthook or sys.__excepthook__
    hook(exc_type, exc, tb)


def install_blackbox_hooks() -> None:
    """Arm the blackbox: atexit (orderly shutdown), ``sys.excepthook``
    (unhandled exception, chained), SIGTERM (only when the process
    has no handler of its own — the serving worker's drain handler
    keeps precedence) and ``faulthandler`` into
    ``host-<k>/fatal.log`` for C-level fatal signals.  Idempotent."""
    global _hooks_installed, _prev_excepthook
    with _active_lock:
        if _hooks_installed:
            return
        _hooks_installed = True
        rec = _active_recorder
        atexit.register(_atexit_dump)
        _prev_excepthook = sys.excepthook
        sys.excepthook = _excepthook
    if rec is not None and rec.dir is not None:
        try:
            import faulthandler
            fh = open(os.path.join(rec.dir, FATAL_LOG_FILENAME), "a")
            faulthandler.enable(file=fh)
        except (OSError, ImportError):
            pass
    # fatal-signal dump: claim SIGTERM only if it is unhandled, and
    # re-deliver with the default disposition so exit semantics (the
    # detector's ``signal(TERM)`` classification) are preserved
    try:
        if (threading.current_thread() is threading.main_thread()
                and _signal.getsignal(_signal.SIGTERM)
                == _signal.SIG_DFL):
            def _on_term(signum, frame):   # noqa: ARG001
                _dump_active("signal:SIGTERM", fatal=True)
                _signal.signal(signum, _signal.SIG_DFL)
                os.kill(os.getpid(), signum)
            _signal.signal(_signal.SIGTERM, _on_term)
    except (ValueError, OSError):
        pass


def reset_flightrec() -> None:
    """Drop the process-wide recorder (tests)."""
    global _active_recorder
    with _active_lock:
        if _active_recorder is not None:
            _active_recorder.close()
            _active_recorder = None
