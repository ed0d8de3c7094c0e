"""Preemption/failure detection: classify errors, exit codes, and
missing heartbeats.

The reference's retry loop (Topology.scala:1179-1261) treated every
mid-training exception the same — restore and replay.  On a TPU pod
that is wrong in both directions: a transient XLA/RPC flake heals with
a plain retry, a *lost host* needs the mesh re-formed on the surviving
topology before any retry can succeed, and poisoned state (NaN'd
params) must never be retried at all.  This module is the
classification layer the :mod:`~analytics_zoo_torch.resilience.policy`
engine consumes:

* :func:`classify_failure` — exception → :class:`FailureClass`, from
  the typed chaos faults or a message-pattern table distilled from the
  failure modes the bench rounds actually hit (rc=124 hangs, PJRT
  "deadline exceeded", coordination-service host drops);
* :func:`classify_exit` — a worker's exit code → ``ok`` / ``error(N)``
  / ``signal(NAME)``, with :func:`is_preemption_like` marking the
  KILL/TERM signatures a preempted or OOM-killed worker leaves;
* :class:`HostHeartbeat` — a throttled per-host heartbeat file in the
  launcher run-dir slot, so the supervisor can tell a slow worker from
  a dead one *before* a collective hangs on it (the launcher's
  ``check_health`` reads these and surfaces the
  ``cluster_hosts_missing`` gauge).

Everything here is importable without jax (the launcher supervisor and
tests classify exit codes with no backend in the process).
"""

from __future__ import annotations

import enum
import json
import os
import re
import signal
import threading
import time
from typing import Dict, List, Optional


class FailureClass(enum.Enum):
    TRANSIENT = "transient"
    LOST_HOST = "lost_host"
    POISONED_STATE = "poisoned_state"
    UNRECOVERABLE = "unrecoverable"
    UNKNOWN = "unknown"


# Ordered: first match wins.  LOST_HOST outranks TRANSIENT because a
# dead host's symptoms usually *include* a timeout ("host unreachable:
# deadline exceeded") and retrying onto a dead topology hangs forever.
_PATTERNS = (
    (FailureClass.LOST_HOST, re.compile(
        r"(?i)(lost|missing|unreachable|disconnect\w*|preempt\w*|"
        r"evict\w*|shut\s?down|terminated)[^.]{0,60}"
        r"(host|worker|process|peer|task|replica|node)"
        r"|(host|worker|process|peer|task|node)[^.]{0,60}"
        r"(lost|missing|unreachable|disconnect\w*|preempt\w*|died|"
        r"exited|failed|down)"
        r"|heartbeat|coordination service|slice health|"
        r"barrier timed?\s?out")),
    (FailureClass.POISONED_STATE, re.compile(
        r"(?i)\bnan\b|non.?finite|poison\w*|corrupt\w*|checksum")),
    (FailureClass.TRANSIENT, re.compile(
        r"(?i)deadline.?exceeded|unavailable|resource.?exhausted|"
        r"out of memory|connection (reset|refused|closed)|"
        r"socket closed|broken pipe|\brpc\b|temporar\w*|try again|"
        r"transient|timed?\s?out|cancelled|aborted")),
)


def classify_failure(exc: BaseException) -> FailureClass:
    """Best-effort failure taxonomy for the recovery policy engine."""
    from analytics_zoo_torch.resilience import chaos
    if isinstance(exc, chaos.LostHost):
        return FailureClass.LOST_HOST
    if isinstance(exc, chaos.PoisonedState):
        return FailureClass.POISONED_STATE
    if isinstance(exc, chaos.TransientFault):
        return FailureClass.TRANSIENT
    # by NAME, not import: the watchdog/estimator types live above this
    # layer and the classifier must stay importable standalone
    if type(exc).__name__ in ("TrainingHalted", "_UnrecoverableTraining"):
        return FailureClass.UNRECOVERABLE
    text = f"{type(exc).__name__}: {exc}"
    for cls, pattern in _PATTERNS:
        if pattern.search(text):
            return cls
    return FailureClass.UNKNOWN


# ---------------------------------------------------------- exit codes
def classify_exit(code: Optional[int]) -> str:
    """Human/machine-readable classification of a worker exit code.

    ``Popen.returncode`` is negative when the child died to a signal;
    the 128+N shell convention (and ``os._exit(137)`` after an OOM
    kill) is decoded too."""
    if code is None:
        return "running"
    if code == 0:
        return "ok"
    sig = None
    if code < 0:
        sig = -code
    elif 128 < code < 160:
        sig = code - 128
    if sig is not None:
        try:
            return f"signal({signal.Signals(sig).name})"
        except ValueError:
            return f"signal({sig})"
    return f"error({code})"


def is_preemption_like(classification: str) -> bool:
    """KILL/TERM deaths — the signature of preemption, an OOM kill, or
    a supervisor teardown, as opposed to a worker crashing on its own
    error."""
    return classification in ("signal(SIGKILL)", "signal(SIGTERM)")


# ---------------------------------------------------------- heartbeats
HEARTBEAT_FILE = "heartbeat.json"
_HOST_DIR_RE = re.compile(r"^host-(\d+)$")


class HostHeartbeat:
    """Throttled liveness file in this worker's run-dir slot.

    The training loop calls :meth:`beat` every step (next to the
    watchdog's in-process beat); at most one write per
    ``resilience.heartbeat_interval_s`` actually lands, so the hot
    path pays a clock read, not file IO.  Writes are atomic
    (tmp+rename) and best-effort: heartbeat trouble must never break
    training."""

    def __init__(self, directory: str,
                 interval_s: Optional[float] = None,
                 clock=time.monotonic):
        if interval_s is None:
            from analytics_zoo_torch.common.config import get_config
            interval_s = float(get_config().get(
                "resilience.heartbeat_interval_s", 5.0))
        self.directory = directory
        self.path = os.path.join(directory, HEARTBEAT_FILE)
        self.interval_s = float(interval_s)
        self._clock = clock
        self._last_write: Optional[float] = None
        self._lock = threading.Lock()
        self._warned = False

    @classmethod
    def from_env(cls) -> Optional["HostHeartbeat"]:
        """The launcher env contract: ``ZOO_TPU_METRICS_DIR`` is this
        worker's ``host-<k>/`` slot (aggregator.ENV_METRICS_DIR)."""
        directory = os.environ.get("ZOO_TPU_METRICS_DIR")
        return cls(directory) if directory else None

    def beat(self, step: int = 0, force: bool = False) -> bool:
        """Record liveness; returns True when a write landed."""
        with self._lock:
            now = self._clock()
            if not force and self._last_write is not None \
                    and now - self._last_write < self.interval_s:
                return False
            self._last_write = now
        payload = {
            "time": time.time(),       # wall clock: compared cross-process
            "step": int(step),
            "pid": os.getpid(),
            "process_index": int(os.environ.get(
                "ZOO_TPU_PROCESS_ID", "0") or 0),
        }
        try:
            os.makedirs(self.directory, exist_ok=True)
            tmp = f"{self.path}.{os.getpid()}.tmp"
            with open(tmp, "w") as f:
                json.dump(payload, f)
            os.replace(tmp, self.path)
            return True
        except OSError:
            if not self._warned:
                self._warned = True
                import logging
                logging.getLogger(
                    "analytics_zoo_torch.resilience").exception(
                    "heartbeat write failed (%s); liveness detection "
                    "degrades to process polling", self.path)
            return False


def read_heartbeats(run_dir: str) -> Dict[int, Dict]:
    """process_index -> last heartbeat payload, from the launcher's
    ``host-<k>/`` slots.  Unreadable/partial files are skipped (a
    reader can race the atomic rename only into seeing the OLD file,
    but a slot may simply not have beaten yet)."""
    out: Dict[int, Dict] = {}
    try:
        names = os.listdir(run_dir)
    except OSError:
        return out
    for name in names:
        m = _HOST_DIR_RE.match(name)
        if not m:
            continue
        path = os.path.join(run_dir, name, HEARTBEAT_FILE)
        try:
            with open(path) as f:
                out[int(m.group(1))] = json.load(f)
        except (OSError, ValueError):
            continue
    return out


def stale_hosts(run_dir: str, timeout_s: float,
                expected: Optional[int] = None,
                now: Optional[float] = None) -> List[int]:
    """Process indices whose heartbeat is older than ``timeout_s`` (or
    absent, when ``expected`` says how many hosts should be beating).
    The caller intersects this with still-supposed-to-be-running
    processes — a worker that exited cleanly stops beating and is not
    'stale'."""
    now = time.time() if now is None else now
    beats = read_heartbeats(run_dir)
    indices = range(expected) if expected is not None \
        else sorted(beats)
    out = []
    for idx in indices:
        hb = beats.get(idx)
        if hb is None or now - float(hb.get("time", 0.0)) > timeout_s:
            out.append(idx)
    return out
