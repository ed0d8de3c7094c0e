"""Deterministic fault-injection harness.

The reference's resilience property (fault-tolerant synchronous SGD,
PAPERS.md arXiv 1804.05839 §task retry) was testable because Spark
could kill any task on demand.  Our TPU rebuild needs the same lever:
every recovery path in ``resilience/`` must be provable on CPU in
tier-1, which requires *scripted, reproducible* failures — not real
chip contention.

A :class:`ChaosPlan` is a list of :class:`FaultSpec`\\ s keyed on a
*site* (an instrumented code location) and a *step* (that site's own
0-based dispatch/batch counter).  Instrumented sites call
``plan.trip(site, step)`` on their hot path; a matching spec fires
**once per scheduled step** (`times` consecutive steps, then disarmed
forever — so a recovery that restarts a counter cannot re-trip the
same fault and livelock the retry machinery).

Sites shipped in this repo:

* ``trainer.dispatch``  — DistributedTrainer per-step dispatch
  (fires BEFORE the step is dispatched, so no buffer is donated to a
  doomed dispatch and the committed-iteration count stays exact)
* ``data.batch``        — DeviceLoader batch hand-off
* ``worker.step``       — free site for launched worker scripts
* ``bench.probe``       — bench.py backend probe (simulated chip
  contention)
* ``serving.decode``    — ClusterServing batch decode (step = decode
  batch counter; fires inside the decode pool worker)
* ``serving.predict``   — ClusterServing predict (step = predict batch
  counter; fires BEFORE the model call, so a ``kill`` here is a
  replica dying mid-batch with the batch un-acked — the PEL-reclaim /
  poison-quarantine trigger)
* ``serving.redis``     — broker ops through the serving circuit
  breaker (redis_client.BreakerClient).  Steps count *attempted* ops
  since the current plan became active (each newly installed plan sees
  steps 0, 1, 2, …), so ``at_step=0, times=k`` means "the next k
  broker ops fail" — a scripted broker outage window
* ``serving.http``      — the HTTP fast-path transport (step = POST
  counter per transport).  A raising kind makes the server DROP the
  connection with no HTTP response (the transport-layer
  disconnect class a load balancer or flaky network produces);
  ``slow`` stalls the response — so HTTP-path faults are scriptable
  exactly like ``serving.redis``/``serving.predict``

Fault kinds:

* ``raise``           — raise :class:`TransientFault` (retryable)
* ``drop_collective`` — raise :class:`DroppedCollective` (a collective
  failed mid-step; transient subclass)
* ``poison``          — raise :class:`PoisonedState` (state corrupt;
  never retried)
* ``lose_host``       — raise :class:`LostHost` carrying the surviving
  device ids (``survivors``) — the elastic-recovery trigger
* ``kill``            — ``os._exit(exit_code)`` (a preempted/OOM-killed
  worker process, for launcher-level tests)
* ``hang``            — sleep ``sleep_s`` (default 3600 s): a worker
  stuck in a dead collective
* ``slow``            — sleep ``sleep_s`` then continue: a straggler

CONTRACT: this module is stdlib-only.  Cross-process injection rides in the ``ZOO_TPU_CHAOS`` env var (JSON of
``ChaosPlan.to_dict()``): ``ZooCluster(chaos=...)`` stamps it into
every worker's env, and :func:`active_chaos` lazily parses it in the
worker, filtering per-process faults by ``ZOO_TPU_PROCESS_ID``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading
import time
from typing import Dict, List, Optional, Sequence

ENV_CHAOS = "ZOO_TPU_CHAOS"

SITE_TRAINER_DISPATCH = "trainer.dispatch"
SITE_DATA_BATCH = "data.batch"
SITE_WORKER_STEP = "worker.step"
SITE_BENCH_PROBE = "bench.probe"
SITE_SERVING_DECODE = "serving.decode"
SITE_SERVING_PREDICT = "serving.predict"
SITE_SERVING_REDIS = "serving.redis"
SITE_SERVING_HTTP = "serving.http"

KINDS = ("raise", "drop_collective", "poison", "lose_host", "kill",
         "hang", "slow")


class InjectedFault(RuntimeError):
    """Base class of every raised injected fault."""


class TransientFault(InjectedFault):
    """A retryable failure (the RPC-flake / XLA-hiccup class)."""


class DroppedCollective(TransientFault):
    """A collective op failed mid-step (transient: the fabric usually
    heals; a persistent drop escalates through the retry budget)."""


class PoisonedState(InjectedFault):
    """Training state is corrupt — retrying replays the poison."""


class LostHost(InjectedFault):
    """A host/worker vanished.  ``survivors`` lists the device ids
    still reachable (``None`` = unknown: recovery asks the backend)."""

    def __init__(self, message: str,
                 survivors: Optional[Sequence[int]] = None):
        super().__init__(message)
        self.survivors = (None if survivors is None
                          else [int(s) for s in survivors])


@dataclasses.dataclass
class FaultSpec:
    """One scripted fault: fire ``kind`` at ``site`` when that site's
    step counter reaches ``at_step`` (then the ``times - 1`` following
    steps), optionally only in process ``process_index``."""

    site: str
    at_step: int
    kind: str = "raise"
    times: int = 1
    process_index: Optional[int] = None
    survivors: Optional[List[int]] = None   # lose_host only
    exit_code: int = 137                    # kill only (128+SIGKILL)
    sleep_s: float = 0.0                    # slow/hang
    message: str = ""

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(
                f"unknown fault kind {self.kind!r}: expected one of "
                f"{KINDS}")
        self.at_step = int(self.at_step)
        self.times = max(int(self.times), 1)

    def to_dict(self) -> Dict:
        # full round trip (None kept out for brevity; 0 is meaningful
        # for at_step/process_index and must survive)
        out = dataclasses.asdict(self)
        return {k: v for k, v in out.items() if v is not None}

    @classmethod
    def from_dict(cls, d: Dict) -> "FaultSpec":
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})


class ChaosPlan:
    """An armed set of :class:`FaultSpec`\\ s.

    ``trip`` is thread-safe (the DeviceLoader prefetch thread and the
    main loop may hit different sites concurrently) and cheap when no
    spec matches the site.
    """

    def __init__(self, faults: Sequence[FaultSpec] = ()):
        self.faults = list(faults)
        self._fired: Dict[int, int] = {}     # spec index -> fires so far
        self._lock = threading.Lock()

    # ------------------------------------------------------------ firing
    def trip(self, site: str, step: int) -> None:
        """Fire any armed fault scheduled for ``(site, step)``.

        Raising kinds raise; ``kill`` exits the process; ``slow``/
        ``hang`` sleep.  A spec fires at most ``times`` total trips and
        is then disarmed (see module docstring: recovery restarts step
        counters, and a step-keyed re-fire would livelock recovery)."""
        pid = self._process_index()
        for i, f in enumerate(self.faults):
            if f.site != site:
                continue
            if f.process_index is not None and f.process_index != pid:
                continue
            with self._lock:
                fired = self._fired.get(i, 0)
                if fired >= f.times or step != f.at_step + fired:
                    continue
                self._fired[i] = fired + 1
            self._execute(f, site, step)

    @staticmethod
    def _process_index() -> int:
        try:
            return int(os.environ.get("ZOO_TPU_PROCESS_ID", "0"))
        except ValueError:
            return 0

    @staticmethod
    def _execute(f: FaultSpec, site: str, step: int) -> None:
        msg = f.message or (
            f"injected {f.kind} fault at {site} step {step}")
        # flight-record the trip BEFORE executing: ``kill`` is
        # ``os._exit`` (no atexit, no blackbox) — the incrementally
        # flushed journal line is the only evidence that survives,
        # and it is exactly what zoo-doctor joins restarts against
        try:
            from analytics_zoo_torch.observability.flightrec import \
                record_event
            record_event("chaos.trip", site=site, step=step,
                         kind=f.kind)
        except Exception:   # noqa: BLE001 — chaos must fire regardless
            pass
        if f.kind == "raise":
            raise TransientFault(msg)
        if f.kind == "drop_collective":
            raise DroppedCollective(
                f.message or f"injected dropped collective at {site} "
                             f"step {step}")
        if f.kind == "poison":
            raise PoisonedState(msg)
        if f.kind == "lose_host":
            raise LostHost(
                f.message or f"injected lost host at {site} step "
                             f"{step}", survivors=f.survivors)
        if f.kind == "kill":
            # the abrupt-death path: no atexit, no cleanup — exactly
            # what a preempted/OOM-killed worker looks like from outside
            os._exit(f.exit_code)
        if f.kind == "hang":
            time.sleep(f.sleep_s or 3600.0)
            return
        if f.kind == "slow":
            time.sleep(f.sleep_s)
            return
        raise AssertionError(f.kind)    # pragma: no cover — __post_init__

    # ------------------------------------------------------- serialization
    def to_dict(self) -> Dict:
        return {"faults": [f.to_dict() for f in self.faults]}

    def to_json(self) -> str:
        return json.dumps(self.to_dict())

    @classmethod
    def from_dict(cls, d: Dict) -> "ChaosPlan":
        return cls([FaultSpec.from_dict(f) for f in d.get("faults", [])])

    @classmethod
    def from_json(cls, raw: str) -> "ChaosPlan":
        return cls.from_dict(json.loads(raw))

    def env(self) -> Dict[str, str]:
        """Env contract for launched workers (``ZooCluster(chaos=...)``
        merges this into every worker env)."""
        return {ENV_CHAOS: self.to_json()}


# -------------------------------------------------- process-wide hookup
_active: Optional[ChaosPlan] = None
_env_checked = False
_lock = threading.Lock()


def install_chaos(plan: Optional[ChaosPlan]) -> Optional[ChaosPlan]:
    """Install ``plan`` as this process's active chaos plan; returns
    the previous one (tests restore it in a ``finally``)."""
    global _active, _env_checked
    with _lock:
        prev = _active
        _active = plan
        _env_checked = True     # explicit install wins over the env
    return prev


def clear_chaos() -> None:
    """Disarm everything (also forgets a cached env plan)."""
    global _active, _env_checked
    with _lock:
        _active = None
        _env_checked = False


def active_chaos() -> Optional[ChaosPlan]:
    """The active plan: an installed one, else a one-time parse of
    ``ZOO_TPU_CHAOS`` (how launched workers inherit the launcher's
    plan).  Returns None on the overwhelmingly common no-chaos path."""
    global _active, _env_checked
    if _env_checked:
        return _active
    with _lock:
        if not _env_checked:
            raw = os.environ.get(ENV_CHAOS)
            if raw:
                try:
                    _active = ChaosPlan.from_json(raw)
                except (ValueError, TypeError, KeyError):
                    import logging
                    logging.getLogger(
                        "analytics_zoo_torch.resilience").warning(
                        "unparseable %s ignored: %r", ENV_CHAOS,
                        raw[:200])
                    _active = None
            _env_checked = True
    return _active
