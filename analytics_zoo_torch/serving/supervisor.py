"""Serving replica supervisor — the resilience layer of the fleet.

The reference's Cluster Serving got multi-replica fault tolerance for
free from Spark executor restart + Redis consumer groups (BigDL,
arXiv 1804.05839 §serving; BigDL 2.0, arXiv 2204.01715).  Our rebuild
provides — and beats — that property itself: a
:class:`ServingSupervisor` spawns N ``ClusterServing`` worker
processes against ONE consumer group (distinct consumer names, so each
record is delivered to exactly one replica and a dead replica's
un-acked records are PEL-reclaimed by its peers), watches them via

* **process exit** — classified with
  :func:`~analytics_zoo_torch.resilience.detector.classify_exit`
  (``ok`` / ``error(N)`` / ``signal(SIGKILL)`` …),
* **/healthz** — each replica publishes its metrics port through
  ``ZOO_TPU_SERVING_PORT_FILE``; 200/503 both mean *alive* (503 =
  not-ready, e.g. ``breaker_open`` during a broker outage — restarting
  cannot fix that, so the supervisor deliberately does NOT),
* **heartbeats** — with a ``run_dir``, replicas write the
  ``host-<k>/heartbeat.json``; a staleness past
  ``resilience.heartbeat_timeout_s`` flags a replica whose process
  still polls as running but whose serve loop is wedged,

and restarts crashed replicas with exponential backoff under a
:class:`~analytics_zoo_torch.resilience.policy.RetryBudget` (the
reference's time-windowed budget).  Budget exhausted → the fleet ends
*structured*: a ``DegradedTraining``-style record (mirrored to
``<run_dir>/degraded.json``) and
:data:`~analytics_zoo_torch.resilience.policy.DEGRADED_EXIT_CODE` (17)
from the CLI — honoring the ``zoo-launch --max-degraded`` contract, so
an orchestrator can tell "serving tier gave up in an orderly way"
from "supervisor crashed".

SIGTERM to the supervisor drains the fleet gracefully: each replica
gets SIGTERM, finishes + acks its in-flight batches, flushes metrics,
and exits 0 (escalating to SIGKILL only past ``drain_timeout_s``).

**SLO-driven autoscaling** (``min_replicas``/``max_replicas``): the
supervisor already polls every replica's /healthz port — the same
``MetricsServer`` serves ``/metrics.json``, so the fleet's own
exported signals drive scale decisions with zero new plumbing:

* **up** — the shared-stream backlog (``serving_queue_depth``, the
  gauge every replica exports) sustained above
  ``scale_up_queue_depth`` for ``scale_up_sustain_s``, or p50 request
  latency (the serving histogram) sustained above
  ``scale_up_latency_p50_ms`` when that knob is set;
* **down** — backlog empty for ``scale_down_idle_s`` (fill ratio and
  latency ride every scale event's signal record for forensics, but
  the LIVE backlog is the decisive idle signal — the fill gauge
  holds the last batch's value and would read stale-high forever on
  an idle fleet): the highest-index replica is *retired* — SIGTERM,
  the existing drain contract, so it finishes + acks in-flight
  batches and exits 0 — and never restarted;
* **hysteresis** — both signals must SUSTAIN (one noisy poll never
  scales), and ``scale_cooldown_s`` separates consecutive scale
  events so a fresh replica gets to absorb load before the next
  decision;
* **held** — a replica 503ing ``error_rate`` pauses scale-up: a
  poisoned stream amplified across more replicas is more poison, not
  more throughput.

The live fleet size is exported as ``serving_fleet_replicas`` and
recorded in ``replica_trajectory`` — the autoscaler's acceptance
evidence.

The supervisor process never touches a device — replicas are separate
processes, so the fleet controller can run on a host with no
accelerator access at all.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import os
import subprocess
import sys
import tempfile
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

from analytics_zoo_torch.common.config import get_config
from analytics_zoo_torch.common.fsutil import atomic_write_text
from analytics_zoo_torch.observability import get_registry
from analytics_zoo_torch.observability import flightrec as _flightrec
from analytics_zoo_torch.resilience.detector import (
    classify_exit, read_heartbeats)
from analytics_zoo_torch.resilience.policy import (
    DEGRADED_EXIT_CODE, DegradedTraining, RetryBudget, degraded_exit)

log = logging.getLogger("analytics_zoo_torch.serving.supervisor")

#: env var through which a replica publishes its bound /metrics
#: (+/healthz) port back to the supervisor (server._publish_port)
ENV_PORT_FILE = "ZOO_TPU_SERVING_PORT_FILE"

#: worker_factory signature: (replica_index, incarnation) ->
#: (argv list, extra env dict) — incarnation 0 is the first spawn,
#: so tests can arm chaos for exactly one life of a replica
WorkerFactory = Callable[[int, int], Tuple[List[str], Dict[str, str]]]


def _set_pdeathsig():   # pragma: no cover — linux only
    """Replica dies with the supervisor (launcher._set_pdeathsig's
    role, re-implemented here as in the reference)."""
    try:
        import ctypes
        import signal
        libc = ctypes.CDLL("libc.so.6", use_errno=True)
        PR_SET_PDEATHSIG = 1
        libc.prctl(PR_SET_PDEATHSIG, signal.SIGKILL)
    except Exception:   # noqa: BLE001 — non-linux
        pass


def cli_worker_factory(config_path: str,
                       consumer_group: str = "serving",
                       extra_args: Tuple[str, ...] = (),
                       python: str = sys.executable) -> WorkerFactory:
    """The default replica command: ``zoo-serving start`` against one
    shared consumer group, a unique consumer name per replica slot,
    and an ephemeral metrics port (the replica publishes the bound
    port back through :data:`ENV_PORT_FILE`)."""
    def factory(index: int, incarnation: int):
        cmd = [python, "-m", "analytics_zoo_torch.serving.cli", "start",
               "-c", config_path,
               "--consumer-group", consumer_group,
               "--consumer-name", f"replica-{index}",
               "--metrics-port", "0", *extra_args]
        return cmd, {}
    return factory


@dataclasses.dataclass
class _Replica:
    """Supervisor-side state of one replica slot."""
    index: int
    port_file: str
    budget: RetryBudget
    proc: Optional[subprocess.Popen] = None
    incarnation: int = 0          # lives spawned so far
    port: Optional[int] = None    # discovered /healthz port
    spawned_at: float = 0.0
    next_spawn_at: Optional[float] = None   # backoff restart schedule
    consecutive_failures: int = 0
    health_fails: int = 0         # consecutive unreachable probes
    last_health_at: float = 0.0
    last_exit: Optional[int] = None
    done: bool = False            # exited 0 (orderly drain)
    degraded: bool = False        # exited DEGRADED_EXIT_CODE
    kill_reason: Optional[str] = None   # supervisor-initiated kill
    retiring: bool = False        # scale-down drain in progress
    retire_deadline: float = 0.0  # monotonic: SIGKILL escalation
    last_health: str = ""         # latest _probe result


class ServingSupervisor:
    """Spawn, watch, restart, and drain a fleet of serving replicas.

    ``run()`` blocks until the fleet drains (``stop()`` / SIGTERM /
    every replica exiting 0 or 17) and returns a summary dict — or
    raises :class:`DegradedTraining` when a replica exhausts its
    restart budget (the CLI maps that to exit 17 via
    ``degraded_exit``)."""

    def __init__(self, worker_factory: WorkerFactory,
                 replicas: int = 3, *,
                 retry_times: Optional[int] = None,
                 retry_window_s: Optional[float] = None,
                 backoff_base_s: float = 0.5,
                 backoff_max_s: float = 10.0,
                 health_interval_s: float = 2.0,
                 health_fail_threshold: int = 3,
                 startup_grace_s: float = 30.0,
                 heartbeat_timeout_s: Optional[float] = None,
                 run_dir: Optional[str] = None,
                 drain_timeout_s: float = 30.0,
                 min_replicas: Optional[int] = None,
                 max_replicas: Optional[int] = None,
                 scale_up_queue_depth: Optional[int] = None,
                 scale_up_latency_p50_ms: Optional[float] = None,
                 scale_up_sustain_s: Optional[float] = None,
                 scale_down_idle_s: Optional[float] = None,
                 scale_cooldown_s: Optional[float] = None,
                 autoscale_interval_s: float = 1.0,
                 slo_signal: Optional[Callable[[], Dict]] = None,
                 clock: Optional[Callable[[], float]] = None):
        if retry_times is None:
            retry_times = int(get_config().get(
                "serving.supervisor_retry_times", 5))
        if retry_window_s is None:
            retry_window_s = float(get_config().get(
                "serving.supervisor_retry_window_s", 60.0))
        if heartbeat_timeout_s is None:
            heartbeat_timeout_s = float(get_config().get(
                "resilience.heartbeat_timeout_s", 30.0))
        # every interval/hysteresis decision reads THIS clock (default
        # monotonic): tests drive scale mechanics deterministically by
        # injecting a fake clock and calling _tick() directly, instead
        # of racing wall-clock sustain windows against a loaded CPU
        self._clock = clock or time.monotonic
        self.worker_factory = worker_factory
        self.replicas = int(replicas)
        self.retry_times = int(retry_times)
        self.retry_window_s = float(retry_window_s)
        self.backoff_base_s = float(backoff_base_s)
        self.backoff_max_s = float(backoff_max_s)
        self.health_interval_s = float(health_interval_s)
        self.health_fail_threshold = max(int(health_fail_threshold), 1)
        self.startup_grace_s = float(startup_grace_s)
        self.heartbeat_timeout_s = float(heartbeat_timeout_s)
        self.drain_timeout_s = float(drain_timeout_s)
        self.run_dir = run_dir
        # ---- autoscaler: bounds + SLO knobs (config-defaulted) -----
        cfg = get_config()
        if scale_up_queue_depth is None:
            scale_up_queue_depth = int(cfg.get(
                "serving.scale_up_queue_depth", 16))
        if scale_up_latency_p50_ms is None:
            scale_up_latency_p50_ms = float(cfg.get(
                "serving.scale_up_latency_p50_ms", 0.0))   # 0 = off
        if scale_up_sustain_s is None:
            scale_up_sustain_s = float(cfg.get(
                "serving.scale_up_sustain_s", 3.0))
        if scale_down_idle_s is None:
            scale_down_idle_s = float(cfg.get(
                "serving.scale_down_idle_s", 10.0))
        if scale_cooldown_s is None:
            scale_cooldown_s = float(cfg.get(
                "serving.scale_cooldown_s", 5.0))
        self.min_replicas = int(replicas if min_replicas is None
                                else min_replicas)
        self.max_replicas = int(replicas if max_replicas is None
                                else max_replicas)
        if self.min_replicas > self.max_replicas:
            raise ValueError(
                f"min_replicas {self.min_replicas} > max_replicas "
                f"{self.max_replicas}")
        self.autoscale = self.max_replicas > self.min_replicas
        self.scale_up_queue_depth = int(scale_up_queue_depth)
        self.scale_up_latency_p50_ms = float(scale_up_latency_p50_ms)
        self.scale_up_sustain_s = float(scale_up_sustain_s)
        self.scale_down_idle_s = float(scale_down_idle_s)
        self.scale_cooldown_s = float(scale_cooldown_s)
        self.autoscale_interval_s = float(autoscale_interval_s)
        # SLO feed (observability/slo.py): a callable returning the
        # latest {"alert": "ok"|"warn"|"page", "budget_remaining":
        # float} for the serving SLO.  A paging burn rate is a
        # scale-up pressure source in its own right (the budget is
        # burning faster than queue depth alone admits), and an
        # exhausted error budget HOLDS scale-down — retiring capacity
        # while the budget is spent converts a warn into an outage.
        self._slo_signal = slo_signal
        # hysteresis state: when each condition STARTED holding
        self._pressure_since: Optional[float] = None
        self._idle_since: Optional[float] = None
        self._last_scale_at = 0.0
        self._last_autoscale_poll = 0.0
        # fleet bookkeeping (_replicas, scale_events,
        # replica_trajectory, restarts_total, the autoscale clock) is
        # mutated on the supervision loop thread while summary()/
        # wait_ready()/drain_fleet() read from the caller's thread —
        # every touch holds this lock.  Reentrant because
        # _record_fleet_size → _persist_state nest read sections
        # inside write sections.  NEVER held across _spawn or a
        # health probe: iteration sites copy the list and release.
        self._fleet_lock = threading.RLock()
        #: [(unix time, fleet size, reason)] — every size change,
        #: including the initial spawn; the acceptance trajectory
        self.replica_trajectory: List[Tuple[float, int, str]] = []
        self.scale_events: List[Dict] = []
        # ``replicas`` is the INITIAL size, clamped into bounds
        self.replicas = min(max(self.replicas, self.min_replicas),
                            self.max_replicas)
        self._state_dir = run_dir or tempfile.mkdtemp(
            prefix="zoo-serving-supervisor-")
        os.makedirs(self._state_dir, exist_ok=True)
        # the control plane's own flight recorder: lifecycle events
        # journal to <run_dir>/events.jsonl (ring-only without a run
        # dir) — deliberately a PRIVATE instance, the process-wide
        # slot belongs to worker processes
        self._flightrec = _flightrec.FlightRecorder(
            run_dir, role="supervisor")
        self._replicas: List[_Replica] = [
            _Replica(index=i,
                     port_file=os.path.join(self._state_dir,
                                            f"replica-{i}.port"),
                     budget=RetryBudget(self.retry_times,
                                        self.retry_window_s))
            for i in range(self.replicas)]
        self.restarts_total = 0
        self._stop = threading.Event()
        reg = get_registry()
        self._m_running = reg.gauge(
            "serving_replicas_running",
            "serving replicas currently alive under the supervisor")
        self._m_restarts = reg.counter(
            "serving_replica_restarts_total",
            "replica restarts performed by the supervisor")
        self._m_exits = reg.counter(
            "serving_replica_exits_total",
            "replica exits observed, by classified exit code",
            labels=("class",))
        self._m_fleet = reg.gauge(
            "serving_fleet_replicas",
            "live (non-retiring) serving replicas the autoscaler is "
            "holding the fleet at")
        self._m_scale = reg.counter(
            "serving_scale_events_total",
            "autoscaler scale decisions", labels=("direction",))
        self._m_slo_hold = reg.counter(
            "serving_slo_hold_total",
            "autoscaler decisions vetoed by the SLO signal, by kind",
            labels=("kind",))
        self._record_fleet_size("initial")

    # -------------------------------------------------------------- control
    def stop(self) -> None:
        """Request a graceful fleet drain (also the SIGTERM handler)."""
        self._stop.set()

    def install_signal_handlers(self) -> bool:
        """SIGTERM → ``stop()`` (graceful drain).  Main-thread only;
        returns False when not installable."""
        import signal
        try:
            signal.signal(signal.SIGTERM,
                          lambda _sig, _frame: self.stop())
            return True
        except ValueError:
            return False

    # ------------------------------------------------------------ lifecycle
    def _spawn(self, r: _Replica) -> None:
        cmd, env = self.worker_factory(r.index, r.incarnation)
        full = dict(os.environ)
        full.update(env or {})
        try:
            os.remove(r.port_file)     # stale port from a past life
        except OSError:
            pass
        if self.run_dir:
            # drop the dead incarnation's heartbeat too (the same
            # contamination guard the launcher applies to reused run
            # dirs): the replacement's first beat only lands after
            # model load, and judging it by its predecessor's stale
            # timestamp would kill every slow-starting respawn until
            # the budget spuriously degrades the fleet
            try:
                os.remove(os.path.join(self.run_dir,
                                       f"host-{r.index}",
                                       "heartbeat.json"))
            except OSError:
                pass
        r.port = None
        r.health_fails = 0
        r.kill_reason = None
        full[ENV_PORT_FILE] = r.port_file
        # chaos process filtering + const metric labels both key on
        # the replica slot; a test factory may override
        full.setdefault("ZOO_TPU_PROCESS_ID", str(r.index))
        if self.run_dir:
            slot = os.path.join(self.run_dir, f"host-{r.index}")
            os.makedirs(slot, exist_ok=True)
            full.setdefault("ZOO_TPU_METRICS_DIR", slot)
        r.proc = subprocess.Popen(cmd, env=full,
                                  preexec_fn=_set_pdeathsig)
        r.incarnation += 1
        r.spawned_at = self._clock()
        r.next_spawn_at = None
        self._flightrec.record(
            "replica.spawn", replica=r.index,
            incarnation=r.incarnation, pid=r.proc.pid)
        log.info("replica %d spawned (incarnation %d, pid %d)",
                 r.index, r.incarnation, r.proc.pid)

    def _handle_exit(self, r: _Replica, code: int) -> None:
        r.proc = None
        r.last_exit = code
        killed, r.kill_reason = r.kill_reason, None
        if r.retiring:
            # scale-down retirement: whatever the exit code, this slot
            # is finished — respawning it would undo the scale
            # decision.  (A non-zero exit during drain is logged: the
            # records it read are in the PEL for its peers.)
            r.done = True
            if code == 0:
                log.info("replica %d retired (scale-down drain, "
                         "exit 0)", r.index)
            else:
                log.warning("replica %d exited %d during scale-down "
                            "drain; peers will reclaim its PEL",
                            r.index, code)
            self._m_exits.labels("retired").inc()
            self._flightrec.record(
                "replica.retire", replica=r.index, exit=code)
            return
        cls = ("killed_by_supervisor" if killed
               else "degraded" if code == DEGRADED_EXIT_CODE
               else classify_exit(code))
        self._m_exits.labels(cls).inc()
        self._flightrec.record(
            "replica.exit", replica=r.index, exit=code,
            classification=cls,
            **({"kill_reason": killed} if killed else {}))
        # a supervisor-initiated kill (wedged heartbeat, unreachable
        # /healthz) must be restarted no matter HOW the replica ended:
        # its SIGTERM handler drains gracefully to exit 0, and taking
        # that as an orderly retirement would silently shrink the
        # fleet with no restart and no degraded record
        if killed:
            log.warning("replica %d exited %d after supervisor kill "
                        "(%s); routing through the restart budget",
                        r.index, code, killed)
        elif code == 0:
            r.done = True
            log.info("replica %d drained and exited 0", r.index)
            return
        elif code == DEGRADED_EXIT_CODE:
            r.degraded = True
            log.warning("replica %d ended DEGRADED (exit 17)", r.index)
            return
        # a crash.  Stable-for-a-window replicas restart their
        # backoff ladder from the bottom (the budget itself refills on
        # the same window rule inside RetryBudget.consume)
        if self._clock() - r.spawned_at > self.retry_window_s:
            r.consecutive_failures = 0
        r.consecutive_failures += 1
        if not r.budget.consume():
            self._degrade(r, code, cls)
        with self._fleet_lock:
            self.restarts_total += 1
        self._m_restarts.inc()
        delay = min(self.backoff_max_s,
                    self.backoff_base_s
                    * (2 ** (r.consecutive_failures - 1)))
        r.next_spawn_at = self._clock() + delay
        log.warning("replica %d died (%s); restart %d scheduled in "
                    "%.2fs (%d budget left)", r.index, cls,
                    r.incarnation, delay, r.budget.remaining)

    def _degrade(self, r: _Replica, code: int, cls: str) -> None:
        """Budget exhausted: end the fleet structured — the serving
        twin of training's checkpoint-and-queue degraded record."""
        # mark the replica BEFORE raising: with run_background() the
        # DegradedTraining dies with the daemon thread, and summary()
        # must still show which replica took the fleet down
        r.degraded = True
        r.last_exit = code
        with self._fleet_lock:
            restarts = self.restarts_total
        record = {
            "status": "degraded",
            "component": "serving",
            "reason": (f"replica {r.index} exhausted its restart "
                       f"budget ({self.retry_times} failures within "
                       f"{self.retry_window_s:.0f}s)"),
            "replica": r.index,
            "exit_code": code,
            "classification": cls,
            "incarnations": r.incarnation,
            "restarts_total": restarts,
            "replicas": self.replicas,
        }
        if self.run_dir:
            path = os.path.join(self.run_dir, "degraded.json")
            try:
                atomic_write_text(path, json.dumps(record, indent=2))
            except OSError:
                log.exception("could not mirror degraded record to %s",
                              path)
        self._flightrec.record(
            "fleet.degraded", replica=r.index, exit=code,
            classification=cls, restarts_total=restarts)
        self._persist_state()
        raise DegradedTraining(record["reason"], result=record)

    # ------------------------------------------------------------ autoscale
    def _fleet(self) -> List[_Replica]:
        """Locked copy of the replica slots — iterate the copy so the
        lock is never held across a spawn or a health probe."""
        with self._fleet_lock:
            return list(self._replicas)

    def _fleet_size(self) -> int:
        """The live fleet: slots that are neither finished nor on
        their way out (a retiring replica still drains, but traffic
        planning must not count it)."""
        return sum(1 for r in self._fleet()
                   if not r.done and not r.degraded and not r.retiring)

    def _record_fleet_size(self, reason: str) -> None:
        size = self._fleet_size()
        self._m_fleet.set(size)
        with self._fleet_lock:
            changed = (not self.replica_trajectory
                       or self.replica_trajectory[-1][1] != size)
            if changed:
                self.replica_trajectory.append(
                    (time.time(), size, reason))
        if changed:
            self._persist_state()

    def _persist_state(self) -> None:
        """Mirror ``scale_events`` + ``replica_trajectory`` to the run
        dir AT DECISION TIME — ``summary()`` dies with the process, a
        crashed supervisor must still leave its decisions for
        ``zoo-doctor``."""
        if not self.run_dir:
            return
        with self._fleet_lock:
            doc = {
                "written_unix": time.time(),
                "replicas": self.replicas,
                "restarts_total": self.restarts_total,
                "scale_events": list(self.scale_events),
                "replica_trajectory": [
                    [t, size, reason]
                    for t, size, reason in self.replica_trajectory],
            }
        try:
            atomic_write_text(
                os.path.join(self.run_dir, "supervisor.json"),
                json.dumps(doc, indent=2, sort_keys=True))
        except OSError:
            log.exception("could not persist supervisor state")

    def _replica_gauges(self, r: _Replica) -> Dict:
        """One replica's ``/metrics.json`` snapshot sections (gauges +
        histograms); {} when unreachable — the autoscaler treats a
        silent replica as contributing no signal, and the health loop
        separately decides whether it is dead."""
        if r.port is None:
            return {}
        from urllib import request as urlrequest
        try:
            with urlrequest.urlopen(
                    f"http://127.0.0.1:{r.port}/metrics.json",
                    timeout=1.0) as resp:
                return json.loads(resp.read().decode())
        except Exception:   # noqa: BLE001 — probe, not a failure
            return {}

    def _healthz_error_rate(self, r: _Replica) -> bool:
        """Whether this replica's /healthz 503s for ``error_rate`` —
        the one signal that must HOLD scale-up (more replicas on a
        poisoned stream amplify the poison)."""
        if r.port is None:
            return False
        from urllib import error as urlerror
        from urllib import request as urlrequest
        try:
            with urlrequest.urlopen(
                    f"http://127.0.0.1:{r.port}/healthz",
                    timeout=1.0):
                return False
        except urlerror.HTTPError as e:
            try:
                reason = json.loads(e.read().decode()).get("reason")
            except Exception:   # noqa: BLE001
                reason = None
            finally:
                e.close()
            return reason == "error_rate"
        except (urlerror.URLError, OSError):
            return False

    def _collect_signals(self) -> Dict:
        """Fleet-wide scale signals from the replicas' own exported
        metrics: max queue depth (every replica sees the same shared
        stream, so max ≈ truth even mid-scrape), max batch fill, max
        p50 request latency.  The error-rate /healthz probe is NOT
        taken here — it only matters when a scale-up is about to
        fire, so ``_autoscale`` checks it lazily at that moment
        instead of paying a second per-replica round trip every
        interval."""
        queue = fill = p50_ms = 0.0
        saw_metrics = False
        for r in self._fleet():
            if r.proc is None or r.done or r.degraded or r.retiring:
                continue
            snap = self._replica_gauges(r)
            if not snap:
                continue
            saw_metrics = True
            gauges = snap.get("gauges", {})
            queue = max(queue,
                        float(gauges.get("serving_queue_depth", 0.0)))
            fill = max(fill, float(gauges.get(
                "serving_batch_fill_ratio", 0.0)))
            hist = snap.get("histograms", {}).get(
                "serving_request_latency_seconds")
            if hist:
                p50_ms = max(p50_ms,
                             float(hist.get("p50") or 0.0) * 1000.0)
        return {"queue": queue, "fill": fill, "p50_ms": p50_ms,
                "saw_metrics": saw_metrics}

    def _error_rate_hold(self) -> bool:
        """Lazy scale-up gate: does ANY live replica 503 for
        error_rate right now?  Only called when a scale-up is
        otherwise ready to fire."""
        return any(
            self._healthz_error_rate(r) for r in self._fleet()
            if r.proc is not None and not r.done and not r.degraded
            and not r.retiring)

    def _scale_down_allowed(self) -> bool:
        """Scale-down is only trusted when every live replica's last
        /healthz probe was a plain 200: a warming replica (503
        warming_up, queue gauge frozen at boot) or a breaker-open one
        (broker invisible) cannot vouch that the backlog is really
        empty — retiring capacity on their say-so is the cold-boot
        scale-to-floor failure mode."""
        live = [r for r in self._fleet()
                if r.proc is not None and not r.done
                and not r.degraded and not r.retiring]
        return bool(live) and all(r.last_health == "ok"
                                  for r in live)

    def _read_slo_signal(self) -> Dict:
        """The latest SLO verdict from the injected feed, or {} when
        no feed is wired / the feed raises (a broken SLO evaluator
        must never take down the autoscaler with it)."""
        if self._slo_signal is None:
            return {}
        try:
            return dict(self._slo_signal() or {})
        except Exception:   # noqa: BLE001 — advisory signal
            log.exception("autoscaler: slo_signal raised; ignoring")
            return {}

    def _autoscale(self, now: float) -> None:
        if not self.autoscale or self._stop.is_set():
            return
        with self._fleet_lock:
            if now - self._last_autoscale_poll \
                    < self.autoscale_interval_s:
                return
            self._last_autoscale_poll = now
        sig = self._collect_signals()
        if not sig["saw_metrics"]:
            # nobody reachable yet (cold fleet / every port pending):
            # no evidence, no decision — hysteresis clocks reset so a
            # blind window can never accumulate into a scale event
            self._pressure_since = self._idle_since = None
            return
        slo = self._read_slo_signal()
        if slo:
            # ride the scale-event record so forensics can see WHICH
            # signal fired each decision
            sig["slo_alert"] = str(slo.get("alert", "ok"))
            if slo.get("budget_remaining") is not None:
                sig["slo_budget_remaining"] = float(
                    slo["budget_remaining"])
        slo_page = sig.get("slo_alert") == "page"
        pressure = slo_page \
            or sig["queue"] > self.scale_up_queue_depth or (
                self.scale_up_latency_p50_ms > 0
                and sig["p50_ms"] > self.scale_up_latency_p50_ms)
        # idle keys on the live backlog alone: the fill gauge holds
        # the LAST batch's ratio, so a full final batch would read
        # stale-high forever and wedge scale-down.  Fill still rides
        # every scale event's signal record for operator forensics.
        idle = sig["queue"] <= 0
        self._pressure_since = (
            None if not pressure
            else self._pressure_since if self._pressure_since
            is not None else now)
        self._idle_since = (
            None if not idle
            else self._idle_since if self._idle_since
            is not None else now)
        in_cooldown = now - self._last_scale_at < self.scale_cooldown_s
        size = self._fleet_size()
        if pressure and size < self.max_replicas and not in_cooldown \
                and now - self._pressure_since \
                >= self.scale_up_sustain_s:
            if self._error_rate_hold():
                log.warning(
                    "autoscaler: scale-up held — a replica 503s "
                    "error_rate (queue=%.0f); more replicas would "
                    "amplify a poisoned stream", sig["queue"])
                return
            self._scale_up(now, sig)
        elif idle and size > self.min_replicas and not in_cooldown \
                and now - self._idle_since >= self.scale_down_idle_s \
                and self._scale_down_allowed():
            budget = sig.get("slo_budget_remaining")
            if budget is not None and budget <= 0:
                # error budget exhausted: the queue may be empty only
                # because users are being turned away — retiring
                # capacity now bakes the outage in.  Hold until the
                # budget recovers above zero.
                self._m_slo_hold.labels("scale_down").inc()
                log.warning(
                    "autoscaler: scale-down held — SLO error budget "
                    "exhausted (remaining=%.3f, alert=%s)", budget,
                    sig.get("slo_alert", "?"))
                return
            self._scale_down(now, sig)

    def _scale_up(self, now: float, sig: Dict) -> None:
        with self._fleet_lock:
            index = len(self._replicas)
            r = _Replica(index=index,
                         port_file=os.path.join(
                             self._state_dir,
                             f"replica-{index}.port"),
                         budget=RetryBudget(self.retry_times,
                                            self.retry_window_s))
            self._replicas.append(r)
        self._spawn(r)
        self._last_scale_at = now
        self._pressure_since = None
        self._m_scale.labels("up").inc()
        with self._fleet_lock:
            self.scale_events.append({
                "direction": "up", "replica": index,
                "fleet": self._fleet_size(), "signals": sig})
        self._flightrec.record(
            "scale.up", replica=index, fleet=self._fleet_size(),
            signals=sig)
        self._record_fleet_size("scale_up")
        self._persist_state()
        log.warning(
            "autoscaler: scale UP → replica %d spawned (fleet %d, "
            "queue=%.0f, p50=%.0fms)", index, self._fleet_size(),
            sig["queue"], sig["p50_ms"])

    def _scale_down(self, now: float, sig: Dict) -> None:
        """Retire the highest-index live replica via the SIGTERM
        drain contract: it finishes + acks in-flight batches, flushes
        metrics, and exits 0 — and is never restarted."""
        victim = None
        for r in reversed(self._fleet()):
            if r.proc is not None and r.proc.poll() is None \
                    and not r.retiring and not r.done \
                    and not r.degraded:
                victim = r
                break
        if victim is None:
            return
        victim.retiring = True
        # a retiring replica leaves the health/heartbeat watchdog, so
        # it needs its own wedge guard: past the drain window it is
        # SIGKILLed by _tick (same escalation drain_fleet applies)
        victim.retire_deadline = now + self.drain_timeout_s
        victim.proc.terminate()
        self._last_scale_at = now
        self._idle_since = None
        self._m_scale.labels("down").inc()
        with self._fleet_lock:
            self.scale_events.append({
                "direction": "down", "replica": victim.index,
                "fleet": self._fleet_size(), "signals": sig})
        self._flightrec.record(
            "scale.down", replica=victim.index,
            fleet=self._fleet_size(), signals=sig)
        self._record_fleet_size("scale_down")
        self._persist_state()
        log.warning(
            "autoscaler: scale DOWN → replica %d draining (fleet %d, "
            "idle %.1fs)", victim.index, self._fleet_size(),
            self.scale_down_idle_s)

    # ---------------------------------------------------------- health
    def _probe(self, r: _Replica) -> str:
        """One /healthz probe: ``ok`` | ``not_ready`` (503 — alive) |
        ``unreachable`` | ``no_port`` (not yet published)."""
        if r.port is None:
            try:
                with open(r.port_file) as f:
                    r.port = int(f.read().strip() or 0) or None
            except (OSError, ValueError):
                r.port = None
        if r.port is None:
            return "no_port"
        from urllib import error as urlerror
        from urllib import request as urlrequest
        try:
            with urlrequest.urlopen(
                    f"http://127.0.0.1:{r.port}/healthz",
                    timeout=1.0):
                return "ok"
        except urlerror.HTTPError as e:
            e.close()
            return "not_ready"     # 503: alive, deliberately not-ready
        except (urlerror.URLError, OSError):
            return "unreachable"

    def _poll_health(self, r: _Replica, now: float) -> None:
        if now - r.last_health_at < self.health_interval_s:
            return
        r.last_health_at = now
        status = self._probe(r)
        r.last_health = status
        if status in ("ok", "not_ready"):
            r.health_fails = 0
        elif status == "unreachable":
            r.health_fails += 1
            if r.health_fails >= self.health_fail_threshold:
                self._kill_replica(
                    r, f"/healthz unreachable x{r.health_fails}")
                return
        elif status == "no_port" and \
                now - r.spawned_at > self.startup_grace_s:
            self._kill_replica(
                r, f"no /healthz port published within "
                   f"{self.startup_grace_s:.0f}s of spawn")
            return
        # heartbeat staleness: a process that polls as running but
        # whose serve loop is wedged (hung predict, dead collective)
        # stops beating — flag it before clients notice
        if self.run_dir:
            hb = read_heartbeats(self.run_dir).get(r.index)
            if hb is not None and \
                    time.time() - float(hb.get("time", 0.0)) \
                    > self.heartbeat_timeout_s and \
                    now - r.spawned_at > self.heartbeat_timeout_s:
                self._kill_replica(
                    r, f"heartbeat stale > "
                       f"{self.heartbeat_timeout_s:.0f}s")

    def _kill_replica(self, r: _Replica, reason: str) -> None:
        """TERM→KILL a wedged replica; the next tick classifies its
        exit and routes it through the normal restart budget."""
        proc = r.proc
        if proc is None or proc.poll() is not None:
            return
        log.error("killing replica %d (pid %d): %s", r.index,
                  proc.pid, reason)
        r.kill_reason = reason
        self._flightrec.record(
            "replica.kill", replica=r.index, reason=reason)
        proc.terminate()
        try:
            proc.wait(2.0)
        except subprocess.TimeoutExpired:
            proc.kill()
            try:
                proc.wait(2.0)
            except subprocess.TimeoutExpired:   # pragma: no cover
                log.error("replica %d survived SIGKILL", r.index)

    # ------------------------------------------------------------- run loop
    def _tick(self) -> None:
        now = self._clock()
        alive = 0
        for r in self._fleet():
            if r.proc is None:
                if (not r.done and not r.degraded
                        and r.next_spawn_at is not None
                        and now >= r.next_spawn_at):
                    self._spawn(r)
                    alive += 1
                continue
            code = r.proc.poll()
            if code is None:
                alive += 1
                if r.retiring:
                    if now >= r.retire_deadline:
                        log.warning(
                            "replica %d ignored SIGTERM for %.0fs "
                            "during scale-down; escalating to "
                            "SIGKILL", r.index, self.drain_timeout_s)
                        r.proc.kill()
                        r.retire_deadline = now + 2.0   # reap window
                else:
                    self._poll_health(r, now)
            else:
                self._handle_exit(r, code)
        self._m_running.set(alive)
        self._autoscale(now)
        self._record_fleet_size("tick")

    def run(self, poll_interval_s: float = 0.25) -> Dict:
        """Supervise until drained; returns the fleet summary.  Raises
        :class:`DegradedTraining` on budget exhaustion (wrap the CLI
        in ``degraded_exit()`` for the exit-17 protocol)."""
        self.install_signal_handlers()
        for r in self._fleet():
            self._spawn(r)
        try:
            while not self._stop.is_set():
                self._tick()
                if all(r.done or r.degraded for r in self._fleet()):
                    break
                time.sleep(poll_interval_s)
        finally:
            self.drain_fleet()
            self._m_running.set(0)
        return self.summary()

    def run_background(self) -> threading.Thread:
        t = threading.Thread(target=self.run, daemon=True,
                             name="zoo-serving-supervisor")
        t.start()
        return t

    def wait_ready(self, timeout_s: float = 30.0) -> bool:
        """Block until every live replica answers /healthz 200 (for
        tests and scripted bring-up)."""
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            live = [r for r in self._fleet()
                    if not r.done and not r.degraded]
            if live and all(self._probe(r) == "ok" for r in live):
                return True
            time.sleep(0.1)
        return False

    def drain_fleet(self) -> Dict[int, Optional[int]]:
        """Graceful fleet drain: SIGTERM each replica (its handler
        finishes + acks in-flight batches and exits 0), escalate to
        SIGKILL per process past ``drain_timeout_s``, reap everything.
        Returns {replica_index: exit code}."""
        live = [r for r in self._fleet()
                if r.proc is not None and r.proc.poll() is None]
        for r in live:
            r.proc.terminate()
        deadline = time.monotonic() + self.drain_timeout_s
        codes: Dict[int, Optional[int]] = {}
        for r in live:
            try:
                code = r.proc.wait(
                    max(deadline - time.monotonic(), 0.1))
            except subprocess.TimeoutExpired:
                log.warning("replica %d ignored SIGTERM for %.0fs; "
                            "escalating to SIGKILL", r.index,
                            self.drain_timeout_s)
                r.proc.kill()
                try:
                    code = r.proc.wait(2.0)
                except subprocess.TimeoutExpired:  # pragma: no cover
                    code = None
            codes[r.index] = code
            r.last_exit = code
            if code == 0:
                r.done = True
            r.proc = None
        return codes

    def summary(self) -> Dict:
        with self._fleet_lock:
            rs = list(self._replicas)
            out = {
                "replicas": self.replicas,
                "restarts_total": self.restarts_total,
                "done": [r.index for r in rs if r.done],
                "degraded": [r.index for r in rs if r.degraded],
                "exit_codes": {r.index: r.last_exit for r in rs},
            }
            if self.autoscale:
                out["min_replicas"] = self.min_replicas
                out["max_replicas"] = self.max_replicas
                out["scale_events"] = list(self.scale_events)
                out["replica_trajectory"] = [
                    size for _t, size, _r in self.replica_trajectory]
        return out


def supervisor_main(argv=None) -> int:
    """``python -m analytics_zoo_torch.serving.supervisor``: run a
    replica fleet from config.yaml (``params.replicas`` /
    ``params.consumer_group``), speaking the launcher degraded-exit
    protocol on budget exhaustion."""
    p = argparse.ArgumentParser(prog="zoo-serving-supervisor")
    p.add_argument("--config", "-c", default="config.yaml")
    p.add_argument("--replicas", type=int, default=None,
                   help="replica count (default config "
                        "params.replicas, else 3)")
    p.add_argument("--consumer-group", default=None,
                   help="shared consumer group (default config "
                        "params.consumer_group, else 'serving')")
    p.add_argument("--run-dir", default=None,
                   help="fleet state dir: per-replica heartbeat "
                        "slots + degraded.json")
    p.add_argument("--retry-times", type=int, default=None)
    p.add_argument("--retry-window-s", type=float, default=None)
    p.add_argument("--drain-timeout-s", type=float, default=30.0)
    p.add_argument("--min-replicas", type=int, default=None,
                   help="autoscaler floor (default config "
                        "params.min_replicas; equal to --replicas "
                        "disables autoscaling)")
    p.add_argument("--max-replicas", type=int, default=None,
                   help="autoscaler ceiling (default config "
                        "params.max_replicas)")
    args = p.parse_args(argv)

    from analytics_zoo_torch.serving.server import ServingConfig
    cfg = (ServingConfig.from_yaml(args.config)
           if os.path.exists(args.config) else ServingConfig())

    def _cfg_int(key):
        v = cfg.extra.get(key)
        return int(v) if v not in (None, "") else None

    replicas = args.replicas
    if replicas is None:
        replicas = _cfg_int("params.replicas") or 3
    min_replicas = (args.min_replicas
                    if args.min_replicas is not None
                    else _cfg_int("params.min_replicas"))
    max_replicas = (args.max_replicas
                    if args.max_replicas is not None
                    else _cfg_int("params.max_replicas"))
    group = (args.consumer_group or cfg.consumer_group or "serving")
    sup = ServingSupervisor(
        cli_worker_factory(args.config, consumer_group=group),
        replicas=replicas,
        retry_times=args.retry_times,
        retry_window_s=args.retry_window_s,
        run_dir=args.run_dir,
        drain_timeout_s=args.drain_timeout_s,
        min_replicas=min_replicas,
        max_replicas=max_replicas)
    with degraded_exit():
        summary = sup.run()
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(supervisor_main())
