"""Training-health watchdog (port of the JAX package's
``observability/watchdog.py``): non-finite loss/grad detection, loss
divergence/plateau detection over a sliding window, and a stall
heartbeat — with a configurable policy.

The health signals are *first-class*: the train step folds an
``isfinite`` reduction over loss+grads into its program
(:func:`fold_finiteness_check`) and returns the flag as one of its
outputs; :class:`StepFlags` reads it on the host once the device has
computed it, with no sync of its own (the reference surfaces the same
flag through a host callback, which a captured CUDA graph cannot run);
the driver loop feeds observed losses and heartbeats; a background
thread flags stalls when no step completes within a deadline.  The policy decides what an unhealthy signal does:

* ``warn`` — structured log + metrics, training continues;
* ``checkpoint_and_halt`` — the Estimator snapshots through its
  checkpoint machinery and raises :class:`TrainingHalted` (which the
  failure-retry loop deliberately does NOT absorb — retrying a NaN'd
  step would replay the same poison).

Plateau and stall are *advisory* (always warn-only): halting a run for
a plateau would turn early stopping into a crash; a truly stalled loop
cannot run the halting code anyway, so the heartbeat thread's loud log
line and health gauge are the honest best-effort.

Metrics: ``train_nonfinite_total{source}``,
``watchdog_events_total{kind}``, ``train_health_status``
(0 healthy / 1 warned / 2 halt-pending).
"""

from __future__ import annotations

import logging
import math
import threading
import time
from typing import Callable, Dict, List, Optional

from analytics_zoo_torch.observability.metrics import (
    MetricsRegistry, get_registry)

log = logging.getLogger("analytics_zoo_torch.observability")

HEALTHY, WARNED, HALT_PENDING = 0, 1, 2


class TrainingHalted(RuntimeError):
    """Raised by the ``checkpoint_and_halt`` policy after the halt
    snapshot is written.  Carries ``issue`` (the triggering event
    dict) so callers can render the reason without parsing the
    message."""

    def __init__(self, message: str, issue: Optional[Dict] = None):
        super().__init__(message)
        self.issue = issue or {}


class TrainingWatchdog:
    """Aggregates health signals from three producers — the in-step
    finite check (delivered by :class:`StepFlags`), the driver loop
    (``beat``/``observe_loss``), and the stall monitor thread — into a
    queue of *issues* the driver polls between steps.

    ``clock`` is injectable for tests (defaults to
    ``time.monotonic``); all interval math uses it.
    """

    HALTING_KINDS = ("nonfinite", "divergence")

    def __init__(self, policy: Optional[str] = None,
                 window: Optional[int] = None,
                 min_delta: Optional[float] = None,
                 divergence: Optional[float] = None,
                 stall_timeout_s: Optional[float] = None,
                 clock: Callable[[], float] = time.monotonic,
                 registry: Optional[MetricsRegistry] = None):
        from analytics_zoo_torch.common.config import get_config
        cfg = get_config()
        self.policy = str(policy if policy is not None else cfg.get(
            "observability.watchdog_policy", "warn"))
        if self.policy not in ("warn", "checkpoint_and_halt"):
            raise ValueError(
                f"watchdog policy {self.policy!r}: expected 'warn' or "
                "'checkpoint_and_halt'")
        self.window = int(window if window is not None else cfg.get(
            "observability.watchdog_window", 50))
        self.min_delta = float(
            min_delta if min_delta is not None
            else cfg.get("observability.watchdog_min_delta", 1e-4))
        self.divergence = float(
            divergence if divergence is not None
            else cfg.get("observability.watchdog_divergence", 10.0))
        self.stall_timeout_s = float(
            stall_timeout_s if stall_timeout_s is not None
            else cfg.get("observability.watchdog_stall_s", 0.0))
        self._clock = clock
        self._registry = registry
        self._lock = threading.Lock()
        self._issues: List[Dict] = []
        self._best = math.inf
        self._since_improve = 0
        self._observed = 0
        self._nonfinite_seen = 0
        self._diverged_fired = False
        self._stall_fired = False
        self._drift_fired: set = set()   # series currently in episode
        self._last_beat = clock()
        self._halted = False
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._set_status(HEALTHY)

    def _reg(self) -> MetricsRegistry:
        return self._registry if self._registry is not None \
            else get_registry()

    def _set_status(self, value: int) -> None:
        try:
            self._reg().gauge(
                "train_health_status",
                "watchdog verdict: 0 healthy, 1 warned, 2 halt "
                "pending/halted").set(value)
        except Exception:
            pass

    def _push(self, kind: str, **detail) -> None:
        issue = {"kind": kind, **detail}
        with self._lock:
            self._issues.append(issue)
        try:
            self._reg().counter(
                "watchdog_events_total",
                "training-health events by kind",
                labels=("kind",)).labels(kind).inc()
        except Exception:
            pass
        # every watchdog episode is a flight event: the single
        # chokepoint all detectors (nonfinite/divergence/plateau/
        # stall/drift) funnel through
        try:
            from analytics_zoo_torch.observability.flightrec import \
                record_event
            record_event("watchdog.episode", issue=kind, **detail)
        except Exception:   # noqa: BLE001 — forensics never halts health
            pass

    # ------------------------------------------------------- producers
    def beat(self) -> None:
        """A train step completed — feeds the stall deadline.  A beat
        after a flagged stall ends that episode and re-arms the
        detector for the next one."""
        with self._lock:     # vs the heartbeat thread's check_stall
            self._last_beat = self._clock()
            self._stall_fired = False

    def record_nonfinite(self, source: str = "step") -> None:
        """A non-finite loss/grad was detected (a step's finite flag or
        a driver-side isfinite check).  The counter counts every
        occurrence; the issue (and its warning log) is throttled —
        under the warn policy a permanently-NaN run would otherwise
        log once per step."""
        try:
            self._reg().counter(
                "train_nonfinite_total",
                "steps whose loss or gradients were non-finite",
                labels=("source",)).labels(source).inc()
        except Exception:
            pass
        with self._lock:
            self._nonfinite_seen += 1
            n = self._nonfinite_seen
        if n == 1 or n % 100 == 0:
            self._push("nonfinite", source=source, occurrences=n)

    def observe_loss(self, loss: float) -> None:
        """Feed a host-synced loss sample (logging crossings / epoch
        ends — never forces an extra device sync)."""
        try:
            loss = float(loss)
        except (TypeError, ValueError):
            return
        if not math.isfinite(loss):
            self.record_nonfinite("loss_sample")
            return
        self._observed += 1
        scale = max(abs(self._best), 1.0)
        if not math.isfinite(self._best) \
                or loss < self._best - self.min_delta * scale:
            # first finite sample seeds best (inf arithmetic would
            # otherwise NaN the comparison and freeze it forever)
            self._best = loss
            self._since_improve = 0
            self._diverged_fired = False
            return
        self._since_improve += 1
        if (not self._diverged_fired
                and math.isfinite(self._best)
                and loss - self._best > self.divergence * scale):
            self._diverged_fired = True   # once until a new best
            self._push("divergence", loss=loss, best=self._best,
                       factor=self.divergence)
        if self.window > 0 and self._since_improve >= self.window:
            self._since_improve = 0       # re-arm: one event per window
            self._push("plateau", best=self._best, window=self.window,
                       min_delta=self.min_delta)

    def observe_drift(self, series: str, score: float) -> None:
        """Advisory drift signal from ``observability/drift.py``: a
        normalized score (1.0 = at the detector's z-threshold) for a
        watched metric series.  Like plateau/stall, drift never halts
        — a distribution shift is a reason to LOOK at a run, not to
        kill it — but it rides the same issue queue and
        ``watchdog_events_total{kind="drift"}`` counter so the driver
        loop and obs_report surface it next to loss-health events.
        One event per episode: re-arms when the series drops back
        under threshold."""
        try:
            score = float(score)
        except (TypeError, ValueError):
            return
        if score < 1.0:
            self._drift_fired.discard(series)
            return
        if series in self._drift_fired:
            return
        self._drift_fired.add(series)
        self._push("drift", series=series, score=round(score, 3))

    # ---------------------------------------------------- stall monitor
    def check_stall(self) -> bool:
        """One stall check against the injectable clock (the heartbeat
        thread calls this; tests call it directly with a fake clock)."""
        if self.stall_timeout_s <= 0:
            return False
        # guard and flag-set under one lock so a beat() landing between
        # them can't be stomped by a stale stall verdict; _push takes
        # the same (non-reentrant) lock, so it runs after release
        with self._lock:
            if self._stall_fired:
                return False
            idle = self._clock() - self._last_beat
            if idle <= self.stall_timeout_s:
                return False
            self._stall_fired = True      # once per stall episode
        self._push("stall", idle_s=round(idle, 1),
                   deadline_s=self.stall_timeout_s)
        log.error(
            "training stall: no step completed in %.0fs (deadline "
            "%.0fs) — the loop may be hung in dispatch, a collective, "
            "or the input pipeline", idle, self.stall_timeout_s)
        self._set_status(HALT_PENDING if self._halted else WARNED)
        return True

    def start_stall_monitor(self) -> "TrainingWatchdog":
        """Daemon heartbeat thread; no-op when the deadline is 0."""
        if self.stall_timeout_s <= 0 or self._thread is not None:
            return self
        # arm the deadline NOW: time between construction and start
        # (checkpoint restore, cache placement) is setup, not a stall
        self.beat()
        self._stop.clear()

        def run():
            while not self._stop.is_set():
                try:
                    self.check_stall()
                except Exception:
                    log.exception("stall check failed")
                self._stop.wait(min(self.stall_timeout_s / 4.0, 10.0))

        self._thread = threading.Thread(
            target=run, daemon=True, name="zoo-train-watchdog")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    # -------------------------------------------------------- consumer
    def poll(self) -> Optional[Dict]:
        """Drain the next pending issue (driver loop, between steps).

        Every issue is logged with structure; the return value is the
        first HALTING-ELIGIBLE issue when the policy is
        ``checkpoint_and_halt`` (the caller then snapshots and raises
        :class:`TrainingHalted`), else None."""
        halting = None
        while True:
            with self._lock:
                issue = self._issues.pop(0) if self._issues else None
            if issue is None:
                break
            log.warning("training-health event: %s", issue)
            self._set_status(WARNED)
            if (halting is None
                    and self.policy == "checkpoint_and_halt"
                    and issue["kind"] in self.HALTING_KINDS):
                halting = issue
        if halting is not None:
            self._halted = True
            self._set_status(HALT_PENDING)
        return halting

    def halted(self) -> bool:
        return self._halted


# -------------------------------------------------- process-wide hookup
_active_watchdog: Optional[TrainingWatchdog] = None
_active_lock = threading.Lock()


def set_active_watchdog(wd: Optional[TrainingWatchdog]
                        ) -> Optional[TrainingWatchdog]:
    """Install the watchdog the steps' finite flags report to; returns
    the previous one (restore it in a ``finally``)."""
    global _active_watchdog
    with _active_lock:
        prev = _active_watchdog
        _active_watchdog = wd
    return prev


def get_active_watchdog() -> Optional[TrainingWatchdog]:
    return _active_watchdog


def fold_finiteness_check(loss, grads):
    """IN-STEP: fold an ``isfinite(loss + Σ sum(g))`` reduction into the
    step (NaN/Inf propagate through the sums — one add-reduce per grad
    leaf, in the reference's order) and return the flag, a 0-d bool
    tensor on the step's device.  The step hands it back as one of its
    outputs (a captured graph's static output), and the trainer gives
    it to a :class:`StepFlags`, which reads it on the host once the
    device has computed it.  The reference surfaces the same flag
    through ``jax.debug.callback``; a host callback cannot run inside a
    captured CUDA graph, and a host read there would break the capture,
    so the flag leaves the step as data.  The single implementation
    every step builder calls, so the detection logic cannot diverge
    between them."""
    import torch
    from analytics_zoo_torch.pipeline.api.keras.topology import tree_leaves
    total = loss.detach().to(torch.float32)
    for g in tree_leaves(grads):
        total = total + g.detach().sum().to(torch.float32)
    return torch.isfinite(total)


class StepFlags:
    """The finite flags of dispatched steps, delivered to
    :func:`record_step_finiteness` on the host WITHOUT a device sync:
    each flag is copied into pinned host memory behind the step on its
    stream and an event recorded after it; :meth:`drain` delivers the
    flags whose events have completed, in step order (a CPU flag is
    ready at once).  The port's counterpart of the reference's
    asynchronous host callback: a flag arrives when the device has
    computed it, and the driver loop reads the watchdog between steps
    as before.  ``drain(wait=True)`` delivers every pending flag (the
    loop calls it only where it already synchronizes)."""

    # the host can run this far ahead of the device before a push waits
    # for the oldest flag (a bound on memory, never reached in practice:
    # the device's launch queue holds fewer steps)
    MAX_PENDING = 4096

    def __init__(self):
        from collections import deque
        self._pending = deque()

    def push(self, flag) -> None:
        """Queue the flag a step just returned (None: the check is off)
        and deliver the flags that are ready (a CPU flag at once)."""
        if flag is not None:
            if flag.device.type == "cuda":
                import torch
                host = torch.empty((), dtype=torch.bool, pin_memory=True)
                host.copy_(flag, non_blocking=True)
                event = torch.cuda.Event()
                event.record()
                self._pending.append((host, event))
            else:
                self._pending.append((flag, None))
        self.drain(wait=len(self._pending) > self.MAX_PENDING)

    def drain(self, wait: bool = False) -> int:
        """Deliver the ready flags (all of them with ``wait``); returns
        how many were delivered."""
        n = 0
        while self._pending:
            host, event = self._pending[0]
            if event is not None and not event.query():
                if not wait:
                    break
                event.synchronize()
            self._pending.popleft()
            record_step_finiteness(bool(host))
            n += 1
        return n

    def __len__(self) -> int:
        return len(self._pending)


def record_step_finiteness(finite) -> None:
    """The host end of the step's folded ``isfinite(loss + Σ grads)``
    flag (``StepFlags.drain``; the reference's ``jax.debug.callback``
    target).  Must never raise."""
    try:
        if bool(finite):
            return
        wd = get_active_watchdog()
        if wd is not None:
            wd.record_nonfinite("step")
        else:
            get_registry().counter(
                "train_nonfinite_total",
                "steps whose loss or gradients were non-finite",
                labels=("source",)).labels("step").inc()
    except Exception:
        pass
