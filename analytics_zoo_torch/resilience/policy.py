"""Recovery policy engine: classified failure -> recovery action (port
of the JAX package's ``resilience/policy.py``).

The reference's failure handling was a single rule — restore the last
snapshot and replay, ``bigdl.failure.retryTimes`` times per
``retryTimeInterval`` window (Topology.scala:1179-1261).  That rule is
kept bit-for-bit as the TRANSIENT/UNKNOWN branch (:class:`RetryBudget`
is the exact time-windowed budget the Estimator used inline), but it
is now one branch of a policy over :class:`FailureClass`:

============== =============================================== =======
failure class  action                                          budget
============== =============================================== =======
transient /    ``RETRY``: restore latest snapshot, replay      retry
unknown        (needs a checkpoint dir)                        window
lost_host      ``REFORM_MESH``: re-form the mesh on the        max
               surviving topology, reshard, resume from the    reform-
               snapshot + pipeline position (train.elastic)    ations
lost_host,     ``DEGRADE``: checkpoint-and-queue — persist a   —
no viable      structured ``degraded`` record and raise
topology       :class:`DegradedTraining` (bench/CI emit a
               partial result instead of timing out empty)
poisoned /     ``RAISE``: retrying replays the poison
unrecoverable  (TrainingHalted & friends are never absorbed)
============== =============================================== =======

Stdlib only.  The port's single-device ``Estimator`` builds the policy
with ``elastic=False`` (a lost host takes the retry budget): mesh
re-formation comes with the multi-GPU slice (ROADMAP.md, queue 1).
"""

from __future__ import annotations

import contextlib
import dataclasses
import enum
import json
import sys
import time
from typing import Callable, Optional

from analytics_zoo_torch.resilience.detector import (
    FailureClass, classify_failure)

#: Exit code a worker should use when it ends DEGRADED (structured
#: partial result written, work queued at the last snapshot) — the
#: launcher distinguishes this from a crash (``zoo-launch
#: --max-degraded``).
DEGRADED_EXIT_CODE = 17


class RecoveryAction(enum.Enum):
    RETRY = "retry"
    REFORM_MESH = "reform_mesh"
    DEGRADE = "degrade"
    RAISE = "raise"


@dataclasses.dataclass(frozen=True)
class RecoveryDecision:
    action: RecoveryAction
    failure_class: FailureClass
    reason: str


class DegradedTraining(RuntimeError):
    """Training could not continue on any viable topology; the run
    ended in checkpoint-and-queue mode.  ``result`` is the structured
    record (status/reason/iteration/snapshot/data position) that
    bench, the launcher, and CI surface instead of an empty timeout."""

    def __init__(self, message: str, result: Optional[dict] = None):
        super().__init__(message)
        self.result = result or {}


@contextlib.contextmanager
def degraded_exit(stream=None):
    """Wrap a launched worker's main so a degraded run speaks the
    launcher protocol: :class:`DegradedTraining` escaping the block
    prints its structured result as one JSON line and exits with
    :data:`DEGRADED_EXIT_CODE` — which ``zoo-launch --max-degraded``
    counts as a partial result, not a crash.  Without this mapping a
    degraded worker dies rc=1 and is indistinguishable from one that
    crashed on its own bug.

    >>> with degraded_exit():
    ...     estimator.train(...)
    """
    try:
        yield
    except DegradedTraining as e:
        print(json.dumps(e.result),
              file=stream if stream is not None else sys.stdout,
              flush=True)
        sys.exit(DEGRADED_EXIT_CODE)


class RetryBudget:
    """The reference's time-windowed retry budget, extracted verbatim
    from the Estimator's inline bookkeeping so it is testable: the
    budget refills to ``retry_times`` whenever more than ``window_s``
    passed since the LAST failure (interval between failures, not
    since the refill), and each failure consumes one unit.

    ``clock`` is injectable (monotonic by contract: a wall-clock/NTP
    adjustment must not reset or starve the budget)."""

    def __init__(self, retry_times: int, window_s: float,
                 clock: Callable[[], float] = time.perf_counter):
        self.retry_times = int(retry_times)
        self.window_s = float(window_s)
        self._clock = clock
        self._remaining = int(retry_times)
        self._last_failure: Optional[float] = None

    @property
    def remaining(self) -> int:
        return self._remaining

    def consume(self) -> bool:
        """Record one failure; True while the budget absorbs it."""
        now = self._clock()
        if self._last_failure is None or \
                now - self._last_failure > self.window_s:
            self._remaining = self.retry_times
        self._last_failure = now
        self._remaining -= 1
        return self._remaining >= 0


class RecoveryPolicy:
    """Decide what a classified failure does to the training loop.

    Stateful across one training run: the retry budget and the
    mesh-reformation count live here, so the Estimator's except block
    reduces to dispatching on the returned action."""

    def __init__(self, budget: RetryBudget, elastic: bool = True,
                 max_reformations: int = 2,
                 classifier=classify_failure):
        self.budget = budget
        self.elastic = bool(elastic)
        self.max_reformations = int(max_reformations)
        self.reformations = 0
        self._classify = classifier

    def decide(self, exc: BaseException,
               have_checkpoint: bool) -> RecoveryDecision:
        fc = self._classify(exc)
        if fc in (FailureClass.POISONED_STATE,
                  FailureClass.UNRECOVERABLE):
            return RecoveryDecision(
                RecoveryAction.RAISE, fc,
                "retrying would replay the same poisoned state")
        if fc is FailureClass.LOST_HOST and self.elastic:
            if self.reformations >= self.max_reformations:
                return RecoveryDecision(
                    RecoveryAction.DEGRADE, fc,
                    f"mesh already re-formed {self.reformations}x "
                    f"(train.max_mesh_reformations="
                    f"{self.max_reformations}); topology keeps "
                    "shrinking — queueing at the last snapshot")
            self.reformations += 1
            return RecoveryDecision(
                RecoveryAction.REFORM_MESH, fc,
                "re-forming the mesh on the surviving topology "
                f"(reformation {self.reformations}/"
                f"{self.max_reformations})")
        # TRANSIENT / UNKNOWN (and LOST_HOST with elastic disabled):
        # the reference's restore-and-replay rule, budgeted per window
        if not self.budget.consume():
            return RecoveryDecision(
                RecoveryAction.RAISE, fc,
                f"retry budget exhausted ({self.budget.retry_times} "
                f"failures within {self.budget.window_s:.0f}s)")
        if not have_checkpoint:
            return RecoveryDecision(
                RecoveryAction.RAISE, fc,
                "no checkpoint dir to restore from (set model_dir)")
        return RecoveryDecision(
            RecoveryAction.RETRY, fc,
            f"restore latest snapshot and replay "
            f"({self.budget.remaining} retries left in window)")
