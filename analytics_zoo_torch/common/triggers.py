"""Trigger DSL controlling when training ends / validates / checkpoints
(the PyTorch port's copy of ``common/triggers.py``, which is stdlib-only:
the port imports nothing of the reference package).

Reference: ``ZooTrigger`` (zoo/common/ZooTrigger.scala:26-60) extends
BigDL's Trigger with slice-epoch awareness — ``EveryEpoch`` fires on
epoch boundaries even when one "epoch" is split into ``numSlice``
sub-epochs by DiskFeatureSet (FeatureSet.scala:585-662).

Triggers are predicates over an immutable ``TrainingState`` snapshot, so
they compose (`TriggerAnd`/`TriggerOr`) and stay trivially serialisable.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass
class TrainingState:
    """Host-side scalar state the engine maintains between steps."""
    epoch: int = 0            # completed epochs
    iteration: int = 0        # completed global steps
    slice_index: int = 0      # within-epoch slice (DiskFeatureSet analogue)
    num_slices: int = 1
    epoch_finished: bool = False   # true at an epoch boundary
    last_loss: float = float("inf")
    best_score: Optional[float] = None
    last_score: Optional[float] = None


class Trigger:
    def __call__(self, state: TrainingState) -> bool:
        raise NotImplementedError

    def __and__(self, other: "Trigger") -> "Trigger":
        return TriggerAnd(self, other)

    def __or__(self, other: "Trigger") -> "Trigger":
        return TriggerOr(self, other)


class EveryEpoch(Trigger):
    """Fires at true epoch boundaries (slice-aware, ZooTrigger.scala:31)."""

    def __call__(self, state: TrainingState) -> bool:
        return state.epoch_finished and (state.slice_index == 0)


class MaxEpoch(Trigger):
    def __init__(self, max_epoch: int):
        self.max_epoch = int(max_epoch)

    def __call__(self, state: TrainingState) -> bool:
        return state.epoch >= self.max_epoch


class MaxIteration(Trigger):
    def __init__(self, max_iteration: int):
        self.max_iteration = int(max_iteration)

    def __call__(self, state: TrainingState) -> bool:
        return state.iteration >= self.max_iteration


class SeveralIteration(Trigger):
    """Fires every ``interval`` iterations (ZooTrigger.scala:50)."""

    def __init__(self, interval: int):
        if interval <= 0:
            raise ValueError(f"SeveralIteration interval {interval} <= 0")
        self.interval = int(interval)

    def __call__(self, state: TrainingState) -> bool:
        return state.iteration > 0 and state.iteration % self.interval == 0


class MinLoss(Trigger):
    def __init__(self, min_loss: float):
        self.min_loss = float(min_loss)

    def __call__(self, state: TrainingState) -> bool:
        return state.last_loss < self.min_loss


class MaxScore(Trigger):
    def __init__(self, max_score: float):
        self.max_score = float(max_score)

    def __call__(self, state: TrainingState) -> bool:
        return state.last_score is not None and state.last_score > self.max_score


class TriggerAnd(Trigger):
    def __init__(self, *triggers: Trigger):
        self.triggers = triggers

    def __call__(self, state: TrainingState) -> bool:
        return all(t(state) for t in self.triggers)


class TriggerOr(Trigger):
    def __init__(self, *triggers: Trigger):
        self.triggers = triggers

    def __call__(self, state: TrainingState) -> bool:
        return any(t(state) for t in self.triggers)
