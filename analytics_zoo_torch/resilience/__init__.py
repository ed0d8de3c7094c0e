"""Fault injection, failure detection and the recovery policy (port of
the JAX package's ``resilience/``):

- :mod:`.chaos`    — deterministic, scriptable fault injection at the
                     serving sites (broker IO, decode, predict, HTTP) and
                     the trainer's per-step dispatch;
- :mod:`.detector` — failure taxonomy, worker exit-code classification,
                     and the run-dir heartbeat a serving replica writes;
- :mod:`.policy`   — the policy engine the Estimator's retry loop
                     dispatches through (the reference's time-windowed
                     retry budget is the TRANSIENT branch).

Mesh re-formation (``recovery``) comes with the multi-GPU slice
(ROADMAP.md, queue 1).
"""

from analytics_zoo_torch.resilience.chaos import (
    ChaosPlan,
    FaultSpec,
    InjectedFault,
    LostHost,
    PoisonedState,
    TransientFault,
    active_chaos,
    clear_chaos,
    install_chaos,
)
from analytics_zoo_torch.resilience.detector import (
    FailureClass,
    HostHeartbeat,
    classify_exit,
    classify_failure,
    is_preemption_like,
)
from analytics_zoo_torch.resilience.policy import (
    DEGRADED_EXIT_CODE,
    DegradedTraining,
    RecoveryAction,
    RecoveryDecision,
    RecoveryPolicy,
    RetryBudget,
    degraded_exit,
)

__all__ = [
    "ChaosPlan",
    "FaultSpec",
    "InjectedFault",
    "LostHost",
    "PoisonedState",
    "TransientFault",
    "active_chaos",
    "clear_chaos",
    "install_chaos",
    "FailureClass",
    "HostHeartbeat",
    "classify_exit",
    "classify_failure",
    "is_preemption_like",
    "DEGRADED_EXIT_CODE",
    "DegradedTraining",
    "RecoveryAction",
    "RecoveryDecision",
    "RecoveryPolicy",
    "RetryBudget",
    "degraded_exit",
]
