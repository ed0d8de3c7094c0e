"""Fault injection and failure detection for the serving slice (port of
the JAX package's ``resilience/``):

- :mod:`.chaos`    — deterministic, scriptable fault injection at the
                     serving sites (broker IO, decode, predict, HTTP);
- :mod:`.detector` — failure taxonomy, worker exit-code classification,
                     and the run-dir heartbeat a serving replica writes.

The recovery policy and mesh re-formation (``policy``, ``recovery``)
come with the multi-GPU slice (ROADMAP.md, queue 1).
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
]
