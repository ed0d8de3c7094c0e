"""Config, context and triggers.  The context names are imported on first
use: the config and the triggers are stdlib-only, and a control-plane
process (the batch coordinator, a numpy-only fleet worker) reads the
config without importing torch."""

from analytics_zoo_torch.common.config import ZooConfig, get_config
from analytics_zoo_torch.common.triggers import (
    Trigger,
    EveryEpoch,
    MaxEpoch,
    MaxIteration,
    SeveralIteration,
    MinLoss,
    MaxScore,
    TriggerAnd,
    TriggerOr,
)

_CONTEXT_NAMES = ("ZooContext", "get_zoo_context", "init_zoo_context",
                  "reset_zoo_context")


def __getattr__(name):
    if name in _CONTEXT_NAMES:
        from analytics_zoo_torch.common import zoo_context
        return getattr(zoo_context, name)
    raise AttributeError(f"module 'analytics_zoo_torch.common' has no "
                         f"attribute {name!r}")


__all__ = ["ZooConfig", "get_config", "ZooContext", "get_zoo_context",
           "init_zoo_context", "reset_zoo_context", "Trigger", "EveryEpoch",
           "MaxEpoch", "MaxIteration", "SeveralIteration", "MinLoss",
           "MaxScore", "TriggerAnd", "TriggerOr"]
