from analytics_zoo_torch.common.config import ZooConfig, get_config
from analytics_zoo_torch.common.zoo_context import (
    ZooContext,
    get_zoo_context,
    init_zoo_context,
    reset_zoo_context,
)
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

__all__ = ["ZooConfig", "get_config", "ZooContext", "get_zoo_context",
           "init_zoo_context", "reset_zoo_context", "Trigger", "EveryEpoch",
           "MaxEpoch", "MaxIteration", "SeveralIteration", "MinLoss",
           "MaxScore", "TriggerAnd", "TriggerOr"]
