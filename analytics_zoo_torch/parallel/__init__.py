"""The training engine and the device mesh: ``trainer`` (the steps),
``mesh`` (the six-axis mesh on ``torch.distributed`` and the sharding
specs), ``sharding`` (a model's specs), ``comm`` (the collectives),
``ring_attention``, ``pipeline``, ``launcher`` and ``launch_cli``."""

from analytics_zoo_torch.parallel.mesh import (
    DATA_AXIS,
    EXPERT_AXIS,
    FSDP_AXIS,
    MODEL_AXIS,
    PIPE_AXIS,
    SEQ_AXIS,
    batch_shardings,
    create_mesh,
    data_sharding,
    fsdp_shardings,
    local_batch_size,
    replicated,
)

__all__ = [
    "create_mesh",
    "data_sharding",
    "replicated",
    "batch_shardings",
    "fsdp_shardings",
    "local_batch_size",
    "DATA_AXIS",
    "FSDP_AXIS",
    "MODEL_AXIS",
    "SEQ_AXIS",
    "PIPE_AXIS",
    "EXPERT_AXIS",
]
