"""Host-side data stages (port of the JAX package's ``data/``): only
what the serving slice runs, ``pad_to_batch`` and ``WorkerPool``."""

from analytics_zoo_torch.data.stages import WorkerPool, pad_to_batch

__all__ = ["WorkerPool", "pad_to_batch"]
