"""``analytics_zoo_torch.data`` — the deterministic, checkpointable,
sharded input-pipeline engine (port of the JAX package's ``data/``).

Layers, bottom-up::

    Source        random-access records (ArraySource / NpyDirSource /
                  TFRecordSource)
    IndexSampler  pure (seed, epoch, step) -> per-shard batch indices
    Stage         composable host batch transforms (+ WorkerPool)
    DataPipeline  source + sampler + stages + an explicit, checkpoint-
                  able (epoch, step) position
    DeviceLoader  double-buffered host-to-device placement feeding the
                  trainer

Quick use::

    from analytics_zoo_torch.data import DataPipeline

    pipe = DataPipeline(x, y, batch_size=128, seed=7).map(normalize)
    est.train(pipe, "mse", end_trigger=MaxEpoch(5))   # resumable

A checkpointed training run restores mid-epoch on the exact next batch
(``pipe.state_dict()`` rides inside the Estimator snapshot).  The
batches, the permutations and the state dicts are those of the JAX
package for the same inputs.
"""

from analytics_zoo_torch.data.source import (
    ArraySource,
    NpyDirSource,
    Source,
    TFRecordSource,
    as_source,
)
from analytics_zoo_torch.data.sampler import IndexSampler
from analytics_zoo_torch.data.stages import (
    BatchStage,
    MapStage,
    PrefetchIterator,
    Stage,
    TransformStage,
    WorkerPool,
    pad_to_batch,
    run_stages,
)
from analytics_zoo_torch.data.pipeline import DataPipeline
from analytics_zoo_torch.data.device_loader import DeviceLoader
from analytics_zoo_torch.data.adapters import (
    as_data_pipeline,
    from_feature_set,
)

__all__ = [
    "ArraySource",
    "NpyDirSource",
    "Source",
    "TFRecordSource",
    "as_source",
    "IndexSampler",
    "BatchStage",
    "MapStage",
    "PrefetchIterator",
    "Stage",
    "TransformStage",
    "WorkerPool",
    "pad_to_batch",
    "run_stages",
    "DataPipeline",
    "DeviceLoader",
    "as_data_pipeline",
    "from_feature_set",
]
