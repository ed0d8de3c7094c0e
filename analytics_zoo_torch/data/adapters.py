"""Legacy-FeatureSet → DataPipeline shims (port of the JAX package's
``data/adapters.py``).

``Estimator.train`` / ``KerasNet.fit`` accept
either layer; these helpers are the one place the two meet, so the
migration path (docs/data.md) is a one-line change per call site.
"""

from __future__ import annotations

from typing import Optional

from analytics_zoo_torch.data.pipeline import DataPipeline
from analytics_zoo_torch.data.source import ArraySource


def from_feature_set(feature_set, batch_size: int, *,
                     remainder: str = "drop",
                     shard_index: Optional[int] = None,
                     shard_count: Optional[int] = None,
                     num_workers: int = 0,
                     name: str = "train") -> DataPipeline:
    """Wrap an eager ``FeatureSet`` in a ``DataPipeline``.

    The pipeline reuses the FeatureSet's columnar arrays zero-copy and
    its ``shuffle``/``seed`` settings, but note the STREAMS DIFFER: the
    pipeline shards per host and its sampler draws an independent
    permutation, so this is a migration adapter, not a bit-exact
    re-encoding of ``FeatureSet.epoch_batches``.
    """
    return DataPipeline(
        ArraySource(feature_set.x, feature_set.y),
        batch_size=batch_size, shuffle=feature_set.shuffle,
        seed=feature_set.seed, remainder=remainder,
        shard_index=shard_index, shard_count=shard_count,
        num_workers=num_workers, name=name)


def as_data_pipeline(data, y=None, batch_size: int = 32,
                     **kwargs) -> DataPipeline:
    """Coerce a DataPipeline / FeatureSet / ndarray pytree into a
    DataPipeline (pass-through for an existing pipeline)."""
    if isinstance(data, DataPipeline):
        return data
    from analytics_zoo_torch.feature.feature_set import FeatureSet
    if isinstance(data, FeatureSet):
        return from_feature_set(data, batch_size, **kwargs)
    return DataPipeline(data, y, batch_size=batch_size, **kwargs)
