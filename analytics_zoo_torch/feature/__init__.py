"""Input pipeline: the in-memory FeatureSet, composable preprocessing and
the numpy image pipeline."""
from analytics_zoo_torch.feature.common import (
    ChainedPreprocessing, FnPreprocessing, Preprocessing, SplitColumns,
)
from analytics_zoo_torch.feature.feature_set import FeatureSet

__all__ = ["ChainedPreprocessing", "FeatureSet", "FnPreprocessing",
           "Preprocessing", "SplitColumns"]
