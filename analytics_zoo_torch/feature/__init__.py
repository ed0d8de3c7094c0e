"""Input pipeline: the in-memory FeatureSet."""
from analytics_zoo_torch.feature.feature_set import FeatureSet

__all__ = ["FeatureSet"]
