from analytics_zoo_torch.models.recommendation.recommender import (
    Recommender, UserItemFeature, UserItemPrediction,
)
from analytics_zoo_torch.models.recommendation.neuralcf import NeuralCF
from analytics_zoo_torch.models.recommendation.wide_and_deep import (
    ColumnFeatureInfo, WideAndDeep,
)
from analytics_zoo_torch.models.recommendation.session_recommender import (
    SessionRecommender,
)

__all__ = [
    "Recommender", "UserItemFeature", "UserItemPrediction", "NeuralCF",
    "ColumnFeatureInfo", "WideAndDeep", "SessionRecommender",
]
