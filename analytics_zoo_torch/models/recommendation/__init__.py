from analytics_zoo_torch.models.common import ZooModel
from analytics_zoo_torch.models.recommendation.recommender import (
    Recommender, UserItemFeature, UserItemPrediction,
)
from analytics_zoo_torch.models.recommendation.neuralcf import NeuralCF
from analytics_zoo_torch.models.recommendation.wide_and_deep import (
    ColumnFeatureInfo, WideAndDeep,
)


class SessionRecommender(ZooModel):
    """Not ported: the session recommender needs the recurrent layers."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "SessionRecommender needs GRU, which is not ported to the "
            "PyTorch package yet (ROADMAP.md, queue 1)")


__all__ = [
    "Recommender", "UserItemFeature", "UserItemPrediction", "NeuralCF",
    "ColumnFeatureInfo", "WideAndDeep", "SessionRecommender",
]
