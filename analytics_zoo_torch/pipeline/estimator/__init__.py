from analytics_zoo_torch.pipeline.estimator.estimator import Estimator
from analytics_zoo_torch.pipeline.estimator.local_estimator import (
    LocalEstimator)

__all__ = ["Estimator", "LocalEstimator"]
