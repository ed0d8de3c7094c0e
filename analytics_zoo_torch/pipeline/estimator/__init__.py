from analytics_zoo_torch.pipeline.estimator.estimator import Estimator

__all__ = ["Estimator"]
