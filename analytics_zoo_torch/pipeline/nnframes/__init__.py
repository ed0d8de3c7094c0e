"""NNFrames: estimators and transformers over DataFrames, and the image
reader."""
from analytics_zoo_torch.pipeline.nnframes.nn_estimator import (
    NNClassifier, NNClassifierModel, NNEstimator, NNModel,
)
from analytics_zoo_torch.pipeline.nnframes.nn_image_reader import (
    NNImageReader,
)

__all__ = ["NNEstimator", "NNModel", "NNClassifier", "NNClassifierModel",
           "NNImageReader"]
