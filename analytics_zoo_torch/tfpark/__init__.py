"""TFPark (port of ``tfpark/``): tf.keras models converted to native
layers and trained on the zoo engine (``KerasModel``, ``TFOptimizer``,
``TFEstimator``, ``TFPredictor``, ``TFDataset``), the TF1 ``train_op``
importer, GAN training, and the text models."""

from analytics_zoo_torch.tfpark.model import KerasModel
from analytics_zoo_torch.tfpark.tf_dataset import TFDataset
from analytics_zoo_torch.tfpark.tf_optimizer import TFOptimizer
from analytics_zoo_torch.tfpark.tf_predictor import TFPredictor
from analytics_zoo_torch.tfpark.estimator import (ModeKeys, TFEstimator,
                                                  TFEstimatorSpec)
from analytics_zoo_torch.tfpark import text  # noqa: F401

__all__ = ["KerasModel", "TFDataset", "TFOptimizer", "TFPredictor",
           "TFEstimator", "TFEstimatorSpec", "ModeKeys", "text"]
