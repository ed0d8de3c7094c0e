"""TFPark (port of ``tfpark/``): the text models.  The reference's
TF-graph modules (``KerasModel``, ``TFDataset``, ``TFOptimizer``,
``TFPredictor``, ``TFEstimator``) are not ported yet (ROADMAP.md)."""

from analytics_zoo_torch.tfpark import text  # noqa: F401

__all__ = ["text"]
