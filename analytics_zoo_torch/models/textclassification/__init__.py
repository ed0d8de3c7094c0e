from analytics_zoo_torch.models.textclassification.text_classifier import (
    TextClassifier,
)

__all__ = ["TextClassifier"]
