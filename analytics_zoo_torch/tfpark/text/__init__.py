"""TFPark text models (port of ``tfpark/text``)."""

from analytics_zoo_torch.tfpark.text.estimator import (  # noqa: F401
    BERTBaseEstimator, BERTClassifier, BERTNER, BERTSQuAD)
from analytics_zoo_torch.tfpark.text.keras_models import (  # noqa: F401
    IntentEntity, NER, SequenceTagger, TextKerasModel)
from analytics_zoo_torch.tfpark.text.bert_checkpoint import (  # noqa: F401
    bert_kwargs_from_config, load_bert_checkpoint)
