"""TFPredictor: batched inference driver (port of the JAX package's
``tfpark/tf_predictor.py``): a native model + dataset; ``predict()``
batches through the device with the shared predict path.
"""

from __future__ import annotations


class TFPredictor:
    def __init__(self, model, dataset):
        self.model = model
        self.dataset = dataset

    @classmethod
    def from_outputs(cls, model, dataset) -> "TFPredictor":
        """(ref from_outputs(sess, outputs): the 'outputs' are whatever
        the model's forward produces here.)"""
        return cls(model, dataset)

    @classmethod
    def from_keras(cls, keras_model, dataset) -> "TFPredictor":
        """(ref from_keras(keras_model, dataset))"""
        from analytics_zoo_torch.tfpark.model import KerasModel
        if not isinstance(keras_model, KerasModel):
            keras_model = KerasModel(keras_model)
        return cls(keras_model.model, dataset)

    def predict(self, batch_per_thread: int = -1):
        from analytics_zoo_torch.tfpark.tf_optimizer import (
            _dataset_to_featureset)
        fs, batch = _dataset_to_featureset(self.dataset, training=False)
        if batch_per_thread and batch_per_thread > 0:
            batch = batch_per_thread
        return self.model.predict(fs.x, batch_size=batch)
