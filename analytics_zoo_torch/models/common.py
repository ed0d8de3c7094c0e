"""Model-zoo base class (port of ``models/common.py``).

A ZooModel is a thin facade over an inner KerasNet graph built by
``build_model``; compile/fit/evaluate/predict/predict_classes,
quantize/is_quantized, the variables surface and save_model/load_weights
delegate to it.
"""

from __future__ import annotations


class ZooModel:
    """Base: subclasses implement ``build_model() -> KerasNet``."""

    def __init__(self, **kwargs):
        self.model = self.build_model()

    def build_model(self):
        raise NotImplementedError

    def compile(self, *args, **kwargs):
        self.model.compile(*args, **kwargs)
        return self

    def fit(self, *args, **kwargs):
        return self.model.fit(*args, **kwargs)

    def evaluate(self, *args, **kwargs):
        return self.model.evaluate(*args, **kwargs)

    def predict(self, *args, **kwargs):
        return self.model.predict(*args, **kwargs)

    def predict_classes(self, *args, **kwargs):
        return self.model.predict_classes(*args, **kwargs)

    def quantize(self, calib_data, **kwargs):
        """Calibrated int8 conversion (``KerasNet.quantize``): after this,
        predict, recommend and serving run the int8 products."""
        self.model.quantize(calib_data, **kwargs)
        return self

    @property
    def is_quantized(self) -> bool:
        return self.model.is_quantized

    def get_variables(self):
        return self.model.get_variables()

    def set_variables(self, variables):
        self.model.set_variables(variables)

    def get_weights(self):
        return self.model.get_weights()

    def set_weights(self, weights):
        self.model.set_weights(weights)

    def save_model(self, path: str, over_write: bool = True):
        self.model.save_model(path, over_write=over_write)

    def load_weights(self, path: str):
        self.model.load_weights(path)
        return self
