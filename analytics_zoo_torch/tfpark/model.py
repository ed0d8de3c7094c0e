"""TFPark KerasModel: training of tf.keras models (port of the JAX
package's ``tfpark/model.py``).

The architecture is converted to native layers once (``converter.py``)
and the native engine does everything; the loss and optimizer declared
on the tf.keras compile map to zoo equivalents as the reference maps
them — any tf.keras ``SGD`` becomes ``SGD(lr)``, its momentum dropped (a
reference fault the port keeps: ROADMAP.md, queue 3).  No TensorFlow is
imported: the compile facts are read off the model object (``loss``,
``optimizer``'s class name and ``learning_rate``, ``metrics_names``).
``train_on_batch`` and weight get/set mirror the reference surface.
"""

from __future__ import annotations

from typing import List

import numpy as np


_LOSS_MAP = {
    "sparse_categorical_crossentropy": "sparse_categorical_crossentropy",
    "categorical_crossentropy": "categorical_crossentropy",
    "binary_crossentropy": "binary_crossentropy",
    "mse": "mse", "mean_squared_error": "mse",
    "mae": "mae", "mean_absolute_error": "mae",
}


class KerasModel:
    def __init__(self, tf_keras_model):
        from analytics_zoo_torch.tfpark.converter import convert_keras_model
        self.tf_model = tf_keras_model
        self.model = convert_keras_model(tf_keras_model)
        self._compiled = False
        self._maybe_compile()

    def _maybe_compile(self):
        m = self.tf_model
        loss = getattr(m, "loss", None)
        if loss is None:
            return
        loss_name = loss if isinstance(loss, str) else \
            getattr(loss, "name", getattr(loss, "__name__", None))
        mapped = _LOSS_MAP.get(str(loss_name))
        if mapped is None:
            return
        # tf.keras models usually end in a softmax; the probability
        # losses are correct as-is.
        opt = getattr(m, "optimizer", None)
        opt_name = type(opt).__name__.lower() if opt is not None else "adam"
        try:
            lr = float(np.asarray(opt.learning_rate))
        except Exception:
            lr = 0.001
        from analytics_zoo_torch.pipeline.api.keras import optimizers as O
        zoo_opt = {"adam": O.Adam(lr=lr), "sgd": O.SGD(lr),
                   "rmsprop": O.RMSprop(lr=lr)}.get(opt_name, O.Adam(lr=lr))
        metrics = ["accuracy"] if getattr(m, "metrics_names", None) else []
        self.model.compile(optimizer=zoo_opt, loss=mapped, metrics=metrics)
        self._compiled = True

    # ------------------------------------------------------------- training
    def fit(self, x=None, y=None, batch_size=32, epochs=1,
            validation_data=None, distributed=True):
        assert self._compiled, \
            "compile the tf.keras model before wrapping (loss mapping)"
        return self.model.fit(x, y, batch_size=batch_size,
                              nb_epoch=epochs,
                              validation_data=validation_data)

    def train_on_batch(self, x, y):
        hist = self.model.fit(x, y, batch_size=len(np.asarray(y)),
                              nb_epoch=1)
        return hist[-1]["loss"]

    def evaluate(self, x, y, batch_size=32, distributed=True):
        return self.model.evaluate(x, y, batch_size=batch_size)

    def predict(self, x, batch_size=256, distributed=True):
        return self.model.predict(x, batch_size=batch_size)

    # -------------------------------------------------------------- weights
    def get_weights(self) -> List[np.ndarray]:
        return self.model.get_weights()

    def set_weights(self, weights) -> None:
        self.model.set_weights(weights)

    def save_model(self, path: str) -> None:
        self.model.save_model(path)

    def load_weights(self, path: str) -> None:
        self.model.load_weights(path)
