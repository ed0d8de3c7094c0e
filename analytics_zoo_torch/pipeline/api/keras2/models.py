"""keras2 model containers: Keras-2 calling conventions over the
keras-1 engine (port of ``pipeline/api/keras2/models.py``).

Reference: pyzoo/zoo/pipeline/api/keras2/engine/{topology,training}.py
are empty py2/3 shims — the reference never finished this surface.
Here the containers are real: ``fit(epochs=...)``/``validation_split``
Keras-2 ergonomics delegating to the native KerasNet engine.
"""

from __future__ import annotations

from analytics_zoo_torch.pipeline.api.keras import topology as k1


class _Keras2Fit:
    def fit(self, x, y=None, batch_size: int = 32, epochs: int = 10,
            validation_data=None, validation_split: float = 0.0,
            shuffle: bool = True, **kw):
        """Keras-2 arg names (``epochs``) → the keras-1 engine."""
        return super().fit(x, y, batch_size=batch_size, nb_epoch=epochs,
                           validation_data=validation_data,
                           validation_split=validation_split,
                           shuffle=shuffle, **kw)


class Sequential(_Keras2Fit, k1.Sequential):
    pass


class Model(_Keras2Fit, k1.Model):
    pass
