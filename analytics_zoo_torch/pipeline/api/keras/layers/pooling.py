"""Global max pooling over time (port of ``GlobalMaxPooling1D`` in
``pipeline/api/keras/layers/pooling.py``; channels-last)."""

from __future__ import annotations

from analytics_zoo_torch.pipeline.api.keras.engine import Layer


class GlobalMaxPooling1D(Layer):
    """(B, T, D) -> (B, D), the max over T."""

    def call(self, params, x, training=False, rng=None):
        return x.amax(dim=1)

    def compute_output_shape(self, s):
        return (s[0], s[-1])
