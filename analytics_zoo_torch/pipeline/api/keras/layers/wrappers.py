"""Wrapper layers (port of ``pipeline/api/keras/layers/wrappers.py``):
``TimeDistributed`` and ``KerasLayerWrapper``."""

from __future__ import annotations

from analytics_zoo_torch.pipeline.api.keras.engine import (
    Layer, Params, State, fold_name,
)


class TimeDistributed(Layer):
    """Apply an inner layer independently to every timestep, by folding
    time into the batch dim: one batched call of the inner layer.  The
    params are the inner layer's own, under this layer's name."""

    def __init__(self, layer: Layer, **kwargs):
        super().__init__(**kwargs)
        self.layer = layer

    def _inner_shape(self, input_shape):
        return (input_shape[0],) + tuple(input_shape[2:])

    def build(self, rng, input_shape) -> Params:
        return self.layer.init(fold_name(rng, self.layer.name),
                               self._inner_shape(input_shape))["params"]

    def init_state(self, input_shape) -> State:
        return self.layer.init_state(self._inner_shape(input_shape))

    def apply(self, params, x, state=None, training=False, rng=None):
        b, t = x.shape[0], x.shape[1]
        flat = x.reshape((b * t,) + tuple(x.shape[2:]))
        out, new_state = self.layer.apply(params, flat, state=state,
                                          training=training, rng=rng)
        return out.reshape((b, t) + tuple(out.shape[1:])), new_state

    def compute_output_shape(self, input_shape):
        inner = self.layer.compute_output_shape(
            self._inner_shape(input_shape))
        return (input_shape[0], input_shape[1]) + tuple(inner[1:])


class KerasLayerWrapper(Layer):
    """Wrap a ``(params, x) -> y`` function, with an optional
    ``build_fn(rng, input_shape) -> params`` and output-shape function, as
    a layer."""

    def __init__(self, forward_fn, build_fn=None, output_shape_fn=None,
                 **kwargs):
        super().__init__(**kwargs)
        self.forward_fn = forward_fn
        self.build_fn = build_fn
        self.output_shape_fn = output_shape_fn

    def build(self, rng, input_shape) -> Params:
        if self.build_fn is None:
            return {}
        return self.build_fn(rng, input_shape)

    def call(self, params, x, training=False, rng=None):
        return self.forward_fn(params, x)

    def compute_output_shape(self, input_shape):
        if self.output_shape_fn is None:
            return input_shape
        return self.output_shape_fn(input_shape)
