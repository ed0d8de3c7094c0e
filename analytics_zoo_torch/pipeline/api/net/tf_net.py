"""TFNet: run a TensorFlow model as a forward-only framework layer (port
of the JAX package's ``pipeline/api/net/tf_net.py``).

The reference stages the TF function into JAX through
``jax2tf.call_tf``; the port makes the same call as a host round trip:
tensor -> numpy -> TF -> numpy -> tensor on the input's device.
``tf_fn`` is that call, differentiable as ``call_tf`` is (its backward
runs TF's ``GradientTape`` on the saved input); the layer's ``call``
stops the gradient, as the reference's does: TFNet is inference-only,
and tf.keras models train through ``tfpark.KerasModel``, which converts
the architecture to native layers.  A host round trip cannot be captured
into a CUDA graph, so everything here runs eagerly.  TensorFlow is
imported only inside the functions that call it.
"""

from __future__ import annotations

import numpy as np
import torch

from analytics_zoo_torch.pipeline.api.keras.engine import Layer


class _CallTF(torch.autograd.Function):
    """``y = f(x)`` through TensorFlow; ``dx = vjp(f)(x, dy)`` through
    ``tf.GradientTape``."""

    @staticmethod
    def forward(ctx, x, fn):
        import tensorflow as tf
        ctx.fn = fn
        ctx.x_np = x.detach().cpu().numpy()
        out = np.asarray(fn(tf.convert_to_tensor(ctx.x_np)))
        return torch.from_numpy(np.array(out, copy=True)).to(x.device)

    @staticmethod
    def backward(ctx, dy):
        import tensorflow as tf
        xt = tf.convert_to_tensor(ctx.x_np)
        with tf.GradientTape() as tape:
            tape.watch(xt)
            out = ctx.fn(xt)
        grad = tape.gradient(
            out, xt, output_gradients=tf.convert_to_tensor(
                dy.detach().cpu().numpy()))
        return torch.from_numpy(np.array(grad, copy=True)).to(dy.device), \
            None


class TFNet(Layer):
    def __init__(self, tf_callable, output_shape=None, **kwargs):
        """``tf_callable``: a tf.function / keras model / SavedModel
        signature mapping input tensor(s) -> output tensor."""
        super().__init__(**kwargs)
        self._tf_callable = tf_callable
        self._declared_output_shape = output_shape

    def tf_fn(self, x) -> torch.Tensor:
        """The TF function on a tensor, as ``call_tf`` stages it: the
        result lands on ``x``'s device and carries a gradient."""
        return _CallTF.apply(x, self._tf_callable)

    # ------------------------------------------------------------ factories
    @classmethod
    def from_saved_model(cls, path: str,
                         signature: str = "serving_default",
                         **kwargs) -> "TFNet":
        """(ref TFNetForInference.scala:35 SavedModel loading)"""
        import tensorflow as tf
        loaded = tf.saved_model.load(path)
        fn = loaded.signatures[signature]

        def single(x):
            out = fn(x)
            if isinstance(out, dict):
                return list(out.values())[0]
            return out

        net = cls(single, **kwargs)
        net._tf_loaded = loaded    # keep alive
        return net

    @classmethod
    def from_keras(cls, keras_model, **kwargs) -> "TFNet":
        import tensorflow as tf
        fn = tf.function(lambda x: keras_model(x, training=False))
        net = cls(fn, **kwargs)
        net._tf_loaded = keras_model
        return net

    # -------------------------------------------------------------- numeric
    def call(self, params, x, training=False, rng=None):
        return self.tf_fn(x).detach()   # forward-only, like TFNet

    def compute_output_shape(self, input_shape):
        if self._declared_output_shape is not None:
            return (input_shape[0],) + tuple(self._declared_output_shape)
        concrete = tuple(2 if d is None else d for d in input_shape)
        out = self.tf_fn(torch.zeros(concrete))
        return (None,) + tuple(out.shape[1:])

    def predict(self, x, batch_size: int = 256):
        """Batched prediction (the TFNet.predict surface), eager."""
        outs = []
        n = len(x)
        for lo in range(0, n, batch_size):
            xb = torch.from_numpy(np.ascontiguousarray(x[lo:lo + batch_size]))
            outs.append(self.tf_fn(xb).detach().cpu().numpy())
        return np.concatenate(outs)
