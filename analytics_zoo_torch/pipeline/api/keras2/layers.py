"""Keras-2 layer set — real classes with keras-2 semantics (port of
``pipeline/api/keras2/layers.py``).

Reference: zoo/pipeline/api/keras2/layers/ (20 layer classes: Dense,
Conv1D/2D, pooling + global pooling families, Cropping1D,
LocallyConnected1D, Activation, Dropout, Flatten, Softmax, and the
Average/Maximum/Minimum merges).  These are not just argument renames:
keras-2 adds ``bias_initializer`` (keras-1 hard-wires zeros),
``data_format`` (channels_first/channels_last), conv ``dilation_rate``,
merge-as-class functional layers, and an ``axis`` on Softmax.

Each class SUBCLASSES the keras-1 engine layer, so the pure-functional
params/apply machinery, shape inference, and the training stack are
shared — only the keras-2 surface and semantics live here.  The
lowercase functional helpers (``add``, ``concatenate``, ...) mirror
keras-2's ``keras.layers.add`` API.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from analytics_zoo_torch.pipeline.api.keras import layers as k1
from analytics_zoo_torch.pipeline.api.keras.engine import Layer, Params


def _pair(v) -> Tuple[int, int]:
    return (v, v) if isinstance(v, int) else tuple(v)


def _one(v) -> int:
    return v[0] if isinstance(v, (tuple, list)) else int(v)


def _df_to_ordering(data_format: Optional[str]) -> str:
    if data_format in (None, "channels_last"):
        return "tf"
    if data_format == "channels_first":
        return "th"
    raise ValueError(f"unknown data_format {data_format!r}")


class _BiasInitMixin:
    """keras-2 ``bias_initializer`` on layers whose keras-1 parent
    hard-wires bias init to zeros."""

    def _set_bias_init(self, bias_initializer):
        self._bias_initializer = bias_initializer

    def build(self, rng, input_shape) -> Params:
        params = super().build(rng, input_shape)
        bi = getattr(self, "_bias_initializer", None)
        if bi not in (None, "zero", "zeros") and "bias" in params:
            from analytics_zoo_torch.ops import initializers as inits
            from analytics_zoo_torch.ops.dtypes import get_policy
            from analytics_zoo_torch.pipeline.api.keras.engine import (
                fold_name)
            shape = params["bias"].shape
            params["bias"] = inits.get(bi)(
                fold_name(rng, "bias_k2"), shape,
                get_policy().param_dtype)
        return params


class Dense(_BiasInitMixin, k1.Dense):
    """(ref keras2/layers/Dense.scala)"""

    def __init__(self, units: int, activation=None, use_bias: bool = True,
                 kernel_initializer="glorot_uniform",
                 bias_initializer="zeros", kernel_regularizer=None,
                 bias_regularizer=None, **kwargs):
        super().__init__(units, init=kernel_initializer,
                         activation=activation,
                         W_regularizer=kernel_regularizer,
                         b_regularizer=bias_regularizer, bias=use_bias,
                         **kwargs)
        self._set_bias_init(bias_initializer)


class Conv1D(_BiasInitMixin, k1.Convolution1D):
    """(ref keras2/layers/Conv1D.scala)"""

    def __init__(self, filters: int, kernel_size, strides=1,
                 padding: str = "valid", activation=None,
                 use_bias: bool = True,
                 kernel_initializer="glorot_uniform",
                 bias_initializer="zeros", kernel_regularizer=None,
                 bias_regularizer=None, **kwargs):
        super().__init__(filters, _one(kernel_size),
                         strides=(_one(strides),), border_mode=padding,
                         activation=activation, bias=use_bias,
                         init=kernel_initializer,
                         W_regularizer=kernel_regularizer,
                         b_regularizer=bias_regularizer, **kwargs)
        self._set_bias_init(bias_initializer)


class Conv2D(_BiasInitMixin, k1.Convolution2D):
    """(ref keras2/layers/Conv2D.scala) — adds data_format and
    dilation_rate over the keras-1 Convolution2D."""

    def __init__(self, filters: int, kernel_size, strides=(1, 1),
                 padding: str = "valid", data_format: str = None,
                 dilation_rate=(1, 1), activation=None,
                 use_bias: bool = True,
                 kernel_initializer="glorot_uniform",
                 bias_initializer="zeros", kernel_regularizer=None,
                 bias_regularizer=None, **kwargs):
        kh, kw = _pair(kernel_size)
        super().__init__(filters, kh, kw, subsample=_pair(strides),
                         border_mode=padding,
                         dim_ordering=_df_to_ordering(data_format),
                         dilation=_pair(dilation_rate),
                         activation=activation, bias=use_bias,
                         init=kernel_initializer,
                         W_regularizer=kernel_regularizer,
                         b_regularizer=bias_regularizer, **kwargs)
        self._set_bias_init(bias_initializer)


class MaxPooling1D(k1.MaxPooling1D):
    def __init__(self, pool_size: int = 2, strides=None,
                 padding: str = "valid", **kwargs):
        super().__init__(
            pool_length=_one(pool_size),
            stride=None if strides is None else _one(strides),
            border_mode=padding, **kwargs)


class AveragePooling1D(k1.AveragePooling1D):
    def __init__(self, pool_size: int = 2, strides=None,
                 padding: str = "valid", **kwargs):
        super().__init__(
            pool_length=_one(pool_size),
            stride=None if strides is None else _one(strides),
            border_mode=padding, **kwargs)


class MaxPooling2D(k1.MaxPooling2D):
    def __init__(self, pool_size=(2, 2), strides=None,
                 padding: str = "valid", data_format: str = None,
                 **kwargs):
        if _df_to_ordering(data_format) != "tf":
            raise NotImplementedError(
                "pooling supports data_format='channels_last' (NHWC is "
                "the reference's layout); transpose inputs instead")
        super().__init__(
            pool_size=_pair(pool_size),
            strides=None if strides is None else _pair(strides),
            border_mode=padding, **kwargs)


class AveragePooling2D(k1.AveragePooling2D):
    def __init__(self, pool_size=(2, 2), strides=None,
                 padding: str = "valid", data_format: str = None,
                 **kwargs):
        if _df_to_ordering(data_format) != "tf":
            raise NotImplementedError(
                "pooling supports data_format='channels_last' (NHWC is "
                "the reference's layout); transpose inputs instead")
        super().__init__(
            pool_size=_pair(pool_size),
            strides=None if strides is None else _pair(strides),
            border_mode=padding, **kwargs)


class Cropping1D(k1.Cropping1D):
    """(ref keras2/layers/Cropping1D.scala)"""

    def __init__(self, cropping=(1, 1), **kwargs):
        super().__init__(cropping=_pair(cropping), **kwargs)


class LocallyConnected1D(k1.LocallyConnected1D):
    """(ref keras2/layers/LocallyConnected1D.scala) — keras-2 supports
    only 'valid' padding here, as does the reference."""

    def __init__(self, filters: int, kernel_size, strides=1,
                 padding: str = "valid", activation=None,
                 use_bias: bool = True, **kwargs):
        if padding != "valid":
            raise ValueError(
                "LocallyConnected1D supports padding='valid' only "
                "(keras-2 semantics)")
        super().__init__(filters, _one(kernel_size),
                         activation=activation,
                         subsample_length=_one(strides), bias=use_bias,
                         **kwargs)


# global pooling family + pass-throughs — same semantics in keras-2;
# exported as CLASSES so isinstance/subclass use works
GlobalAveragePooling1D = k1.GlobalAveragePooling1D
GlobalAveragePooling2D = k1.GlobalAveragePooling2D
GlobalAveragePooling3D = k1.GlobalAveragePooling3D
GlobalMaxPooling1D = k1.GlobalMaxPooling1D
GlobalMaxPooling2D = k1.GlobalMaxPooling2D
GlobalMaxPooling3D = k1.GlobalMaxPooling3D
Activation = k1.Activation
Flatten = k1.Flatten


class Dropout(k1.Dropout):
    """keras-2 spells the probability ``rate`` (keras-1: ``p``)."""

    def __init__(self, rate: float, **kwargs):
        super().__init__(rate, **kwargs)


class Softmax(Layer):
    """Softmax with a keras-2 ``axis`` argument
    (ref keras2/layers/Softmax.scala; keras-1's is last-axis only)."""

    def __init__(self, axis: int = -1, **kwargs):
        super().__init__(**kwargs)
        self.axis = int(axis)

    def call(self, params, x, training=False, rng=None):
        return torch.softmax(x, dim=self.axis)

    def compute_output_shape(self, input_shape):
        return input_shape


class _KerasMerge(k1.Merge):
    """keras-2 merges are standalone classes (Average.scala,
    Maximum.scala, Minimum.scala) rather than a mode string."""

    _mode = "sum"

    def __init__(self, **kwargs):
        super().__init__(mode=self._mode, **kwargs)


class Average(_KerasMerge):
    _mode = "ave"


class Maximum(_KerasMerge):
    _mode = "max"


class Minimum(_KerasMerge):
    _mode = "min"


class Add(_KerasMerge):
    _mode = "sum"


class Multiply(_KerasMerge):
    _mode = "mul"


class Subtract(_KerasMerge):
    _mode = "sub"


class Concatenate(k1.Merge):
    def __init__(self, axis: int = -1, **kwargs):
        super().__init__(mode="concat", concat_axis=axis, **kwargs)


# ------------------------------------------------ functional merge API
def add(inputs, **kw):
    return Add(**kw)(list(inputs))


def multiply(inputs, **kw):
    return Multiply(**kw)(list(inputs))


def average(inputs, **kw):
    return Average(**kw)(list(inputs))


def maximum(inputs, **kw):
    return Maximum(**kw)(list(inputs))


def minimum(inputs, **kw):
    return Minimum(**kw)(list(inputs))


def subtract(inputs, **kw):
    assert len(inputs) == 2
    return Subtract(**kw)(list(inputs))


def concatenate(inputs, axis=-1, **kw):
    return Concatenate(axis=axis, **kw)(list(inputs))


__all__ = [
    "Dense", "Conv1D", "Conv2D", "MaxPooling1D", "MaxPooling2D",
    "AveragePooling1D", "AveragePooling2D", "GlobalAveragePooling1D",
    "GlobalAveragePooling2D", "GlobalAveragePooling3D",
    "GlobalMaxPooling1D", "GlobalMaxPooling2D", "GlobalMaxPooling3D",
    "Cropping1D", "LocallyConnected1D", "Activation", "Dropout",
    "Flatten", "Softmax", "Average", "Maximum", "Minimum", "Add",
    "Multiply", "Subtract", "Concatenate", "add", "multiply", "average",
    "maximum", "minimum", "subtract", "concatenate",
    "LSTM", "GRU", "SimpleRNN", "Embedding", "BatchNormalization",
]


class _Keras2RNN:
    """Keras-2 recurrent arg names: units, recurrent_activation,
    kernel_initializer/recurrent_initializer, *_regularizer."""

    def __init__(self, units, activation="tanh",
                 recurrent_activation="sigmoid",
                 return_sequences=False, go_backwards=False,
                 kernel_initializer="glorot_uniform",
                 recurrent_initializer="orthogonal",
                 kernel_regularizer=None, recurrent_regularizer=None,
                 bias_regularizer=None, **kw):
        super().__init__(
            units, activation=activation,
            inner_activation=recurrent_activation,
            return_sequences=return_sequences,
            go_backwards=go_backwards, init=kernel_initializer,
            inner_init=recurrent_initializer,
            W_regularizer=kernel_regularizer,
            U_regularizer=recurrent_regularizer,
            b_regularizer=bias_regularizer, **kw)


class LSTM(_Keras2RNN, k1.LSTM):
    def __init__(self, units, *args, unit_forget_bias=True, **kw):
        # keras-2 default: forget-gate bias initialised to 1
        # (keyword-only so LSTM(64, "relu") still binds activation)
        super().__init__(units, *args,
                         unit_forget_bias=unit_forget_bias, **kw)


class GRU(_Keras2RNN, k1.GRU):
    pass


class SimpleRNN(_Keras2RNN, k1.SimpleRNN):
    pass


class Embedding(k1.Embedding):
    def __init__(self, input_dim, output_dim,
                 embeddings_initializer="uniform",
                 embeddings_regularizer=None, mask_zero=False,
                 **kw):
        if mask_zero:
            import warnings
            warnings.warn(
                "keras2.Embedding(mask_zero=True): embedded vectors of "
                "id-0 steps are zeroed, but downstream RNN layers do "
                "NOT skip masked timesteps (keras-2 carries state "
                "through them); final states can differ from Keras 2 "
                "on padded sequences", stacklevel=2)
        super().__init__(input_dim, output_dim,
                         init=embeddings_initializer,
                         W_regularizer=embeddings_regularizer,
                         mask_zero=mask_zero, **kw)


class BatchNormalization(k1.BatchNormalization):
    def __init__(self, axis=-1, momentum=0.99, epsilon=1e-3,
                 center=True, scale=True,
                 beta_initializer="zero", gamma_initializer="one",
                 **kw):
        super().__init__(epsilon=epsilon, momentum=momentum,
                         beta_init=beta_initializer,
                         gamma_init=gamma_initializer, axis=axis,
                         scale=scale, center=center, **kw)
