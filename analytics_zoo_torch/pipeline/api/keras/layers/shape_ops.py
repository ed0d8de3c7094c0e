"""Shape-manipulation layers (port of
``pipeline/api/keras/layers/shape_ops.py``).

Reference surface: zoo/pipeline/api/keras/layers/{Select, Narrow, Squeeze,
ExpandDim, Expand, SplitTensor, SelectTable, Max, GetShape}.scala.

Dims follow the reference's Keras convention: a non-negative ``dim``
excludes the batch dimension (dim 0 = the first non-batch axis); a
negative dim counts from the end.  ``SplitTensor`` has several outputs
and ``SelectTable`` several inputs: both go through ``Model``'s
multi-input/multi-output graph.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from analytics_zoo_torch.pipeline.api.keras.engine import Layer


def _axis(dim: int, ndim: int) -> int:
    """Map a batch-excluded dim to an absolute axis (batch included)."""
    return dim + 1 if dim >= 0 else dim + ndim


class Select(Layer):
    """Index ``index`` along ``dim``, dropping that axis."""

    def __init__(self, dim: int, index: int, **kwargs):
        super().__init__(**kwargs)
        self.dim = int(dim)
        self.index = int(index)

    def compute_output_shape(self, input_shape):
        shape = list(input_shape)
        del shape[_axis(self.dim, len(shape))]
        return tuple(shape)

    def call(self, params, x, training=False, rng=None):
        return x.select(_axis(self.dim, x.ndim), self.index)


class Narrow(Layer):
    """Slice ``[offset, offset + length)`` along ``dim``; a negative
    ``length`` counts from the end (-1: to the end)."""

    def __init__(self, dim: int, offset: int, length: int = 1, **kwargs):
        super().__init__(**kwargs)
        self.dim = int(dim)
        self.offset = int(offset)
        self.length = int(length)

    def _length(self, size):
        if self.length < 0:
            return size - self.offset + self.length + 1
        return self.length

    def compute_output_shape(self, input_shape):
        shape = list(input_shape)
        ax = _axis(self.dim, len(shape))
        shape[ax] = self._length(shape[ax])
        return tuple(shape)

    def call(self, params, x, training=False, rng=None):
        ax = _axis(self.dim, x.ndim)
        return x.narrow(ax, self.offset, self._length(x.shape[ax]))


class Squeeze(Layer):
    """Drop the size-1 axes at ``dims`` (every size-1 non-batch axis when
    ``dims`` is None)."""

    def __init__(self, dims=None, **kwargs):
        super().__init__(**kwargs)
        if dims is None:
            self.dims = None
        else:
            if isinstance(dims, (int, np.integer)):
                dims = [dims]
            self.dims = tuple(int(d) for d in dims)

    def _axes(self, shape):
        if self.dims is None:
            return [i for i in range(1, len(shape)) if shape[i] == 1]
        return sorted(_axis(d, len(shape)) for d in self.dims)

    def compute_output_shape(self, input_shape):
        shape = list(input_shape)
        for ax in sorted(self._axes(shape), reverse=True):
            if shape[ax] != 1:
                raise ValueError(
                    f"cannot squeeze axis {ax} of size {shape[ax]}")
            del shape[ax]
        return tuple(shape)

    def call(self, params, x, training=False, rng=None):
        return x.squeeze(tuple(self._axes(tuple(x.shape))))


class ExpandDim(Layer):
    """Insert a size-1 axis at ``dim``."""

    def __init__(self, dim: int = 0, **kwargs):
        super().__init__(**kwargs)
        self.dim = int(dim)

    def compute_output_shape(self, input_shape):
        shape = list(input_shape)
        shape.insert(_axis(self.dim, len(shape) + 1), 1)
        return tuple(shape)

    def call(self, params, x, training=False, rng=None):
        return x.unsqueeze(_axis(self.dim, x.ndim + 1))


class Expand(Layer):
    """Broadcast size-1 axes to ``tgt_sizes`` (batch dim excluded; -1
    keeps a dim)."""

    def __init__(self, tgt_sizes: Sequence[int], **kwargs):
        super().__init__(**kwargs)
        self.tgt_sizes = tuple(int(s) for s in tgt_sizes)

    def _target(self, input_shape):
        shape = list(input_shape)
        if len(self.tgt_sizes) != len(shape) - 1:
            raise ValueError(
                f"tgt_sizes {self.tgt_sizes} must cover the "
                f"{len(shape) - 1} non-batch dims")
        for i, s in enumerate(self.tgt_sizes):
            if s != -1:
                shape[i + 1] = s
        return tuple(shape)

    def compute_output_shape(self, input_shape):
        return self._target(input_shape)

    def call(self, params, x, training=False, rng=None):
        return x.expand(self._target(tuple(x.shape)))


class SplitTensor(Layer):
    """Split into ``num`` equal chunks along ``dimension``: a list of
    ``num`` outputs."""

    def __init__(self, dimension: int, num: int, **kwargs):
        super().__init__(**kwargs)
        self.dimension = int(dimension)
        self.num = int(num)

    def compute_output_shape(self, input_shape):
        shape = list(input_shape)
        ax = _axis(self.dimension, len(shape))
        if shape[ax] is not None:
            if shape[ax] % self.num:
                raise ValueError(
                    f"axis size {shape[ax]} not divisible by {self.num}")
            shape[ax] = shape[ax] // self.num
        return [tuple(shape) for _ in range(self.num)]

    def call(self, params, x, training=False, rng=None):
        ax = _axis(self.dimension, x.ndim)
        if x.shape[ax] % self.num:
            raise ValueError(
                f"axis size {x.shape[ax]} not divisible by {self.num}")
        return list(torch.chunk(x, self.num, dim=ax))


class SelectTable(Layer):
    """Pick input ``index`` of a list input."""

    def __init__(self, index: int, **kwargs):
        super().__init__(**kwargs)
        self.index = int(index)

    def compute_output_shape(self, input_shape):
        return tuple(input_shape[self.index])

    def call(self, params, inputs, training=False, rng=None):
        return inputs[self.index]


class Max(Layer):
    """Max (or, with ``return_value=False``, the float32 argmax) along
    ``dim``, the reduced axis kept with size 1."""

    def __init__(self, dim: int, return_value: bool = True, **kwargs):
        super().__init__(**kwargs)
        self.dim = int(dim)
        self.return_value = bool(return_value)

    def compute_output_shape(self, input_shape):
        shape = list(input_shape)
        shape[_axis(self.dim, len(shape))] = 1
        return tuple(shape)

    def call(self, params, x, training=False, rng=None):
        ax = _axis(self.dim, x.ndim)
        if self.return_value:
            return x.amax(dim=ax, keepdim=True)
        return x.argmax(dim=ax, keepdim=True).to(torch.float32)


class GetShape(Layer):
    """The input's shape, batch dim included, as a 1-D int32 tensor (no
    batch axis on the output)."""

    def compute_output_shape(self, input_shape):
        return (len(input_shape),)

    def call(self, params, x, training=False, rng=None):
        return torch.tensor(tuple(x.shape), dtype=torch.int32,
                            device=x.device)
