"""Merge layer — combine multiple branches (port of
``pipeline/api/keras/layers/merge.py``)."""

from __future__ import annotations

from typing import List

import torch

from analytics_zoo_torch.pipeline.api.keras.engine import Layer


class Merge(Layer):
    def __init__(self, mode: str = "sum", concat_axis: int = -1, **kwargs):
        super().__init__(**kwargs)
        self.mode = mode
        self.concat_axis = concat_axis

    def call(self, params, inputs: List, training=False, rng=None):
        mode = self.mode
        if mode == "concat":
            return torch.cat(list(inputs), dim=self.concat_axis)
        if mode == "sum":
            out = inputs[0]
            for x in inputs[1:]:
                out = out + x
            return out
        if mode == "mul":
            out = inputs[0]
            for x in inputs[1:]:
                out = out * x
            return out
        if mode == "max":
            out = inputs[0]
            for x in inputs[1:]:
                out = torch.maximum(out, x)
            return out
        if mode == "min":
            out = inputs[0]
            for x in inputs[1:]:
                out = torch.minimum(out, x)
            return out
        if mode == "sub":
            a, b = inputs
            return a - b
        if mode == "ave":
            out = inputs[0]
            for x in inputs[1:]:
                out = out + x
            return out / len(inputs)
        if mode == "dot":
            a, b = inputs
            return torch.sum(a * b, dim=-1, keepdim=True)
        if mode == "cosine":
            a, b = inputs
            na = torch.linalg.norm(a, dim=-1, keepdim=True)
            nb = torch.linalg.norm(b, dim=-1, keepdim=True)
            return torch.sum(a * b, dim=-1, keepdim=True) / (na * nb + 1e-8)
        raise ValueError(f"unknown merge mode {mode}")

    def compute_output_shape(self, input_shape):
        shapes = input_shape
        if self.mode == "concat":
            ax = self.concat_axis
            base = list(shapes[0])
            ax = ax % len(base)
            total = 0
            for s in shapes:
                if s[ax] is None:
                    total = None
                    break
                total += s[ax]
            base[ax] = total
            return tuple(base)
        if self.mode in ("dot", "cosine"):
            return (shapes[0][0], 1)
        return tuple(shapes[0])


def merge(inputs, mode="sum", concat_axis=-1, name=None):
    """Functional helper mirroring zoo's ``merge``."""
    return Merge(mode=mode, concat_axis=concat_axis, name=name)(inputs)
