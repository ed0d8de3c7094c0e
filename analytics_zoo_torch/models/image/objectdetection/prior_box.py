"""SSD prior (anchor) box generation, host-side and static (port of
``models/image/objectdetection/prior_box.py``, numpy in both packages;
ref: the PriorBox layer wiring in ssd/SSDGraph.scala)."""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np


def priors_for_layer(fmap_size: int, image_size: int, min_size: float,
                     max_size: Optional[float],
                     aspect_ratios: Sequence[float]) -> np.ndarray:
    """Corner-form priors (fmap*fmap*k, 4) for one feature map."""
    boxes = []
    step = image_size / fmap_size
    for i in range(fmap_size):
        for j in range(fmap_size):
            cx = (j + 0.5) * step / image_size
            cy = (i + 0.5) * step / image_size
            s = min_size / image_size
            boxes.append([cx, cy, s, s])
            if max_size is not None:
                sp = math.sqrt(min_size * max_size) / image_size
                boxes.append([cx, cy, sp, sp])
            for ar in aspect_ratios:
                if ar == 1.0:
                    continue
                r = math.sqrt(ar)
                boxes.append([cx, cy, s * r, s / r])
                boxes.append([cx, cy, s / r, s * r])
    arr = np.asarray(boxes, np.float32)
    corner = np.concatenate(
        [arr[:, :2] - arr[:, 2:] / 2, arr[:, :2] + arr[:, 2:] / 2], axis=1)
    return np.clip(corner, 0.0, 1.0)


def num_priors_per_cell(max_size: Optional[float],
                        aspect_ratios: Sequence[float]) -> int:
    k = 1 + (1 if max_size is not None else 0)
    k += 2 * sum(1 for ar in aspect_ratios if ar != 1.0)
    return k


def ssd_priors(image_size: int, fmap_sizes: Sequence[int],
               min_sizes: Sequence[float],
               max_sizes: Sequence[Optional[float]],
               aspect_ratios: Sequence[Sequence[float]]) -> np.ndarray:
    """Stack priors over all feature maps -> (P, 4)."""
    parts = [priors_for_layer(f, image_size, mn, mx, ars)
             for f, mn, mx, ars in zip(fmap_sizes, min_sizes, max_sizes,
                                       aspect_ratios)]
    return np.concatenate(parts, axis=0)
