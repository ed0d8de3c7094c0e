"""Box utilities (port of ``models/image/objectdetection/bbox.py``; ref:
objectdetection/common/BboxUtil.scala), vectorized over fixed shapes.

Boxes are (x1, y1, x2, y2) in [0, 1]; priors are center-form encoded
with SSD variances.  Each function is the reference's elementwise
formula in the same order, so float32 inputs give the same results.
"""

from __future__ import annotations

import torch

VARIANCES = (0.1, 0.1, 0.2, 0.2)


def corner_to_center(boxes):
    wh = boxes[..., 2:] - boxes[..., :2]
    c = boxes[..., :2] + wh / 2
    return torch.cat([c, wh], dim=-1)


def center_to_corner(boxes):
    c, wh = boxes[..., :2], boxes[..., 2:]
    return torch.cat([c - wh / 2, c + wh / 2], dim=-1)


def _area(b):
    return (b[..., 2] - b[..., 0]).clamp(min=0) * \
        (b[..., 3] - b[..., 1]).clamp(min=0)


def iou_rows(a, b):
    """a: (..., N, 4), b: (..., M, 4) corner boxes -> (..., N, M) IoU;
    ``a`` may be a single row of each batch (N = 1), which gives the same
    values as that row of the full matrix."""
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = (rb - lt).clamp(min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = _area(a)[..., :, None] + _area(b)[..., None, :] - inter
    return inter / union.clamp(min=1e-10)


def iou_matrix(a, b):
    """a: (N,4), b: (M,4) corner boxes -> (N,M) IoU."""
    return iou_rows(a, b)


def encode_boxes(matched, priors, variances=VARIANCES):
    """Encode matched gt corner boxes against center-form priors
    (BboxUtil.encodeBoxes)."""
    m = corner_to_center(matched)
    p = corner_to_center(priors)
    g_c = (m[..., :2] - p[..., :2]) / (p[..., 2:] * variances[0])
    g_wh = torch.log((m[..., 2:] / p[..., 2:].clamp(min=1e-10))
                     .clamp(min=1e-10)) / variances[2]
    return torch.cat([g_c, g_wh], dim=-1)


def decode_boxes(loc, priors, variances=VARIANCES):
    """Inverse of encode (BboxUtil.decodeBoxes)."""
    p = corner_to_center(priors)
    c = p[..., :2] + loc[..., :2] * variances[0] * p[..., 2:]
    wh = p[..., 2:] * torch.exp(loc[..., 2:] * variances[2])
    return center_to_corner(torch.cat([c, wh], dim=-1)).clamp(0.0, 1.0)
