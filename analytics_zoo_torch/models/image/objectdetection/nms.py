"""Non-maximum suppression on the device with static shapes (port of
``models/image/objectdetection/nms.py``; ref: the Nms class in
objectdetection/common — scalar loops there; here a fixed-iteration
select-and-suppress loop with a static output size).

The loop runs ``max_output`` iterations with no host read and no host
branch, batched over any leading axes, so ``engine_jit`` captures a
whole ``detect`` into one CUDA graph.  Each iteration computes only the
IoU row of the box it picked (``bbox.iou_rows``: the same elementwise
formula as the reference's (N, N) matrix, so the same values) instead of
the matrix, which at SSD-300 and batch 32 would take 32 × 8732² floats.
Ties break as the reference's: ``argmax`` takes the first maximum, and
``top_k`` is a stable descending sort (the lower index first among
equal values).
"""

from __future__ import annotations

import torch

from analytics_zoo_torch.models.image.objectdetection.bbox import iou_rows


def top_k(x, k: int):
    """``jax.lax.top_k`` on the last axis: the ``k`` largest values in
    descending order, the lower index first among equal ones."""
    values, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


def _rows(x, idx):
    """``x[..., idx, :]`` per batch: x (..., N, D), idx (..., K)."""
    return x.gather(-2, idx[..., None].expand(*idx.shape, x.shape[-1]))


def nms(boxes, scores, iou_threshold: float = 0.45,
        max_output: int = 100, score_threshold: float = 0.0):
    """boxes (..., N, 4), scores (..., N) -> (idx (..., max_output) int64,
    valid mask).

    Greedy NMS: each of ``max_output`` steps picks the best remaining
    score and suppresses the boxes overlapping it.  Padded slots return
    index -1."""
    n = scores.shape[-1]
    alive = scores > score_threshold
    neg_inf = torch.full((), float("-inf"), dtype=scores.dtype,
                         device=scores.device)
    positions = torch.arange(n, device=scores.device)
    out_idx, out_valid = [], []
    for _ in range(max_output):
        masked = torch.where(alive, scores, neg_inf)
        best = masked.argmax(dim=-1, keepdim=True)             # (..., 1)
        ok = masked.gather(-1, best) > neg_inf
        out_idx.append(torch.where(ok, best, -1))
        out_valid.append(ok)
        suppress = iou_rows(_rows(boxes, best), boxes)[..., 0, :] \
            >= iou_threshold
        alive = alive & ~suppress & (positions != best) & ok
    return torch.cat(out_idx, dim=-1), torch.cat(out_valid, dim=-1)


def multiclass_nms(boxes, probs, iou_threshold: float = 0.45,
                   score_threshold: float = 0.01,
                   topk_per_class: int = 400,
                   max_detections: int = 200):
    """Per-class NMS with cross-class results (torchvision's SSD
    postprocess: a location can be detected as SEVERAL classes).

    ``boxes`` (..., P, 4), ``probs`` (..., P, C) with class 0 =
    background.  Per non-background class: the top ``topk_per_class``
    candidates by score, greedy NMS, then the global top
    ``max_detections`` across classes by score.

    Returns (boxes (..., D, 4), scores (..., D), labels (..., D) int32,
    valid (..., D)) with D = ``max_detections``; invalid slots carry
    label 0."""
    p, c = probs.shape[-2:]
    k = min(topk_per_class, p)
    m = min(max_detections, k)
    lead = probs.shape[:-2]
    # every non-background class as its own row: (..., C-1, P)
    scores_c = probs[..., 1:].transpose(-1, -2)
    top_scores, top_idx = top_k(scores_c, k)                # (..., C-1, k)
    cand = _rows(boxes[..., None, :, :].expand(*lead, c - 1, p, 4), top_idx)
    idx, valid = nms(cand, top_scores, iou_threshold, m, score_threshold)
    safe = idx.clamp(min=0)
    sel = top_idx.gather(-1, safe)                          # (..., C-1, m)
    sc = torch.where(valid, top_scores.gather(-1, safe),
                     torch.full((), float("-inf"), dtype=probs.dtype,
                                device=probs.device))
    labels = torch.arange(1, c, dtype=torch.int32, device=probs.device
                          )[:, None].expand(c - 1, m)

    flat_scores = sc.reshape(*lead, -1)
    # the candidate pool can be SMALLER than max_detections: take what
    # exists and pad the outputs up to D
    d = min(max_detections, flat_scores.shape[-1])
    best_scores, order = top_k(flat_scores, d)
    out_valid = best_scores > float("-inf")
    safe = order.clamp(min=0)
    out_boxes = _rows(boxes, sel.reshape(*lead, -1).gather(-1, safe))
    out_labels = torch.where(
        out_valid, labels.reshape(-1)[safe], torch.zeros_like(safe)
    ).to(torch.int32)
    out_scores = torch.where(out_valid, best_scores,
                             torch.zeros_like(best_scores))
    pad = max_detections - d
    if pad:
        out_boxes = torch.cat([out_boxes, out_boxes.new_zeros(
            (*lead, pad, 4))], dim=-2)
        out_scores = torch.cat([out_scores, out_scores.new_zeros(
            (*lead, pad))], dim=-1)
        out_labels = torch.cat([out_labels, out_labels.new_zeros(
            (*lead, pad))], dim=-1)
        out_valid = torch.cat([out_valid, out_valid.new_zeros(
            (*lead, pad))], dim=-1)
    return out_boxes, out_scores, out_labels, out_valid
