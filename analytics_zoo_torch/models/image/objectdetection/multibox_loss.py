"""MultiBox loss with prior matching and hard negative mining (port of
``models/image/objectdetection/multibox_loss.py``).

Reference: objectdetection/common/loss/MultiBoxLoss.scala:622 — match
ground truths to priors by IoU (plus a forced best-prior-per-gt match),
smooth-L1 on encoded locations, cross-entropy on confidences with 3:1
hard-negative mining.

Fixed shapes, batched: ground truths are padded to ``max_gt`` with a
validity mask; negative mining ranks the negatives by loss through a
stable sort (ties by index, as the reference's ``argsort``) and keeps
rank < 3·num_pos.  The matching takes the reference's choices among
equal values: ``argmax`` the first maximum, and where two ground truths
claim one prior the later one writes last.  Gradients flow through
autograd.
"""

from __future__ import annotations

import torch

from analytics_zoo_torch.models.image.objectdetection.bbox import (
    encode_boxes, iou_rows,
)


def match_priors(gt_boxes, gt_labels, gt_mask, priors,
                 iou_threshold: float = 0.5):
    """gt (..., G, 4) / (..., G) / (..., G) padded; priors (P, 4).

    Returns (loc_targets (..., P, 4), cls_targets (..., P) int64 with 0 =
    background)."""
    g = gt_boxes.shape[-2]
    iou = iou_rows(gt_boxes, priors)                      # (..., G, P)
    iou = torch.where(gt_mask[..., None], iou,
                      torch.full((), -1.0, dtype=iou.dtype,
                                 device=iou.device))
    best_gt_per_prior = iou.argmax(dim=-2)               # first maximum
    best_iou_per_prior = iou.amax(dim=-2)
    best_prior_per_gt = iou.argmax(dim=-1)               # (..., G)
    # force-match: each gt claims its best prior, the reference's scatter
    # in gt order, so of the gts claiming one prior the last one writes
    gts = torch.arange(g, device=iou.device)
    claims = best_prior_per_gt[..., :, None] == torch.arange(
        priors.shape[0], device=iou.device)               # (..., G, P)
    last = (g - 1) - claims.flip(-2).int().argmax(dim=-2)  # (..., P)
    claimed = claims.any(dim=-2)
    forced = claimed & gt_mask.gather(-1, last)
    gt_of_forced = torch.where(claimed, gts[last], 0)

    assigned_gt = torch.where(forced, gt_of_forced, best_gt_per_prior)
    positive = forced | (best_iou_per_prior >= iou_threshold)

    matched_boxes = gt_boxes.gather(
        -2, assigned_gt[..., None].expand(*assigned_gt.shape, 4))
    matched_labels = gt_labels.gather(-1, assigned_gt).long()
    loc_targets = encode_boxes(matched_boxes, priors)
    cls_targets = torch.where(positive, matched_labels, 0)
    return loc_targets, cls_targets


def smooth_l1(x):
    ax = x.abs()
    return torch.where(ax < 1.0, 0.5 * x * x, ax - 0.5)


class MultiBoxLoss:
    """loss((gt_boxes, gt_labels, gt_mask), (loc_pred, conf_pred))."""

    def __init__(self, priors, neg_pos_ratio: float = 3.0,
                 iou_threshold: float = 0.5):
        self.priors = torch.as_tensor(priors)
        self.neg_pos_ratio = float(neg_pos_ratio)
        self.iou_threshold = float(iou_threshold)
        self.name = "multibox_loss"

    def __call__(self, y_true, y_pred):
        gt_boxes, gt_labels, gt_mask = y_true
        loc_pred, conf_pred = y_pred        # (B,P,4), (B,P,C)
        if self.priors.device != loc_pred.device:
            # placed once, by the eager warm-up before a step is captured
            # (a host copy cannot be recorded into a CUDA graph)
            self.priors = self.priors.to(loc_pred.device)
        priors = self.priors

        with torch.no_grad():
            loc_t, cls_t = match_priors(gt_boxes, gt_labels,
                                        gt_mask.bool(), priors,
                                        self.iou_threshold)

        positive = cls_t > 0                               # (B,P)
        num_pos = positive.sum(dim=1)                      # (B,)

        # localisation: smooth-L1 on positives
        loc_loss = smooth_l1(loc_pred - loc_t).sum(dim=-1)
        loc_loss = (loc_loss * positive).sum(dim=1)

        # confidence: CE everywhere, then hard-negative mining
        logp = torch.log_softmax(conf_pred, dim=-1)
        ce = -logp.gather(-1, cls_t[..., None])[..., 0]    # (B,P)
        with torch.no_grad():
            neg_ce = torch.where(positive, float("-inf"), ce)
            # rank of each negative by descending loss, ties by index
            order = torch.argsort(-neg_ce, dim=1, stable=True)
            rank = torch.empty_like(order).scatter_(
                1, order, torch.arange(order.shape[1], device=order.device
                                       ).expand_as(order))
            max_neg = torch.minimum(self.neg_pos_ratio * num_pos,
                                    positive.shape[1] - num_pos)
            negative = (rank < max_neg[:, None]) & ~positive & \
                torch.isfinite(neg_ce)
        conf_loss = (ce * (positive | negative)).sum(dim=1)

        denom = num_pos.float().clamp(min=1.0)
        return ((loc_loss + conf_loss) / denom).mean()
