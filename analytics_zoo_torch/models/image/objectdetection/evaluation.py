"""Detection evaluation: PascalVOC-style mean average precision on the
host in numpy (port of ``models/image/objectdetection/evaluation.py``;
ref: objectdetection/evaluation/ PascalVocEvaluator /
MeanAveragePrecision)."""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np


def _voc_ap(recall, precision, use_07_metric: bool = False) -> float:
    if use_07_metric:
        ap = 0.0
        for t in np.arange(0.0, 1.1, 0.1):
            p = np.max(precision[recall >= t]) if np.any(recall >= t) \
                else 0.0
            ap += p / 11.0
        return float(ap)
    mrec = np.concatenate([[0.0], recall, [1.0]])
    mpre = np.concatenate([[0.0], precision, [0.0]])
    for i in range(len(mpre) - 1, 0, -1):
        mpre[i - 1] = max(mpre[i - 1], mpre[i])
    idx = np.where(mrec[1:] != mrec[:-1])[0]
    return float(np.sum((mrec[idx + 1] - mrec[idx]) * mpre[idx + 1]))


class MeanAveragePrecision:
    """Accumulate per-image detections + ground truths, compute mAP."""

    def __init__(self, num_classes: int, iou_threshold: float = 0.5,
                 use_07_metric: bool = False):
        self.num_classes = num_classes
        self.iou_threshold = iou_threshold
        self.use_07 = use_07_metric
        self._dets: List[Tuple] = []    # (img, box, score, label)
        self._gts: List[Tuple] = []     # (img, box, label, difficult)
        self._img = 0

    def add(self, det_boxes, det_scores, det_labels,
            gt_boxes, gt_labels, gt_difficult=None) -> None:
        """``gt_difficult`` follows PascalVOC semantics: difficult
        ground truths are excluded from the positive count and a
        detection matching one is IGNORED (neither TP nor FP) —
        ref PascalVocEvaluator.scala's difficult handling."""
        i = self._img
        self._img += 1
        if gt_difficult is None:
            gt_difficult = [False] * len(gt_labels)
        if len(gt_difficult) != len(gt_labels):
            raise ValueError(
                f"gt_difficult length {len(gt_difficult)} != "
                f"gt_labels length {len(gt_labels)}")
        for b, s, l in zip(det_boxes, det_scores, det_labels):
            self._dets.append((i, np.asarray(b), float(s), int(l)))
        for b, l, d in zip(gt_boxes, gt_labels, gt_difficult):
            self._gts.append((i, np.asarray(b), int(l), bool(d)))

    @staticmethod
    def _iou(a, b):
        lt = np.maximum(a[:2], b[:2])
        rb = np.minimum(a[2:], b[2:])
        wh = np.clip(rb - lt, 0, None)
        inter = wh[0] * wh[1]
        ua = (a[2] - a[0]) * (a[3] - a[1]) + \
            (b[2] - b[0]) * (b[3] - b[1]) - inter
        return inter / max(ua, 1e-10)

    def result(self) -> Dict[str, float]:
        aps = {}
        for c in range(1, self.num_classes):
            gts = [(i, b, d) for i, b, l, d in self._gts if l == c]
            dets = sorted([(i, b, s) for i, b, s, l in self._dets
                           if l == c], key=lambda t: -t[2])
            npos = sum(1 for _i, _b, d in gts if not d)
            if npos == 0:
                continue
            matched = set()
            tp = np.zeros(len(dets))
            fp = np.zeros(len(dets))
            for d, (img, box, _s) in enumerate(dets):
                best, best_iou = None, self.iou_threshold
                for g, (gimg, gbox, _gd) in enumerate(gts):
                    if gimg != img or g in matched:
                        continue
                    iou = self._iou(box, gbox)
                    if iou >= best_iou:
                        best, best_iou = g, iou
                if best is not None:
                    if gts[best][2]:
                        # difficult match: ignore the detection entirely
                        continue
                    matched.add(best)
                    tp[d] = 1
                else:
                    fp[d] = 1
            ctp = np.cumsum(tp)
            cfp = np.cumsum(fp)
            recall = ctp / npos
            precision = ctp / np.maximum(ctp + cfp, 1e-10)
            aps[f"class_{c}"] = _voc_ap(recall, precision, self.use_07)
        mean = float(np.mean(list(aps.values()))) if aps else 0.0
        return {"mAP": mean, **aps}
