"""Detection data pipeline: Pascal-VOC reader + box-aware transforms
(port of ``feature/image_detection.py``).

Reference: objectdetection/common/dataset/roiimage/ (RoiImageSeqGenerator,
VOC parsing), feature/image transforms ImageExpand.scala /
ImageRandomCrop / ImageColorJitter — the OpenCV executor-side pipeline
that feeds SSD training with (image, RoiLabel) pairs.

Samples are plain dicts {image HWC, boxes (N,4) ABSOLUTE x1y1x2y2
pixels, labels (N,), difficult (N,)} flowing through chained host-side
numpy transforms; each random stage draws from its own seeded
``np.random.default_rng``, so both packages draw the same crops, flips
and expansions.  ``to_feature_set`` pads boxes to a fixed ``max_boxes``
and normalizes them to [0,1], so every batch has static shapes for the
MultiBox loss (multibox_loss.py matches on (gt_boxes, gt_labels,
gt_mask)).
"""

from __future__ import annotations

import glob
import os
import xml.etree.ElementTree as ET
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from analytics_zoo_torch.feature.common import Preprocessing
from analytics_zoo_torch.feature.feature_set import FeatureSet
from analytics_zoo_torch.feature.image import read_image

VOC_CLASSES = (
    "aeroplane", "bicycle", "bird", "boat", "bottle", "bus", "car",
    "cat", "chair", "cow", "diningtable", "dog", "horse", "motorbike",
    "person", "pottedplant", "sheep", "sofa", "train", "tvmonitor",
)


def parse_voc_xml(xml_path: str, class_to_idx: Dict[str, int]
                  ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """One VOC annotation file → (boxes (N,4) absolute x1y1x2y2,
    labels (N,) int32 1-based, difficult (N,) bool).  Unknown class
    names are skipped (matches the reference's configurable class
    list)."""
    root = ET.parse(xml_path).getroot()
    boxes, labels, difficult = [], [], []
    for obj in root.findall("object"):
        name = obj.findtext("name", "").strip()
        if name not in class_to_idx:
            continue
        bb = obj.find("bndbox")
        # VOC pixel coordinates are 1-based inclusive
        x1 = float(bb.findtext("xmin")) - 1.0
        y1 = float(bb.findtext("ymin")) - 1.0
        x2 = float(bb.findtext("xmax")) - 1.0
        y2 = float(bb.findtext("ymax")) - 1.0
        boxes.append([x1, y1, x2, y2])
        labels.append(class_to_idx[name])
        difficult.append(obj.findtext("difficult", "0").strip() == "1")
    return (np.asarray(boxes, np.float32).reshape(-1, 4),
            np.asarray(labels, np.int32),
            np.asarray(difficult, bool))


class DetectionSet:
    """Container of detection samples with chained transforms (the
    roiimage ImageSet analogue).

    Transforms are LAZY: ``transform``/``>>`` records the stage and
    ``materialize(epoch)`` (called by ``to_feature_set``) applies the
    chain with per-epoch reseeding of random stages — so each epoch
    sees FRESH augmentation draws, like the reference's executor-side
    per-iteration transforms, not one frozen draw."""

    def __init__(self, samples: List[dict],
                 classes: Sequence[str] = VOC_CLASSES,
                 stages: Optional[List[Preprocessing]] = None):
        self.samples = samples
        self.classes = tuple(classes)
        self.stages: List[Preprocessing] = list(stages or [])

    @classmethod
    def read_voc(cls, root: str, split: Optional[str] = None,
                 classes: Sequence[str] = VOC_CLASSES) -> "DetectionSet":
        """Read a VOCdevkit-layout dataset: ``JPEGImages/``,
        ``Annotations/``, optional ``ImageSets/Main/<split>.txt``.
        Class indices are 1-based (0 = background)."""
        class_to_idx = {c: i + 1 for i, c in enumerate(classes)}
        if split is not None:
            ids = [ln.strip().split()[0] for ln in
                   open(os.path.join(root, "ImageSets", "Main",
                                     split + ".txt"))
                   if ln.strip()]
        else:
            ids = sorted(
                os.path.splitext(os.path.basename(p))[0]
                for p in glob.glob(os.path.join(root, "Annotations",
                                                "*.xml")))
        samples = []
        for img_id in ids:
            xml = os.path.join(root, "Annotations", img_id + ".xml")
            boxes, labels, difficult = parse_voc_xml(xml, class_to_idx)
            img_path = None
            for ext in (".jpg", ".jpeg", ".png"):
                p = os.path.join(root, "JPEGImages", img_id + ext)
                if os.path.exists(p):
                    img_path = p
                    break
            if img_path is None:
                raise FileNotFoundError(
                    f"no image for annotation {img_id} under "
                    f"{os.path.join(root, 'JPEGImages')}")
            samples.append({"image": read_image(img_path), "boxes": boxes,
                            "labels": labels, "difficult": difficult,
                            "id": img_id})
        return cls(samples, classes)

    @classmethod
    def from_samples(cls, samples: List[dict],
                     classes: Sequence[str] = VOC_CLASSES
                     ) -> "DetectionSet":
        return cls(list(samples), classes)

    def transform(self, stage: Preprocessing) -> "DetectionSet":
        return DetectionSet(self.samples, self.classes,
                            self.stages + [stage])

    __rshift__ = transform

    def __len__(self):
        return len(self.samples)

    def materialize(self, epoch: int = 0) -> "DetectionSet":
        """Run the recorded transform chain; random stages are reseeded
        per (epoch, stage index) so every epoch draws fresh
        augmentations."""
        samples = self.samples
        for i, st in enumerate(self.stages):
            if hasattr(st, "reseed"):
                st.reseed(epoch * 1000 + i)
            samples = [st.apply(dict(s)) for s in samples]
        return DetectionSet(samples, self.classes)

    def to_feature_set(self, max_boxes: int = 16, shuffle: bool = True,
                       include_difficult: bool = True,
                       epoch: int = 0) -> FeatureSet:
        """Pad/normalize into the MultiBoxLoss target layout:
        x = images (B,H,W,C) f32; y = (boxes (B,G,4) in [0,1],
        labels (B,G) int32, mask (B,G) f32).

        Ground truths beyond ``max_boxes`` are DROPPED (logged once) —
        raise ``max_boxes`` for crowd-heavy datasets."""
        import logging
        imgs, bxs, lbs, msks = [], [], [], []
        dropped = 0
        for s in self.materialize(epoch).samples:
            img = np.asarray(s["image"], np.float32)
            h, w = img.shape[:2]
            boxes = np.asarray(s["boxes"], np.float32).reshape(-1, 4)
            labels = np.asarray(s["labels"], np.int32)
            if not include_difficult and len(labels):
                keep = ~np.asarray(s["difficult"], bool)
                boxes, labels = boxes[keep], labels[keep]
            n = min(len(labels), max_boxes)
            dropped += len(labels) - n
            b = np.zeros((max_boxes, 4), np.float32)
            l = np.zeros((max_boxes,), np.int32)
            m = np.zeros((max_boxes,), np.float32)
            if n:
                b[:n] = boxes[:n] / np.array([w, h, w, h], np.float32)
                l[:n] = labels[:n]
                m[:n] = 1.0
            imgs.append(img)
            bxs.append(b)
            lbs.append(l)
            msks.append(m)
        if dropped:
            logging.getLogger("analytics_zoo_torch").warning(
                "to_feature_set: dropped %d ground-truth boxes beyond "
                "max_boxes=%d — raise max_boxes to keep them", dropped,
                max_boxes)
        shapes = {im.shape for im in imgs}
        if len(shapes) > 1:
            raise ValueError(
                f"images must share one shape for batching, got {shapes};"
                " add DetResize to the transform chain")
        return FeatureSet.from_ndarrays(
            np.stack(imgs),
            (np.stack(bxs), np.stack(lbs), np.stack(msks)),
            shuffle=shuffle)


# --------------------------------------------------------- box transforms
class DetResize(Preprocessing):
    """Resize image and scale boxes (ref ImageResize + RoiResize)."""

    def __init__(self, resize_h: int, resize_w: int):
        self.h, self.w = int(resize_h), int(resize_w)

    def apply(self, s: dict) -> dict:
        from analytics_zoo_torch.feature.image import ImageResize
        h, w = s["image"].shape[:2]
        s["image"] = ImageResize(self.h, self.w).apply(s["image"])
        if len(s["boxes"]):
            scale = np.array([self.w / w, self.h / h] * 2, np.float32)
            s["boxes"] = s["boxes"] * scale
        return s


class DetHFlip(Preprocessing):
    """Horizontal flip of image AND boxes (ref RoiHFlip)."""

    def __init__(self, prob: float = 0.5, seed: int = 0):
        self.prob = prob
        self.rng = np.random.default_rng(seed)

    def reseed(self, seed: int) -> None:
        self.rng = np.random.default_rng(seed)

    def apply(self, s: dict) -> dict:
        if self.rng.random() >= self.prob:
            return s
        w = s["image"].shape[1]
        s["image"] = np.ascontiguousarray(s["image"][:, ::-1])
        if len(s["boxes"]):
            b = s["boxes"].copy()
            b[:, [0, 2]] = w - s["boxes"][:, [2, 0]]
            s["boxes"] = b
        return s


class DetExpand(Preprocessing):
    """Zoom-out: paste the image at a random offset on a mean-filled
    canvas up to ``max_ratio`` larger; boxes shift (ref
    ImageExpand.scala — the SSD small-object augmentation)."""

    def __init__(self, max_ratio: float = 4.0, mean=(123, 117, 104),
                 prob: float = 0.5, seed: int = 0):
        self.max_ratio = float(max_ratio)
        self.mean = np.asarray(mean, np.float32)
        self.prob = prob
        self.rng = np.random.default_rng(seed)

    def reseed(self, seed: int) -> None:
        self.rng = np.random.default_rng(seed)

    def apply(self, s: dict) -> dict:
        if self.rng.random() >= self.prob:
            return s
        from analytics_zoo_torch.feature.image import expand_canvas
        canvas, top, left = expand_canvas(s["image"], self.rng,
                                          self.max_ratio, self.mean)
        s["image"] = canvas
        if len(s["boxes"]):
            s["boxes"] = s["boxes"] + np.array(
                [left, top, left, top], np.float32)
        return s


class DetRandomCrop(Preprocessing):
    """SSD batch-sampler crop: repeatedly sample a patch whose min-IoU
    with some ground truth meets a randomly chosen constraint; keep
    boxes whose CENTERS fall inside, clip them to the patch (ref
    ImageRandomCrop + the SSD sampler in roiimage)."""

    def __init__(self, min_ious=(None, 0.1, 0.3, 0.5, 0.7, 0.9),
                 min_scale: float = 0.3, max_trials: int = 50,
                 prob: float = 0.5, seed: int = 0):
        self.min_ious = tuple(min_ious)
        self.min_scale = float(min_scale)
        self.max_trials = int(max_trials)
        self.prob = prob
        self.rng = np.random.default_rng(seed)

    def reseed(self, seed: int) -> None:
        self.rng = np.random.default_rng(seed)

    @staticmethod
    def _iou(boxes, patch):
        lt = np.maximum(boxes[:, :2], patch[:2])
        rb = np.minimum(boxes[:, 2:], patch[2:])
        wh = np.clip(rb - lt, 0, None)
        inter = wh[:, 0] * wh[:, 1]
        area_b = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
        area_p = (patch[2] - patch[0]) * (patch[3] - patch[1])
        return inter / np.maximum(area_b + area_p - inter, 1e-10)

    def apply(self, s: dict) -> dict:
        if self.rng.random() >= self.prob or not len(s["boxes"]):
            return s
        img, boxes = s["image"], s["boxes"]
        h, w = img.shape[:2]
        min_iou = self.min_ious[
            int(self.rng.integers(0, len(self.min_ious)))]
        if min_iou is None:
            return s
        for _ in range(self.max_trials):
            cw = float(self.rng.uniform(self.min_scale, 1.0)) * w
            ch = float(self.rng.uniform(self.min_scale, 1.0)) * h
            if not 0.5 <= cw / ch <= 2.0:     # aspect constraint
                continue
            left = float(self.rng.uniform(0, w - cw))
            top = float(self.rng.uniform(0, h - ch))
            patch = np.array([left, top, left + cw, top + ch],
                             np.float32)
            if self._iou(boxes, patch).max() < min_iou:
                continue
            centers = (boxes[:, :2] + boxes[:, 2:]) / 2
            keep = ((centers[:, 0] >= patch[0])
                    & (centers[:, 0] <= patch[2])
                    & (centers[:, 1] >= patch[1])
                    & (centers[:, 1] <= patch[3]))
            if not keep.any():
                continue
            x1, y1, x2, y2 = (int(patch[0]), int(patch[1]),
                              int(patch[2]), int(patch[3]))
            s["image"] = np.ascontiguousarray(img[y1:y2, x1:x2])
            b = boxes[keep].copy()
            b[:, [0, 2]] = np.clip(b[:, [0, 2]] - x1, 0, x2 - x1)
            b[:, [1, 3]] = np.clip(b[:, [1, 3]] - y1, 0, y2 - y1)
            s["boxes"] = b
            s["labels"] = np.asarray(s["labels"])[keep]
            s["difficult"] = np.asarray(s["difficult"])[keep]
            return s
        return s


class DetColorJitter(Preprocessing):
    """Photometric jitter on the image only — boxes untouched."""

    def __init__(self, **kwargs):
        from analytics_zoo_torch.feature.image import ImageColorJitter
        self.jitter = ImageColorJitter(**kwargs)

    def reseed(self, seed: int) -> None:
        self.jitter.reseed(seed)

    def apply(self, s: dict) -> dict:
        s["image"] = self.jitter.apply(s["image"])
        return s


class DetNormalize(Preprocessing):
    """Per-channel mean/std on the image only."""

    def __init__(self, mean, std=(1.0, 1.0, 1.0)):
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)

    def apply(self, s: dict) -> dict:
        s["image"] = (np.asarray(s["image"], np.float32) - self.mean) \
            / self.std
        return s
