"""SSD detection graphs and the detector wrapper (port of
``models/image/objectdetection/ssd.py``).

Reference: objectdetection/ssd/SSDGraph.scala:220 + SSD.scala:214 — VGG
backbone with extra feature layers and per-scale loc/conf heads; SSDVGG
300 config.  Heads emit (B, P, 4) locations and (B, P, C) class scores
over the stacked prior set; decode + NMS produce final detections.

``SSDDetector.detect`` runs the forward, the box decode, the softmax and
the NMS loop as one program through ``engine_jit`` (one CUDA graph a
batch shape on the card; eager on the CPU), the weights and the priors
read in place.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from analytics_zoo_torch.models.image.objectdetection.bbox import (
    decode_boxes,
)
from analytics_zoo_torch.models.image.objectdetection.nms import (
    _rows, multiclass_nms, nms,
)
from analytics_zoo_torch.models.image.objectdetection.prior_box import (
    num_priors_per_cell, ssd_priors,
)
from analytics_zoo_torch.pipeline.api.keras import Input, Model
from analytics_zoo_torch.pipeline.api.keras.topology import tree_leaves
from analytics_zoo_torch.pipeline.api.keras.layers import (
    Activation, BatchNormalization, Convolution2D, Cropping2D, Lambda,
    MaxPooling2D, Merge,
)


def _conv_bn(x, f, k, stride=1, border="same"):
    x = Convolution2D(f, k, k, subsample=(stride, stride),
                      border_mode=border, bias=False)(x)
    x = BatchNormalization()(x)
    return Activation("relu")(x)


def _head(feats, n_priors_cell: Sequence[int], num_classes: int):
    """Per-scale loc/conf conv heads, flattened and concatenated."""
    locs, confs = [], []
    for x, k in zip(feats, n_priors_cell):
        loc = Convolution2D(k * 4, 3, 3, border_mode="same")(x)
        conf = Convolution2D(k * num_classes, 3, 3, border_mode="same")(x)
        # reshape is by logical (B, H, W, k*c) order, whatever the
        # conv output's storage layout: rows cell by cell, k priors a
        # cell, as ssd_priors stacks them
        locs.append(Lambda(
            lambda t: t.reshape(t.shape[0], -1, 4))(loc))
        confs.append(Lambda(
            lambda t, c=num_classes: t.reshape(t.shape[0], -1, c))(conf))
    loc = locs[0] if len(locs) == 1 else Merge(mode="concat",
                                              concat_axis=1)(locs)
    conf = confs[0] if len(confs) == 1 else Merge(mode="concat",
                                                  concat_axis=1)(confs)
    return loc, conf


_SSD300_SPECS = dict(
    fmap_sizes=(38, 19, 10, 5, 3, 1),
    min_sizes=(30, 60, 111, 162, 213, 264),
    max_sizes=(60, 111, 162, 213, 264, 315),
    aspect_ratios=((2.0,), (2.0, 3.0), (2.0, 3.0), (2.0, 3.0),
                   (2.0,), (2.0,)),
)


def ssd_vgg300(num_classes: int = 21) -> Tuple[Model, np.ndarray]:
    """SSD300 with a VGG16-style backbone (SSDVGG default config)."""
    inp = Input(shape=(300, 300, 3))
    x = _conv_bn(inp, 64, 3)
    x = _conv_bn(x, 64, 3)
    x = MaxPooling2D(border_mode="same")(x)          # 150
    x = _conv_bn(x, 128, 3)
    x = _conv_bn(x, 128, 3)
    x = MaxPooling2D(border_mode="same")(x)          # 75
    x = _conv_bn(x, 256, 3)
    x = _conv_bn(x, 256, 3)
    x = _conv_bn(x, 256, 3)
    x = MaxPooling2D(pool_size=(2, 2), strides=(2, 2),
                     border_mode="same")(x)          # 38
    x = _conv_bn(x, 512, 3)
    x = _conv_bn(x, 512, 3)
    f38 = _conv_bn(x, 512, 3)                        # conv4_3: 38x38
    x = MaxPooling2D(border_mode="same")(f38)        # 19
    x = _conv_bn(x, 512, 3)
    x = _conv_bn(x, 512, 3)
    x = _conv_bn(x, 512, 3)
    x = _conv_bn(x, 1024, 3)
    f19 = _conv_bn(x, 1024, 1)                       # fc7: 19x19
    x = _conv_bn(f19, 256, 1)
    f10 = _conv_bn(x, 512, 3, stride=2)              # 10x10
    x = _conv_bn(f10, 128, 1)
    f5 = _conv_bn(x, 256, 3, stride=2)               # 5x5
    x = _conv_bn(f5, 128, 1)
    f3 = _conv_bn(x, 256, 3, stride=2)               # 3x3
    x = _conv_bn(f3, 128, 1)
    f1 = _conv_bn(x, 256, 3, stride=2, border="same")  # 2x2 -> crop
    f1 = Cropping2D(((0, 1), (0, 1)))(f1)            # 1x1

    s = _SSD300_SPECS
    k_cells = [num_priors_per_cell(mx, ars)
               for mx, ars in zip(s["max_sizes"], s["aspect_ratios"])]
    loc, conf = _head([f38, f19, f10, f5, f3, f1], k_cells, num_classes)
    priors = ssd_priors(300, s["fmap_sizes"], s["min_sizes"],
                        s["max_sizes"], s["aspect_ratios"])
    return Model(inp, [loc, conf]), priors


def ssd_lite(num_classes: int = 4, image_size: int = 64
             ) -> Tuple[Model, np.ndarray]:
    """Small SSD for tests / tiny datasets: 3 scales."""
    inp = Input(shape=(image_size, image_size, 3))
    x = _conv_bn(inp, 16, 3, stride=2)     # 32
    x = _conv_bn(x, 32, 3)
    f1 = _conv_bn(x, 32, 3, stride=2)      # 16
    f2 = _conv_bn(f1, 64, 3, stride=2)     # 8
    f3 = _conv_bn(f2, 64, 3, stride=2)     # 4
    fmaps = (image_size // 4, image_size // 8, image_size // 16)
    min_sizes = (image_size * 0.15, image_size * 0.35, image_size * 0.6)
    max_sizes = (image_size * 0.35, image_size * 0.6, image_size * 0.9)
    ars = ((2.0,), (2.0,), (2.0,))
    k_cells = [num_priors_per_cell(mx, a)
               for mx, a in zip(max_sizes, ars)]
    loc, conf = _head([f1, f2, f3], k_cells, num_classes)
    priors = ssd_priors(image_size, fmaps, min_sizes, max_sizes, ars)
    return Model(inp, [loc, conf]), priors


class SSDDetector:
    """Detection wrapper: forward → decode → NMS (the predictImageSet
    + postprocess role of ImageModel/SSD).

    ``per_class_nms=False`` (default): best-non-background-class NMS —
    cheap, one NMS pass per image.  ``per_class_nms=True``: the
    torchvision/COCO postprocess — NMS per class with cross-class
    results (overlapping objects of DIFFERENT classes both survive),
    bounded by ``topk_per_class`` candidates per class."""

    def __init__(self, model: Model, priors: np.ndarray,
                 num_classes: int, score_threshold: float = 0.3,
                 iou_threshold: float = 0.45, max_detections: int = 100,
                 per_class_nms: bool = False, topk_per_class: int = 400):
        self.model = model
        self.priors = torch.as_tensor(np.asarray(priors, np.float32))
        self.num_classes = num_classes
        self.score_threshold = score_threshold
        self.iou_threshold = iou_threshold
        self.max_detections = max_detections
        self.per_class_nms = per_class_nms
        self.topk_per_class = topk_per_class
        self._fn = None

    def _build(self):
        model = self.model
        k_iou, k_max, k_score = (self.iou_threshold, self.max_detections,
                                 self.score_threshold)
        per_class, k_topk = self.per_class_nms, self.topk_per_class

        def detect(params, state, priors, x):
            with torch.no_grad():
                (loc, conf), _ = model.apply(params, x, state=state,
                                             training=False)
                boxes = decode_boxes(loc, priors)             # (B,P,4)
                probs = torch.softmax(conf, dim=-1)           # (B,P,C)
                if per_class:
                    return multiclass_nms(boxes, probs, k_iou, k_score,
                                          k_topk, k_max)
                score = probs[..., 1:].amax(dim=-1)           # best non-bg
                label = probs[..., 1:].argmax(dim=-1) + 1
                idx, valid = nms(boxes, score, k_iou, k_max, k_score)
                safe = idx.clamp(min=0)
                return (_rows(boxes, safe), score.gather(-1, safe),
                        label.gather(-1, safe).to(torch.int32), valid)

        from analytics_zoo_torch.compile import engine_jit
        self._fn = engine_jit(detect, borrow_argnums=(0, 1, 2),
                              key_hint="ssd_detect")

    def detect(self, images: np.ndarray):
        """-> list per image of (boxes (k,4), scores (k,), labels (k,))."""
        if self._fn is None:
            self._build()
        v = self.model.get_variables()
        device = tree_leaves(v["params"])[0].device
        if self.priors.device != device:
            self.priors = self.priors.to(device)
        x = torch.as_tensor(np.ascontiguousarray(images, np.float32)
                            ).to(device)
        boxes, scores, labels, valid = (
            t.cpu().numpy() for t in self._fn(v["params"], v["state"],
                                              self.priors, x))
        return [(b[m], s[m], l[m])
                for b, s, l, m in zip(boxes, scores, labels, valid)]
