"""ObjectDetector: the user-facing detection model facade (port of
``models/image/objectdetection/detector.py``).

Reference: zoo/models/image/objectdetection/ObjectDetector.scala —
``loadModel`` materialises a published detector by name/path, and
``predictImageSet`` runs the ImageConfigure preprocess → forward →
decode/NMS postprocess chain; ``Visualizer.scala`` draws the boxes.

The detector is a ZooModel wrapping an SSD graph + priors; the whole
postprocess (box decode + NMS) runs inside the compiled program
(SSDDetector).  ``save_model``/``load_model`` persist architecture
metadata + trained variables in one msgpack file, the JAX package's
layout, so a detector saved by either package loads in the other.  The
torchvision-derived ``ssd300_vgg16`` and ``ssdlite320_mobilenet_v3``
wait for checkpoint files that are not in the repository and raise.
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from analytics_zoo_torch.models.image.common import (ImageConfigure,
                                                     ImageModel)
from analytics_zoo_torch.models.image.objectdetection.ssd import (
    SSDDetector, ssd_lite, ssd_vgg300)


def _pretrained_not_ported(name: str):
    def build(num_classes: int = 91):
        raise NotImplementedError(
            f"{name}: the torchvision-derived pretrained detectors "
            "(objectdetection/pretrained*.py) are not ported to the PyTorch "
            "package yet; they wait for checkpoint files in the repository "
            "(ROADMAP.md, port queue 1)")
    return build


_ARCHS = {"ssd_lite": ssd_lite, "ssd_vgg300": ssd_vgg300,
          "ssd300_vgg16": _pretrained_not_ported("ssd300_vgg16"),
          "ssdlite320_mobilenet_v3": _pretrained_not_ported(
              "ssdlite320_mobilenet_v3")}
# architectures whose input size is baked into the graph
_FIXED_SIZE = {"ssd_vgg300": 300, "ssd300_vgg16": 300,
               "ssdlite320_mobilenet_v3": 320}


class ObjectDetector(ImageModel):
    """A named SSD architecture + trained weights + detection config."""

    def __init__(self, model_type: str = "ssd_lite",
                 num_classes: int = 21, image_size: int = 300,
                 score_threshold: float = 0.3,
                 iou_threshold: float = 0.45,
                 max_detections: int = 100,
                 per_class_nms: bool = False,
                 topk_per_class: int = 400,
                 label_map: Optional[Dict[str, int]] = None,
                 config: Optional[ImageConfigure] = None):
        if model_type not in _ARCHS:
            raise ValueError(f"unknown detector '{model_type}' "
                             f"(have {sorted(_ARCHS)})")
        self.model_type = model_type
        self.num_classes = int(num_classes)
        self.image_size = int(image_size)
        self.score_threshold = float(score_threshold)
        self.iou_threshold = float(iou_threshold)
        self.max_detections = int(max_detections)
        self.per_class_nms = bool(per_class_nms)
        self.topk_per_class = int(topk_per_class)
        self._detector = None
        self._detector_key = None
        super().__init__(config=config or ImageConfigure(
            label_map=label_map))

    # ------------------------------------------------------------ building
    def build_model(self):
        if self.model_type in _FIXED_SIZE:    # input size baked in
            self.image_size = _FIXED_SIZE[self.model_type]
            model, self.priors = _ARCHS[self.model_type](
                num_classes=self.num_classes)
        else:
            model, self.priors = _ARCHS[self.model_type](
                num_classes=self.num_classes, image_size=self.image_size)
        model.init()
        return model

    @property
    def detector(self) -> SSDDetector:
        # rebuild when a threshold changed — the compiled postprocess
        # bakes them in, so a stale cache would silently ignore edits
        key = (self.score_threshold, self.iou_threshold,
               self.max_detections, self.per_class_nms,
               self.topk_per_class)
        if self._detector is None or self._detector_key != key:
            self._detector = SSDDetector(
                self.model, self.priors, num_classes=self.num_classes,
                score_threshold=self.score_threshold,
                iou_threshold=self.iou_threshold,
                max_detections=self.max_detections,
                per_class_nms=self.per_class_nms,
                topk_per_class=self.topk_per_class)
            self._detector_key = key
        return self._detector

    # ----------------------------------------------------------- detection
    def detect(self, images: np.ndarray
               ) -> List[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
        """-> per image (boxes (k,4) normalised, scores, labels)."""
        return self.detector.detect(np.asarray(images, np.float32))

    def predict_image_set(self, image_set, configure=None,
                          batch_size: int = 32):
        """ImageSet → per-image detections (predictImageSet role).

        Unlike classification, the postprocessor here is called PER
        IMAGE with a ``(boxes, scores, labels)`` tuple.
        """
        cfg = configure or self.config
        x = self._materialize_image_set(image_set, cfg)
        out = []
        for lo in range(0, len(x), batch_size):
            chunk = x[lo:lo + batch_size]
            real = len(chunk)
            if real < batch_size:    # pad: ONE compiled program serves
                chunk = np.concatenate(   # every tail size
                    [chunk, np.zeros((batch_size - real,)
                                     + chunk.shape[1:], chunk.dtype)])
            out.extend(self.detect(chunk)[:real])
        if cfg.postprocessor is not None:
            out = [cfg.postprocessor(o) for o in out]
        return out

    def label_names(self, labels: Sequence[int]) -> List[str]:
        if not self.config.label_map:
            return [str(int(l)) for l in labels]
        inv = {v: k for k, v in self.config.label_map.items()}
        return [inv.get(int(l), str(int(l))) for l in labels]

    # ------------------------------------------------------- visualisation
    def visualize(self, image: np.ndarray, boxes: np.ndarray,
                  scores: np.ndarray, labels: np.ndarray,
                  min_score: float = 0.0) -> np.ndarray:
        """Draw detections on an HWC image; returns a uint8 canvas
        (Visualizer.scala role)."""
        img = np.asarray(image)
        if img.dtype != np.uint8:    # drawing needs a uint8 canvas
            hi = float(img.max()) if img.size else 1.0
            # [0,1]-normalised floats scale up; 0..255 floats just clip
            # (a ratio-based stretch would distort appearance)
            if hi <= 1.0:
                img = img * 255.0
            img = np.clip(img, 0, 255).astype(np.uint8)
        img = np.ascontiguousarray(img)
        h, w = img.shape[:2]
        names = self.label_names(labels)
        try:
            import cv2
        except ImportError:          # pragma: no cover
            cv2 = None
        color = (0, 255, 0)
        for box, score, name in zip(boxes, scores, names):
            if score < min_score:
                continue
            x0 = min(max(int(box[0] * w), 0), w - 1)
            y0 = min(max(int(box[1] * h), 0), h - 1)
            x1 = min(max(int(box[2] * w), 0), w - 1)
            y1 = min(max(int(box[3] * h), 0), h - 1)
            if cv2 is not None:
                cv2.rectangle(img, (x0, y0), (x1, y1), color, 1)
                cv2.putText(img, f"{name}:{score:.2f}", (x0, max(y0, 10)),
                            cv2.FONT_HERSHEY_PLAIN, 0.8, color)
            else:                    # pragma: no cover
                img[y0:y1 + 1, x0] = color
                img[y0:y1 + 1, x1] = color
                img[y0, x0:x1 + 1] = color
                img[y1, x0:x1 + 1] = color
        return img

    # --------------------------------------------------------- persistence
    def save_model(self, path: str, over_write: bool = True) -> None:
        """One-file persistence: architecture meta + trained variables
        (ObjectDetector.loadModel's artifact format), a msgpack tree
        (no pickle), written atomically.  The variables are keyed by the
        layers' order, not their auto-names, so any process reloads
        them."""
        from analytics_zoo_torch.utils.serialization import save_variables
        variables = self.model.get_variables()
        order = [l.name for l in self.model.layers]
        if len(set(order)) != len(order):
            dupes = sorted({n for n in order if order.count(n) > 1})
            raise ValueError(
                f"duplicate layer names {dupes}: order-keyed save would "
                "silently overwrite one layer's weights with another's")
        index_of = {n: i for i, n in enumerate(order)}
        variables = {
            kind: {f"layer_{index_of[n]:04d}": sub
                   for n, sub in tree.items()}
            for kind, tree in variables.items()}
        meta = {
            "model_type": self.model_type,
            "num_classes": self.num_classes,
            "image_size": self.image_size,
            "score_threshold": self.score_threshold,
            "iou_threshold": self.iou_threshold,
            "max_detections": self.max_detections,
            "per_class_nms": self.per_class_nms,
            "topk_per_class": self.topk_per_class,
            "label_map": self.config.label_map,
        }
        save_variables(path, {
            "format": "zoo_object_detector_v1",
            "meta": json.dumps(meta),
            "variables": variables,
        }, over_write=over_write)

    @classmethod
    def load_model(cls, path: str) -> "ObjectDetector":
        """A detector from a ``save_model`` file of either package, its
        variables on this model's device; a file of another architecture
        raises."""
        from analytics_zoo_torch.utils import file_io
        from analytics_zoo_torch.utils import msgpack_codec as codec
        from analytics_zoo_torch.utils.serialization import (
            from_state_dict)
        payload = codec.unpackb(file_io.read_bytes(path))
        if not isinstance(payload, dict) or \
                payload.get("format") != "zoo_object_detector_v1":
            raise ValueError(f"{path} is not a saved ObjectDetector")
        meta = json.loads(payload["meta"])
        label_map = meta.pop("label_map", None)
        det = cls(label_map=label_map, **meta)
        order = [l.name for l in det.model.layers]
        like = {kind: {f"layer_{order.index(n):04d}": sub
                       for n, sub in tree.items()}
                for kind, tree in det.model.get_variables().items()}
        try:
            restored = from_state_dict(like, payload["variables"])
        except ValueError as e:
            raise ValueError(
                f"{path}: saved detector does not match the rebuilt "
                f"{meta['model_type']} architecture ({e})") from e
        det.model.set_variables({
            kind: {order[int(key.split("_")[-1])]: sub
                   for key, sub in tree.items()}
            for kind, tree in restored.items()})
        return det
