"""Image pipeline: ImageSet and the per-image numpy transforms (port of
``feature/image.py``).

The transforms run on the host in numpy and give channels-last float32
arrays ready for the device.  Each random transform draws from its own
``np.random.default_rng(seed)``, as the reference's do, so the same seeds
give the same crops, flips and jitters in both packages.  An ImageSet is
a thin container over ndarrays; ``transform`` applies a Preprocessing
stage to every image and ``to_feature_set`` stacks them into a columnar
FeatureSet.

Not ported: decoding (``decode_image_bytes``, ``read_image``,
``ImageSet.read``), ``ImageResize`` and ``ImageHue`` (and so
``ImageColorJitter``'s hue stage), which run on OpenCV or PIL in the
reference; they raise ``NotImplementedError`` naming ROADMAP.md.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from analytics_zoo_torch.feature.common import Preprocessing
from analytics_zoo_torch.feature.feature_set import FeatureSet


def _needs_codec(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} needs an image codec (OpenCV or PIL) and is not ported to "
        "the PyTorch package yet (ROADMAP.md, port queue 1): pass decoded "
        "HWC arrays through ImageSet.from_ndarrays")


def decode_image_bytes(data: bytes, to_rgb: bool = True,
                       context: str = "") -> np.ndarray:
    raise _needs_codec("decode_image_bytes")


def read_image(path: str, to_rgb: bool = True) -> np.ndarray:
    raise _needs_codec("read_image")


# ------------------------------------------------------------- transforms
class ImageResize(Preprocessing):
    def __init__(self, resize_h: int, resize_w: int):
        self.h, self.w = int(resize_h), int(resize_w)

    def apply(self, img):
        raise _needs_codec("ImageResize")


class ImageCenterCrop(Preprocessing):
    def __init__(self, crop_h: int, crop_w: int):
        self.h, self.w = int(crop_h), int(crop_w)

    def apply(self, img):
        H, W = img.shape[:2]
        top = max((H - self.h) // 2, 0)
        left = max((W - self.w) // 2, 0)
        return img[top:top + self.h, left:left + self.w]


class ImageRandomCrop(Preprocessing):
    def __init__(self, crop_h: int, crop_w: int, seed: int = 0):
        self.h, self.w = int(crop_h), int(crop_w)
        self.rng = np.random.default_rng(seed)

    def reseed(self, seed: int) -> None:
        self.rng = np.random.default_rng(seed)

    def apply(self, img):
        H, W = img.shape[:2]
        top = int(self.rng.integers(0, max(H - self.h, 0) + 1))
        left = int(self.rng.integers(0, max(W - self.w, 0) + 1))
        return img[top:top + self.h, left:left + self.w]


class ImageHFlip(Preprocessing):
    def __init__(self, prob: float = 0.5, seed: int = 0):
        self.prob = prob
        self.rng = np.random.default_rng(seed)

    def reseed(self, seed: int) -> None:
        self.rng = np.random.default_rng(seed)

    def apply(self, img):
        if self.rng.random() < self.prob:
            return img[:, ::-1]
        return img


class ImageChannelNormalize(Preprocessing):
    """Subtract a per-channel mean, divide by a per-channel std."""

    def __init__(self, mean_r, mean_g, mean_b, std_r=1.0, std_g=1.0,
                 std_b=1.0):
        self.mean = np.array([mean_r, mean_g, mean_b], np.float32)
        self.std = np.array([std_r, std_g, std_b], np.float32)

    def apply(self, img):
        return (img.astype(np.float32) - self.mean) / self.std


class ImageBrightness(Preprocessing):
    """Additive brightness jitter."""

    def __init__(self, delta: float = 32.0, seed: int = 0):
        self.delta = delta
        self.rng = np.random.default_rng(seed)

    def reseed(self, seed: int) -> None:
        self.rng = np.random.default_rng(seed)

    def apply(self, img):
        shift = self.rng.uniform(-self.delta, self.delta)
        return np.clip(img.astype(np.float32) + shift, 0, 255)


class ImageContrast(Preprocessing):
    """Multiplicative contrast jitter."""

    def __init__(self, lower: float = 0.5, upper: float = 1.5,
                 seed: int = 0):
        self.lower, self.upper = float(lower), float(upper)
        self.rng = np.random.default_rng(seed)

    def reseed(self, seed: int) -> None:
        self.rng = np.random.default_rng(seed)

    def apply(self, img):
        alpha = self.rng.uniform(self.lower, self.upper)
        return np.clip(img.astype(np.float32) * alpha, 0, 255)


class ImageSaturation(Preprocessing):
    """Blend with the per-pixel grayscale."""

    def __init__(self, lower: float = 0.5, upper: float = 1.5,
                 seed: int = 0):
        self.lower, self.upper = float(lower), float(upper)
        self.rng = np.random.default_rng(seed)

    def reseed(self, seed: int) -> None:
        self.rng = np.random.default_rng(seed)

    def apply(self, img):
        alpha = self.rng.uniform(self.lower, self.upper)
        f = img.astype(np.float32)
        gray = f @ np.array([0.299, 0.587, 0.114], np.float32)
        return np.clip(alpha * f + (1 - alpha) * gray[..., None], 0, 255)


class ImageHue(Preprocessing):
    """Hue rotation in HSV space: needs OpenCV or PIL."""

    def __init__(self, delta: float = 18.0, seed: int = 0):
        self.delta = float(delta)
        self.rng = np.random.default_rng(seed)

    def reseed(self, seed: int) -> None:
        self.rng = np.random.default_rng(seed)

    def apply(self, img):
        raise _needs_codec("ImageHue")


class ImageColorJitter(Preprocessing):
    """Brightness, contrast, saturation and hue jitter in a random order;
    the hue stage raises (``ImageHue``) when the order reaches it."""

    def __init__(self, brightness_delta: float = 32.0,
                 contrast: Tuple[float, float] = (0.5, 1.5),
                 saturation: Tuple[float, float] = (0.5, 1.5),
                 hue_delta: float = 18.0, seed: int = 0):
        self.rng = np.random.default_rng(seed)
        self.stages = [
            ImageBrightness(brightness_delta, seed=seed + 1),
            ImageContrast(*contrast, seed=seed + 2),
            ImageSaturation(*saturation, seed=seed + 3),
            ImageHue(hue_delta, seed=seed + 4),
        ]

    def reseed(self, seed: int) -> None:
        self.rng = np.random.default_rng(seed)
        for i, st in enumerate(self.stages):
            st.reseed(seed + 10 + i)

    def apply(self, img):
        out = img
        for i in self.rng.permutation(len(self.stages)):
            out = self.stages[i].apply(out)
        return out


def expand_canvas(img: np.ndarray, rng, max_ratio: float, mean
                  ) -> Tuple[np.ndarray, int, int]:
    """Paste ``img`` at a random offset on a mean-filled canvas up to
    ``max_ratio`` larger; returns (canvas, top, left)."""
    h, w, c = img.shape
    ratio = float(rng.uniform(1.0, max_ratio))
    H, W = int(h * ratio), int(w * ratio)
    top = int(rng.integers(0, H - h + 1))
    left = int(rng.integers(0, W - w + 1))
    canvas = np.empty((H, W, c), img.dtype)
    canvas[...] = np.asarray(mean, np.float32).astype(img.dtype)
    canvas[top:top + h, left:left + w] = img
    return canvas, top, left


class ImageExpand(Preprocessing):
    """Zoom out onto a mean-filled canvas."""

    def __init__(self, max_ratio: float = 4.0, mean=(123, 117, 104),
                 prob: float = 0.5, seed: int = 0):
        self.max_ratio = float(max_ratio)
        self.mean = np.asarray(mean, np.float32)
        self.prob = prob
        self.rng = np.random.default_rng(seed)

    def reseed(self, seed: int) -> None:
        self.rng = np.random.default_rng(seed)

    def apply(self, img):
        if self.rng.random() >= self.prob:
            return img
        canvas, _, _ = expand_canvas(img, self.rng, self.max_ratio,
                                     self.mean)
        return canvas


class ImageChannelOrder(Preprocessing):
    """RGB <-> BGR swap."""

    def apply(self, img):
        return np.ascontiguousarray(img[..., ::-1])


class ImageMatToTensor(Preprocessing):
    """HWC uint8/float -> float32, optionally CHW."""

    def __init__(self, format: str = "NHWC"):
        self.format = format

    def apply(self, img):
        arr = img.astype(np.float32)
        if self.format == "NCHW":
            arr = arr.transpose(2, 0, 1)
        return arr


# -------------------------------------------------------------- ImageSet
class ImageSet:
    """Images (and optional labels) with chained transforms."""

    def __init__(self, images: List, labels: Optional[np.ndarray] = None,
                 label_map: Optional[dict] = None):
        self.images = images
        self.labels = labels
        self.label_map = label_map

    @classmethod
    def read(cls, path: str, with_label: bool = False,
             pattern: str = "*.jpg") -> "ImageSet":
        raise _needs_codec("ImageSet.read")

    @classmethod
    def from_ndarrays(cls, images: np.ndarray,
                      labels: Optional[np.ndarray] = None) -> "ImageSet":
        return cls(list(images),
                   None if labels is None else np.asarray(labels))

    def transform(self, stage: Preprocessing) -> "ImageSet":
        return ImageSet([stage.apply(im) for im in self.images],
                        self.labels, self.label_map)

    __rshift__ = transform

    def to_feature_set(self, shuffle: bool = True) -> FeatureSet:
        x = np.stack(self.images).astype(np.float32)
        y = None if self.labels is None else self.labels.reshape(-1, 1)
        return FeatureSet.from_ndarrays(x, y, shuffle=shuffle)

    def __len__(self):
        return len(self.images)
