"""Image pipeline: ImageSet and the per-image numpy transforms (port of
``feature/image.py``).

The transforms run on the host in numpy and give channels-last float32
arrays ready for the device.  Each random transform draws from its own
``np.random.default_rng(seed)``, as the reference's do, so the same seeds
give the same crops, flips and jitters in both packages.  An ImageSet is
a thin container over ndarrays; ``transform`` applies a Preprocessing
stage to every image and ``to_feature_set`` stacks them into a columnar
FeatureSet.

Decoding (``decode_image_bytes``, ``read_image``, ``ImageSet.read``),
``ImageResize`` and ``ImageHue`` run on OpenCV when it imports, else on
PIL, as the reference's do (the same ``_HAS_CV2`` guard), so both
packages decode and resize to the same bytes on either codec.  PIL's BGR
result is a negative-stride view of its RGB array, as the reference
returns it; the consumers that hand arrays to torch make them contiguous.
"""

from __future__ import annotations

import glob
import os
from typing import List, Optional, Tuple

import numpy as np

try:
    import cv2
    _HAS_CV2 = True
except Exception:            # pragma: no cover
    _HAS_CV2 = False

from analytics_zoo_torch.feature.common import Preprocessing
from analytics_zoo_torch.feature.feature_set import FeatureSet


def decode_image_bytes(data: bytes, to_rgb: bool = True,
                       context: str = "") -> np.ndarray:
    """Decode one encoded image (JPEG/PNG bytes) to HWC uint8.
    ``context`` names the source (path / record id) in decode errors."""
    what = f"image {context}" if context else "image bytes"
    if _HAS_CV2:
        img = cv2.imdecode(np.frombuffer(data, np.uint8),
                           cv2.IMREAD_COLOR)
        if img is None:
            raise IOError(f"cannot decode {what}")
        return cv2.cvtColor(img, cv2.COLOR_BGR2RGB) if to_rgb else img
    import io
    from PIL import Image
    try:
        rgb = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    except Exception as e:
        raise IOError(f"cannot decode {what}") from e
    return rgb if to_rgb else rgb[..., ::-1]


def read_image(path: str, to_rgb: bool = True) -> np.ndarray:
    """Decode one image file (local or remote URI) to HWC uint8."""
    from analytics_zoo_torch.utils import file_io
    if file_io.is_remote(path):
        return decode_image_bytes(file_io.read_bytes(path), to_rgb,
                                  context=path)
    if _HAS_CV2:
        img = cv2.imread(path, cv2.IMREAD_COLOR)
        if img is None:
            raise IOError(f"cannot decode image {path}")
        return cv2.cvtColor(img, cv2.COLOR_BGR2RGB) if to_rgb else img
    from PIL import Image
    return np.asarray(Image.open(path).convert("RGB"))


# ------------------------------------------------------------- transforms
class ImageResize(Preprocessing):
    """Bilinear resize to (resize_h, resize_w)."""

    def __init__(self, resize_h: int, resize_w: int):
        self.h, self.w = int(resize_h), int(resize_w)

    def apply(self, img: np.ndarray) -> np.ndarray:
        if _HAS_CV2:
            return cv2.resize(img, (self.w, self.h),
                              interpolation=cv2.INTER_LINEAR)
        from PIL import Image
        return np.asarray(Image.fromarray(img).resize((self.w, self.h)))


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
    """Hue rotation in HSV space."""

    def __init__(self, delta: float = 18.0, seed: int = 0):
        self.delta = float(delta)
        self.rng = np.random.default_rng(seed)

    def reseed(self, seed: int) -> None:
        self.rng = np.random.default_rng(seed)

    def apply(self, img):
        shift = self.rng.uniform(-self.delta, self.delta)
        u8 = np.clip(img, 0, 255).astype(np.uint8)
        if _HAS_CV2:
            hsv = cv2.cvtColor(u8, cv2.COLOR_RGB2HSV)
            h = hsv[..., 0].astype(np.int16)
            hsv[..., 0] = ((h + int(shift / 2)) % 180).astype(np.uint8)
            out = cv2.cvtColor(hsv, cv2.COLOR_HSV2RGB)
        else:
            from PIL import Image
            hsv = np.asarray(Image.fromarray(u8).convert("HSV"),
                             np.int16)
            hsv[..., 0] = (hsv[..., 0] + int(shift * 255 / 360)) % 256
            out = np.asarray(Image.fromarray(
                hsv.astype(np.uint8), "HSV").convert("RGB"))
        return out.astype(img.dtype if np.issubdtype(
            np.asarray(img).dtype, np.floating) else np.uint8)


class ImageColorJitter(Preprocessing):
    """Brightness, contrast, saturation and hue jitter in a random order
    (the full photometric distort)."""

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
    """Images (and optional labels) with chained transforms.

    ``read`` takes a local directory of files matching ``pattern``; with
    ``with_label=True``, one sub-directory per class, labelled in sorted
    order."""

    def __init__(self, images: List, labels: Optional[np.ndarray] = None,
                 label_map: Optional[dict] = None):
        self.images = images
        self.labels = labels
        self.label_map = label_map

    @classmethod
    def read(cls, path: str, with_label: bool = False,
             pattern: str = "*.jpg") -> "ImageSet":
        if with_label:
            classes = sorted(
                d for d in os.listdir(path)
                if os.path.isdir(os.path.join(path, d)))
            label_map = {c: i for i, c in enumerate(classes)}
            files, labels = [], []
            for c in classes:
                for f in sorted(glob.glob(os.path.join(path, c, pattern))):
                    files.append(f)
                    labels.append(label_map[c])
            images = [read_image(f) for f in files]
            return cls(images, np.asarray(labels, np.int32), label_map)
        files = sorted(glob.glob(os.path.join(path, pattern)))
        return cls([read_image(f) for f in files])

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
