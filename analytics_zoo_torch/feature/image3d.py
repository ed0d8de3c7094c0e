"""3D (volumetric / medical) image transforms (port of
``feature/image3d.py``).

Reference: zoo/feature/image3d/ — Rotation3D (Rotation.scala:133),
Crop3D, AffineTransform3D.  Crops are numpy slices; the rotation and the
affine resampling run on the host in ``scipy.ndimage``, imported when a
transform is applied, so the same scipy gives both packages the same
volumes.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

from analytics_zoo_torch.feature.common import Preprocessing


class Crop3D(Preprocessing):
    """Crop a (D, H, W) volume at ``start`` with ``patch_size``."""

    def __init__(self, start: Sequence[int], patch_size: Sequence[int]):
        self.start = tuple(int(v) for v in start)
        self.patch = tuple(int(v) for v in patch_size)

    def apply(self, vol: np.ndarray) -> np.ndarray:
        (z, y, x), (dz, dy, dx) = self.start, self.patch
        return vol[z:z + dz, y:y + dy, x:x + dx]


class CenterCrop3D(Preprocessing):
    def __init__(self, patch_size: Sequence[int]):
        self.patch = tuple(int(v) for v in patch_size)

    def apply(self, vol: np.ndarray) -> np.ndarray:
        start = [(s - p) // 2 for s, p in zip(vol.shape[:3], self.patch)]
        return Crop3D(start, self.patch).apply(vol)


class RandomCrop3D(Preprocessing):
    def __init__(self, patch_size: Sequence[int], seed: int = 0):
        self.patch = tuple(int(v) for v in patch_size)
        self.rng = np.random.default_rng(seed)

    def apply(self, vol: np.ndarray) -> np.ndarray:
        start = [int(self.rng.integers(0, max(s - p, 0) + 1))
                 for s, p in zip(vol.shape[:3], self.patch)]
        return Crop3D(start, self.patch).apply(vol)


class Rotate3D(Preprocessing):
    """Rotate around one axis by ``angle`` degrees (Rotation.scala)."""

    def __init__(self, angle: float, axes: Tuple[int, int] = (0, 1),
                 order: int = 1):
        self.angle = float(angle)
        self.axes = axes
        self.order = order

    def apply(self, vol: np.ndarray) -> np.ndarray:
        from scipy.ndimage import rotate
        return rotate(vol, self.angle, axes=self.axes, reshape=False,
                      order=self.order, mode="nearest")


class AffineTransform3D(Preprocessing):
    """Apply a 3x3 affine matrix (+ optional translation)
    (AffineTransform3D)."""

    def __init__(self, matrix: np.ndarray,
                 translation: Optional[Sequence[float]] = None,
                 order: int = 1):
        self.matrix = np.asarray(matrix, np.float64)
        self.translation = (np.zeros(3) if translation is None
                            else np.asarray(translation, np.float64))
        self.order = order

    def apply(self, vol: np.ndarray) -> np.ndarray:
        from scipy.ndimage import affine_transform
        center = (np.asarray(vol.shape[:3]) - 1) / 2.0
        offset = center - self.matrix @ center + self.translation
        return affine_transform(vol, self.matrix, offset=offset,
                                order=self.order, mode="nearest")
