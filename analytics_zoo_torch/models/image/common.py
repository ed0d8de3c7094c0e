"""ImageModel base and its per-model ImageConfigure (port of
``models/image/common.py``): ``predict_image_set`` runs the configure's
preprocessor over an ImageSet on the host, predicts the stacked batch on
the zoo context's device and applies the postprocessor;
``predict_image_classes`` takes the top-k classes (named through the
label map when there is one)."""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np

from analytics_zoo_torch.feature.common import Preprocessing
from analytics_zoo_torch.models.common import ZooModel


@dataclasses.dataclass
class ImageConfigure:
    preprocessor: Optional[Preprocessing] = None
    postprocessor: Optional[Callable] = None
    batch_per_partition: int = 4
    label_map: Optional[dict] = None


class ImageModel(ZooModel):
    """Base for the image classification models."""

    def __init__(self, config: Optional[ImageConfigure] = None):
        self.config = config or ImageConfigure()
        super().__init__()

    def _materialize_image_set(self, image_set, cfg: ImageConfigure
                               ) -> np.ndarray:
        """The preprocessed images stacked into one float32 batch."""
        if cfg.preprocessor is not None:
            image_set = image_set.transform(cfg.preprocessor)
        return np.stack(image_set.images).astype(np.float32)

    def predict_image_set(self, image_set, configure: Optional[
            ImageConfigure] = None, batch_size: int = 32):
        cfg = configure or self.config
        x = self._materialize_image_set(image_set, cfg)
        out = self.predict(x, batch_size=batch_size)
        if cfg.postprocessor is not None:
            out = cfg.postprocessor(out)
        return out

    def predict_image_classes(self, image_set, top_k: int = 1, **kwargs):
        out = np.asarray(self.predict_image_set(image_set, **kwargs))
        idx = np.argsort(-out, axis=-1)[:, :top_k]
        if self.config.label_map:
            inv = {v: k for k, v in self.config.label_map.items()}
            return [[inv.get(int(i), int(i)) for i in row] for row in idx]
        return idx
