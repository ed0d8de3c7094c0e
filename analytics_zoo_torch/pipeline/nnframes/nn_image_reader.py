"""NNImageReader: read images into a DataFrame with an image column
(port of ``pipeline/nnframes/nn_image_reader.py``; ref:
zoo/pipeline/nnframes/NNImageReader.scala + NNImageSchema — image struct:
origin, height, width, nChannels, mode, data).  pandas is imported when
``read_images`` runs, as the reference does.
"""

from __future__ import annotations

import glob
import os
from typing import Optional

import numpy as np


def read_images(path: str, pattern: str = "*.jpg",
                resize_h: Optional[int] = None,
                resize_w: Optional[int] = None):
    """Return a pandas DataFrame with columns [origin, height, width,
    n_channels, mode, data] — the NNImageSchema row shape."""
    import pandas as pd

    from analytics_zoo_torch.feature.image import ImageResize, read_image
    from analytics_zoo_torch.utils import file_io
    if file_io.is_remote(path):
        files = file_io.list_files(path.rstrip("/") + "/" + pattern)
        if not files:
            files = file_io.list_files(
                path.rstrip("/") + "/**/" + pattern)
    else:
        files = sorted(glob.glob(os.path.join(path, pattern)))
        if not files:
            files = sorted(glob.glob(os.path.join(path, "**", pattern),
                                     recursive=True))
    rows = []
    resize = (ImageResize(resize_h, resize_w)
              if resize_h and resize_w else None)
    for f in files:
        img = read_image(f)
        if resize is not None:
            img = resize.apply(img)
        rows.append({
            "origin": f,
            "height": img.shape[0],
            "width": img.shape[1],
            "n_channels": img.shape[2],
            # NNImageSchema `mode`: OpenCV type code of the STORED
            # buffer — data is float32 HWC, i.e. CV_32FC3
            "mode": 21,
            "data": img.astype(np.float32),
        })
    return pd.DataFrame(rows)


class NNImageReader:
    readImages = staticmethod(read_images)
    read_images = staticmethod(read_images)
