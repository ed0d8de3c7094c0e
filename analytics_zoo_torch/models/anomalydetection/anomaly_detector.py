"""LSTM time-series anomaly detection (port of
``models/anomalydetection/anomaly_detector.py``).

Reference: zoo/models/anomalydetection/AnomalyDetector.scala:40-222 —
stacked LSTMs predicting the next value from an unrolled window;
``Unroll`` builds the windows; ``detectAnomalies`` flags the top-N
largest |y - y_hat| distances as anomalies.  ``unroll`` and
``detect_anomalies`` are numpy, as in the reference; the model is the
port's ``LSTM``, ``Dropout`` and ``Dense`` in a graph ``Model``.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

from analytics_zoo_torch.models.common import ZooModel
from analytics_zoo_torch.pipeline.api.keras import Input, Model
from analytics_zoo_torch.pipeline.api.keras.layers import (
    LSTM, Dense, Dropout,
)


def unroll(data: np.ndarray, unroll_length: int
           ) -> Tuple[np.ndarray, np.ndarray]:
    """Sliding windows: (N, F) series -> x (N-L, L, F), y (N-L, 1) of the
    first feature's value following each window."""
    data = np.asarray(data, np.float32)
    if data.ndim == 1:
        data = data[:, None]
    n = len(data) - unroll_length
    idx = np.arange(unroll_length)[None, :] + np.arange(n)[:, None]
    x = data[idx]
    y = data[unroll_length:, 0]
    return x, y.reshape(-1, 1)


def detect_anomalies(y_true: np.ndarray, y_pred: np.ndarray,
                     anomaly_size: int = 5) -> np.ndarray:
    """Indices of the ``anomaly_size`` largest absolute errors (ties at
    the threshold included)."""
    dist = np.abs(np.ravel(y_true) - np.ravel(y_pred))
    threshold = np.sort(dist)[-anomaly_size]
    return np.where(dist >= threshold)[0]


class AnomalyDetector(ZooModel):
    """Stacked LSTMs (each but the last returning sequences), each
    followed by its Dropout, then ``Dense(1)``; input (unroll,
    features)."""

    def __init__(self, feature_shape: Tuple[int, int],
                 hidden_layers: Sequence[int] = (8, 32, 15),
                 dropouts: Sequence[float] = (0.2, 0.2, 0.2)):
        self.feature_shape = tuple(feature_shape)     # (unroll, features)
        self.hidden_layers = list(hidden_layers)
        self.dropouts = list(dropouts)
        if len(self.hidden_layers) != len(self.dropouts):
            raise ValueError("hidden_layers and dropouts differ in length")
        super().__init__()

    def build_model(self):
        inp = Input(shape=self.feature_shape)
        x = inp
        for i, (h, p) in enumerate(zip(self.hidden_layers, self.dropouts)):
            last = (i == len(self.hidden_layers) - 1)
            x = LSTM(h, return_sequences=not last)(x)
            x = Dropout(p)(x)
        out = Dense(1)(x)
        return Model(inp, out)
