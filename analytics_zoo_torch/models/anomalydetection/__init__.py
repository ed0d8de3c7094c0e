from analytics_zoo_torch.models.anomalydetection.anomaly_detector import (
    AnomalyDetector, detect_anomalies, unroll,
)

__all__ = ["AnomalyDetector", "detect_anomalies", "unroll"]
