"""Online drift / anomaly detection over stored telemetry series
(port of the JAX package's ``observability/drift.py``).

Two cheap, stdlib-only detectors run over any series the tsdb stores:

* **EWMA z-score** — an exponentially weighted mean/variance pair per
  series; the score is the standardized distance of the newest value
  from the running estimate.  Catches level shifts and spikes.
* **Seasonal-naive residual** — the residual against the value one
  season ago (``season`` points back), itself standardized by an EWMA
  of residuals.  Catches "the daily pattern changed" drift that a
  plain EWMA absorbs.

The published ``drift_score{series}`` gauge is ``max(|z_ewma|,
|z_seasonal|) / z_threshold`` — >= 1.0 means drifting.  The zoo's own
anomaly-detection capability plugs in through ``model_hook`` (given
the recent window, return a score or ``None`` to defer to the
built-ins) — the platform dogfooding its model zoo on its own
telemetry, with the stdlib detectors as the always-available default.

CONTRACT: stdlib-only at module level (no torch, no numpy; the
``aggregator.py`` contract).
"""

from __future__ import annotations

import math
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Sequence

__all__ = [
    "DriftDetector",
    "DriftWatch",
    "drift_report",
]


class DriftDetector:
    """Streaming detector for ONE series."""

    def __init__(self, *, alpha: float = 0.1, z_threshold: float = 3.0,
                 season: int = 0, min_points: int = 8,
                 window: int = 256):
        self.alpha = float(alpha)
        self.z_threshold = float(z_threshold)
        self.season = int(season)
        self.min_points = int(min_points)
        self.n = 0
        self.mean = 0.0
        self.var = 0.0
        self._res_n = 0
        self._res_mean = 0.0
        self._res_var = 0.0
        self._ring: deque = deque(maxlen=max(self.season, 1))
        self.recent: deque = deque(maxlen=int(window))
        self.last_score = 0.0
        self.peak_score = 0.0

    def _z(self, value: float, mean: float, var: float,
           n: int) -> float:
        if n < self.min_points:
            return 0.0
        sd = math.sqrt(max(var, 1e-18))
        # a flat-lined series (sd ~ 0) only drifts when the value
        # actually moves; guard against a 0/0 explosion on noise-free
        # constants
        if sd < 1e-9:
            return 0.0 if abs(value - mean) < 1e-9 else self.z_threshold * 2
        return (value - mean) / sd

    def observe(self, value: float) -> float:
        """Feed one point; returns the drift score (>= 1.0 drifting)."""
        value = float(value)
        self.recent.append(value)
        z_ewma = self._z(value, self.mean, self.var, self.n)
        z_seasonal = 0.0
        if self.season > 0 and len(self._ring) == self.season:
            residual = value - self._ring[0]
            z_seasonal = self._z(residual, self._res_mean,
                                 self._res_var, self._res_n)
            diff = residual - self._res_mean
            incr = self.alpha * diff
            self._res_mean += incr
            self._res_var = (1 - self.alpha) * (self._res_var
                                                + diff * incr)
            self._res_n += 1
        if self.season > 0:
            self._ring.append(value)
        # update the level estimate AFTER scoring the point against it
        diff = value - self.mean
        incr = self.alpha * diff
        self.mean += incr
        self.var = (1 - self.alpha) * (self.var + diff * incr)
        self.n += 1
        self.last_score = max(abs(z_ewma),
                              abs(z_seasonal)) / self.z_threshold
        self.peak_score = max(self.peak_score, self.last_score)
        return self.last_score


class DriftWatch:
    """Watches a set of series selectors over a store, one detector
    per concrete series, publishing ``drift_score{series}``.

    ``model_hook(series_key, recent_values) -> Optional[float]`` is
    the anomaly-model plug-in point; return ``None`` to keep the
    stdlib score."""

    def __init__(self, selectors: Sequence[str], *,
                 registry: Any = None,
                 model_hook: Optional[Callable[[str, List[float]],
                                               Optional[float]]] = None,
                 **detector_kwargs: Any):
        self.selectors = list(selectors)
        self.model_hook = model_hook
        self._detector_kwargs = detector_kwargs
        self._detectors: Dict[str, DriftDetector] = {}
        self._seen_until: Dict[str, float] = {}
        self.peak_at: Dict[str, float] = {}
        self._gauge = None
        if registry is not None:
            self._gauge = registry.gauge(
                "drift_score",
                "drift score per watched series (>=1 drifting)",
                labels=("series",))

    def detector(self, key: str) -> DriftDetector:
        if key not in self._detectors:
            self._detectors[key] = DriftDetector(
                **self._detector_kwargs)
        return self._detectors[key]

    def observe_store(self, store: Any) -> Dict[str, float]:
        """Feed every not-yet-seen point of every watched series;
        returns the latest score per series."""
        scores: Dict[str, float] = {}
        for selector in self.selectors:
            for key, pts in store.query(selector).items():
                det = self.detector(key)
                seen = self._seen_until.get(key, float("-inf"))
                for t, v in pts:
                    if t <= seen:
                        continue
                    score = det.observe(v)
                    if score >= det.peak_score:
                        self.peak_at[key] = t
                    self._seen_until[key] = t
                score = det.last_score
                if self.model_hook is not None and det.recent:
                    hooked = self.model_hook(key, list(det.recent))
                    if hooked is not None:
                        score = float(hooked)
                        det.last_score = score
                scores[key] = score
                if self._gauge is not None:
                    self._gauge.labels(key).set(score)
                self._notify_watchdog(key, score)
        return scores

    @staticmethod
    def _notify_watchdog(key: str, score: float) -> None:
        """Feed the training watchdog's advisory drift hook when one
        is active.  A lazy import: drift.py's module level stays
        stdlib-only."""
        try:
            from analytics_zoo_torch.observability.watchdog import (
                get_active_watchdog)
        except ImportError:
            return
        wd = get_active_watchdog()
        if wd is not None and hasattr(wd, "observe_drift"):
            wd.observe_drift(key, score)


def drift_report(store: Any, selectors: Sequence[str], *,
                 threshold: float = 1.0,
                 **detector_kwargs: Any) -> List[Dict[str, Any]]:
    """Offline sweep: replay every matching series through a fresh
    detector and return the callouts sorted worst-first — the
    ``obs_report --slo`` drift section."""
    watch = DriftWatch(selectors, **detector_kwargs)
    scores = watch.observe_store(store)
    out = []
    for key, score in scores.items():
        det = watch.detector(key)
        out.append({
            "series": key,
            "score": round(score, 4),
            "peak_score": round(det.peak_score, 4),
            "peak_at": watch.peak_at.get(key),
            "drifting": det.peak_score >= threshold,
            "points": det.n,
            "mean": round(det.mean, 6),
            "last": round(det.recent[-1], 6) if det.recent else None,
        })
    out.sort(key=lambda d: -d["peak_score"])
    return out
