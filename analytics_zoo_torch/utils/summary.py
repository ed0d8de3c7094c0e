"""Training/validation summaries (ref: the pure-Scala TensorBoard writer
— tensorboard/FileWriter.scala, Summary.scala: TrainSummary /
ValidationSummary with scalar tags Loss, LearningRate, Throughput and
per-metric validation scalars, surfaced via Topology.scala:205-237).

Scalars are appended to a JSONL event log per app (crash-safe, trivially
parseable) with the same tag names and a ``read_scalar`` read-back API.
A TensorBoard-proto writer can layer on later without changing callers.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, List, Optional, Tuple


class _ScalarWriter:
    """Scalar event sink (JSONL + tfevents).

    Owns open file handles, so it supports ``with`` and an idempotent
    :meth:`close`; a write after close transparently REOPENS the sink
    (append mode — nothing is lost), so callers like ``Estimator.train``
    can close on every exit path while repeated ``train()`` calls on
    the same writer keep working.  Every scalar is also mirrored to the
    shared metrics registry as ``summary_scalar{kind,tag}`` so the
    latest Loss/Throughput/metric values appear on ``/metrics``.
    """

    def __init__(self, log_dir: str, app_name: str, kind: str):
        from analytics_zoo_torch.utils.tb_writer import TBEventWriter
        self.dir = os.path.join(log_dir, app_name, kind)
        self.kind = kind
        os.makedirs(self.dir, exist_ok=True)
        self.path = os.path.join(self.dir, "events.jsonl")
        self._f = open(self.path, "a")
        self._seal_torn_line()
        # real tfevents alongside the JSONL, loadable by TensorBoard
        self._tb = TBEventWriter(self.dir)
        self._closed = False
        from analytics_zoo_torch.observability import get_registry
        self._gauge = get_registry().gauge(
            "summary_scalar", "latest value per summary tag",
            labels=("kind", "tag"))

    def _seal_torn_line(self) -> None:
        """A crash mid-write can leave a torn final line; start appends
        on a fresh line so the torn record corrupts only itself, not
        the next record written after reopen."""
        try:
            if self._f.tell() > 0:
                with open(self.path, "rb") as rf:
                    rf.seek(-1, os.SEEK_END)
                    if rf.read(1) != b"\n":
                        self._f.write("\n")
                        self._f.flush()
        except OSError:
            pass

    def _ensure_open(self) -> None:
        if not self._closed:
            return
        from analytics_zoo_torch.utils.tb_writer import TBEventWriter
        self._f = open(self.path, "a")
        self._seal_torn_line()
        # a fresh tfevents file in the same dir: TensorBoard merges
        # all event files of a run directory
        self._tb = TBEventWriter(self.dir)
        self._closed = False

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        self._ensure_open()
        rec = {"tag": tag, "value": float(value), "step": int(step),
               "wall_time": time.time()}
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()
        self._tb.add_scalar(tag, value, step)
        self._gauge.labels(self.kind, tag).set(float(value))

    def read_scalar(self, tag: str) -> List[Tuple[int, float]]:
        out = []
        if not os.path.exists(self.path):
            return out
        with open(self.path) as f:
            for line in f:
                # a torn/truncated final line (crash mid-write) parses
                # as invalid JSON and is skipped, not fatal
                try:
                    rec = json.loads(line)
                except json.JSONDecodeError:
                    continue
                if rec.get("tag") == tag:
                    out.append((rec["step"], rec["value"]))
        return out

    @property
    def closed(self) -> bool:
        return self._closed

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self._f.close()
        self._tb.close()

    def __enter__(self) -> "_ScalarWriter":
        self._ensure_open()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close()


class TrainSummary(_ScalarWriter):
    """Tags: Loss, LearningRate, Throughput (Topology.scala:221-223)."""

    def __init__(self, log_dir: str, app_name: str):
        super().__init__(log_dir, app_name, "train")


class ValidationSummary(_ScalarWriter):
    """One scalar per validation metric name."""

    def __init__(self, log_dir: str, app_name: str):
        super().__init__(log_dir, app_name, "validation")


class InferenceSummary(_ScalarWriter):
    """Serving-side tags: 'Serving Throughput', 'Total Records Number'
    (ClusterServing.scala:294-317)."""

    def __init__(self, log_dir: str, app_name: str):
        super().__init__(log_dir, app_name, "inference")
