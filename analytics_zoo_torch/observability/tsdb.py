"""Embedded append-only telemetry time-series store (port of the JAX
package's ``observability/tsdb.py``; the segment files are its, byte
for byte, so either package reads the other's).

The registry and the cluster federation answer "what is
the value NOW"; this module gives the platform a memory so the SLO
engine (``observability/slo.py``) and the drift watch
(``observability/drift.py``) can answer "what happened over the last
window".  One writer per process appends **segment files** under the
run-dir host slot (``host-<k>/tsdb/seg-*.jsonl``), fed by a
background sampler that scrapes the in-process registry snapshot on a
jittered interval and once more at ``flush_worker_observability``.

Design points (sized for an embedded store, not a Prometheus):

* **Delta-encoded counters** — each sample records counter deltas
  against the previous sample; a segment's first sample (and any
  sample observing a counter reset) is a ``full`` sample carrying
  absolute values, so every segment is self-describing and a torn or
  deleted predecessor never corrupts reconstruction.
* **Ring retention** — segments roll at a byte/age bound and the
  oldest closed segments are deleted once the directory exceeds the
  byte or age budget: disk use is bounded no matter how long the
  service runs.
* **Crash safety** — the same torn-tail discipline as the training
  summaries' ``_ScalarWriter``: reopening seals a torn final line
  onto its own line, and readers skip unparseable lines instead of
  failing, so a SIGKILL mid-append costs at most one sample.
* **Histograms are flattened at scrape time** into counter series
  (``<name>_count``, ``<name>_sum``, ``<name>_bucket{le=...}``) and
  quantile gauges (``<name>_p50/p95/p99``) — the bucket counters are
  exactly what the burn-rate math needs for latency objectives.

CONTRACT: stdlib-only at module level (no torch, no numpy; the
``aggregator.py``/``reqtrace.py`` contract), so the store is read on a
host with no accelerator stack.
"""

from __future__ import annotations

import json
import os
import random
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

__all__ = [
    "TSDB_SCHEMA",
    "TSDB_DIRNAME",
    "SeriesStore",
    "TsdbSampler",
    "TsdbWriter",
    "flatten_snapshot",
    "flush_active_tsdb",
    "get_active_tsdb",
    "init_tsdb",
    "parse_series_key",
    "read_samples",
    "reset_tsdb",
    "series_matches",
]

TSDB_SCHEMA = 1
TSDB_DIRNAME = "tsdb"
_SEGMENT_PREFIX = "seg-"


# ---------------------------------------------------------------- keys
def parse_series_key(key: str) -> Tuple[str, Dict[str, str]]:
    """``name{a="x",b="y"}`` -> (name, {a: x, b: y}).

    Local twin of ``aggregator.parse_series_key`` so this module stays
    standalone-loadable; the formats are identical by construction
    (both parse what ``metrics._format_labels`` emits)."""
    if "{" not in key:
        return key, {}
    name, _, rest = key.partition("{")
    labels: Dict[str, str] = {}
    for part in rest.rstrip("}").split(","):
        if not part:
            continue
        k, _, v = part.partition("=")
        labels[k.strip()] = v.strip().strip('"')
    return name, labels


def format_series_key(name: str, labels: Dict[str, str]) -> str:
    if not labels:
        return name
    inner = ",".join(f'{k}="{labels[k]}"' for k in sorted(labels))
    return f"{name}{{{inner}}}"


def series_matches(selector: str, key: str) -> bool:
    """A selector matches a series when the names are equal and every
    selector label is present with the same value (extra series labels
    are fine — that is what lets one ``serving_errors_total`` selector
    cover per-endpoint children).  ``""``/``"*"`` match everything."""
    if selector in ("", "*", None):
        return True
    sname, slabels = parse_series_key(selector)
    kname, klabels = parse_series_key(key)
    if sname != kname:
        return False
    return all(klabels.get(k) == v for k, v in slabels.items())


# ------------------------------------------------------------- flatten
def flatten_snapshot(snap: Dict[str, Any]) -> Tuple[Dict[str, float],
                                                    Dict[str, float]]:
    """Registry ``snapshot()`` -> (counter series, gauge series).

    Histogram families become the Prometheus-shaped counter triplet
    (``_count``, ``_sum``, per-bucket cumulative ``_bucket{le=...}``
    with the implicit ``+Inf`` bucket) plus quantile gauges."""
    counters: Dict[str, float] = {}
    gauges: Dict[str, float] = {}
    for key, val in (snap.get("counters") or {}).items():
        counters[key] = float(val)
    for key, val in (snap.get("gauges") or {}).items():
        gauges[key] = float(val)
    for key, h in (snap.get("histograms") or {}).items():
        name, labels = parse_series_key(key)
        counters[format_series_key(name + "_count", labels)] = float(
            h.get("count", 0))
        counters[format_series_key(name + "_sum", labels)] = float(
            h.get("sum", 0.0))
        les = h.get("le") or []
        cum = h.get("cum") or []
        for le, c in zip(les, cum):
            blabels = dict(labels)
            blabels["le"] = f"{float(le):g}"
            counters[format_series_key(name + "_bucket",
                                       blabels)] = float(c)
        blabels = dict(labels)
        blabels["le"] = "+Inf"
        counters[format_series_key(name + "_bucket", blabels)] = float(
            h.get("count", 0))
        for q in ("p50", "p95", "p99"):
            if h.get(q) is not None:
                gauges[format_series_key(f"{name}_{q}",
                                         labels)] = float(h[q])
    return counters, gauges


# -------------------------------------------------------------- writer
class TsdbWriter:
    """Appends scrape samples to ring-retained segment files.

    One writer owns one directory (conventionally
    ``<run_dir>/host-<k>/tsdb``).  Thread-safe: the sampler thread and
    a flush call may append concurrently."""

    def __init__(self, directory: str, *,
                 retention_bytes: int = 64 * 1024 * 1024,
                 retention_age_s: float = 86400.0,
                 segment_max_bytes: int = 256 * 1024,
                 segment_max_age_s: float = 600.0,
                 recent_samples: int = 4096,
                 clock: Callable[[], float] = time.time):
        self.dir = directory
        self.retention_bytes = int(retention_bytes)
        self.retention_age_s = float(retention_age_s)
        self.segment_max_bytes = int(segment_max_bytes)
        self.segment_max_age_s = float(segment_max_age_s)
        self._clock = clock
        self._lock = threading.Lock()
        self._f = None
        self._seg_path: Optional[str] = None
        self._seg_created = 0.0
        self._seg_seq = 0
        self._last_counters: Optional[Dict[str, float]] = None
        self._last_t: Optional[float] = None
        self.segments_deleted = 0
        # the live ring /tsdb.json serves from (absolute counters)
        self._recent: deque = deque(maxlen=int(recent_samples))
        os.makedirs(self.dir, exist_ok=True)

    # -- segment lifecycle -------------------------------------------
    def _open_segment(self, now: float) -> None:
        self._seg_seq += 1
        name = f"{_SEGMENT_PREFIX}{int(now * 1000):013d}-{self._seg_seq:04d}.jsonl"
        self._seg_path = os.path.join(self.dir, name)
        self._f = open(self._seg_path, "a")
        self._seal_torn_line()
        header = {"tsdb_schema": TSDB_SCHEMA, "created": now}
        self._f.write(json.dumps(header) + "\n")
        self._f.flush()
        self._seg_created = now
        # a fresh segment must be self-describing: next sample is full
        self._last_counters = None

    def _seal_torn_line(self) -> None:
        """Same discipline as ``_ScalarWriter``: a crash mid-write can
        leave a torn final line; start appends on a fresh line so the
        torn record corrupts only itself."""
        try:
            if self._f is not None and self._f.tell() > 0:
                with open(self._seg_path, "rb") as rf:
                    rf.seek(-1, os.SEEK_END)
                    if rf.read(1) != b"\n":
                        self._f.write("\n")
                        self._f.flush()
        except OSError:
            pass

    def _segments(self) -> List[str]:
        try:
            names = [n for n in os.listdir(self.dir)
                     if n.startswith(_SEGMENT_PREFIX)
                     and n.endswith(".jsonl")]
        except OSError:
            return []
        return sorted(os.path.join(self.dir, n) for n in names)

    def _roll_if_needed(self, now: float) -> None:
        if self._f is None:
            self._open_segment(now)
            return
        size = 0
        try:
            size = self._f.tell()
        except (OSError, ValueError):
            pass
        if (size >= self.segment_max_bytes
                or now - self._seg_created >= self.segment_max_age_s):
            self._f.close()
            self._open_segment(now)

    def _enforce_retention(self, now: float) -> None:
        segs = self._segments()
        sizes = {}
        for p in segs:
            try:
                sizes[p] = os.path.getsize(p)
            except OSError:
                sizes[p] = 0
        total = sum(sizes.values())
        for p in list(segs):
            if p == self._seg_path:
                break           # never delete the active segment
            age = now - self._segment_created_time(p)
            if total > self.retention_bytes or age > self.retention_age_s:
                try:
                    os.remove(p)
                    self.segments_deleted += 1
                    total -= sizes[p]
                except OSError:
                    pass
            else:
                break           # segments are time-ordered: done

    @staticmethod
    def _segment_created_time(path: str) -> float:
        base = os.path.basename(path)[len(_SEGMENT_PREFIX):]
        try:
            return int(base.split("-", 1)[0]) / 1000.0
        except ValueError:
            return 0.0

    # -- appends ------------------------------------------------------
    def append(self, snapshot: Dict[str, Any],
               now: Optional[float] = None) -> None:
        """Record one registry snapshot as a sample."""
        now = self._clock() if now is None else float(now)
        counters, gauges = flatten_snapshot(snapshot)
        with self._lock:
            self._roll_if_needed(now)
            full = self._last_counters is None
            if not full:
                # a reset (registry restart) would need a negative
                # delta — switch to a full sample instead so absolute
                # reconstruction never goes negative
                for key, val in counters.items():
                    if val < self._last_counters.get(key, 0.0):
                        full = True
                        break
            if full:
                rec = {"t": now, "full": True, "c": counters,
                       "g": gauges}
            else:
                deltas = {}
                for key, val in counters.items():
                    prev = self._last_counters.get(key, 0.0)
                    if val != prev:
                        deltas[key] = round(val - prev, 9)
                rec = {"t": now, "c": deltas, "g": gauges}
            self._f.write(json.dumps(rec, sort_keys=True) + "\n")
            self._f.flush()
            self._last_counters = dict(counters)
            self._last_t = now
            self._recent.append({"t": now, "counters": dict(counters),
                                 "gauges": dict(gauges)})
            self._enforce_retention(now)

    # -- reads --------------------------------------------------------
    def recent_samples(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._recent)

    def total_bytes(self) -> int:
        total = 0
        for p in self._segments():
            try:
                total += os.path.getsize(p)
            except OSError:
                pass
        return total

    def close(self) -> None:
        with self._lock:
            if self._f is not None:
                self._f.close()
                self._f = None


# -------------------------------------------------------------- reader
def _iter_segment_samples(path: str) -> Iterable[Dict[str, Any]]:
    """Yield absolute-counter samples from one segment; a torn or
    corrupt line is skipped (costs one sample, never the segment)."""
    abs_counters: Dict[str, float] = {}
    have_base = False
    try:
        f = open(path)
    except OSError:
        return
    with f:
        for line in f:
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                continue
            if "tsdb_schema" in rec:
                continue
            if "t" not in rec:
                continue
            if rec.get("full"):
                abs_counters = {k: float(v)
                                for k, v in (rec.get("c") or {}).items()}
                have_base = True
            elif have_base:
                for k, d in (rec.get("c") or {}).items():
                    abs_counters[k] = abs_counters.get(k, 0.0) + float(d)
            else:
                # segment lost its full base (torn header region):
                # deltas alone cannot reconstruct — skip until a full
                continue
            yield {"t": float(rec["t"]),
                   "counters": dict(abs_counters),
                   "gauges": {k: float(v)
                              for k, v in (rec.get("g") or {}).items()}}


def read_samples(directory: str) -> List[Dict[str, Any]]:
    """All samples of one tsdb directory (or a ``host-<k>`` slot, or a
    run dir containing ``host-*/tsdb``), time-ordered."""
    roots = []
    if os.path.isdir(os.path.join(directory, TSDB_DIRNAME)):
        roots.append(os.path.join(directory, TSDB_DIRNAME))
    elif os.path.isdir(directory):
        names = sorted(os.listdir(directory))
        host_roots = [os.path.join(directory, n, TSDB_DIRNAME)
                      for n in names if n.startswith("host-")]
        host_roots = [r for r in host_roots if os.path.isdir(r)]
        roots.extend(host_roots if host_roots else [directory])
    out: List[Dict[str, Any]] = []
    for root_i, root in enumerate(roots):
        stream = f"s{root_i}"
        try:
            segs = sorted(n for n in os.listdir(root)
                          if n.startswith(_SEGMENT_PREFIX))
        except OSError:
            continue
        for seg in segs:
            for sample in _iter_segment_samples(os.path.join(root, seg)):
                sample["stream"] = stream
                out.append(sample)
    out.sort(key=lambda s: s["t"])
    return out


class SeriesStore:
    """Query layer over a list of samples — the duck the SLO engine
    and the drift watch consume.

    Counters from different streams (hosts) are kept separate
    internally so one host's restart never looks like a cluster-wide
    reset; ``increase()`` sums reset-aware per-stream increases."""

    def __init__(self, samples: List[Dict[str, Any]]):
        self.samples = sorted(samples, key=lambda s: s["t"])
        # (stream, key) -> [(t, absolute value)]
        self._counter_series: Dict[Tuple[str, str],
                                   List[Tuple[float, float]]] = {}
        self._gauge_series: Dict[Tuple[str, str],
                                 List[Tuple[float, float]]] = {}
        for s in self.samples:
            stream = s.get("stream", "s0")
            t = s["t"]
            for key, v in (s.get("counters") or {}).items():
                self._counter_series.setdefault((stream, key),
                                                []).append((t, v))
            for key, v in (s.get("gauges") or {}).items():
                self._gauge_series.setdefault((stream, key),
                                              []).append((t, v))

    @classmethod
    def from_run_dir(cls, run_dir: str) -> "SeriesStore":
        return cls(read_samples(run_dir))

    @classmethod
    def from_writer(cls, writer: TsdbWriter) -> "SeriesStore":
        return cls(writer.recent_samples())

    def time_range(self) -> Tuple[Optional[float], Optional[float]]:
        if not self.samples:
            return None, None
        return self.samples[0]["t"], self.samples[-1]["t"]

    def counter_keys(self, selector: str) -> List[str]:
        return sorted({key for (_s, key) in self._counter_series
                       if series_matches(selector, key)})

    def gauge_keys(self, selector: str) -> List[str]:
        return sorted({key for (_s, key) in self._gauge_series
                       if series_matches(selector, key)})

    def increase(self, selector: str, t0: float, t1: float) -> float:
        """Total counter increase over ``(t0, t1]`` across every
        matching series, reset-aware: positive jumps count as deltas,
        and a counter reset (absolute value drops below the previous
        sample — a process restart) contributes its post-restart
        absolute value, Prometheus ``increase`` style, instead of a
        bogus negative — budget accounting survives sampler gaps and
        restarts."""
        total = 0.0
        for (_stream, key), pts in self._counter_series.items():
            if not series_matches(selector, key):
                continue
            prev = None
            for t, v in pts:
                if t > t1:
                    break
                if t <= t0:
                    prev = v
                    continue
                if prev is not None and v > prev:
                    total += v - prev
                elif prev is not None and v < prev:
                    # counter reset: the fresh stream grew 0 -> v
                    total += v
                elif prev is None:
                    # first point inside the window of a stream that
                    # has no pre-window baseline: the segment's full
                    # base covers growth before the window; count
                    # nothing until the next point
                    pass
                prev = v
        return total

    def gauge_points(self, selector: str,
                     t0: Optional[float] = None,
                     t1: Optional[float] = None
                     ) -> Dict[str, List[Tuple[float, float]]]:
        out: Dict[str, List[Tuple[float, float]]] = {}
        for (_stream, key), pts in self._gauge_series.items():
            if not series_matches(selector, key):
                continue
            sel = [(t, v) for t, v in pts
                   if (t0 is None or t >= t0)
                   and (t1 is None or t <= t1)]
            if sel:
                out.setdefault(key, []).extend(sel)
        for key in out:
            out[key].sort()
        return out

    def query(self, selector: str,
              t0: Optional[float] = None,
              t1: Optional[float] = None) -> Dict[str, List[Tuple[float, float]]]:
        """Raw points (counters absolute + gauges) for a selector —
        the ``/tsdb.json`` answer shape."""
        out = self.gauge_points(selector, t0, t1)
        for (_stream, key), pts in self._counter_series.items():
            if not series_matches(selector, key):
                continue
            sel = [(t, v) for t, v in pts
                   if (t0 is None or t >= t0)
                   and (t1 is None or t <= t1)]
            if sel:
                out.setdefault(key, []).extend(sel)
        for key in out:
            out[key].sort()
        return out


# ------------------------------------------------------------- sampler
class TsdbSampler:
    """Background scraper: registry ``snapshot()`` -> writer, on a
    jittered interval (±``jitter`` fraction, so a fleet of replicas
    never thunders in phase), plus on-demand ``sample_once`` calls
    from ``flush_worker_observability``.

    Scrape cost is measured per sample and kept in a bounded ring —
    ``overhead_p50()`` feeds the bench satellite's
    ``tsdb_sampler_p50_overhead_fraction`` self-gate."""

    def __init__(self, writer: TsdbWriter, *,
                 interval_s: float = 10.0,
                 jitter: float = 0.2,
                 registry: Any = None,
                 clock: Callable[[], float] = time.time,
                 perf: Callable[[], float] = time.perf_counter):
        self.writer = writer
        self.interval_s = float(interval_s)
        self.jitter = float(jitter)
        self._clock = clock
        self._perf = perf
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # appends land on the sampler thread while overhead_p50 sorts
        # on the caller's thread — deque append is atomic, but
        # iterating (sorted/list) during a concurrent append raises
        # RuntimeError, so both sides take this lock
        self._cost_lock = threading.Lock()
        self._scrape_costs: deque = deque(maxlen=512)
        self.samples_total = 0
        if registry is None:
            try:
                from analytics_zoo_torch.observability.metrics import \
                    get_registry
                registry = get_registry()
            except ImportError:      # standalone use, no registry
                registry = None
        self.registry = registry
        self._samples_counter = None
        self._scrape_gauge = None
        self._bytes_gauge = None
        if registry is not None:
            self._samples_counter = registry.counter(
                "tsdb_samples_total", "tsdb scrape samples appended")
            self._scrape_gauge = registry.gauge(
                "tsdb_last_scrape_seconds",
                "wall seconds the last tsdb scrape cost")
            self._bytes_gauge = registry.gauge(
                "tsdb_store_bytes", "bytes the tsdb segments occupy")

    def sample_once(self, now: Optional[float] = None) -> float:
        """One scrape+append; returns its cost in seconds."""
        if self.registry is None:
            return 0.0
        t0 = self._perf()
        snap = self.registry.snapshot()
        self.writer.append(snap, now=now)
        cost = self._perf() - t0
        with self._cost_lock:
            self._scrape_costs.append(cost)
        self.samples_total += 1
        if self._samples_counter is not None:
            self._samples_counter.inc()
            self._scrape_gauge.set(cost)
            self._bytes_gauge.set(self.writer.total_bytes())
        return cost

    def overhead_p50(self) -> float:
        with self._cost_lock:
            costs = sorted(self._scrape_costs)
        if not costs:
            return 0.0
        return costs[len(costs) // 2]

    def _loop(self) -> None:
        while not self._stop.is_set():
            lo, hi = 1.0 - self.jitter, 1.0 + self.jitter
            wait = self.interval_s * random.uniform(lo, hi)
            if self._stop.wait(max(0.01, wait)):
                break
            try:
                self.sample_once()
            except Exception:    # a scrape must never kill telemetry
                pass

    def start(self) -> "TsdbSampler":
        if self._thread is None or not self._thread.is_alive():
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._loop, name="tsdb-sampler", daemon=True)
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None


# ----------------------------------------------------- process wiring
_active_lock = threading.Lock()
_active_writer: Optional[TsdbWriter] = None
_active_sampler: Optional[TsdbSampler] = None


def init_tsdb(directory: str, *, interval_s: float = 10.0,
              retention_bytes: int = 64 * 1024 * 1024,
              retention_age_s: float = 86400.0,
              registry: Any = None,
              start_sampler: bool = True) -> TsdbWriter:
    """Install the process-wide writer+sampler (idempotent per dir) —
    called by ``init_worker_observability`` for the worker's run-dir
    slot; the exporter's ``/tsdb.json`` serves the writer's ring."""
    global _active_writer, _active_sampler
    with _active_lock:
        if _active_writer is not None and _active_writer.dir == directory:
            return _active_writer
        if _active_sampler is not None:
            _active_sampler.stop()
        if _active_writer is not None:
            _active_writer.close()
        _active_writer = TsdbWriter(
            directory, retention_bytes=retention_bytes,
            retention_age_s=retention_age_s)
        _active_sampler = TsdbSampler(
            _active_writer, interval_s=interval_s, registry=registry)
        if start_sampler:
            _active_sampler.start()
        return _active_writer


def get_active_tsdb() -> Optional[TsdbWriter]:
    with _active_lock:
        return _active_writer


def get_active_sampler() -> Optional[TsdbSampler]:
    with _active_lock:
        return _active_sampler


def flush_active_tsdb() -> None:
    """One synchronous scrape — the ``flush_worker_observability``
    hook, so every flushed run dir ends on a fresh sample."""
    with _active_lock:
        sampler = _active_sampler
    if sampler is not None:
        try:
            sampler.sample_once()
        except Exception:
            pass


def reset_tsdb() -> None:
    global _active_writer, _active_sampler
    with _active_lock:
        if _active_sampler is not None:
            _active_sampler.stop()
            _active_sampler = None
        if _active_writer is not None:
            _active_writer.close()
            _active_writer = None
