"""Process-wide metrics registry: Counter / Gauge / Histogram with
labels, Prometheus text exposition, and JSONL snapshots.

Reference posture: BigDL's Spark job printed a per-interval phase table
(the Metrics breakdown) and pushed Train/Validation scalars to
TensorBoard; operability lived in logs.  Here every subsystem shares
ONE registry so a single scrape (``/metrics``) or snapshot shows the
whole pipeline — training step latency, serving request latency, HBM
in use — in one place.

Dependency-free by design (no prometheus_client): the exposition
format is a few lines of text framing, and serving must not grow a
client-library dependency the container may not have.

Thread-safety: every mutation takes the owning metric's lock.  The
hot-path cost is one lock + float add, far below the dispatch cost of
any step it instruments.
"""

from __future__ import annotations

import bisect
import json
import logging
import threading
import time
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

log = logging.getLogger("analytics_zoo_torch.observability")

# Per-metric label-cardinality ceiling: a per-request or per-host label
# exploding into unbounded series is the classic way an exporter OOMs.
# Children past the cap still accept writes (callers never break) but
# are not stored/exported; zoo_metrics_dropped_series_total{metric}
# counts them.  Overridable per registry or via
# observability.max_series_per_metric.
DEFAULT_MAX_SERIES = 1000

# Prometheus' default bucket ladder, widened down to 100us: TPU predict
# steps on a warm executable can sit well under 5ms.
DEFAULT_BUCKETS: Tuple[float, ...] = (
    .0001, .00025, .0005, .001, .0025, .005, .01, .025, .05, .1, .25,
    .5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0)

# Ladder for epoch/long-job durations (sub-second to an hour) — shared
# by every train_epoch_seconds registration site.
EPOCH_BUCKETS: Tuple[float, ...] = (
    .1, .25, .5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0, 300.0, 600.0,
    1800.0, 3600.0)


def _escape_label_value(v: str) -> str:
    return (str(v).replace("\\", r"\\").replace("\n", r"\n")
            .replace('"', r'\"'))


def _format_labels(names: Sequence[str], values: Sequence[str],
                   extra: Optional[Tuple[str, str]] = None,
                   const: Sequence[Tuple[str, str]] = ()) -> str:
    pairs = [f'{n}="{_escape_label_value(v)}"'
             for n, v in list(const) + list(zip(names, values))]
    if extra is not None:
        pairs.append(f'{extra[0]}="{extra[1]}"')
    return "{" + ",".join(pairs) + "}" if pairs else ""


def _format_value(v: float) -> str:
    if v == float("inf"):
        return "+Inf"
    if v == float("-inf"):
        return "-Inf"
    # integers print bare (Prometheus accepts either; bare reads better)
    if float(v).is_integer() and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


def _exemplar_suffix(ex: Optional[Tuple[str, float, float]]) -> str:
    """OpenMetrics exemplar clause appended to a bucket/counter line:
    ``# {trace_id="..."} <value> <unix ts>``."""
    if not ex:
        return ""
    tid, v, ts = ex
    return (f' # {{trace_id="{_escape_label_value(tid)}"}} '
            f"{_format_value(v)} {ts:.3f}")


class _Child:
    """One labeled time series of a metric family."""

    __slots__ = ("_lock",)

    def __init__(self):
        self._lock = threading.Lock()


class _CounterChild(_Child):
    __slots__ = ("value", "exemplar")

    def __init__(self):
        super().__init__()
        self.value = 0.0
        # last exemplar: (trace_id, observed increment, unix ts) — the
        # OpenMetrics bridge from a counter series to one inspectable
        # request timeline (reqtrace.py)
        self.exemplar: Optional[Tuple[str, float, float]] = None

    def inc(self, amount: float = 1.0,
            exemplar: Optional[str] = None) -> None:
        if amount < 0:
            raise ValueError("counters can only increase")
        with self._lock:
            self.value += amount
            if exemplar:
                self.exemplar = (str(exemplar), float(amount),
                                 time.time())


class _GaugeChild(_Child):
    __slots__ = ("value",)

    def __init__(self):
        super().__init__()
        self.value = 0.0

    def set(self, value: float) -> None:
        with self._lock:
            self.value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self.value += amount

    def dec(self, amount: float = 1.0) -> None:
        self.inc(-amount)


class _HistogramChild(_Child):
    __slots__ = ("buckets", "counts", "sum", "count", "exemplars")

    def __init__(self, buckets: Tuple[float, ...]):
        super().__init__()
        self.buckets = buckets
        self.counts = [0] * len(buckets)   # per-bucket (non-cumulative)
        self.sum = 0.0
        self.count = 0
        # per-bucket last exemplar (index len(buckets) = +Inf):
        # (trace_id, observed value, unix ts) — so a p99 bucket links
        # directly to one inspectable request timeline (reqtrace.py)
        self.exemplars: List[Optional[Tuple[str, float, float]]] = \
            [None] * (len(buckets) + 1)

    def observe(self, value: float,
                exemplar: Optional[str] = None) -> None:
        v = float(value)
        i = bisect.bisect_left(self.buckets, v)
        with self._lock:
            if i < len(self.counts):
                self.counts[i] += 1
            self.sum += v
            self.count += 1
            if exemplar:
                self.exemplars[i] = (str(exemplar), v, time.time())

    def cumulative(self) -> List[int]:
        out, acc = [], 0
        with self._lock:
            for c in self.counts:
                acc += c
                out.append(acc)
        return out

    def percentile(self, p: float) -> float:
        """Approximate percentile from bucket upper bounds (the bound
        of the first cumulative bucket covering p of the count)."""
        with self._lock:
            total = self.count
            counts = list(self.counts)
        if total == 0:
            return 0.0
        target = p / 100.0 * total
        acc = 0
        for bound, c in zip(self.buckets, counts):
            acc += c
            if acc >= target:
                return bound
        return self.buckets[-1] if self.buckets else 0.0


_KIND_CHILD = {"counter": _CounterChild, "gauge": _GaugeChild}


class _Family:
    """A named metric with a fixed label-name schema and one child per
    label-value combination."""

    def __init__(self, name: str, help: str, kind: str,
                 label_names: Tuple[str, ...],
                 buckets: Tuple[float, ...] = DEFAULT_BUCKETS,
                 max_series: int = DEFAULT_MAX_SERIES,
                 on_drop=None):
        self.name = name
        self.help = help
        self.kind = kind
        self.label_names = label_names
        self.buckets = tuple(sorted(buckets))
        self.max_series = int(max_series)
        self._on_drop = on_drop      # registry callback, called unlocked
        self._overflow_child: Optional[_Child] = None
        self._drop_warned = False
        # label combos already counted as dropped: the counter tracks
        # COMBINATIONS (what the help text promises), not writes, and
        # repeat writes to a dropped combo skip the lock/callback.
        # Bounded so a truly unbounded label can't grow this set either
        self._dropped_keys: set = set()
        self._max_dropped_keys = max(10 * self.max_series, 10_000)
        self._dropped_saturated = False
        self._children: Dict[Tuple[str, ...], _Child] = {}
        self._lock = threading.Lock()
        if not label_names:
            # label-free series exist at zero from registration, so a
            # scrape before the first sample still shows them (rate()/
            # absent() alerting needs the series present) — matching
            # prometheus_client; labeled children appear on first use
            self.labels()

    def labels(self, *values, **kw):
        if kw:
            values = tuple(str(kw[n]) for n in self.label_names)
        else:
            values = tuple(str(v) for v in values)
        if len(values) != len(self.label_names):
            raise ValueError(
                f"{self.name}: expected labels {self.label_names}, "
                f"got {values}")
        child = self._children.get(values)
        if child is None:
            # known-dropped combo: skip the lock and the drop
            # accounting entirely (hot-path writes to a capped series
            # must stay one set lookup, and the drop counter tracks
            # combinations, not writes).  Once the memo itself
            # saturates (a label so unbounded even 10x the cap of
            # combos flowed past), EVERY unknown combo short-circuits:
            # the counter undercounts beyond the memo bound rather
            # than reverting to per-write lock traffic — the loud
            # warning and >=bound counter value are signal enough
            if self._overflow_child is not None and (
                    self._dropped_saturated
                    or values in self._dropped_keys):
                return self._overflow_child
            dropped = False
            with self._lock:
                child = self._children.get(values)
                if child is None:
                    if (self.max_series > 0
                            and len(self._children) >= self.max_series):
                        # cardinality cap: hand back a detached child —
                        # the caller's inc/observe still work, but the
                        # series is never stored or exported, so the
                        # exporter's memory stays bounded
                        if self._overflow_child is None:
                            self._overflow_child = self._new_child()
                        child = self._overflow_child
                        dropped = values not in self._dropped_keys
                        if dropped:
                            if len(self._dropped_keys) < \
                                    self._max_dropped_keys:
                                self._dropped_keys.add(values)
                            else:
                                # zoolint: disable=ATOM017 — deliberate saturating memo (see labels() docstring above): the unlocked fast-path guard may admit a few extra writers, each of which sets the same monotonic True under _lock
                                self._dropped_saturated = True
                    else:
                        child = self._children.setdefault(
                            values, self._new_child())
            if dropped:
                if not self._drop_warned:
                    self._drop_warned = True
                    log.warning(
                        "metric %r exceeded its %d-series label-"
                        "cardinality cap; further label combinations "
                        "are accepted but NOT exported (counted in "
                        "zoo_metrics_dropped_series_total) — an "
                        "unbounded label (request id? per-host key?) "
                        "is leaking into this metric",
                        self.name, self.max_series)
                if self._on_drop is not None:
                    try:
                        self._on_drop(self.name)
                    except Exception:  # accounting must never raise
                        pass
        return child

    def _new_child(self) -> _Child:
        return (_HistogramChild(self.buckets)
                if self.kind == "histogram"
                else _KIND_CHILD[self.kind]())

    def _default(self):
        """The unlabeled child (only valid for label-free families)."""
        return self.labels()

    # convenience passthroughs so label-free metrics read naturally
    # (the exemplar kw is forwarded only when given: gauges don't
    # take one, and a bare inc() must keep working on every kind)
    def inc(self, amount: float = 1.0,
            exemplar: Optional[str] = None) -> None:
        if exemplar is not None:
            self._default().inc(amount, exemplar=exemplar)
        else:
            self._default().inc(amount)

    def dec(self, amount: float = 1.0) -> None:
        self._default().dec(amount)

    def set(self, value: float) -> None:
        self._default().set(value)

    def observe(self, value: float,
                exemplar: Optional[str] = None) -> None:
        self._default().observe(value, exemplar=exemplar)

    @property
    def value(self):
        return self._default().value

    def items(self) -> List[Tuple[Tuple[str, ...], _Child]]:
        with self._lock:
            return list(self._children.items())


class MetricsRegistry:
    """Ordered collection of metric families with exposition/snapshot.

    ``counter``/``gauge``/``histogram`` are get-or-create: calling
    twice with the same name returns the same family (kind and label
    schema must match), so instrumentation sites never need to
    coordinate registration order.
    """

    def __init__(self, max_series_per_metric: Optional[int] = None):
        self._families: Dict[str, _Family] = {}
        self._lock = threading.Lock()
        # constant labels stamped on every exported series (host /
        # process_index identity in multi-host runs); immutable once set
        self._const_labels: Dict[str, str] = {}
        if max_series_per_metric is None:
            try:
                from analytics_zoo_torch.common.config import get_config
                max_series_per_metric = int(get_config().get(
                    "observability.max_series_per_metric",
                    DEFAULT_MAX_SERIES))
            except Exception:
                max_series_per_metric = DEFAULT_MAX_SERIES
        self.max_series_per_metric = int(max_series_per_metric)

    # ---------------------------------------------------- const labels
    def set_const_labels(self, **labels) -> None:
        """Stamp identity labels (e.g. ``host``/``process_index``) onto
        every series this registry exports.  IMMUTABLE: re-setting a
        label to a different value raises — a worker's identity must
        not drift mid-run (the aggregator keys on it)."""
        clean = {str(k): str(v) for k, v in labels.items()}
        with self._lock:
            for k, v in clean.items():
                old = self._const_labels.get(k)
                if old is not None and old != v:
                    raise ValueError(
                        f"const label {k!r} already set to {old!r}; "
                        f"refusing to change it to {v!r} (worker "
                        "identity labels are immutable)")
            self._const_labels.update(clean)

    @property
    def const_labels(self) -> Dict[str, str]:
        with self._lock:
            return dict(self._const_labels)

    def _record_dropped_series(self, metric_name: str) -> None:
        # called from a family with NO lock held (see _Family.labels)
        self.counter(
            "zoo_metrics_dropped_series_total",
            "label-value combinations dropped by the per-metric "
            "cardinality cap (observability.max_series_per_metric)",
            labels=("metric",)).labels(metric_name).inc()

    def _get_or_create(self, name: str, help: str, kind: str,
                       label_names: Iterable[str],
                       buckets: Tuple[float, ...] = DEFAULT_BUCKETS
                       ) -> _Family:
        label_names = tuple(label_names)
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                fam = _Family(name, help, kind, label_names, buckets,
                              max_series=self.max_series_per_metric,
                              on_drop=self._record_dropped_series)
                self._families[name] = fam
                return fam
        if fam.kind != kind or fam.label_names != label_names:
            raise ValueError(
                f"metric {name!r} re-registered as {kind}"
                f"{label_names}, existing is {fam.kind}"
                f"{fam.label_names}")
        if kind == "histogram" and fam.buckets != tuple(sorted(buckets)):
            # a silently-discarded bucket ladder would misreport every
            # later observation — fail as loudly as a kind mismatch
            raise ValueError(
                f"histogram {name!r} re-registered with buckets "
                f"{tuple(sorted(buckets))}, existing has {fam.buckets}")
        return fam

    def counter(self, name: str, help: str = "",
                labels: Iterable[str] = ()) -> _Family:
        return self._get_or_create(name, help, "counter", labels)

    def gauge(self, name: str, help: str = "",
              labels: Iterable[str] = ()) -> _Family:
        return self._get_or_create(name, help, "gauge", labels)

    def histogram(self, name: str, help: str = "",
                  labels: Iterable[str] = (),
                  buckets: Tuple[float, ...] = DEFAULT_BUCKETS
                  ) -> _Family:
        return self._get_or_create(name, help, "histogram", labels,
                                   buckets)

    # -------------------------------------------------------- exposition
    def prometheus_text(self, exemplars: bool = False) -> str:
        """Prometheus text exposition format 0.0.4.

        ``exemplars=True`` appends OpenMetrics-style exemplar clauses
        (``# {trace_id="..."} value ts``) to histogram bucket and
        counter lines that have one.  Off by default: the plain
        ``/metrics`` route keeps serving strict 0.0.4 (some scrapers
        reject the clause); the exporter serves the exemplar rendering
        under ``/metrics?exemplars=1``."""
        lines: List[str] = []
        with self._lock:
            families = sorted(self._families.values(),
                              key=lambda f: f.name)
            const = tuple(sorted(self._const_labels.items()))
        for fam in families:
            items = fam.items()
            if not items:
                continue
            # a family whose own schema names a const label (e.g. a
            # "host" label on a metric in a host-labelled registry)
            # wins: emitting both would be duplicate-label exposition,
            # which Prometheus rejects for the WHOLE scrape
            fconst = tuple((k, v) for k, v in const
                           if k not in fam.label_names)
            if fam.help:
                lines.append(f"# HELP {fam.name} {fam.help}")
            lines.append(f"# TYPE {fam.name} {fam.kind}")
            for values, child in sorted(items):
                if fam.kind == "histogram":
                    cum = child.cumulative()
                    for i, (bound, c) in enumerate(
                            zip(fam.buckets, cum)):
                        lab = _format_labels(
                            fam.label_names, values,
                            ("le", _format_value(bound)), const=fconst)
                        line = f"{fam.name}_bucket{lab} {c}"
                        if exemplars:
                            line += _exemplar_suffix(
                                child.exemplars[i])
                        lines.append(line)
                    lab = _format_labels(fam.label_names, values,
                                         ("le", "+Inf"), const=fconst)
                    line = f"{fam.name}_bucket{lab} {child.count}"
                    if exemplars:
                        line += _exemplar_suffix(
                            child.exemplars[len(fam.buckets)])
                    lines.append(line)
                    plain = _format_labels(fam.label_names, values,
                                           const=fconst)
                    lines.append(f"{fam.name}_sum{plain} "
                                 f"{_format_value(child.sum)}")
                    lines.append(f"{fam.name}_count{plain} "
                                 f"{child.count}")
                else:
                    lab = _format_labels(fam.label_names, values,
                                         const=fconst)
                    line = (f"{fam.name}{lab} "
                            f"{_format_value(child.value)}")
                    if exemplars and fam.kind == "counter":
                        line += _exemplar_suffix(
                            getattr(child, "exemplar", None))
                    lines.append(line)
        return "\n".join(lines) + "\n"

    # ---------------------------------------------------------- snapshot
    def snapshot(self) -> Dict:
        """JSON-friendly snapshot: counters/gauges as values, histograms
        as count/sum/percentile summaries (compact enough to embed in a
        bench artifact) plus their cumulative bucket counts (so the
        cluster aggregator can merge distributions exactly, not just
        count-weight the percentiles).  When const labels are set the
        snapshot carries them under a top-level ``"labels"`` key — keys
        inside the sections stay unprefixed, so single-process
        consumers are unaffected."""
        out: Dict[str, Dict] = {"counters": {}, "gauges": {},
                                "histograms": {}}
        with self._lock:
            families = list(self._families.values())
            const = dict(self._const_labels)
        if const:
            out["labels"] = const
        for fam in families:
            for values, child in fam.items():
                key = fam.name
                if values:
                    key += _format_labels(fam.label_names, values)
                if fam.kind == "counter":
                    out["counters"][key] = child.value
                elif fam.kind == "gauge":
                    out["gauges"][key] = child.value
                else:
                    entry = {
                        "count": child.count,
                        "sum": round(child.sum, 6),
                        "p50": child.percentile(50),
                        "p95": child.percentile(95),
                        "p99": child.percentile(99),
                        # finite upper bounds + cumulative counts; the
                        # +Inf bucket is implicit ("count")
                        "le": list(fam.buckets),
                        "cum": child.cumulative(),
                    }
                    exs = {}
                    for i, ex in enumerate(child.exemplars):
                        if ex is None:
                            continue
                        bound = (_format_value(fam.buckets[i])
                                 if i < len(fam.buckets) else "+Inf")
                        exs[bound] = {"trace_id": ex[0],
                                      "value": ex[1]}
                    if exs:
                        entry["exemplars"] = exs
                    out["histograms"][key] = entry
        return out

    def write_jsonl(self, path: str) -> None:
        """Append one timestamped snapshot line (crash-safe scrape log,
        same shape as utils/summary.py's JSONL scalars)."""
        rec = {"wall_time": time.time(), "metrics": self.snapshot()}
        with open(path, "a") as f:
            f.write(json.dumps(rec) + "\n")


_global_registry: Optional[MetricsRegistry] = None
_registry_lock = threading.Lock()


def get_registry() -> MetricsRegistry:
    """The process-wide registry every subsystem instruments into."""
    global _global_registry
    if _global_registry is None:
        with _registry_lock:
            if _global_registry is None:
                _global_registry = MetricsRegistry()
    return _global_registry


def reset_registry() -> None:
    """Drop the process-wide registry (test helper)."""
    global _global_registry
    with _registry_lock:
        _global_registry = None
