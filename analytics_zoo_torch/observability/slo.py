"""Declarative SLOs evaluated as multi-window multi-burn-rate error
budgets (port of the JAX package's ``observability/slo.py``).

An :class:`SloObjective` names what "good" means over registry series
stored in the tsdb (``observability/tsdb.py``): an availability or
error-rate ratio over counter pairs, a latency quantile over a
histogram's bucket counters, or the freshness of a series.  The
evaluator is the Google-SRE burn-rate construction: the error budget
is ``1 - target`` per budget period (``window_s``); the **burn rate**
over a lookback window is ``bad_fraction / (1 - target)`` (1.0 =
spending exactly the sustainable budget); an alert level fires when
the burn rate exceeds its threshold in BOTH a long and a short window
(the long window proves the spend is real, the short window makes the
alert reset fast once the incident ends).  Defaults are the SRE
workbook's: page at 14.4× (1h + 5m), warn at 6× (6h + 30m) —
storm-compressed tests override the window lengths, never the math.

Objectives are label-keyed: a ``group_by`` label (``endpoint`` today,
a tenant dimension tomorrow) fans one objective out into one budget
per label value.

Specs load from YAML (``slo.yaml`` / a ``slos:`` section in
``config.yaml``) via the same hand-rolled subset parser discipline as
``ServingConfig.from_yaml`` — CONTRACT: stdlib-only at module level
(no torch, no numpy).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import (Any, Callable, Dict, List, Optional, Sequence,
                    Tuple)

__all__ = [
    "ALERT_LEVELS",
    "BurnWindow",
    "SloAlertState",
    "SloEngine",
    "SloObjective",
    "SloStatus",
    "default_windows",
    "evaluate_timeline",
    "load_slo_yaml",
    "parse_slo_specs",
]

ALERT_LEVELS = {"ok": 0, "warn": 1, "page": 2}
_LEVEL_NAMES = {v: k for k, v in ALERT_LEVELS.items()}


@dataclass
class BurnWindow:
    """One (long, short) burn-rate window pair and the alert level it
    raises when BOTH exceed ``burn``."""
    name: str                    # alert level: "page" or "warn"
    burn: float                  # burn-rate threshold (>= fires)
    long_s: float
    short_s: float


def default_windows() -> List[BurnWindow]:
    """The SRE-workbook ladder (budget period 30d in the book; the
    thresholds are period-relative so they transfer unchanged)."""
    return [
        BurnWindow("page", 14.4, 3600.0, 300.0),
        BurnWindow("warn", 6.0, 21600.0, 1800.0),
    ]


@dataclass
class SloObjective:
    """What "good" means for one service dimension.

    objective kinds
        ``error_rate``       bad/total counter ratio (``bad``,``total``)
        ``availability``     1 - good/total (``good`` or ``bad``)
        ``latency_quantile`` fraction of requests over ``threshold_ms``
                             from ``<histogram>_bucket{le=...}`` counters
        ``freshness``        fraction of the window with no sample of
                             ``series`` within ``max_age_s``
    """
    name: str
    objective: str = "availability"
    target: float = 0.99
    window_s: float = 3600.0          # the budget period
    total: Optional[str] = None       # counter selectors
    bad: Optional[str] = None
    good: Optional[str] = None
    histogram: Optional[str] = None   # latency_quantile
    threshold_ms: float = 1000.0
    series: Optional[str] = None      # freshness
    max_age_s: float = 60.0
    group_by: Optional[str] = None    # label key to fan out on
    windows: List[BurnWindow] = field(default_factory=default_windows)
    recovery_hold_s: float = 0.0      # extra clear-side hysteresis

    def scaled(self, factor: float) -> "SloObjective":
        """A copy with every time window multiplied by ``factor`` —
        how compressed storm runs reuse production specs."""
        return SloObjective(
            name=self.name, objective=self.objective,
            target=self.target, window_s=self.window_s * factor,
            total=self.total, bad=self.bad, good=self.good,
            histogram=self.histogram, threshold_ms=self.threshold_ms,
            series=self.series, max_age_s=self.max_age_s * factor,
            group_by=self.group_by,
            windows=[BurnWindow(w.name, w.burn, w.long_s * factor,
                                w.short_s * factor)
                     for w in self.windows],
            recovery_hold_s=self.recovery_hold_s * factor)


@dataclass
class SloStatus:
    """One objective's (or one group's) evaluated state at ``t``."""
    name: str
    group: Optional[str]
    t: float
    alert: str
    burn: Dict[str, Dict[str, float]]   # window name -> {long, short}
    budget_remaining: float
    bad_fraction: float                 # over the budget period
    target: float
    detail: str = ""

    @property
    def slo_key(self) -> str:
        return self.name if not self.group else f"{self.name}/{self.group}"

    def to_dict(self) -> Dict[str, Any]:
        return {
            "name": self.name, "group": self.group,
            "t": round(self.t, 6), "alert": self.alert,
            "burn": {w: {k: round(v, 6) for k, v in b.items()}
                     for w, b in self.burn.items()},
            "budget_remaining": round(self.budget_remaining, 6),
            "bad_fraction": round(self.bad_fraction, 9),
            "target": self.target, "detail": self.detail,
        }


# ------------------------------------------------------- alert state
class SloAlertState:
    """ok/warn/page with asymmetric hysteresis: a level fires the
    instant both of its windows exceed the threshold; it clears only
    after the burn stays below for ``recovery_hold_s`` (0 = the short
    window itself is the hysteresis, per the SRE construction)."""

    def __init__(self, recovery_hold_s: float = 0.0):
        self.recovery_hold_s = float(recovery_hold_s)
        self.level = 0
        self._clear_since: Optional[float] = None
        self.transitions: List[Tuple[float, str]] = []

    def update(self, now: float,
               firing_level: int) -> str:
        if firing_level >= self.level:
            if firing_level > self.level:
                self.level = firing_level
                self.transitions.append((now, _LEVEL_NAMES[self.level]))
            self._clear_since = None
        else:
            if self._clear_since is None:
                self._clear_since = now
            if now - self._clear_since >= self.recovery_hold_s:
                self.level = firing_level
                self._clear_since = None
                self.transitions.append((now, _LEVEL_NAMES[self.level]))
        return _LEVEL_NAMES[self.level]


# ------------------------------------------------------- evaluation
def _with_label(selector: Optional[str], key: str,
                value: str) -> Optional[str]:
    if selector is None:
        return None
    if "{" in selector:
        name, _, rest = selector.partition("{")
        inner = rest.rstrip("}")
        sep = "," if inner else ""
        return f'{name}{{{inner}{sep}{key}="{value}"}}'
    return f'{selector}{{{key}="{value}"}}'


class _Evaluator:
    """bad_fraction over an arbitrary window, per objective kind."""

    def __init__(self, store: Any, obj: SloObjective,
                 group: Optional[str] = None):
        self.store = store
        self.obj = obj
        self.group = group

    def _sel(self, selector: Optional[str]) -> Optional[str]:
        if self.group is not None and self.obj.group_by:
            return _with_label(selector, self.obj.group_by, self.group)
        return selector

    def bad_fraction(self, t0: float, t1: float) -> float:
        obj = self.obj
        if t1 <= t0:
            return 0.0
        if obj.objective in ("error_rate", "availability"):
            total = self.store.increase(self._sel(obj.total), t0, t1)
            if total <= 0:
                return 0.0       # no traffic spends no budget
            if obj.bad is not None:
                bad = self.store.increase(self._sel(obj.bad), t0, t1)
            else:
                good = self.store.increase(self._sel(obj.good), t0, t1)
                bad = max(0.0, total - good)
            return min(1.0, max(0.0, bad / total))
        if obj.objective == "latency_quantile":
            # suffix the bare histogram name FIRST, then apply the
            # group label: the stored keys are hist_count{endpoint=..}
            total = self.store.increase(
                self._sel(f"{obj.histogram}_count"), t0, t1)
            if total <= 0:
                return 0.0
            le = self._bucket_le(self._sel(f"{obj.histogram}_bucket"))
            if le is None:       # threshold beyond the ladder
                return 0.0
            good = self.store.increase(
                _with_label(self._sel(f"{obj.histogram}_bucket"),
                            "le", le), t0, t1)
            return min(1.0, max(0.0, (total - good) / total))
        if obj.objective == "freshness":
            return self._staleness_fraction(t0, t1)
        raise ValueError(f"unknown objective kind: {obj.objective!r}")

    def _bucket_le(self, bucket_sel: str) -> Optional[str]:
        """The smallest bucket bound >= threshold — requests at or
        under it are the 'good' events."""
        threshold_s = self.obj.threshold_ms / 1000.0
        best: Optional[float] = None
        for key in self.store.counter_keys(bucket_sel):
            _, labels = _parse_key(key)
            raw = labels.get("le", "")
            if raw in ("+Inf", "inf", ""):
                continue
            try:
                le = float(raw)
            except ValueError:
                continue
            if le >= threshold_s - 1e-12 and (best is None or le < best):
                best = le
        return None if best is None else f"{best:g}"

    def _staleness_fraction(self, t0: float, t1: float) -> float:
        obj = self.obj
        window = t1 - t0
        got = self.store.query(self._sel(obj.series),
                               t0 - obj.max_age_s, t1)
        pts = sorted(t for series_pts in got.values()
                     for t, _v in series_pts)
        if not pts:
            return 1.0           # never observed: fully stale
        covered = 0.0
        cursor = t0
        for t in pts:
            lo, hi = max(t, cursor), min(t + obj.max_age_s, t1)
            if hi > lo:
                covered += hi - lo
                cursor = hi      # intervals merge left-to-right
        return min(1.0, max(0.0, 1.0 - covered / window))


def _parse_key(key: str) -> Tuple[str, Dict[str, str]]:
    if "{" not in key:
        return key, {}
    name, _, rest = key.partition("{")
    labels: Dict[str, str] = {}
    for part in rest.rstrip("}").split(","):
        if part:
            k, _, v = part.partition("=")
            labels[k.strip()] = v.strip().strip('"')
    return name, labels


class SloEngine:
    """Evaluates objectives against a series store and keeps the
    per-objective (per-group) alert state between calls — the live
    consumer loop: supervisor/watchdog call ``evaluate`` on their
    cadence and read the statuses."""

    def __init__(self, objectives: Sequence[SloObjective], *,
                 registry: Any = None,
                 clock: Callable[[], float] = time.time):
        self.objectives = list(objectives)
        self._clock = clock
        self._states: Dict[Tuple[str, Optional[str]], SloAlertState] = {}
        self.registry = registry
        self._burn_gauge = None
        self._budget_gauge = None
        self._alert_gauge = None
        if registry is not None:
            self._bind_registry(registry)

    def _bind_registry(self, registry: Any) -> None:
        self.registry = registry
        self._burn_gauge = registry.gauge(
            "slo_burn_rate", "error-budget burn rate per window",
            labels=("slo", "window"))
        self._budget_gauge = registry.gauge(
            "slo_budget_remaining",
            "fraction of the period's error budget left",
            labels=("slo",))
        self._alert_gauge = registry.gauge(
            "slo_alert_state", "0 ok / 1 warn / 2 page",
            labels=("slo",))

    def _groups(self, store: Any, obj: SloObjective) -> List[Optional[str]]:
        if not obj.group_by:
            return [None]
        base = obj.total or obj.series or (
            f"{obj.histogram}_count" if obj.histogram else None)
        if base is None:
            return [None]
        keys = list(store.counter_keys(base))
        # freshness objectives usually watch gauges (heartbeat/up
        # series) — without this union group_by silently collapses
        # to one ungrouped budget
        gauge_keys = getattr(store, "gauge_keys", None)
        if gauge_keys is not None:
            keys.extend(gauge_keys(base))
        groups = set()
        for key in keys:
            _, labels = _parse_key(key)
            if obj.group_by in labels:
                groups.add(labels[obj.group_by])
        return sorted(groups) or [None]

    def evaluate(self, store: Any,
                 now: Optional[float] = None) -> List[SloStatus]:
        now = self._clock() if now is None else float(now)
        statuses: List[SloStatus] = []
        for obj in self.objectives:
            for group in self._groups(store, obj):
                statuses.append(self._evaluate_one(store, obj, group,
                                                   now))
        if self.registry is not None:
            self.publish(statuses)
        return statuses

    def _evaluate_one(self, store: Any, obj: SloObjective,
                      group: Optional[str], now: float) -> SloStatus:
        ev = _Evaluator(store, obj, group)
        budget = max(1e-12, 1.0 - obj.target)
        burn: Dict[str, Dict[str, float]] = {}
        firing = 0
        for w in obj.windows:
            long_frac = ev.bad_fraction(now - w.long_s, now)
            short_frac = ev.bad_fraction(now - w.short_s, now)
            b = {"long": long_frac / budget, "short": short_frac / budget}
            burn[w.name] = b
            if (b["long"] >= w.burn and b["short"] >= w.burn):
                firing = max(firing, ALERT_LEVELS.get(w.name, 1))
        state = self._states.setdefault(
            (obj.name, group), SloAlertState(obj.recovery_hold_s))
        alert = state.update(now, firing)
        period_frac = ev.bad_fraction(now - obj.window_s, now)
        status = SloStatus(
            name=obj.name, group=group, t=now, alert=alert,
            burn=burn,
            budget_remaining=1.0 - period_frac / budget,
            bad_fraction=period_frac, target=obj.target,
            detail=obj.objective)
        return status

    def transitions(self, name: str,
                    group: Optional[str] = None
                    ) -> List[Tuple[float, str]]:
        state = self._states.get((name, group))
        return list(state.transitions) if state else []

    def publish(self, statuses: Sequence[SloStatus]) -> None:
        if self._burn_gauge is None:
            return
        for s in statuses:
            for wname, b in s.burn.items():
                self._burn_gauge.labels(
                    s.slo_key, f"{wname}_long").set(b["long"])
                self._burn_gauge.labels(
                    s.slo_key, f"{wname}_short").set(b["short"])
            self._budget_gauge.labels(s.slo_key).set(s.budget_remaining)
            self._alert_gauge.labels(s.slo_key).set(
                float(ALERT_LEVELS[s.alert]))


def evaluate_timeline(store: Any, objectives: Sequence[SloObjective],
                      *, times: Optional[Sequence[float]] = None
                      ) -> List[List[SloStatus]]:
    """Replay the stored samples through a fresh engine — the offline
    twin of the live loop: one status list per evaluation instant
    (every stored sample timestamp by default).  ``obs_report --slo``
    and the storm stage's ``slo_report.json`` both render this."""
    engine = SloEngine(objectives)
    if times is None:
        times = sorted({s["t"] for s in getattr(store, "samples", [])})
    return [engine.evaluate(store, now=t) for t in times]


# --------------------------------------------------------- yaml specs
def _parse_scalar(raw: str) -> Any:
    s = raw.strip()
    if s.lower() in ("true", "false"):
        return s.lower() == "true"
    if s.lower() in ("null", "~", ""):
        return None
    try:
        return int(s)
    except ValueError:
        pass
    try:
        return float(s)
    except ValueError:
        pass
    return s.strip("'\"")


def _parse_yaml_subset(text: str) -> Any:
    """The same discipline as ``ServingConfig.from_yaml``: a
    hand-rolled parser for the indentation subset the spec files use
    (nested maps, lists of maps, scalar values) — no yaml dependency
    in the stdlib-only report path."""
    lines: List[Tuple[int, str]] = []
    for raw in text.splitlines():
        if not raw.strip() or raw.lstrip().startswith("#"):
            continue
        indent = len(raw) - len(raw.lstrip(" "))
        lines.append((indent, raw.strip()))

    def parse_block(i: int, indent: int) -> Tuple[Any, int]:
        if i >= len(lines):
            return {}, i
        if lines[i][1].startswith("- "):
            items = []
            while i < len(lines) and lines[i][0] == indent \
                    and lines[i][1].startswith("- "):
                head = lines[i][1][2:]
                item_indent = indent + 2
                if ":" in head:
                    k, _, v = head.partition(":")
                    entry: Dict[str, Any] = {}
                    if v.strip():
                        entry[k.strip()] = _parse_scalar(v)
                        i += 1
                    else:
                        i += 1
                        sub, i = parse_block(i, _next_indent(
                            lines, i, item_indent))
                        entry[k.strip()] = sub
                    while i < len(lines) and lines[i][0] >= item_indent \
                            and not lines[i][1].startswith("- "):
                        k2, _, v2 = lines[i][1].partition(":")
                        if v2.strip():
                            entry[k2.strip()] = _parse_scalar(v2)
                            i += 1
                        else:
                            i += 1
                            sub, i = parse_block(i, _next_indent(
                                lines, i, item_indent))
                            entry[k2.strip()] = sub
                    items.append(entry)
                else:
                    items.append(_parse_scalar(head))
                    i += 1
            return items, i
        out: Dict[str, Any] = {}
        while i < len(lines) and lines[i][0] == indent \
                and not lines[i][1].startswith("- "):
            k, _, v = lines[i][1].partition(":")
            if v.strip():
                out[k.strip()] = _parse_scalar(v)
                i += 1
            else:
                i += 1
                if i < len(lines) and lines[i][0] > indent:
                    sub, i = parse_block(i, lines[i][0])
                else:
                    sub = None
                out[k.strip()] = sub
        return out, i

    def _next_indent(ls, i, fallback):
        return ls[i][0] if i < len(ls) else fallback

    doc, _ = parse_block(0, lines[0][0] if lines else 0)
    return doc


def parse_slo_specs(doc: Any) -> List[SloObjective]:
    """Dict/list document -> objectives.  Accepts a bare list or a
    mapping with a ``slos:`` key (so a ``config.yaml`` section and a
    standalone ``slo.yaml`` both work)."""
    if isinstance(doc, dict):
        doc = doc.get("slos") or []
    objectives = []
    for entry in doc or []:
        if not isinstance(entry, dict) or "name" not in entry:
            continue
        windows = []
        for w in entry.get("windows") or []:
            if isinstance(w, dict) and "name" in w:
                windows.append(BurnWindow(
                    str(w["name"]), float(w.get("burn", 14.4)),
                    float(w.get("long_s", 3600.0)),
                    float(w.get("short_s", 300.0))))
        objectives.append(SloObjective(
            name=str(entry["name"]),
            objective=str(entry.get("objective", "availability")),
            target=float(entry.get("target", 0.99)),
            window_s=float(entry.get("window_s", 3600.0)),
            total=entry.get("total"),
            bad=entry.get("bad"),
            good=entry.get("good"),
            histogram=entry.get("histogram"),
            threshold_ms=float(entry.get("threshold_ms", 1000.0)),
            series=entry.get("series"),
            max_age_s=float(entry.get("max_age_s", 60.0)),
            group_by=entry.get("group_by"),
            windows=windows or default_windows(),
            recovery_hold_s=float(entry.get("recovery_hold_s", 0.0))))
    return objectives


def load_slo_yaml(path: str) -> List[SloObjective]:
    with open(path) as f:
        return parse_slo_specs(_parse_yaml_subset(f.read()))
