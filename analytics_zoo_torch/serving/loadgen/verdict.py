"""End-of-run SLO verdict + capacity-planning report.

The verdict joins three evidence streams:

* the **loadgen log** (per-request scheduled/sent/done timestamps and
  terminal statuses — the client's view);
* the **dead-letter stream** (every record the fleet deliberately
  gave up on, with its reason/cause/age bookkeeping — the server's
  confession);
* the **fleet introspection** (the supervisor's replica trajectory
  and scale events — the control plane's diary).

and asserts the production claims end to end:

* **p99 from scheduled** under the SLO bound — the coordinated-
  omission-safe basis (``latency_from_sent`` is reported beside it so
  the CO gap is visible, but it never gates);
* **exactly-once**: every scheduled request reached exactly one
  terminal outcome — nothing lost, nothing silently dropped, no
  request both served and dead-lettered, no duplicate dead letters;
* **shed correctness**: every ``reason=shed`` dead letter is
  deadline-justified by its own recorded age (``age_ms`` vs
  ``deadline_ms``, halved under overload — the serving deadline contract);
* **quarantine exactness**: every ``reason=poison`` dead letter took
  exactly ``poison_max_attempts`` deliveries — fewer means innocent
  records are being condemned, more means a poison record burned
  extra replica lives;
* **poison containment**: no poison-kind request resolved ``ok``;
* **autoscaler trajectory**: a scale-up landed within
  ``scale_up_lag_s`` of the burst start, and the fleet never flapped
  (no re-growth after a shrink during one run).

Checks whose evidence is absent (no poison scheduled, no autoscaler
bound configured) pass vacuously with a ``skipped`` note — the fleet
acceptance test asserts the load-bearing ones really ran.

The **capacity report** is fitted from the run itself: the run is
cut into windows, each window contributes (offered rps, achieved p99
from scheduled, live replicas); the highest per-replica offered rate
whose window still met the target p99 becomes the planning
coefficient, and the report tabulates replicas-needed-per-rps from
it.  Emitted as JSON and rendered by ``scripts/obs_report.py``.
"""

from __future__ import annotations

import dataclasses
import json
import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

from analytics_zoo_torch.serving.loadgen.loadgen import LoadgenRun


@dataclasses.dataclass
class SloSpec:
    """The bounds a scenario must meet.  ``None``/0 disables a check
    (it reports as skipped, not passed-on-no-evidence)."""
    p99_from_scheduled_ms: float = 10000.0
    max_error_fraction: float = 0.05     # non-deliberate errors only
    scale_up_lag_s: Optional[float] = None
    max_scale_flaps: int = 0
    request_deadline_ms: float = 0.0
    poison_max_attempts: int = 2
    #: capacity fit target; None = reuse p99_from_scheduled_ms
    target_capacity_p99_ms: Optional[float] = None

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class CheckResult:
    name: str
    passed: bool
    detail: str
    skipped: bool = False
    #: forensic handles: the trace_ids of the requests that drove
    #: this finding (p99-region requests, exactly-once violators).
    #: Feed them to ``obs_report --requests RUN_DIR`` to see each
    #: one's station waterfall.
    trace_ids: Tuple[str, ...] = ()

    def to_dict(self) -> Dict[str, Any]:
        out = {"name": self.name, "passed": self.passed,
               "detail": self.detail, "skipped": self.skipped}
        if self.trace_ids:
            out["trace_ids"] = list(self.trace_ids)
        return out


class Verdict:
    """The run's pass/fail plus everything needed to argue about it."""

    def __init__(self, checks: List[CheckResult],
                 latency: Dict[str, float], counts: Dict[str, int],
                 capacity: Optional[Dict] = None):
        self.checks = checks
        self.latency = latency
        self.counts = counts
        self.capacity = capacity

    @property
    def passed(self) -> bool:
        return all(c.passed for c in self.checks)

    def check(self, name: str) -> CheckResult:
        for c in self.checks:
            if c.name == name:
                return c
        raise KeyError(name)

    def to_dict(self) -> Dict[str, Any]:
        return {
            "passed": self.passed,
            "checks": [c.to_dict() for c in self.checks],
            "latency": self.latency,
            "counts": self.counts,
            "capacity_planning": self.capacity,
        }

    def render(self) -> str:
        lines = [f"== SLO verdict: "
                 f"{'PASS' if self.passed else 'FAIL'} =="]
        for c in self.checks:
            mark = ("SKIP" if c.skipped
                    else "ok  " if c.passed else "FAIL")
            lines.append(f"  [{mark}] {c.name}: {c.detail}")
        lines.append(
            "  latency: "
            + "  ".join(f"{k}={v:.1f}ms"
                        for k, v in sorted(self.latency.items())))
        lines.append("  outcomes: "
                     + "  ".join(f"{k}={v}" for k, v
                                 in sorted(self.counts.items())))
        return "\n".join(lines)


# ----------------------------------------------------------- dead letters
def read_dead_letters(broker, reason: Optional[str] = None
                      ) -> List[Dict[str, str]]:
    """Decode the ``serving_dead_letter`` stream into dicts (the
    verdict's server-side evidence)."""
    entries = broker.xread("serving_dead_letter", "0-0", count=100000)
    out = []
    for _id, fields in entries:
        rec = {k: (v.decode() if isinstance(v, bytes) else v)
               for k, v in fields.items()}
        if reason is None or rec.get("reason") == reason:
            out.append(rec)
    return out


def pending_count(broker, stream: str = "serving_stream",
                  group: str = "serving") -> int:
    """The group's remaining PEL depth after a run settled — the
    server-side half of the exactly-once evidence (a delivered but
    never-acked record is invisible to the client log until it is
    reclaimed... or never).  Embedded brokers expose the PEL
    directly; over the wire ``xlag`` (undelivered + pending) stands
    in — 0 after a fully drained run either way."""
    groups = getattr(broker, "_groups", None)
    if isinstance(groups, dict):
        return len(groups.get((stream, group), {})
                   .get("pending", {}))
    xlag = getattr(broker, "xlag", None)
    if xlag is not None:
        try:
            return int(xlag(stream, group))
        except Exception:   # noqa: BLE001 — absent group/old server
            return 0
    return 0


def fleet_snapshot(supervisor) -> Dict[str, Any]:
    """Freeze a supervisor's introspection surface for the verdict
    (duck-typed: anything with replica_trajectory / scale_events)."""
    return {
        "trajectory": [tuple(t) for t
                       in supervisor.replica_trajectory],
        "scale_events": list(supervisor.scale_events),
        "restarts_total": supervisor.restarts_total,
    }


# ---------------------------------------------------------------- checks
def _latency_summary(run: LoadgenRun) -> Dict[str, float]:
    return {
        "p50_from_scheduled_ms": run.percentile(50) * 1e3,
        "p99_from_scheduled_ms": run.percentile(99) * 1e3,
        "p50_from_sent_ms": run.percentile(50, basis="sent") * 1e3,
        "p99_from_sent_ms": run.percentile(99, basis="sent") * 1e3,
    }


def _check_latency(run: LoadgenRun, slo: SloSpec) -> CheckResult:
    p99 = run.percentile(99) * 1e3
    p99_sent = run.percentile(99, basis="sent") * 1e3
    ok = p99 <= slo.p99_from_scheduled_ms
    # name the requests that ARE the tail: everything at/above the
    # p99 value, slowest first — the handles a forensics pass feeds
    # to ``obs_report --requests`` to see where the time went
    tail = sorted(
        ((r.latency_from_scheduled_s or 0.0) * 1e3, r.trace_id)
        for r in run.records
        if r.latency_from_scheduled_s is not None
        and r.latency_from_scheduled_s * 1e3 >= p99)
    tail_ids = tuple(t for _lat, t in reversed(tail))[:5]
    return CheckResult(
        "p99_from_scheduled", ok,
        f"p99 {p99:.0f}ms from SCHEDULED (bound "
        f"{slo.p99_from_scheduled_ms:.0f}ms; from-sent p99 "
        f"{p99_sent:.0f}ms — the gap is the coordinated omission a "
        f"closed-loop bench would have hidden)"
        + (f"; slowest trace_ids {list(tail_ids)}" if tail_ids
           else ""),
        trace_ids=tail_ids)


def _check_exactly_once(run: LoadgenRun,
                        dead_letters: Sequence[Dict],
                        pending: int) -> CheckResult:
    counts = run.counts()
    lost = counts.get("lost", 0) + counts.get("send_failed", 0)
    by_rid: Dict[str, int] = {}
    for d in dead_letters:
        rid = d.get("request_id") or ""
        if rid:
            by_rid[rid] = by_rid.get(rid, 0) + 1
    dupes = sorted(r for r, n in by_rid.items() if n > 1)
    # a request that resolved OK must not ALSO have been given up on
    both = sorted(r.spec.request_id for r in run.records
                  if r.status == "ok"
                  and by_rid.get(r.spec.request_id))
    ok = lost == 0 and pending == 0 and not dupes and not both
    # the violators themselves, by trace_id (== request_id on the
    # loadgen wire): lost/unsent first, then duplicate/double-served
    lost_ids = [r.trace_id for r in run.records
                if r.status in ("lost", "send_failed")]
    violators = tuple((lost_ids + dupes + both)[:8])
    return CheckResult(
        "exactly_once", ok,
        f"{lost} lost/unsent of {len(run.records)}, {pending} still "
        f"pending in the PEL, {len(dupes)} duplicate dead-letter "
        f"request_ids, {len(both)} served-AND-dead-lettered"
        + (f"; violator trace_ids {list(violators)}"
           if violators else ""),
        trace_ids=violators)


def _check_error_fraction(run: LoadgenRun, slo: SloSpec
                          ) -> CheckResult:
    counts = run.counts()
    # deliberate hostile traffic (poison/malformed kinds) is EXPECTED
    # to error; only errors on well-formed requests count
    errors = sum(1 for r in run.records
                 if r.status == "error" and r.spec.kind == "ok")
    total = max(sum(1 for r in run.records if r.spec.kind == "ok"), 1)
    frac = errors / total
    ok = frac <= slo.max_error_fraction
    return CheckResult(
        "error_fraction", ok,
        f"{errors}/{total} well-formed requests errored "
        f"({frac:.1%}; bound {slo.max_error_fraction:.1%}); "
        f"outcomes {dict(sorted(counts.items()))}")


def _check_sheds_justified(dead_letters: Sequence[Dict]
                           ) -> CheckResult:
    sheds = [d for d in dead_letters if d.get("reason") == "shed"]
    if not sheds:
        return CheckResult("sheds_deadline_justified", True,
                           "no records shed", skipped=True)
    unjust = []
    for d in sheds:
        try:
            age = float(d.get("age_ms", "nan"))
            deadline = float(d.get("deadline_ms", "nan"))
        except ValueError:
            unjust.append(d)
            continue
        cut = deadline / 2.0 if d.get("cause") == "overload" \
            else deadline
        if not (age > cut > 0):
            unjust.append(d)
    return CheckResult(
        "sheds_deadline_justified", not unjust,
        f"{len(sheds)} shed, {len(unjust)} NOT past their deadline "
        f"cut (causes "
        f"{sorted({d.get('cause', '?') for d in sheds})})")


def _check_quarantine_exact(dead_letters: Sequence[Dict],
                            slo: SloSpec,
                            poison_scheduled: int) -> CheckResult:
    poisons = [d for d in dead_letters
               if d.get("reason") == "poison"]
    if not poisons and poison_scheduled == 0:
        return CheckResult("quarantine_exact", True,
                           "no poison in the scenario", skipped=True)
    wrong = [d for d in poisons
             if d.get("deliveries")
             != str(slo.poison_max_attempts)]
    return CheckResult(
        "quarantine_exact", not wrong,
        f"{len(poisons)} quarantined of {poison_scheduled} poison "
        f"scheduled; {len(wrong)} with deliveries != "
        f"{slo.poison_max_attempts} "
        f"({sorted({d.get('deliveries') for d in poisons})})")


def _check_poison_contained(run: LoadgenRun) -> CheckResult:
    poison = [r for r in run.records if r.spec.kind != "ok"]
    if not poison:
        return CheckResult("poison_contained", True,
                           "no hostile traffic scheduled",
                           skipped=True)
    leaked = [r for r in poison if r.status == "ok"]
    silent = [r for r in poison
              if r.status in ("lost", "send_failed")]
    return CheckResult(
        "poison_contained", not leaked and not silent,
        f"{len(poison)} hostile requests: {len(leaked)} resolved OK "
        f"(leak), {len(silent)} got no terminal outcome")


def _check_autoscaler(run: LoadgenRun, slo: SloSpec,
                      fleet: Optional[Dict],
                      burst_start_offset_s: Optional[float]
                      ) -> List[CheckResult]:
    if slo.scale_up_lag_s is None or fleet is None:
        return [CheckResult("autoscaler", True,
                            "no autoscaler bound configured",
                            skipped=True)]
    trajectory: List[Tuple[float, int, str]] = [
        tuple(t) for t in fleet.get("trajectory", [])]
    scaled = [(t, s) for (t, s, r) in trajectory if r == "scale_up"]
    out = []
    if burst_start_offset_s is None:
        out.append(CheckResult(
            "scale_up_lag", bool(scaled),
            f"{len(scaled)} scale-up(s) (no burst anchor given)"))
    else:
        burst_wall = run.wall_of(run.started_monotonic
                                 + burst_start_offset_s)
        lags = [t - burst_wall for (t, _s) in scaled
                if t >= burst_wall - 0.5]
        ok = any(0 <= lag <= slo.scale_up_lag_s for lag in lags) \
            if lags else False
        out.append(CheckResult(
            "scale_up_lag", ok,
            f"scale-up lag(s) from burst start: "
            f"{[round(x, 2) for x in lags] or 'NONE'} "
            f"(bound {slo.scale_up_lag_s:.1f}s)"))
    # flap: the fleet grew again after shrinking within one run —
    # the hysteresis the autoscaler promises makes this a defect
    reasons = [r for (_t, _s, r) in trajectory
               if r in ("scale_up", "scale_down")]
    flaps = 0
    seen_down = False
    for r in reasons:
        if r == "scale_down":
            seen_down = True
        elif seen_down:
            flaps += 1
    out.append(CheckResult(
        "no_flap", flaps <= slo.max_scale_flaps,
        f"{flaps} re-growth(s) after a shrink (bound "
        f"{slo.max_scale_flaps}); trajectory "
        f"{[s for (_t, s, _r) in trajectory]}"))
    return out


# ------------------------------------------------- declarative SLO specs
#: latency bucket bounds (seconds) for the synthesized run histogram —
#: a latency_quantile objective's threshold should sit on one of these
RUN_SERIES_BUCKETS = (0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0)


def run_series_store(run: LoadgenRun, *, max_samples: int = 240):
    """Synthesize an ``observability.tsdb.SeriesStore`` from the
    loadgen log, so declarative :class:`~analytics_zoo_torch
    .observability.slo.SloObjective` specs evaluate against the run
    with the SAME burn-rate math production uses.

    Series (well-formed ``kind=="ok"`` traffic only — hostile traffic
    is EXPECTED to error and must not burn the availability budget):

    * ``loadgen_requests_total`` / ``loadgen_requests_bad_total``
      (bad = ANY non-ok outcome, the client's view) /
      ``loadgen_requests_error_total`` (broken responses only —
      deadline-justified sheds are admission control doing its job
      and have their own verdict check, so production specs usually
      burn availability on errors and let the latency objective
      carry the pain sheds trade away);
    * ``loadgen_latency_seconds_count`` / ``_sum`` /
      ``_bucket{le=...}`` over :data:`RUN_SERIES_BUCKETS`, from the
      scheduled basis (coordinated-omission-safe, same as the p99
      check).

    Completions are bucketed onto a bounded time grid (cumulative
    counters, one sample per grid point, a leading zero sample so the
    first window has a baseline)."""
    from analytics_zoo_torch.observability.tsdb import (
        SeriesStore, format_series_key)
    events = []     # (wall_done, bad, error, latency_s)
    for r in run.records:
        if r.spec.kind != "ok":
            continue
        mono = r.done if r.done is not None else run.started_monotonic \
            + r.spec.offset_s
        bad = r.status != "ok"
        err = r.status not in ("ok", "shed")
        events.append((run.wall_of(mono), bad, err,
                       r.latency_from_scheduled_s))
    # timestamp only: the latency element can be None (never-completed
    # requests), which full-tuple sort would compare on a (t, bad, err)
    # tie and crash
    events.sort(key=lambda e: e[0])
    t_start = run.wall_of(run.started_monotonic)
    t_end = max([t for (t, _b, _e, _l) in events] + [t_start + 1e-3])
    grid = max((t_end - t_start) / max_samples, 1e-3)
    total = bad_n = err_n = lat_count = 0
    lat_sum = 0.0
    bucket_counts = [0] * len(RUN_SERIES_BUCKETS)

    def counters() -> Dict[str, float]:
        c = {"loadgen_requests_total": float(total),
             "loadgen_requests_bad_total": float(bad_n),
             "loadgen_requests_error_total": float(err_n),
             "loadgen_latency_seconds_count": float(lat_count),
             "loadgen_latency_seconds_sum": lat_sum}
        for le, n in zip(RUN_SERIES_BUCKETS, bucket_counts):
            c[format_series_key("loadgen_latency_seconds_bucket",
                                {"le": f"{le:g}"})] = float(n)
        c[format_series_key("loadgen_latency_seconds_bucket",
                            {"le": "+Inf"})] = float(lat_count)
        return c

    samples = [{"t": t_start, "counters": counters(), "gauges": {}}]
    cursor = t_start + grid
    for (t, bad, err, lat) in events:
        while t > cursor:
            samples.append({"t": cursor, "counters": counters(),
                            "gauges": {}})
            cursor += grid
        total += 1
        if bad:
            bad_n += 1
        if err:
            err_n += 1
        if lat is not None:
            lat_count += 1
            lat_sum += lat
            for i, le in enumerate(RUN_SERIES_BUCKETS):
                if lat <= le:
                    bucket_counts[i] += 1
    samples.append({"t": max(t_end, cursor), "counters": counters(),
                    "gauges": {}})
    return SeriesStore(samples)


def _check_slo_objectives(run: LoadgenRun, objectives: Sequence
                          ) -> List[CheckResult]:
    """One ``slo:<name>`` check per declared objective: the run's
    recorded window must not exhaust the objective's error budget.
    Violating requests are cited by trace_id (forensic handles,
    same contract as the p99 check)."""
    if not objectives:
        return []
    from analytics_zoo_torch.observability.slo import SloEngine
    store = run_series_store(run)
    _t0, t1 = store.time_range()
    engine = SloEngine(list(objectives), registry=None)
    statuses = engine.evaluate(store, now=t1)
    bad_ids = tuple(r.trace_id for r in run.records
                    if r.spec.kind == "ok" and r.status != "ok")[:5]
    err_ids = tuple(r.trace_id for r in run.records
                    if r.spec.kind == "ok"
                    and r.status not in ("ok", "shed"))[:5]
    slow_ids = tuple(
        t for (_lat, t) in sorted(
            ((r.latency_from_scheduled_s, r.trace_id)
             for r in run.records
             if r.latency_from_scheduled_s is not None),
            reverse=True))[:5]
    by_name = {o.name: o for o in objectives}
    out = []
    for st in statuses:
        ok = st.budget_remaining > 0.0
        obj = by_name.get(st.name)
        # cite the requests this OBJECTIVE counts as bad: sheds are
        # not violations of an errors-only availability spec
        errors_only = (obj is not None and
                       obj.bad == "loadgen_requests_error_total")
        ids = () if ok else (
            slow_ids if st.detail == "latency_quantile"
            else err_ids if errors_only else bad_ids)
        out.append(CheckResult(
            f"slo:{st.slo_key}", ok,
            f"bad_fraction {st.bad_fraction:.2%} vs target "
            f"{st.target:.2%} -> budget_remaining "
            f"{st.budget_remaining:.2f}, alert={st.alert}"
            + (f"; violating trace_ids {list(ids)}" if ids else ""),
            trace_ids=ids))
    return out


# ----------------------------------------------------------- capacity fit
def capacity_report(run: LoadgenRun, *, target_p99_ms: float,
                    trajectory: Optional[Sequence[Tuple]] = None,
                    windows: int = 12) -> Dict[str, Any]:
    """Fit replicas-needed-per-rps from the run: cut the schedule into
    ``windows`` equal slices, measure each slice's offered rate and
    achieved p99-from-scheduled, attribute the live replica count from
    the trajectory, and take the best per-replica rate that still met
    the target."""
    if not run.records:
        return {"target_p99_ms": target_p99_ms, "windows": [],
                "rps_per_replica_at_slo": None, "replicas_for": {}}
    offsets = [r.spec.offset_s for r in run.records]
    span = max(max(offsets), 1e-9)
    width = span / windows

    def replicas_at(offset_s: float) -> int:
        if not trajectory:
            return 1
        wall = run.wall_of(run.started_monotonic + offset_s)
        size = trajectory[0][1]
        for (t, s, _r) in trajectory:
            if t <= wall:
                size = s
            else:
                break
        return max(int(size), 1)

    rows = []
    for w in range(windows):
        lo, hi = w * width, (w + 1) * width
        recs = [r for r in run.records
                if lo <= r.spec.offset_s < hi]
        if not recs:
            continue
        lats = sorted(x for x in
                      (r.latency_from_scheduled_s for r in recs)
                      if x is not None)
        p99 = (lats[min(int(0.99 * len(lats)), len(lats) - 1)] * 1e3
               if lats else float("inf"))
        unresolved = sum(1 for r in recs
                         if r.status in ("lost", "send_failed"))
        replicas = replicas_at((lo + hi) / 2.0)
        offered = len(recs) / width
        rows.append({
            "window_s": [round(lo, 2), round(hi, 2)],
            "offered_rps": round(offered, 2),
            "p99_from_scheduled_ms": round(p99, 1),
            "replicas": replicas,
            "rps_per_replica": round(offered / replicas, 2),
            "met_slo": bool(p99 <= target_p99_ms
                            and unresolved == 0),
        })
    feasible = [r["rps_per_replica"] for r in rows if r["met_slo"]]
    per_replica = max(feasible) if feasible else None
    replicas_for = {}
    if per_replica:
        for rate in (10, 50, 100, 250, 500, 1000, 10000):
            replicas_for[str(rate)] = int(
                math.ceil(rate / per_replica))
    return {
        "target_p99_ms": target_p99_ms,
        "windows": rows,
        "rps_per_replica_at_slo": per_replica,
        "replicas_for": replicas_for,
    }


# ---------------------------------------------------------------- entry
def evaluate(run: LoadgenRun, slo: SloSpec, *,
             fleet: Optional[Dict] = None,
             dead_letters: Sequence[Dict] = (),
             pending: int = 0,
             burst_start_offset_s: Optional[float] = None,
             objectives: Sequence = (),
             trajectory_for_capacity: Optional[Sequence[Tuple]]
             = None) -> Verdict:
    """Compute the full verdict.  ``pending`` is the broker's
    remaining PEL depth after the run settled (exactly-once evidence
    the client log alone cannot provide); ``burst_start_offset_s``
    anchors the autoscaler lag bound on the scenario's burst phase;
    ``objectives`` are declarative SLO specs (scenario-declared or
    ``--slo-spec``-loaded) evaluated over the recorded window with
    the production burn-rate math."""
    poison_scheduled = sum(1 for r in run.records
                           if r.spec.kind == "poison")
    checks = [
        _check_latency(run, slo),
        _check_exactly_once(run, dead_letters, pending),
        _check_error_fraction(run, slo),
        _check_sheds_justified(dead_letters),
        _check_quarantine_exact(dead_letters, slo, poison_scheduled),
        _check_poison_contained(run),
    ]
    checks.extend(_check_autoscaler(run, slo, fleet,
                                    burst_start_offset_s))
    checks.extend(_check_slo_objectives(run, objectives))
    target = slo.target_capacity_p99_ms or slo.p99_from_scheduled_ms
    capacity = capacity_report(
        run, target_p99_ms=target,
        trajectory=(trajectory_for_capacity
                    or (fleet or {}).get("trajectory")))
    return Verdict(checks, _latency_summary(run), run.counts(),
                   capacity)


def report_document(scenario_name: str, verdict: Verdict, *,
                    slo: SloSpec, compress: float = 1.0,
                    extra: Optional[Dict] = None) -> Dict[str, Any]:
    """The JSON document ``zoo-loadtest`` writes and
    ``scripts/obs_report.py`` renders: verdict + capacity planning +
    a registry snapshot of the run's exported metrics."""
    from analytics_zoo_torch.observability import get_registry
    doc = {
        "kind": "zoo_loadtest_report",
        "scenario": scenario_name,
        "compress": compress,
        "slo": slo.to_dict(),
        "verdict": verdict.to_dict(),
        "capacity_planning": verdict.capacity,
        "metrics": get_registry().snapshot(),
    }
    doc.update(extra or {})
    return doc


def write_report(path: str, doc: Dict[str, Any]) -> None:
    with open(path, "w") as f:
        json.dump(doc, f, indent=2)
