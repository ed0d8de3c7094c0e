"""Incident forensics engine: run-dir artifacts -> named root cause.

The flight recorder (``flightrec.py``) leaves journals; heartbeats,
``degraded.json``, blackboxes, SLO reports and request waterfalls are
already on disk.  This module is the *join*: it folds a finished run
dir's evidence into one causally-ordered incident timeline and runs a
rule-based diagnoser table over it, producing a **ranked root-cause
hypothesis list with evidence citations** — each citation names the
concrete event id (``host-0/e12``), trace id, or heartbeat gap that
supports the claim — emitted as ``incident.json``.

The diagnoser is a table, not a model: each rule is a plain function
``(ctx) -> hypothesis | None`` whose confidence arithmetic is written
out in the open (docs/observability.md reproduces the table).  Rules
distinguish cause from symptom — a fleet-wide breaker-open right
after a ``serving.redis`` chaos trip is a broker outage, and the
replica restarts that follow are *symptoms*, listed under the
hypothesis rather than competing with it.

Port of the JAX package's ``observability/incident.py``: the same rules,
the same confidence arithmetic and the same ``incident.json``, so either
package diagnoses the other's run dirs.

CONTRACT: stdlib-only at module level (no torch, no numpy); the sibling
modules it reads with (``flightrec.py``, ``tsdb.py``) are stdlib-only
too and imported inside the functions, so the forensics render a dead
run dir on a control node with no accelerator stack.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

__all__ = [
    "INCIDENT_SCHEMA",
    "INCIDENT_FILENAME",
    "ROOT_CAUSE_THRESHOLD",
    "RULES",
    "diagnose",
    "gather",
    "render_incident",
    "write_incident",
]

INCIDENT_SCHEMA = 1
INCIDENT_FILENAME = "incident.json"

# a hypothesis at or above this confidence counts as "root cause
# identified" — zoo-doctor's exit code contract
ROOT_CAUSE_THRESHOLD = 0.6

HEARTBEAT_FILE = "heartbeat.json"     # local twin of detector.py
CLUSTER_FILE = "cluster.json"         # local twin of aggregator.py
DEGRADED_FILE = "degraded.json"
BLACKBOX_FILE = "blackbox.json"
REQUESTS_FILE = "requests.json"
SLO_REPORT_FILE = "slo_report.json"


def _read_json(path: str) -> Optional[Any]:
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, json.JSONDecodeError):
        return None


# ------------------------------------------------------------- gather
def gather(run_dir: str, *, stale_after_s: float = 10.0) -> Dict[str, Any]:
    """Collect every forensic artifact a run dir offers into one
    context dict — the diagnoser rules' working set.  Every source is
    optional: a half-written run dir still gathers (that is the
    point — the run *died*)."""
    # plain imports, kept lazy: both modules are stdlib-only at module
    # level, so the forensics run where torch is not installed
    from analytics_zoo_torch.observability import flightrec
    events = flightrec.read_events(run_dir)
    journals = flightrec.journal_paths(run_dir)
    torn = []
    for stream, path in journals:
        parsed = flightrec.read_journal(path)
        if parsed["torn_tail"]:
            torn.append(stream)

    cluster = _read_json(os.path.join(run_dir, CLUSTER_FILE))
    degraded = _read_json(os.path.join(run_dir, DEGRADED_FILE))
    supervisor = _read_json(os.path.join(run_dir, "supervisor.json"))
    respawns = _read_json(os.path.join(run_dir, "job", "respawns.json"))

    heartbeats: Dict[str, Dict[str, Any]] = {}
    blackboxes: Dict[str, Dict[str, Any]] = {}
    try:
        names = sorted(os.listdir(run_dir))
    except OSError:
        names = []
    for name in names:
        if not name.startswith("host-"):
            continue
        hb = _read_json(os.path.join(run_dir, name, HEARTBEAT_FILE))
        if isinstance(hb, dict):
            heartbeats[name] = hb
        bb = _read_json(os.path.join(run_dir, name, BLACKBOX_FILE))
        if isinstance(bb, dict):
            blackboxes[name] = bb
    if not blackboxes:
        bb = _read_json(os.path.join(run_dir, BLACKBOX_FILE))
        if isinstance(bb, dict):
            blackboxes["run"] = bb

    # the run's activity horizon: latest event / beat / blackbox —
    # heartbeat gaps are measured against it, never wall-now, so a
    # week-old run dir diagnoses identically
    t_end = 0.0
    t_start = None
    for ev in events:
        t_end = max(t_end, float(ev.get("t", 0.0)))
        t = float(ev.get("t", 0.0))
        t_start = t if t_start is None else min(t_start, t)
    for hb in heartbeats.values():
        t_end = max(t_end, float(hb.get("time", 0.0)))
    for bb in blackboxes.values():
        t_end = max(t_end, float(bb.get("written", 0.0)))

    gaps: List[Dict[str, Any]] = []
    for host, hb in sorted(heartbeats.items()):
        beat = float(hb.get("time", 0.0))
        gap = t_end - beat
        if gap > stale_after_s:
            gaps.append({"host": host, "last_beat": beat,
                         "gap_s": round(gap, 3),
                         "step": hb.get("step"),
                         "process_index": hb.get("process_index")})

    # request waterfalls: non-ok trace ids are the citation currency
    # joining serving incidents to client-observed failures
    bad_traces: List[Dict[str, Any]] = []
    req_docs = []
    doc = _read_json(os.path.join(run_dir, REQUESTS_FILE))
    if isinstance(doc, dict):
        req_docs.append(doc)
    for name in names:
        if name.startswith("host-"):
            doc = _read_json(os.path.join(run_dir, name, REQUESTS_FILE))
            if isinstance(doc, dict):
                req_docs.append(doc)
    for doc in req_docs:
        for tl in (doc.get("timelines") or []):
            if not isinstance(tl, dict):
                continue
            outcome = tl.get("outcome", "ok")
            if outcome not in ("ok", "pending"):
                bad_traces.append({
                    "trace_id": tl.get("trace_id"),
                    "outcome": outcome})
    bad_traces = bad_traces[:32]

    # SLO alert transitions (loadtest's slo_report.json) — accepted in
    # both shapes the engine has emitted: [[t, level], ...] pairs or
    # {"t":, "alert":} dicts
    slo_transitions: List[Dict[str, Any]] = []
    slo_doc = _read_json(os.path.join(run_dir, SLO_REPORT_FILE))

    def _walk_slo(node: Any, name: str) -> None:
        if isinstance(node, dict):
            nm = node.get("name", name)
            for k, v in node.items():
                if k == "transitions" and isinstance(v, list):
                    for tr in v:
                        if isinstance(tr, (list, tuple)) and len(tr) == 2:
                            slo_transitions.append(
                                {"objective": nm, "t": float(tr[0]),
                                 "alert": str(tr[1])})
                        elif isinstance(tr, dict) and "t" in tr:
                            slo_transitions.append(
                                {"objective": nm, "t": float(tr["t"]),
                                 "alert": str(tr.get("alert",
                                                     tr.get("state", "?")))})
                else:
                    _walk_slo(v, nm)
        elif isinstance(node, list):
            for item in node:
                _walk_slo(item, name)

    if slo_doc is not None:
        _walk_slo(slo_doc, "slo")

    # tsdb corroboration: the serving breaker gauge's open intervals
    # (independent of the event journal — a worker whose journal was
    # lost still shows up here)
    tsdb_breaker_opens: List[Dict[str, Any]] = []
    try:
        from analytics_zoo_torch.observability import tsdb
        store = tsdb.SeriesStore.from_run_dir(run_dir)
        for key, pts in store.gauge_points("serving_breaker_state").items():
            prev = 0.0
            for t, v in pts:
                if v >= 2.0 > prev:
                    tsdb_breaker_opens.append(
                        {"series": key, "t": float(t)})
                prev = v
    except Exception:   # noqa: BLE001 — corroboration only
        pass

    return {
        "run_dir": run_dir,
        "events": events,
        "journals": [{"stream": s, "path": p} for s, p in journals],
        "torn_streams": torn,
        "cluster": cluster,
        "degraded": degraded,
        "supervisor": supervisor,
        "respawns": respawns,
        "heartbeats": heartbeats,
        "heartbeat_gaps": gaps,
        "blackboxes": blackboxes,
        "bad_traces": bad_traces,
        "slo_transitions": slo_transitions,
        "tsdb_breaker_opens": tsdb_breaker_opens,
        "t_start": t_start,
        "t_end": t_end or None,
        "stale_after_s": stale_after_s,
    }


# ----------------------------------------------------------- timeline
def _event_summary(ev: Dict[str, Any]) -> str:
    d = ev.get("d") or {}
    bits = ", ".join(f"{k}={d[k]}" for k in sorted(d))
    return f"{ev.get('kind')}({bits})" if bits else str(ev.get("kind"))


def build_timeline(ctx: Dict[str, Any]) -> List[Dict[str, Any]]:
    """Fold events + derived observations into one causally-ordered
    timeline.  Event ``t`` values are wall clock; per-session clock
    anchors (the launcher contract, carried in journal headers
    and ``meta.json``) make cross-host ordering honest on multi-host
    fleets sharing an anchor."""
    entries: List[Dict[str, Any]] = []
    for ev in ctx["events"]:
        entries.append({
            "t": float(ev.get("t", 0.0)),
            "id": ev.get("id"),
            "src": ev.get("stream"),
            "kind": ev.get("kind"),
            "summary": _event_summary(ev),
            "detail": ev.get("d") or {},
        })
    for gap in ctx["heartbeat_gaps"]:
        entries.append({
            "t": float(gap["last_beat"]),
            "id": f"heartbeat:{gap['host']}",
            "src": gap["host"],
            "kind": "heartbeat.gap",
            "summary": (f"last heartbeat of {gap['host']} "
                        f"({gap['gap_s']}s before the run's end)"),
            "detail": gap,
        })
    for host, bb in sorted(ctx["blackboxes"].items()):
        entries.append({
            "t": float(bb.get("written", 0.0)),
            "id": f"blackbox:{host}",
            "src": host,
            "kind": "blackbox.written",
            "summary": (f"blackbox dump ({bb.get('reason')}) "
                        f"with {len(bb.get('events') or [])} ring events"),
            "detail": {"reason": bb.get("reason"),
                       "error": bb.get("error")},
        })
    for tr in ctx["slo_transitions"]:
        entries.append({
            "t": float(tr["t"]),
            "id": f"slo:{tr['objective']}",
            "src": "slo_report",
            "kind": "slo.transition",
            "summary": (f"SLO {tr['objective']} -> {tr['alert']}"),
            "detail": tr,
        })
    for opn in ctx["tsdb_breaker_opens"]:
        entries.append({
            "t": float(opn["t"]),
            "id": f"tsdb:{opn['series']}",
            "src": "tsdb",
            "kind": "tsdb.breaker_open",
            "summary": f"tsdb gauge {opn['series']} reached open",
            "detail": opn,
        })
    if ctx["degraded"] is not None:
        deg = ctx["degraded"]
        path = os.path.join(ctx["run_dir"], DEGRADED_FILE)
        try:
            t = os.path.getmtime(path)
        except OSError:
            t = ctx["t_end"] or 0.0
        entries.append({
            "t": float(t),
            "id": "degraded.json",
            "src": "run",
            "kind": "degraded.record",
            "summary": (f"degraded: {deg.get('component', '?')} — "
                        f"{deg.get('reason', '?')}"),
            "detail": {k: deg.get(k) for k in
                       ("component", "reason", "classification",
                        "exit_code") if k in deg},
        })
    entries.sort(key=lambda e: (e["t"], str(e["id"])))
    return entries


# ---------------------------------------------------------- diagnoser
def _ev(ctx: Dict[str, Any], kind: str,
        pred: Optional[Callable[[Dict], bool]] = None
        ) -> List[Dict[str, Any]]:
    out = []
    for ev in ctx["events"]:
        if ev.get("kind") != kind:
            continue
        if pred is not None and not pred(ev.get("d") or {}):
            continue
        out.append(ev)
    return out


def _cite(ev: Dict[str, Any], note: str) -> Dict[str, Any]:
    return {"ref": ev.get("id"), "t": float(ev.get("t", 0.0)),
            "note": note}


def rule_broker_outage(ctx: Dict[str, Any]) -> Optional[Dict[str, Any]]:
    """Fleet-wide breaker-open (± a ``serving.redis`` chaos trip, dead
    letters, tsdb corroboration) -> the broker died; restarts and
    failed requests that follow are symptoms."""
    opens = _ev(ctx, "breaker.transition",
                lambda d: str(d.get("to")) == "open")
    redis_trips = _ev(ctx, "chaos.trip",
                      lambda d: "redis" in str(d.get("site", "")))
    if not opens and not redis_trips:
        return None
    evidence = [
        _cite(ev, f"breaker opened on {ev.get('stream')} "
                  f"(failures={((ev.get('d') or {}).get('failures', '?'))})")
        for ev in opens[:6]]
    conf = 0.55 if opens else 0.30
    streams = {ev.get("stream") for ev in opens}
    if len(streams) > 1:
        conf += 0.10   # fleet-wide, not one sick replica
    first_open = min((float(e.get("t", 0.0)) for e in opens),
                     default=None)
    for trip in redis_trips:
        t = float(trip.get("t", 0.0))
        if first_open is None or abs(first_open - t) <= 5.0:
            conf += 0.25
            evidence.append(_cite(
                trip, "chaos fault fired at the broker site "
                      f"({(trip.get('d') or {}).get('site')})"))
            break
    letters = _ev(ctx, "dead_letter",
                  lambda d: d.get("reason") == "write_abandoned")
    if letters:
        conf += 0.05
        evidence.append(_cite(
            letters[0],
            f"result write abandoned ({len(letters)} dead letter(s))"))
    if ctx["tsdb_breaker_opens"]:
        conf += 0.02
        opn = ctx["tsdb_breaker_opens"][0]
        evidence.append({"ref": f"tsdb:{opn['series']}",
                         "t": opn["t"],
                         "note": "tsdb breaker gauge corroborates"})
    symptoms = []
    if first_open is not None:
        for ev in (_ev(ctx, "replica.exit") + _ev(ctx, "replica.spawn")):
            if float(ev.get("t", 0.0)) >= first_open:
                symptoms.append(ev.get("id"))
    return {
        "cause": "broker_outage",
        "title": "broker (redis transport) outage",
        "confidence": round(min(conf, 0.97), 3),
        "evidence": evidence,
        "symptoms": sorted(symptoms)[:12],
        "explanation": (
            "circuit breakers opened"
            + (" fleet-wide" if len(streams) > 1 else "")
            + (" within seconds of a chaos fault at the broker site"
               if redis_trips else "")
            + "; replica restarts and request failures after the first "
              "open are symptoms of the dead broker, not causes."),
    }


def rule_poison_record(ctx: Dict[str, Any]) -> Optional[Dict[str, Any]]:
    """A quarantined record (± poison dead letters, worker deaths per
    delivery) -> one input kept killing its worker."""
    quarantines = _ev(ctx, "quarantine")
    poison_letters = _ev(ctx, "dead_letter",
                         lambda d: d.get("reason") == "poison")
    if not quarantines and not poison_letters:
        return None
    evidence = []
    conf = 0.80 if quarantines else 0.45
    for q in quarantines[:4]:
        d = q.get("d") or {}
        evidence.append(_cite(
            q, "record quarantined after "
               f"{d.get('deliveries', '?')} deliveries "
               f"(request_id={d.get('request_id', '?')})"))
    for pl in poison_letters[:2]:
        evidence.append(_cite(pl, "poison dead letter"))
    # worker deaths between deliveries are the kill mechanism
    kills = _ev(ctx, "replica.exit",
                lambda d: str(d.get("classification", ""))
                .startswith("signal")
                or str(d.get("classification", "")).startswith("error"))
    if quarantines and kills:
        conf += 0.10
        evidence.append(_cite(
            kills[0], f"replica death per delivery "
                      f"({len(kills)} exit(s) recorded)"))
    bad = {b.get("trace_id") for b in ctx["bad_traces"]}
    cited_req = {str((q.get("d") or {}).get("request_id"))
                 for q in quarantines}
    joined = sorted(t for t in bad & cited_req if t)
    if joined:
        conf += 0.05
        evidence.append({"ref": f"trace:{joined[0]}", "t": None,
                         "note": "client-side waterfall shows the "
                                 "same request failing"})
    return {
        "cause": "poison_record",
        "title": "poison record repeatedly killing its worker",
        "confidence": round(min(conf, 0.97), 3),
        "evidence": evidence,
        "symptoms": sorted(e.get("id") for e in kills)[:12],
        "explanation": (
            "one record reached the per-record delivery cap and was "
            "quarantined to the dead-letter stream; the replica deaths "
            "before the quarantine are its kill mechanism, not an "
            "independent fleet problem."),
    }


def rule_lost_host(ctx: Dict[str, Any]) -> Optional[Dict[str, Any]]:
    """Lost-host failure class / mesh reformation / heartbeat gap ->
    a worker host vanished (preemption, kill)."""
    lost = _ev(ctx, "train.failure",
               lambda d: str(d.get("classification")) == "lost_host")
    reforms = _ev(ctx, "mesh.reform")
    gaps = ctx["heartbeat_gaps"]
    kill_trips = _ev(ctx, "chaos.trip",
                     lambda d: str(d.get("kind")) in
                     ("lose_host", "kill"))
    steals = _ev(ctx, "lease.steal")
    if not (lost or reforms or gaps or kill_trips):
        return None
    conf = 0.0
    evidence = []
    if lost:
        conf += 0.60
        evidence.extend(_cite(
            ev, "step failure classified lost_host "
                f"({(ev.get('d') or {}).get('error', '')})".strip())
            for ev in lost[:3])
    if reforms:
        conf += 0.20 if lost else 0.50
        d = reforms[0].get("d") or {}
        evidence.append(_cite(
            reforms[0],
            f"mesh re-formed on the survivors "
            f"({d.get('old_devices', '?')} -> "
            f"{d.get('new_devices', '?')} devices)"))
    if gaps:
        conf += 0.10
        g = gaps[0]
        evidence.append({
            "ref": f"heartbeat:{g['host']}", "t": g["last_beat"],
            "note": f"{g['host']} heartbeat went silent "
                    f"{g['gap_s']}s before the run's end"})
    if kill_trips:
        conf += 0.10
        evidence.append(_cite(
            kill_trips[0], "chaos fault of the host-loss kind fired "
                           f"({(kill_trips[0].get('d') or {}).get('site')})"))
    if steals and not (lost or reforms):
        conf += 0.10
        evidence.append(_cite(
            steals[0], "expired shard lease stolen from the dead "
                       "owner (recompute debt paid)"))
    return {
        "cause": "lost_host",
        "title": "lost worker host (preemption / kill)",
        "confidence": round(min(conf, 0.97), 3),
        "evidence": evidence,
        "symptoms": sorted(e.get("id") for e in
                           _ev(ctx, "worker.respawn"))[:12],
        "explanation": (
            "a worker host disappeared mid-run; the mesh reformation / "
            "lease steals / respawns that follow are the platform "
            "absorbing the loss, not independent failures."),
    }


def rule_training_numerics(ctx: Dict[str, Any]
                           ) -> Optional[Dict[str, Any]]:
    """Watchdog nonfinite/divergence episodes -> training numerics
    (bad step, data, or LR), not infrastructure."""
    hard = _ev(ctx, "watchdog.episode",
               lambda d: str(d.get("issue")) in
               ("nonfinite", "divergence"))
    soft = _ev(ctx, "watchdog.episode",
               lambda d: str(d.get("issue")) in
               ("plateau", "stall", "drift"))
    if not hard and not soft:
        return None
    conf = 0.65 if hard else 0.40
    evidence = [_cite(ev, f"watchdog flagged "
                          f"{(ev.get('d') or {}).get('issue')}")
                for ev in (hard or soft)[:4]]
    if hard and _ev(ctx, "train.degraded"):
        conf += 0.10
        evidence.append(_cite(_ev(ctx, "train.degraded")[0],
                              "the run degraded after the episode"))
    return {
        "cause": "training_numerics",
        "title": "training numerics episode (watchdog)",
        "confidence": round(min(conf, 0.97), 3),
        "evidence": evidence,
        "symptoms": [],
        "explanation": (
            "the training watchdog flagged numerics-level episodes; "
            "infrastructure looks healthy around them."),
    }


def rule_budget_exhausted(ctx: Dict[str, Any]
                          ) -> Optional[Dict[str, Any]]:
    """A degraded record / fleet.degraded event with no stronger
    cause: the restart budget drained.  Deliberately mid-confidence —
    when a real cause (outage, poison, lost host) exists, its rule
    outranks this one and the degradation is the symptom."""
    deg = ctx["degraded"]
    deg_events = _ev(ctx, "fleet.degraded") + _ev(ctx, "train.degraded")
    if deg is None and not deg_events:
        return None
    evidence = []
    if deg is not None:
        evidence.append({
            "ref": "degraded.json", "t": None,
            "note": f"{deg.get('component', '?')}: "
                    f"{deg.get('reason', '?')} "
                    f"(classification="
                    f"{deg.get('classification', '?')})"})
    evidence.extend(_cite(ev, "degradation recorded")
                    for ev in deg_events[:2])
    return {
        "cause": "restart_budget_exhausted",
        "title": "restart budget exhausted (degraded exit)",
        "confidence": 0.50,
        "evidence": evidence,
        "symptoms": [],
        "explanation": (
            "the run ended through the degraded path; if another "
            "hypothesis ranks above this one, the budget drain is that "
            "cause's symptom."),
    }


RULES: List[Tuple[str, Callable[[Dict[str, Any]],
                                Optional[Dict[str, Any]]]]] = [
    ("broker_outage", rule_broker_outage),
    ("poison_record", rule_poison_record),
    ("lost_host", rule_lost_host),
    ("training_numerics", rule_training_numerics),
    ("restart_budget_exhausted", rule_budget_exhausted),
]


# ------------------------------------------------------------ diagnose
def diagnose(run_dir: str, *,
             stale_after_s: float = 10.0,
             max_timeline: int = 400) -> Dict[str, Any]:
    """Gather, join, diagnose: the whole engine in one call.  Returns
    the ``incident.json`` document (not yet written)."""
    ctx = gather(run_dir, stale_after_s=stale_after_s)
    timeline = build_timeline(ctx)
    hypotheses = []
    for _name, rule in RULES:
        try:
            hyp = rule(ctx)
        except Exception:   # noqa: BLE001 — one bad rule, not the report
            hyp = None
        if hyp is not None:
            hypotheses.append(hyp)
    hypotheses.sort(key=lambda h: (-h["confidence"], h["cause"]))
    for rank, hyp in enumerate(hypotheses, start=1):
        hyp["rank"] = rank
    identified = bool(hypotheses) and \
        hypotheses[0]["confidence"] >= ROOT_CAUSE_THRESHOLD
    truncated = max(0, len(timeline) - max_timeline)
    return {
        "incident_schema": INCIDENT_SCHEMA,
        "run_dir": os.path.abspath(run_dir),
        "generated_unix": time.time(),
        "window": {"t_start": ctx["t_start"], "t_end": ctx["t_end"]},
        "identified": identified,
        "root_cause": hypotheses[0]["cause"] if identified else None,
        "hypotheses": hypotheses,
        "timeline": timeline[-max_timeline:],
        "timeline_truncated": truncated,
        "artifacts": {
            "journals": [j["stream"] for j in ctx["journals"]],
            "torn_streams": ctx["torn_streams"],
            "events": len(ctx["events"]),
            "heartbeats": len(ctx["heartbeats"]),
            "heartbeat_gaps": len(ctx["heartbeat_gaps"]),
            "blackboxes": sorted(ctx["blackboxes"]),
            "degraded": ctx["degraded"] is not None,
            "supervisor_log": ctx["supervisor"] is not None,
            "respawn_log": ctx["respawns"] is not None,
            "slo_transitions": len(ctx["slo_transitions"]),
            "bad_traces": len(ctx["bad_traces"]),
        },
    }


def write_incident(run_dir: str, out_path: Optional[str] = None,
                   **kw: Any) -> Tuple[Dict[str, Any], str]:
    """Diagnose and persist ``incident.json`` (atomic
    write-then-rename, like every other run-dir artifact)."""
    doc = diagnose(run_dir, **kw)
    path = out_path or os.path.join(run_dir, INCIDENT_FILENAME)
    # hand-rolled atomic write, as the reference's: the bytes are its
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(doc, f, indent=2, sort_keys=True)
    os.replace(tmp, path)
    return doc, path


# -------------------------------------------------------------- render
def render_incident(doc: Dict[str, Any], *,
                    timeline_tail: int = 20) -> str:
    """Human-readable report — shared by ``zoo-doctor`` and
    ``obs_report --incident``."""
    lines: List[str] = []
    arts = doc.get("artifacts", {})
    lines.append("== Incident report ==")
    lines.append(f"run dir: {doc.get('run_dir')}")
    lines.append(
        "evidence: "
        f"{arts.get('events', 0)} event(s) across "
        f"{len(arts.get('journals', []))} journal(s)"
        + (f" (torn tail: {', '.join(arts['torn_streams'])})"
           if arts.get("torn_streams") else "")
        + f", {arts.get('heartbeats', 0)} heartbeat(s) "
        f"({arts.get('heartbeat_gaps', 0)} gap(s)), "
        f"{len(arts.get('blackboxes', []))} blackbox(es), "
        f"degraded={'yes' if arts.get('degraded') else 'no'}, "
        f"{arts.get('slo_transitions', 0)} SLO transition(s)")
    lines.append("")
    hyps = doc.get("hypotheses", [])
    if not hyps:
        lines.append("no hypothesis: the run dir carries no failure "
                     "evidence (nothing to diagnose, or nothing was "
                     "recorded).")
    else:
        lines.append("-- Ranked root-cause hypotheses --")
        for hyp in hyps:
            mark = "*" if hyp.get("rank") == 1 and \
                doc.get("identified") else " "
            lines.append(
                f"{mark}#{hyp.get('rank')} "
                f"[{hyp.get('confidence'):.2f}] "
                f"{hyp.get('cause')}: {hyp.get('title')}")
            for ev in hyp.get("evidence", []):
                lines.append(f"      evidence: {ev.get('ref')} — "
                             f"{ev.get('note')}")
            if hyp.get("symptoms"):
                lines.append("      symptoms: "
                             + ", ".join(hyp["symptoms"][:8])
                             + (" …" if len(hyp["symptoms"]) > 8
                                else ""))
            lines.append(f"      {hyp.get('explanation')}")
        lines.append("")
        if doc.get("identified"):
            lines.append(f"ROOT CAUSE: {doc.get('root_cause')} "
                         f"(confidence "
                         f"{hyps[0].get('confidence'):.2f})")
        else:
            lines.append("ROOT CAUSE: not identified (best hypothesis "
                         "below the "
                         f"{ROOT_CAUSE_THRESHOLD:.2f} threshold)")
    timeline = doc.get("timeline", [])
    if timeline:
        lines.append("")
        lines.append(f"-- Timeline (last {min(timeline_tail, len(timeline))} "
                     f"of {len(timeline) + doc.get('timeline_truncated', 0)}"
                     " entries) --")
        t0 = doc.get("window", {}).get("t_start") or \
            timeline[0].get("t", 0.0)
        for entry in timeline[-timeline_tail:]:
            dt = float(entry.get("t", 0.0)) - float(t0)
            lines.append(f"  +{dt:8.3f}s {entry.get('id'):<24} "
                         f"{entry.get('summary')}")
    return "\n".join(lines)
