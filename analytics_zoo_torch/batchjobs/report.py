"""Job-end capacity/cost report + shard-progress rendering (port of the
JAX package's ``batchjobs/report.py``: the same keys and text).

The batch twin of the serving loadgen verdict's capacity section: where
serving answers "replicas needed at a target p99", batch answers
"chips needed at a target deadline".  Built entirely from the job
ledger (manifest + commit markers + live leases) so it can be rendered
offline by the CLI's ``report`` long after the fleet is gone.

Shape (mirrors ``serving.loadgen.verdict.capacity_report``):

* measured throughput → ``rows_per_sec_per_chip`` (the headline of
  the reference's ``batch_scoring`` benchmark);
* a ``chips_for`` table keyed by deadline seconds — ``ceil(rows /
  (rows_per_sec_per_chip * deadline))`` — the deployment-sizing
  artifact CI archives;
* a ``resume`` block: recomputed rows, duplicate commit races, and
  the resume-overhead fraction the kill-and-resume acceptance bounds
  (< 1 shard of recompute per preemption).

CONTRACT: stdlib-only (``python -m analytics_zoo_torch.batchjobs.cli
report RUN_DIR`` renders a ledger without importing torch).
"""

from __future__ import annotations

import json
import math
import os
from typing import Any, Dict, List, Optional

from . import spec as _spec
from .manifest import ShardManifest, read_commits, read_leases

__all__ = ["build_report", "render_report", "render_shard_table",
           "load_report", "render_job_section"]


def _deadline_ladder(target_s: float) -> List[float]:
    """target plus the neighbouring rungs — the "what if the deadline
    halves" question answered in the same artifact."""
    rungs = sorted({target_s * m for m in (0.25, 0.5, 1.0, 2.0, 4.0)})
    return [r for r in rungs if r > 0]


def build_report(run_dir: str, *, num_chips: int,
                 elapsed_s: float, status: str = "complete",
                 restarts: int = 0) -> Dict[str, Any]:
    """Assemble the job report from the ledger and persist it as
    ``<run_dir>/job/report.json``."""
    job = _spec.BatchJobSpec.load(run_dir)
    manifest = ShardManifest.load(run_dir)
    progress = manifest.progress()
    commits = read_commits(run_dir)

    rows = progress["rows_committed"]
    recomputed = progress["rows_recomputed"]
    rows_per_sec = rows / elapsed_s if elapsed_s > 0 else 0.0
    per_chip = rows_per_sec / num_chips if num_chips else 0.0

    per_host: Dict[str, Dict[str, float]] = {}
    for m in commits:
        host = str(m.get("owner", "?")).split(":")[0]
        h = per_host.setdefault(
            host, {"shards": 0, "rows": 0, "seconds": 0.0})
        h["shards"] += 1
        h["rows"] += int(m.get("rows", 0))
        h["seconds"] += float(m.get("seconds", 0.0))

    # straggler: the host whose mean shard time most exceeds the
    # fleet mean (same spirit as observability.straggler_report, but
    # computable from the ledger alone)
    straggler = None
    means = {h: v["seconds"] / v["shards"]
             for h, v in per_host.items() if v["shards"]}
    if len(means) > 1:
        fleet_mean = sum(means.values()) / len(means)
        worst = max(means, key=lambda h: means[h])
        if fleet_mean > 0 and means[worst] > 1.5 * fleet_mean:
            straggler = {"host": worst,
                         "mean_shard_s": round(means[worst], 4),
                         "fleet_mean_shard_s": round(fleet_mean, 4)}

    target = float(job.target_deadline_s)
    chips_for = {}
    if per_chip > 0:
        total_rows = progress["rows_total"]
        for d in _deadline_ladder(target):
            chips_for[f"{d:g}"] = int(
                math.ceil(total_rows / (per_chip * d)))

    report = {
        "job": job.name,
        "status": status,
        "num_chips": int(num_chips),
        "restarts": int(restarts),
        "elapsed_s": round(float(elapsed_s), 4),
        "rows_total": progress["rows_total"],
        "rows_committed": rows,
        "shards_total": progress["shards_total"],
        "shards_committed": progress["shards_committed"],
        "rows_per_sec": round(rows_per_sec, 4),
        "rows_per_sec_per_chip": round(per_chip, 4),
        "target_deadline_s": target,
        # job-level SLO: the deadline is the batch plane's
        # objective; "budget remaining" is the unspent fraction of it,
        # the same vocabulary the serving SLO engine publishes
        "slo": {
            "deadline_met": (bool(elapsed_s <= target)
                             if target > 0 else None),
            "deadline_budget_remaining": (
                round(1.0 - float(elapsed_s) / target, 4)
                if target > 0 else None),
        },
        "chips_for": chips_for,
        "resume": {
            "rows_recomputed": recomputed,
            "duplicate_commits": progress["duplicates"],
            "resume_overhead_fraction": round(
                recomputed / rows, 6) if rows else 0.0,
        },
        "per_host": per_host,
        "straggler": straggler,
    }
    out = os.path.join(_spec.job_dir(run_dir), _spec.REPORT_FILE)
    # hand-rolled atomic write: a stdlib-only module (same carve-out as
    # manifest.py)
    tmp = f"{out}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(report, f, indent=2, sort_keys=True)
    os.replace(tmp, out)
    return report


def load_report(run_dir: str) -> Optional[Dict[str, Any]]:
    path = os.path.join(_spec.job_dir(run_dir), _spec.REPORT_FILE)
    try:
        with open(path) as f:
            return json.load(f)
    except (FileNotFoundError, json.JSONDecodeError):
        return None


# -------------------------------------------------------------- rendering
def render_shard_table(run_dir: str, max_rows: int = 40) -> str:
    """The shard progress table: one line per shard — committed (by
    whom, how fast), leased (age), or pending."""
    manifest = ShardManifest.load(run_dir)
    committed = manifest.committed()
    leases = {l["shard_id"]: l for l in read_leases(run_dir)}
    lines = [f"{'shard':>6} {'rows':>7}  state"]
    shown = 0
    for s in manifest.shards:
        if shown >= max_rows:
            lines.append(f"  ... {len(manifest.shards) - shown} more")
            break
        sid = s["shard_id"]
        rows = s["end"] - s["start"]
        if sid in committed:
            m = committed[sid]
            extra = ""
            if m.get("recomputed_rows"):
                extra = f" (+{m['recomputed_rows']} recomputed)"
            if m.get("duplicates"):
                extra += f" ({m['duplicates']} dup races)"
            lines.append(
                f"{sid:>6} {rows:>7}  COMMITTED by {m.get('owner', '?')}"
                f" in {m.get('seconds', 0.0):.2f}s{extra}")
        elif sid in leases:
            l = leases[sid]
            lines.append(
                f"{sid:>6} {rows:>7}  leased by {l.get('owner', '?')}"
                f" ({l.get('rows_done', 0)}/{rows} rows)")
        else:
            lines.append(f"{sid:>6} {rows:>7}  pending")
        shown += 1
    return "\n".join(lines)


def render_report(report: Dict[str, Any]) -> str:
    lines = []
    lines.append(f"batch job: {report['job']}  [{report['status']}]")
    lines.append(
        f"  shards {report['shards_committed']}/{report['shards_total']}"
        f"  rows {report['rows_committed']}/{report['rows_total']}"
        f"  elapsed {report['elapsed_s']:.2f}s"
        f"  restarts {report['restarts']}")
    lines.append(
        f"  throughput: {report['rows_per_sec']:.1f} rows/s"
        f" on {report['num_chips']} chip(s)"
        f" = {report['rows_per_sec_per_chip']:.1f} rows/s/chip")
    slo = report.get("slo") or {}
    if slo.get("deadline_met") is not None:
        lines.append(
            f"  job SLO: deadline {report['target_deadline_s']:g}s — "
            + (f"MET with {100 * slo['deadline_budget_remaining']:.0f}%"
               f" budget remaining" if slo["deadline_met"]
               else f"MISSED by "
                    f"{-100 * slo['deadline_budget_remaining']:.0f}%"
                    f" of the deadline"))
    res = report.get("resume", {})
    lines.append(
        f"  resume overhead: {res.get('rows_recomputed', 0)} rows"
        f" recomputed ({100 * res.get('resume_overhead_fraction', 0.0):.2f}%),"
        f" {res.get('duplicate_commits', 0)} duplicate commit race(s)")
    if report.get("chips_for"):
        lines.append(
            f"  capacity at target deadline"
            f" {report['target_deadline_s']:g}s:")
        for d in sorted(report["chips_for"], key=float):
            mark = " <- target" if float(d) == float(
                report["target_deadline_s"]) else ""
            lines.append(
                f"    finish in {float(d):>10g}s: "
                f"{report['chips_for'][d]:>4} chip(s){mark}")
    per_host = report.get("per_host") or {}
    if per_host:
        lines.append("  per-host:")
        for h in sorted(per_host):
            v = per_host[h]
            lines.append(
                f"    {h}: {v['shards']} shard(s), {v['rows']} rows,"
                f" {v['seconds']:.2f}s scoring")
    s = report.get("straggler")
    if s:
        lines.append(
            f"  STRAGGLER: {s['host']} mean shard"
            f" {s['mean_shard_s']:.2f}s vs fleet"
            f" {s['fleet_mean_shard_s']:.2f}s")
    return "\n".join(lines)


def render_job_section(run_dir: str) -> str:
    """The CLI's ``report RUN_DIR`` section: progress table +
    (when the job has ended) the capacity/cost report."""
    parts = [f"batch job ledger: {run_dir}", ""]
    parts.append(render_shard_table(run_dir))
    report = load_report(run_dir)
    if report is not None:
        parts.append("")
        parts.append(render_report(report))
    else:
        manifest = ShardManifest.load(run_dir)
        p = manifest.progress()
        parts.append("")
        parts.append(
            f"job still running: {p['shards_committed']}/"
            f"{p['shards_total']} shards committed"
            f" ({p['rows_committed']}/{p['rows_total']} rows)")
    return "\n".join(parts)
