"""Run, demo, and report offline batch scoring jobs (port of the JAX
package's ``batchjobs/cli.py``)::

    python -m analytics_zoo_torch.batchjobs.cli run --spec job.json \
        --run-dir RUN --workers 4
    python -m analytics_zoo_torch.batchjobs.cli demo --run-dir RUN \
        --output-dir OUT --report-out cap.json [--keras]
    python -m analytics_zoo_torch.batchjobs.cli report RUN   # no torch

``run``/``demo`` exit 0 on a complete ledger and speak the launcher's
degraded protocol on restart-budget exhaustion: the structured record
prints as one JSON line and the process exits
:data:`~analytics_zoo_torch.resilience.policy.DEGRADED_EXIT_CODE` (17)
— CI can tell "the fleet died of preemption pressure" from "the job
has a bug" by exit code alone.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys


def _finish(report: dict, run_dir: str, report_out: str = None) -> int:
    from . import report as report_lib
    from .spec import job_dir, REPORT_FILE
    print(report_lib.render_report(report))
    src = os.path.join(job_dir(run_dir), REPORT_FILE)
    if report_out:
        shutil.copyfile(src, report_out)
        print(f"capacity report -> {report_out}")
    return 0 if report.get("status") == "complete" else 1


def cmd_run(args) -> int:
    from .coordinator import run_job
    from .spec import BatchJobSpec
    with open(args.spec) as f:
        job = BatchJobSpec.from_dict(json.load(f))
    report = run_job(job, args.run_dir, num_workers=args.workers,
                     timeout_s=args.timeout)
    return _finish(report, args.run_dir, args.report_out)


def cmd_demo(args) -> int:
    from .coordinator import run_job
    from .demo import demo_job
    job = demo_job(args.output_dir, num_rows=args.rows,
                   rows_per_shard=args.rows_per_shard,
                   batch_size=args.batch_size, keras=args.keras)
    report = run_job(job, args.run_dir, num_workers=args.workers,
                     timeout_s=args.timeout)
    return _finish(report, args.run_dir, args.report_out)


def cmd_report(args) -> int:
    # stdlib only: the ledger renders on a node without torch
    from . import report as report_lib
    print(report_lib.render_job_section(args.run_dir))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m analytics_zoo_torch.batchjobs.cli",
        description="distributed offline batch scoring (docs/batch.md)")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p_run = sub.add_parser("run", help="run a job from a spec JSON")
    p_run.add_argument("--spec", required=True,
                       help="BatchJobSpec JSON file")
    p_run.add_argument("--run-dir", required=True)
    p_run.add_argument("--workers", type=int, default=1)
    p_run.add_argument("--timeout", type=float, default=None)
    p_run.add_argument("--report-out", default=None,
                       help="also copy the capacity report JSON here")
    p_run.set_defaults(fn=cmd_run)

    p_demo = sub.add_parser(
        "demo", help="run the canned demo job end to end")
    p_demo.add_argument("--run-dir", required=True)
    p_demo.add_argument("--output-dir", required=True)
    p_demo.add_argument("--workers", type=int, default=2)
    p_demo.add_argument("--rows", type=int, default=1024)
    p_demo.add_argument("--rows-per-shard", type=int, default=128)
    p_demo.add_argument("--batch-size", type=int, default=32)
    p_demo.add_argument("--keras", action="store_true",
                        help="score through a KerasNet behind "
                             "InferenceModel (warms through the run-dir "
                             "compile farm) instead of the numpy "
                             "stand-in")
    p_demo.add_argument("--timeout", type=float, default=300.0)
    p_demo.add_argument("--report-out", default=None)
    p_demo.set_defaults(fn=cmd_demo)

    p_rep = sub.add_parser("report",
                           help="render a job ledger + capacity report")
    p_rep.add_argument("run_dir")
    p_rep.set_defaults(fn=cmd_report)

    args = ap.parse_args(argv)
    from analytics_zoo_torch.resilience.policy import degraded_exit
    with degraded_exit(stream=sys.stderr):
        return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
