"""``zoo-launch`` CLI: spawn an N-process ``torch.distributed`` job on
this machine (port of ``parallel/launch_cli.py``; the spark-submit
launcher-script role).

Usage: ``python -m analytics_zoo_torch.parallel.launch_cli -n 4
script.py [args...]``.  Each worker gets ZOO_TPU_COORDINATOR /
NUM_PROCESSES / PROCESS_ID and joins the process group in
``init_zoo_context()`` (NCCL on the card, gloo on the CPU): the
rendezvous the launcher leaves to each process.  ``--coordinator`` takes
``host:port`` (rank 0 serves a TCP store) or a ``file://`` path (a file
store); the default is a free local port.
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None):
    p = argparse.ArgumentParser(prog="zoo-launch")
    p.add_argument("-n", "--num-processes", type=int, default=1)
    p.add_argument("--coordinator", default=None,
                   help="host:port of process 0, or file:///path of a "
                        "file store (default: local free port)")
    p.add_argument("--timeout", type=float, default=None,
                   help="seconds to wait before killing stragglers")
    p.add_argument("--run-dir", default=None,
                   help="observability run directory: each worker "
                        "gets a host-<k>/ metrics slot + port and a "
                        "shared clock anchor; aggregate with "
                        "scripts/obs_report.py --merge-hosts")
    p.add_argument("--max-degraded", type=int, default=0,
                   help="exit 0 when at most this many workers exit "
                        "DEGRADED (code 17: checkpoint-and-queue, a "
                        "structured partial result) and the rest "
                        "exit 0")
    p.add_argument("script")
    p.add_argument("args", nargs=argparse.REMAINDER)
    args = p.parse_args(argv)

    import os
    import subprocess

    from analytics_zoo_torch.parallel.launcher import ZooCluster
    # CLI convenience (the spark-submit --py-files role): python puts
    # the SCRIPT's dir on a worker's sys.path, not the launch cwd —
    # propagate the cwd so `zoo-launch -n 4 train.py` resolves the
    # same imports the launcher shell does.  CLI-only: ZooCluster as
    # a library leaves worker import paths alone.
    env = {"PYTHONPATH": os.getcwd() + (
        os.pathsep + os.environ["PYTHONPATH"]
        if os.environ.get("PYTHONPATH") else "")}
    cluster = ZooCluster(num_processes=args.num_processes,
                         coordinator=args.coordinator,
                         run_dir=args.run_dir, env=env)
    import json

    from analytics_zoo_torch.resilience.policy import DEGRADED_EXIT_CODE
    cluster.start(args.script, args.args)
    try:
        codes = cluster.wait(timeout=args.timeout)
    except subprocess.TimeoutExpired:
        health = cluster.check_health()
        print(f"workers still running after {args.timeout}s; "
              "killing stragglers", file=sys.stderr)
        # structured record instead of a bare timeout: which host
        # died first (the cause — the rest is collective collateral)
        print(json.dumps({"status": "timeout",
                          "first_failure": health.first_death,
                          "missing": health.missing,
                          "alive": health.alive}))
        return 1
    finally:
        cluster.stop()
    degraded = [i for i, c in enumerate(codes)
                if c == DEGRADED_EXIT_CODE]
    bad = [c for c in codes if c not in (0, DEGRADED_EXIT_CODE)]
    if bad:
        print(f"workers exited with codes {list(codes)}; first "
              f"failure: {codes.first_failure}", file=sys.stderr)
        print(json.dumps({"status": "failed", "codes": list(codes),
                          "first_failure": codes.first_failure}))
        return 1
    if degraded:
        # checkpoint-and-queue workers (resilience.policy
        # DEGRADED_EXIT_CODE): a structured partial result, not a
        # crash — exit 0 within the --max-degraded budget
        within = len(degraded) <= args.max_degraded
        print(json.dumps({"status": "degraded",
                          "degraded_workers": degraded,
                          "codes": list(codes),
                          "max_degraded": args.max_degraded,
                          "within_budget": within}))
        return 0 if within else 1
    print(f"{args.num_processes} workers completed")
    if args.run_dir:
        print(f"observability run dir: {args.run_dir} — merge with "
              f"`python scripts/obs_report.py --merge-hosts "
              f"{args.run_dir}`")
    return 0


if __name__ == "__main__":
    sys.exit(main())
