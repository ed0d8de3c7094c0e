"""``zoo-loadtest`` — run a canned adversarial scenario against a
serving worker and print/write the SLO verdict + capacity report.

Self-contained mode (default): spins an in-process ``ClusterServing``
worker (embedded broker, numpy delay model) and storms it — the
one-command smoke an operator runs to sanity-check the harness and
produce a capacity-planning JSON on any machine.  Scenario events
script the in-process chaos sites (a ``broker_outage`` window arms
``serving.redis``; the breaker opens, fast-fails, recovers).

``--redis-url``/``--http-url`` target an EXTERNAL worker or fleet
instead (autoscaler checks are skipped — the supervisor's trajectory
is not visible from outside; the fleet acceptance test in
``tests/test_loadgen_fleet.py`` runs the full join).

Exit code: 0 when the verdict passes, 1 when it fails, 2 on usage
errors — so CI can gate on the storm directly.
"""

from __future__ import annotations

import argparse
import sys
import threading
import time

import numpy as np


class DelayModel:
    """Numpy stand-in model: ``predict_delay`` seconds of simulated
    device time per batch; poison payloads (>1e8) raise — the
    in-process containment class (error results, never a crash; the
    process-killing poison class needs the real fleet test)."""

    def __init__(self, predict_delay: float = 0.0):
        self.predict_delay = float(predict_delay)

    def predict(self, x, batch_size=None):
        x = np.asarray(x, dtype=np.float32)
        if np.any(np.abs(x) > 1e8):
            raise ValueError("poison payload rejected")
        if self.predict_delay > 0:
            time.sleep(self.predict_delay)
        return np.tile(np.arange(4, dtype=np.float32), (len(x), 1))


def _self_contained_worker(args):
    """(serving, broker, worker_thread) — an in-process worker shaped
    like one replica of the production fleet."""
    from analytics_zoo_torch.serving.redis_client import EmbeddedBroker
    from analytics_zoo_torch.serving.server import (
        ClusterServing, ServingConfig)
    broker = EmbeddedBroker()
    cfg = ServingConfig(
        batch_size=args.batch_size,
        consumer_group="loadtest", consumer_name="w0",
        request_deadline_ms=args.deadline_ms,
        healthz_max_queue=args.healthz_max_queue or None,
        breaker_failures=3, breaker_cooldown_s=0.2,
        reclaim_min_idle_ms=500,
        http_port=0 if args.http else None,
        metrics_host="127.0.0.1")
    serving = ClusterServing(DelayModel(args.predict_delay), cfg,
                             broker=broker)
    t = threading.Thread(target=serving.run, kwargs={"poll_ms": 10},
                         daemon=True)
    t.start()
    return serving, broker, t


def _write_slo_report(path, run, scenario, verdict) -> None:
    """slo_report.json: the declarative objectives, their verdict
    checks, and the full replayed burn/budget timeline — what the CI
    storm stage archives beside capacity_report.json and
    ``obs_report --slo`` renders."""
    import json
    from analytics_zoo_torch.observability.slo import evaluate_timeline
    from analytics_zoo_torch.serving.loadgen.verdict import \
        run_series_store
    store = run_series_store(run)
    timeline = evaluate_timeline(store, scenario.objectives)
    doc = {
        "kind": "zoo_slo_report",
        "scenario": scenario.name,
        "objectives": [o.name for o in scenario.objectives],
        "checks": [c.to_dict() for c in verdict.checks
                   if c.name.startswith("slo:")],
        "timeline": [[s.to_dict() for s in row] for row in timeline],
    }
    with open(path, "w") as f:
        json.dump(doc, f, indent=2)


def main(argv=None) -> int:
    from analytics_zoo_torch.serving.loadgen import (
        SCENARIOS, evaluate, read_dead_letters, report_document,
        run_scenario, write_report)
    from analytics_zoo_torch.serving.loadgen.verdict import \
        pending_count
    from analytics_zoo_torch.serving.loadgen.loadgen import \
        PayloadFactory

    ap = argparse.ArgumentParser(
        prog="zoo-loadtest",
        description="open-loop adversarial traffic scenarios with an "
                    "SLO verdict and a capacity-planning report")
    ap.add_argument("scenario", choices=sorted(SCENARIOS),
                    help="canned scenario to run")
    ap.add_argument("--compress", type=float, default=1.0,
                    help="duration compression factor (rates stay "
                         "absolute; 0.5 = half as long)")
    ap.add_argument("--out", default=None,
                    help="write the verdict + capacity-planning JSON "
                         "here (render with scripts/obs_report.py)")
    ap.add_argument("--records-out", default=None,
                    help="write the per-request structured log "
                         "(JSONL) here")
    ap.add_argument("--requests-out", default=None,
                    help="export the request log's station timelines "
                         "(requests.json) here; self-contained mode "
                         "captures client AND server stations in one "
                         "process — render with scripts/obs_report.py "
                         "--requests")
    ap.add_argument("--redis-url", default=None,
                    help="target an external broker instead of the "
                         "self-contained worker")
    ap.add_argument("--http-url", default=None,
                    help="external HTTP fast-path base URL")
    ap.add_argument("--http", action="store_true",
                    help="self-contained mode: open the HTTP fast "
                         "path and route the scenario over it")
    ap.add_argument("--batch-size", type=int, default=4)
    ap.add_argument("--predict-delay", type=float, default=0.02,
                    help="self-contained model seconds per batch")
    ap.add_argument("--deadline-ms", type=int, default=2000,
                    help="worker request_deadline_ms (self-contained)")
    ap.add_argument("--healthz-max-queue", type=int, default=64)
    ap.add_argument("--result-timeout-s", type=float, default=30.0)
    ap.add_argument("--p99-ms", type=float, default=None,
                    help="override the scenario's p99-from-scheduled "
                         "SLO bound")
    ap.add_argument("--slo-spec", default=None,
                    help="YAML file of declarative SLO objectives "
                         "(slo.yaml); each becomes an slo:<name> "
                         "verdict check evaluated over the recorded "
                         "run with the production burn-rate math")
    ap.add_argument("--slo-scale", type=float, default=None,
                    help="scale every --slo-spec time window by this "
                         "factor (compressed storms reuse production "
                         "specs; default: the --compress factor)")
    ap.add_argument("--slo-out", default=None,
                    help="write the evaluated SLO statuses + burn "
                         "timeline JSON here (slo_report.json)")
    ap.add_argument("--run-dir", default=None,
                    help="attach the black-box flight recorder here: "
                         "breaker transitions, dead letters, "
                         "quarantines and chaos trips from the storm "
                         "spool to <dir>/host-0/events.jsonl — the "
                         "evidence `scripts/zoo-doctor <dir>` "
                         "diagnoses afterwards")
    ap.add_argument("--seed", type=int, default=None)
    args = ap.parse_args(argv)

    if args.run_dir:
        import os
        from analytics_zoo_torch.observability import flightrec
        flightrec.init_flightrec(
            os.path.join(args.run_dir, "host-0"), process_index=0,
            install_hooks=False)
        print(f"flight recorder attached to {args.run_dir}",
              flush=True)

    builder = SCENARIOS[args.scenario]
    kwargs = {}
    if args.seed is not None:
        kwargs["seed"] = args.seed
    # the scenario must ride the transport the target actually
    # exposes: --http (self-contained) or an external --http-url with
    # no broker both mean the HTTP fast path carries the traffic
    if args.http or (args.http_url and not args.redis_url):
        kwargs["transport"] = "http"
    scenario = builder(**kwargs)
    if args.p99_ms is not None:
        scenario.slo.p99_from_scheduled_ms = float(args.p99_ms)
    scenario.slo.request_deadline_ms = float(args.deadline_ms)
    if args.slo_spec:
        from analytics_zoo_torch.observability.slo import load_slo_yaml
        scale = (args.slo_scale if args.slo_scale is not None
                 else args.compress)
        scenario.objectives = [
            obj.scaled(scale) if scale != 1.0 else obj
            for obj in load_slo_yaml(args.slo_spec)]
        print(f"zoo-loadtest: {len(scenario.objectives)} SLO "
              f"objective(s) from {args.slo_spec} "
              f"(windows scaled x{scale:g})", flush=True)

    serving = worker_thread = None
    external = args.redis_url or args.http_url
    if external:
        from analytics_zoo_torch.serving.redis_client import connect
        broker_factory = ((lambda: connect(args.redis_url))
                          if args.redis_url else None)
        broker = connect(args.redis_url) if args.redis_url else None
        http_url = args.http_url
    else:
        serving, broker, worker_thread = _self_contained_worker(args)
        broker_factory = lambda: broker     # noqa: E731 — embedded
        http_url = (f"http://127.0.0.1:"
                    f"{serving.http_transport.port}"
                    if serving.http_transport else None)

    print(f"zoo-loadtest: scenario={args.scenario} "
          f"compress={args.compress} duration="
          f"{scenario.duration_s(args.compress):.1f}s "
          f"target={'external' if external else 'self-contained'}",
          flush=True)
    try:
        run = run_scenario(
            scenario, compress=args.compress,
            broker_factory=broker_factory, http_url=http_url,
            payloads=PayloadFactory(shape=(4,)),
            result_timeout_s=args.result_timeout_s)
        pending = 0
        dead = []
        if broker is not None:
            # results are visible BEFORE the worker acks the batch —
            # poll the PEL down instead of reading a transient depth
            group = "loadtest" if not external else "serving"
            deadline = time.monotonic() + 5.0
            while pending_count(broker, group=group) \
                    and time.monotonic() < deadline:
                time.sleep(0.1)
            dead = read_dead_letters(broker)
            pending = pending_count(broker, group=group)
        burst = None
        try:
            burst = scenario.phase_window("burst",
                                          args.compress)[0]
        except KeyError:
            pass
        verdict = evaluate(run, scenario.slo, dead_letters=dead,
                           pending=pending,
                           burst_start_offset_s=burst,
                           objectives=scenario.objectives)
        print(verdict.render(), flush=True)
        if args.slo_out:
            _write_slo_report(args.slo_out, run, scenario, verdict)
            print(f"slo report written to {args.slo_out}", flush=True)
        cap = verdict.capacity or {}
        if cap.get("rps_per_replica_at_slo"):
            print(f"capacity: {cap['rps_per_replica_at_slo']:.1f} "
                  f"req/s per replica at p99<="
                  f"{cap['target_p99_ms']:.0f}ms; replicas needed: "
                  + "  ".join(f"{k}rps->{v}" for k, v in
                              cap["replicas_for"].items()),
                  flush=True)
        if args.records_out:
            run.to_jsonl(args.records_out)
        if args.requests_out:
            from analytics_zoo_torch.observability.reqtrace import \
                get_request_log
            get_request_log().export(args.requests_out)
            print(f"request timelines written to {args.requests_out}",
                  flush=True)
        if args.out:
            write_report(args.out, report_document(
                args.scenario, verdict, slo=scenario.slo,
                compress=args.compress,
                extra={"duration_s": round(run.wall_s, 2)}))
            print(f"report written to {args.out}", flush=True)
        return 0 if verdict.passed else 1
    finally:
        if serving is not None:
            serving.stop()
        if worker_thread is not None:
            worker_thread.join(timeout=15)
        if args.run_dir:
            from analytics_zoo_torch.observability import flightrec
            rec = flightrec.get_active_flightrec()
            if rec is not None:
                rec.close()


if __name__ == "__main__":
    sys.exit(main())
