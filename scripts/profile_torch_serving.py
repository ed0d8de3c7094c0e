#!/usr/bin/env python3
"""Where a serving request's time goes in the PyTorch port, on one GPU.

Builds the transformer TextClassifier at BERT-base widths (as
``chip_smoke.py`` does: 12 blocks, hidden 768, 12 heads, FFN 3072,
512 positions, seeded random weights), serves batches of 8 sequences
through ``InferenceModel.predict``, and reports:

* per-request latency under ``ops.fused=auto`` (the CUDA kernels) and
  ``ops.fused=torch`` (their plain versions), in turns
  (torch, auto, auto, torch), host clock around calls that end on the
  host;
* a ``torch.profiler`` trace of a few kernel-path requests: device time
  by kernel, grouped into the port's kernels, matrix products and the
  rest, and the device's busy and idle share of the wall time.

With ``--cluster`` it measures Cluster Serving's front end instead: the
72 records of ``chip_smoke.py``'s phase 3b (64 stream records over TCP,
8 HTTP singles) served through ``ClusterServing`` over the same model,
in turns across four set-ups (the broker in this process as in
``chip_smoke.py``; the broker in a child process; the broker in a child
process and no HTTP singles; the same with the 64 records queued before
the loop starts) beside the same 72 records through
``InferenceModel.predict`` alone, 8 at a time; after ``warm`` of
buckets 1 and 8, the first and second predict on fresh threads beside
the main thread's; then one profiled
run of the first set-up for the device's busy and idle share.

    python3 scripts/profile_torch_serving.py [--requests N] [--out PATH]
    python3 scripts/profile_torch_serving.py --cluster [--turns N] [--out PATH]

Needs a CUDA device; with ``--out PATH`` also writes the full table as
JSON.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import threading
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

PORT_KERNELS = ("flash_fwd_kernel", "bias_gelu", "layernorm_act")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# a BrokerServer of the port in a child process: prints its host:port,
# serves until its stdin closes
BROKER_CHILD = (
    "import sys\n"
    f"sys.path.insert(0, {REPO!r})\n"
    "from analytics_zoo_torch.serving.redis_client import (\n"
    "    BrokerServer, EmbeddedBroker)\n"
    "srv = BrokerServer(EmbeddedBroker())\n"
    "print(srv.url, flush=True)\n"
    "sys.stdin.read()\n"
    "srv.stop()\n")


def _group(name: str) -> str:
    low = name.lower()
    if any(k in low for k in PORT_KERNELS):
        return "port kernels"
    if any(k in low for k in ("gemm", "cutlass", "sm90_xmma", "nvjet", "cublas")):
        return "matrix products"
    return "other"


def _device_busy_ms(torch, prof) -> float:
    return sum(getattr(evt, "self_device_time_total",
                       getattr(evt, "self_cuda_time_total", 0))
               for evt in prof.key_averages()
               if evt.device_type == torch.autograd.DeviceType.CUDA) / 1e3


def fresh_threads(im, n_threads: int = 3) -> dict:
    """Host ms of a bucket-1 predict, again, then a bucket-8 one, on
    each of ``n_threads`` new threads in turn and on this thread (each
    predict ends on the host): what a new thread's first predict pays
    after the model was warmed."""
    rs = np.random.RandomState(2)
    one, eight = rs.randint(0, 30522, size=(1, 512)), \
        rs.randint(0, 30522, size=(8, 512))

    def timed():
        out = []
        for x in (one, one, eight):
            s = time.perf_counter()
            im.predict(x)
            out.append(round((time.perf_counter() - s) * 1e3, 3))
        return out

    result = {}
    for k in range(n_threads):
        box = []
        t = threading.Thread(target=lambda: box.append(timed()))
        t.start()
        t.join(120)
        if t.is_alive() or not box:
            sys.exit("profile_torch_serving: a predict thread did not end")
        result[f"fresh thread {k}: bucket 1, again, bucket 8"] = box[0]
    result["main thread: bucket 1, again, bucket 8"] = timed()
    return result


def cluster(torch, im, card, turns: int) -> dict:
    """Cluster Serving's front end over ``im``, in turns across its
    set-ups, beside ``predict`` alone; then one profiled run."""
    import chip_smoke

    def fail(msg):
        sys.exit(f"profile_torch_serving: {msg}")

    def run(child_broker: bool, n_singles: int, queued_first=False):
        if not child_broker:
            return chip_smoke.serve_front_end(torch, im, fail,
                                              n_singles=n_singles)
        # leaving the block closes its stdin (the child stops) and waits
        with subprocess.Popen([sys.executable, "-c", BROKER_CHILD],
                              stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                              text=True) as proc:
            url = proc.stdout.readline().strip()
            return chip_smoke.serve_front_end(
                torch, im, fail, url, n_singles=n_singles,
                queued_first=queued_first)

    def direct():
        rs = np.random.RandomState(1)     # the same 72 records
        x = np.concatenate([rs.randint(0, 30522, size=(64, 512)),
                            rs.randint(0, 30522, size=(8, 512))])
        torch.cuda.synchronize()
        s = time.perf_counter()
        im.predict(x, batch_size=8)
        return {"wall_s": time.perf_counter() - s, "n": len(x)}

    setups = {
        "broker in process, 8 HTTP": (False, 8),
        "broker in a child process, 8 HTTP": (True, 8),
        "broker in a child process, no HTTP": (True, 0),
        "broker in a child process, queued first, no HTTP": (True, 0, True),
    }
    runs = {name: [] for name in setups}
    runs["predict alone, 9 x 8"] = []
    direct()                                   # first-call setup
    # warmed as a server warms, before any serving run; then new threads
    warm_ms = []
    for b in (1, 8):
        s = time.perf_counter()
        im.warm((512,), b)
        warm_ms.append(round((time.perf_counter() - s) * 1e3, 3))
    threads = {"warm: bucket 1, bucket 8": warm_ms, **fresh_threads(im)}
    order = list(setups) + ["predict alone, 9 x 8"]
    for turn in range(turns):
        for name in (order if turn % 2 == 0 else order[::-1]):
            if name in setups:
                r = run(*setups[name])
                n = len(r["results"])
                execute_s = sum(r["execute_ms"]) * 1e-3
                runs[name].append({
                    "n": n, "wall_s": r["wall_s"],
                    "records_per_s": n / r["wall_s"],
                    "p50_ms": r["p50_ms"], "p99_ms": r["p99_ms"],
                    "batches": r["batches"],
                    "batch_records": r["batch_records"],
                    "execute_ms": r["execute_ms"],
                    "predict_span_ms": r["predict_ms"],
                    "host_ms_per_record": (r["wall_s"] - execute_s)
                    * 1e3 / n})
            else:
                d = direct()
                d["records_per_s"] = d["n"] / d["wall_s"]
                runs[name].append(d)

    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        r = run(False, 8)
        torch.cuda.synchronize()
    busy = _device_busy_ms(torch, prof)
    profiled = {"wall_ms": r["wall_s"] * 1e3, "device_busy_ms": busy,
                "device_idle_share": max(0.0, 1 - busy / (r["wall_s"] * 1e3)),
                "execute_ms": r["execute_ms"],
                "batch_records": r["batch_records"]}

    print(f"card: {card}")
    for name, rs_ in runs.items():
        med = statistics.median(x["records_per_s"] for x in rs_)
        line = (f"{name}: records/s {[round(x['records_per_s'], 2) for x in rs_]}"
                f" (median {med:.2f})")
        if name in setups:
            line += (
                f"; p50 ms {[round(x['p50_ms'], 2) for x in rs_]}, p99 ms "
                f"{[round(x['p99_ms'], 2) for x in rs_]}; host ms a record "
                f"{[round(x['host_ms_per_record'], 4) for x in rs_]}; "
                f"serving_execute ms a batch median "
                f"{[round(statistics.median(x['execute_ms']), 3) for x in rs_]}"
                f"; first batch ms "
                f"{[round(x['execute_ms'][0], 3) for x in rs_]}"
                f"; batches {[x['batches'] for x in rs_]}")
        print(line)
    for name, ms in threads.items():
        print(f"{name}: ms {ms}")
    print(f"profiled (broker in process, 8 HTTP, profiler on): wall "
          f"{profiled['wall_ms']:.3f} ms, device busy {busy:.3f} ms, idle "
          f"share {profiled['device_idle_share']:.3f}; serving_execute ms "
          f"{[round(t, 3) for t in r['execute_ms']]}")
    return {"card": card, "runs": runs, "threads": threads,
            "profiled": profiled}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--requests", type=int, default=10)
    ap.add_argument("--cluster", action="store_true",
                    help="measure Cluster Serving's front end instead")
    ap.add_argument("--turns", type=int, default=4)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        sys.exit("profile_torch_serving: needs a CUDA device")
    from analytics_zoo_torch import init_zoo_context
    from analytics_zoo_torch.common.config import get_config
    from analytics_zoo_torch.models.textclassification import TextClassifier
    from analytics_zoo_torch.pipeline.inference import InferenceModel

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    init_zoo_context(device="cuda:0")
    model = TextClassifier(class_num=20, token_length=768,
                           sequence_length=512, encoder="transformer",
                           n_head=12, n_block=12, max_words_num=30521,
                           encoder_output_dim=256)
    model.model.init(torch.Generator().manual_seed(0))
    im = InferenceModel().load_zoo(model)
    if args.cluster:
        result = cluster(torch, im, card, args.turns)
        if args.out:
            os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                        exist_ok=True)
            with open(args.out, "w") as f:
                json.dump(result, f, indent=1)
        return
    rs = np.random.RandomState(0)
    reqs = [rs.randint(0, 30522, size=(8, 512)) for _ in range(args.requests)]
    cfg = get_config()

    def serve(mode):
        cfg.set("ops.fused", mode)
        im.predict(reqs[0], batch_size=8)      # warm-up
        lat = []
        for r in reqs:
            s = time.perf_counter()
            im.predict(r, batch_size=8)
            lat.append((time.perf_counter() - s) * 1e3)
        return lat

    lat = {"torch": [], "auto": []}
    for mode in ("torch", "auto", "auto", "torch"):
        lat[mode] += serve(mode)
    cfg.set("ops.fused", "auto")
    medians = {m: statistics.median(v) for m, v in lat.items()}

    from torch.profiler import ProfilerActivity, profile
    n_prof = 3
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        s = time.perf_counter()
        for r in reqs[:n_prof]:
            im.predict(r, batch_size=8)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - s) * 1e3
    rows = []
    for evt in prof.key_averages():
        dev_us = getattr(evt, "self_device_time_total",
                         getattr(evt, "self_cuda_time_total", 0))
        if dev_us > 0 and evt.device_type == torch.autograd.DeviceType.CUDA:
            rows.append({"name": evt.key, "group": _group(evt.key),
                         "calls_per_request": evt.count / n_prof,
                         "device_ms_per_request": dev_us / 1e3 / n_prof})
    rows.sort(key=lambda r: -r["device_ms_per_request"])
    busy = sum(r["device_ms_per_request"] for r in rows)
    per_req_wall = wall_ms / n_prof
    groups = {}
    for r in rows:
        groups[r["group"]] = groups.get(r["group"], 0.0) + \
            r["device_ms_per_request"]

    result = {
        "card": card,
        "latency_ms_median": medians,
        "latency_ms": lat,
        "sequences_per_s": {m: 8e3 / v for m, v in medians.items()},
        "profiled_requests": n_prof,
        "profiled_wall_ms_per_request": per_req_wall,
        "device_busy_ms_per_request": busy,
        "device_idle_share": max(0.0, 1.0 - busy / per_req_wall),
        "device_ms_by_group": groups,
        "kernels": rows,
    }
    print(f"card: {card}")
    for m in ("auto", "torch"):
        print(f"ops.fused={m}: per-request latency median {medians[m]:.3f} ms "
              f"({8e3 / medians[m]:.1f} sequences/s) over {len(lat[m])} "
              f"requests")
    print(f"profiled (ops.fused=auto, profiler on): wall {per_req_wall:.3f} "
          f"ms/request, device busy {busy:.3f} ms/request, idle share "
          f"{result['device_idle_share']:.3f}")
    for g, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
        print(f"  {g:16s} {ms:.3f} ms/request")
    for r in rows[:15]:
        print(f"  {r['device_ms_per_request']:8.3f} ms  x{r['calls_per_request']:6.1f}"
              f"  [{r['group']}] {r['name'][:90]}")
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)


if __name__ == "__main__":
    main()
