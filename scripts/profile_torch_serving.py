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

    python3 scripts/profile_torch_serving.py [--requests N] [--out PATH]

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
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

PORT_KERNELS = ("flash_fwd_kernel", "bias_gelu", "layernorm_act")


def _group(name: str) -> str:
    low = name.lower()
    if any(k in low for k in PORT_KERNELS):
        return "port kernels"
    if any(k in low for k in ("gemm", "cutlass", "sm90_xmma", "nvjet", "cublas")):
        return "matrix products"
    return "other"


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--requests", type=int, default=10)
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
