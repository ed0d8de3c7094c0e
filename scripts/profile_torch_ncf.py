#!/usr/bin/env python3
"""Where a NeuralCF training step's time goes in the PyTorch port, on one
GPU.

Builds NeuralCF at the JAX bench's ML-1M width (``bench.py``
``bench_ncf``: 6040 users, 3706 items, embeddings 64, hidden
128/64/32, 2 classes, seeded random weights) on ``synthetic_ratings()``
with 4 negatives a positive, and trains it with Adam (lr 1e-3) at batch
16384 through ``DistributedTrainer.train_step_at`` under ``prefetch``,
the loop ``fit`` runs.  Reports:

* the step time (host clock over N steps that end in
  ``torch.cuda.synchronize()``) and samples/s, and the host's own time a
  step: how long the step call takes to return (the eager graph walk,
  autograd and the launches) and how long the loop waits for the next
  placed batch;
* a ``torch.profiler`` trace of N steps: device time a step by group
  (embedding gather and scatter-add, matrix products, the fused Adam
  kernel, copies, other elementwise), the fused Adam launches a step and
  their device time, the device's busy and idle share of the wall, and
  the host operators (PyTorch ops and CUDA runtime calls) by their own
  host time a step, inflated by the profiler's cost.

    python3 scripts/profile_torch_ncf.py [--steps N] [--out PATH]

Needs a CUDA device; with ``--out PATH`` also writes the full table as
JSON.
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

BATCH = 16384
GROUPS = (
    ("fused adam", ("multi_adam",)),
    ("embedding gather and scatter-add", ("index", "scatter", "gather",
                                          "embedding")),
    ("matrix products", ("gemm", "cutlass", "sm90_xmma", "nvjet", "cublas")),
    ("copies", ("memcpy", "memset")),
)


def _group(name: str) -> str:
    low = name.lower()
    for group, keys in GROUPS:
        if any(k in low for k in keys):
            return group
    return "other elementwise"


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        sys.exit("profile_torch_ncf: needs a CUDA device")
    from analytics_zoo_torch import init_zoo_context
    from analytics_zoo_torch.feature import FeatureSet
    from analytics_zoo_torch.feature.datasets import movielens
    from analytics_zoo_torch.models.recommendation import NeuralCF
    from analytics_zoo_torch.ops import kernels
    from analytics_zoo_torch.parallel.trainer import DistributedTrainer
    from analytics_zoo_torch.pipeline.api.keras import objectives
    from analytics_zoo_torch.pipeline.api.keras.optimizers import Adam
    from analytics_zoo_torch.pipeline.api.keras.topology import tree_leaves

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    init_zoo_context(device="cuda:0")
    ratings = movielens.synthetic_ratings()
    train_x, train_y, _, _ = movielens.build_ncf_samples(
        ratings, movielens.ML1M_USERS, movielens.ML1M_ITEMS, neg_per_pos=4)
    train_set = FeatureSet.from_ndarrays(train_x, train_y)
    model = NeuralCF(movielens.ML1M_USERS, movielens.ML1M_ITEMS,
                     class_num=2, user_embed=64, item_embed=64, mf_embed=64,
                     hidden_layers=(128, 64, 32))
    model.model.init(torch.Generator().manual_seed(0))
    tr = DistributedTrainer(
        model.model,
        objectives.get("sparse_categorical_crossentropy_with_logits"),
        optim_method=Adam(lr=1e-3))
    params = tr.place_params(model.get_variables()["params"])
    n_leaves = len(tree_leaves(params))
    opt_state, state = tr.init_opt_state(params), {}
    epoch_batches = train_set.epoch_batches(0, BATCH, train=True)
    step = [0]

    def run(n):
        """n steps under prefetch; returns (wall ms, host ms in the step
        calls, host ms waiting for batches), each a step."""
        nonlocal params, opt_state, state
        in_step = waiting = 0.0
        torch.cuda.synchronize()
        s0 = time.perf_counter()
        it = tr.prefetch(itertools.islice(epoch_batches, n))
        while True:
            w0 = time.perf_counter()
            b = next(it, None)
            if b is None:
                break
            t0 = time.perf_counter()
            waiting += t0 - w0
            params, opt_state, state, loss = tr.train_step_at(
                params, opt_state, state, b, 0, step[0])
            in_step += time.perf_counter() - t0
            step[0] += 1
        torch.cuda.synchronize()
        wall = time.perf_counter() - s0
        if not np.isfinite(float(loss)):
            sys.exit(f"profile_torch_ncf: loss {float(loss)}")
        return wall * 1e3 / n, in_step * 1e3 / n, waiting * 1e3 / n

    run(5)                                          # warm-up
    turns = [run(args.steps) for _ in range(3)]
    step_ms = sorted(t[0] for t in turns)[1]

    from torch.profiler import ProfilerActivity, profile
    kernels.reset_launch_counts()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        prof_wall, prof_host, prof_wait = run(args.steps)
    launches = kernels.launch_counts()["fused_adam"]
    rows = []
    for evt in prof.key_averages():
        dev_us = getattr(evt, "self_device_time_total",
                         getattr(evt, "self_cuda_time_total", 0))
        if dev_us > 0 and evt.device_type == torch.autograd.DeviceType.CUDA:
            rows.append({"name": evt.key, "group": _group(evt.key),
                         "calls_per_step": evt.count / args.steps,
                         "device_ms_per_step": dev_us / 1e3 / args.steps})
    host_rows = [{"name": evt.key, "calls_per_step": evt.count / args.steps,
                  "host_ms_per_step": evt.self_cpu_time_total / 1e3 /
                  args.steps}
                 for evt in prof.key_averages()
                 if evt.self_cpu_time_total > 0 and
                 evt.device_type == torch.autograd.DeviceType.CPU]
    host_rows.sort(key=lambda r: -r["host_ms_per_step"])
    rows.sort(key=lambda r: -r["device_ms_per_step"])
    busy = sum(r["device_ms_per_step"] for r in rows)
    groups = {}
    for r in rows:
        groups[r["group"]] = groups.get(r["group"], 0.0) + \
            r["device_ms_per_step"]
    adam = [r for r in rows if r["group"] == "fused adam"]

    result = {
        "card": card,
        "batch": BATCH,
        "leaves": n_leaves,
        "steps_a_turn": args.steps,
        "step_ms_turns": [t[0] for t in turns],
        "step_ms_median": step_ms,
        "samples_per_s": BATCH * 1e3 / step_ms,
        "host_ms_in_step_call": [t[1] for t in turns],
        "host_ms_waiting_for_batch": [t[2] for t in turns],
        "profiled_wall_ms_per_step": prof_wall,
        "profiled_host_ms_in_step_call": prof_host,
        "device_busy_ms_per_step": busy,
        "device_idle_share": max(0.0, 1.0 - busy / prof_wall),
        "device_ms_by_group": groups,
        "fused_adam_launches_per_step": launches / args.steps,
        "fused_adam_device_ms_per_step": sum(r["device_ms_per_step"]
                                             for r in adam),
        "kernels": rows,
        "host_ops": host_rows,
    }
    print(f"card: {card}")
    print(f"ncf step (batch {BATCH}, train_step_at under prefetch): "
          f"{[round(t[0], 4) for t in turns]} ms over 3 turns of "
          f"{args.steps}, median {step_ms:.4f} ms, "
          f"{result['samples_per_s']:.1f} samples/s")
    print(f"host ms a step in the step call {[round(t[1], 4) for t in turns]},"
          f" waiting for the next batch {[round(t[2], 4) for t in turns]}")
    print(f"profiled (profiler on): wall {prof_wall:.4f} ms/step, host in "
          f"the step call {prof_host:.4f}, device busy {busy:.4f} ms/step, "
          f"idle share {result['device_idle_share']:.4f}")
    print(f"fused adam: {launches / args.steps:.1f} launches a step "
          f"({n_leaves} leaves), {result['fused_adam_device_ms_per_step']:.4f}"
          f" ms of device time a step")
    for g, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
        print(f"  {g:34s} {ms:.4f} ms/step")
    for r in rows[:25]:
        print(f"  {r['device_ms_per_step']:8.4f} ms  x{r['calls_per_step']:6.1f}"
              f"  [{r['group']}] {r['name'][:90]}")
    print(f"host operators, own time (profiler on), "
          f"{sum(r['host_ms_per_step'] for r in host_rows):.4f} ms/step in all:")
    for r in host_rows[:20]:
        print(f"  {r['host_ms_per_step']:8.4f} ms  x{r['calls_per_step']:6.1f}"
              f"  {r['name'][:90]}")
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)


if __name__ == "__main__":
    main()
