#!/usr/bin/env python3
"""Where a training step's time goes in the PyTorch port, on one GPU.

Builds the transformer TextClassifier at BERT-base widths (as
``chip_smoke.py`` does: 12 blocks, hidden 768, 12 heads, FFN 3072,
512 positions, 20 classes, seeded random weights), and trains it with
Adam (lr 1e-4) on seeded batches of 8 sequences through
``DistributedTrainer.train_step``, the step ``fit`` runs.  Reports:

* the step time under ``ops.fused=auto`` (the CUDA kernels) and
  ``ops.fused=torch`` (their plain versions), in turns
  (torch, auto, auto, torch), host clock around steps that end in
  ``torch.cuda.synchronize()``;
* a ``torch.profiler`` trace of a few kernel-path steps: device time by
  kernel, grouped into the port's kernels, matrix products and the rest,
  and the device's busy and idle share of the wall time.

    python3 scripts/profile_torch_training.py [--steps N] [--out PATH]

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

PORT_KERNELS = ("flash_fwd_kernel", "flash_dq_kernel", "flash_dkv_kernel",
                "bias_gelu", "layernorm_act", "multi_adam", "multi_sgd")


def _group(name: str) -> str:
    low = name.lower()
    if any(k in low for k in PORT_KERNELS):
        return "port kernels"
    if any(k in low for k in ("gemm", "cutlass", "sm90_xmma", "nvjet", "cublas")):
        return "matrix products"
    return "other"


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=6)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        sys.exit("profile_torch_training: needs a CUDA device")
    from analytics_zoo_torch import init_zoo_context
    from analytics_zoo_torch.common.config import get_config
    from analytics_zoo_torch.models.textclassification import TextClassifier
    from analytics_zoo_torch.parallel.trainer import (
        DistributedTrainer, step_generator)
    from analytics_zoo_torch.pipeline.api.keras import objectives
    from analytics_zoo_torch.pipeline.api.keras.optimizers import Adam

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
    rs = np.random.RandomState(0)
    batches = [(rs.randint(0, 30522, size=(8, 512)),
                rs.randint(0, 20, size=(8,))) for _ in range(args.steps)]
    cfg = get_config()
    loss_fn = objectives.get("sparse_categorical_crossentropy_with_logits")

    def trainer_state():
        tr = DistributedTrainer(model.model, loss_fn,
                                optim_method=Adam(lr=1e-4))
        v = model.get_variables()
        params = tr.place_params(v["params"])
        return tr, params, tr.init_opt_state(params), v["state"]

    def steps(mode, timed=True):
        cfg.set("ops.fused", mode)
        tr, params, opt, state = trainer_state()
        placed = [tr.put_batch(b) for b in batches]
        times = []
        for i, b in enumerate([placed[0]] + placed):    # one warm-up step
            torch.cuda.synchronize()
            s = time.perf_counter()
            params, opt, state, loss = tr.train_step(
                params, opt, state, b, step_generator(0, i, tr.device))
            torch.cuda.synchronize()
            times.append((time.perf_counter() - s) * 1e3)
        if not np.isfinite(float(loss)):
            sys.exit(f"profile_torch_training: loss {float(loss)}")
        return times[1:]

    step_ms = {"torch": [], "auto": []}
    for mode in ("torch", "auto", "auto", "torch"):
        step_ms[mode] += steps(mode)
    cfg.set("ops.fused", "auto")
    medians = {m: statistics.median(v) for m, v in step_ms.items()}

    from torch.profiler import ProfilerActivity, profile
    n_prof = 3
    tr, params, opt, state = trainer_state()
    placed = [tr.put_batch(b) for b in batches[:n_prof]]
    params, opt, state, _ = tr.train_step(params, opt, state, placed[0],
                                          step_generator(0, 0, tr.device))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        s = time.perf_counter()
        for i, b in enumerate(placed):
            params, opt, state, _ = tr.train_step(
                params, opt, state, b, step_generator(0, i + 1, tr.device))
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - s) * 1e3
    rows = []
    for evt in prof.key_averages():
        dev_us = getattr(evt, "self_device_time_total",
                         getattr(evt, "self_cuda_time_total", 0))
        if dev_us > 0 and evt.device_type == torch.autograd.DeviceType.CUDA:
            rows.append({"name": evt.key, "group": _group(evt.key),
                         "calls_per_step": evt.count / n_prof,
                         "device_ms_per_step": dev_us / 1e3 / n_prof})
    rows.sort(key=lambda r: -r["device_ms_per_step"])
    busy = sum(r["device_ms_per_step"] for r in rows)
    per_step_wall = wall_ms / n_prof
    groups = {}
    for r in rows:
        groups[r["group"]] = groups.get(r["group"], 0.0) + \
            r["device_ms_per_step"]

    result = {
        "card": card,
        "step_ms_median": medians,
        "step_ms": step_ms,
        "sequences_per_s": {m: 8e3 / v for m, v in medians.items()},
        "profiled_steps": n_prof,
        "profiled_wall_ms_per_step": per_step_wall,
        "device_busy_ms_per_step": busy,
        "device_idle_share": max(0.0, 1.0 - busy / per_step_wall),
        "device_ms_by_group": groups,
        "kernels": rows,
    }
    print(f"card: {card}")
    for m in ("auto", "torch"):
        print(f"ops.fused={m}: step median {medians[m]:.3f} ms "
              f"({8e3 / medians[m]:.1f} sequences/s) over "
              f"{len(step_ms[m])} steps: {step_ms[m]}")
    print(f"profiled (ops.fused=auto, profiler on): wall {per_step_wall:.3f} "
          f"ms/step, device busy {busy:.3f} ms/step, idle share "
          f"{result['device_idle_share']:.3f}")
    for g, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
        print(f"  {g:16s} {ms:.3f} ms/step")
    for r in rows[:25]:
        print(f"  {r['device_ms_per_step']:8.3f} ms  x{r['calls_per_step']:6.1f}"
              f"  [{r['group']}] {r['name'][:90]}")
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)


if __name__ == "__main__":
    main()
