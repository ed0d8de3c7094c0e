#!/usr/bin/env python3
"""Whether ``fit``'s prefetch thread pays for itself, on one GPU.

Times the loop ``Estimator.train`` runs (``DistributedTrainer.prefetch``
over an epoch's host batches, one ``train_step_at`` a batch) with each
batch gathered and placed inline (depth 0) and by the prefetch thread
(depth 2), in turns 0, 2, 2, 0, 0, 2, 2, 0, for two models with seeded
random weights and Adam:

* NeuralCF at the JAX bench's ML-1M width (``bench.py`` ``bench_ncf``:
  6040 users, 3706 items, embeddings 64, hidden 128/64/32) on
  ``synthetic_ratings()`` with 4 negatives a positive, batch 16384, a
  whole epoch (303 steps) a turn, as ``fit`` runs it;
* the transformer TextClassifier at BERT-base widths (as ``chip_smoke.py``
  phase 4: 12 blocks, hidden 768, 12 heads, 512 positions, 20 classes),
  batch 8 x 512 tokens.

Each turn reports, a step: the wall time over its steps (ended by
``torch.cuda.synchronize()``), the host's time in the step call, and its
time waiting for the next placed batch after the first; and the wait for
the first batch, which holds the epoch's shuffle and no thread hides.

    python3 scripts/time_prefetch.py [--ncf-steps N] [--bert-steps N] [--out PATH]

Needs a CUDA device; with ``--out PATH`` also writes the turns as JSON.
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
import statistics
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

DEPTHS = (0, 2, 2, 0, 0, 2, 2, 0)


def timed_turns(torch, tr, params, train_set, batch, steps, warm):
    """``warm`` steps inline, then one turn of ``steps`` steps at each
    depth of DEPTHS; returns {depth: [(wall, in step, waiting ms a step,
    first wait ms), ...]}."""
    opt_state, state = tr.init_opt_state(params), {}
    out = {d: [] for d in sorted(set(DEPTHS))}
    step = 0
    for turn, depth in enumerate((0,) + DEPTHS):
        n = warm if turn == 0 else steps
        start = step
        in_step = waiting = first = 0.0
        torch.cuda.synchronize()
        s0 = time.perf_counter()
        it = tr.prefetch(itertools.islice(
            train_set.epoch_batches(turn, batch, train=True), n), depth=depth)
        while True:
            w0 = time.perf_counter()
            b = next(it, None)
            if b is None:
                break
            t0 = time.perf_counter()
            if step == start:
                first = t0 - w0
            else:
                waiting += t0 - w0
            params, opt_state, state, loss = tr.train_step_at(
                params, opt_state, state, b, 0, step)
            in_step += time.perf_counter() - t0
            step += 1
        torch.cuda.synchronize()
        wall = time.perf_counter() - s0
        if not bool(torch.isfinite(loss)):
            sys.exit(f"time_prefetch: loss {float(loss)} at depth {depth}")
        if turn:
            out[depth].append((wall * 1e3 / n, in_step * 1e3 / n,
                               waiting * 1e3 / (n - 1), first * 1e3))
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ncf-steps", type=int, default=303)
    ap.add_argument("--bert-steps", type=int, default=16)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        sys.exit("time_prefetch: needs a CUDA device")
    from analytics_zoo_torch import init_zoo_context
    from analytics_zoo_torch.feature import FeatureSet
    from analytics_zoo_torch.feature.datasets import movielens
    from analytics_zoo_torch.models.recommendation import NeuralCF
    from analytics_zoo_torch.models.textclassification import TextClassifier
    from analytics_zoo_torch.parallel.trainer import DistributedTrainer
    from analytics_zoo_torch.pipeline.api.keras import objectives
    from analytics_zoo_torch.pipeline.api.keras.optimizers import Adam

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    init_zoo_context(device="cuda:0")
    loss_fn = objectives.get("sparse_categorical_crossentropy_with_logits")

    def measure(model, lr, x, y, batch, steps, warm):
        model.model.init(torch.Generator().manual_seed(0))
        tr = DistributedTrainer(model.model, loss_fn, optim_method=Adam(lr=lr))
        params = tr.place_params(model.get_variables()["params"])
        return timed_turns(torch, tr, params, FeatureSet.from_ndarrays(x, y),
                           batch, steps, warm)

    ratings = movielens.synthetic_ratings()
    ncf_x, ncf_y, _, _ = movielens.build_ncf_samples(
        ratings, movielens.ML1M_USERS, movielens.ML1M_ITEMS, neg_per_pos=4)
    ncf = NeuralCF(movielens.ML1M_USERS, movielens.ML1M_ITEMS, class_num=2,
                   user_embed=64, item_embed=64, mf_embed=64,
                   hidden_layers=(128, 64, 32))
    rs = np.random.RandomState(0)
    n_bert = 8 * args.bert_steps
    bert = TextClassifier(class_num=20, token_length=768, sequence_length=512,
                          encoder="transformer", n_head=12, n_block=12,
                          max_words_num=30521, encoder_output_dim=256)
    result = {"card": card, "depths_in_turn_order": list(DEPTHS), "models": {
        "neuralcf (batch 16384)": measure(ncf, 1e-3, ncf_x, ncf_y, 16384,
                                          args.ncf_steps, 5),
        "bert-base textclassifier (batch 8 x 512)": measure(
            bert, 1e-4, rs.randint(0, 30522, size=(n_bert, 512)),
            rs.randint(0, 20, size=(n_bert,)), 8, args.bert_steps, 2)}}

    print(f"card: {card}")
    for name, by_depth in result["models"].items():
        for depth, turns in by_depth.items():
            walls = [t[0] for t in turns]
            print(f"{name}, prefetch depth {depth}: wall ms a step "
                  f"{walls}, median {statistics.median(walls)}; host in the "
                  f"step call {[t[1] for t in turns]}, waiting for a batch "
                  f"after the first {[t[2] for t in turns]}; the first "
                  f"batch's wait ms {[t[3] for t in turns]} ({card})")
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)


if __name__ == "__main__":
    main()
