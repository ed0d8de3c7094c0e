#!/usr/bin/env python3
"""Which operand layouts cuBLASLt's int8 product takes, on one GPU, and
what the weight-only dequantization costs in each of two forms.

1. ``torch._int_mm(a, b)`` for every row count 17..139 and five larger
   ones (3968, 4040, 4041, 6272, 8192) at eight (K, N) pairs of the int8
   paths (NeuralCF's 64 x 32, 128 x 64, 128 x 128; BERT-base's head
   768 x 256; the cnn encoder's unfolded 1000 x 256 and 200 x 256; 8 x 8;
   96 x 8), with ``b`` row-major and column-major: the shapes each layout
   refuses (``CUBLAS_STATUS_NOT_SUPPORTED``) or answers wrongly, against
   the exact float64 product.  Then both layouts timed at NeuralCF's
   8192 x 128 x 128 (median of 25 CUDA-event-timed launches, the
   column-major operand stored so or made per call).
2. The dequantization of BERT-base's int8 leaves (the transformer
   TextClassifier at ``chip_smoke.py`` phase 3's widths, seeded weights,
   ``InferenceModel.load_zoo(quantize=True)``) as one mixed-dtype multiply
   a leaf (``dequantize_params``) and as a cast then an in-place multiply,
   bit-identical, timed alike.

    python3 scripts/probe_int_mm.py [--out PATH]

Needs a CUDA device; with ``--out PATH`` also writes the readings as JSON.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402

PAIRS = ((64, 32), (128, 64), (128, 128), (768, 256), (1000, 256),
         (200, 256), (8, 8), (96, 8))
ROWS = list(range(17, 140)) + [3968, 4040, 4041, 6272, 8192]


def layouts(torch, dev):
    g = torch.Generator(device=dev).manual_seed(0)
    refused = {"row-major": [], "column-major": []}
    for k, n in PAIRS:
        b = torch.randint(-127, 128, (k, n), generator=g, device=dev,
                          dtype=torch.int8)
        operands = {"row-major": b, "column-major": b.t().contiguous().t()}
        for m in ROWS:
            a = torch.randint(-127, 128, (m, k), generator=g, device=dev,
                              dtype=torch.int8)
            want = (a.double() @ b.double()).to(torch.int32)
            for name, bb in operands.items():
                try:
                    ok = torch.equal(torch._int_mm(a, bb), want)
                    torch.cuda.synchronize()
                except RuntimeError:
                    torch.cuda.synchronize()
                    ok = False
                if not ok:
                    refused[name].append((m, k, n))
    total = len(PAIRS) * len(ROWS)
    for name, bad in refused.items():
        print(f"_int_mm, b {name}: {len(bad)} of {total} shapes refused or "
              f"wrong; first {bad[:12]}")
    a = torch.randint(-127, 128, (8192, 128), generator=g, device=dev,
                      dtype=torch.int8)
    b = torch.randint(-127, 128, (128, 128), generator=g, device=dev,
                      dtype=torch.int8)
    bc = b.t().contiguous().t()
    times = {"row-major": chip_smoke.time_ms(torch, lambda: torch._int_mm(a, b)),
             "column-major stored": chip_smoke.time_ms(
                 torch, lambda: torch._int_mm(a, bc)),
             "column-major made a call": chip_smoke.time_ms(
                 torch, lambda: torch._int_mm(a, b.t().contiguous().t()))}
    print(f"_int_mm 8192 x 128 x 128 ms: {times}")
    return {"shapes": total, "refused": {k: len(v) for k, v in
                                         refused.items()},
            "ms_8192x128x128": times}


def dequantization(torch):
    from analytics_zoo_torch import init_zoo_context
    from analytics_zoo_torch.models.textclassification import TextClassifier
    from analytics_zoo_torch.pipeline.api.keras.topology import (
        tree_leaves, tree_replace)
    from analytics_zoo_torch.pipeline.inference import InferenceModel
    from analytics_zoo_torch.pipeline.inference.inference_model import (
        dequantize_params)

    init_zoo_context(device="cuda:0")
    model = TextClassifier(class_num=20, token_length=768,
                           sequence_length=512, encoder="transformer",
                           n_head=12, n_block=12, max_words_num=30521,
                           encoder_output_dim=256)
    model.model.init(torch.Generator().manual_seed(0))
    im = InferenceModel().load_zoo(model, quantize=True)
    params, scales = im._variables["params"], im._scales

    def cast_then_mul(qp, sc):
        return tree_replace(qp, [l if s is None else l.float().mul_(s)
                                 for l, s in zip(tree_leaves(qp), sc)])

    same = all(torch.equal(x, y) for x, y in zip(
        tree_leaves(dequantize_params(params, scales)),
        tree_leaves(cast_then_mul(params, scales))))
    if not same:
        chip_smoke.fail("the two dequantizations differ")
    times = {
        "one multiply a leaf": chip_smoke.time_ms(
            torch, lambda: dequantize_params(params, scales)),
        "cast, then multiply in place": chip_smoke.time_ms(
            torch, lambda: cast_then_mul(params, scales))}
    n = sum(s is not None for s in scales)
    print(f"dequantization of BERT-base's {n} int8 leaves, ms: {times}; "
          f"bit-identical")
    return {"leaves": n, "ms": times}


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--out", default=None)
    args = p.parse_args()
    import torch
    if not torch.cuda.is_available():
        chip_smoke.fail("needs a CUDA device")
    card = chip_smoke.gpu_line()
    print(f"gpu: {card}")
    result = {"card": card,
              "layouts": layouts(torch, torch.device("cuda", 0)),
              "dequantization": dequantization(torch)}
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)


if __name__ == "__main__":
    main()
