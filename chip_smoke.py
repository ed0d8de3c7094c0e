#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU: build its CUDA kernels, hold
each against its plain PyTorch version, serve a full-width transformer
TextClassifier through ``InferenceModel``, and show that the serving path
went through the kernels.

    python3 chip_smoke.py

Phases (any failure exits non-zero; no phase catches its own failure):

1. build every kernel from ``analytics_zoo_torch/csrc`` (one nvcc per
   source, all started together) and print the card's name and power
   limit;
2. each kernel against its plain version at the serving shapes, both
   without TF32, with its time (median of CUDA-event-timed launches),
   the plain version's time, a library call's time where one PyTorch
   call computes the same function, and the least time the card could
   take for the same work;
3. ``TextClassifier(encoder="transformer")`` at BERT-base widths
   (hidden 768, 12 heads of 64, FFN 3072, 512 positions, vocabulary
   30522, 12 blocks) with seeded random weights, served through
   ``InferenceModel.load_zoo``/``predict``: 4 requests of 8 sequences,
   launch counts checked, one request re-run under ``ops.fused=torch``
   and compared;
4. a ``kernels`` JSON line, then the device line last.

Exits non-zero, printing no result, when CUDA is not available.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np

# Peak rates of one H100 SXM at its full 700 W (NVIDIA data sheet).
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12

WARMUP = 3
TIMED = 25

# Whole-model tolerance between ops.fused=auto (kernels) and
# ops.fused=torch (plain versions) logits, same weights and inputs.  The
# bf16 rounding of each product's operands is the same code on both
# sides, so only the summation order of attention, LayerNorm and the
# epilogues differs (~1e-7 relative in f32); where such a difference
# moves a value across a bf16 rounding boundary, that one operand moves
# by 2^-8 relative and carries through the following layers.
MODEL_ATOL = 2e-2


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn) -> float:
    """Median of TIMED launches, each between two CUDA events.

    The device first spins for ~50 ms so that the host queues every
    launch and event before the device reaches them: the events then
    bracket device time, not the wrapper's Python work (which would
    otherwise dominate kernels of a few microseconds)."""
    for _ in range(WARMUP):
        fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(100_000_000)
    pairs = []
    for _ in range(TIMED):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        pairs.append((s, e))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def bound_ms(bytes_moved: float, flops: float):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def close(name, got, want, atol, rtol=0.0) -> float:
    err = (got - want).abs()
    worst = float((err - rtol * want.abs()).max())
    max_abs = float(err.max())
    if not (worst <= atol):
        fail(f"{name}: max abs err {max_abs:.3e} over tolerance "
             f"(atol {atol}, rtol {rtol})")
    return max_abs


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a GPU")

    from analytics_zoo_torch import init_zoo_context
    from analytics_zoo_torch.common.config import get_config
    from analytics_zoo_torch.ops import fused, kernels
    from analytics_zoo_torch.ops import flash_attention as fa
    from analytics_zoo_torch.ops.activations import gelu
    from analytics_zoo_torch.models.textclassification import TextClassifier
    from analytics_zoo_torch.pipeline.inference import InferenceModel

    # ---------------------------------------------------------- 1. build
    t0 = time.perf_counter()
    kernels.build_all()
    print(f"build: {len(kernels.SIGNATURES)} kernels in "
          f"{time.perf_counter() - t0:.1f} s")
    card = gpu_line()
    print(f"gpu: {card}")
    ctx = init_zoo_context(device="cuda:0")
    dev = ctx.device
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    report = {}

    # ----------------------------------- 2. kernels against plain versions
    b, h, t, d = 8, 12, 512, 64
    q, k, v = randn(b, h, t, d), randn(b, h, t, d), randn(b, h, t, d)
    for causal in (False, True):
        o, lse = fa.flash_attention_fwd(q, k, v, causal=causal)
        o_ref, lse_ref = fa.flash_attention_ref(q, k, v, causal=causal)
        torch.cuda.synchronize()
        err_o = close(f"flash causal={causal} O", o, o_ref, 1e-5, 1e-5)
        err_l = close(f"flash causal={causal} LSE", lse, lse_ref, 1e-5)
        print(f"check flash_attention_fwd causal={causal} {(b, h, t, d)} "
              f"f32: O max abs err {err_o:.3e}, LSE {err_l:.3e}")
        if not causal:
            flash_err = max(err_o, err_l)
    ms = time_ms(torch, lambda: fa.flash_attention_fwd(q, k, v))
    plain = time_ms(torch, lambda: fa.flash_attention_ref(q, k, v))
    lib = time_ms(torch, lambda: torch.nn.functional
                  .scaled_dot_product_attention(q, k, v))
    bnd, by = bound_ms((4 * b * h * t * d + b * h * t) * 4,
                       4 * b * h * t * t * d)
    report["flash_attention_fwd"] = dict(
        route="cuda", source="analytics_zoo_torch/csrc/flash_attention_fwd.cu",
        replaces="analytics_zoo_tpu/ops/pallas_attention.py:51",
        max_abs_err=flash_err, ms=ms, plain_ms=plain, bound_ms=bnd,
        bound_by=by, library_ms=lib)

    rows, dd = 8 * 512, 3072
    x, bias = randn(rows, dd), randn(dd)
    got, want = fused.bias_gelu_kernel(x, bias), fused.bias_gelu_ref(x, bias)
    torch.cuda.synchronize()
    err = close("bias_gelu", got, want, 1e-6)
    print(f"check bias_gelu {(rows, dd)} f32: max abs err {err:.3e}")
    ms = time_ms(torch, lambda: fused.bias_gelu_kernel(x, bias))
    plain = time_ms(torch, lambda: fused.bias_gelu_ref(x, bias))
    bnd, by = bound_ms((2 * rows * dd + dd) * 4, 0)
    report["bias_gelu"] = dict(
        route="cuda", source="analytics_zoo_torch/csrc/bias_gelu.cu",
        replaces="analytics_zoo_tpu/ops/fused.py:518", max_abs_err=err,
        ms=ms, plain_ms=plain, bound_ms=bnd, bound_by=by, library_ms=None)

    dl = 768
    gamma, beta = randn(dl) * 0.1 + 1.0, randn(dl) * 0.1
    for shape, act in (((4096, dl), None), ((8, dl), gelu)):
        x = randn(*shape)
        got = fused.layernorm_act_kernel(x, gamma, beta, 1e-5, act)
        want = fused.layernorm_act_ref(x, gamma, beta, 1e-5, act)
        torch.cuda.synchronize()
        err = close(f"layernorm_act {shape}", got, want, 1e-5)
        name = "gelu" if act else "none"
        ms = time_ms(torch, lambda: fused.layernorm_act_kernel(
            x, gamma, beta, 1e-5, act))
        plain = time_ms(torch, lambda: fused.layernorm_act_ref(
            x, gamma, beta, 1e-5, act))
        bnd, by = bound_ms((2 * shape[0] * dl + 2 * dl) * 4, 0)
        print(f"check layernorm_act {shape} act={name} f32: max abs err "
              f"{err:.3e}; kernel_ms {ms:.5f} plain_ms {plain:.5f} "
              f"bound_ms {bnd:.6f} ({card})")
    # the serving path's shape is (8, 768) with gelu: the last one above
    report["layernorm_act"] = dict(
        route="cuda", source="analytics_zoo_torch/csrc/layernorm_act.cu",
        replaces="analytics_zoo_tpu/ops/fused.py:550", max_abs_err=err,
        ms=ms, plain_ms=plain, bound_ms=bnd, bound_by=by, library_ms=None)
    for name, r in report.items():
        print(f"time {name}: kernel_ms {r['ms']:.5f} plain_ms "
              f"{r['plain_ms']:.5f} library_ms {r['library_ms']} "
              f"bound_ms {r['bound_ms']:.6f} ({r['bound_by']}) ({card})")
    del q, k, v, o, lse, o_ref, lse_ref, x, got, want

    # -------------------------------------- 3. the slice at full width
    t0 = time.perf_counter()
    model = TextClassifier(class_num=20, token_length=768,
                           sequence_length=512, encoder="transformer",
                           n_head=12, n_block=12, max_words_num=30521,
                           encoder_output_dim=256)
    model.model.init(torch.Generator().manual_seed(0))
    n_params = sum(int(p.numel()) for layer in
                   model.get_variables()["params"].values()
                   for p in layer.values())
    im = InferenceModel().load_zoo(model)
    print(f"model: {n_params} params, built and placed in "
          f"{time.perf_counter() - t0:.1f} s")
    rs = np.random.RandomState(0)
    requests = [rs.randint(0, 30522, size=(8, 512)).astype(np.int64)
                for _ in range(4)]
    im.predict(requests[0], batch_size=8)          # warm-up, not counted

    kernels.reset_launch_counts()
    lat, outs = [], []
    for req in requests:
        s = time.perf_counter()
        outs.append(im.predict(req, batch_size=8))  # returns host numpy
        lat.append((time.perf_counter() - s) * 1e3)
    launches = kernels.launch_counts()
    for out in outs:
        if out.shape != (8, 20) or not np.isfinite(out).all():
            fail(f"serving output shape {out.shape}, finite "
                 f"{np.isfinite(out).all()}")
    want = {"flash_attention_fwd": 48, "bias_gelu": 48, "layernorm_act": 4}
    if launches != want:
        fail(f"launch counts {launches} != {want}")
    print(f"serving launches over 4 requests: {launches}")

    get_config().set("ops.fused", "torch")
    plain_out = im.predict(requests[0], batch_size=8)
    get_config().set("ops.fused", "auto")
    if kernels.launch_counts() != want:
        fail("ops.fused=torch launched a kernel")
    diff = float(np.abs(plain_out - outs[0]).max())
    print(f"ops.fused=torch vs kernels, logits max abs diff {diff:.3e} "
          f"(tolerance {MODEL_ATOL}), logits max abs "
          f"{float(np.abs(outs[0]).max()):.3e}")
    if not diff <= MODEL_ATOL:
        fail(f"kernel and plain logits differ by {diff} > {MODEL_ATOL}")
    med = statistics.median(lat)
    print(f"serving: per-request latency median {med:.3f} ms over "
          f"{lat}, {8 * 1e3 / med:.1f} sequences/s, batch 8 x 512 tokens "
          f"({card})")

    # ------------------------------------------------------- 4. results
    for name, r in report.items():
        r["launches"] = launches[name]
    line = {"kernels": [{"name": n, **{key: r[key] for key in (
        "route", "source", "replaces", "launches", "max_abs_err", "ms",
        "plain_ms", "bound_ms", "bound_by", "library_ms")}}
        for n, r in report.items()]}
    print(json.dumps(line))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
