"""Long-context attention: the flash kernels against dense attention
(port of ``bench.py::bench_attention``).

Causal, forward and backward, bfloat16 q/k/v of (batch, heads, seq_len,
head_dim).  Each timed run chains ``ITERS`` iterations, in which the loss
is ``O.float().sum()`` and ``dq + dk + dv`` (rounded to bf16) is the next
q, so every gradient kernel runs and each iteration waits for the last.
"Flash" is ``ops.flash_attention.flash_attention``, "dense" the port's
``ops.attention.scaled_dot_product_attention``, as the reference times
its Pallas op against XLA's dense attention.  The returned keys are the
reference's; times come from the host clock around runs that end in
``torch.cuda.synchronize()``, the best of ``repeats`` divided by
``ITERS``.

    python -m analytics_zoo_torch.benchmarks.attention

runs on ``cuda:0`` and prints the dict; it raises without a card unless
``device="cpu"`` is asked for (tests at small sizes).
"""

from __future__ import annotations

import json
import time

import torch

from analytics_zoo_torch.ops.attention import scaled_dot_product_attention
from analytics_zoo_torch.ops.flash_attention import flash_attention

ITERS = 16
SEED = 0           # the inputs' seed, fixed as the reference fixes its key


def attention_flops(batch: int, heads: int, seq_len: int,
                    head_dim: int) -> float:
    """The reference's count: 7 T^2-sized products (forward QK^T and PV;
    backward S, dV, dP, dQ, dK) over the T^2/2 causal pairs, two FLOP a
    multiply-add: 3.5 times the two-product forward."""
    return 3.5 * 2 * 2 * batch * heads * (seq_len ** 2 / 2) * head_dim


def _qkv(shape, device, seed):
    gen = torch.Generator(device=device).manual_seed(seed)
    return [torch.randn(shape, generator=gen, device=device,
                        dtype=torch.bfloat16) for _ in range(3)]


def chained(fn, q, k, v, iters: int = ITERS) -> torch.Tensor:
    """``iters`` forward + backward iterations of ``fn``, each feeding
    ``dq + dk + dv`` to the next as q; returns the last q's float sum."""
    c = q
    for _ in range(iters):
        leaves = [x.detach().requires_grad_() for x in (c, k, v)]
        out = fn(*leaves).float().sum()
        gq, gk, gv = torch.autograd.grad(out, leaves)
        c = (gq + gk + gv).to(q.dtype)
    return c.float().sum()


def _timed(fn, q, k, v, repeats: int, sync) -> float:
    """Seconds an iteration: the best of ``repeats`` chained runs, after
    one untimed run."""
    float(chained(fn, q, k, v))
    best = float("inf")
    for _ in range(repeats):
        sync()
        t0 = time.perf_counter()
        float(chained(fn, q, k, v))      # a host read ends the run
        best = min(best, time.perf_counter() - t0)
    return best / ITERS


def bench_attention(seq_len: int = 4096, batch: int = 4, heads: int = 8,
                    head_dim: int = 128, repeats: int = 5,
                    device=None) -> dict:
    """The flash op's tokens/s at (batch, heads, seq_len, head_dim) in bf16,
    causal, forward + backward, beside dense attention, and the flash op's
    time at twice the sequence."""
    dev = torch.device(device if device is not None else "cuda")
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("bench_attention: CUDA is not available; pass "
                               "device='cpu' to run it on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        sync = lambda: torch.cuda.synchronize(dev)      # noqa: E731
        kind = torch.cuda.get_device_name(dev)
    else:
        sync = lambda: None                             # noqa: E731
        kind = "cpu"

    def flash(q, k, v):
        return flash_attention(q, k, v, causal=True)

    def dense(q, k, v):
        return scaled_dot_product_attention(q, k, v, causal=True)

    q, k, v = _qkv((batch, heads, seq_len, head_dim), dev, SEED)
    t_flash = _timed(flash, q, k, v, repeats, sync)
    t_dense = _timed(dense, q, k, v, repeats, sync)
    del q, k, v
    # twice the context, flash only, as the reference (dense would hold
    # several float32 (B, H, 2T, 2T) tensors)
    q2, k2, v2 = _qkv((batch, heads, 2 * seq_len, head_dim), dev,
                      SEED + 10)
    t_flash_2x = _timed(flash, q2, k2, v2, repeats, sync)
    tokens = batch * seq_len
    return {
        "metric": "flash_attention_tokens_per_sec",
        "value": tokens / t_flash,
        "unit": "tokens/sec/chip",
        "vs_baseline": None,
        "workload": "attention",
        "seq_len": seq_len,
        "batch": batch,
        "heads": heads,
        "head_dim": head_dim,
        "fwd_bwd": True,
        "flash_ms": t_flash * 1e3,
        "dense_ms": t_dense * 1e3,
        "speedup_vs_dense": t_dense / t_flash,
        "flash_tflops": attention_flops(batch, heads, seq_len, head_dim)
        / t_flash / 1e12,
        "flash_2x_seq_ms": t_flash_2x * 1e3,
        "device": str(dev),
        "device_kind": kind,
    }


if __name__ == "__main__":
    print(json.dumps(bench_attention()))
