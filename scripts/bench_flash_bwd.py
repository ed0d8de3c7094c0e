#!/usr/bin/env python3
"""The flash-attention backward kernels (dQ, dK/dV) on one GPU: build,
inspect, check and time, beside another version of the same source.

    python3 scripts/bench_flash_bwd.py [--compare PATH.cu ...] [--out PATH]

Builds ``analytics_zoo_torch/csrc/flash_attention_bwd.cu`` and, with
``--compare``, other sources with the same C entry points (an earlier
commit's copy, taken with ``git show``), by ``nvcc`` with the port's flags
plus ``-Xptxas -v``; each is named by its file name.  For each build it prints the kernels' registers,
shared memory and spills, and their SASS instruction mix
(``cuobjdump -sass``: tensor-core ``HMMA``, ``FFMA``, shared loads, ...).
It holds each build's dQ, dK and dV against the plain versions and checks
that two launches give bit-identical outputs, at the training shape
(8, 12, 512, 64) causal and not, at (2, 4, 200, 64) and at
(2, 4, 512, 128).  Then it times, at the training shape, dQ, dK/dV and the
pair (CUDA events, as ``chip_smoke.py`` does) in turns: the compared
sources, current, current, the compared sources in reverse; beside the
backward of float32
``scaled_dot_product_attention``, which computes dQ, dK and dV together.

With ``--diagnose`` it also builds variants of the current source that
each drop one kind of work, and times them in the same turns (they give
wrong answers by design and are not checked): ``one_mma`` keeps only the
hi.hi product of each split product (a third of the tensor-core work,
the same loads), ``no_lo_loads`` reads the B operands' lo parts from their
hi planes (half the shared loads of B fragments, the same mma), and
``fast_exp`` uses ``__expf``.  What a variant saves is what that work costs
on the kernels' critical path: there is no profiler on the card's machine.

Needs a CUDA device and ``nvcc``; with ``--out PATH`` also writes the
results as JSON.
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import json
import os
import re
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

SHAPES = [((8, 12, 512, 64), False), ((8, 12, 512, 64), True),
          ((2, 4, 200, 64), False), ((2, 4, 200, 64), True),
          ((2, 4, 512, 128), False), ((2, 4, 512, 128), True)]
TRAIN_SHAPE = (8, 12, 512, 64)

# --diagnose: variant name -> (text in the current source, replacement)
DIAGNOSE = {
    "one_mma": ("    mma(c, al, h0, h1);\n    mma(c, ah, bl[o0], bl[o1]);\n", ""),
    "no_lo_loads": ("mma(c, ah, bl[o0], bl[o1]);", "mma(c, ah, h0, h1);"),
    "fast_exp": ("expf(", "__expf("),
}


def diagnose_sources(current: str, out_dir: str):
    """Write the --diagnose variants of ``current``; returns their paths."""
    with open(current) as f:
        text = f.read()
    paths = []
    for name, (old, new) in DIAGNOSE.items():
        if old not in text:
            sys.exit(f"bench_flash_bwd: --diagnose: {name}: the source no "
                     f"longer holds {old!r}")
        path = os.path.join(out_dir, f"diag_{name}.cu")
        with open(path, "w") as f:
            f.write(text.replace(old, new))
        paths.append(path)
    return paths


def build(kernels, src: str, tag: str):
    """nvcc ``src`` into ``_build/bench_<tag>.so``; returns (ctypes lib,
    path, ptxas lines)."""
    out = os.path.join(kernels.BUILD_DIR, f"bench_{tag}.so")
    os.makedirs(kernels.BUILD_DIR, exist_ok=True)
    cmd = [kernels.nvcc_path(), *kernels.NVCC_FLAGS, "-Xptxas", "-v",
           "-o", out, src]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        sys.exit(f"bench_flash_bwd: nvcc failed for {src}:\n"
                 f"{res.stdout}{res.stderr}")
    ptxas = [ln.strip() for ln in (res.stdout + res.stderr).splitlines()
             if "ptxas info" in ln and ("Used" in ln or "Compiling" in ln
                                        or "spill" in ln)]
    lib = ctypes.CDLL(out)
    for name in ("flash_attention_dq", "flash_attention_dkv"):
        _, entry, argtypes = kernels.SIGNATURES[name]
        fn = getattr(lib, entry)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
    return lib, out, ptxas


def sass_mix(path: str, nvcc: str):
    """Opcode counts of each flash kernel in the library's SASS, from the
    ``cuobjdump`` beside ``nvcc``."""
    tool = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    try:
        res = subprocess.run([tool, "-sass", path], capture_output=True,
                             text=True)
    except OSError as e:
        return {"error": str(e)}
    if res.returncode != 0:
        return {"error": res.stderr.strip()[:500]}
    mixes, current = {}, None
    for line in res.stdout.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            current = None
            for kind in ("flash_dq_kernel", "flash_dkv_kernel"):
                if kind in m.group(1):
                    dim = re.search(r"ILi(\d+)E", m.group(1))
                    current = f"{kind}<{dim.group(1) if dim else '?'}>"
                    mixes[current] = collections.Counter()
            continue
        m = re.match(r"\s*/\*[0-9a-f]+\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)",
                     line)
        if current and m:
            op = m.group(1)
            key = op if op.startswith("HMMA") else op.split(".")[0]
            mixes[current][key] += 1
    return {k: dict(c.most_common(14)) for k, c in mixes.items()}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--compare", action="append", default=[])
    ap.add_argument("--diagnose", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        sys.exit("bench_flash_bwd: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from chip_smoke import BWD_ATOL, BWD_RTOL, close, gpu_line, time_ms
    from analytics_zoo_torch.ops import flash_attention as fa
    from analytics_zoo_torch.ops import kernels

    card = gpu_line()
    print(f"gpu: {card}")
    versions = {os.path.splitext(os.path.basename(p))[0]: p
                for p in args.compare}
    versions["current"] = kernels.source_path("flash_attention_bwd")
    diagnostic = set()
    if args.diagnose:
        os.makedirs(kernels.BUILD_DIR, exist_ok=True)
        for path in diagnose_sources(versions["current"], kernels.BUILD_DIR):
            tag = os.path.splitext(os.path.basename(path))[0]
            versions[tag] = path
            diagnostic.add(tag)
    libs, result = {}, {"card": card, "versions": {}}
    for tag, src in versions.items():
        lib, path, ptxas = build(kernels, src, tag)
        libs[tag] = lib
        mix = sass_mix(path, kernels.nvcc_path())
        result["versions"][tag] = {"source": src, "ptxas": ptxas,
                                   "sass": mix}
        print(f"[{tag}] {src}")
        for ln in ptxas:
            print(f"  {ln}")
        for kern, counts in mix.items():
            print(f"  sass {kern}: {counts}")

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)

    def inputs(shape, causal):
        q, k, v, do = (torch.randn(shape, generator=gen, device=dev)
                       for _ in range(4))
        o, lse = fa.flash_attention_ref(q, k, v, causal=causal)
        delta = fa.flash_attention_delta(o, do)
        return q, k, v, do, lse, delta

    def run(lib, q, k, v, do, lse, delta, causal):
        b, h, t, d = q.shape
        dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
        stream = torch.cuda.current_stream().cuda_stream
        ptrs = [x.data_ptr() for x in (q, k, v, do, lse, delta)]
        scale = float(d ** -0.5)
        err = lib.zoo_flash_attention_dq(*ptrs, dq.data_ptr(), b * h, t, d,
                                         scale, int(causal), stream)
        err = err or lib.zoo_flash_attention_dkv(
            *ptrs, dk.data_ptr(), dv.data_ptr(), b * h, t, d, scale,
            int(causal), stream)
        if err:
            sys.exit(f"bench_flash_bwd: launch failed, cudaError {err}")
        return dq, dk, dv

    checks = []
    for shape, causal in SHAPES:
        args_ = inputs(shape, causal)
        q, k, v, do, lse, delta = args_
        want = (fa.flash_attention_dq_ref(q, k, v, do, lse, delta, causal),
                *fa.flash_attention_dkv_ref(q, k, v, do, lse, delta, causal))
        for tag, lib in libs.items():
            if tag in diagnostic:
                continue
            got = run(lib, *args_, causal)
            again = run(lib, *args_, causal)
            torch.cuda.synchronize()
            errs = [close(f"{tag} {n} {shape} causal={causal}", x, w,
                          BWD_ATOL, BWD_RTOL)
                    for n, x, w in zip(("dQ", "dK", "dV"), got, want)]
            same = all(torch.equal(a, b_) for a, b_ in zip(got, again))
            if not same:
                sys.exit(f"bench_flash_bwd: {tag} {shape} causal={causal}: "
                         "two launches differ")
            checks.append(dict(version=tag, shape=shape, causal=causal,
                               max_abs_err=dict(zip(("dq", "dk", "dv"), errs)),
                               bit_identical_relaunch=same))
            print(f"check [{tag}] {shape} causal={causal}: max abs err dQ "
                  f"{errs[0]:.3e} dK {errs[1]:.3e} dV {errs[2]:.3e}; two "
                  f"launches bit-identical")
    result["checks"] = checks

    args_ = inputs(TRAIN_SHAPE, False)
    q, k, v, do, lse, delta = args_
    b, h, t, d = TRAIN_SHAPE
    stream = torch.cuda.current_stream().cuda_stream
    ptrs = [x.data_ptr() for x in args_]
    dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
    scale = float(d ** -0.5)

    def dq_fn(lib):
        return lambda: lib.zoo_flash_attention_dq(
            *ptrs, dq.data_ptr(), b * h, t, d, scale, 0, stream)

    def dkv_fn(lib):
        return lambda: lib.zoo_flash_attention_dkv(
            *ptrs, dk.data_ptr(), dv.data_ptr(), b * h, t, d, scale, 0,
            stream)

    def pair_fn(lib):
        f1, f2 = dq_fn(lib), dkv_fn(lib)
        return lambda: (f1(), f2())

    others = [tag for tag in libs if tag != "current"]
    order = others + ["current", "current"] + others[::-1]
    times = {tag: collections.defaultdict(list) for tag in libs}
    for tag in order:
        for part, make in (("dq", dq_fn), ("dkv", dkv_fn), ("pair", pair_fn)):
            times[tag][part].append(time_ms(torch, make(libs[tag])))
    qg, kg, vg = (x.clone().requires_grad_() for x in (q, k, v))
    out = torch.nn.functional.scaled_dot_product_attention(qg, kg, vg)
    lib_ms = time_ms(torch, lambda: torch.autograd.grad(
        out, (qg, kg, vg), do, retain_graph=True))
    result["times_ms"] = {tag: {p: dict(runs=r, median=statistics.median(r))
                                for p, r in parts.items()}
                          for tag, parts in times.items()}
    result["library_ms"] = lib_ms
    flops = {"dq": 6 * b * h * t * t * d, "dkv": 8 * b * h * t * t * d}
    flops["pair"] = flops["dq"] + flops["dkv"]
    result["bound_ms_3xtf32"] = {p: 3 * f / 495e12 * 1e3
                                 for p, f in flops.items()}
    result["bound_ms_fp32_fma"] = {p: f / 67e12 * 1e3
                                   for p, f in flops.items()}
    for tag, parts in result["times_ms"].items():
        print(f"time [{tag}] {TRAIN_SHAPE} f32: " + ", ".join(
            f"{p} {r['median']:.5f} ms {r['runs']}" for p, r in parts.items())
            + f" ({card})")
    print(f"library: f32 scaled_dot_product_attention backward "
          f"{lib_ms:.5f} ms; bounds 3xTF32 {result['bound_ms_3xtf32']}, "
          f"f32 FMA {result['bound_ms_fp32_fma']} ({card})")
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps({"times_ms": {t_: {p: r["median"] for p, r in x.items()}
                                   for t_, x in result["times_ms"].items()},
                      "library_ms": lib_ms, "card": card}))


if __name__ == "__main__":
    main()
