#!/usr/bin/env python3
"""The flash-attention kernels (forward; backward dQ and dK/dV) on one GPU:
build, inspect, check and time, beside other versions of the same sources.

    python3 scripts/bench_flash.py [--compare PATH.cu ...] [--diagnose]
                                   [--fit | --bf16 | --wide | --wider]
                                   [--variants NAME,...] [--out PATH]

Builds ``analytics_zoo_torch/csrc/flash_attention_fwd.cu`` and
``flash_attention_bwd.cu`` and, with ``--compare``, other sources with the
same C entry points (an earlier commit's copy, taken with ``git show``);
a compared source is a forward or a backward by the entry points it
defines, and is named by its file name.  Every build (all started
together) is ``nvcc`` with the port's flags plus ``-Xptxas -v`` and ``-I``
the port's ``csrc/`` (so a copy taken elsewhere finds the shared
``flash_tile.cuh``).  For each build it prints the kernels' registers,
shared memory and spills, and their SASS instruction mix (``cuobjdump
-sass``: tensor-core ``HMMA``, ``FFMA``, shared loads, ...).

Checks, at the training shape (8, 12, 512, 64), at (2, 4, 200, 64) and at
(2, 4, 512, 128), causal and not: each forward's O and LSE against the
plain version, each backward's dQ, dK and dV against the plain versions
(the tolerances of ``chip_smoke.py``), and for every build that two
launches give bit-identical outputs.  It also reports whether the current
backward's dQ, dK and dV are bit-identical to each compared backward's at
every shape, and how far the current forward's O is from each compared
forward's.  Then it times, at the training shape, non-causal (CUDA
events, as ``chip_smoke.py`` does), in turns: the compared sources,
current, current, the compared sources in reverse: the forward, beside
float32 ``scaled_dot_product_attention`` as PyTorch picks its backend and
with the memory-efficient backend forced; dQ, dK/dV and the pair, beside
the backward of ``scaled_dot_product_attention``.

With ``--diagnose`` it also builds variants of the current sources that
each drop one kind of work, and times them in the same turns (they give
wrong answers by design and are not checked): ``one_mma`` keeps only the
hi.hi product of each split product (a third of the tensor-core work,
the same loads), ``no_lo_loads`` reads the B operands' lo parts from their
hi planes (half the shared loads of B fragments, the same mma), and
``fast_exp`` uses ``__expf``.  What a variant saves is what that work costs
on the kernels' critical path: there is no profiler on the card's machine.

With ``--fit``, instead of the checks and times, it runs ``chip_smoke.py``'s
phase-4 ``fit`` (the transformer TextClassifier at BERT-base widths,
seeded weights, Adam lr 1e-4, 8 steps of the same 64 seeded sequences,
dropout seeded 0) from the same weights under each forward, with float32
products and with the default bf16 products, in the same turns, and
prints each run's epoch loss: does a compared forward change what
training learns?

With ``--bf16``, instead of all that, the bf16 kernels at
``bench_attention``'s shape: the forward (``flash_attention_fwd_bf16.cu``)
and the backward (dQ and dK/dV, ``flash_attention_bwd_bf16.cu``).  It
builds the current sources and every ``--compare`` source that defines a
bf16 entry point (an earlier ``flash_attention_fwd.cu`` held the float32
and bf16 forward in one file, an earlier ``flash_attention_bwd.cu`` both
backwards; put that commit's headers beside it, which it finds first),
prints their registers, spills and SASS mix (``HGMMA`` beside ``HMMA``;
the current kernels must be ``HGMMA`` alone at head_dim 64, 128, 192 and
256, free of spills and of ptxas's warnings that it serialized the
``wgmma``s), checks each against the plain versions with
``chip_smoke.py``'s tolerances at its phase-14 and phase-26 shapes and,
for the forwards, at its ragged ``BF16_FWD_SHAPES`` and on inputs where
key 0 leads every row (two launches bit-identical), reports whether the
current bf16 kernels' outputs are bit-identical to each compared source's
where both take the width (a compared source takes the head_dims its entry
points have cases for; earlier sources 64 and 128 only), and the current
float32 forward and backward to each compared source's at the float32
shapes above, and times in turns at (4, 8, 4096, D) and (4, 8, 8192, D),
causal, for D = 128, 192 and 256 (each compared source at the widths it
takes): the forward beside bf16 ``scaled_dot_product_attention``'s
forward, and dQ, dK/dV and the pair beside its backward, each beside
``flash_bf16_bound``.
With ``--diagnose`` it adds variants of the current bf16 sources, timed in
the same turns: of the backward, held bit-identical to the current build,
``nc1`` (dQ with one consumer warpgroup at every head_dim, the design of
192 and 256, in place of two at 64 and 128), ``dkv_one_pbuf`` (dK/dV at
192 and 256 with one P^T buffer in place of two), ``dkv_st2`` (two q/dO
stages at 192 in place of three) and ``scale_q`` (dK/dV at 256 rounding
each q tile to bf16(q * scale) as at 192, in place of reading q as it
lands and scaling S^T and dK), and, unchecked, ``one_part`` (the
float32 operand of dQ, dK and dV as one bf16 part in place of three: a
third of those products' tensor work) and ``fast_exp`` (``__expf``); of
the forward ``no_pingpong`` (the consumers issue their products without
taking turns), ``fast_exp``, ``bn64`` (64-key tiles in place of 128) and
``grid_by_head`` (the query block on x, reversed, and the head on y: a
head's blocks run together, heaviest first).

With ``--wide``, instead of all that, the float32 kernels at every
head_dim up to 256: it builds the current sources and prints each
instance's registers, spills and SASS mix.  With ``--diagnose`` it also builds the
variants of ``WIDE_VARIANTS`` (other tilings of the head_dim 192 and 256
instances, the designs they replaced; the split dQ and dK/dV at 64, the
unsplit ones at 128), holds each variant's outputs to the current build's (bit-identical,
or within ``chip_smoke.py``'s tolerances) and times each in turns with the
current build at ``WIDE_TIMED`` (BERT-base's width in heads of 64, 128,
192 and 256: the same work at each), causal and not.  ``chip_smoke.py``
holds the current build to the plain versions and times it beside them,
its bound and the library (phases 2 and 25).

With ``--wider``, instead of all that, the float32 kernels past head_dim
256 (``flash_attention_wide.cu``, the forward, and
``flash_attention_wide_bwd.cu``, dQ and dK/dV: one instance of each
kernel takes every head_dim from 320 to 2048): it builds the sources and
prints the kernels' registers, spills and SASS mix, holds forward, dQ and
dK/dV to the plain versions with ``chip_smoke.py``'s tolerances at
``WIDER_CHECKED`` and ``WIDER_TIMED``, causal and not, and times each
kernel, and dQ + dK/dV, at ``WIDER_TIMED`` (BERT-base's width in heads of
384 and 768, and the reference's t * head_dim limit at 2048; with
``--diagnose`` also at ``WIDER_RANKS``, the cluster sizes 4 to 7).  With
``--diagnose`` it also builds the variants of ``WIDER_VARIANTS`` (the
partial scores in the other order of summation, other unrollings, the
exchange's scatter at every cluster size or at none, and, wrong by
design, no exchange at all), holds each to the plain versions
(reporting, not failing, where it misses a tolerance) and to the current
build (bit-identical or not, the forward and the backward apart), and
times the kernels each variant changes in turns with the current build
(``--variants`` names a subset).  A ``--compare`` source (an earlier
``flash_attention_wide.cu`` or ``flash_attention_wide_bwd.cu``, named by
its directory; put that commit's headers beside it, which it finds
first) takes the parts whose entry points it defines, the current
sources the rest, and is built, checked and timed the same way; for each
part it defines it also reports whether that kernel's SASS is the
current one's, instruction for instruction, and whether its outputs are
the current ones' bit for bit at every checked shape.

Needs a CUDA device and ``nvcc``; with ``--out PATH`` also writes the
results as JSON.  Exits non-zero if a check failed (after timing).
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import glob
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
FWD, BWD = "flash_attention_fwd", "flash_attention_bwd"
KINDS = ("flash_fwd_kernel", "flash_dq_kernel", "flash_dq_split_kernel",
         "flash_dkv_kernel", "flash_dkv_split_kernel", "flash_fwd_bf16_kernel",
         "flash_dq_bf16_kernel", "flash_dkv_bf16_kernel",
         "flash_dkv_bf16_pair_kernel",
         "flash_fwd_wide_kernel", "flash_dq_wide_kernel",
         "flash_dkv_wide_kernel")
BF16_FWD = "flash_attention_fwd_bf16"
BF16_BWD = "flash_attention_bwd_bf16"
BF16_NAMES = ["flash_attention_dq_bf16", "flash_attention_dkv_bf16"]
WIDE = "flash_attention_wide"
WIDE_BWD = "flash_attention_wide_bwd"
WIDE_NAMES = ["flash_attention_fwd_wide", "flash_attention_dq_wide",
              "flash_attention_dkv_wide"]
# --wider: part -> C entry point
WIDER_ENTRIES = {"fwd": "zoo_flash_attention_fwd_wide",
                 "dq": "zoo_flash_attention_dq_wide",
                 "dkv": "zoo_flash_attention_dkv_wide"}
# --wider: where the wide kernels are checked (ragged last tiles, fewer
# rows than a tile, 5 chunks split 3 + 2) and where they are timed
WIDER_CHECKED = ((2, 2, 200, 320), (1, 2, 17, 384), (2, 1, 129, 768),
                 (1, 2, 100, 2048))
WIDER_TIMED = ((8, 2, 512, 384), (8, 1, 512, 768), (8, 1, 256, 2048))
# --wider --diagnose: also timed, the cluster sizes 4 to 7 (32 clusters
# each, one wave), where each kernel's SCATTER_FROM is placed
WIDER_RANKS = ((8, 1, 256, 1024), (8, 1, 256, 1280), (8, 1, 256, 1536),
               (8, 1, 256, 1792))
# --wider --diagnose: variants of the wide kernels, by the source whose
# parts they build, each a list of edits: (text in that source,
# replacement), or (header, text in it, replacement) for a header of
# csrc/ (the variant's own copy, which only that source is built with)
WIDE_CLUSTER = "flash_wide_cluster.cuh"
_NO_EXCHANGE = [
    (WIDE_CLUSTER, "        cluster_reduce<NP>(part, nz, rank);\n", ""),
    (WIDE_CLUSTER, "    if (live) {\n        if (SCATTER) {",
     "    if (false) {\n        if (SCATTER) {")]
WIDER_VARIANTS = {WIDE: {
    # each partial's 8-wide steps one accumulator chain, as the backward
    # takes its partials: what the per-step sums cost, and the chain's
    # accuracy on the card
    "fwd_chain": [("constexpr bool SCORE_STEPS = true;",
                   "constexpr bool SCORE_STEPS = false;")],
    # other unrollings of the partial scores' 8-wide steps
    "fwd_unroll2": [("constexpr int FWD_UNROLL = 1;", "constexpr int FWD_UNROLL = 2;")],
    "fwd_unroll8": [("constexpr int FWD_UNROLL = 1;", "constexpr int FWD_UNROLL = 8;")],
    # every cluster sums every position in every rank, or every one
    # scatters (the kernel takes each by cluster size)
    "fwd_all_read": [("constexpr int FWD_SCATTER_FROM = 4;",
                      "constexpr int FWD_SCATTER_FROM = 9;")],
    "fwd_scatter": [("constexpr int FWD_SCATTER_FROM = 4;",
                     "constexpr int FWD_SCATTER_FROM = 2;")],
    # no rank reads another's partial (wrong by design): what the
    # exchange's reads cost beside its barriers
    "fwd_no_exchange": _NO_EXCHANGE,
}, WIDE_BWD: {
    # each 8-wide step of the partial scores summed from zero, then added
    # (the forward's order): what the one chain saves, and its accuracy
    "bwd_steps": [("constexpr bool PARTIAL_STEPS = false;",
                   "constexpr bool PARTIAL_STEPS = true;")],
    # other unrollings of the partial scores' 8-wide steps
    "dq_unroll2": [("constexpr int DQ_UNROLL = 8;", "constexpr int DQ_UNROLL = 2;")],
    "dkv_unroll8": [("constexpr int DKV_UNROLL = 2;", "constexpr int DKV_UNROLL = 8;")],
    "bwd_unroll1": [("constexpr int DQ_UNROLL = 8;", "constexpr int DQ_UNROLL = 1;"),
                    ("constexpr int DKV_UNROLL = 2;", "constexpr int DKV_UNROLL = 1;")],
    # every cluster sums every position in every rank (each partial read
    # nz times, one barrier fewer a step), or every one scatters (the
    # kernels take each by cluster size)
    "bwd_all_read": [("constexpr int SCATTER_FROM = 4;",
                      "constexpr int SCATTER_FROM = 9;")],
    "bwd_scatter": [("constexpr int SCATTER_FROM = 4;",
                     "constexpr int SCATTER_FROM = 2;")],
    # no rank reads another's partials (wrong by design): what the
    # exchange's reads cost beside its barriers
    "bwd_no_exchange": _NO_EXCHANGE,
}}
F32_NAMES = ["flash_attention_dq", "flash_attention_dkv"]
# bench_attention's shape and twice its sequence, causal
BF16_TIMED = tuple((4, 8, t, d) for d in (128, 192, 256)
                   for t in (4096, 8192))
# --wide --diagnose: BERT-base's width in heads of 64, 128, 192 and 256
# (H * D = 768: the work of TRAIN_SHAPE at each)
WIDE_TIMED = ((8, 12, 512, 64), (8, 6, 512, 128), (8, 4, 512, 192),
              (8, 3, 512, 256))
# --wide --diagnose: variants of the float32 sources, by source, each a
# list of (text in it, replacement); correct kernels, held to the current
# build and timed.  The tilings are the wide instances' earlier designs and
# their neighbours; "split", "dq64_bn32" and "unsplit128" ask at which
# head_dims the split dQ and dK/dV kernels beat the unsplit ones.
_DQ_BN = ("    // rows of each streamed K and V tile\n"
          "    static constexpr int BN = D == 64 ? 64 : D == 128 ? 32 : 16;")
_DKV_BN = ("    // rows of each streamed q and dO tile\n"
           "    static constexpr int BN = D == 64 ? 64 : D == 128 ? 32 : 16;")
_BN8 = ": D == 128 ? 32 : D == 192 ? 16 : 8;"
WIDE_VARIANTS = {FWD: {
    # the forward's first tiling: BM 64 (4 warps), BN 32 at 192 and 16 at
    # 256, K split as it lands
    "fwd_first": [("int BM = D == 128 ? 64 : 128;",
                   "int BM = D == 64 ? 128 : 64;"),
                  ("bool K_LO = D <= 128;", "bool K_LO = true;")],
    # then: BM 128, BN 8 at 256 (8 warps, one chain each), K split as it lands
    "fwd_bn8": [("int BM = D == 128 ? 64 : 128;",
                 "int BM = D == 128 || D == 192 ? 64 : 128;"),
                ("int BN = D <= 192 ? 32 : 16;", "int BN = D <= 192 ? 32 : 8;"),
                ("bool K_LO = D <= 128;", "bool K_LO = true;")],
}, BWD: {
    # dQ's first design: one warp a 16-row group, BN 16 at 192 and 8 at 256
    "dq_unsplit": [("bool SPLIT = D > 64;          // two warps a 16-row",
                    "bool SPLIT = D > 256;         // two warps a 16-row"),
                   (_DQ_BN, _DQ_BN.replace(": D == 128 ? 32 : 16;", _BN8)),
                   ("bool V_LO = D != 256;", "bool V_LO = true;")],
    # then: split, BN 8 at 256 with V split as it lands
    "dq_bn8": [(_DQ_BN, _DQ_BN.replace(": D == 128 ? 32 : 16;", _BN8)),
               ("bool V_LO = D != 256;", "bool V_LO = true;")],
    # dK/dV's first design: BN 8 at 256 with dO split as it lands
    "dkv_bn8": [(_DKV_BN, _DKV_BN.replace(": D == 128 ? 32 : 16;", _BN8)),
                ("bool DO_LO = D != 256;", "bool DO_LO = true;")],
    # BM 32 (4 warps) at 256, BN 16, dO split as it lands
    "dkv256_bm32": [("int BM = D == 64 ? 128 : 64;  // key rows",
                     "int BM = D == 64 ? 128 : D == 256 ? 32 : 64;  // key rows"),
                    ("bool DO_LO = D != 256;", "bool DO_LO = true;")],
    # the split dQ and dK/dV at head_dim 64 too; dQ's with BN 32 there (its
    # P and dP buffers take 64 KB: BN 64 would need 239,616 bytes)
    "split": [("bool SPLIT = D > 64;", "bool SPLIT = true;"),
              (_DQ_BN, _DQ_BN.replace("D == 64 ? 64", "D == 64 ? 32"))],
    # the unsplit dQ at 64 with BN 32: what that tiling alone costs
    "dq64_bn32": [(_DQ_BN, _DQ_BN.replace("D == 64 ? 64", "D == 64 ? 32"))],
    # the unsplit dQ and dK/dV at head_dim 128 (the split ones took 128
    # from them)
    "unsplit128": [("bool SPLIT = D > 64;", "bool SPLIT = D > 128;")],
}}
# --diagnose --bf16: variant name -> [(text in the bf16 source, replacement)]
DIAGNOSE_BF16 = {
    # dQ: one consumer warpgroup (256 threads, two stages, no setmaxnreg)
    # at head_dim 64 and 128 too, as at 192 and 256
    "nc1": [("static constexpr int NC = DQ && D_ > 128 ? 1 : 2;",
             "static constexpr int NC = DQ ? 1 : 2;")],
    # dK/dV at 192 and 256: one P^T buffer; two q/dO stages at 192
    "dkv_one_pbuf": [("static constexpr int NPB = 2;", "static constexpr int NPB = 1;")],
    "dkv_st2": [("static constexpr int ST = D_ == 256 ? 2 : 3;",
                 "static constexpr int ST = 2;")],
    # dK/dV at 256 rounds each q tile to bf16(q * scale) as at 192, where
    # the exact scale lets it read q as it lands
    "scale_q": [("return (__float_as_uint(x) & 0x7FFFFF) == 0 && e != 0 && e != 0xFF;",
                 "return false;")],
    "one_part": [("constexpr int PARTS = 3;", "constexpr int PARTS = 1;")],
    "fast_exp": [("expf(", "__expf(")],
}
DIAGNOSE_BF16_FWD = {
    "no_pingpong": [("constexpr bool PINGPONG = true;",
                     "constexpr bool PINGPONG = false;")],
    "fast_exp": [("expf(", "__expf(")],
    "bn64": [("static constexpr int BN = D_ <= 128 ? 128 : 64;",
              "static constexpr int BN = 64;")],
    "grid_by_head": [
        ("const int bh = blockIdx.x;", "const int bh = blockIdx.y;"),
        ("(gridDim.y - 1 - blockIdx.y) * BM", "(gridDim.x - 1 - blockIdx.x) * BM"),
        ("dim3 grid(bh, (t + C::BM - 1) / C::BM);",
         "dim3 grid((t + C::BM - 1) / C::BM, bh);")],
}

# --diagnose --bf16: the variants held bit-identical to the current build
BF16_SAME = {"diag_nc1", "diag_dkv_one_pbuf", "diag_dkv_st2", "diag_scale_q"}
# --diagnose: variant name -> (text in the current sources, replacement);
# each must be found in at least one of them
DIAGNOSE = {
    "one_mma": ("    mma(c, al, h0, h1);\n    mma(c, ah, bl[o0], bl[o1]);\n", ""),
    "no_lo_loads": ("mma(c, ah, bl[o0], bl[o1]);", "mma(c, ah, h0, h1);"),
    "fast_exp": ("expf(", "__expf("),
}


def direction(path: str) -> str:
    with open(path) as f:
        text = f.read()
    if "zoo_flash_attention_fwd" in text:
        return FWD
    if "zoo_flash_attention_dq" in text:
        return BWD
    sys.exit(f"bench_flash: {path} defines no flash entry point")


def diagnose_sources(csrc: str, out_dir: str):
    """Write the --diagnose variants of the current forward and backward
    (each with its own copy of the headers); returns {tag: {direction:
    path}}."""
    names = [FWD + ".cu", BWD + ".cu"] + sorted(
        os.path.basename(p) for p in glob.glob(os.path.join(csrc, "*.cuh")))
    texts = {}
    for n in names:
        with open(os.path.join(csrc, n)) as f:
            texts[n] = f.read()
    out = {}
    for name, (old, new) in DIAGNOSE.items():
        if not any(old in t for t in texts.values()):
            sys.exit(f"bench_flash: --diagnose: {name}: the sources no "
                     f"longer hold {old!r}")
        d = os.path.join(out_dir, f"diag_{name}")
        os.makedirs(d, exist_ok=True)
        for n, t in texts.items():
            with open(os.path.join(d, n), "w") as f:
                f.write(t.replace(old, new))
        out[f"diag_{name}"] = {FWD: os.path.join(d, FWD + ".cu"),
                               BWD: os.path.join(d, BWD + ".cu")}
    return out


def start_build(kernels, src: str, tag: str):
    """Start nvcc on ``src`` into ``_build/bench_<tag>.so``; returns (Popen,
    library path)."""
    out = os.path.join(kernels.BUILD_DIR, f"bench_{tag}.so")
    os.makedirs(kernels.BUILD_DIR, exist_ok=True)
    cmd = [kernels.nvcc_path(), *kernels.NVCC_FLAGS, "-Xptxas", "-v",
           "-I", kernels.CSRC_DIR, "-o", out, src]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True), out


def finish_build(kernels, started, src: str, names):
    """Wait for a build; returns (ctypes lib, path, ptxas lines)."""
    proc, out = started
    log, _ = proc.communicate()
    if proc.returncode != 0:
        sys.exit(f"bench_flash: nvcc failed for {src}:\n{log}")
    ptxas = [ln.strip() for ln in log.splitlines()
             if ("ptxas info" in ln and ("Used" in ln or "Compiling" in ln
                                         or "Potential" in ln))
             or "spill" in ln]
    lib = ctypes.CDLL(out)
    for name in names:
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
            for kind in KINDS:
                # a template instance, or (the wide kernels) a function
                if kind + "I" in m.group(1) or kind + "E" in m.group(1):
                    dim = re.search(r"IL[ib](\d+)E", m.group(1))
                    current = f"{kind}<{dim.group(1) if dim else '?'}>"
                    mixes[current] = collections.Counter()
            continue
        m = re.match(r"\s*/\*[0-9a-f]+\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Za-z0-9_.]*)",
                     line)
        if current and m:
            op = m.group(1)
            key = op if op.startswith(("HMMA", "HGMMA")) else op.split(".")[0]
            mixes[current][key] += 1
    # the 14 most common opcodes, and every tensor-core one
    return {k: {**dict(c.most_common(14)),
                **{op: n for op, n in c.items()
                   if op.startswith(("HMMA", "HGMMA"))}}
            for k, c in mixes.items()}


def sass_text(path: str, nvcc: str, kind: str):
    """The SASS instructions (without addresses and encodings) of the
    function ``kind`` in the library at ``path``, from the ``cuobjdump``
    beside ``nvcc``; None if it cannot be read."""
    tool = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    try:
        res = subprocess.run([tool, "-sass", path], capture_output=True,
                             text=True)
    except OSError:
        return None
    if res.returncode != 0:
        return None
    out, inside = [], False
    for line in res.stdout.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            inside = kind + "E" in m.group(1) or kind + "I" in m.group(1)
            continue
        m = re.match(r"\s*/\*[0-9a-f]+\*/\s+(.*?)\s*;", line)
        if inside and m:
            out.append(m.group(1))
    return out


def in_turns(torch, time_ms, fns, runs):
    """Time each fn of ``fns`` ({tag: fn}) in turns: the others, current,
    current, the others in reverse; appends to ``runs[tag]``."""
    others = [tag for tag in fns if tag != "current"]
    for tag in others + ["current", "current"] + others[::-1]:
        runs[tag].append(time_ms(torch, fns[tag]))


def fit_losses(torch, kernels, fwd_libs, card):
    """--fit: the epoch loss of chip_smoke.py's phase-4 fit under each
    forward library of ``fwd_libs`` ({tag: lib}), f32 and bf16 products,
    in turns; returns {"<compute> <tag>": [loss, ...]}."""
    import numpy as np
    from analytics_zoo_torch import init_zoo_context
    from analytics_zoo_torch.models.textclassification import TextClassifier
    from analytics_zoo_torch.ops import dtypes
    from analytics_zoo_torch.pipeline.api.keras.optimizers import Adam
    from analytics_zoo_torch.pipeline.api.keras.topology import tree_map
    kernels.build_all()
    own = kernels._libs[FWD]
    init_zoo_context(device="cuda:0")
    model = TextClassifier(class_num=20, token_length=768,
                           sequence_length=512, encoder="transformer",
                           n_head=12, n_block=12, max_words_num=30521,
                           encoder_output_dim=256)
    model.model.init(torch.Generator().manual_seed(0))
    start = model.get_variables()
    rs = np.random.RandomState(0)
    for _ in range(4):          # phase 4's data comes after phase 3's requests
        rs.randint(0, 30522, size=(8, 512))
    x = rs.randint(0, 30522, size=(64, 512)).astype(np.int64)
    y = rs.randint(0, 20, size=(64,)).astype(np.int64)
    others = [tag for tag in fwd_libs if tag != "current"]
    losses = collections.defaultdict(list)
    for compute in ("float32", "bfloat16"):
        dtypes.set_policy(compute_dtype=compute)
        for tag in others + ["current", "current"] + others[::-1]:
            kernels._libs[FWD] = fwd_libs[tag]
            model.set_variables({"params": tree_map(torch.clone,
                                                    start["params"]),
                                 "state": start["state"]})
            model.compile(Adam(lr=1e-4),
                          "sparse_categorical_crossentropy_with_logits")
            kernels.reset_launch_counts()
            loss = model.fit(x, y, batch_size=8, nb_epoch=1, rng=0)[0]["loss"]
            if kernels.launch_counts()[FWD] != 96:
                sys.exit(f"bench_flash: --fit: {tag} launched the forward "
                         f"{kernels.launch_counts()[FWD]} times, want 96")
            losses[f"{compute} {tag}"].append(loss)
        dtypes.restore_policy(None)
    kernels._libs[FWD] = own
    for key, ls in losses.items():
        print(f"fit dtype.compute={key.replace(' ', ' forward=')}: epoch "
              f"losses {ls}, spread {max(ls) - min(ls):.3e} ({card})")
    return dict(losses)


def defines(path: str, entry: str) -> bool:
    with open(path) as f:
        return f"{entry}(" in f.read()


def variant_sources(csrc: str, out_dir: str, source: str, variants):
    """Write the --diagnose variants (``variants``: {name: [edit]}, each
    edit (old, new) in ``source``'s text or (header, old, new) in a
    header's) of the current ``source``, each beside its own copy of the
    headers; returns {tag: path}."""
    files = [source + ".cu"] + sorted(
        os.path.basename(h) for h in glob.glob(os.path.join(csrc, "*.cuh")))
    texts = {}
    for n in files:
        with open(os.path.join(csrc, n)) as f:
            texts[n] = f.read()
    out = {}
    for name, edits in variants.items():
        variant = dict(texts)
        for edit in edits:
            where, old, new = edit if len(edit) == 3 else (source + ".cu",
                                                           *edit)
            if old not in variant[where]:
                sys.exit(f"bench_flash: --diagnose: {name}: {where} no "
                         f"longer holds {old!r}")
            variant[where] = variant[where].replace(old, new)
        d = os.path.join(out_dir, f"diag_{source}_{name}")
        os.makedirs(d, exist_ok=True)
        for n, text in variant.items():
            with open(os.path.join(d, n), "w") as f:
                f.write(text)
        out[f"diag_{name}"] = os.path.join(d, source + ".cu")
    return out


def wide_flash(args, torch, kernels, fa, card) -> None:
    """--wide: the float32 kernels' registers, spills and SASS mix at every
    head_dim; with --diagnose the ``WIDE_VARIANTS`` held to the current
    build and timed in turns with it (see the module's docstring)."""
    from chip_smoke import BWD_ATOL, BWD_RTOL, FWD_ATOL, FWD_RTOL, time_ms
    versions = {"current": {FWD: kernels.source_path(FWD),
                            BWD: kernels.source_path(BWD)}}
    if args.diagnose:
        for src, variants in WIDE_VARIANTS.items():
            for tag, path in variant_sources(
                    kernels.CSRC_DIR, kernels.BUILD_DIR, src,
                    variants).items():
                versions[tag] = {src: path}
    names = {FWD: [FWD], BWD: F32_NAMES}
    started = {(tag, dirn): start_build(kernels, src, f"wide_{dirn}_{tag}")
               for tag, srcs in versions.items() for dirn, src in srcs.items()}
    libs = collections.defaultdict(dict)
    result = {"card": card, "versions": {}}
    for (tag, dirn), st in started.items():
        src = versions[tag][dirn]
        lib, path, ptxas = finish_build(kernels, st, src, names[dirn])
        libs[tag][dirn] = lib
        mix = sass_mix(path, kernels.nvcc_path())
        result["versions"][f"{dirn}:{tag}"] = {"source": src, "ptxas": ptxas,
                                               "sass": mix}
        print(f"[wide {dirn}:{tag}] {src}")
        # ptxas names each instance before its registers and spills
        for ln in ptxas:
            kind = next((k for k in KINDS if k + "I" in ln), None)
            dim = re.search(r"Li(\d+)E", ln)
            print(f"  {kind}<{dim.group(1) if dim else '?'}>" if kind
                  else f"    {ln}")
        for kern, counts in mix.items():
            print(f"  sass {kern}: {counts}")
    if not args.diagnose:
        return write_out(args, result)

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(24)
    stream = torch.cuda.current_stream().cuda_stream
    failures = []

    def calls(tag, q, k, v, do, lse, delta, outs, causal):
        """{part: fn} of the version ``tag`` (its forward or its backward
        where it has one) writing into ``outs`` (o, lse, dq, dk, dv)."""
        b, h, t, d = q.shape
        scale = float(d ** -0.5)
        ptrs = [x.data_ptr() for x in (q, k, v, do, lse, delta)]
        o, lse_o, dq, dk, dv = (x.data_ptr() for x in outs)
        fns = {}
        if FWD in libs[tag]:
            fns["fwd"] = lambda: libs[tag][FWD].zoo_flash_attention_fwd(
                *ptrs[:3], o, lse_o, b * h, t, d, scale, int(causal), stream)
        if BWD in libs[tag]:
            lib = libs[tag][BWD]
            fns["dq"] = lambda: lib.zoo_flash_attention_dq(
                *ptrs, dq, b * h, t, d, scale, int(causal), stream)
            fns["dkv"] = lambda: lib.zoo_flash_attention_dkv(
                *ptrs, dk, dv, b * h, t, d, scale, int(causal), stream)
        return fns

    checks, times = [], {}
    for shape in WIDE_TIMED:
        q, k, v, do = (torch.randn(shape, generator=gen, device=dev)
                       for _ in range(4))
        for causal in (False, True):
            key = f"{shape} causal={causal}"
            o_ref, lse = fa.flash_attention_ref(q, k, v, causal=causal)
            delta = fa.flash_attention_delta(o_ref, do)
            fns, got = {}, {}
            for tag in libs:
                outs = [torch.zeros_like(x)
                        for x in (q, lse, q, k, v)]
                fns[tag] = calls(tag, q, k, v, do, lse, delta, outs, causal)
                for part, fn in fns[tag].items():
                    if fn():
                        sys.exit(f"bench_flash: {tag} {part} {key}: launch "
                                 "failed")
                got[tag] = dict(zip(("o", "lse", "dq", "dk", "dv"), outs))
            torch.cuda.synchronize()
            # each variant against the current build, on the outputs of
            # the source it changes (chip_smoke.py holds the current one
            # to the plain versions)
            for tag in libs:
                if tag == "current":
                    continue
                which = ("o", "lse") if FWD in libs[tag] else ("dq", "dk", "dv")
                for n in which:
                    want, x = got["current"][n], got[tag][n]
                    atol, rtol = ((FWD_ATOL, FWD_RTOL) if n in ("o", "lse")
                                  else (BWD_ATOL, BWD_RTOL))
                    err = (x - want).abs()
                    same = torch.equal(x, want)
                    if not float((err - rtol * want.abs()).max()) <= atol:
                        failures.append(f"{tag} {n} {key}: max abs diff "
                                        f"{float(err.max()):.3e}")
                    checks.append(dict(version=tag, shape=shape, causal=causal,
                                       output=n, bit_identical=same,
                                       max_abs_diff=float(err.max())))
                    print(f"check [wide {tag}] {n} {key} against current: "
                          f"{'bit-identical' if same else f'max abs diff {float(err.max()):.3e}'}")
            entry = times[key] = {}
            for part in ("fwd", "dq", "dkv"):
                turn = {tag: f[part] for tag, f in fns.items() if part in f}
                if len(turn) < 2:
                    continue
                runs = collections.defaultdict(list)
                in_turns(torch, time_ms, turn, runs)
                entry[part] = {tag: dict(runs=r, median=statistics.median(r))
                               for tag, r in runs.items()}
                print(f"time [wide] {part} {key} f32: " + ", ".join(
                    f"{tag} {r['median']:.5f}" for tag, r in
                    entry[part].items()) + f" ms ({card})")
        del q, k, v, do
    result.update(checks=checks, times_ms=times, failures=failures)
    write_out(args, result)
    if failures:
        print("bench_flash: FAILED:\n  " + "\n  ".join(failures))
        sys.exit(1)


def wider_versions(args, kernels):
    """--wider: {tag: {part: source}} of the versions to build, for the
    parts fwd, dq and dkv: the current forward and backward sources; each
    ``--compare`` source (named by its directory) for the parts whose entry
    points it defines, the current sources for the rest; with --diagnose,
    each variant of ``WIDER_VARIANTS`` for the parts of its source."""
    current = {"fwd": kernels.source_path(WIDE),
               "dq": kernels.source_path(WIDE_BWD),
               "dkv": kernels.source_path(WIDE_BWD)}
    versions = {"current": current}
    for path in args.compare:
        parts = {part: path for part, entry in WIDER_ENTRIES.items()
                 if defines(path, entry)}
        if not parts:
            sys.exit(f"bench_flash: {path} defines no wide entry point")
        versions[os.path.basename(os.path.dirname(path))] = {**current,
                                                             **parts}
    if args.diagnose:
        chosen = args.variants.split(",") if args.variants else None
        unknown = set(chosen or ()) - {n for v in WIDER_VARIANTS.values()
                                       for n in v}
        if unknown:
            sys.exit(f"bench_flash: --variants: no variant {sorted(unknown)}")
        for source, variants in WIDER_VARIANTS.items():
            variants = {n: e for n, e in variants.items()
                        if chosen is None or n in chosen}
            for tag, path in variant_sources(kernels.CSRC_DIR,
                                             kernels.BUILD_DIR, source,
                                             variants).items():
                versions[tag] = {part: path if src == kernels.source_path(
                    source) else src for part, src in current.items()}
    return versions


def wider_flash(args, torch, kernels, fa, card) -> None:
    """--wider: the wide kernels' registers, spills and SASS mix, checks
    against the plain versions and times; with --diagnose the
    ``WIDER_VARIANTS`` beside them (see the module's docstring)."""
    from chip_smoke import (BWD_ATOL, BWD_RTOL, FWD_ATOL, FWD_LSE_ATOL,
                            FWD_RTOL, flash_bound_ms, time_ms)
    versions = wider_versions(args, kernels)
    sources = sorted({src for parts in versions.values()
                      for src in parts.values()})
    started = {src: start_build(kernels, src, f"wider_{i}")
               for i, src in enumerate(sources)}
    built, paths, result = {}, {}, {"card": card, "versions": {}}
    for src in sources:
        names = [WIDE_NAMES[i] for i, part in enumerate(WIDER_ENTRIES)
                 if defines(src, WIDER_ENTRIES[part])]
        lib, path, ptxas = finish_build(kernels, started[src], src, names)
        built[src], paths[src] = lib, path
        mix = sass_mix(path, kernels.nvcc_path())
        result["versions"][src] = {"ptxas": ptxas, "sass": mix}
        print(f"[wider] {src}")
        for ln in ptxas:
            kind = next((k for k in KINDS if k + "E" in ln or k + "I" in ln),
                        None)
            inst = re.search(r"IL[ib](\d+)E", ln) if kind else None
            print(f"  {kind}{f'<{inst.group(1)}>' if inst else ''}" if kind
                  else f"    {ln}")
        for kern, counts in mix.items():
            print(f"  sass {kern}: {counts}")
    # each version's library for each part
    libs = {tag: {part: built[src] for part, src in parts.items()}
            for tag, parts in versions.items()}
    result["parts"] = versions
    # is each compared part the same machine code as the current one?
    result["sass_identical"] = {}
    for part, kind in (("fwd", "flash_fwd_wide_kernel"),
                       ("dq", "flash_dq_wide_kernel"),
                       ("dkv", "flash_dkv_wide_kernel")):
        sass = {src: sass_text(paths[src], kernels.nvcc_path(), kind)
                for src in {parts[part] for parts in versions.values()}}
        current_sass = sass[versions["current"][part]]
        for tag, parts in versions.items():
            if parts[part] == versions["current"][part]:
                continue
            same = current_sass is not None and sass[parts[part]] == current_sass
            result["sass_identical"].setdefault(tag, {})[kind] = same
            print(f"[wider {tag}] {kind} SASS "
                  f"({len(current_sass or [])} instructions) "
                  f"{'identical to' if same else 'differs from'} current's")

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(26)
    stream = torch.cuda.current_stream().cuda_stream
    failures, checks, times = [], [], {}

    def calls(parts, q, k, v, do, lse, delta, outs, causal):
        """{part: fn} launching each part's library into ``outs`` (o, lse,
        dq, dk, dv); dQ and dK/dV on the given lse and delta."""
        b, h, t, d = q.shape
        scale = float(d ** -0.5)
        ptrs = [x.data_ptr() for x in (q, k, v, do, lse, delta)]
        o, lse_o, dq, dk, dv = (x.data_ptr() for x in outs)
        return {
            "fwd": lambda: parts["fwd"].zoo_flash_attention_fwd_wide(
                *ptrs[:3], o, lse_o, b * h, t, d, scale, int(causal), stream),
            "dq": lambda: parts["dq"].zoo_flash_attention_dq_wide(
                *ptrs, dq, b * h, t, d, scale, int(causal), stream),
            "dkv": lambda: parts["dkv"].zoo_flash_attention_dkv_wide(
                *ptrs, dk, dv, b * h, t, d, scale, int(causal), stream)}

    timed = WIDER_TIMED + (WIDER_RANKS if args.diagnose else ())
    for shape in WIDER_CHECKED + timed:
        q, k, v, do = (torch.randn(shape, generator=gen, device=dev)
                       for _ in range(4))
        for causal in (False, True):
            key = f"{shape} causal={causal}"
            o_ref, lse_ref = fa.flash_attention_ref(q, k, v, causal=causal)
            delta = fa.flash_attention_delta(o_ref, do)
            want = dict(o=o_ref, lse=lse_ref,
                        dq=fa.flash_attention_dq_ref(q, k, v, do, lse_ref,
                                                     delta, causal))
            want["dk"], want["dv"] = fa.flash_attention_dkv_ref(
                q, k, v, do, lse_ref, delta, causal)
            fns, got = {}, {}
            for tag, parts in libs.items():
                outs = [torch.zeros_like(x) for x in (q, lse_ref, q, k, v)]
                fns[tag] = calls(parts, q, k, v, do, lse_ref, delta, outs,
                                 causal)
                for part, fn in fns[tag].items():
                    if fn():
                        sys.exit(f"bench_flash: {tag} {part} {key}: launch "
                                 "failed")
                got[tag] = dict(zip(("o", "lse", "dq", "dk", "dv"), outs))
            torch.cuda.synchronize()
            for tag in libs:
                errs = {}
                for n, w in want.items():
                    atol, rtol = ((FWD_LSE_ATOL, 0.0) if n == "lse" else
                                  (FWD_ATOL, FWD_RTOL) if n == "o" else
                                  (BWD_ATOL, BWD_RTOL))
                    err = (got[tag][n] - w).abs()
                    used = float((err / (atol + rtol * w.abs())).max())
                    errs[n] = dict(max_abs=float(err.max()), used=used)
                    if used > 1.0:
                        (failures if tag == "current" else checks).append(
                            dict(version=tag, shape=shape, causal=causal,
                                 output=n, used=used, over_tolerance=True))
                same = {part: all(torch.equal(got[tag][n], got["current"][n])
                                  for n in outs_)
                        for part, outs_ in (("fwd", ("o", "lse")),
                                            ("bwd", ("dq", "dk", "dv")))}
                checks.append(dict(version=tag, shape=shape, causal=causal,
                                   errs=errs, bit_identical_to_current=same))
                print(f"check [wider {tag}] {key}: " + ", ".join(
                    f"{n} {e['max_abs']:.3e} ({e['used']:.3f} of its "
                    f"tolerance)" for n, e in errs.items()) +
                    ("" if tag == "current" else
                     f"; forward {'bit-identical to' if same['fwd'] else 'differs from'}"
                     f" current, backward {'bit-identical to' if same['bwd'] else 'differs from'}"
                     " current"))
            if shape not in timed:
                continue
            b, h, t, d = shape
            pairs = b * h * t * t / (2 if causal else 1)
            entry = times[key] = {}
            for part, tensors, rows, flops in (("fwd", 4, 1, 4),
                                               ("dq", 5, 2, 6),
                                               ("dkv", 6, 2, 8)):
                runs = collections.defaultdict(list)
                # the versions whose library for this part is not current's
                turn = {tag: f[part] for tag, f in fns.items()
                        if tag == "current" or
                        versions[tag][part] != versions["current"][part]}
                if len(turn) > 1:
                    in_turns(torch, time_ms, turn, runs)
                else:
                    runs["current"].append(time_ms(torch, turn["current"]))
                bnd, by = flash_bound_ms(
                    (tensors * b * h * t * d + rows * b * h * t) * 4,
                    flops * pairs * d)
                entry[part] = dict(bound_ms=bnd, bound_by=by, **{
                    tag: dict(runs=r, median=statistics.median(r))
                    for tag, r in runs.items()})
                print(f"time [wider] {part} {key} f32: " + ", ".join(
                    f"{tag} {statistics.median(r):.5f}"
                    for tag, r in runs.items()) +
                    f" ms; bound {bnd:.6f} ({by}) ({card})")
            pair = {tag: entry["dq"][tag]["median"] + entry["dkv"][tag]["median"]
                    for tag in fns if tag in entry["dq"] and tag in entry["dkv"]}
            entry["pair"] = pair
            print(f"time [wider] dQ + dK/dV {key} f32: " + ", ".join(
                f"{tag} {ms:.5f}" for tag, ms in pair.items()) +
                f" ms ({card})")
        del q, k, v, do
        torch.cuda.empty_cache()
    # each compared version's forward and backward against the current
    # ones' outputs, over every checked shape
    for tag in libs:
        if tag == "current":
            continue
        mine = [c["bit_identical_to_current"] for c in checks
                if c["version"] == tag and "bit_identical_to_current" in c]
        for what, key in (("forward", "fwd"), ("backward (dQ, dK, dV)", "bwd")):
            same = all(c[key] for c in mine)
            result.setdefault("bit_identical_everywhere", {}).setdefault(
                tag, {})[key] = same
            print(f"[wider {tag}] {what} {'bit-identical to' if same else 'differs from'}"
                  f" current's at every checked shape, causal and not "
                  f"({len(mine)} checks)")
    result.update(checks=checks, times_ms=times, failures=failures)
    write_out(args, result)
    if failures:
        print("bench_flash: FAILED:\n  " + "\n  ".join(map(str, failures)))
        sys.exit(1)


def write_out(args, result) -> None:
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)


def bf16_flash(args, torch, kernels, fa, card) -> None:
    """--bf16: build, inspect, check and time the bf16 forward and
    backward against the compared sources (see the module's docstring)."""
    from chip_smoke import (BF16_BWD_ATOL_FLOOR, BF16_BWD_ATOL_SHARE,
                            BF16_BWD_RTOL, BF16_FWD_SHAPES, BF16_LSE_ATOL,
                            BF16_O_TIPPED_SHARE, BF16_SHAPES,
                            WIDE_BF16_SHAPES, flash_bf16_bound,
                            leading_key_inputs, o_fault2_order, o_tipped,
                            o_unrounded_p, o_used, sdpa_backend, time_ms)
    # kind -> {tag: source}: the bf16 forward and backward, and the float32
    # forward and backward, held bit-identical to the compared ones
    srcs = {"fwd": {"current": kernels.source_path(BF16_FWD)},
            "bwd": {"current": kernels.source_path(BF16_BWD)},
            "f32fwd": {"current": kernels.source_path(FWD)},
            "f32bwd": {"current": kernels.source_path(BWD)}}
    entries = {"fwd": "zoo_flash_attention_fwd_bf16",
               "bwd": "zoo_flash_attention_dq_bf16",
               "f32fwd": "zoo_flash_attention_fwd",
               "f32bwd": "zoo_flash_attention_dq"}
    names = {"fwd": [BF16_FWD], "bwd": BF16_NAMES, "f32fwd": [FWD],
             "f32bwd": F32_NAMES}
    for p in args.compare:
        tag = os.path.splitext(os.path.basename(p))[0]
        for kind, entry in entries.items():
            if defines(p, entry):
                srcs[kind][tag] = p
    diagnostic = set()
    if args.diagnose:
        for kind, source, variants in (("bwd", BF16_BWD, DIAGNOSE_BF16),
                                       ("fwd", BF16_FWD, DIAGNOSE_BF16_FWD)):
            for tag, path in variant_sources(
                    kernels.CSRC_DIR, kernels.BUILD_DIR, source,
                    variants).items():
                srcs[kind][tag] = path
                diagnostic.add(tag)
    result = {"card": card, "versions": {}}
    started = {(kind, tag): start_build(kernels, src, f"{kind}_{tag}")
               for kind, versions in srcs.items()
               for tag, src in versions.items()}
    libs = {kind: {} for kind in srcs}
    bad_builds = []
    for (kind, tag), st in started.items():
        src = srcs[kind][tag]
        lib, path, ptxas = finish_build(kernels, st, src, names[kind])
        libs[kind][tag] = lib
        if kind.startswith("f32"):
            continue
        mix = {k: v for k, v in sass_mix(path, kernels.nvcc_path()).items()
               if "bf16" in k or k == "error"}
        result["versions"][f"{kind}:{tag}"] = {"source": src, "ptxas": ptxas,
                                               "sass": mix}
        print(f"[bf16 {kind}:{tag}] {src}")
        for ln in ptxas:
            print(f"  {ln}")
        for kern, counts in mix.items():
            tensor = {op: sum(n for k, n in counts.items() if k.startswith(op))
                      for op in ("HGMMA", "HMMA")}
            print(f"  sass {kern}: {counts}; tensor-core instructions "
                  f"{tensor}")
            if tag == "current" and (tensor["HMMA"] or not tensor["HGMMA"]):
                bad_builds.append(f"{kern}: {tensor}")
        if tag == "current":
            if len(mix) != len(names[kind]) * 4:      # head_dim 64 to 256
                bad_builds.append(f"{kind}: kernels {sorted(mix)}")
            bad_builds += [ln for ln in ptxas if "Potential" in ln or
                           re.search(r"[1-9]\d* bytes spill", ln)]
    if bad_builds:
        sys.exit("bench_flash: a current bf16 kernel is not wgmma alone, "
                 f"spills or serializes: {bad_builds}")

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(12)
    stream = torch.cuda.current_stream().cuda_stream
    failures = []

    def run_fwd(lib, q, k, v, causal):
        b, h, t, d = q.shape
        o = torch.empty_like(q)
        lse = torch.empty((b * h, t, 1), device=dev)
        args_ = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 lse.data_ptr(), b * h, t, d)
        if q.dtype == torch.float32:
            err = lib.zoo_flash_attention_fwd(*args_, float(d ** -0.5),
                                              int(causal), stream)
        else:
            err = lib.zoo_flash_attention_fwd_bf16(
                *args_, fa.q_scale(d ** -0.5, q.dtype), int(causal), stream)
        if err:
            sys.exit(f"bench_flash: forward launch failed, cudaError {err}")
        return o, lse

    def run(lib, q, k, v, do, lse, delta, causal, parts=("dq", "dkv")):
        b, h, t, d = q.shape
        dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
        ptrs = [x.data_ptr() for x in (q, k, v, do, lse, delta)]
        scale = float(d ** -0.5)
        err = 0
        if q.dtype == torch.float32:
            err = lib.zoo_flash_attention_dq(*ptrs, dq.data_ptr(), b * h, t,
                                             d, scale, int(causal), stream)
            err = err or lib.zoo_flash_attention_dkv(
                *ptrs, dk.data_ptr(), dv.data_ptr(), b * h, t, d, scale,
                int(causal), stream)
        else:
            qs = fa.q_scale(scale, q.dtype)
            if "dq" in parts:
                err = lib.zoo_flash_attention_dq_bf16(
                    *ptrs, dq.data_ptr(), b * h, t, d, scale, qs, int(causal),
                    stream)
            if "dkv" in parts:
                err = err or lib.zoo_flash_attention_dkv_bf16(
                    *ptrs, dk.data_ptr(), dv.data_ptr(), b * h, t, d, qs,
                    int(causal), stream)
        if err:
            sys.exit(f"bench_flash: backward launch failed, cudaError {err}")
        return dq, dk, dv

    def bwd_err(name, got, want):
        atol = (BF16_BWD_ATOL_SHARE * float(want.float().abs().max()) +
                BF16_BWD_ATOL_FLOOR)
        err = (got.float() - want.float()).abs()
        if not float((err - BF16_BWD_RTOL * want.float().abs()).max()) <= atol:
            failures.append(f"{name}: max abs err {float(err.max()):.3e} "
                            "over tolerance")
        return float(err.max())

    def bf16_inputs(shape, n):
        return [torch.randn(shape, generator=gen, device=dev)
                .to(torch.bfloat16) for _ in range(n)]

    # the head_dims each compared source builds (its entry points' cases;
    # sources before the 192 and 256 instances hold 64 and 128)
    widths = {}
    for versions in srcs.values():
        for tag, src in versions.items():
            with open(src) as f:
                text = f.read()
            widths[tag] = {d for d in (64, 128, 192, 256)
                           if f"case {d}:" in text}

    def takes(tag, d):
        """The current build and its variants take every width, a compared
        source the widths it builds."""
        return tag == "current" or tag in diagnostic or d in widths[tag]

    def same_as_current(kind, tag_s, outs, names_):
        """Each compared source's outputs, and each ``BF16_SAME`` variant's,
        against the current build's, bit for bit (the head_dim 64/128
        instances must not move)."""
        for tag, got in outs.items():
            if tag == "current":
                continue
            same = [torch.equal(a, b_) for a, b_ in zip(outs["current"], got)]
            if not all(same):
                failures.append(f"bf16 {kind}:current and {kind}:{tag} "
                                f"{tag_s}: not bit-identical "
                                f"{dict(zip(names_, same))}")
            checks.append(dict(version=f"{kind}:current={kind}:{tag}",
                               shape=tag_s, bit_identical=dict(zip(names_,
                                                                  same))))
            print(f"compare [bf16 {kind}:current] against [bf16 {kind}:{tag}]"
                  f" {tag_s}: {', '.join(names_)} bit-identical {same}")

    checks = []
    fwds = {tag: lib for tag, lib in libs["fwd"].items()
            if tag not in diagnostic}
    for shape in BF16_SHAPES + BF16_FWD_SHAPES + WIDE_BF16_SHAPES:
        q, k, v = bf16_inputs(shape, 3)
        for causal in (False, True):
            tag_s = f"{shape} causal={causal}"
            o_ref, lse_ref = fa.flash_attention_ref(q, k, v, causal=causal)
            outs = {}
            for tag, lib in fwds.items():
                if not takes(tag, shape[3]):
                    continue
                got, again = (run_fwd(lib, q, k, v, causal) for _ in range(2))
                outs[tag] = got
                torch.cuda.synchronize()
                used = o_used(got[0], o_ref)
                e_o = float((got[0].float() - o_ref.float()).abs().max())
                e_l = float((got[1] - lse_ref).abs().max())
                same = all(torch.equal(a, b_) for a, b_ in zip(got, again))
                if not used <= 1.0:
                    failures.append(f"bf16 fwd:{tag} O {tag_s}: {used:.3f} "
                                    "of its tolerance")
                if not e_l <= BF16_LSE_ATOL:
                    failures.append(f"bf16 fwd:{tag} LSE {tag_s}: {e_l:.3e}")
                if not same:
                    failures.append(f"bf16 fwd:{tag} {tag_s}: two launches "
                                    "differ")
                checks.append(dict(version=f"fwd:{tag}", shape=shape,
                                   causal=causal, o_used=used,
                                   max_abs_err=dict(o=e_o, lse=e_l),
                                   bit_identical_relaunch=same))
                print(f"check [bf16 fwd:{tag}] {tag_s}: O max abs err "
                      f"{e_o:.3e}, {used:.3f} of its tolerance, LSE "
                      f"{e_l:.3e}; two launches "
                      f"{'bit-identical' if same else 'DIFFER'}")
            same_as_current("fwd", tag_s, outs, ("o", "lse"))
            del o_ref, lse_ref, outs
        # P's rounding: where key 0 leads every row, each kernel rounds P as
        # the plain version does; at phase 14's shapes both controls fail
        q, k, v = leading_key_inputs(torch, shape, gen, dev)
        for causal in (False, True):
            tag_s = f"{shape} causal={causal}, key 0 leading"
            o_ref = fa.flash_attention_ref(q, k, v, causal=causal)[0]
            controls = [o_tipped(fn(torch, q, k, v, causal), o_ref)
                        for fn in (o_fault2_order, o_unrounded_p)]
            # phase 14's shapes; phase 26's on causal rows of T > 1
            must_fail = shape in BF16_SHAPES or (
                shape in WIDE_BF16_SHAPES and causal and shape[2] > 1)
            if must_fail and any(
                    c_share <= BF16_O_TIPPED_SHARE and c_used <= 1.0
                    for c_share, c_used in controls):
                failures.append(f"bf16 fwd {tag_s}: a control passes "
                                f"({controls})")
            for tag, lib in fwds.items():
                if not takes(tag, shape[3]):
                    continue
                tipped, used = o_tipped(run_fwd(lib, q, k, v, causal)[0],
                                        o_ref)
                if not (tipped <= BF16_O_TIPPED_SHARE and used <= 1.0):
                    failures.append(f"bf16 fwd:{tag} {tag_s}: O differs on "
                                    f"{tipped:.4%}, {used:.3f} of its "
                                    "tolerance")
                checks.append(dict(version=f"fwd:{tag}", shape=shape,
                                   causal=causal, key0_tipped_share=tipped,
                                   o_used=used, controls=controls))
                print(f"check [bf16 fwd:{tag}] {tag_s}: O differs from the "
                      f"plain version's on {tipped:.4%} of its elements, "
                      f"{used:.3f} of its tolerance; controls {controls}")
        del q, k, v
    for shape in BF16_SHAPES + WIDE_BF16_SHAPES:
        for causal in (False, True):
            if shape[2] >= 4096 and not causal:
                continue
            q, k, v, do = bf16_inputs(shape, 4)
            o, lse = fa.flash_attention_fwd(q, k, v, causal=causal)
            delta = fa.flash_attention_delta(o, do)
            want = (fa.flash_attention_dq_ref(q, k, v, do, lse, delta, causal),
                    *fa.flash_attention_dkv_ref(q, k, v, do, lse, delta,
                                                causal))
            tag_s = f"{shape} causal={causal}"
            outs = {}
            for tag, lib in libs["bwd"].items():
                if ((tag in diagnostic and tag not in BF16_SAME)
                        or not takes(tag, shape[3])):
                    continue
                got = run(lib, q, k, v, do, lse, delta, causal)
                outs[tag] = got
                again = run(lib, q, k, v, do, lse, delta, causal)
                torch.cuda.synchronize()
                errs = [bwd_err(f"bf16 bwd:{tag} {n} {tag_s}", x, w)
                        for n, x, w in zip(("dQ", "dK", "dV"), got, want)]
                same = all(torch.equal(a, b_) for a, b_ in zip(got, again))
                if not same:
                    failures.append(f"bf16 bwd:{tag} {tag_s}: two launches "
                                    "differ")
                checks.append(dict(version=f"bwd:{tag}", shape=shape,
                                   causal=causal, bit_identical_relaunch=same,
                                   max_abs_err=dict(zip(("dq", "dk", "dv"),
                                                        errs))))
                print(f"check [bf16 bwd:{tag}] {tag_s}: max abs err dQ "
                      f"{errs[0]:.3e} dK {errs[1]:.3e} dV {errs[2]:.3e}; two "
                      f"launches {'bit-identical' if same else 'DIFFER'}")
            same_as_current("bwd", tag_s, outs, ("dq", "dk", "dv"))
            del q, k, v, do, o, lse, delta, want, outs
    for shape, causal in SHAPES:
        q, k, v, do = (torch.randn(shape, generator=gen, device=dev)
                       for _ in range(4))
        o_ref, lse = fa.flash_attention_ref(q, k, v, causal=causal)
        delta = fa.flash_attention_delta(o_ref, do)
        cur = (*run_fwd(libs["f32fwd"]["current"], q, k, v, causal),
               *run(libs["f32bwd"]["current"], q, k, v, do, lse, delta,
                    causal))
        for kind, outs in (("f32fwd", ("o", "lse")),
                           ("f32bwd", ("dq", "dk", "dv"))):
            mine = cur[:2] if kind == "f32fwd" else cur[2:]
            for tag, lib in libs[kind].items():
                if tag == "current":
                    continue
                theirs = (run_fwd(lib, q, k, v, causal) if kind == "f32fwd"
                          else run(lib, q, k, v, do, lse, delta, causal))
                same = [torch.equal(a, b_) for a, b_ in zip(mine, theirs)]
                if not all(same):
                    failures.append(f"{kind}:current and {kind}:{tag} "
                                    f"{shape} causal={causal}: not "
                                    f"bit-identical {dict(zip(outs, same))}")
                checks.append(dict(version=f"{kind}:current={kind}:{tag}",
                                   shape=shape, causal=causal,
                                   bit_identical=dict(zip(outs, same))))
                print(f"compare [{kind}:current] against [{kind}:{tag}] "
                      f"{shape} causal={causal}: {', '.join(outs)} "
                      f"bit-identical {same}")
    torch.cuda.empty_cache()
    result["checks"] = checks

    sdpa = torch.nn.functional.scaled_dot_product_attention
    for key in ("fwd_times_ms", "times_ms", "library_ms", "bound_ms"):
        result[key] = {}
    for shape in BF16_TIMED:
        key = "x".join(map(str, shape))
        q, k, v, do = bf16_inputs(shape, 4)
        backend = sdpa_backend(torch, q, k, v)
        runs = collections.defaultdict(list)
        in_turns(torch, time_ms, {
            tag: (lambda lib=lib: run_fwd(lib, q, k, v, True))
            for tag, lib in libs["fwd"].items() if takes(tag, shape[3])},
            runs)
        lib_fwd = time_ms(torch, lambda: sdpa(q, k, v, is_causal=True))
        bound_fwd = flash_bf16_bound(shape, True, 2, 4, 1)[0]
        result["fwd_times_ms"][key] = {
            tag: dict(runs=r, median=statistics.median(r))
            for tag, r in runs.items()}
        for tag, r in result["fwd_times_ms"][key].items():
            print(f"time [bf16 fwd:{tag}] {shape} causal: "
                  f"{r['median']:.5f} ms {r['runs']} "
                  f"({bound_fwd / r['median']:.3f} of its bound) ({card})")
        print(f"library: bf16 scaled_dot_product_attention {shape} causal "
              f"({backend}) forward {lib_fwd:.5f} ms; bound "
              f"{bound_fwd:.6f} ms ({card})")
        o, lse = fa.flash_attention_fwd(q, k, v, causal=True)
        delta = fa.flash_attention_delta(o, do)
        times = collections.defaultdict(lambda: collections.defaultdict(list))
        for part, parts in (("dq", ("dq",)), ("dkv", ("dkv",)),
                            ("pair", ("dq", "dkv"))):
            runs = collections.defaultdict(list)
            in_turns(torch, time_ms, {
                tag: (lambda lib=lib, parts=parts: run(
                    lib, q, k, v, do, lse, delta, True, parts))
                for tag, lib in libs["bwd"].items() if takes(tag, shape[3])},
                runs)
            for tag, r in runs.items():
                times[tag][part] = r
        qg, kg, vg = (x.clone().requires_grad_() for x in (q, k, v))
        out = sdpa(qg, kg, vg, is_causal=True)
        lib_bwd = time_ms(torch, lambda: torch.autograd.grad(
            out, (qg, kg, vg), do, retain_graph=True))
        bounds = {"fwd": bound_fwd,
                  "dq": flash_bf16_bound(shape, True, 5, 5, 2)[0],
                  "dkv": flash_bf16_bound(shape, True, 8, 6, 2)[0]}
        bounds["pair"] = bounds["dq"] + bounds["dkv"]
        result["times_ms"][key] = {
            tag: {p: dict(runs=r, median=statistics.median(r))
                  for p, r in parts.items()} for tag, parts in times.items()}
        result["library_ms"][key] = {"fwd": lib_fwd, "bwd": lib_bwd}
        result["bound_ms"][key] = bounds
        for tag, parts in result["times_ms"][key].items():
            print(f"time [bf16 bwd:{tag}] {shape} causal: " + ", ".join(
                f"{p} {r['median']:.5f} ms {r['runs']} "
                f"({bounds[p] / r['median']:.3f} of its bound)"
                for p, r in parts.items()) + f" ({card})")
        print(f"library: bf16 scaled_dot_product_attention {shape} causal "
              f"({backend}) backward (dQ, dK, dV together) {lib_bwd:.5f} ms; "
              f"bounds {bounds} ({card})")
        del q, k, v, do, o, lse, delta, qg, kg, vg, out
        torch.cuda.empty_cache()
    result["failures"] = failures
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps({
        "fwd_times_ms": {k_: {t_: r["median"] for t_, r in v_.items()}
                         for k_, v_ in result["fwd_times_ms"].items()},
        "times_ms": {k_: {t_: {p: r["median"] for p, r in x.items()}
                          for t_, x in v_.items()}
                     for k_, v_ in result["times_ms"].items()},
        "library_ms": result["library_ms"], "card": card}))
    if failures:
        print("bench_flash: FAILED:\n  " + "\n  ".join(failures))
        sys.exit(1)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--compare", action="append", default=[])
    ap.add_argument("--diagnose", action="store_true")
    ap.add_argument("--fit", action="store_true")
    ap.add_argument("--bf16", action="store_true")
    ap.add_argument("--wide", action="store_true")
    ap.add_argument("--wider", action="store_true")
    # --wider --diagnose: only these variants of WIDER_VARIANTS (comma
    # separated names; default all)
    ap.add_argument("--variants", default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        sys.exit("bench_flash: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from chip_smoke import (BWD_ATOL, BWD_RTOL, FWD_ATOL, FWD_LSE_ATOL,
                            FWD_RTOL, gpu_line, time_ms)
    from analytics_zoo_torch.ops import flash_attention as fa
    from analytics_zoo_torch.ops import kernels

    card = gpu_line()
    print(f"gpu: {card}")
    if args.bf16:
        return bf16_flash(args, torch, kernels, fa, card)
    if args.wide:
        return wide_flash(args, torch, kernels, fa, card)
    if args.wider:
        return wider_flash(args, torch, kernels, fa, card)
    # direction -> {tag: source}
    versions = {FWD: {}, BWD: {}}
    for p in args.compare:
        versions[direction(p)][os.path.splitext(os.path.basename(p))[0]] = p
    for dirn in (FWD, BWD):
        versions[dirn]["current"] = kernels.source_path(dirn)
    diagnostic = set()
    if args.diagnose:
        for tag, paths in diagnose_sources(kernels.CSRC_DIR,
                                           kernels.BUILD_DIR).items():
            for dirn, path in paths.items():
                versions[dirn][tag] = path
            diagnostic.add(tag)
    libs = {FWD: {}, BWD: {}}
    result = {"card": card, "versions": {}}
    names = {FWD: [FWD], BWD: ["flash_attention_dq", "flash_attention_dkv"]}
    started = {(dirn, tag): start_build(kernels, src, f"{dirn}_{tag}")
               for dirn in (FWD, BWD) for tag, src in versions[dirn].items()}
    for dirn in (FWD, BWD):
        for tag, src in versions[dirn].items():
            lib, path, ptxas = finish_build(kernels, started[dirn, tag], src,
                                            names[dirn])
            libs[dirn][tag] = lib
            mix = sass_mix(path, kernels.nvcc_path())
            result["versions"][f"{dirn}:{tag}"] = {
                "source": src, "ptxas": ptxas, "sass": mix}
            print(f"[{dirn}:{tag}] {src}")
            for ln in ptxas:
                print(f"  {ln}")
            for kern, counts in mix.items():
                print(f"  sass {kern}: {counts}")

    if args.fit:
        result["fit_losses"] = fit_losses(torch, kernels, libs[FWD], card)
        if args.out:
            os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                        exist_ok=True)
            with open(args.out, "w") as f:
                json.dump(result, f, indent=1)
        return

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    failures = []

    def err_over(name, got, want, atol, rtol):
        """Max abs error; records a failure where |err| > atol + rtol|want|."""
        err = (got - want).abs()
        if not float((err - rtol * want.abs()).max()) <= atol:
            failures.append(f"{name}: max abs err {float(err.max()):.3e} "
                            f"over tolerance (atol {atol}, rtol {rtol})")
        return float(err.max())

    def run_fwd(lib, q, k, v, causal):
        b, h, t, d = q.shape
        o = torch.empty_like(q)
        lse = torch.empty((b * h, t, 1), device=dev)
        err = lib.zoo_flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), b * h, t, d, float(d ** -0.5), int(causal),
            stream)
        if err:
            sys.exit(f"bench_flash: forward launch failed, cudaError {err}")
        return o, lse

    def run_bwd(lib, q, k, v, do, lse, delta, causal):
        b, h, t, d = q.shape
        dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
        ptrs = [x.data_ptr() for x in (q, k, v, do, lse, delta)]
        scale = float(d ** -0.5)
        err = lib.zoo_flash_attention_dq(*ptrs, dq.data_ptr(), b * h, t, d,
                                         scale, int(causal), stream)
        err = err or lib.zoo_flash_attention_dkv(
            *ptrs, dk.data_ptr(), dv.data_ptr(), b * h, t, d, scale,
            int(causal), stream)
        if err:
            sys.exit(f"bench_flash: backward launch failed, cudaError {err}")
        return dq, dk, dv

    checks = []
    for shape, causal in SHAPES:
        q, k, v, do = (torch.randn(shape, generator=gen, device=dev)
                       for _ in range(4))
        o_ref, lse_ref = fa.flash_attention_ref(q, k, v, causal=causal)
        delta = fa.flash_attention_delta(o_ref, do)
        want = (fa.flash_attention_dq_ref(q, k, v, do, lse_ref, delta, causal),
                *fa.flash_attention_dkv_ref(q, k, v, do, lse_ref, delta,
                                            causal))
        tag_s = f"{shape} causal={causal}"
        fwd_out = {}
        for tag, lib in libs[FWD].items():
            if tag in diagnostic:
                continue
            got, again = run_fwd(lib, q, k, v, causal), \
                run_fwd(lib, q, k, v, causal)
            torch.cuda.synchronize()
            fwd_out[tag] = got
            e_o = err_over(f"fwd:{tag} O {tag_s}", got[0], o_ref, FWD_ATOL,
                           FWD_RTOL)
            e_l = err_over(f"fwd:{tag} LSE {tag_s}", got[1], lse_ref,
                           FWD_LSE_ATOL, 0.0)
            same = all(torch.equal(a, b_) for a, b_ in zip(got, again))
            if not same:
                failures.append(f"fwd:{tag} {tag_s}: two launches differ")
            checks.append(dict(version=f"fwd:{tag}", shape=shape,
                               causal=causal, max_abs_err=dict(o=e_o, lse=e_l),
                               bit_identical_relaunch=same))
            print(f"check [fwd:{tag}] {tag_s}: max abs err O {e_o:.3e} LSE "
                  f"{e_l:.3e} (|O| max {float(o_ref.abs().max()):.3e}); two "
                  f"launches {'bit-identical' if same else 'DIFFER'}")
        for tag, got in fwd_out.items():
            if tag != "current":
                diff = float((got[0] - fwd_out["current"][0]).abs().max())
                print(f"compare [fwd:current] against [fwd:{tag}] {tag_s}: O "
                      f"max abs diff {diff:.3e}")
        bwd_out = {}
        for tag, lib in libs[BWD].items():
            if tag in diagnostic:
                continue
            got = run_bwd(lib, q, k, v, do, lse_ref, delta, causal)
            again = run_bwd(lib, q, k, v, do, lse_ref, delta, causal)
            torch.cuda.synchronize()
            bwd_out[tag] = got
            errs = [err_over(f"bwd:{tag} {n} {tag_s}", x, w, BWD_ATOL,
                             BWD_RTOL)
                    for n, x, w in zip(("dQ", "dK", "dV"), got, want)]
            same = all(torch.equal(a, b_) for a, b_ in zip(got, again))
            if not same:
                failures.append(f"bwd:{tag} {tag_s}: two launches differ")
            checks.append(dict(version=f"bwd:{tag}", shape=shape,
                               causal=causal,
                               max_abs_err=dict(zip(("dq", "dk", "dv"), errs)),
                               bit_identical_relaunch=same))
            print(f"check [bwd:{tag}] {tag_s}: max abs err dQ {errs[0]:.3e} "
                  f"dK {errs[1]:.3e} dV {errs[2]:.3e}; two launches "
                  f"{'bit-identical' if same else 'DIFFER'}")
        for tag, got in bwd_out.items():
            if tag != "current":
                same = [torch.equal(a, b_)
                        for a, b_ in zip(bwd_out["current"], got)]
                checks.append(dict(version=f"bwd:current=bwd:{tag}",
                                   shape=shape, causal=causal,
                                   bit_identical=dict(zip(("dq", "dk", "dv"),
                                                          same))))
                print(f"compare [bwd:current] against [bwd:{tag}] {tag_s}: "
                      f"dQ, dK, dV bit-identical {same}")
    result["checks"] = checks

    b, h, t, d = TRAIN_SHAPE
    q, k, v, do = (torch.randn(TRAIN_SHAPE, generator=gen, device=dev)
                   for _ in range(4))
    o_ref, lse = fa.flash_attention_ref(q, k, v)
    delta = fa.flash_attention_delta(o_ref, do)
    o, lse_out = torch.empty_like(q), torch.empty_like(lse)
    dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
    scale = float(d ** -0.5)
    qkv = [x.data_ptr() for x in (q, k, v)]
    ptrs = [x.data_ptr() for x in (q, k, v, do, lse, delta)]

    def fwd_fn(lib):
        return lambda: lib.zoo_flash_attention_fwd(
            *qkv, o.data_ptr(), lse_out.data_ptr(), b * h, t, d, scale, 0,
            stream)

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

    times = collections.defaultdict(lambda: collections.defaultdict(list))
    fwd_runs = collections.defaultdict(list)
    in_turns(torch, time_ms, {tag: fwd_fn(lib)
                              for tag, lib in libs[FWD].items()}, fwd_runs)
    for tag, r in fwd_runs.items():
        times[f"fwd:{tag}"]["fwd"] = r
    for part, make in (("dq", dq_fn), ("dkv", dkv_fn), ("pair", pair_fn)):
        runs = collections.defaultdict(list)
        in_turns(torch, time_ms, {tag: make(lib)
                                  for tag, lib in libs[BWD].items()}, runs)
        for tag, r in runs.items():
            times[f"bwd:{tag}"][part] = r

    sdpa = torch.nn.functional.scaled_dot_product_attention
    from torch.nn.attention import SDPBackend, sdpa_kernel
    lib_fwd = time_ms(torch, lambda: sdpa(q, k, v))
    with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
        lib_fwd_eff = time_ms(torch, lambda: sdpa(q, k, v))
        eff_err = float((sdpa(q, k, v) - o_ref).abs().max())
    qg, kg, vg = (x.clone().requires_grad_() for x in (q, k, v))
    out = sdpa(qg, kg, vg)
    lib_bwd = time_ms(torch, lambda: torch.autograd.grad(
        out, (qg, kg, vg), do, retain_graph=True))
    result["times_ms"] = {tag: {p: dict(runs=r, median=statistics.median(r))
                                for p, r in parts.items()}
                          for tag, parts in times.items()}
    result["library_ms"] = {"fwd_default": lib_fwd,
                            "fwd_efficient": lib_fwd_eff,
                            "bwd_default": lib_bwd}
    result["library_fwd_efficient_max_abs_err"] = eff_err
    flops = {"fwd": 4 * b * h * t * t * d, "dq": 6 * b * h * t * t * d,
             "dkv": 8 * b * h * t * t * d}
    flops["pair"] = flops["dq"] + flops["dkv"]
    result["bound_ms_3xtf32"] = {p: 3 * f / 495e12 * 1e3
                                 for p, f in flops.items()}
    result["bound_ms_fp32_fma"] = {p: f / 67e12 * 1e3
                                   for p, f in flops.items()}
    for tag, parts in result["times_ms"].items():
        print(f"time [{tag}] {TRAIN_SHAPE} f32: " + ", ".join(
            f"{p} {r['median']:.5f} ms {r['runs']}" for p, r in parts.items())
            + f" ({card})")
    print(f"library: f32 scaled_dot_product_attention forward {lib_fwd:.5f} "
          f"ms (PyTorch's choice of backend), {lib_fwd_eff:.5f} ms "
          f"(EFFICIENT_ATTENTION forced; O max abs err {eff_err:.3e}); "
          f"backward {lib_bwd:.5f} ms; bounds 3xTF32 "
          f"{result['bound_ms_3xtf32']}, f32 FMA "
          f"{result['bound_ms_fp32_fma']} ({card})")
    result["failures"] = failures
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps({"times_ms": {t_: {p: r["median"] for p, r in x.items()}
                                   for t_, x in result["times_ms"].items()},
                      "library_ms": result["library_ms"], "card": card}))
    if failures:
        print("bench_flash: FAILED:\n  " + "\n  ".join(failures))
        sys.exit(1)


if __name__ == "__main__":
    main()
