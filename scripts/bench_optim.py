#!/usr/bin/env python3
"""Time the port's fused optimizer updates on the card against the
per-leaf design they replace, the library and the plain versions.

    python3 scripts/bench_optim.py [--compare-adam PATH.cu]
        [--compare-sgd PATH.cu] [--baseline-root DIR] [--out PATH]

The optimizer counterpart of ``scripts/bench_flash.py --compare``.  Leaf
sets: NeuralCF at ``bench_ncf``'s width (12 leaves), Wide & Deep at the
census configuration (11) and the BERT-base ``TextClassifier`` (154),
their shapes taken from the port's models, their values seeded.

1. The kernels alone, in one process, in turns (compared, current,
   library, library, current, compared), each by CUDA events as
   ``chip_smoke.py`` times them: the compared per-leaf sources (default
   ``chiprun_archive/fused_{adam,sgd}_988dcd4.cu``: ``git show
   988dcd4:analytics_zoo_torch/csrc/fused_adam.cu``, and ``fused_sgd``),
   one launch a leaf reading a 4-float scalar buffer; the multi-tensor
   kernels, one launch; ``torch.optim.Adam``/``SGD(fused=True).step`` over
   the same leaves; and the plain versions once.  The current kernels
   must leave every leaf bit-identical to the compared ones'.
2. The step's whole fused update (``build_fused_update``) of the current
   package and of the package under ``--baseline-root`` (default
   ``chiprun_archive/988dcd4``: ``git archive 988dcd4 analytics_zoo_torch``
   unpacked there), each in a process of its own (``--update-only``), in
   turns (baseline, current, current, baseline): its device time and its
   host time a call (``chip_smoke.host_ms``: each call with nothing
   queued on the device).
3. With ``--diagnose``, variants of the current sources (``DIAGNOSE``:
   one text substitution each, built with ``-Xptxas -v`` like the current
   ones) timed in part 1's turns beside the current kernels, each checked
   bit-identical to them: what a design decision is worth.

Both parts print their numbers beside the card's name and power limit
and, with ``--out``, write them as JSON.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASELINE_COMMIT = "988dcd4"
ARCHIVE = os.path.join(ROOT, "chiprun_archive")
# the per-leaf entry points of the compared sources and their arguments:
# p, g, m, v, scal, n, b1, 1-b1, b2, 1-b2, eps, wd, lo, hi, flags, stream;
# p, g, trace, scal, n, momentum, wd, lo, hi, flags, stream
_P, _I, _F, _L = (ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                  ctypes.c_longlong)
PER_LEAF = {
    "fused_adam": ("zoo_fused_adam", [_P] * 5 + [_L] + [_F] * 8 + [_I, _P]),
    "fused_sgd": ("zoo_fused_sgd", [_P] * 4 + [_L] + [_F] * 4 + [_I, _P]),
}
BYTES_PER_ELEMENT = {"fused_adam": 28, "fused_sgd": 20}
MODELS = ("NeuralCF", "Wide & Deep", "BERT-base")
# --diagnose: variant -> (kernel, text in its current source, replacement)
DIAGNOSE = {
    "adam_bounds_by_block_only": ("fused_adam",
                                  "__launch_bounds__(mt::THREADS, 2)",
                                  "__launch_bounds__(mt::THREADS)"),
    "sgd_bounds_by_block_only": ("fused_sgd",
                                 "__launch_bounds__(mt::THREADS, 2)",
                                 "__launch_bounds__(mt::THREADS)"),
    "adam_large_table_only": (
        "fused_adam", "    if (leaves <= mt::SMALL) return "
        "launch<mt::SMALL>(rows, leaves, h, st, s);\n", ""),
}


def leaf_shapes():
    """{model: its leaves' shapes, in the trainer's order}, from the port's
    models built on the card."""
    import torch
    from analytics_zoo_torch.feature.datasets import movielens
    from analytics_zoo_torch.models.recommendation import (
        ColumnFeatureInfo, NeuralCF, WideAndDeep)
    from analytics_zoo_torch.models.textclassification import TextClassifier
    from analytics_zoo_torch.pipeline.api.keras.topology import tree_leaves
    ncf = NeuralCF(movielens.ML1M_USERS, movielens.ML1M_ITEMS, class_num=2,
                   user_embed=64, item_embed=64, mf_embed=64,
                   hidden_layers=(128, 64, 32))
    info = ColumnFeatureInfo(
        wide_base_cols=["gender", "age_bucket", "education"],
        wide_base_dims=[3, 10, 16],
        wide_cross_cols=["gender_age", "edu_age"],
        wide_cross_dims=[30, 160],
        embed_cols=["occupation", "relationship"],
        embed_in_dims=[48, 8], embed_out_dims=[16, 8],
        continuous_cols=["hours_per_week", "capital_gain"])
    wd = WideAndDeep(2, info, model_type="wide_n_deep",
                     hidden_layers=(64, 32, 16))
    bert = TextClassifier(class_num=20, token_length=768,
                          sequence_length=512, encoder="transformer",
                          n_head=12, n_block=12, max_words_num=30521,
                          encoder_output_dim=256)
    out = {}
    for name, model in zip(MODELS, (ncf, wd, bert)):
        model.model.init(torch.Generator().manual_seed(0))
        out[name] = [list(p.shape) for p in
                     tree_leaves(model.get_variables()["params"])]
    torch.cuda.empty_cache()
    return out


def leaf_columns(torch, shapes, dev, count):
    """``count`` lists of seeded float32 leaves of ``shapes``: params,
    gradients, then moments (a second moment non-negative)."""
    gen = torch.Generator(device=dev).manual_seed(1)
    cols = [[torch.randn(s, generator=gen, device=dev) * 1e-2
             for s in shapes] for _ in range(count)]
    if count == 4:
        cols[3] = [v.abs_() for v in cols[3]]
    return cols


def prepare_sources(args):
    """Write the compared sources and the baseline package from git where
    they are missing (in a checkout; the card's copy has no .git)."""
    todo = [(path, f"{BASELINE_COMMIT}:analytics_zoo_torch/csrc/{kernel}.cu")
            for path, kernel in ((args.compare_adam, "fused_adam"),
                                 (args.compare_sgd, "fused_sgd"))
            if not os.path.isfile(path)]
    for path, spec in todo:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "w") as f:
            subprocess.run(["git", "show", spec], cwd=ROOT, stdout=f,
                           check=True)
    if not os.path.isdir(os.path.join(args.baseline_root,
                                      "analytics_zoo_torch")):
        os.makedirs(args.baseline_root, exist_ok=True)
        archive = subprocess.run(
            ["git", "archive", BASELINE_COMMIT, "analytics_zoo_torch"],
            cwd=ROOT, capture_output=True, check=True).stdout
        subprocess.run(["tar", "-x", "-C", args.baseline_root],
                       input=archive, check=True)


def build_compared(kernels, paths):
    """Build each compared source (one nvcc each, started together) into
    the build directory; returns {kernel: its C entry point}."""
    started = {}
    os.makedirs(kernels.BUILD_DIR, exist_ok=True)
    for name, src in paths.items():
        out = os.path.join(kernels.BUILD_DIR, f"compared_{name}.so")
        cmd = [kernels.nvcc_path(), *kernels.NVCC_FLAGS, "-o", out, src]
        started[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT,
                                          text=True), out)
    entries = {}
    for name, (proc, out) in started.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            sys.exit(f"bench_optim: nvcc failed for {paths[name]}:\n{log}")
        entry, argtypes = PER_LEAF[name]
        fn = getattr(ctypes.CDLL(out), entry)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        entries[name] = fn
    return entries


def build_variants(kernels, diagnose):
    """Build the current optimizer sources and, with ``diagnose``, each
    ``DIAGNOSE`` variant (a copy of the source and its headers in a
    directory of its own), with ``-Xptxas -v``; prints each build's
    registers and spills; returns {variant: (kernel, C entry point)}."""
    import glob
    import shutil
    todo = {f"current_{k}": (k, None, None) for k in PER_LEAF}
    if diagnose:
        todo.update(DIAGNOSE)
    started = {}
    for tag, (name, old, new) in todo.items():
        d = os.path.join(kernels.BUILD_DIR, f"diag_{tag}")
        os.makedirs(d, exist_ok=True)
        for h in glob.glob(os.path.join(kernels.CSRC_DIR, "*.cuh")):
            shutil.copy(h, d)
        with open(kernels.source_path(name)) as f:
            text = f.read()
        if old is not None:
            if old not in text:
                sys.exit(f"bench_optim: --diagnose {tag}: {name}.cu no "
                         f"longer holds {old!r}")
            text = text.replace(old, new)
        src = os.path.join(d, f"{name}.cu")
        with open(src, "w") as f:
            f.write(text)
        out = os.path.join(d, "lib.so")
        cmd = [kernels.nvcc_path(), *kernels.NVCC_FLAGS, "-Xptxas", "-v",
               "-o", out, src]
        started[tag] = (name, out, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    built = {}
    for tag, (name, out, proc) in started.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            sys.exit(f"bench_optim: nvcc failed for {tag}:\n{log}")
        lines = [ln.strip() for ln in log.splitlines()
                 if "Used" in ln or "spill" in ln]
        print(f"ptxas [{tag}]: {lines}")
        _, entry, argtypes = kernels.SIGNATURES[name]
        fn = getattr(ctypes.CDLL(out), entry)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        if tag in DIAGNOSE:
            built[tag] = (name, fn)
    return built


def variant_call(torch, name, fn, launches, count, count_out):
    """A built variant's entry point over a ``LeafSet``'s tables, with the
    arguments the current wrapper gives its kernel at a constant rate."""
    stream = torch.cuda.current_stream().cuda_stream

    def call():
        for address, rows in launches:
            if name == "fused_adam":
                err = fn(address, rows, None, count.data_ptr(),
                         count_out.data_ptr(), None, None, None, -1e-3, 1.0,
                         0.9, 1.0 - 0.9, 0.999, 1.0 - 0.999, 1e-8, 0.0,
                         0.0, 0.0, 0, stream)
            else:
                err = fn(address, rows, None, None, None, -1e-3, 1.0, 0.9,
                         0.0, 0.0, 0.0, 16, stream)
            if err:
                raise RuntimeError(f"variant of {name}: cudaError {err}")
    return call


def per_leaf_sweep(torch, entry, name, cols, scal):
    """The compared design: one launch a leaf, the scalars in ``scal``."""
    stream = torch.cuda.current_stream().cuda_stream
    ptrs = [[t.data_ptr() for t in leaf] for leaf in zip(*cols)]
    numels = [t.numel() for t in cols[0]]

    def sweep():
        for leaf, n in zip(ptrs, numels):
            if name == "fused_adam":
                err = entry(*leaf, scal.data_ptr(), n, 0.9, 1.0 - 0.9, 0.999,
                            1.0 - 0.999, 1e-8, 0.0, 0.0, 0.0, 0, stream)
            else:
                err = entry(*leaf, scal.data_ptr(), n, 0.9, 0.0, 0.0, 0.0,
                            16, stream)
            if err:
                raise RuntimeError(f"compared {name}: cudaError {err}")
    return sweep


def kernels_alone(torch, entries, shapes, variants):
    """Part 1 (and 3) for one leaf set: {kernel: numbers}."""
    import chip_smoke as cs
    from analytics_zoo_torch.ops import fused
    from analytics_zoo_torch.ops import multi_tensor as mt
    dev = torch.device("cuda", 0)
    n_el = sum(int(torch.Size(s).numel()) for s in shapes)
    # count 2 before the step: the current kernel computes bc from it, the
    # compared one reads the same values from the buffer
    count = torch.tensor(2, dtype=torch.int32, device=dev)
    _, scal = fused.adam_scalars(count, -1e-3, 0.9, 0.999)
    sgd_scal = fused.step_scalars(None, -1e-3, device=dev)
    out = {}
    for name, width, lib_cls, lib_kw in (
            ("fused_adam", 4, torch.optim.Adam, {}),
            ("fused_sgd", 3, torch.optim.SGD, dict(momentum=0.9))):
        cols = leaf_columns(torch, shapes, dev, width)
        cache = mt.TableCache()
        if name == "fused_adam":
            def current(c=cols):
                fused.adam_multi_update(*c, count, -1e-3, b1=0.9, b2=0.999,
                                        eps=1e-8, cache=cache)
        else:
            def current(c=cols):
                fused.sgd_multi_update(*c, -1e-3, momentum=0.9,
                                       nesterov=False, cache=cache)
        # bit-identity to the compared kernels on copies, leaf by leaf
        a = [[t.clone() for t in col] for col in cols]
        b = [[t.clone() for t in col] for col in cols]
        current(a)
        per_leaf_sweep(torch, entries[name], name, b,
                       scal if name == "fused_adam" else sgd_scal)()
        torch.cuda.synchronize()
        same = all(torch.equal(x, y) for j in range(width) if j != 1
                   for x, y in zip(a[j], b[j]))
        if not same:
            sys.exit(f"bench_optim: current {name} differs from the compared "
                     "per-leaf kernel")
        # each variant bit-identical to the current kernel, on copies
        count_out = torch.empty((), dtype=torch.int32, device=dev)
        mine = {tag: fn for tag, (k, fn) in variants.items() if k == name}
        for tag, fn in mine.items():
            b = [[t.clone() for t in col] for col in cols]
            leaf_set = mt.LeafSet([b[0], None, *b[2:]])
            variant_call(torch, name, fn, leaf_set.fill(b[1]), count,
                         count_out)()
            torch.cuda.synchronize()
            if not all(torch.equal(x, y) for j in range(width) if j != 1
                       for x, y in zip(a[j], b[j])):
                sys.exit(f"bench_optim: variant {tag} differs from the "
                         "current kernel")
        del a, b
        compared = per_leaf_sweep(torch, entries[name], name, cols,
                                  scal if name == "fused_adam" else sgd_scal)
        leaf_set = mt.LeafSet([cols[0], None, *cols[2:]])
        launches = leaf_set.fill(cols[1])
        lib_params = [p.clone().requires_grad_() for p in cols[0]]
        for p, g in zip(lib_params, cols[1]):
            p.grad = g.clone()
        lib = lib_cls(lib_params, lr=1e-3, fused=True, **lib_kw)
        fns = {"compared": compared, "current": current}
        fns.update({tag: variant_call(torch, name, fn, launches, count,
                                      count_out)
                    for tag, fn in mine.items()})
        fns["library"] = lib.step
        runs = {tag: [] for tag in fns}
        for tag in list(fns) + list(fns)[::-1]:
            runs[tag].append(cs.time_ms(torch, fns[tag]))
        plain = cs.time_ms(torch, lambda: cs.plain_route(current))
        bnd, by = cs.bound_ms(BYTES_PER_ELEMENT[name] * n_el, 0)
        out[name] = dict(runs, plain=plain, bound_ms=bnd, bound_by=by,
                         leaves=len(shapes), elements=n_el,
                         bit_identical_to_compared=same)
        del cols, lib_params, lib, fns, leaf_set
        torch.cuda.empty_cache()
    return out


def update_only(args):
    """Part 2 in this process: the whole update of the package this
    process imports, for every leaf set of ``--shapes``; prints one JSON
    line."""
    import torch
    sys.path.append(ROOT)          # chip_smoke's timers; the package comes
    import chip_smoke as cs        # from PYTHONPATH, the root under test
    from analytics_zoo_torch.ops import fused, kernels
    from analytics_zoo_torch.pipeline.api.keras.optimizers import Adam, SGD
    kernels.build_all(["fused_adam", "fused_sgd"])
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    with open(args.shapes) as f:
        sets = json.load(f)
    out = {}
    for model, shapes in sets.items():
        for name, optim, width in (("fused_adam", Adam(lr=1e-3), 2),
                                   ("fused_sgd", SGD(1e-3, momentum=0.9),
                                    1)):
            ps, gs = leaf_columns(torch, shapes, dev, 2)
            tree = {f"l{i:03d}": p for i, p in enumerate(ps)}
            gtree = {f"l{i:03d}": g for i, g in enumerate(gs)}
            state = [optim.init(tree)]
            update = fused.build_fused_update(optim)

            def whole():
                _, state[0] = update(gtree, state[0], tree)
            kernels.reset_launch_counts()
            device_ms = cs.time_ms(torch, whole)
            launches = kernels.launch_counts()[name] / (cs.WARMUP + cs.TIMED)
            host = [cs.host_ms(torch, whole) for _ in range(5)]
            out[f"{model} {name}"] = dict(
                device_ms=device_ms, host_ms=host,
                host_ms_median=statistics.median(host),
                launches_per_update=launches)
            del ps, gs, tree, gtree, state, update
            torch.cuda.empty_cache()
    print(json.dumps(out))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--compare-adam",
                    default=os.path.join(ARCHIVE, "fused_adam_988dcd4.cu"))
    ap.add_argument("--compare-sgd",
                    default=os.path.join(ARCHIVE, "fused_sgd_988dcd4.cu"))
    ap.add_argument("--baseline-root", default=os.path.join(ARCHIVE, BASELINE_COMMIT))
    ap.add_argument("--out", default=None)
    ap.add_argument("--diagnose", action="store_true")
    ap.add_argument("--update-only", action="store_true",
                    help=argparse.SUPPRESS)
    ap.add_argument("--shapes", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.update_only:
        return update_only(args)

    prepare_sources(args)
    sys.path.insert(0, ROOT)
    import torch
    if not torch.cuda.is_available():
        sys.exit("bench_optim: needs a CUDA device")
    import chip_smoke as cs
    from analytics_zoo_torch import init_zoo_context
    from analytics_zoo_torch.ops import kernels
    card = cs.gpu_line()
    print(f"gpu: {card}")
    kernels.build_all(["fused_adam", "fused_sgd"])
    entries = build_compared(kernels, {"fused_adam": args.compare_adam,
                                       "fused_sgd": args.compare_sgd})
    variants = build_variants(kernels, args.diagnose)
    init_zoo_context(device="cuda:0")
    sets = leaf_shapes()
    result = {"card": card, "kernels": {}, "updates": {}}
    for model, shapes in sets.items():
        res = kernels_alone(torch, entries, shapes, variants)
        result["kernels"][model] = res
        for name, r in res.items():
            med = {tag: statistics.median(r[tag])
                   for tag in ("compared", "current", "library")}
            for tag in variants:
                if tag in r:
                    print(f"{model} {name} variant {tag} in turns: "
                          f"{r[tag]} ms, bit-identical to current ({card})")
            print(f"{model} {name}, {r['leaves']} leaves ({r['elements']} "
                  f"elements), kernels alone in turns: per-leaf compared "
                  f"({r['leaves']} launches) {r['compared']} ms, current "
                  f"(1 launch) {r['current']} ms, library {r['library']} ms; "
                  f"medians {med}; plain {r['plain']:.5f} ms; bound "
                  f"{r['bound_ms']:.6f} ms ({r['bound_by']}); bit-identical "
                  f"to compared: {r['bit_identical_to_compared']} ({card})")

    # part 2: whole updates, each package in a process of its own
    with tempfile.NamedTemporaryFile("w", suffix=".json",
                                     delete=False) as f:
        json.dump(sets, f)
    roots = {"baseline": os.path.abspath(args.baseline_root), "current": ROOT}
    runs = {"baseline": [], "current": []}
    for tag in ("baseline", "current", "current", "baseline"):
        env = dict(os.environ, PYTHONPATH=roots[tag])
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--update-only",
             "--shapes", f.name], env=env, cwd=roots[tag],
            capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            sys.exit(f"bench_optim: {tag} update run failed:\n"
                     f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
        runs[tag].append(json.loads(proc.stdout.strip().splitlines()[-1]))
    os.unlink(f.name)
    for key in runs["current"][0]:
        line = {tag: [(round(r[key]["device_ms"], 5),
                       round(r[key]["host_ms_median"], 5),
                       r[key]["launches_per_update"]) for r in rs]
                for tag, rs in runs.items()}
        print(f"whole update {key}, in turns (device ms, host ms a call, "
              f"launches a call): {line} ({card})")
    result["updates"] = runs
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as fo:
            json.dump(result, fo, indent=1)


if __name__ == "__main__":
    main()
