"""Loader for the hand-written CUDA kernels in ``csrc/``.

Each source ``csrc/<source>.cu`` is compiled at first use by its own
``nvcc`` call into a shared library with a plain C interface (no PyTorch
headers, so a build takes seconds), under ``analytics_zoo_torch/_build/``,
and loaded with ``ctypes``.  A source may hold more than one kernel (the
flash backward's dQ and dK/dV share ``flash_attention_bwd.cu``).  The
library's file name carries a hash of its source, the shared headers
(``csrc/*.cuh``) and the flags, so an edited source or header is
rebuilt.  ``build_all`` starts every build at once.  A missing
``nvcc`` or a failed build raises: there is no fallback to the plain
versions for CUDA tensors.

Every C entry point launches on the stream it is given, allocates
nothing, and returns ``cudaGetLastError()``; ``launch`` turns a non-zero
return into an exception.  ``LAUNCHES`` counts, per kernel, the launches
the wrappers made through ``launch``, and nothing else: a launch on the
stream of an open ``record_launches`` block (a graph's warm-up and
capture on the engine's side stream, ``compile/engine.py``) goes to that
block's own counts instead, and ``add_launches`` adds a captured graph's
counts on each replay, so the counts mean launches that ran.  Launches
on any other stream (another thread's) count as usual.

With a persistent cache directory (``compile.cache_dir`` or
``ZOO_TPU_COMPILE_CACHE``, ``compile/cache.py``) a library not yet in
``_build/`` is looked up there first: a hit writes it into ``_build/``
without running ``nvcc``; a miss builds it and stores it.  The entry's
key is the library's hash, the toolkit's version (``nvcc_version``) and
the backend signature.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time
from contextlib import contextmanager
from typing import Dict, List, Optional

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(os.path.dirname(_HERE), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")

# no --use_fast_math: the tolerances assume IEEE expf/tanhf/sqrtf
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

# kernel name -> (source in csrc/, C entry point, argtypes)
SIGNATURES = {
    # q, k, v, o, lse, bh, t, d, scale, causal, stream
    "flash_attention_fwd": ("flash_attention_fwd", "zoo_flash_attention_fwd",
                            [_P, _P, _P, _P, _P, _I, _I, _I, _F, _I, _P]),
    # q, k, v, do, lse, delta, dq, bh, t, d, scale, causal, stream
    "flash_attention_dq": ("flash_attention_bwd", "zoo_flash_attention_dq",
                           [_P] * 7 + [_I, _I, _I, _F, _I, _P]),
    # q, k, v, do, lse, delta, dk, dv, bh, t, d, scale, causal, stream
    "flash_attention_dkv": ("flash_attention_bwd", "zoo_flash_attention_dkv",
                            [_P] * 8 + [_I, _I, _I, _F, _I, _P]),
    # the same three on bfloat16 q, k, v, dO and outputs (lse, delta float32;
    # forward and backward on wgmma, each in a source of its own); qscale
    # is the scale rounded to bf16, as the reference's q * scale takes it.
    # q, k, v, o, lse, bh, t, d, qscale, causal, stream
    "flash_attention_fwd_bf16": ("flash_attention_fwd_bf16",
                                 "zoo_flash_attention_fwd_bf16",
                                 [_P] * 5 + [_I, _I, _I, _F, _I, _P]),
    # q, k, v, do, lse, delta, dq, bh, t, d, scale, qscale, causal, stream
    "flash_attention_dq_bf16": ("flash_attention_bwd_bf16",
                                "zoo_flash_attention_dq_bf16",
                                [_P] * 7 + [_I, _I, _I, _F, _F, _I, _P]),
    # q, k, v, do, lse, delta, dk, dv, bh, t, d, qscale, causal, stream
    "flash_attention_dkv_bf16": ("flash_attention_bwd_bf16",
                                 "zoo_flash_attention_dkv_bf16",
                                 [_P] * 8 + [_I, _I, _I, _F, _I, _P]),
    # the same three on float32 at head_dim 320 to 2048 (multiples of 64),
    # with the arguments of the float32 ones above, head_dim taken at run
    # time; the forward in one source, the backward (clusters of column
    # blocks) in another
    "flash_attention_fwd_wide": ("flash_attention_wide",
                                 "zoo_flash_attention_fwd_wide",
                                 [_P] * 5 + [_I, _I, _I, _F, _I, _P]),
    "flash_attention_dq_wide": ("flash_attention_wide_bwd",
                                "zoo_flash_attention_dq_wide",
                                [_P] * 7 + [_I, _I, _I, _F, _I, _P]),
    "flash_attention_dkv_wide": ("flash_attention_wide_bwd",
                                 "zoo_flash_attention_dkv_wide",
                                 [_P] * 8 + [_I, _I, _I, _F, _I, _P]),
    # x, bias, out, rows, d, stream
    "bias_gelu": ("bias_gelu", "zoo_bias_gelu", [_P, _P, _P, _I, _I, _P]),
    # x, gamma, beta, out, rows, d, eps, act (0 none, 1 gelu), stream
    "layernorm_act": ("layernorm_act", "zoo_layernorm_act",
                      [_P, _P, _P, _P, _I, _I, _F, _I, _P]),
    # rows, leaves, scal, count, count_out, gnorm, step_ptr, scal_out,
    # step_value, clip_norm, b1, 1-b1, b2, 1-b2, eps, wd, lo, hi, flags,
    # stream (rows: ops/multi_tensor.py's table)
    "fused_adam": ("fused_adam", "zoo_multi_adam",
                   [_P, _I] + [_P] * 6 + [_F] * 10 + [_I, _P]),
    # rows, leaves, scal, gnorm, step_ptr, step_value, clip_norm, momentum,
    # wd, lo, hi, flags, stream
    "fused_sgd": ("fused_sgd", "zoo_multi_sgd",
                  [_P, _I] + [_P] * 3 + [_F] * 6 + [_I, _P]),
}

# the wide kernels' occupancy queries, which launch nothing and count
# nothing: kernel -> (C entry point, its leading int arguments); each
# entry point then takes head_dim and an int pointer, and writes how many
# clusters of that kernel's blocks at that head_dim (ceil(head_dim / 256)
# blocks a cluster, the instance a launch at head_dim takes) the card
# holds at once (cudaOccupancyMaxActiveClusters)
CLUSTER_QUERIES = {
    "flash_attention_fwd_wide": ("zoo_flash_wide_fwd_max_clusters", ()),
    # dkv = 0: dQ, 1: dK/dV
    "flash_attention_dq_wide": ("zoo_flash_wide_bwd_max_clusters", (0,)),
    "flash_attention_dkv_wide": ("zoo_flash_wide_bwd_max_clusters", (1,)),
}

# what the compiler gave the bf16 backward kernels, queries that launch
# nothing and count nothing: kernel -> (C entry point, its leading int
# arguments); the entry point then takes head_dim and an int[4] it fills
# with the registers a thread, the local (spilled) bytes a thread, the
# dynamic shared bytes and the threads a block of the instance a launch at
# that head_dim takes (cudaFuncGetAttributes)
ATTRIBUTE_QUERIES = {
    "flash_attention_dq_bf16": ("zoo_flash_bwd_bf16_attributes", (0,)),
    "flash_attention_dkv_bf16": ("zoo_flash_bwd_bf16_attributes", (1,)),
}

# every source, each built by one nvcc call
SOURCES = sorted({src for src, _, _ in SIGNATURES.values()})

# the kernels a forward pass can launch (what InferenceModel.warm builds;
# a model's attention is float32 at any head_dim, so both float32
# forwards; no model hands the flash op bf16 q/k/v, so not its bf16 forward)
FORWARD_KERNELS = ("flash_attention_fwd", "flash_attention_fwd_wide",
                   "bias_gelu", "layernorm_act")

LAUNCHES: Dict[str, int] = {name: 0 for name in SIGNATURES}

_libs: Dict[str, ctypes.CDLL] = {}
# guards the builds and LAUNCHES: the serving batcher and several
# predict threads launch at once, and ``+= 1`` is a read-modify-write
_lock = threading.Lock()
# stream handle -> the counts of the open ``record_launches`` blocks on
# it, innermost last (keyed by stream, not thread: a captured backward
# launches from autograd's worker thread, on its forward's stream)
_recording: Dict[int, List[Dict[str, int]]] = {}


def reset_launch_counts() -> None:
    with _lock:
        for name in LAUNCHES:
            LAUNCHES[name] = 0


def launch_counts() -> Dict[str, int]:
    with _lock:
        return dict(LAUNCHES)


@contextmanager
def record_launches(stream: int):
    """Count the launches made on ``stream`` (a ``cuda_stream`` handle)
    while the block is open into a dict of their own (yielded) instead
    of ``LAUNCHES``."""
    counts: Dict[str, int] = {name: 0 for name in SIGNATURES}
    with _lock:
        _recording.setdefault(stream, []).append(counts)
    try:
        yield counts
    finally:
        with _lock:
            open_ = _recording[stream]
            open_.remove(counts)
            if not open_:
                del _recording[stream]


def _target(stream: int) -> Dict[str, int]:
    open_ = _recording.get(stream)
    return open_[-1] if open_ else LAUNCHES


def add_launches(counts: Dict[str, int], stream: int) -> None:
    """Add ``counts`` to ``LAUNCHES`` (a captured graph's replay on
    ``stream``; inside an open record of that stream, to the record)."""
    with _lock:
        target = _target(stream)
        for name, n in counts.items():
            target[name] += n


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    if os.path.isfile(cand):
        return cand
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin): the CUDA kernels in "
        f"{CSRC_DIR} are built at first use and need the CUDA toolkit")


def source_path(source: str) -> str:
    return os.path.join(CSRC_DIR, f"{source}.cu")


def library_path(source: str) -> str:
    """The library built from ``source``: its name carries a hash of the
    source, every header in ``csrc/`` (in sorted order: a source may
    include any of them) and the flags."""
    h = hashlib.sha256()
    headers = sorted(glob.glob(os.path.join(CSRC_DIR, "*.cuh")))
    for path in [source_path(source), *headers]:
        with open(path, "rb") as f:
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"lib{source}_{h.hexdigest()[:16]}.so")


_nvcc_version: Optional[str] = None


def nvcc_version() -> str:
    """The CUDA toolkit's identity, for the persistent cache's key, read
    without starting nvcc (so a cache hit runs no nvcc process at all):
    the ``version.json`` manifest beside ``bin/nvcc`` (a CUDA 11.1 or
    later installer's), else a digest of the nvcc binary itself."""
    global _nvcc_version
    if _nvcc_version is None:
        nvcc = os.path.realpath(nvcc_path())
        manifest = os.path.join(os.path.dirname(os.path.dirname(nvcc)),
                                "version.json")
        if os.path.isfile(manifest):
            with open(manifest) as f:
                _nvcc_version = f.read().strip()
        else:
            h = hashlib.sha256()
            with open(nvcc, "rb") as f:
                for block in iter(lambda: f.read(1 << 20), b""):
                    h.update(block)
            _nvcc_version = f"nvcc sha256 {h.hexdigest()}"
    return _nvcc_version


def library_cache_key(source: str) -> str:
    """The persistent cache's key for ``source``'s library."""
    from analytics_zoo_torch.compile.cache import cache_key
    digest = os.path.basename(library_path(source))
    return cache_key(digest, nvcc_version())


def _write_atomic(path: str, payload: bytes) -> None:
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "wb") as f:
        f.write(payload)
    os.replace(tmp, path)


def _from_cache(source: str, out: str) -> bool:
    """Write ``source``'s library from the persistent cache; whether it
    was there."""
    from analytics_zoo_torch.compile.cache import get_cache
    cache = get_cache()
    if cache is None:
        return False
    from analytics_zoo_torch.observability.diagnostics import (
        get_compile_monitor)
    t0 = time.perf_counter()
    payload = cache.load(library_cache_key(source))
    if payload is not None:
        _write_atomic(out, payload)
    get_compile_monitor().record_cache_event(
        source, hit=payload is not None,
        seconds=time.perf_counter() - t0 if payload is not None else None)
    return payload is not None


def _to_cache(source: str, out: str) -> None:
    from analytics_zoo_torch.compile.cache import get_cache
    cache = get_cache()
    if cache is not None:
        with open(out, "rb") as f:
            cache.store(library_cache_key(source), f.read(),
                        key_hint=source)


def _start_build(source: str):
    """Start one nvcc; returns (Popen, tmp path, final path) or None when
    the library for this source is already built or came from the
    persistent cache."""
    out = library_path(source)
    if os.path.isfile(out):
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    if _from_cache(source, out):
        return None
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, source_path(source)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish_build(source: str, started) -> None:
    if started is None:
        return
    proc, tmp, out = started
    log, _ = proc.communicate()
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(f"nvcc failed for {source}.cu "
                           f"(exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)      # atomic: a concurrent builder sees all or nothing
    _to_cache(source, out)


def _load(source: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(library_path(source))
    for src, entry_point, argtypes in SIGNATURES.values():
        if src == source:
            fn = getattr(lib, entry_point)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    return lib


def build_all(names: List[str] = None) -> None:
    """Build (one nvcc per source, all started together) and load the
    libraries of the named kernels (default: all) not yet loaded in this
    process."""
    sources = sorted({SIGNATURES[n][0] for n in (names or SIGNATURES)})
    with _lock:
        todo = [src for src in sources if src not in _libs]
        build_libraries(todo)
        for src in todo:
            _libs[src] = _load(src)


def build_libraries(sources: List[str]) -> None:
    """Put the libraries of ``sources`` into ``_build/``: each one already
    there is kept, each in the persistent cache is copied from it, and
    the rest are built by one nvcc each, all started together."""
    started = {}
    try:
        for src in sources:
            started[src] = _start_build(src)
    finally:
        # reap whatever was started, even if a later start raised
        errors = []
        for src, proc in started.items():
            try:
                _finish_build(src, proc)
            except RuntimeError as e:
                errors.append(str(e))
        if errors:
            raise RuntimeError("\n".join(errors))


def entry(name: str):
    """The C entry point of kernel ``name``, building it at first use."""
    source, entry_point, _ = SIGNATURES[name]
    if source not in _libs:
        build_all([name])
    return getattr(_libs[source], entry_point)


def max_active_clusters(name: str, head_dim: int) -> int:
    """How many clusters of kernel ``name``'s blocks (a key of
    ``CLUSTER_QUERIES``) at ``head_dim`` the current CUDA device holds at
    once; raises if the query fails."""
    entry_point, lead = CLUSTER_QUERIES[name]
    entry(name)                         # builds and loads the source
    fn = getattr(_libs[SIGNATURES[name][0]], entry_point)
    fn.argtypes = [_I] * (len(lead) + 1) + [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    n = ctypes.c_int(0)
    err = fn(*lead, head_dim, ctypes.byref(n))
    if err != 0 or n.value < 1:
        raise RuntimeError(
            f"{entry_point}: cudaOccupancyMaxActiveClusters for {name} at "
            f"head_dim {head_dim} gave {n.value} (cudaError {err})")
    return n.value


def kernel_attributes(name: str, head_dim: int) -> Dict[str, int]:
    """Registers a thread, local bytes a thread, dynamic shared bytes and
    threads a block of kernel ``name`` (a key of ``ATTRIBUTE_QUERIES``) at
    ``head_dim``; raises if the query fails."""
    entry_point, lead = ATTRIBUTE_QUERIES[name]
    entry(name)                         # builds and loads the source
    fn = getattr(_libs[SIGNATURES[name][0]], entry_point)
    fn.argtypes = [_I] * (len(lead) + 1) + [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * 4)()
    err = fn(*lead, head_dim, out)
    if err != 0:
        raise RuntimeError(f"{entry_point}: cudaFuncGetAttributes for {name} "
                           f"at head_dim {head_dim} failed: cudaError {err}")
    return dict(zip(("registers", "local_bytes", "shared_bytes", "threads"),
                    out))


def launch(name: str, device, *args) -> None:
    """Launch kernel ``name`` on the current stream of ``device`` (which
    must be the current CUDA device), raise if the launch was refused,
    and count it."""
    import torch
    if device.index != torch.cuda.current_device():
        raise ValueError(
            f"{name}: tensors on {device} but the current CUDA device is "
            f"cuda:{torch.cuda.current_device()}")
    stream = torch.cuda.current_stream().cuda_stream
    err = entry(name)(*args, stream)
    if err != 0:
        raise RuntimeError(
            f"CUDA kernel {name} failed to launch: cudaError {err}")
    _count(name, stream)


def _count(name: str, stream: int) -> None:
    with _lock:
        _target(stream)[name] += 1
