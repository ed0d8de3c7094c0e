"""Content-addressed persistent artifact cache (port of
``compile/cache.py``).

The reference persists serialized XLA executables.  A CUDA graph cannot
be serialized, so what the port persists is its own cold-start compile:
the shared libraries that ``nvcc`` builds from ``csrc/*.cu`` at first use
(``ops/kernels.py``).  A warm directory turns that build (seconds a
source, all sources started together) into a file copy.

Layout: one file per entry, ``<cache_dir>/<key>.zooexec``, where ``key``
is a content digest over

* the artifact's own digest (for a kernel library: the hash of its
  source, every ``csrc/*.cuh`` header and the nvcc flags, the hash
  ``ops/kernels.library_path`` names the library by),
* a signature string (for a kernel library: the toolkit's version,
  ``ops/kernels.nvcc_version``),
* the donation/static-argnum spec (unused by the libraries, kept for the
  reference's key layout),
* ``backend_signature()``: platform, device kind, device and process
  counts,
* extra compiler flags (the reference's ``XLA_FLAGS``; the kernel
  libraries' flags are already in their hash).

torch, CUDA runtime and driver *versions* live in the entry's META, not
the key: a version bump finds the old entry, evicts it LOUDLY
(``compile_cache_errors_total{kind="stale"}``) and rebuilds, rather than
stranding unreachable files until the LRU sweep.

Durability contract, the reference's:

* writes are atomic (same-directory temp file + ``os.replace``), so two
  processes racing on one key can never tear an entry;
* loads are corruption-safe: an unreadable, truncated, hand-edited
  (payload digest mismatch) or stale entry is a MISS plus a loud counter
  and eviction, never a crash and never a library loaded from bad bytes;
* a read-only process (``compile.cache_write=false``, a farm worker)
  never mutates entries;
* the directory honors a size cap with LRU eviction
  (``compile.cache_max_mb``, ``compile_cache_evictions_total``).

Compile-farm mode: with no explicit directory but inside a launcher
``run_dir`` (``ZOO_TPU_RUN_DIR``), the cache lands in
``<run_dir>/compile-cache`` and only host 0 (``ZOO_TPU_PROCESS_ID``, else
the ``torch.distributed`` rank) persists entries.
"""

from __future__ import annotations

import hashlib
import logging
import os
import pickle
import tempfile
import threading
import time
from typing import Dict, List, Optional, Tuple

log = logging.getLogger("analytics_zoo_torch.compile")

#: explicit cache-dir override (takes precedence over config)
ENV_CACHE_DIR = "ZOO_TPU_COMPILE_CACHE"

ENTRY_SUFFIX = ".zooexec"


def _counter(name: str, doc: str, labels=()):
    from analytics_zoo_torch.observability import get_registry
    return get_registry().counter(name, doc, labels=labels)


def _count_error(kind: str) -> None:
    """Loud-counter contract: every bad, stale or unwritable entry, and
    every failed capture, is visible on /metrics."""
    try:
        _counter(
            "compile_cache_errors_total",
            "artifact-cache entries rejected or failed, and programs "
            "that fell back to eager dispatch, by kind "
            "(corrupt/stale/io/serialize/capture)",
            labels=("kind",)).labels(kind).inc()
    except Exception:   # noqa: BLE001 — metrics never block the cache
        pass


def backend_signature() -> str:
    """Platform, device kind, device count and process count."""
    import torch
    if torch.cuda.is_available():
        platform, kind = "cuda", torch.cuda.get_device_name(0)
        count = torch.cuda.device_count()
    else:
        platform, kind, count = "cpu", "cpu", 1
    procs = 1
    try:
        import torch.distributed as dist
        if dist.is_available() and dist.is_initialized():
            procs = dist.get_world_size()
    except Exception:   # noqa: BLE001
        pass
    return "|".join((platform, str(kind), str(count), str(procs)))


def _driver_version() -> str:
    try:
        import ctypes
        lib = ctypes.CDLL("libcuda.so.1")
        v = ctypes.c_int()
        if lib.cuDriverGetVersion(ctypes.byref(v)) == 0:
            return str(v.value)
    except Exception:   # noqa: BLE001 — version probe must not raise
        pass
    return "?"


def runtime_versions() -> Dict[str, str]:
    """The versions checked (loudly) at LOAD time: an entry built under
    another torch, CUDA runtime or driver is evicted, not trusted."""
    import torch
    return {"torch": torch.__version__, "cuda": str(torch.version.cuda),
            "driver": _driver_version()}


def cache_key(digest: str, signature_repr: str,
              donate_repr: str = "()", static_repr: str = "()",
              backend_sig: Optional[str] = None, flags: str = "") -> str:
    """Content digest of everything that determines the artifact."""
    if backend_sig is None:
        backend_sig = backend_signature()
    material = "\x1f".join((digest, signature_repr, donate_repr,
                            static_repr, backend_sig, flags))
    return hashlib.sha256(material.encode()).hexdigest()


def _process_id() -> int:
    """Worker index for the farm write policy: the launcher env contract
    first, the live ``torch.distributed`` rank second."""
    raw = os.environ.get("ZOO_TPU_PROCESS_ID")
    if raw is not None:
        try:
            return int(raw)
        except ValueError:
            pass
    try:
        import torch.distributed as dist
        if dist.is_available() and dist.is_initialized():
            return dist.get_rank()
    except Exception:   # noqa: BLE001
        pass
    return 0


def resolve_cache_dir() -> Optional[Tuple[str, bool]]:
    """``(cache_dir, farm_mode)`` or None when caching is off.

    Precedence: ``ZOO_TPU_COMPILE_CACHE`` env > ``compile.cache_dir``
    config > (``compile.farm``) ``<ZOO_TPU_RUN_DIR>/compile-cache``."""
    env = os.environ.get(ENV_CACHE_DIR, "").strip()
    if env:
        return env, False
    from analytics_zoo_torch.common.config import get_config
    cfg = get_config()
    explicit = str(cfg.get("compile.cache_dir") or "").strip()
    if explicit:
        return explicit, False
    if bool(cfg.get("compile.farm", True)):
        run_dir = os.environ.get("ZOO_TPU_RUN_DIR", "").strip()
        if run_dir:
            return os.path.join(run_dir, "compile-cache"), True
    return None


class _StaleEntry(RuntimeError):
    pass


class ExecutableCache:
    """On-disk artifact store with atomic writes, corruption-safe loads
    and an LRU size cap.  One instance per directory per process
    (``get_cache``); safe under concurrent processes because every
    mutation is a whole-file rename or unlink.  Payloads are bytes."""

    def __init__(self, cache_dir: str, max_mb: Optional[float] = None,
                 write_enabled: bool = True):
        self.dir = os.path.abspath(cache_dir)
        os.makedirs(self.dir, exist_ok=True)
        if max_mb is None:
            try:
                from analytics_zoo_torch.common.config import get_config
                max_mb = float(get_config().get(
                    "compile.cache_max_mb", 2048))
            except Exception:   # noqa: BLE001
                max_mb = 2048.0
        self.max_bytes = int(max_mb * (1 << 20)) if max_mb > 0 else 0
        self.write_enabled = bool(write_enabled)
        self._lock = threading.Lock()

    # --------------------------------------------------------------- paths
    def path_for(self, key: str) -> str:
        return os.path.join(self.dir, key + ENTRY_SUFFIX)

    def entries(self) -> List[str]:
        try:
            return sorted(f for f in os.listdir(self.dir)
                          if f.endswith(ENTRY_SUFFIX))
        except OSError:
            return []

    # ---------------------------------------------------------------- load
    def load(self, key: str) -> Optional[bytes]:
        """The payload stored under ``key``, or None (miss).  A present
        but bad entry (torn write, hand edit, version skew) is EVICTED
        with a loud counter and becomes a miss."""
        path = self.path_for(key)
        if not os.path.exists(path):
            return None
        try:
            with open(path, "rb") as f:
                doc = pickle.load(f)
            meta, payload = doc["meta"], doc["payload"]
            if not isinstance(payload, bytes) or \
                    hashlib.sha256(payload).hexdigest() != meta["sha256"]:
                raise ValueError("payload does not match its digest")
            current = runtime_versions()
            if meta.get("versions") != current:
                raise _StaleEntry(
                    f"entry built under {meta.get('versions')}, running "
                    f"{current}")
        except _StaleEntry as e:
            # a read-only process on a skewed build must not unlink the
            # writer's valid entry; for it a stale entry is just a miss
            log.warning(
                "compile cache: %s VERSION-STALE entry %s (%s); treating "
                "as a miss", "evicting" if self.write_enabled else
                "ignoring", os.path.basename(path), e)
            _count_error("stale")
            if self.write_enabled:
                self._evict_file(path)
            return None
        except Exception:   # noqa: BLE001 — corrupt-entry contract
            log.warning(
                "compile cache: %s unreadable/corrupt entry %s; treating "
                "as a miss", "evicting" if self.write_enabled else
                "ignoring", os.path.basename(path), exc_info=True)
            _count_error("corrupt")
            if self.write_enabled:
                self._evict_file(path)
            return None
        if self.write_enabled:
            try:
                os.utime(path, None)   # LRU recency on hit
            except OSError:
                pass
        return payload

    # --------------------------------------------------------------- store
    def store(self, key: str, payload: bytes, key_hint: str = "") -> bool:
        """Persist ``payload`` atomically (write, then rename): two writers
        on one key cannot tear the entry.  Returns whether it landed."""
        if not self.write_enabled:
            return False
        try:
            payload = bytes(payload)
            blob = pickle.dumps({
                "meta": {"versions": runtime_versions(),
                         "key_hint": key_hint,
                         "created_unix": round(time.time(), 1),
                         "sha256": hashlib.sha256(payload).hexdigest()},
                "payload": payload})
        except Exception:   # noqa: BLE001
            log.warning("compile cache: cannot serialize %r; entry not "
                        "persisted", key_hint or key, exc_info=True)
            _count_error("serialize")
            return False
        path = self.path_for(key)
        try:
            fd, tmp = tempfile.mkstemp(dir=self.dir,
                                       prefix=".tmp-" + key[:16] + "-")
            try:
                with os.fdopen(fd, "wb") as f:
                    f.write(blob)
                os.replace(tmp, path)   # atomic on one filesystem
            except BaseException:
                try:
                    os.remove(tmp)
                except OSError:
                    pass
                raise
        except Exception:   # noqa: BLE001 — full disk, permissions...
            log.warning("compile cache: could not persist entry %s",
                        os.path.basename(path), exc_info=True)
            _count_error("io")
            return False
        try:
            _counter("compile_cache_writes_total",
                     "artifact-cache entries persisted").inc()
        except Exception:   # noqa: BLE001
            pass
        self._enforce_cap()
        return True

    # ------------------------------------------------------------ eviction
    def _evict_file(self, path: str) -> None:
        try:
            os.remove(path)
        except OSError:
            pass

    def _enforce_cap(self) -> None:
        """LRU sweep: drop oldest-by-mtime entries until the directory
        fits ``compile.cache_max_mb`` (mtime is bumped on every hit)."""
        if self.max_bytes <= 0:
            return
        with self._lock:
            try:
                stats = []
                for name in self.entries():
                    p = os.path.join(self.dir, name)
                    try:
                        st = os.stat(p)
                    except OSError:
                        continue
                    stats.append((st.st_mtime, st.st_size, p))
                total = sum(s[1] for s in stats)
                if total <= self.max_bytes:
                    return
                stats.sort()   # oldest first
                evicted = 0
                for _, size, p in stats:
                    if total <= self.max_bytes:
                        break
                    self._evict_file(p)
                    total -= size
                    evicted += 1
                if evicted:
                    log.info("compile cache: LRU-evicted %d entr%s to fit "
                             "the %.0f MB cap (%s)", evicted,
                             "y" if evicted == 1 else "ies",
                             self.max_bytes / (1 << 20), self.dir)
                    try:
                        _counter(
                            "compile_cache_evictions_total",
                            "artifact-cache entries LRU-evicted to honor "
                            "compile.cache_max_mb").inc(evicted)
                    except Exception:   # noqa: BLE001
                        pass
            except Exception:   # noqa: BLE001 — the sweep is advisory
                log.debug("compile cache: LRU sweep failed", exc_info=True)


# ------------------------------------------------------------- singleton
_caches: Dict[str, ExecutableCache] = {}
_caches_lock = threading.Lock()


def get_cache() -> Optional[ExecutableCache]:
    """The process cache for the resolved directory, or None when caching
    is off (no directory, or ``compile.aot`` false).  Farm mode enables
    writes on host 0 only; everyone reads."""
    try:
        from analytics_zoo_torch.common.config import get_config
        cfg = get_config()
        if not bool(cfg.get("compile.aot", True)):
            return None
        resolved = resolve_cache_dir()
        if resolved is None:
            return None
        cache_dir, farm = resolved
        cache_dir = os.path.abspath(cache_dir)
        with _caches_lock:
            cache = _caches.get(cache_dir)
            if cache is None:
                write = bool(cfg.get("compile.cache_write", True)) and \
                    (not farm or _process_id() == 0)
                cache = ExecutableCache(cache_dir, write_enabled=write)
                _caches[cache_dir] = cache
        return cache
    except Exception:   # noqa: BLE001 — resolution never breaks a path
        log.debug("compile cache resolution failed", exc_info=True)
        return None


def reset_cache_state() -> None:
    """Drop the per-directory cache singletons (config or write-policy
    changes take effect on the next resolve)."""
    with _caches_lock:
        _caches.clear()
