"""PyTorch port, the persistent artifact cache (``compile/cache.py``) and
its use by the kernel loader (``ops/kernels.py``), on the CPU.

The reference's cache contracts (``tests/test_compile_cache.py``) that do
not need XLA, held on bytes payloads: the key changes with each of its
components and only then; a hit returns the stored bytes; corrupt,
digest-mismatched, version-stale and truncated entries are loud misses,
evicted by a writer and never by a read-only process; concurrent writers
race safely; the LRU cap evicts with a counter; farm mode writes on host 0
only; ``compile.aot=false`` turns the cache off.  Then the kernel
libraries through a stand-in ``nvcc`` (a script that copies the source to
its ``-o`` path and logs each call): a cold build stores every library, a
fresh build directory is filled from the cache with no ``nvcc`` call, and
a corrupted entry is a loud miss that rebuilds the same bytes."""

import os
import pickle
import stat
import sys
import threading

import pytest

from analytics_zoo_torch.common import config as tconfig
from analytics_zoo_torch.compile import cache as cache_mod
from analytics_zoo_torch.compile.cache import (
    ENTRY_SUFFIX, ExecutableCache, cache_key, get_cache, reset_cache_state,
    resolve_cache_dir)
from analytics_zoo_torch.observability import get_registry
from analytics_zoo_torch.ops import kernels


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    monkeypatch.delenv("ZOO_TPU_COMPILE_CACHE", raising=False)
    monkeypatch.delenv("ZOO_TPU_RUN_DIR", raising=False)
    monkeypatch.delenv("ZOO_TPU_PROCESS_ID", raising=False)
    tconfig.reset_config()
    reset_cache_state()
    yield
    tconfig.reset_config()
    reset_cache_state()


def _errors(kind):
    return get_registry().counter(
        "compile_cache_errors_total", labels=("kind",)).labels(kind).value


def _entries(d):
    return sorted(f for f in os.listdir(d) if f.endswith(ENTRY_SUFFIX))


def _stored(d, payload=b"\x7fELF library bytes"):
    cache = ExecutableCache(str(d))
    key = cache_key("digest", "nvcc 12.8")
    assert cache.store(key, payload, key_hint="t") is True
    return cache, key


def _rewrite(cache, key, edit):
    with open(cache.path_for(key), "rb") as f:
        doc = pickle.load(f)
    edit(doc)
    with open(cache.path_for(key), "wb") as f:
        pickle.dump(doc, f)


class TestCacheKey:
    BASE = dict(digest="h", signature_repr="s", donate_repr="()",
                static_repr="()", backend_sig="cuda|H100|1|1", flags="")

    def key(self, **over):
        kw = dict(self.BASE, **over)
        return cache_key(kw.pop("digest"), kw.pop("signature_repr"), **kw)

    @pytest.mark.parametrize("field,value", [
        ("digest", "h2"), ("signature_repr", "s2"), ("donate_repr", "(0,)"),
        ("static_repr", "(1,)"), ("backend_sig", "cuda|H100|4|1"),
        ("flags", "-lineinfo")])
    def test_every_component_changes_the_key(self, field, value):
        assert self.key(**{field: value}) != self.key()
        assert self.key() == self.key()

    def test_backend_signature_and_versions_on_the_cpu(self):
        assert cache_mod.backend_signature().startswith("cpu|cpu|1|")
        v = cache_mod.runtime_versions()
        assert set(v) == {"torch", "cuda", "driver"}


class TestCacheDurability:
    def test_hit_returns_the_stored_bytes(self, tmp_path):
        cache, key = _stored(tmp_path)
        assert cache.load(key) == b"\x7fELF library bytes"
        assert cache.load(cache_key("other", "s")) is None

    def test_corrupt_entry_is_loud_miss_and_evicted(self, tmp_path):
        cache, key = _stored(tmp_path)
        with open(cache.path_for(key), "wb") as f:
            f.write(b"not a pickle")
        before = _errors("corrupt")
        assert cache.load(key) is None
        assert not os.path.exists(cache.path_for(key))
        assert _errors("corrupt") == before + 1

    def test_a_payload_that_does_not_match_its_digest_is_corrupt(
            self, tmp_path):
        """A flipped byte that still unpickles is never handed back as a
        library."""
        cache, key = _stored(tmp_path)
        _rewrite(cache, key, lambda doc: doc.__setitem__(
            "payload", b"\x7fELF librarx bytes"))
        before = _errors("corrupt")
        assert cache.load(key) is None
        assert _errors("corrupt") == before + 1

    def test_version_stale_entry_is_loud_miss_and_evicted(self, tmp_path):
        cache, key = _stored(tmp_path)
        _rewrite(cache, key, lambda doc: doc["meta"].__setitem__(
            "versions", {"torch": "0.0.1", "cuda": "1.0", "driver": "1"}))
        before = _errors("stale")
        assert cache.load(key) is None
        assert not os.path.exists(cache.path_for(key))
        assert _errors("stale") == before + 1

    def test_read_only_process_never_mutates_shared_entries(self, tmp_path):
        cache, key = _stored(tmp_path)
        ro = ExecutableCache(str(tmp_path), write_enabled=False)
        _rewrite(cache, key, lambda doc: doc["meta"].__setitem__(
            "versions", {"torch": "0.0.1"}))
        assert ro.load(key) is None
        assert os.path.exists(cache.path_for(key))      # not evicted
        with open(cache.path_for(key), "wb") as f:
            f.write(b"garbage")
        assert ro.load(key) is None
        assert os.path.exists(cache.path_for(key))      # still there
        assert ro.store(cache_key("x", "y"), b"z") is False
        assert cache.load(key) is None                  # the writer evicts
        assert not os.path.exists(cache.path_for(key))

    def test_truncated_write_never_crashes(self, tmp_path):
        cache, key = _stored(tmp_path)
        blob = open(cache.path_for(key), "rb").read()
        with open(cache.path_for(key), "wb") as f:
            f.write(blob[:len(blob) // 2])
        assert cache.load(key) is None

    def test_concurrent_writers_race_safely(self, tmp_path):
        cache = ExecutableCache(str(tmp_path))
        key = cache_key("race", "s")
        payload = os.urandom(1 << 16)
        errors = []

        def writer():
            try:
                for _ in range(10):
                    assert cache.store(key, payload, key_hint="race")
            except Exception as e:   # noqa: BLE001
                errors.append(e)

        def reader():
            try:
                for _ in range(30):
                    got = cache.load(key)
                    assert got is None or got == payload
            except Exception as e:   # noqa: BLE001
                errors.append(e)

        threads = [threading.Thread(target=writer) for _ in range(2)] + \
            [threading.Thread(target=reader)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert errors == []
        assert cache.load(key) == payload
        assert not [f for f in os.listdir(tmp_path) if f.startswith(".tmp")]

    def test_lru_cap_evicts_oldest_with_counter(self, tmp_path):
        cache = ExecutableCache(str(tmp_path), max_mb=0.02)   # ~20 KB
        ev = get_registry().counter("compile_cache_evictions_total")
        before = ev.value
        keys = [cache_key(f"h{i}", "s") for i in range(8)]
        for i, k in enumerate(keys):
            cache.store(k, os.urandom(4096), key_hint=f"k{i}")
            if os.path.exists(cache.path_for(k)):
                os.utime(cache.path_for(k), (1000 + i, 1000 + i))
            cache._enforce_cap()
        surviving = {n[:-len(ENTRY_SUFFIX)] for n in _entries(tmp_path)}
        assert 0 < len(surviving) < 8
        assert keys[-1] in surviving and keys[0] not in surviving
        assert ev.value >= before + 1


class TestResolution:
    def test_env_over_config_over_farm(self, tmp_path, monkeypatch):
        assert resolve_cache_dir() is None and get_cache() is None
        monkeypatch.setenv("ZOO_TPU_RUN_DIR", str(tmp_path / "run"))
        assert resolve_cache_dir() == (
            str(tmp_path / "run" / "compile-cache"), True)
        tconfig.get_config().set("compile.cache_dir", str(tmp_path / "cfg"))
        assert resolve_cache_dir() == (str(tmp_path / "cfg"), False)
        monkeypatch.setenv("ZOO_TPU_COMPILE_CACHE", str(tmp_path / "env"))
        assert resolve_cache_dir() == (str(tmp_path / "env"), False)
        assert get_cache().dir == str(tmp_path / "env")

    def test_compile_aot_false_turns_the_cache_off(self, tmp_path,
                                                   monkeypatch):
        monkeypatch.setenv("ZOO_TPU_COMPILE_CACHE", str(tmp_path))
        assert get_cache() is not None
        reset_cache_state()
        tconfig.get_config().set("compile.aot", False)
        assert get_cache() is None

    def test_farm_mode_host0_writes_and_a_worker_reads(self, tmp_path,
                                                       monkeypatch):
        run_dir = tmp_path / "run"
        run_dir.mkdir()
        monkeypatch.setenv("ZOO_TPU_RUN_DIR", str(run_dir))
        monkeypatch.setenv("ZOO_TPU_PROCESS_ID", "0")
        host0 = get_cache()
        assert host0.write_enabled
        assert host0.dir == str(run_dir / "compile-cache")
        key = cache_key("farm", "s")
        assert host0.store(key, b"lib")
        monkeypatch.setenv("ZOO_TPU_PROCESS_ID", "1")
        reset_cache_state()
        worker = get_cache()
        assert not worker.write_enabled
        assert worker.load(key) == b"lib"
        assert worker.store(cache_key("other", "s"), b"x") is False
        assert len(_entries(worker.dir)) == 1


# -------------------------------------------- the kernel libraries' cache
@pytest.fixture
def fake_nvcc(tmp_path, monkeypatch):
    """A stand-in nvcc in ``cuda/bin``: a build copies the source to the
    ``-o`` path; every call is logged."""
    log = tmp_path / "nvcc.log"
    (tmp_path / "cuda" / "bin").mkdir(parents=True)
    script = tmp_path / "cuda" / "bin" / "nvcc"
    script.write_text(
        f"#!{sys.executable}\n"
        "import shutil, sys\n"
        f"open({str(log)!r}, 'a').write(' '.join(sys.argv[1:]) + '\\n')\n"
        "args = sys.argv[1:]\n"
        "shutil.copyfile(args[-1], args[args.index('-o') + 1])\n")
    script.chmod(script.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(kernels, "nvcc_path", lambda: str(script))
    monkeypatch.setattr(kernels, "_nvcc_version", None)
    monkeypatch.setattr(kernels, "BUILD_DIR", str(tmp_path / "build1"))
    monkeypatch.setenv("ZOO_TPU_COMPILE_CACHE", str(tmp_path / "cache"))
    return log


def _builds(log):
    if not log.exists():
        return 0
    return sum(1 for line in log.read_text().splitlines()
               if " -o " in f" {line} ")


def _libraries(build_dir):
    return {f: open(os.path.join(build_dir, f), "rb").read()
            for f in sorted(os.listdir(build_dir)) if f.endswith(".so")}


def test_a_cold_build_stores_and_a_fresh_build_dir_loads_without_nvcc(
        fake_nvcc, tmp_path, monkeypatch):
    hits = get_registry().counter("compile_cache_hits_total",
                                  labels=("fn",))
    kernels.build_libraries(kernels.SOURCES)
    assert _builds(fake_nvcc) == len(kernels.SOURCES)
    cold = _libraries(tmp_path / "build1")
    assert len(cold) == len(kernels.SOURCES)
    assert len(_entries(tmp_path / "cache")) == len(kernels.SOURCES)
    before = sum(hits.labels(s).value for s in kernels.SOURCES)

    monkeypatch.setattr(kernels, "BUILD_DIR", str(tmp_path / "build2"))
    kernels.build_libraries(kernels.SOURCES)
    assert _builds(fake_nvcc) == len(kernels.SOURCES)       # no new nvcc
    assert _libraries(tmp_path / "build2") == cold           # bit for bit
    assert sum(hits.labels(s).value for s in kernels.SOURCES) == \
        before + len(kernels.SOURCES)


def test_a_corrupted_library_entry_is_a_loud_miss_and_rebuilds(
        fake_nvcc, tmp_path, monkeypatch):
    kernels.build_libraries(["bias_gelu"])
    cold = _libraries(tmp_path / "build1")
    entry = tmp_path / "cache" / _entries(tmp_path / "cache")[0]
    blob = bytearray(entry.read_bytes())
    blob[-40] ^= 0xFF                       # inside the payload
    entry.write_bytes(bytes(blob))
    before = _errors("corrupt")
    monkeypatch.setattr(kernels, "BUILD_DIR", str(tmp_path / "build2"))
    kernels.build_libraries(["bias_gelu"])
    assert _errors("corrupt") == before + 1
    assert _builds(fake_nvcc) == 2                           # rebuilt
    assert _libraries(tmp_path / "build2") == cold
    assert len(_entries(tmp_path / "cache")) == 1            # stored again


@pytest.mark.parametrize("manifest", [True, False])
def test_a_warm_load_starts_no_nvcc_and_another_toolkit_misses(
        fake_nvcc, tmp_path, monkeypatch, manifest):
    """The key's toolkit version comes from ``version.json`` beside
    ``bin/nvcc``, or else from the nvcc binary's bytes: a process that
    finds every library in the cache starts no nvcc, not even
    ``nvcc --version``; another toolkit is another key."""
    version = tmp_path / "cuda" / "version.json"
    nvcc = tmp_path / "cuda" / "bin" / "nvcc"
    if manifest:
        version.write_text('{"cuda_nvcc": {"version": "12.8.93"}}')
    kernels.build_libraries(["bias_gelu"])
    built = fake_nvcc.read_text().splitlines()
    assert len(built) == 1 and "--version" not in built[0]
    monkeypatch.setattr(kernels, "_nvcc_version", None)     # a new process
    monkeypatch.setattr(kernels, "BUILD_DIR", str(tmp_path / "build2"))
    kernels.build_libraries(["bias_gelu"])
    assert fake_nvcc.read_text().splitlines() == built
    assert _libraries(tmp_path / "build2") == _libraries(tmp_path / "build1")
    if manifest:
        version.write_text('{"cuda_nvcc": {"version": "12.9.41"}}')
    else:
        nvcc.write_text(nvcc.read_text() + "# another release\n")
    monkeypatch.setattr(kernels, "_nvcc_version", None)
    monkeypatch.setattr(kernels, "BUILD_DIR", str(tmp_path / "build3"))
    kernels.build_libraries(["bias_gelu"])                   # another key
    assert _builds(fake_nvcc) == 2


def test_the_key_follows_the_library_hash_and_the_nvcc_version(
        fake_nvcc, monkeypatch):
    a = kernels.library_cache_key("bias_gelu")
    assert a != kernels.library_cache_key("layernorm_act")
    monkeypatch.setattr(kernels, "_nvcc_version", "another nvcc")
    assert kernels.library_cache_key("bias_gelu") != a


def test_without_a_cache_dir_the_loader_builds_as_before(
        fake_nvcc, tmp_path, monkeypatch):
    monkeypatch.delenv("ZOO_TPU_COMPILE_CACHE")
    kernels.build_libraries(["bias_gelu"])
    kernels.build_libraries(["bias_gelu"])                   # already built
    assert _builds(fake_nvcc) == 1
    assert not (tmp_path / "cache").exists()
