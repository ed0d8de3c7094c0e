"""PyTorch port, kernel modules: each plain version against the JAX
package's Pallas kernel run in interpret mode on the CPU, the CPU routing
of the kernel wrappers, and the kernel loader's build step.

The CUDA kernels themselves run only on a card:
tests/test_torch_kernels_cuda.py and chip_smoke.py hold them against
these plain versions there."""

import contextlib
import ctypes
import os
import re
import stat

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from analytics_zoo_tpu.ops import activations as jacts
from analytics_zoo_tpu.ops import fused as jfused
from analytics_zoo_tpu.ops.attention import (
    scaled_dot_product_attention as j_sdpa,
)
from analytics_zoo_tpu.ops.pallas_attention import (
    _flash_fwd_impl, flash_attention as j_flash,
)

from analytics_zoo_torch.common import config as tconfig
from analytics_zoo_torch.ops import activations as tacts
from analytics_zoo_torch.ops import flash_attention as tfa
from analytics_zoo_torch.ops import fused as tfused
from analytics_zoo_torch.ops import kernels
from analytics_zoo_torch.ops.attention import (
    scaled_dot_product_attention as t_sdpa,
)


@pytest.fixture(autouse=True)
def _port_config():
    tconfig.reset_config()
    kernels.reset_launch_counts()
    yield
    tconfig.reset_config()


@contextlib.contextmanager
def _full_f32_products():
    """Pin both frameworks' float32 products to full float32 for the
    comparison: JAX's default matmul precision and torch's float32 matmul
    precision are process-wide, and a file run earlier on the same test
    worker may leave either at a cheaper setting."""
    before = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        with jax.default_matmul_precision("float32"):
            yield
    finally:
        torch.set_float32_matmul_precision(before)


def _qkv(seed, shape=(2, 2, 128, 64)):
    rs = np.random.RandomState(seed)
    return [rs.randn(*shape).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("causal", [False, True])
def test_flash_ref_matches_pallas_interpret(causal):
    q, k, v = _qkv(0)
    scale = 64 ** -0.5
    with _full_f32_products():
        jo, jl = _flash_fwd_impl(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), (causal, scale, 64, 64, True))
        to, tl = tfa.flash_attention_ref(
            torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
            causal=causal, scale=scale)
    assert tl.shape == jl.shape == (4, 128, 1)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo),
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                               atol=1e-5, rtol=0)


@pytest.mark.parametrize("causal", [False, True])
def test_flash_attention_public_entry_matches_reference(causal):
    q, k, v = _qkv(1)
    want = j_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                   causal=causal, block_q=64, block_k=64, interpret=True)
    got = tfa.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("causal", [False, True])
def test_flash_backward_matches_pallas_vjp(causal):
    """The port's flash autograd on the CPU (plain forward, then
    flash_attention_bwd_ref) and flash_attention_bwd_ref called directly,
    against jax.vjp through the Pallas kernels in interpret mode."""
    q, k, v = _qkv(8, (1, 2, 256, 64))
    do = np.random.RandomState(9).randn(1, 2, 256, 64).astype(np.float32)
    out, vjp = jax.vjp(
        lambda a, b, c: j_flash(a, b, c, causal=causal, interpret=True),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = [np.asarray(g) for g in vjp(jnp.asarray(do))]

    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    o = tfa.flash_attention(tq, tk, tv, causal=causal)
    assert o.grad_fn is not None
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(out),
                               atol=1e-5, rtol=1e-5)
    got = torch.autograd.grad(o, (tq, tk, tv), torch.from_numpy(do))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, atol=1e-5, rtol=0)

    qq, kk, vv = (torch.from_numpy(a) for a in (q, k, v))
    o, lse = tfa.flash_attention_ref(qq, kk, vv, causal=causal)
    direct = tfa.flash_attention_bwd_ref(qq, kk, vv, o, lse,
                                         torch.from_numpy(do), causal=causal)
    for g, w in zip(direct, want):
        np.testing.assert_allclose(g.numpy(), w, atol=1e-5, rtol=0)
    assert sum(kernels.launch_counts().values()) == 0


@pytest.mark.parametrize("causal,masked", [(False, False), (True, False),
                                           (False, True)])
def test_dense_attention_matches_reference(causal, masked):
    q, k, v = _qkv(2, (2, 3, 40, 16))
    mask = None
    if masked:
        mask = (np.random.RandomState(3).rand(2, 1, 1, 40) > 0.3)
        mask = mask.astype(np.float32)
    want = j_sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                  mask=None if mask is None else jnp.asarray(mask),
                  causal=causal)
    got = t_sdpa(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                 mask=None if mask is None else torch.from_numpy(mask),
                 causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=1e-5, rtol=1e-5)


def test_bias_gelu_ref_matches_pallas_interpret():
    rs = np.random.RandomState(4)
    x = rs.randn(64, 256).astype(np.float32)
    b = rs.randn(256).astype(np.float32)
    want = jfused.bias_gelu(jnp.asarray(x), jnp.asarray(b), interpret=True)
    got = tfused.bias_gelu_ref(torch.from_numpy(x), torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=1e-6, rtol=0)


@pytest.mark.parametrize("act", ["gelu", None])
def test_layernorm_act_ref_matches_pallas_interpret(act):
    rs = np.random.RandomState(5)
    x = rs.randn(64, 256).astype(np.float32)
    g = (rs.rand(256) + 0.5).astype(np.float32)
    b = rs.randn(256).astype(np.float32)
    want = jfused.layernorm_act(jnp.asarray(x), jnp.asarray(g),
                                jnp.asarray(b), eps=1e-5,
                                activation=jacts.get(act), interpret=True)
    got = tfused.layernorm_act_ref(torch.from_numpy(x), torch.from_numpy(g),
                                   torch.from_numpy(b), eps=1e-5,
                                   activation=tacts.get(act))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=1e-5, rtol=0)


@pytest.mark.parametrize("name", ["gelu", "gelu_erf", "relu", "tanh"])
def test_activations_match_reference(name):
    x = np.linspace(-6, 6, 1001, dtype=np.float32)
    want = jacts.get(name)(jnp.asarray(x))
    got = tacts.get(name)(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=1e-6, rtol=0)


@pytest.mark.parametrize("mode", ["auto", "torch"])
def test_cpu_tensors_take_the_plain_version_and_launch_nothing(
        monkeypatch, mode):
    def no_kernel(name):
        raise AssertionError(f"kernel {name} reached for a CPU tensor")
    monkeypatch.setattr(kernels, "entry", no_kernel)
    tconfig.get_config().set("ops.fused", mode)
    q, k, v = (torch.from_numpy(a) for a in _qkv(6))
    x = torch.randn(16, 64, generator=torch.Generator().manual_seed(0))
    bias, gamma = torch.zeros(64), torch.ones(64)
    assert torch.equal(tfa.flash_attention(q, k, v),
                       tfa.flash_attention_ref(q, k, v)[0])
    assert torch.equal(tfused.bias_gelu(x, bias),
                       tfused.bias_gelu_ref(x, bias))
    assert torch.equal(
        tfused.layernorm_act(x, gamma, bias, activation=tacts.gelu),
        tfused.layernorm_act_ref(x, gamma, bias, activation=tacts.gelu))
    p, m, v = x.clone(), torch.zeros_like(x), torch.zeros_like(x)
    tfused.adam_leaf_update(p, x, m, v, tfused.step_scalars(None, -0.1, 0.1,
                                                           0.001),
                            b1=0.9, b2=0.999, eps=1e-8)
    tfused.sgd_leaf_update(p, x, m, tfused.step_scalars(None, -0.1),
                           momentum=0.9, nesterov=False)
    assert kernels.launch_counts() == {name: 0 for name in kernels.SIGNATURES}


def test_kernel_wrappers_refuse_cpu_tensors():
    q, k, v = (torch.from_numpy(a) for a in _qkv(7))
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_attention_fwd(q, k, v)
    o, lse = tfa.flash_attention_ref(q, k, v)
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_attention_bwd(q, k, v, o, lse, o)
    with pytest.raises(ValueError, match="CUDA"):
        tfused.bias_gelu_kernel(torch.zeros(4, 8), torch.zeros(8))
    with pytest.raises(ValueError, match="CUDA"):
        tfused.layernorm_act_kernel(torch.zeros(4, 8), torch.ones(8),
                                    torch.zeros(8))
    assert sum(kernels.launch_counts().values()) == 0


def test_unknown_fused_mode_raises():
    tconfig.get_config().set("ops.fused", "lax")
    with pytest.raises(ValueError, match="ops.fused"):
        tfused.fused_enabled()


def test_missing_nvcc_is_an_error(monkeypatch, tmp_path):
    monkeypatch.setattr(kernels.shutil, "which", lambda _: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(kernels, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(kernels, "_libs", {})
    with pytest.raises(RuntimeError, match="nvcc not found"):
        kernels.build_all()


def _fake_nvcc(tmp_path, body):
    path = tmp_path / "nvcc"
    path.write_text("#!/bin/sh\n" + body)
    path.chmod(path.stat().st_mode | stat.S_IEXEC)
    return str(path)


def test_build_runs_one_nvcc_per_source_with_the_stated_flags(
        monkeypatch, tmp_path):
    log = tmp_path / "calls"
    # records its arguments and writes the -o target, like nvcc
    nvcc = _fake_nvcc(tmp_path, f'echo "$@" >> {log}\n'
                      'while [ $# -gt 0 ]; do [ "$1" = -o ] && : > "$2"; '
                      'shift; done\n')
    monkeypatch.setattr(kernels, "nvcc_path", lambda: nvcc)
    monkeypatch.setattr(kernels, "BUILD_DIR", str(tmp_path / "build"))
    started = {n: kernels._start_build(n) for n in kernels.SOURCES}
    for n, s in started.items():
        kernels._finish_build(n, s)
    calls = log.read_text().splitlines()
    assert len(calls) == len(kernels.SOURCES)
    assert set(kernels.SOURCES) == {src for src, _, _ in
                                    kernels.SIGNATURES.values()}
    for n in kernels.SOURCES:
        call = next(c for c in calls if c.endswith(f"csrc/{n}.cu"))
        assert "arch=compute_90a,code=sm_90a" in call
        assert "-shared" in call and "fast_math" not in call
        assert os.path.isfile(kernels.library_path(n))
    # a built library is reused: no second nvcc run
    assert all(kernels._start_build(n) is None for n in kernels.SOURCES)


def test_failed_build_raises_with_the_compiler_log(monkeypatch, tmp_path):
    nvcc = _fake_nvcc(tmp_path, 'echo "error: no sm_90a here"; exit 2\n')
    monkeypatch.setattr(kernels, "nvcc_path", lambda: nvcc)
    monkeypatch.setattr(kernels, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(kernels, "_libs", {})
    with pytest.raises(RuntimeError, match="no sm_90a here"):
        kernels.build_all(["bias_gelu"])
    assert not os.listdir(tmp_path / "build")


def test_library_name_follows_the_source(monkeypatch, tmp_path):
    src = tmp_path / "csrc"
    src.mkdir()
    (src / "bias_gelu.cu").write_text("// one")
    monkeypatch.setattr(kernels, "CSRC_DIR", str(src))
    first = kernels.library_path("bias_gelu")
    (src / "bias_gelu.cu").write_text("// two")
    second = kernels.library_path("bias_gelu")
    assert second != first
    # a shared header is part of every source's build: editing only the
    # header must not load a stale library
    (src / "flash_tile.cuh").write_text("// tile one")
    third = kernels.library_path("bias_gelu")
    assert third != second
    (src / "flash_tile.cuh").write_text("// tile two")
    assert kernels.library_path("bias_gelu") != third
    assert kernels.library_path("bias_gelu") == kernels.library_path(
        "bias_gelu")


def _c_parameters(source: str, entry_point: str):
    """The parameter declarations of ``extern "C" int entry_point(...)`` in
    ``source``'s text, or None where no such definition is found."""
    m = re.search(r'extern\s+"C"\s+int\s+' + re.escape(entry_point) +
                  r'\s*\(([^)]*)\)\s*\{', source)
    if m is None:
        return None
    return [p.strip() for p in m.group(1).split(",") if p.strip()]


@pytest.mark.parametrize("name", sorted(kernels.SIGNATURES))
def test_signature_matches_the_c_entry_point(name):
    """ctypes passes what ``argtypes`` says: an int where the C function
    takes a pointer would cut the pointer to 32 bits, and only on the
    card.  So every entry point is defined in its source with as many
    parameters as its argtypes, each pointer as c_void_p, each int as
    c_int and each float as c_float."""
    source, entry_point, argtypes = kernels.SIGNATURES[name]
    with open(kernels.source_path(source)) as f:
        params = _c_parameters(f.read(), entry_point)
    assert params is not None, f"{entry_point} is not defined in {source}.cu"
    assert len(params) == len(argtypes), params
    for decl, argtype in zip(params, argtypes):
        if "*" in decl:
            want = ctypes.c_void_p
        elif re.match(r"(const\s+)?int\b", decl):
            want = ctypes.c_int
        elif re.match(r"(const\s+)?float\b", decl):
            want = ctypes.c_float
        else:
            raise AssertionError(f"{entry_point}: unexpected parameter {decl!r}")
        assert argtype is want, (entry_point, decl, argtype)


@pytest.mark.parametrize("name", sorted(kernels.ATTRIBUTE_QUERIES))
def test_attribute_query_matches_the_c_entry_point(name):
    """The bf16 backward's attribute query is defined in the kernel's own
    source with its leading ints, head_dim and an int pointer, as
    ``kernel_attributes`` passes them."""
    entry_point, lead = kernels.ATTRIBUTE_QUERIES[name]
    source = kernels.SIGNATURES[name][0]
    with open(kernels.source_path(source)) as f:
        params = _c_parameters(f.read(), entry_point)
    assert params is not None, f"{entry_point} is not defined in {source}.cu"
    assert len(params) == len(lead) + 2, params
    assert all(re.match(r"int\s+\w+$", p) for p in params[:-1]), params
    assert re.match(r"int\s*\*\s*\w+$", params[-1]), params


@pytest.mark.parametrize("name", sorted(kernels.CLUSTER_QUERIES))
def test_cluster_query_matches_the_c_entry_point(name):
    """Each wide kernel's occupancy query is defined in the kernel's own
    source with its leading ints, z and an int pointer, as
    ``max_active_clusters`` passes them."""
    entry_point, lead = kernels.CLUSTER_QUERIES[name]
    source = kernels.SIGNATURES[name][0]
    with open(kernels.source_path(source)) as f:
        params = _c_parameters(f.read(), entry_point)
    assert params is not None, f"{entry_point} is not defined in {source}.cu"
    assert len(params) == len(lead) + 2, params
    assert all(re.match(r"int\s+\w+$", p) for p in params[:-1]), params
    assert re.match(r"int\s*\*\s*\w+$", params[-1]), params
