"""PyTorch port, the flash op on bfloat16: its plain versions and its
autograd on the CPU against the JAX package's Pallas kernels in interpret
mode at head_dim 64, 128, 192 and 256, the bf16 forward kernel's order of
arithmetic (128-key tiles at 64 and 128, 64-key tiles at 192 and 256)
emulated in PyTorch against both, the float32 plain versions against
their pre-bf16 formulas bit for bit, the op's routing, dense attention in
bf16, and the port's ``bench_attention`` at a small size.

The bf16 kernels themselves run only on a card:
tests/test_torch_kernels_cuda.py and chip_smoke.py hold them against the
plain versions held here.

The JAX reference runs in a child process with
``--xla_allow_excess_precision=false``.  By default XLA may keep a bf16
product in float32 where a float32 consumer follows it: on the CPU it drops
the reference dK/dV kernel's rounding of ``q * scale`` to bf16 (its
forward and dQ kernel keep theirs), and at head_dim 128, where the scale is
not a power of two, dK and dV move by ~3e-3 relative L2.  The kernels as
written round ``q * scale`` to bf16 in all three, and so does the port.
"""

import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from analytics_zoo_tpu.ops.attention import (
    scaled_dot_product_attention as j_sdpa,
)
from analytics_zoo_tpu.ops.pallas_attention import flash_attention as j_flash

from analytics_zoo_torch.benchmarks.attention import (
    attention_flops, bench_attention,
)
from analytics_zoo_torch.common import config as tconfig
from analytics_zoo_torch.ops import flash_attention as tfa
from analytics_zoo_torch.ops import kernels
from analytics_zoo_torch.ops.attention import (
    scaled_dot_product_attention as t_sdpa,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CASES = [(d, causal) for d in (64, 128, 192, 256) for causal in (False, True)]
SHAPE_T = 256
BLOCK = 64

# O against the reference: the reference rounds P to bf16 at each K
# block's running max, the plain version at the row's max, and both round
# O to bf16 once.  So an element may land one bf16 ulp apart (2^-7 of it
# at most), and the two roundings of P leave a difference that scales with
# the row's values, not the element's: 2^-6 of the row's RMS (the plain
# version reads up to 0.59 of this bound here, the order before the bf16
# repair 1.07 to 1.40).
O_RTOL, O_ROW_RMS = 2.0 ** -7, 2.0 ** -6
# Where key 0 holds every row's largest score, the reference's running max
# is the row's max from its first block on and both round P alike: O may
# differ only where float32 sums in other orders tip S, P or O to the next
# value, on at most this share of its elements (0.02% here; more with more
# keys a row, 1.6% at 4096 keys), each within the bound above.
O_TIPPED_SHARE = 0.05
# LSE is float32 on both sides from the same bf16 products: summation order
LSE_ATOL = 1e-5
# Gradients, relative L2 each: the plain version in the reference's order
# reads 2.6e-5 to 8.7e-4 here; with S rounded to bf16 before the softmax
# (the order before this repair) it read 3.1e-3 to 4.2e-3.
GRAD_RL2 = 2e-3


@pytest.fixture(autouse=True)
def _port_config():
    tconfig.reset_config()
    kernels.reset_launch_counts()
    yield
    tconfig.reset_config()


def _as_bf16_values(xs):
    return [torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16)
            .float().numpy() for x in xs]


def _inputs(d, seed=0):
    """q, k, v, dO (1, 2, 256, d) as float32 arrays holding bf16 values."""
    rs = np.random.RandomState(seed)
    return _as_bf16_values([rs.randn(1, 2, SHAPE_T, d) for _ in range(4)])


def _leading_key_inputs(d, seed=0):
    """q, k, v, dO as ``_inputs`` gives them, but with key 0 holding every
    row's largest score by a wide margin: coordinate 0 of q is 2, of k
    uniform in [-17, 0] and 10 at key 0; q's other coordinates are
    N(0, 0.01)."""
    rs = np.random.RandomState(seed)
    shape = (1, 2, SHAPE_T, d)
    q = 0.1 * rs.randn(*shape)
    q[..., 0] = 2.0
    k = rs.randn(*shape)
    k[..., 0] = rs.uniform(-17.0, 0.0, shape[:-1])
    k[..., 0, 0] = 10.0
    return _as_bf16_values([q, k, rs.randn(*shape), rs.randn(*shape)])


def _o_used(got, want):
    """The largest share of its tolerance an element of O uses: one bf16
    ulp plus 2^-6 of the row's RMS in the reference's O."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    row_rms = np.sqrt((want.astype(np.float64) ** 2).mean(-1, keepdims=True))
    bound = O_ROW_RMS * row_rms + O_RTOL * np.abs(want)
    return float((np.abs(got - want) / bound).max())


def _assert_o_close(got, want):
    used = _o_used(got, want)
    assert used <= 1.0, used


def _o_tipped(got, want):
    """The share of elements of ``got`` not equal to ``want``, and the
    largest share of its tolerance an element uses."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float((got != want).mean()), _o_used(got, want)


_CHILD = r"""
import json, sys
import numpy as np
import jax, jax.numpy as jnp
from analytics_zoo_tpu.ops.pallas_attention import flash_attention
src, dst, cases, block = sys.argv[1], sys.argv[2], json.loads(sys.argv[3]), int(sys.argv[4])
arrays, out = np.load(src), {}
for d, causal in cases:
    q, k, v, do = (jnp.asarray(arrays[f"{n}{d}"]).astype(jnp.bfloat16) for n in "qkvg")
    o, vjp = jax.vjp(lambda a, b, c: flash_attention(
        a, b, c, causal=causal, block_q=block, block_k=block, interpret=True), q, k, v)
    for name, x in zip(("o", "dq", "dk", "dv"), (o, *vjp(do))):
        out[f"{name}{d}{int(causal)}"] = np.asarray(x.astype(jnp.float32))
np.savez(dst, **out)
"""


def _reference(tmp, make_inputs):
    """The JAX op's O and (dq, dk, dv) for every case on ``make_inputs``'s
    arrays, bf16 in and out, from one child process without XLA's excess
    precision."""
    arrays = {}
    for d in sorted({d for d, _ in CASES}):
        for name, x in zip("qkvg", make_inputs(d)):
            arrays[f"{name}{d}"] = x
    np.savez(tmp / "in.npz", **arrays)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_allow_excess_precision=false",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    subprocess.run([sys.executable, "-c", _CHILD, str(tmp / "in.npz"),
                    str(tmp / "out.npz"), json.dumps(CASES), str(BLOCK)],
                   check=True, env=env, cwd=REPO, timeout=600)
    return dict(np.load(tmp / "out.npz"))


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return _reference(tmp_path_factory.mktemp("flash_bf16"), _inputs)


@pytest.fixture(scope="module")
def leading_reference(tmp_path_factory):
    return _reference(tmp_path_factory.mktemp("flash_bf16_leading"),
                      _leading_key_inputs)


def _rel_l2(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _bf16(x):
    return torch.from_numpy(x).to(torch.bfloat16)


@pytest.mark.parametrize("d,causal", CASES)
def test_bf16_autograd_matches_pallas_interpret(reference, d, causal):
    """flash_attention with autograd on bf16 CPU tensors (the plain
    versions) against jax.vjp through the Pallas kernels."""
    q, k, v, do = _inputs(d)
    leaves = [_bf16(x).requires_grad_() for x in (q, k, v)]
    o = tfa.flash_attention(*leaves, causal=causal)
    assert o.dtype == torch.bfloat16 and o.grad_fn is not None
    grads = torch.autograd.grad(o, leaves, _bf16(do))
    tag = f"{d}{int(causal)}"
    _assert_o_close(o.detach().float().numpy(), reference[f"o{tag}"])
    for name, g in zip(("dq", "dk", "dv"), grads):
        assert g.dtype == torch.bfloat16
        err = _rel_l2(g.float().numpy(), reference[f"{name}{tag}"])
        assert err <= GRAD_RL2, (name, err)
    assert sum(kernels.launch_counts().values()) == 0


@pytest.mark.parametrize("d,causal", CASES)
def test_bf16_plain_backward_matches_pallas_interpret(reference, d, causal):
    """flash_attention_bwd_ref called directly on the reference's own O
    (and the plain forward's LSE) against the reference's gradients."""
    q, k, v, do = (_bf16(x) for x in _inputs(d))
    tag = f"{d}{int(causal)}"
    o_ref = _bf16(reference[f"o{tag}"])
    _, lse = tfa.flash_attention_ref(q, k, v, causal=causal)
    delta = tfa.flash_attention_delta(o_ref, do)
    dq = tfa.flash_attention_dq_ref(q, k, v, do, lse, delta, causal)
    dk, dv = tfa.flash_attention_dkv_ref(q, k, v, do, lse, delta, causal)
    for name, g in (("dq", dq), ("dk", dk), ("dv", dv)):
        err = _rel_l2(g.float().numpy(), reference[f"{name}{tag}"])
        assert err <= GRAD_RL2, (name, err)


@pytest.mark.parametrize("causal", [False, True])
def test_bf16_forward_lse_matches_pallas_in_process(causal):
    """The plain forward's LSE and O against the Pallas forward run in this
    process at head_dim 64 (scale 1/8: no rounding of the scale at all)."""
    from analytics_zoo_tpu.ops.pallas_attention import _flash_fwd_impl
    q, k, v, _ = _inputs(64, seed=3)
    jq, jk, jv = (jnp.asarray(x).astype(jnp.bfloat16) for x in (q, k, v))
    jo, jl = _flash_fwd_impl(jq, jk, jv, (causal, 0.125, BLOCK, BLOCK, True))
    to, tl = tfa.flash_attention_ref(_bf16(q), _bf16(k), _bf16(v),
                                     causal=causal)
    assert to.dtype == torch.bfloat16 and tl.dtype == torch.float32
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LSE_ATOL,
                               rtol=0)
    _assert_o_close(to.float().numpy(), np.asarray(jo.astype(jnp.float32)))


def _o_unrounded_p(q, k, v, causal):
    """Control: O in the reference's order but with P kept in float32."""
    t, d = q.shape[2], q.shape[3]
    s = torch.matmul(tfa._scaled_q(q, d ** -0.5).float(),
                     k.float().transpose(-1, -2))
    if causal:
        keep = torch.ones(t, t, dtype=torch.bool).tril_()
        s = torch.where(keep, s, s.new_tensor(-1e30))
    p = torch.exp(s - s.amax(-1, keepdim=True))
    l_safe = p.sum(-1, keepdim=True).clamp_min(1e-30)
    return (torch.matmul(p, v.float()) / l_safe).to(q.dtype)


@pytest.mark.parametrize("d,causal", CASES)
def test_bf16_o_rounds_p_as_the_reference(leading_reference, d, causal):
    """Where key 0 leads every row, the plain version's O is the
    reference's on all but a few elements."""
    q, k, v, _ = (_bf16(x) for x in _leading_key_inputs(d))
    o = tfa.flash_attention_ref(q, k, v, causal=causal)[0]
    tipped, used = _o_tipped(o.float().numpy(),
                             leading_reference[f"o{d}{int(causal)}"])
    assert tipped <= O_TIPPED_SHARE and used <= 1.0, (tipped, used)


@pytest.mark.parametrize("d,causal", CASES)
def test_bf16_o_checks_reject_the_wrong_orders(leading_reference, d,
                                               causal):
    """The check above fails for the order before the bf16 repair (S
    rounded to bf16 before the softmax, P.V rounded before the division)
    and for an unrounded P."""
    q, k, v, _ = (_bf16(x) for x in _leading_key_inputs(d))
    want = leading_reference[f"o{d}{int(causal)}"]
    for control in (_old_fwd(q, k, v, causal, d ** -0.5)[0],
                    _o_unrounded_p(q, k, v, causal)):
        tipped, used = _o_tipped(control.float().numpy(), want)
        assert not (tipped <= O_TIPPED_SHARE and used <= 1.0), tipped


@pytest.mark.parametrize("d", [64, 128, 192, 256])
def test_q_scale_rounds_as_jax_weak_types(d):
    """q * scale in bf16: the scale rounded to bf16, the product rounded
    once, as JAX multiplies a bf16 array by a Python float (192 ** -0.5 is
    not a power of two and rounds; 256's 1/16 is exact)."""
    x = np.random.RandomState(d).randn(4096).astype(np.float32)
    want = np.asarray((jnp.asarray(x).astype(jnp.bfloat16) * d ** -0.5)
                      .astype(jnp.float32))
    got = tfa._scaled_q(torch.from_numpy(x).to(torch.bfloat16), d ** -0.5)
    assert got.dtype == torch.bfloat16
    assert np.array_equal(got.float().numpy(), want)
    assert tfa.q_scale(d ** -0.5, torch.float32) == d ** -0.5


# ---- the bf16 forward kernel's order of arithmetic, emulated on the CPU

# keys a tile of the bf16 forward kernel (csrc/flash_attention_fwd_bf16.cu,
# Cfg::BN), by head_dim
KERNEL_TILE = {64: 128, 128: 128, 192: 64, 256: 64}


def _tiled_forward(q, k, v, causal, block=None):
    """The bf16 forward kernel's order in PyTorch: ``q * scale`` rounded to
    bf16, S in float32 from bf16 values (causal cells at -1e30), an online
    softmax over ``block``-key tiles (the running max from -1e30, l the
    sum of the unrounded p, O rescaled by exp(m_old - m_new) before a
    tile's P V is added), P rounded to bf16 at the tile's running max, O
    divided once and rounded to bf16, LSE float32.  The kernel also skips
    the tiles past a block's diagonal: here they add p = 0 at corr = 1,
    which changes nothing."""
    b, h, t, d = q.shape
    block = block or KERNEL_TILE[d]
    qs = tfa._scaled_q(q, d ** -0.5).float()
    kf, vf = k.float(), v.float()
    m = torch.full((b, h, t, 1), -1e30)
    l = torch.zeros(b, h, t, 1)
    acc = torch.zeros(b, h, t, d)
    rows = torch.arange(t).reshape(t, 1)
    for k0 in range(0, t, block):
        s = torch.matmul(qs, kf[:, :, k0:k0 + block].transpose(-1, -2))
        if causal:
            cols = torch.arange(k0, min(k0 + block, t)).reshape(1, -1)
            s = torch.where(cols <= rows, s, s.new_tensor(-1e30))
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        corr = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        l = l * corr + p.sum(-1, keepdim=True)
        acc = acc * corr + torch.matmul(p.to(torch.bfloat16).float(),
                                        vf[:, :, k0:k0 + block])
        m = m_new
    l_safe = l.clamp_min(1e-30)
    return (acc / l_safe).to(q.dtype), (m + torch.log(l_safe)).reshape(
        b * h, t, 1)


@pytest.mark.parametrize("d,causal", CASES)
def test_bf16_kernel_order_matches_the_plain_version(d, causal):
    """The kernel's order against the plain version by the bounds that
    hold the kernel to it on the card (chip_smoke.py, phase 14): O within
    one ulp plus 2^-6 of its row's RMS, LSE 1e-5, and where key 0 leads
    every row O equal to the plain version's on all but 5% of elements."""
    q, k, v, _ = (_bf16(x) for x in _inputs(d, seed=4))
    o, lse = _tiled_forward(q, k, v, causal)
    o_ref, lse_ref = tfa.flash_attention_ref(q, k, v, causal=causal)
    assert o.dtype == torch.bfloat16
    _assert_o_close(o.float().numpy(), o_ref.float().numpy())
    np.testing.assert_allclose(lse.numpy(), lse_ref.numpy(), atol=LSE_ATOL,
                               rtol=0)
    q, k, v, _ = (_bf16(x) for x in _leading_key_inputs(d))
    tipped, used = _o_tipped(_tiled_forward(q, k, v, causal)[0].float().numpy(),
                             tfa.flash_attention_ref(q, k, v, causal=causal)[0]
                             .float().numpy())
    assert tipped <= O_TIPPED_SHARE and used <= 1.0, (tipped, used)


@pytest.mark.parametrize("d,causal", CASES)
def test_bf16_kernel_order_matches_pallas_interpret(reference,
                                                    leading_reference, d,
                                                    causal):
    """The kernel's order (its instance's key tiles) against the Pallas
    kernel in interpret mode (64-key blocks) within the bounds that hold the
    plain version to it above."""
    tag = f"{d}{int(causal)}"
    q, k, v, _ = (_bf16(x) for x in _inputs(d))
    _assert_o_close(_tiled_forward(q, k, v, causal)[0].float().numpy(),
                    reference[f"o{tag}"])
    q, k, v, _ = (_bf16(x) for x in _leading_key_inputs(d))
    tipped, used = _o_tipped(_tiled_forward(q, k, v, causal)[0].float().numpy(),
                             leading_reference[f"o{tag}"])
    assert tipped <= O_TIPPED_SHARE and used <= 1.0, (tipped, used)


# ---- the bf16 backward kernels' order at head_dim 192 and 256, emulated

WIDE_BWD_CASES = [(d, causal) for d in (192, 256) for causal in (False, True)]


def _bf16_parts(x):
    """x (float32) as three bf16 parts, the largest first, as
    ``flash_tile.cuh::bf16_parts`` splits it: each part the nearest bf16
    of what the parts before it leave (the subtraction is exact)."""
    parts, rest = [], x.float()
    for _ in range(3):
        part = rest.to(torch.bfloat16).float()
        parts.append(part)
        rest = rest - part
    return parts


def _product3(w, x):
    """w . x with w (float32) as its three bf16 parts, the smallest part's
    product added first."""
    acc = torch.zeros(w.shape[:-1] + x.shape[-1:])
    for part in reversed(_bf16_parts(w)):
        acc = acc + torch.matmul(part, x)
    return acc


def _tiled_backward(q, k, v, do, lse, delta, causal, block=BLOCK):
    """The bf16 dQ and dK/dV kernels' order at head_dim 192 and 256 in
    PyTorch.  ``q * scale`` rounded as the kernels take it (where the
    rounded scale is a power of two, as at 256, q is read unscaled and the
    scale multiplies S and dK instead: the same values).  Per 64-key tile
    of a query block (dQ) and per 64-query tile of a key block (dK/dV):
    S (S^T) and dP (dP^T) in float32 from bf16 values, P = exp(S - lse)
    with causal cells at -1e30, dS = P (dP - delta), and dQ = dS K in two
    column slices ([0, 128) and the rest, the kernel's two wgmmas on the
    same operands), dV = P^T dO and dK = dS^T qs, each from the float32
    operand's three bf16 parts, summed tile by tile.  Returns (dq, dk, dv)
    in q's dtype."""
    b, h, t, d = q.shape
    scale = d ** -0.5
    qscale = tfa.q_scale(scale, q.dtype)
    exact = math.frexp(qscale)[0] == 0.5
    qs = q.float() if exact else tfa._scaled_q(q, scale).float()
    smul = qscale if exact else 1.0
    kf, vf, dof = k.float(), v.float(), do.float()
    lse4, delta4 = lse.reshape(b, h, t, 1), delta.reshape(b, h, t, 1)
    pos = torch.arange(t)

    def p_and_ds(q0, q1, k0, k1):
        """P and dS of queries [q0, q1) against keys [k0, k1)."""
        s = torch.matmul(qs[:, :, q0:q1], kf[:, :, k0:k1].transpose(-1, -2))
        s = s * smul
        if causal:
            keep = pos[k0:k1].reshape(1, -1) <= pos[q0:q1].reshape(-1, 1)
            s = torch.where(keep, s, s.new_tensor(-1e30))
        p = torch.exp(s - lse4[:, :, q0:q1])
        dp = torch.matmul(dof[:, :, q0:q1], vf[:, :, k0:k1].transpose(-1, -2))
        return p, p * (dp - delta4[:, :, q0:q1])

    slices = ((0, 128), (128, d))
    dq, dk, dv = (torch.zeros(b, h, t, d) for _ in range(3))
    for q0 in range(0, t, block):
        q1 = min(q0 + block, t)
        for k0 in range(0, q1 if causal else t, block):
            k1 = min(k0 + block, t)
            _, ds = p_and_ds(q0, q1, k0, k1)
            for c0, c1 in slices:
                dq[:, :, q0:q1, c0:c1] += _product3(ds, kf[:, :, k0:k1, c0:c1])
    for k0 in range(0, t, block):
        k1 = min(k0 + block, t)
        for q0 in range(k0 if causal else 0, t, block):
            q1 = min(q0 + block, t)
            p, ds = p_and_ds(q0, q1, k0, k1)
            dv[:, :, k0:k1] += _product3(p.transpose(-1, -2), dof[:, :, q0:q1])
            dk[:, :, k0:k1] += _product3(ds.transpose(-1, -2), qs[:, :, q0:q1])
    return ((dq * scale).to(q.dtype), (dk * smul).to(k.dtype),
            dv.to(v.dtype))


def _bwd_inputs(d, t, causal, seed):
    """bf16 q, k, v, dO of (1, 2, t, d), and the plain forward's LSE and
    delta."""
    rs = np.random.RandomState(seed)
    q, k, v, do = (_bf16(x) for x in _as_bf16_values(
        [rs.randn(1, 2, t, d) for _ in range(4)]))
    o, lse = tfa.flash_attention_ref(q, k, v, causal=causal)
    return q, k, v, do, lse, tfa.flash_attention_delta(o, do)


@pytest.mark.parametrize("t", [SHAPE_T, 200, 129])
@pytest.mark.parametrize("d,causal", WIDE_BWD_CASES)
def test_bf16_backward_order_matches_the_plain_version(d, causal, t):
    """The backward kernels' order at 192 and 256 against the plain
    versions within the bounds that hold the kernels to them on the card
    (chip_smoke.py's BF16_BWD_*), at a whole number of tiles and at ragged
    T."""
    from chip_smoke import (BF16_BWD_ATOL_FLOOR, BF16_BWD_ATOL_SHARE,
                            BF16_BWD_RTOL)
    q, k, v, do, lse, delta = _bwd_inputs(d, t, causal, seed=5)
    got = _tiled_backward(q, k, v, do, lse, delta, causal)
    want = (tfa.flash_attention_dq_ref(q, k, v, do, lse, delta, causal),
            *tfa.flash_attention_dkv_ref(q, k, v, do, lse, delta, causal))
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == torch.bfloat16
        g, w = g.float(), w.float()
        atol = BF16_BWD_ATOL_SHARE * float(w.abs().max()) + BF16_BWD_ATOL_FLOOR
        excess = float(((g - w).abs() - BF16_BWD_RTOL * w.abs()).max())
        assert excess <= atol, (name, excess, atol)


@pytest.mark.parametrize("d,causal", WIDE_BWD_CASES)
def test_bf16_backward_order_matches_pallas_interpret(reference, d, causal):
    """The backward kernels' order at 192 and 256 against jax.vjp through
    the Pallas kernels, from the reference's own O, within the bound that
    holds the plain version to them."""
    q, k, v, do = (_bf16(x) for x in _inputs(d))
    tag = f"{d}{int(causal)}"
    _, lse = tfa.flash_attention_ref(q, k, v, causal=causal)
    delta = tfa.flash_attention_delta(_bf16(reference[f"o{tag}"]), do)
    got = _tiled_backward(q, k, v, do, lse, delta, causal)
    for name, g in zip(("dq", "dk", "dv"), got):
        err = _rel_l2(g.float().numpy(), reference[f"{name}{tag}"])
        assert err <= GRAD_RL2, (name, err)


@pytest.mark.parametrize("seed", [0, 1])
def test_bf16_parts_rebuild_each_value(seed):
    """Three bf16 parts rebuild each float32 value to within 2^-24 of its
    magnitude, across signs and magnitudes from 1e-20 to 1e20."""
    rs = np.random.RandomState(seed)
    x = (rs.randn(4096) * 10.0 ** rs.uniform(-20, 20, 4096)).astype(np.float32)
    parts = _bf16_parts(torch.from_numpy(x))
    assert all(p.to(torch.bfloat16).float().equal(p) for p in parts)
    rebuilt = (parts[0].double() + parts[1].double() + parts[2].double()).numpy()
    assert np.all(np.abs(rebuilt - x.astype(np.float64))
                  <= 2.0 ** -24 * np.abs(x.astype(np.float64)))


# ---- float32: bit-identical to the formulas before the bf16 repair

def _old_fwd(q, k, v, causal, scale):
    b, h, t, d = q.shape
    s = torch.matmul(q * scale, k.transpose(-1, -2)).float()
    if causal:
        keep = torch.ones(t, t, dtype=torch.bool).tril_()
        s = torch.where(keep, s, s.new_tensor(-1e30))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l_safe = torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)
    o = torch.matmul(p.to(v.dtype), v).float() / l_safe
    return o.to(q.dtype), (m + torch.log(l_safe)).reshape(b * h, t, 1)


def _old_bwd(q, k, v, do, lse, delta, causal, scale):
    b, h, t, d = q.shape
    qs = q * scale
    s = torch.matmul(qs, k.transpose(-1, -2)).float()
    if causal:
        keep = torch.ones(t, t, dtype=torch.bool).tril_()
        s = torch.where(keep, s, s.new_tensor(-1e30))
    p = torch.exp(s - lse.reshape(b, h, t, 1))
    dp = torch.matmul(do.float(), v.float().transpose(-1, -2))
    ds = p * (dp - delta.reshape(b, h, t, 1))
    dq = (torch.matmul(ds, k.float()) * scale).to(q.dtype)
    dk = torch.matmul(ds.transpose(-1, -2), qs.float()).to(k.dtype)
    dv = torch.matmul(p.transpose(-1, -2), do.float()).to(v.dtype)
    return dq, dk, dv


@pytest.mark.parametrize("d,causal", [(64, False), (64, True), (128, False),
                                      (128, True), (32, True)])
def test_f32_plain_versions_bit_identical_to_before(d, causal):
    rs = np.random.RandomState(11)
    q, k, v, do = (torch.from_numpy(rs.randn(2, 3, 96, d).astype(np.float32))
                   for _ in range(4))
    scale = d ** -0.5
    o, lse = tfa.flash_attention_ref(q, k, v, causal=causal)
    o_old, lse_old = _old_fwd(q, k, v, causal, scale)
    assert torch.equal(o, o_old) and torch.equal(lse, lse_old)
    delta = tfa.flash_attention_delta(o, do)
    new = (tfa.flash_attention_dq_ref(q, k, v, do, lse, delta, causal),
           *tfa.flash_attention_dkv_ref(q, k, v, do, lse, delta, causal))
    for a, b in zip(new, _old_bwd(q, k, v, do, lse, delta, causal, scale)):
        assert torch.equal(a, b)


# ---- the op's routing

@pytest.mark.parametrize("mode", ["auto", "torch", "off"])
@pytest.mark.parametrize("device", ["cpu", "cuda"])
@pytest.mark.parametrize("head_dim", [32, 64, 128, 192, 256, 288, 320,
                                      2048, 2112])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_takes_kernels(dtype, head_dim, device, mode):
    """float32 and bf16 take the kernels at head_dim 64, 128, 192 and 256,
    float32 also at every multiple of 64 from 320 to 2048; float16, and
    every other width, the plain versions."""
    shape = (2, 4, 256, head_dim)
    widths = {torch.float32: (64, 128, 192, 256, *range(320, 2049, 64)),
              torch.bfloat16: (64, 128, 192, 256)}
    want = (mode == "auto" and device == "cuda" and
            head_dim in widths.get(dtype, ()))
    assert tfa.takes_kernels((dtype,) * 3, (shape,) * 3,
                             torch.device(device), mode) is want


@pytest.mark.parametrize("dtypes,shapes", [
    ((torch.bfloat16, torch.float32, torch.bfloat16), [(1, 2, 8, 64)] * 3),
    ((torch.float32,) * 3, [(1, 2, 8, 64), (1, 2, 9, 64), (1, 2, 8, 64)]),
    ((torch.float32,) * 3, [(2, 8, 64)] * 3),
])
def test_takes_kernels_refuses_mixed_inputs(dtypes, shapes):
    assert not tfa.takes_kernels(dtypes, shapes, "cuda:0", "auto")


def test_kernel_supports_reads_dtype_and_head_dim():
    bf = torch.zeros(1, 2, 8, 64, dtype=torch.bfloat16)
    assert tfa.kernel_supports(bf) and tfa.kernel_supports(bf, bf, bf)
    assert not tfa.kernel_supports(bf, bf.float(), bf)
    assert not tfa.kernel_supports(bf.half())
    assert not tfa.kernel_supports(torch.zeros(1, 2, 8, 32))
    # head_dim 192 and 256 on float32 and bf16, on no float16; 320 on
    # float32 alone
    for d in (192, 256):
        assert tfa.kernel_supports(torch.zeros(1, 2, 8, d))
        assert tfa.kernel_supports(torch.zeros(1, 2, 8, d,
                                               dtype=torch.bfloat16))
        assert not tfa.kernel_supports(torch.zeros(1, 2, 8, d,
                                                   dtype=torch.float16))
    assert tfa.kernel_supports(torch.zeros(1, 2, 8, 320))
    for dtype in (torch.bfloat16, torch.float16):
        assert not tfa.kernel_supports(torch.zeros(1, 2, 8, 320,
                                                   dtype=dtype))


@pytest.mark.parametrize("dtype,d", [(torch.bfloat16, 32),
                                     (torch.float16, 64),
                                     (torch.float32, 32)])
def test_op_takes_plain_version_where_no_kernel_does(monkeypatch, dtype, d):
    """What no kernel takes goes to the plain versions and raises nothing,
    forward and backward."""
    def no_kernel(name):
        raise AssertionError(f"kernel {name} reached")
    monkeypatch.setattr(kernels, "entry", no_kernel)
    rs = np.random.RandomState(5)
    q, k, v = (torch.from_numpy(rs.randn(1, 2, 64, d).astype(np.float32))
               .to(dtype).requires_grad_() for _ in range(3))
    o = tfa.flash_attention(q, k, v, causal=True)
    assert o.dtype == dtype
    torch.testing.assert_close(
        o, tfa.flash_attention_ref(q, k, v, causal=True)[0], rtol=0, atol=0)
    grads = torch.autograd.grad(o.float().sum(), (q, k, v))
    assert all(g.dtype == dtype and torch.isfinite(g.float()).all()
               for g in grads)


def test_bf16_wrappers_refuse_what_no_kernel_takes():
    bf = torch.zeros(1, 2, 8, 64, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_attention_fwd(bf, bf, bf)
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_attention_bwd(bf, bf, bf, bf, torch.zeros(2, 8, 1), bf)
    assert sum(kernels.launch_counts().values()) == 0


# ---- dense attention in bf16 (bench_attention's "dense" column)

@pytest.mark.parametrize("causal", [False, True])
def test_dense_attention_bf16_matches_reference(causal):
    """The port's dense attention keeps the reference's dtypes: logits of
    bf16 q, k in bf16, softmax in float32, probabilities rounded to v's
    dtype, output bf16."""
    q, k, v, _ = _inputs(64, seed=7)
    want = j_sdpa(*(jnp.asarray(x).astype(jnp.bfloat16) for x in (q, k, v)),
                  causal=causal)
    got = t_sdpa(_bf16(q), _bf16(k), _bf16(v), causal=causal)
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    # both round the logits, the probabilities and the output to bf16 from
    # float32 sums taken in other orders: a rounding may land one bf16 ulp
    # apart at each of the three
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=2.0 ** -6, atol=2.0 ** -7)


# ---- the port's bench_attention

def test_bench_attention_on_the_cpu_returns_the_reference_keys():
    out = bench_attention(seq_len=64, batch=1, heads=2, head_dim=64,
                          repeats=1, device="cpu")
    assert out["metric"] == "flash_attention_tokens_per_sec"
    for key in ("value", "flash_ms", "dense_ms", "speedup_vs_dense",
                "flash_tflops", "flash_2x_seq_ms"):
        assert np.isfinite(out[key]) and out[key] > 0, key
    assert out["device"] == "cpu" and out["device_kind"] == "cpu"
    assert out["value"] == pytest.approx(64 / (out["flash_ms"] / 1e3))
    assert attention_flops(4, 8, 4096, 128) == pytest.approx(
        3.5 * 2 * 2 * 4 * 8 * 4096 ** 2 / 2 * 128)
    assert sum(kernels.launch_counts().values()) == 0


@pytest.mark.parametrize("head_dim", [192, 256])
def test_bench_attention_on_the_cpu_at_wide_heads(head_dim):
    """``bench_attention(head_dim=192 | 256)``, the entry point that drives
    the bf16 kernels of those widths on the card, on the CPU at a small
    size: the plain versions, every time finite and positive."""
    out = bench_attention(seq_len=32, batch=1, heads=1, head_dim=head_dim,
                          repeats=1, device="cpu")
    assert out["head_dim"] == head_dim
    for key in ("value", "flash_ms", "dense_ms", "flash_2x_seq_ms"):
        assert np.isfinite(out[key]) and out[key] > 0, key
    assert sum(kernels.launch_counts().values()) == 0


def test_bench_attention_needs_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        bench_attention(seq_len=64, batch=1, heads=2, head_dim=64)


def test_chained_iterations_match_the_reference_loop():
    """Four chained iterations on the CPU in f32 against the reference's
    scan of jax.grad (dq + dk + dv feeding the next q)."""
    from analytics_zoo_torch.benchmarks.attention import chained
    rs = np.random.RandomState(2)
    q, k, v = (rs.randn(1, 2, 64, 64).astype(np.float32) * 0.5
               for _ in range(3))

    def body(c, _):
        g = jax.grad(lambda a, b, e: j_flash(a, b, e, causal=True,
                                             block_q=64, block_k=64,
                                             interpret=True)
                     .astype(jnp.float32).sum(), argnums=(0, 1, 2))(
            c, jnp.asarray(k), jnp.asarray(v))
        return (g[0] + g[1] + g[2]).astype(c.dtype), None

    with jax.default_matmul_precision("float32"):
        last, _ = jax.lax.scan(body, jnp.asarray(q), None, length=4)
    want = float(last.astype(jnp.float32).sum())
    got = float(chained(
        lambda a, b, e: tfa.flash_attention(a, b, e, causal=True),
        *(torch.from_numpy(x) for x in (q, k, v)), iters=4))
    assert got == pytest.approx(want, rel=1e-4, abs=1e-4)
