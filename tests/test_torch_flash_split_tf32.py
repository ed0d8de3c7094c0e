"""The flash kernels' product precision, emulated on the CPU.

``csrc/flash_attention_fwd.cu`` takes its two products (S, P.V) and
``csrc/flash_attention_bwd.cu`` its five (S, dP, dQ, dV, dK) on the
tensor cores in split TF32: every float32 operand x is
split into hi = tf32(x) and lo = tf32(x - hi), rounded as
``cvt.rna.tf32.f32`` rounds (nearest, ties away from zero, 10 mantissa
bits), and a product a.b is taken as lo_a.hi_b + hi_a.lo_b + hi_a.hi_b
with float32 accumulation.  The kernels cannot run here, so these tests
emulate that arithmetic in plain PyTorch and hold it against float64
products and against the Pallas kernels in interpret mode (the forward,
and ``jax.vjp`` through it for the backward), within the tolerances the
card tests hold the kernels to.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from analytics_zoo_tpu.ops.pallas_attention import (
    _flash_fwd_impl, _resolve_blocks, flash_attention as j_flash,
)

from analytics_zoo_torch.ops import flash_attention as tfa

# the card's tolerances for the kernels against the plain versions: the
# forward's products do not cancel (O is a convex combination of rows of
# V, LSE the log of a sum of positive terms), the backward's dS = P (dP -
# delta) does
FWD_TOL = dict(atol=1e-5, rtol=1e-5)
FWD_LSE_TOL = dict(atol=1e-5, rtol=0)
BWD_TOL = dict(atol=1e-4, rtol=1e-4)


def tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest TF32 value (10 mantissa bits), ties away from
    zero, as ``cvt.rna.tf32.f32``; finite inputs."""
    bits = x.contiguous().view(torch.int32)
    sign = bits & -0x80000000
    mag = ((bits & 0x7FFFFFFF) + 0x1000) & ~0x1FFF
    return (sign | mag).view(torch.float32)


def split_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b in split TF32: the small terms, then hi.hi, in float32."""
    a, b = a.float(), b.float()
    ah, bh = tf32(a), tf32(b)
    al, bl = tf32(a - ah), tf32(b - bh)
    return (al @ bh + ah @ bl) + ah @ bh


def split_forward(q, k, v, causal):
    """(O, LSE) as the forward kernel computes them, every product in split
    TF32: s = (q*scale) k^T, causal cells at -1e30, then a whole-row
    softmax with the kernel's m and l_safe = max(l, 1e-30).  The kernel's
    online softmax reaches the same m; its l and O differ from these by
    float32 rounding of the per-tile rescaling."""
    b, h, t, d = q.shape
    s = split_mm(q * d ** -0.5, k.transpose(-1, -2))
    if causal:
        keep = torch.ones(t, t, dtype=torch.bool).tril_()
        s = torch.where(keep, s, s.new_tensor(-1e30))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l_safe = torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)
    o = split_mm(p, v) / l_safe
    return o, (m + torch.log(l_safe)).reshape(b * h, t, 1)


def split_backward(q, k, v, do, causal):
    """dq, dk, dv as the kernels compute them: the plain forward's lse,
    delta = rowsum(dO * O), and every product in split TF32."""
    b, h, t, d = q.shape
    scale = d ** -0.5
    o, lse = tfa.flash_attention_ref(q, k, v, causal=causal)
    delta = tfa.flash_attention_delta(o, do).reshape(b, h, t, 1)
    qs = q * scale
    s = split_mm(qs, k.transpose(-1, -2))
    if causal:
        keep = torch.ones(t, t, dtype=torch.bool).tril_()
        s = torch.where(keep, s, s.new_tensor(-1e30))
    p = torch.exp(s - lse.reshape(b, h, t, 1))
    ds = p * (split_mm(do, v.transpose(-1, -2)) - delta)
    dq = split_mm(ds, k) * scale
    dk = split_mm(ds.transpose(-1, -2), qs)
    dv = split_mm(p.transpose(-1, -2), do)
    return dq, dk, dv


def test_tf32_rounds_to_nearest_with_ties_away_from_zero():
    ulp = 2.0 ** -10                     # of a TF32 value in [1, 2)
    x = torch.tensor([1.0, 1 + ulp / 2, -(1 + ulp / 2), 1 + ulp / 4,
                      1 + 3 * ulp / 4, 1 + ulp + ulp / 2, 0.0],
                     dtype=torch.float32)
    want = torch.tensor([1.0, 1 + ulp, -(1 + ulp), 1.0, 1 + ulp,
                         1 + 2 * ulp, 0.0],
                        dtype=torch.float32)
    assert torch.equal(tf32(x), want)
    y = torch.from_numpy(np.random.RandomState(0).randn(4096)
                         .astype(np.float32))
    r = tf32(y)
    assert torch.equal(r.view(torch.int32) & 0x1FFF,
                       torch.zeros(4096, dtype=torch.int32))
    assert float(((r - y).abs() / y.abs()).max()) <= 2.0 ** -11


@pytest.mark.parametrize("m,kdim,n", [(64, 64, 64), (16, 512, 128)])
def test_split_product_keeps_float32_accuracy(m, kdim, n):
    rs = np.random.RandomState(1)
    a = rs.randn(m, kdim).astype(np.float32)
    b = rs.randn(kdim, n).astype(np.float32)
    exact = a.astype(np.float64) @ b.astype(np.float64)
    scale = np.abs(a).astype(np.float64) @ np.abs(b).astype(np.float64)
    got = split_mm(torch.from_numpy(a), torch.from_numpy(b)).double().numpy()
    assert np.max(np.abs(got - exact) / scale) <= 1e-6
    # one TF32 pass is ~1e3 times further off: the split is what keeps
    # float32's accuracy
    one = (tf32(torch.from_numpy(a)) @ tf32(torch.from_numpy(b))).double()
    assert np.max(np.abs(one.numpy() - exact) / scale) > 1e-5


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", [(2, 2, 128, 64), (1, 2, 200, 64),
                                   (2, 2, 128, 128)])
def test_split_tf32_backward_matches_pallas_vjp(shape, causal):
    rs = np.random.RandomState(sum(shape) + causal)
    q, k, v, do = (rs.randn(*shape).astype(np.float32) for _ in range(4))
    _, vjp = jax.vjp(
        lambda a, b, c: j_flash(a, b, c, causal=causal, interpret=True),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = [np.asarray(g) for g in vjp(jnp.asarray(do))]
    got = split_backward(*(torch.from_numpy(x) for x in (q, k, v, do)),
                         causal)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g.numpy(), w, err_msg=name, **BWD_TOL)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", [(2, 2, 128, 64), (1, 2, 200, 64),
                                   (2, 2, 128, 128)])
def test_split_tf32_forward_matches_pallas_forward(shape, causal):
    """O and LSE against the forward ``flash_attention`` runs
    (``_flash_fwd_impl``, the Pallas kernel in interpret mode)."""
    rs = np.random.RandomState(sum(shape) + causal + 7)
    q, k, v = (rs.randn(*shape).astype(np.float32) for _ in range(3))
    t = shape[2]
    blocks = _resolve_blocks(t, 256, 256)
    jo, jl = _flash_fwd_impl(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             (causal, shape[-1] ** -0.5, *blocks, True))
    o, lse = split_forward(*(torch.from_numpy(x) for x in (q, k, v)), causal)
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), err_msg="O",
                               **FWD_TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jl), err_msg="LSE",
                               **FWD_LSE_TOL)
    # the public entry gives the same O
    np.testing.assert_array_equal(
        np.asarray(j_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           causal=causal, interpret=True)), np.asarray(jo))
