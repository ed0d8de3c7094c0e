"""The flash backward kernels' product precision, emulated on the CPU.

``csrc/flash_attention_bwd.cu`` takes each of its five products (S, dP,
dQ, dV, dK) on the tensor cores in split TF32: every float32 operand x is
split into hi = tf32(x) and lo = tf32(x - hi), rounded as
``cvt.rna.tf32.f32`` rounds (nearest, ties away from zero, 10 mantissa
bits), and a product a.b is taken as lo_a.hi_b + hi_a.lo_b + hi_a.hi_b
with float32 accumulation.  The kernels cannot run here, so these tests
emulate that arithmetic in plain PyTorch and hold it against float64
products and against ``jax.vjp`` through the Pallas kernels in interpret
mode, within the tolerance the card tests hold the kernels to.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from analytics_zoo_tpu.ops.pallas_attention import flash_attention as j_flash

from analytics_zoo_torch.ops import flash_attention as tfa

# the card's tolerance for the backward kernels against the plain versions
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
