"""PyTorch port, CUDA kernels against their plain versions on the card.

Every test here needs a CUDA device and the CUDA toolkit; each skips
without one.  The file imports no JAX, so it also runs where only the
port is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py
"""

import pytest
import torch

from analytics_zoo_torch.ops import activations as acts
from analytics_zoo_torch.ops import dtypes
from analytics_zoo_torch.ops import flash_attention as fa
from analytics_zoo_torch.ops import fused, kernels

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", torch.cuda.current_device())


def _randn(dev, *shape, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn(shape, generator=g, device=dev)


@pytest.mark.parametrize("t,d,causal", [(128, 64, False), (128, 64, True),
                                        (100, 128, False), (100, 128, True),
                                        (1, 64, False), (257, 64, True),
                                        (128, 192, False), (100, 192, True),
                                        (257, 192, False), (128, 256, True),
                                        (100, 256, False), (257, 256, True),
                                        (1, 256, False)])
def test_flash_kernel_matches_plain(dev, t, d, causal):
    # split-TF32 products (~1e-6 relative) that do not cancel: O is a convex
    # combination of rows of V, LSE the log of a sum of positive terms
    q, k, v = (_randn(dev, 2, 3, t, d, seed=s) for s in range(3))
    before = kernels.launch_counts()["flash_attention_fwd"]
    o, lse = fa.flash_attention_fwd(q, k, v, causal=causal)
    o_ref, lse_ref = fa.flash_attention_ref(q, k, v, causal=causal)
    torch.testing.assert_close(o, o_ref, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(lse, lse_ref, atol=1e-5, rtol=0)
    assert kernels.launch_counts()["flash_attention_fwd"] == before + 1


@pytest.mark.parametrize("t,d,causal", [(512, 64, False), (200, 64, True),
                                        (257, 128, True), (257, 192, True),
                                        (200, 256, False)])
def test_flash_kernel_is_deterministic(dev, t, d, causal):
    """Each output row is written by one warp of one block: two launches
    on the same inputs agree bit for bit."""
    q, k, v = (_randn(dev, 2, 3, t, d, seed=s) for s in range(3))
    first = fa.flash_attention_fwd(q, k, v, causal=causal)
    second = fa.flash_attention_fwd(q, k, v, causal=causal)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_flash_kernel_refuses_what_it_does_not_take(dev):
    q = _randn(dev, 1, 2, 64, 32)
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_attention_fwd(q, q, q)
    for d, dtype in ((288, torch.float32), (2112, torch.float32),
                     (320, torch.bfloat16)):
        q = _randn(dev, 1, 2, 64, d).to(dtype)
        with pytest.raises(ValueError, match="head_dim"):
            fa.flash_attention_fwd(q, q, q)
    q = _randn(dev, 1, 2, 64, 192).half()
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        fa.flash_attention_fwd(q, q, q)
    q = _randn(dev, 1, 2, 64, 64).requires_grad_()
    with pytest.raises(RuntimeError, match="forward-only"):
        fa.flash_attention_fwd(q, q, q)


@pytest.mark.parametrize("rows,d", [(64, 256), (33, 3072), (7, 30)])
def test_bias_gelu_kernel_matches_plain(dev, rows, d):
    x, b = _randn(dev, rows, d, seed=1), _randn(dev, d, seed=2)
    torch.testing.assert_close(fused.bias_gelu_kernel(x, b),
                               fused.bias_gelu_ref(x, b), atol=1e-6, rtol=0)


# register path: d = 768 (6 float4s a lane), 256, 1000 (a lane's last
# float4 partly past d), 1100 (9 float4s, held as 12), 4096 (32); looped
# branch: d = 30 (scalars), 5000 (float4s, too wide for registers)
@pytest.mark.parametrize("rows,d,act", [(8, 768, acts.gelu), (64, 256, None),
                                        (5, 30, acts.gelu),
                                        (3, 1000, acts.gelu), (2, 1100, None),
                                        (4, 4096, None), (3, 5000, acts.gelu)])
def test_layernorm_act_kernel_matches_plain(dev, rows, d, act):
    x = _randn(dev, rows, d, seed=3)
    g, b = _randn(dev, d, seed=4) * 0.1 + 1, _randn(dev, d, seed=5) * 0.1
    torch.testing.assert_close(
        fused.layernorm_act_kernel(x, g, b, 1e-5, act),
        fused.layernorm_act_ref(x, g, b, 1e-5, act), atol=1e-5, rtol=0)


# The backward kernels take every product on the tensor cores in split
# TF32 (x = hi + lo, both TF32; lo.hi + hi.lo + hi.hi, float32
# accumulation: ~2^-22 of each product term dropped) and sum in 8-term
# steps, in another order than the plain version's float32 products: ~1e-6
# relative.
BWD_TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("t,d,causal", [(128, 64, False), (128, 64, True),
                                        (100, 128, False), (100, 128, True),
                                        (1, 64, False), (257, 64, True),
                                        (512, 64, False), (512, 64, True),
                                        (200, 64, False), (200, 64, True),
                                        (128, 192, False), (100, 192, True),
                                        (257, 192, True), (128, 256, True),
                                        (100, 256, False), (257, 256, True),
                                        (512, 256, True), (1, 256, False)])
def test_flash_backward_kernels_match_plain(dev, t, d, causal):
    q, k, v, do = (_randn(dev, 2, 3, t, d, seed=s) for s in range(4))
    o, lse = fa.flash_attention_fwd(q, k, v, causal=causal)
    before = kernels.launch_counts()
    got = fa.flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
    want = fa.flash_attention_bwd_ref(q, k, v, o, lse, do, causal=causal)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, **BWD_TOL)
    after = kernels.launch_counts()
    assert after["flash_attention_dq"] == before["flash_attention_dq"] + 1
    assert after["flash_attention_dkv"] == before["flash_attention_dkv"] + 1


@pytest.mark.parametrize("t,d,causal", [(512, 64, False), (200, 64, True),
                                        (257, 128, True), (257, 192, True),
                                        (200, 256, False), (512, 256, True)])
def test_flash_backward_kernels_are_deterministic(dev, t, d, causal):
    """No output element is written by two blocks and nothing is summed
    with atomics: two launches on the same inputs agree bit for bit."""
    q, k, v, do = (_randn(dev, 2, 3, t, d, seed=s) for s in range(4))
    o, lse = fa.flash_attention_fwd(q, k, v, causal=causal)
    delta = fa.flash_attention_delta(o, do)
    first = (fa.flash_attention_dq(q, k, v, do, lse, delta, causal),
             *fa.flash_attention_dkv(q, k, v, do, lse, delta, causal))
    second = (fa.flash_attention_dq(q, k, v, do, lse, delta, causal),
              *fa.flash_attention_dkv(q, k, v, do, lse, delta, causal))
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def _autograd_matches_plain(dev, causal, d):
    q, k, v = (_randn(dev, 2, 2, 192, d, seed=s).requires_grad_()
               for s in range(3))
    do = _randn(dev, 2, 2, 192, d, seed=3)
    o = fa.flash_attention(q, k, v, causal=causal)
    got = torch.autograd.grad(o, (q, k, v), do)
    o_ref = fa.flash_attention_ref(q, k, v, causal=causal)[0]
    want = torch.autograd.grad(o_ref, (q, k, v), do)
    torch.testing.assert_close(o, o_ref, atol=1e-5, rtol=1e-5)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, **BWD_TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_flash_autograd_on_the_card_matches_plain_autograd(dev, causal):
    _autograd_matches_plain(dev, causal, 64)


@pytest.mark.parametrize("d", [192, 256])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_autograd_at_wide_heads_matches_plain_autograd(dev, causal, d):
    before = kernels.launch_counts()
    _autograd_matches_plain(dev, causal, d)
    after = kernels.launch_counts()
    assert all(after[n] == before[n] + 1 for n in fa.KERNELS[torch.float32])


# float32 past head_dim 256 (csrc/flash_attention_wide.cu, the forward,
# and csrc/flash_attention_wide_bwd.cu, dQ and dK/dV): a block owns up to
# 256 of the output's columns, and the column blocks of a row tile form a
# cluster of 2 to 8 that takes the scores once, each block the partial
# scores over its own columns, the partials added in rank order through
# distributed shared memory (the forward one partial a key tile, S; the
# backward two, S and dP): one key, fewer rows than a tile, ragged last
# tiles, a width of 5 chunks split 3 + 2 between column blocks, the
# models' 384 and 768, 2048, the cluster sizes 5, 6 and 7 (1280, 1536,
# 1792), and at T = 1024 and 2048 more clusters of 8 than the card holds at
# once (a second wave); the tolerances of the narrow float32 kernels
WIDE_WAVES = (1024, 2048)


@pytest.mark.parametrize("t,d,causal", [(1, 320, False), (17, 384, True),
                                        (100, 448, False), (129, 768, True),
                                        (256, 1024, False), (512, 384, True),
                                        (200, 2048, True), (256, 2048, False),
                                        (100, 1280, False), (128, 1536, True),
                                        (77, 1792, True), (*WIDE_WAVES, False)])
def test_flash_wide_kernels_match_plain_and_relaunch(dev, t, d, causal):
    if (t, d) == WIDE_WAVES:
        # the forward's 16 row tiles of 64 in each of 2 x 2 slices: 64
        # clusters of 8
        assert 64 > kernels.max_active_clusters("flash_attention_fwd_wide", d)
    q, k, v, do = (_randn(dev, 2, 2, t, d, seed=s) for s in range(4))
    before = kernels.launch_counts()
    runs = []
    for _ in range(2):
        o, lse = fa.flash_attention_fwd(q, k, v, causal=causal)
        delta = fa.flash_attention_delta(o, do)
        runs.append((o, lse, fa.flash_attention_dq(q, k, v, do, lse, delta,
                                                   causal),
                     *fa.flash_attention_dkv(q, k, v, do, lse, delta,
                                             causal)))
    after = kernels.launch_counts()
    assert all(after[n] == before[n] + 2 for n in fa.WIDE_KERNELS)
    assert all(after[n] == before[n] for n in fa.KERNELS[torch.float32])
    o, lse, dq, dk, dv = runs[0]
    o_ref, lse_ref = fa.flash_attention_ref(q, k, v, causal=causal)
    torch.testing.assert_close(o, o_ref, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(lse, lse_ref, atol=1e-5, rtol=0)
    delta = fa.flash_attention_delta(o, do)
    want = (fa.flash_attention_dq_ref(q, k, v, do, lse, delta, causal),
            *fa.flash_attention_dkv_ref(q, k, v, do, lse, delta, causal))
    for got, w in zip((dq, dk, dv), want):
        torch.testing.assert_close(got, w, **BWD_TOL)
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.parametrize("d", [384, 768])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_autograd_past_256_matches_plain_autograd(dev, causal, d):
    before = kernels.launch_counts()
    _autograd_matches_plain(dev, causal, d)
    after = kernels.launch_counts()
    assert all(after[n] == before[n] + 1 for n in fa.WIDE_KERNELS)
    assert all(after[n] == before[n] for n in fa.KERNELS[torch.float32])


# bf16 kernels against their plain versions on the same bf16 inputs.  O:
# the kernel rounds P to bf16 at each 64-key tile's running max, the plain
# version at the row's max; both round O once: one bf16 ulp (2^-7 of a
# value at most) plus 2^-6 of the row's RMS, the scale of what the two
# roundings of P leave.  LSE: float32 from the same exact bf16
# products summed in other orders (9.5e-7 at most measured on the H100).
# dQ, dK, dV: float32 sums in other orders rounded to bf16 once: one ulp,
# 2^-10 of the largest element where dS cancels to near zero, and 1e-5
# where it is zero in exact arithmetic (T = 1: dP and delta are float32
# sums of the same bf16 products in other orders).
BF16_O_RTOL, BF16_O_ROW_RMS = 2.0 ** -7, 2.0 ** -6
BF16_LSE_TOL = dict(rtol=0, atol=1e-5)


def _bf16(dev, *shape, seed=0):
    return _randn(dev, *shape, seed=seed).to(torch.bfloat16)


def _bf16_o_used(got, want):
    """The largest share of its tolerance an element of O uses."""
    got, want = got.float(), want.float()
    bound = (BF16_O_ROW_RMS * want.pow(2).mean(-1, keepdim=True).sqrt()
             + BF16_O_RTOL * want.abs())
    return float(((got - want).abs() / bound).max())


def _close_bf16_o(got, want):
    used = _bf16_o_used(got, want)
    assert used <= 1.0, used


def _close_bf16_grad(got, want):
    atol = 2.0 ** -10 * float(want.float().abs().max()) + 1e-5
    torch.testing.assert_close(got.float(), want.float(), rtol=2.0 ** -7,
                               atol=atol)


@pytest.mark.parametrize("t,d,causal", [(128, 64, False), (128, 64, True),
                                        (200, 64, True), (100, 128, False),
                                        (257, 128, True), (1, 64, False),
                                        (512, 128, True), (200, 192, False),
                                        (129, 192, True), (512, 192, True),
                                        (17, 256, False), (129, 256, True),
                                        (512, 256, False), (1, 256, True)])
def test_flash_bf16_kernels_match_plain(dev, t, d, causal):
    q, k, v, do = (_bf16(dev, 2, 3, t, d, seed=s) for s in range(4))
    before = kernels.launch_counts()
    o, lse = fa.flash_attention_fwd(q, k, v, causal=causal)
    o_ref, lse_ref = fa.flash_attention_ref(q, k, v, causal=causal)
    assert o.dtype == torch.bfloat16 and lse.dtype == torch.float32
    _close_bf16_o(o, o_ref)
    torch.testing.assert_close(lse, lse_ref, **BF16_LSE_TOL)
    got = fa.flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
    want = fa.flash_attention_bwd_ref(q, k, v, o, lse, do, causal=causal)
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        _close_bf16_grad(g, w)
    after = kernels.launch_counts()
    for name in fa.KERNELS[torch.bfloat16]:
        assert after[name] == before[name] + 1
    for name in fa.KERNELS[torch.float32]:
        assert after[name] == before[name]


@pytest.mark.parametrize("t,d,causal", [(512, 64, False), (200, 64, True),
                                        (257, 128, True), (1024, 128, False),
                                        (257, 192, True), (1024, 256, False)])
def test_flash_bf16_forward_rounds_p_as_the_plain_version(dev, t, d, causal):
    """Where key 0 holds every row's largest score, the kernel's running
    max is the row's max from its first tile on: its O is the plain
    version's but on at most 5% of the elements (more with more keys a
    row: 1.6% at 4096), each within O's tolerance."""
    gen = torch.Generator(device=dev).manual_seed(t + d)
    shape = (2, 3, t, d)
    q = 0.1 * torch.randn(shape, generator=gen, device=dev)
    q[..., 0] = 2.0
    k = torch.randn(shape, generator=gen, device=dev)
    k[..., 0] = -17.0 * torch.rand(shape[:-1], generator=gen, device=dev)
    k[..., 0, 0] = 10.0
    v = torch.randn(shape, generator=gen, device=dev)
    q, k, v = (x.to(torch.bfloat16) for x in (q, k, v))
    o = fa.flash_attention_fwd(q, k, v, causal=causal)[0]
    want = fa.flash_attention_ref(q, k, v, causal=causal)[0]
    _close_bf16_o(o, want)
    assert float((o != want).float().mean()) <= 0.05


def _leading_key_bf16(dev, shape, seed):
    """bf16 q, k, v on which key 0 holds every row's largest score by a
    wide margin (chip_smoke.py's leading_key_inputs)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    q = 0.1 * torch.randn(shape, generator=gen, device=dev)
    q[..., 0] = 2.0
    k = torch.randn(shape, generator=gen, device=dev)
    k[..., 0] = -17.0 * torch.rand(shape[:-1], generator=gen, device=dev)
    k[..., 0, 0] = 10.0
    v = torch.randn(shape, generator=gen, device=dev)
    return [x.to(torch.bfloat16) for x in (q, k, v)]


def _o_wrong_orders(q, k, v, causal):
    """O in two wrong orders: S rounded to bf16 before the softmax (a
    product of two bf16 tensors, the plain version's former order), and
    the reference's order with P kept in float32."""
    t, d = q.shape[2], q.shape[3]
    keep = torch.ones(t, t, dtype=torch.bool, device=q.device).tril_()
    outs = []
    for s, round_p in ((torch.matmul(q * d ** -0.5, k.transpose(-1, -2))
                        .float(), True),
                       (torch.matmul(fa._scaled_q(q, d ** -0.5).float(),
                                     k.float().transpose(-1, -2)), False)):
        if causal:
            s = torch.where(keep, s, s.new_tensor(-1e30))
        p = torch.exp(s - s.amax(-1, keepdim=True))
        l_safe = p.sum(-1, keepdim=True).clamp_min(1e-30)
        pv = (torch.matmul(p.to(v.dtype), v).float() if round_p
              else torch.matmul(p, v.float()))
        outs.append((pv / l_safe).to(q.dtype))
    return outs


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("t", [1, 17, 127, 129, 200, 4096])
@pytest.mark.parametrize("d", [64, 128, 192, 256])
def test_flash_bf16_forward_kernel_at_ragged_lengths(dev, d, t, causal):
    """The wgmma forward (128 query rows a block and 128-key tiles at head_dim
    64 and 128; 128 rows and 64-key tiles at 192; 64 and 64 at 256) against
    its plain version where T is one key, below one block, one row either
    side of a block, not a multiple of a tile, and long: O within its
    tolerance, LSE, two launches bit-identical.  Where key 0 leads every
    row, O is the plain version's but on at most 5% of its elements; from
    127 keys on, both wrong orders of rounding fail that check (with 17
    keys, causal, at head_dim 64 an unrounded P moved only 4.9% of the
    elements on the H100; with one key O is V's row in every order)."""
    shape = (2, 3, t, d) if t < 4096 else (1, 2, t, d)
    q, k, v = (_bf16(dev, *shape, seed=s) for s in range(3))
    name = fa.KERNELS[torch.bfloat16][0]
    before = kernels.launch_counts()[name]
    first = fa.flash_attention_fwd(q, k, v, causal=causal)
    second = fa.flash_attention_fwd(q, k, v, causal=causal)
    assert kernels.launch_counts()[name] == before + 2
    o_ref, lse_ref = fa.flash_attention_ref(q, k, v, causal=causal)
    assert first[0].dtype == torch.bfloat16
    _close_bf16_o(first[0], o_ref)
    torch.testing.assert_close(first[1], lse_ref, **BF16_LSE_TOL)
    for a, b in zip(first, second):
        assert torch.equal(a, b)
    q, k, v = _leading_key_bf16(dev, shape, seed=t + d)
    o = fa.flash_attention_fwd(q, k, v, causal=causal)[0]
    want = fa.flash_attention_ref(q, k, v, causal=causal)[0]
    _close_bf16_o(o, want)
    assert float((o != want).float().mean()) <= 0.05
    if t >= 127:
        for wrong in _o_wrong_orders(q, k, v, causal):
            assert not (float((wrong != want).float().mean()) <= 0.05 and
                        _bf16_o_used(wrong, want) <= 1.0)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("t", [17, 200, 512, 4096])
@pytest.mark.parametrize("d", [64, 128, 192, 256])
def test_flash_bf16_backward_kernels_match_plain_and_relaunch(dev, d, t,
                                                             causal):
    """The wgmma dQ and dK/dV kernels against their plain versions on the
    forward kernel's LSE: T below one 64-row tile, a ragged last tile,
    several tiles, and more tiles than the ring has stages; two launches
    bit-identical."""
    shape = (2, 3, t, d) if t < 4096 else (1, 2, t, d)
    q, k, v, do = (_bf16(dev, *shape, seed=s) for s in range(4))
    o, lse = fa.flash_attention_fwd(q, k, v, causal=causal)
    delta = fa.flash_attention_delta(o, do)
    before = kernels.launch_counts()
    runs = [(fa.flash_attention_dq(q, k, v, do, lse, delta, causal),
             *fa.flash_attention_dkv(q, k, v, do, lse, delta, causal))
            for _ in range(2)]
    after = kernels.launch_counts()
    for name in fa.KERNELS[torch.bfloat16][1:]:
        assert after[name] == before[name] + 2
    want = (fa.flash_attention_dq_ref(q, k, v, do, lse, delta, causal),
            *fa.flash_attention_dkv_ref(q, k, v, do, lse, delta, causal))
    for got, again, w in zip(*runs, want):
        assert got.dtype == torch.bfloat16
        _close_bf16_grad(got, w)
        assert torch.equal(got, again)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d,scale", [(256, 0.1), (192, 0.125), (128, 0.1)])
def test_flash_bf16_backward_kernels_at_another_scale(dev, d, scale, causal):
    """dQ and dK/dV at a scale other than head_dim ** -0.5: at 256 one whose
    bf16 rounding is not a power of two (dK/dV then rounds each q tile to
    bf16(q * scale)), at 192 one that is (it then reads q as it lands)."""
    q, k, v, do = (_bf16(dev, 2, 3, 200, d, seed=s) for s in range(4))
    o, lse = fa.flash_attention_fwd(q, k, v, causal=causal, scale=scale)
    delta = fa.flash_attention_delta(o, do)
    got = (fa.flash_attention_dq(q, k, v, do, lse, delta, causal, scale),
           *fa.flash_attention_dkv(q, k, v, do, lse, delta, causal, scale))
    want = (fa.flash_attention_dq_ref(q, k, v, do, lse, delta, causal, scale),
            *fa.flash_attention_dkv_ref(q, k, v, do, lse, delta, causal,
                                        scale))
    for g, w in zip(got, want):
        _close_bf16_grad(g, w)


@pytest.mark.parametrize("d", [64, 128, 192, 256])
def test_flash_bf16_backward_attributes(dev, d):
    """What the compiler gave each bf16 backward instance: no local memory
    (no spill), and the block and shared memory the launch asks for."""
    for name in fa.KERNELS[torch.bfloat16][1:]:
        attrs = kernels.kernel_attributes(name, d)
        assert attrs["local_bytes"] == 0, (name, d, attrs)
        assert attrs["threads"] in (256, 384), (name, d, attrs)
        assert 0 < attrs["shared_bytes"] <= 232448, (name, d, attrs)


@pytest.mark.parametrize("t,d,causal", [(512, 64, False), (200, 64, True),
                                        (257, 128, True), (257, 192, True),
                                        (200, 256, False), (512, 256, True)])
def test_flash_bf16_kernels_are_deterministic(dev, t, d, causal):
    q, k, v, do = (_bf16(dev, 2, 3, t, d, seed=s) for s in range(4))
    first = fa.flash_attention_fwd(q, k, v, causal=causal)
    second = fa.flash_attention_fwd(q, k, v, causal=causal)
    for a, b in zip(first, second):
        assert torch.equal(a, b)
    o, lse = first
    delta = fa.flash_attention_delta(o, do)
    runs = [(fa.flash_attention_dq(q, k, v, do, lse, delta, causal),
             *fa.flash_attention_dkv(q, k, v, do, lse, delta, causal))
            for _ in range(2)]
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype,d,fired", [
    (torch.bfloat16, 64, "bf16"), (torch.bfloat16, 128, "bf16"),
    (torch.float32, 128, "f32"), (torch.bfloat16, 32, None),
    (torch.float32, 32, None), (torch.float16, 64, None),
    (torch.float32, 192, "f32"), (torch.float32, 256, "f32"),
    (torch.bfloat16, 192, "bf16"), (torch.bfloat16, 256, "bf16"),
    (torch.float16, 256, None), (torch.float32, 320, "f32 wide"),
    (torch.float32, 2048, "f32 wide"), (torch.float32, 288, None),
    (torch.bfloat16, 320, None), (torch.float16, 192, None)])
def test_flash_op_routes_by_dtype_and_head_dim_on_the_card(dev, dtype, d,
                                                            fired):
    """Through the op and autograd: bf16 launches only the bf16 kernels,
    float32 only the float32 ones (past 256 only the wide ones), and what
    no kernel takes launches none and returns the plain result."""
    leaves = [_randn(dev, 1, 2, 192, d, seed=s).to(dtype).requires_grad_()
              for s in range(3)]
    before = kernels.launch_counts()
    o = fa.flash_attention(*leaves, causal=True)
    grads = torch.autograd.grad(o.float().sum(), leaves)
    after = kernels.launch_counts()
    launched = {n for n in after if after[n] != before[n]}
    want = set(fa.WIDE_KERNELS if fired == "f32 wide" else
               fa.KERNELS[torch.bfloat16 if fired == "bf16" else
                          torch.float32]) if fired else set()
    assert launched == want
    assert o.dtype == dtype and all(g.dtype == dtype for g in grads)
    if not fired:
        with torch.no_grad():
            assert torch.equal(o, fa.flash_attention_ref(*leaves,
                                                         causal=True)[0])


def test_flash_bf16_wrappers_refuse_mixed_dtypes(dev):
    q = _bf16(dev, 1, 2, 64, 64)
    with pytest.raises(ValueError, match="dtype"):
        fa.flash_attention_fwd(q, q.float(), q)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        fa.flash_attention_fwd(q.half(), q.half(), q.half())


def _leaf(dev, n, seed, offset=0):
    """A contiguous float32 leaf of n elements; offset 1 misaligns it."""
    return _randn(dev, n + offset, seed=seed)[offset:]


@pytest.mark.parametrize("n,offset", [(4096, 0), (1001, 0), (777, 1),
                                      (3, 0)])
@pytest.mark.parametrize("clip", [None, "scale", "const"])
def test_fused_adam_kernel_is_bit_identical_to_plain(dev, n, offset, clip):
    p, g, m = (_leaf(dev, n, s, offset) for s in range(3))
    v = _leaf(dev, n, 3, offset).abs() * 0.01
    scal = fused.step_scalars(0.5, -1e-3, 0.1, 1e-3, dev)
    kw = dict(b1=0.9, b2=0.999, eps=1e-8,
              use_clip_scale=clip == "scale",
              clip_const=(-0.5, 0.5) if clip == "const" else None)
    ref = [x.clone() for x in (p, g, m, v)]
    before = kernels.launch_counts()["fused_adam"]
    fused.adam_leaf_update(p, g, m, v, scal, **kw)
    assert kernels.launch_counts()["fused_adam"] == before + 1
    from analytics_zoo_torch.common.config import get_config
    get_config().set("ops.fused", "torch")
    try:
        fused.adam_leaf_update(*ref, scal, **kw)
    finally:
        get_config().set("ops.fused", "auto")
    for a, b in zip((p, m, v), (ref[0], ref[2], ref[3])):
        torch.testing.assert_close(a, b, atol=0, rtol=0)


# NeuralCF at ML-1M width (embeddings 64, hidden 128/64/32, 2 classes):
# its 12 float32 leaves, in the order the trainer updates them
NCF_LEAVES = (6041 * 64, 3707 * 64, 6041 * 64, 3707 * 64, 128 * 128, 128,
              128 * 64, 64, 64 * 32, 32, 96 * 2, 2)


def test_fused_adam_at_ncf_leaves_is_bit_identical_to_plain(dev):
    """The fused update over NeuralCF's 12 leaves (386,624 elements down
    to 2): one multi-tensor launch a step, each leaf bit-identical to the
    plain update's."""
    from analytics_zoo_torch.common.config import get_config
    from analytics_zoo_torch.pipeline.api.keras.optimizers import Adam
    update = fused.build_fused_update(Adam(lr=1e-3))
    params = {f"l{i:02d}": {"w": _randn(dev, n, seed=i)}
              for i, n in enumerate(NCF_LEAVES)}
    grads = {k: {"w": _randn(dev, v["w"].numel(), seed=100 + i)}
             for i, (k, v) in enumerate(params.items())}
    runs = []
    for mode in ("auto", "torch"):
        get_config().set("ops.fused", mode)
        try:
            p = {k: {"w": v["w"].clone()} for k, v in params.items()}
            state = Adam(lr=1e-3).init(p)
            before = kernels.launch_counts()["fused_adam"]
            for _ in range(3):
                p, state = update(grads, state, p)
            launched = kernels.launch_counts()["fused_adam"] - before
        finally:
            get_config().set("ops.fused", "auto")
        runs.append((p, state, launched))
    assert runs[0][2] == 3 and runs[1][2] == 0
    (p_k, s_k, _), (p_t, s_t, _) = runs
    for k in params:
        for a, b in ((p_k[k], p_t[k]), (s_k[0].mu[k], s_t[0].mu[k]),
                     (s_k[0].nu[k], s_t[0].nu[k])):
            torch.testing.assert_close(a["w"], b["w"], atol=0, rtol=0)
    assert int(s_k[0].count) == int(s_t[0].count) == 3


@pytest.mark.parametrize("n,offset", [(4096, 0), (1001, 0), (777, 1)])
@pytest.mark.parametrize("momentum,nesterov,wd", [(0.9, False, 0.0),
                                                  (0.8, True, 1e-4),
                                                  (0.0, False, 0.0)])
def test_fused_sgd_kernel_is_bit_identical_to_plain(dev, n, offset, momentum,
                                                    nesterov, wd):
    p, g, t = (_leaf(dev, n, s, offset) for s in range(3))
    t = t if momentum else None
    scal = fused.step_scalars(0.7, -0.05, device=dev)
    kw = dict(momentum=momentum, nesterov=nesterov, weight_decay=wd,
              use_clip_scale=True, clip_const=(-1.0, 1.0))
    ref = [None if x is None else x.clone() for x in (p, g, t)]
    before = kernels.launch_counts()["fused_sgd"]
    fused.sgd_leaf_update(p, g, t, scal, **kw)
    assert kernels.launch_counts()["fused_sgd"] == before + 1
    from analytics_zoo_torch.common.config import get_config
    get_config().set("ops.fused", "torch")
    try:
        fused.sgd_leaf_update(*ref, scal, **kw)
    finally:
        get_config().set("ops.fused", "auto")
    torch.testing.assert_close(p, ref[0], atol=0, rtol=0)
    if t is not None:
        torch.testing.assert_close(t, ref[2], atol=0, rtol=0)


def test_epilogue_gradients_on_the_card_match_plain(dev):
    x = _randn(dev, 16, 256, seed=6).requires_grad_()
    b = _randn(dev, 256, seed=7).requires_grad_()
    got = torch.autograd.grad(fused.bias_gelu(x, b).sum(), (x, b))
    want = torch.autograd.grad(fused.bias_gelu_ref(x, b).sum(), (x, b))
    for a, w in zip(got, want):
        torch.testing.assert_close(a, w, atol=1e-5, rtol=1e-5)
    g = (_randn(dev, 256, seed=8) * 0.1 + 1).requires_grad_()
    got = torch.autograd.grad(
        fused.layernorm_act(x, g, b, 1e-5, acts.gelu).sum(), (x, g, b))
    want = torch.autograd.grad(
        fused.layernorm_act_ref(x, g, b, 1e-5, acts.gelu).sum(), (x, g, b))
    for a, w in zip(got, want):
        torch.testing.assert_close(a, w, atol=1e-5, rtol=1e-5)


def test_bf16_matmul_gradient_on_the_card(dev):
    x = _randn(dev, 4, 32, 64, seed=9).requires_grad_()
    w = _randn(dev, 64, 48, seed=10).requires_grad_()
    out = dtypes.matmul(x, w)
    assert out.dtype == torch.float32
    gx, gw = torch.autograd.grad(out.square().sum(), (x, w))
    xc, wc = x.detach().cpu(), w.detach().cpu()
    xr, wr = xc.requires_grad_(), wc.requires_grad_()
    rx, rw = torch.autograd.grad(dtypes.matmul(xr, wr).square().sum(),
                                 (xr, wr))
    # the card rounds the float32 cotangent to bf16 for its tensor-core
    # products (2^-8 relative a value); the CPU path multiplies it in
    # float32
    for a, w in ((gx.cpu(), rx), (gw.cpu(), rw)):
        assert float((a - w).norm() / w.norm()) < 1e-2


# a mixed leaf set: the 2-element bias class, ragged sizes, leaves that
# span chunks, and views one float in (not 16-byte aligned)
MIXED_LEAVES = ((1, 0), (2, 0), (3, 0), (1001, 0), (4097, 1), (2, 1),
                (9000, 0), (777, 1))


def _leaf_columns(dev, which, count):
    sizes = ([(n, 0) for n in NCF_LEAVES] if which == "ncf"
             else list(MIXED_LEAVES))
    return [[_leaf(dev, n, 1000 * k + i, off)
             for i, (n, off) in enumerate(sizes)] for k in range(count)]


def _clip_args(dev, clip, gs):
    gnorm = (torch.linalg.vector_norm(torch.cat([g.flatten() for g in gs]))
             if clip == "l2norm" else None)
    return dict(gnorm=gnorm, clip_norm=0.5,
                clip_const=(-0.5, 0.5) if clip == "const" else None)


def _plain(fn):
    from analytics_zoo_torch.common.config import get_config
    get_config().set("ops.fused", "torch")
    try:
        return fn()
    finally:
        get_config().set("ops.fused", "auto")


@pytest.mark.parametrize("which", ["ncf", "mixed"])
@pytest.mark.parametrize("clip", [None, "const", "l2norm"])
@pytest.mark.parametrize("weight_decay", [0.0, 1e-2])
@pytest.mark.parametrize("schedule", [False, True])
def test_multi_adam_is_bit_identical_to_plain(dev, which, clip, weight_decay,
                                              schedule):
    ps, gs, ms, vs = _leaf_columns(dev, which, 4)
    vs = [v.abs_().mul_(0.01) for v in vs]
    count = torch.tensor(4, dtype=torch.int32, device=dev)
    step = torch.tensor(-2e-3, device=dev) if schedule else -2e-3
    kw = dict(b1=0.9, b2=0.999, eps=1e-8, weight_decay=weight_decay,
              **_clip_args(dev, clip, gs))
    ref = [[t.clone() for t in col] for col in (ps, gs, ms, vs)]
    before = kernels.launch_counts()["fused_adam"]
    got = fused.adam_multi_update(ps, gs, ms, vs, count, step, **kw)
    assert kernels.launch_counts()["fused_adam"] == before + 1
    want = _plain(lambda: fused.adam_multi_update(*ref, count, step, **kw))
    assert got.dtype == torch.int32 and int(got) == int(want) == 5
    for a, b in zip(ps + ms + vs, ref[0] + ref[2] + ref[3]):
        torch.testing.assert_close(a, b, atol=0, rtol=0)


@pytest.mark.parametrize("which", ["ncf", "mixed"])
@pytest.mark.parametrize("momentum,nesterov,weight_decay",
                         [(0.9, False, 0.0), (0.8, True, 1e-4),
                          (0.0, False, 0.0)])
@pytest.mark.parametrize("clip", [None, "const", "l2norm"])
@pytest.mark.parametrize("schedule", [False, True])
def test_multi_sgd_is_bit_identical_to_plain(dev, which, momentum, nesterov,
                                             weight_decay, clip, schedule):
    ps, gs, ts = _leaf_columns(dev, which, 3)
    ts = ts if momentum else None
    step = torch.tensor(-0.05, device=dev) if schedule else -0.05
    kw = dict(momentum=momentum, nesterov=nesterov,
              weight_decay=weight_decay, **_clip_args(dev, clip, gs))
    ref = [None if col is None else [t.clone() for t in col]
           for col in (ps, gs, ts)]
    before = kernels.launch_counts()["fused_sgd"]
    fused.sgd_multi_update(ps, gs, ts, step, **kw)
    assert kernels.launch_counts()["fused_sgd"] == before + 1
    _plain(lambda: fused.sgd_multi_update(*ref, step, **kw))
    for a, b in zip(ps + (ts or []), ref[0] + (ref[2] or [])):
        torch.testing.assert_close(a, b, atol=0, rtol=0)


def test_multi_adam_split_table_is_bit_identical_to_plain(dev):
    """A table budget of 5 leaves splits NeuralCF's 12 into 3 launches,
    with nothing lost or doubled."""
    from analytics_zoo_torch.ops import multi_tensor as mt
    ps, gs, ms, vs = _leaf_columns(dev, "ncf", 4)
    vs = [v.abs_().mul_(0.01) for v in vs]
    count = torch.tensor(0, dtype=torch.int32, device=dev)
    kw = dict(b1=0.9, b2=0.999, eps=1e-8)
    ref = [[t.clone() for t in col] for col in (ps, gs, ms, vs)]
    before = kernels.launch_counts()["fused_adam"]
    fused.adam_multi_update(ps, gs, ms, vs, count, -1e-3,
                            cache=mt.TableCache(max_leaves=5), **kw)
    assert kernels.launch_counts()["fused_adam"] == before + 3
    _plain(lambda: fused.adam_multi_update(*ref, count, -1e-3, **kw))
    for a, b in zip(ps + ms + vs, ref[0] + ref[2] + ref[3]):
        torch.testing.assert_close(a, b, atol=0, rtol=0)


def test_multi_adam_scalars_in_the_kernel_match_torch(dev):
    """The kernel's count + 1, bc1, bc2 and clip scale against torch's
    formulas on the card, bit for bit: counts 1 to 10,000 and at
    saturation, norms that clip, that do not, zero and NaN."""
    from analytics_zoo_torch.pipeline.api.keras.optimizers import (
        safe_increment)
    top = 2 ** 31 - 1
    counts = torch.cat([
        torch.arange(0, 10_000, dtype=torch.int32, device=dev),
        torch.tensor([top - 1, top], dtype=torch.int32, device=dev)])
    norms = torch.tensor([0.25, 3.0, 0.0, float("nan")], device=dev)
    norms = norms.repeat(len(counts) // 4 + 1)[:len(counts)].contiguous()
    out = torch.empty(len(counts), 4, device=dev)
    leaf = [torch.zeros(1, device=dev) for _ in range(4)]
    got_counts = []
    for i in range(len(counts)):
        got_counts.append(fused.adam_multi_update(
            *([t] for t in leaf), counts[i], -1e-3, b1=0.9, b2=0.999,
            eps=1e-8, gnorm=norms[i], clip_norm=0.5, scalars_out=out[i]))
    # the plain route's formulas, one count at a time as a step takes them
    plain = [fused.adam_scalars(counts[i], -1e-3, 0.9, 0.999, norms[i], 0.5)
             for i in range(len(counts))]
    assert torch.equal(torch.stack(got_counts), safe_increment(counts))
    assert torch.equal(torch.stack([c for c, _ in plain]),
                       safe_increment(counts))
    want = torch.stack([scal for _, scal in plain])
    torch.testing.assert_close(out, want, atol=0, rtol=0, equal_nan=True)
    assert torch.isnan(out[3::4, 0]).all()


# ------------------------------------------------------- int8 products
def _plain_route(fn):
    """``fn()`` under ``ops.fused=torch``: the int8 products' plain
    route on the card."""
    from analytics_zoo_torch.common.config import get_config
    get_config().set("ops.fused", "torch")
    try:
        return fn()
    finally:
        get_config().set("ops.fused", "auto")


# (M, K, N): rows at and below _int_mm's 16, inner and output dims that
# are not multiples of 8, and the int8 paths' shapes
INT8_MM_SHAPES = [(1, 768, 256), (16, 13, 2), (17, 768, 256),
                  (8192, 128, 64), (33, 96, 2), (4096, 200, 7)]


@pytest.mark.parametrize("m,k,n", INT8_MM_SHAPES)
def test_int8_matmul_card_route_equals_plain(dev, m, k, n):
    """``torch._int_mm`` (zero padded to its shape rules) against the
    plain float64 route on the card: exact integers, bit for bit, and the
    whole quantized product with its epilogue."""
    from analytics_zoo_torch.ops import quant
    g = torch.Generator(device=dev).manual_seed(m + k + n)
    a = torch.randint(-127, 128, (m, k), generator=g, device=dev,
                      dtype=torch.int8)
    b = torch.randint(-127, 128, (k, n), generator=g, device=dev,
                      dtype=torch.int8)
    got = quant.int8_matmul(a, b)
    assert got.dtype == torch.int32 and got.is_cuda
    assert torch.equal(got, _plain_route(lambda: quant.int8_matmul(a, b)))
    assert torch.equal(got.cpu(), quant.int8_matmul(a.cpu(), b.cpu()))
    x = _randn(dev, m, k, seed=1)
    scale = torch.rand(1, n, generator=g, device=dev) * 0.01 + 1e-3
    act = (x.abs().max() / 127).reshape(())
    assert torch.equal(quant.quantized_matmul(x, b, scale, act), _plain_route(
        lambda: quant.quantized_matmul(x, b, scale, act)))


# (input shape, kernel shape, strides, padding, dilation, groups)
INT8_CONV_CASES = [
    ((8, 500, 200), (5, 200, 256), (1,), "VALID", (1,), 1),
    ((2, 37, 12), (3, 6, 10), (2,), "SAME", (2,), 2),
    ((8, 56, 56, 64), (3, 3, 64, 128), (2, 2), "SAME", (1, 1), 1),
    ((1, 9, 8, 3), (3, 3, 3, 5), (1, 1), "SAME", (2, 2), 1),
    ((2, 5, 6, 7, 4), (2, 3, 2, 2, 8), (2, 1, 2), "SAME", (1, 1, 1), 2),
]


@pytest.mark.parametrize("xs,ks,strides,padding,dilation,groups",
                         INT8_CONV_CASES)
def test_int8_conv_card_route_equals_plain(dev, xs, ks, strides, padding,
                                           dilation, groups):
    """The convolution as one ``_int_mm`` product a group over its
    unfolded taps, against the plain float64 ``conv{1,2,3}d`` on the card
    and on the CPU: bit for bit."""
    from analytics_zoo_torch.ops import quant
    g = torch.Generator(device=dev).manual_seed(len(xs))
    xq = torch.randint(-127, 128, xs, generator=g, device=dev,
                       dtype=torch.int8)
    kq = torch.randint(-127, 128, ks, generator=g, device=dev,
                       dtype=torch.int8)
    got = quant.int8_conv(xq, kq, strides, padding, dilation, groups)
    want = _plain_route(lambda: quant.int8_conv(xq, kq, strides, padding,
                                                dilation, groups))
    assert got.dtype == torch.int32 and got.shape == want.shape
    assert torch.equal(got, want)
    assert torch.equal(got.cpu(), quant.int8_conv(
        xq.cpu(), kq.cpu(), strides, padding, dilation, groups))


def test_int8_matmul_card_route_every_row_count(dev):
    """cuBLASLt's int8 product fails at most row counts when its second
    operand is row-major (seen on an H100 at K 64, N 32); the card route
    passes it column-major, so every row count from 1 to 140 and a
    4040-row evaluation batch go through."""
    from analytics_zoo_torch.ops import quant
    g = torch.Generator(device=dev).manual_seed(5)
    for k, n in ((64, 32), (128, 64)):
        b = torch.randint(-127, 128, (k, n), generator=g, device=dev,
                          dtype=torch.int8)
        for m in list(range(1, 141)) + [4040]:
            a = torch.randint(-127, 128, (m, k), generator=g, device=dev,
                              dtype=torch.int8)
            assert torch.equal(quant.int8_matmul(a, b), _plain_route(
                lambda: quant.int8_matmul(a, b))), (m, k, n)
