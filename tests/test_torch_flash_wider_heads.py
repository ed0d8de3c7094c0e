"""The float32 flash kernels past head_dim 256 (320 to 2048), held on the CPU.

``csrc/flash_attention_wide.cu`` (the forward) and
``csrc/flash_attention_wide_bwd.cu`` (dQ and dK/dV) take float32 q, k, v
at every head_dim from 320 to 2048 in steps of 64 (the reference routes
any multiple of 64 to its Pallas kernels while ``t * head_dim <= 4096 *
128``).  A block owns up to 256 of the output's columns, and the column
blocks of a row tile form one cluster: in the forward and the backward
alike each takes the partial scores over its own columns, and every
block adds the cluster's partials in rank order.  The kernels cannot run
here, so:

- the plain versions (``flash_attention_ref`` and the backward's) against
  the Pallas kernels in interpret mode (``_flash_fwd_impl``; ``jax.vjp``
  through ``flash_attention``), at T = 256, causal and not;
- the wide kernels' arithmetic emulated in PyTorch: every product in
  split TF32 (``test_torch_flash_split_tf32.py``) summed in 8-wide steps
  in the kernels' order (each column block's own columns for the partial
  scores, keys for P V and dS K, query rows for P^T dO and dS^T q), the
  partials added in rank order, the forward's online softmax over 32-key
  tiles, and the output's columns split between column blocks as the
  kernels split them; held to the same within the tolerances the card
  holds the kernels to;
- the routing on a CUDA device string;
- a transformer ``TextClassifier`` whose heads are 384 and 768 wide
  (``token_length=384, n_head=1`` and ``token_length=768, n_head=1``)
  against the JAX package from the same weights: ``predict``, one Adam
  step's params and three steps' losses.  Here both packages take dense
  attention (a CPU tensor; ``pallas_supported()`` is False); on the card
  the port's layer routes these widths to the wide kernels
  (``kernel_supports``), as the reference routes them to Pallas.
"""

import contextlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from analytics_zoo_tpu.models.textclassification.text_classifier import (
    TextClassifier as JTextClassifier,
)
from analytics_zoo_tpu.ops.pallas_attention import (
    _flash_fwd_impl, _resolve_blocks, flash_attention as j_flash,
)
from analytics_zoo_tpu.parallel.trainer import DistributedTrainer as JTrainer
from analytics_zoo_tpu.pipeline.api.keras import objectives as jobj
from analytics_zoo_tpu.pipeline.api.keras import optimizers as jopt
from analytics_zoo_tpu.pipeline.api.keras.engine import Layer as JLayer
from analytics_zoo_tpu.pipeline.inference.inference_model import (
    InferenceModel as JInferenceModel,
)

from analytics_zoo_torch.common import config as tconfig
from analytics_zoo_torch.common import zoo_context as tctx
from analytics_zoo_torch.interop import load_jax_variables
from analytics_zoo_torch.models.textclassification import TextClassifier
from analytics_zoo_torch.ops import dtypes as tdtypes
from analytics_zoo_torch.ops import flash_attention as tfa
from analytics_zoo_torch.ops import kernels
from analytics_zoo_torch.parallel.trainer import (
    DistributedTrainer, step_generator,
)
from analytics_zoo_torch.pipeline.api.keras import objectives as tobj
from analytics_zoo_torch.pipeline.api.keras import optimizers as topt
from analytics_zoo_torch.pipeline.api.keras.engine import Layer as TLayer
from analytics_zoo_torch.pipeline.api.keras.layers import (
    MultiHeadSelfAttention,
)
from analytics_zoo_torch.pipeline.inference import InferenceModel

from test_torch_flash_split_tf32 import BWD_TOL, FWD_LSE_TOL, FWD_TOL, tf32

# the smallest width, one that is not a power of two, the models' widths
# and the largest
WIDER = (320, 384, 768, 2048)
# the emulations: the uneven split of 320 (3 + 2 chunks), 384, a cluster
# of 5 (1280: 4 + 4 + 4 + 4 + 4 chunks) and the largest
EMULATED = (320, 384, 1280, 2048)
T = 256
# the plain versions against the Pallas kernels: one float32 formula in
# two orders of summation
PLAIN_ATOL = 1e-5
# the kernels' tiles: 32 keys a tile, 64 query rows, 64-column chunks of
# d, at most 4 chunks of the output a block
BN, BM, CH, MAX_NC = 32, 64, 64, 4
LOSS = "sparse_categorical_crossentropy_with_logits"
PREDICT_ATOL = 1e-5
STEP_PARAM_ATOL = 1e-6
# Adam at epsilon 1e-3, as test_torch_flash_wide_heads.py: at 1e-8 a
# gradient element that cancels to ~1e-9 moves by ~lr whatever its last
# ulps
ADAM = dict(lr=1e-3, epsilon=1e-3)
LOSS_ATOL = 1e-4
# (token_length, n_head): heads of 384 and of 768
MODELS = [(384, 1), (768, 1)]


def _inputs(d, causal, n, salt):
    rs = np.random.RandomState(d + 2 * causal + salt)
    return [rs.randn(1, 2, T, d).astype(np.float32) for _ in range(n)]


def _pallas_forward(q, k, v, causal):
    d = q.shape[-1]
    blocks = _resolve_blocks(T, 256, 256)
    jo, jl = _flash_fwd_impl(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             (causal, d ** -0.5, *blocks, True))
    return np.asarray(jo), np.asarray(jl)


def _pallas_grads(q, k, v, do, causal):
    _, vjp = jax.vjp(
        lambda a, b, c: j_flash(a, b, c, causal=causal, interpret=True),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return [np.asarray(g) for g in vjp(jnp.asarray(do))]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", WIDER)
def test_plain_forward_matches_pallas_forward(d, causal):
    q, k, v = _inputs(d, causal, 3, 0)
    jo, jl = _pallas_forward(q, k, v, causal)
    o, lse = tfa.flash_attention_ref(*(torch.from_numpy(x) for x in
                                       (q, k, v)), causal=causal)
    np.testing.assert_allclose(o.numpy(), jo, atol=PLAIN_ATOL, rtol=0,
                               err_msg="O")
    np.testing.assert_allclose(lse.numpy(), jl, atol=PLAIN_ATOL, rtol=0,
                               err_msg="LSE")


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", WIDER)
def test_plain_backward_matches_pallas_vjp(d, causal):
    q, k, v, do = _inputs(d, causal, 4, 1)
    want = _pallas_grads(q, k, v, do, causal)
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    o, lse = tfa.flash_attention_ref(tq, tk, tv, causal=causal)
    got = tfa.flash_attention_bwd_ref(tq, tk, tv, o, lse, tdo, causal=causal)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g.numpy(), w, atol=PLAIN_ATOL, rtol=0,
                                   err_msg=name)
    # and through the op's autograd, which takes the same plain versions here
    leaves = [x.clone().requires_grad_() for x in (tq, tk, tv)]
    out = tfa.flash_attention(*leaves, causal=causal)
    for g, w in zip(torch.autograd.grad(out, leaves, tdo), got):
        assert torch.equal(g, w)
    assert sum(kernels.launch_counts().values()) == 0


# ------------------------------------- the wide kernels' arithmetic, emulated
def _parts(x):
    hi = tf32(x)
    return hi, tf32(x - hi)


def steps_mm(a, b, fresh_steps=False):
    """a @ b as the kernels take it: split TF32, summed over the inner
    dimension in 8-wide steps in order, each step lo.hi, then hi.lo, then
    hi.hi added to the float32 accumulator; with ``fresh_steps`` (the
    scores over d) each step's three products summed from zero first and
    the step's sum then added."""
    (ah, al), (bh, bl) = _parts(a.float()), _parts(b.float())
    acc = torch.zeros(a.shape[:-1] + b.shape[-1:])
    for k0 in range(0, a.shape[-1], 8):
        ks = slice(k0, k0 + 8)
        step = acc if not fresh_steps else torch.zeros_like(acc)
        step = step + al[..., ks] @ bh[..., ks, :]
        step = step + ah[..., ks] @ bl[..., ks, :]
        step = step + ah[..., ks] @ bh[..., ks, :]
        acc = acc + step if fresh_steps else step
    return acc


def column_blocks(d):
    """The kernels' split of the output's columns: n = d / 64 chunks in
    ceil(n / 4) blocks as even as whole chunks allow."""
    n = d // CH
    nz = -(-n // MAX_NC)
    return [slice(z * n // nz * CH, (z + 1) * n // nz * CH)
            for z in range(nz)]


def wide_forward(q, k, v, causal, fresh_steps=True):
    """(O, LSE) as the wide forward kernel computes them: s as the
    cluster's partials, each rank's over its own columns, added in rank
    order (``cluster_scores``: its 8-wide steps summed from zero, then
    added, the kernel's SCORE_STEPS; ``fresh_steps=False``, one chain a
    partial); then for each column block the online softmax over 32-key
    tiles (keys past T at -inf, causal cells at -1e30; m from -1e30, O
    rescaled by exp(m_old - m_new) each tile), and O's columns of the
    block from P V of its columns, O = acc / max(l, 1e-30).  Every rank of
    the cluster holds the same sum, bit for bit, so one s stands for all
    of them here."""
    b, h, t, d = q.shape
    scale = d ** -0.5
    rows = torch.arange(t)[:, None]
    o = torch.empty_like(q)
    s = cluster_scores(q, k, scale, fresh_steps)
    for cols in column_blocks(d):
        m = torch.full((b, h, t, 1), -1e30)
        l = torch.zeros((b, h, t, 1))
        acc = torch.zeros((b, h, t, cols.stop - cols.start))
        for k0 in range(0, t, BN):
            st = s[..., k0:k0 + BN]
            keys = torch.arange(k0, min(k0 + BN, t))[None, :]
            if causal:
                st = torch.where(keys > rows, st.new_tensor(-1e30), st)
            m_new = torch.maximum(m, st.amax(-1, keepdim=True))
            corr = torch.exp(m - m_new)
            p = torch.exp(st - m_new)
            l = l * corr + p.sum(-1, keepdim=True)
            acc = acc * corr + steps_mm(p, v[..., k0:k0 + BN, cols])
            m = m_new
        l_safe = torch.clamp(l, min=1e-30)
        o[..., cols] = acc / l_safe
    return o, (m + torch.log(l_safe)).reshape(b * h, t, 1)


def cluster_scores(a, b, mul=1.0, fresh_steps=False):
    """(a * mul) b^T as the wide backward takes it: each column block (a
    rank of the cluster) takes the partial over its own columns, its 8-wide
    steps one accumulator chain (``fresh_steps``: each step summed from
    zero, then added, the kernel's PARTIAL_STEPS), and the partials are
    added in rank order."""
    parts = [steps_mm(a[..., cols] * mul, b[..., cols].transpose(-1, -2),
                      fresh_steps)
             for cols in column_blocks(a.shape[-1])]
    total = parts[0]
    for part in parts[1:]:
        total = total + part
    return total


def wide_backward(q, k, v, do, causal, fresh_steps=False):
    """dq, dk, dv as the wide dQ and dK/dV kernels compute them, on the
    emulated forward's O and LSE: s and dP = dO V^T as the cluster's
    partials added in rank order (``cluster_scores``; every rank holds the
    same sums), p = exp(s - lse) (causal cells at -1e30), dS = P (dP -
    delta); each column block's dq = scale * dS K (keys in order), dv =
    P^T dO and dk = dS^T (q * scale) (query rows in order)."""
    b, h, t, d = q.shape
    scale = d ** -0.5
    o, lse = wide_forward(q, k, v, causal)
    delta = tfa.flash_attention_delta(o, do).reshape(b, h, t, 1)
    dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
    s = cluster_scores(q, k, scale, fresh_steps)
    if causal:
        keep = torch.ones(t, t, dtype=torch.bool).tril_()
        s = torch.where(keep, s, s.new_tensor(-1e30))
    p = torch.exp(s - lse.reshape(b, h, t, 1))
    ds = p * (cluster_scores(do, v, fresh_steps=fresh_steps) - delta)
    for cols in column_blocks(d):
        dq[..., cols] = steps_mm(ds, k[..., cols]) * scale
        dv[..., cols] = steps_mm(p.transpose(-1, -2), do[..., cols])
        dk[..., cols] = steps_mm(ds.transpose(-1, -2), q[..., cols] * scale)
    return dq, dk, dv


@contextlib.contextmanager
def _one_thread():
    """The emulation's thousands of small products on one thread: beside
    the other test workers, intra-op threads wait on each other (the
    forward at 2048 took 447 s so in a 6-worker run, 0.3 s alone)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def test_column_blocks_follow_the_kernels_split():
    assert [(c.start, c.stop) for c in column_blocks(320)] == [(0, 128),
                                                              (128, 320)]
    assert [c.stop - c.start for c in column_blocks(384)] == [192, 192]
    assert [c.stop - c.start for c in column_blocks(768)] == [256] * 3
    assert [c.stop - c.start for c in column_blocks(2048)] == [256] * 8
    assert [c.stop - c.start for c in column_blocks(448)] == [192, 256]
    assert [c.stop - c.start for c in column_blocks(1280)] == [256] * 5
    assert [c.stop - c.start for c in column_blocks(1536)] == [256] * 6
    assert [c.stop - c.start for c in column_blocks(1728)] == [192] + \
        [256] * 6
    # every width takes a cluster of ceil(d / 256) column blocks, 2 to 8
    # (8 the portable limit), of whole chunks, at most 4, that cover d in
    # rank order
    sizes = set()
    for d in range(320, 2049, 64):
        blocks = column_blocks(d)
        assert len(blocks) == -(-d // 256)
        assert blocks[0].start == 0 and blocks[-1].stop == d
        assert all(a.stop == b.start for a, b in zip(blocks, blocks[1:]))
        widths = [c.stop - c.start for c in blocks]
        assert all(w % CH == 0 and CH <= w <= MAX_NC * CH for w in widths)
        assert max(widths) - min(widths) <= CH
        sizes.add(len(blocks))
    assert sizes == set(range(2, 9))


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", EMULATED)
def test_wide_split_tf32_forward_keeps_the_card_tolerance(d, causal):
    q, k, v = _inputs(d, causal, 3, 2)
    jo, jl = _pallas_forward(q, k, v, causal)
    with _one_thread():
        o, lse = wide_forward(*(torch.from_numpy(x) for x in (q, k, v)),
                              causal)
    np.testing.assert_allclose(o.numpy(), jo, err_msg="O", **FWD_TOL)
    np.testing.assert_allclose(lse.numpy(), jl, err_msg="LSE", **FWD_LSE_TOL)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", EMULATED)
def test_wide_forward_in_one_chain_keeps_the_card_tolerance(d, causal):
    """The other order the forward's source can be built in (SCORE_STEPS
    false): each partial's 8-wide steps one accumulator chain, as the
    backward takes its partials.  Round to nearest here, where the tensor
    core truncates its running sum: the card decides between the two."""
    q, k, v = _inputs(d, causal, 3, 2)
    jo, jl = _pallas_forward(q, k, v, causal)
    with _one_thread():
        o, lse = wide_forward(*(torch.from_numpy(x) for x in (q, k, v)),
                              causal, fresh_steps=False)
    np.testing.assert_allclose(o.numpy(), jo, err_msg="O", **FWD_TOL)
    np.testing.assert_allclose(lse.numpy(), jl, err_msg="LSE", **FWD_LSE_TOL)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", EMULATED)
def test_wide_split_tf32_backward_keeps_the_card_tolerance(d, causal):
    q, k, v, do = _inputs(d, causal, 4, 3)
    want = _pallas_grads(q, k, v, do, causal)
    with _one_thread():
        got = wide_backward(*(torch.from_numpy(x) for x in (q, k, v, do)),
                            causal)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g.numpy(), w, err_msg=name, **BWD_TOL)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", EMULATED)
def test_wide_backward_in_per_step_sums_keeps_the_card_tolerance(d, causal):
    """The other order the backward's source can be built in (its
    PARTIAL_STEPS): each 8-wide step of a partial summed from zero."""
    q, k, v, do = _inputs(d, causal, 4, 3)
    want = _pallas_grads(q, k, v, do, causal)
    with _one_thread():
        got = wide_backward(*(torch.from_numpy(x) for x in (q, k, v, do)),
                            causal, fresh_steps=True)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g.numpy(), w, err_msg=name, **BWD_TOL)


# ------------------------------------------------------------------ routing
@pytest.mark.parametrize("dtype,d,takes", [
    (torch.float32, 320, True), (torch.float32, 384, True),
    (torch.float32, 768, True), (torch.float32, 2048, True),
    (torch.float32, 288, False), (torch.float32, 2112, False),
    (torch.float32, 352, False), (torch.bfloat16, 320, False),
    (torch.bfloat16, 384, False), (torch.float16, 384, False)])
def test_routes_float32_past_256_to_the_wide_kernels(dtype, d, takes):
    shape = (2, 2, 512, d)
    assert tfa.takes_kernels((dtype,) * 3, (shape,) * 3, "cuda", "auto") \
        is takes
    assert tfa.takes_kernels((dtype,) * 3, (shape,) * 3, "cuda:0",
                             "auto") is takes
    assert not tfa.takes_kernels((dtype,) * 3, (shape,) * 3, "cpu", "auto")
    assert not tfa.takes_kernels((dtype,) * 3, (shape,) * 3, "cuda",
                                 "torch")
    assert tfa.kernel_supports(torch.zeros(1, 1, 4, d, dtype=dtype)) is takes
    if takes:
        assert tfa.kernel_names(dtype, d) == tfa.WIDE_KERNELS


def test_kernel_names_keep_the_narrow_widths():
    for dtype in (torch.float32, torch.bfloat16):
        for d in (64, 128, 192, 256):
            assert tfa.kernel_names(dtype, d) == tfa.KERNELS[dtype]
    assert set(tfa.WIDE_KERNELS) <= set(kernels.SIGNATURES)
    assert [kernels.SIGNATURES[n][0] for n in tfa.WIDE_KERNELS] == [
        "flash_attention_wide", "flash_attention_wide_bwd",
        "flash_attention_wide_bwd"]
    assert "flash_attention_fwd_wide" in kernels.FORWARD_KERNELS
    assert tfa.HEAD_DIMS[torch.float32][4:] == tuple(range(320, 2049, 64))


# ------------------------------------------------ a model at these widths
@pytest.fixture
def _port_f32(f32_policy):
    tctx.reset_zoo_context()
    tconfig.reset_config()
    tctx.init_zoo_context(device="cpu")
    tdtypes.set_policy(param_dtype="float32", compute_dtype="float32")
    kernels.reset_launch_counts()
    yield
    assert sum(kernels.launch_counts().values()) == 0
    tdtypes.restore_policy(None)
    tctx.reset_zoo_context()
    tconfig.reset_config()


def _config(token_length, n_head):
    return dict(class_num=5, token_length=token_length, sequence_length=T,
                encoder="transformer", n_head=n_head, n_block=1,
                max_words_num=100)


def _zero_dropout(model):
    for layer in model.model.layers:
        if hasattr(layer, "p"):
            layer.p = 0.0
        if hasattr(layer, "attn_dropout"):
            layer.attn_dropout = 0.0


def _both_models(token_length, n_head):
    JLayer.reset_name_counters()
    jmodel = JTextClassifier(**_config(token_length, n_head))
    _zero_dropout(jmodel)
    TLayer.reset_name_counters()
    tmodel = TextClassifier(**_config(token_length, n_head))
    _zero_dropout(tmodel)
    load_jax_variables(tmodel, jax.tree_util.tree_map(
        np.asarray, jmodel.get_variables()))
    heads = [l for l in tmodel.model.layers
             if isinstance(l, MultiHeadSelfAttention)]
    assert heads and all(l.head_dim == token_length // n_head for l in heads)
    assert all(tfa.kernel_supports(torch.zeros(1, 1, 8, l.head_dim))
               for l in heads)
    return jmodel, tmodel


@pytest.mark.parametrize("token_length,n_head", MODELS)
def test_text_classifier_predict_matches_reference(_port_f32, token_length,
                                                    n_head):
    jmodel, tmodel = _both_models(token_length, n_head)
    x = np.random.RandomState(0).randint(0, 101, size=(4, T))
    want = JInferenceModel().load_zoo(jmodel).predict(x, batch_size=4)
    got = InferenceModel().load_zoo(tmodel).predict(x, batch_size=4)
    assert got.shape == (4, 5) and np.isfinite(got).all()
    np.testing.assert_allclose(got, np.asarray(want), atol=PREDICT_ATOL,
                               rtol=0)


@pytest.mark.parametrize("token_length,n_head", MODELS)
def test_text_classifier_adam_steps_match_reference(_port_f32, token_length,
                                                     n_head):
    """One Adam step's params within 1e-6 (at ``ADAM``'s epsilon), then
    two more: each of the three steps' losses within 1e-4."""
    jmodel, tmodel = _both_models(token_length, n_head)
    rs = np.random.RandomState(3)
    x, y = rs.randint(0, 101, size=(8, T)), rs.randint(0, 5, size=(8,))
    jtr = JTrainer(jmodel.model, jobj.get(LOSS),
                   optim_method=jopt.Adam(**ADAM))
    ttr = DistributedTrainer(tmodel.model, tobj.get(LOSS),
                             optim_method=topt.Adam(**ADAM))
    jv, tv = jmodel.get_variables(), tmodel.get_variables()
    jp, js = jtr.place_params(jv["params"]), jtr.replicate(jv["state"])
    jo = jtr.init_opt_state(jp)
    tp, ts = ttr.place_params(tv["params"]), ttr.replicate(tv["state"])
    to = ttr.init_opt_state(tp)
    jb, tb = jtr.put_batch((x, y)), ttr.put_batch((x, y))
    for i in range(3):
        jp, jo, js, jloss = jtr.train_step(
            jp, jo, js, jb, jax.random.fold_in(jax.random.PRNGKey(0), i))
        tp, to, ts, tloss = ttr.train_step(tp, to, ts, tb,
                                           step_generator(0, i, "cpu"))
        np.testing.assert_allclose(float(tloss), float(jloss),
                                   atol=LOSS_ATOL, rtol=0)
        if i == 0:
            want = jax.device_get(jp)
            for layer in sorted(want):
                for name in sorted(want[layer]):
                    np.testing.assert_allclose(
                        tp[layer][name].detach().numpy(),
                        np.asarray(want[layer][name]),
                        atol=STEP_PARAM_ATOL, rtol=0,
                        err_msg=f"{layer}/{name}")
