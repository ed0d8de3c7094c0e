"""PyTorch port, Seq2seq: the JAX package's model and the port's on the
same weights (``load_jax_variables``), under float32 products: the
teacher-forced logits (both bridges, one and two layers), ``prefill``'s
carries, ``decode_step``'s tokens and carries, and greedy ``infer`` in both
``early_exit`` modes with and without a stop token (tokens and steps
equal).  Then the reference's early-exit cases against the port alone."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from analytics_zoo_tpu.models.seq2seq import Seq2seq as JSeq2seq
from analytics_zoo_tpu.pipeline.api.keras.engine import Layer as JLayer

from analytics_zoo_torch.common import config as tconfig
from analytics_zoo_torch.common import zoo_context as tctx
from analytics_zoo_torch.interop import load_jax_variables
from analytics_zoo_torch.models.seq2seq import Seq2seq
from analytics_zoo_torch.ops import dtypes as tdtypes
from analytics_zoo_torch.ops import kernels
from analytics_zoo_torch.pipeline.api.keras.engine import Layer as TLayer

ATOL = 1e-5
VOCAB = 16


@pytest.fixture(autouse=True)
def _port_cpu(f32_policy):
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


def _both(**cfg):
    cfg = {"vocab_size": VOCAB, "embed_dim": 8, "hidden_sizes": (12,),
           **cfg}
    JLayer.reset_name_counters()
    jm = JSeq2seq(**cfg)
    jm.init(jax.random.PRNGKey(3))
    # weights of unit-ish scale: the initializers' small weights give
    # logits so close that greedy ties would decide the tokens
    rs = np.random.RandomState(7)
    jm.set_variables(jax.tree_util.tree_map(
        lambda a: jnp.asarray(rs.randn(*a.shape).astype(np.float32) * 0.5),
        jm.get_variables()))
    TLayer.reset_name_counters()
    tm = Seq2seq(**cfg)
    load_jax_variables(tm, jax.tree_util.tree_map(np.asarray,
                                                  jm.get_variables()))
    return jm, tm


def _ids(seed, *shape):
    return np.random.RandomState(seed).randint(3, VOCAB, shape).astype(
        np.int32)


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               atol=atol, rtol=0)


def _carries_close(tcarries, jcarries):
    assert len(tcarries) == len(jcarries)
    for (th, tc), (jh, jc) in zip(tcarries, jcarries):
        _close(th, jh)
        _close(tc, jc)


CONFIGS = {
    "pass-1": dict(bridge="pass", hidden_sizes=(12,)),
    "pass-2": dict(bridge="pass", hidden_sizes=(12, 12)),
    "dense-1": dict(bridge="dense", hidden_sizes=(12,)),
    "dense-2": dict(bridge="dense", hidden_sizes=(12, 10)),
}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_apply_prefill_and_decode_step_match_reference(name):
    jm, tm = _both(**CONFIGS[name])
    jp = jm.get_variables()["params"]
    tp = tm.get_variables()["params"]
    assert sorted(jp) == sorted(tp)
    enc, dec = _ids(0, 3, 7), _ids(1, 3, 5)
    want, _ = jm.apply(jp, (jnp.asarray(enc), jnp.asarray(dec)))
    got, _ = tm.apply(tp, (torch.from_numpy(enc), torch.from_numpy(dec)))
    assert tuple(got.shape) == (3, 5, VOCAB)
    _close(got, want)
    jc = jm.prefill(jp, jnp.asarray(enc))
    tc = tm.prefill(tp, torch.from_numpy(enc))
    _carries_close(tc, jc)
    tok = _ids(2, 3)
    jn, jc2 = jm.decode_step(jp, jnp.asarray(tok), jc)
    tn, tc2 = tm.decode_step(tp, torch.from_numpy(tok), tc)
    assert tn.dtype == torch.int32
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    _carries_close(tc2, jc2)
    zeros = tm.initial_carries(2)
    assert len(zeros) == len(CONFIGS[name]["hidden_sizes"])
    assert all(h is c and not h.any() for h, c in zeros)


def _min_margin(tm, enc, start, steps):
    """The smallest top-2 logit margin over every row and step of the
    greedy decode: above the products' rounding, equal tokens mean the
    same decode, not a lucky tie."""
    p = tm.get_variables()["params"]
    margin = np.inf
    with torch.no_grad():
        carries = tm.prefill(p, torch.from_numpy(enc))
        tok = torch.full((enc.shape[0],), start, dtype=torch.int32)
        for _ in range(steps):
            x = tm.embedding.call(p[tm.embedding.name], tok[:, None])
            new = []
            for dec, carry in zip(tm.decoder_rnns, carries):
                x, nc = dec.run(p[dec.name], x, initial_carry=carry)
                new.append(nc)
            carries = tuple(new)
            logits = tm.generator.call(p[tm.generator.name], x[:, 0])
            top2 = torch.topk(logits, 2, dim=-1).values
            margin = min(margin, float((top2[:, 0] - top2[:, 1]).min()))
            tok = torch.argmax(logits, -1).to(torch.int32)
    return margin


@pytest.mark.parametrize("early_exit", [True, False])
@pytest.mark.parametrize("with_stop", [True, False])
def test_infer_matches_reference(early_exit, with_stop):
    jm, tm = _both(hidden_sizes=(12, 12))
    enc = _ids(4, 6, 7)
    start, max_len = 1, 9
    assert _min_margin(tm, enc, start, max_len) > 1e-4
    free = tm.infer(enc, start_sign=start, max_seq_len=max_len)
    np.testing.assert_array_equal(
        free, jm.infer(enc, start_sign=start, max_seq_len=max_len))
    # a stop token the greedy decode reaches in some rows and not at
    # the same step in all
    stop = int(free[0, 2]) if with_stop else None
    kw = dict(start_sign=start, max_seq_len=max_len, stop_sign=stop,
              early_exit=early_exit, return_steps=True)
    got, steps = tm.infer(enc, **kw)
    want, jsteps = jm.infer(enc, **kw)
    assert got.shape == (6, max_len) and got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    assert steps == jsteps
    if with_stop:
        assert (got == stop).any(axis=1).any()
        assert not (got == stop).all()


# ------------------------------ the reference's early-exit cases, port only
def _model():
    TLayer.reset_name_counters()
    m = Seq2seq(vocab_size=10, embed_dim=8, hidden_sizes=(16,))
    m.init(torch.Generator().manual_seed(0))
    return m


def test_early_exit_bit_identical_to_scan_mask():
    m = _model()
    src = np.random.RandomState(0).randint(2, 10, (4, 6))
    naive = m.infer(src, start_sign=1, max_seq_len=7, stop_sign=2,
                    early_exit=False)
    fast, steps = m.infer(src, start_sign=1, max_seq_len=7,
                          stop_sign=2, return_steps=True)
    assert np.array_equal(naive, fast)
    assert 1 <= steps <= 7


def test_all_stopped_batch_exits_early():
    """A batch that finishes at step 1 pays 1 decode iteration, not
    max_seq_len."""
    m = _model()
    # generator-bias surgery: argmax is ALWAYS the stop token
    m.get_variables()["params"][m.generator.name]["bias"][2] = 1e6
    src = np.random.RandomState(1).randint(2, 10, (4, 6))
    out, steps = m.infer(src, start_sign=1, max_seq_len=30,
                         stop_sign=2, return_steps=True)
    assert steps == 1
    assert (out == 2).all()          # masked contract intact
    naive = m.infer(src, start_sign=1, max_seq_len=30,
                    stop_sign=2, early_exit=False)
    assert np.array_equal(out, naive)


def test_no_stop_sign_keeps_whole_scan():
    m = _model()
    src = np.random.RandomState(2).randint(2, 10, (2, 5))
    out, steps = m.infer(src, start_sign=1, max_seq_len=6,
                         return_steps=True)
    assert out.shape == (2, 6) and steps == 6


def test_bridge_must_be_known_and_pass_sizes_agree():
    with pytest.raises(ValueError, match="bridge"):
        Seq2seq(vocab_size=10, bridge="attention")
    with pytest.raises(ValueError, match="hidden_sizes"):
        Seq2seq(vocab_size=10, hidden_sizes=(8, 4))
