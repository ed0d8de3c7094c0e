"""PyTorch port, optimizer half of the kernel suite: the fused update
(``build_fused_update``, ``adam_leaf_update``, ``sgd_leaf_update``), the
unfused optimizers and their schedules, and the optimizer-state carry-over,
against the JAX package on the CPU.

On the CPU the port's leaf updates take their plain versions, which
repeat the reference's lax branch op for op; the JAX side runs its lax
branch and, for the leaf updates, its Pallas kernels in interpret mode.
Float32 throughout; the only differences are single-ulp ones in
``b ** count`` (XLA's and PyTorch's float32 pow), hence atol 1e-6.
The CUDA kernels are held against these plain versions on the card
(tests/test_torch_kernels_cuda.py, bit for bit)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from analytics_zoo_tpu.ops import fused as jfused
from analytics_zoo_tpu.parallel.trainer import (
    ClipSpec as JClip, _apply_clipping as j_apply_clipping,
)
from analytics_zoo_tpu.pipeline.api.keras import optimizers as jopt

from analytics_zoo_torch.common import config as tconfig
from analytics_zoo_torch.common import zoo_context as tctx
from analytics_zoo_torch.interop import load_jax_opt_state
from analytics_zoo_torch.ops import fused as tfused
from analytics_zoo_torch.ops import kernels
from analytics_zoo_torch.parallel.trainer import (
    ClipSpec as TClip, _apply_clipping as t_apply_clipping,
)
from analytics_zoo_torch.pipeline.api.keras import optimizers as topt

ATOL = 1e-6


@pytest.fixture(autouse=True)
def _port_cpu():
    tctx.reset_zoo_context()
    tconfig.reset_config()
    tctx.init_zoo_context(device="cpu")
    kernels.reset_launch_counts()
    yield
    tctx.reset_zoo_context()
    tconfig.reset_config()


def _both(name):
    """(JAX optimizer, port optimizer, JAX clip, port clip) for one of the
    seven cases of tests/test_fused_kernels.py."""
    cases = {
        "sgd_mom": (lambda m: m.SGD(0.1, momentum=0.9), None),
        "sgd_nesterov_wd": (
            lambda m: m.SGD(0.05, momentum=0.8, nesterov=True,
                            weight_decay=1e-4), ("l2norm", 1.0)),
        "sgd_plain": (lambda m: m.SGD(0.1), ("const", -0.01, 0.01)),
        "sgd_sched": (
            lambda m: m.SGD(0.1, momentum=0.9, schedule=m.warmup_then(
                0.1, 3, m.poly(0.1, 0.5, 50))), None),
        "adam": (lambda m: m.Adam(lr=1e-3), None),
        "adam_clip": (lambda m: m.Adam(lr=1e-3), ("l2norm", 0.5)),
        "adam_decay": (lambda m: m.Adam(lr=1e-3, decay=0.01), None),
    }
    make, clip = cases[name]
    jclip = JClip(*clip) if clip else None
    tclip = TClip(*clip) if clip else None
    return make(jopt), make(topt), jclip, tclip


CASES = ["sgd_mom", "sgd_nesterov_wd", "sgd_plain", "sgd_sched", "adam",
         "adam_clip", "adam_decay"]


def _params(rs, shapes=((16, 128), (128,), (8, 8), (1001,))):
    return {f"w{i}": rs.randn(*s).astype(np.float32)
            for i, s in enumerate(shapes)}


def _state_leaves(state):
    """Port state leaves in jax's flattening order (tuples and named
    tuples in order, dict keys sorted)."""
    if isinstance(state, dict):
        return [l for k in sorted(state) for l in _state_leaves(state[k])]
    if isinstance(state, tuple):
        return [l for c in state for l in _state_leaves(c)]
    return [state]


def _kinds(state):
    """Class names of the state objects, in order."""
    if hasattr(state, "_fields"):
        return [type(state).__name__]
    if isinstance(state, tuple):
        return [k for c in state for k in _kinds(c)]
    return []


def _assert_trees_close(got, want, atol=ATOL):
    got, want = list(got), list(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(np.asarray(g.detach()), np.asarray(w),
                                   atol=atol, rtol=0)


def _run_both(name, fused_path, steps=6):
    joptim, toptim, jclip, tclip = _both(name)
    rs = np.random.RandomState(0)
    params = _params(rs)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    js, ts = joptim.tx.init(jp), toptim.init(tp)
    if fused_path:
        jstep = jfused.build_fused_update(joptim, jclip)
        tstep = tfused.build_fused_update(toptim, tclip)
        assert jstep is not None and tstep is not None
    else:
        def jstep(g, s, p):
            upd, s = joptim.tx.update(j_apply_clipping(g, jclip), s, p)
            return optax.apply_updates(p, upd), s

        def tstep(g, s, p):
            upd, s = toptim.update(t_apply_clipping(g, tclip), s, p)
            for k in p:
                p[k].add_(upd[k])
            return p, s
    for _ in range(steps):
        grads = {k: rs.randn(*v.shape).astype(np.float32)
                 for k, v in params.items()}
        jp, js = jstep({k: jnp.asarray(v) for k, v in grads.items()}, js, jp)
        with torch.no_grad():
            tp, ts = tstep({k: torch.from_numpy(v) for k, v in grads.items()},
                           ts, tp)
    return jp, js, tp, ts


@pytest.mark.parametrize("fused_path", [True, False],
                         ids=["fused", "unfused"])
@pytest.mark.parametrize("name", CASES)
def test_update_matches_reference_over_six_steps(name, fused_path):
    jp, js, tp, ts = _run_both(name, fused_path)
    _assert_trees_close([tp[k] for k in sorted(tp)],
                        [jp[k] for k in sorted(jp)])
    jleaves = jax.tree_util.tree_leaves(js)
    tleaves = _state_leaves(ts)
    assert [tuple(l.shape) for l in tleaves] == \
        [tuple(np.shape(l)) for l in jleaves]
    for t, j in zip(tleaves, jleaves):
        if np.issubdtype(np.asarray(j).dtype, np.integer):
            assert t.dtype == torch.int32 and int(t) == int(j) == 6
        else:
            np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=ATOL,
                                       rtol=0)


@pytest.mark.parametrize("clip", [None, "scale", "const"])
@pytest.mark.parametrize("weight_decay", [0.0, 1e-2])
def test_adam_leaf_matches_pallas_interpret_and_lax(clip, weight_decay):
    rs = np.random.RandomState(1)
    p, g, m = (rs.randn(16, 128).astype(np.float32) for _ in range(3))
    m *= 0.1
    v = np.abs(rs.randn(16, 128)).astype(np.float32) * 0.01
    kw = dict(b1=0.9, b2=0.999, eps=1e-8, weight_decay=weight_decay,
              clip_const=(-0.5, 0.5) if clip == "const" else None)
    jkw = dict(kw, step_size=-1e-3, bias_corr1=0.1, bias_corr2=1e-3,
               clip_scale=jnp.float32(0.5) if clip == "scale" else None)
    args = [jnp.asarray(a) for a in (p, g, m, v)]
    for interpret in (True, False):
        want = jfused.adam_leaf_update(*args, **jkw, interpret=interpret)
        got = [torch.from_numpy(a.copy()) for a in (p, g, m, v)]
        scal = tfused.step_scalars(0.5, -1e-3, 0.1, 1e-3)
        out = tfused.adam_leaf_update(*got, scal, **kw,
                                      use_clip_scale=clip == "scale")
        assert out[0] is got[0] and out[1] is got[2]   # in place
        _assert_trees_close([got[0], got[2], got[3]], want, atol=2e-6)


@pytest.mark.parametrize("momentum,nesterov", [(0.9, True), (0.9, False),
                                               (0.0, False)])
def test_sgd_leaf_matches_pallas_interpret_and_lax(momentum, nesterov):
    rs = np.random.RandomState(2)
    p, g, t = (rs.randn(16, 128).astype(np.float32) for _ in range(3))
    kw = dict(momentum=momentum, nesterov=nesterov, weight_decay=1e-4,
              clip_const=(-0.5, 0.5))
    for interpret in (True, False):
        want = jfused.sgd_leaf_update(
            jnp.asarray(p), jnp.asarray(g),
            jnp.asarray(t) if momentum else None, step_size=-0.1,
            **kw, interpret=interpret)
        got = [torch.from_numpy(a.copy()) for a in (p, g, t)]
        trace = got[2] if momentum else None
        tfused.sgd_leaf_update(got[0], got[1], trace,
                               tfused.step_scalars(None, -0.1), **kw)
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                                   atol=2e-6, rtol=0)
        if momentum:
            np.testing.assert_allclose(trace.numpy(), np.asarray(want[1]),
                                       atol=2e-6, rtol=0)


def test_unsupported_combinations_decline():
    assert tfused.build_fused_update(None, None) is None
    # dampening has no optax counterpart: refused, and the unfused update
    # raises rather than drop it
    damp = topt.SGD(0.1, momentum=0.9, dampening=0.5)
    assert tfused.build_fused_update(damp, None) is None
    with pytest.raises(NotImplementedError, match="dampening"):
        damp.update({"w": torch.zeros(2)}, damp.init({"w": torch.zeros(2)}),
                    {"w": torch.zeros(2)})
    assert tfused.build_fused_update(topt.Adam(1e-3),
                                     TClip("other", 1.0)) is None
    # the reference's fused update takes SGD and Adam only: the other
    # optimizers run their own chains
    for name in ("rmsprop", "adagrad", "adadelta", "adamax", "adamw"):
        assert tfused.build_fused_update(topt.get(name), None) is None


def test_off_switch():
    tconfig.get_config().set("ops.fused", "off")
    assert tfused.build_fused_update(topt.Adam(1e-3), None) is None
    assert not tfused.fused_enabled()


def test_schedules_match_optax():
    steps = np.arange(0, 70, dtype=np.int32)
    pairs = [
        (jopt.poly(0.1, 0.5, 50), topt.poly(0.1, 0.5, 50)),
        (jopt.warmup_then(0.1, 3, jopt.poly(0.1, 0.5, 50)),
         topt.warmup_then(0.1, 3, topt.poly(0.1, 0.5, 50))),
        (jopt.fixed(0.3), topt.fixed(0.3)),
    ]
    for js, ts in pairs:
        want = np.array([np.float32(js(jnp.int32(s))) for s in steps])
        got = np.array([float(ts(torch.tensor(s, dtype=torch.int32)))
                        for s in steps], np.float32)
        np.testing.assert_allclose(got, want, atol=1e-7, rtol=0)


@pytest.mark.parametrize("name", CASES)
def test_optimizer_state_carries_over_and_resumes(name):
    """load_jax_opt_state: a JAX state after 6 steps maps onto the port's
    layout leaf for leaf, and both resume identically from it."""
    jp, js, _, _ = _run_both(name, fused_path=True)
    joptim, toptim, jclip, tclip = _both(name)
    state_np = jax.tree_util.tree_map(np.asarray, js)
    ts = load_jax_opt_state(toptim, state_np)
    assert _kinds(ts) == _kinds(js)
    back = _state_leaves(ts)
    for t, j in zip(back, jax.tree_util.tree_leaves(state_np)):
        assert t.dtype == torch.from_numpy(np.array(j)).dtype
        np.testing.assert_array_equal(t.numpy(), j)
    # resume one more fused step on both sides from the carried state
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    grads = {k: np.full(v.shape, 0.01, np.float32) for k, v in jp.items()}
    jp2, _ = jfused.build_fused_update(joptim, jclip)(
        {k: jnp.asarray(v) for k, v in grads.items()}, js, jp)
    with torch.no_grad():
        tfused.build_fused_update(toptim, tclip)(
            {k: torch.from_numpy(v) for k, v in grads.items()}, ts, tp)
    _assert_trees_close([tp[k] for k in sorted(tp)],
                        [jp2[k] for k in sorted(jp2)])


def test_carry_over_rejects_another_optimizer():
    joptim = jopt.Adam(1e-3)
    state_np = jax.tree_util.tree_map(
        np.asarray, joptim.tx.init({"w": jnp.zeros(4)}))
    with pytest.raises(ValueError, match="layout"):
        load_jax_opt_state(topt.SGD(0.1, momentum=0.9), state_np)
    with pytest.raises(ValueError, match="layout"):
        load_jax_opt_state(topt.Adam(1e-3, decay=0.1), state_np)
