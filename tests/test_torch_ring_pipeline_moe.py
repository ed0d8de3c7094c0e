"""PyTorch port, the collectives and the layers built on them, on two gloo
ranks (``tests/torch_dist_workers.py::scenario_ops``), against dense
single-device forms and the JAX package on the same meshes (two of the
eight virtual CPU devices):

- every collective of ``parallel/comm.py`` and its autograd rule, held
  to values worked out by hand;
- ring attention on ``{"seq": 2}``, causal or not: output and gradients
  against dense attention and against the reference's ``ring_attention``
  (``jax.vjp``);
- the GPipe schedule on ``{"pipe": 2}`` (4 microbatches): output and the
  stage gradients against the stages run in sequence and against the
  reference's ``pipeline_apply``;
- MoE with its experts split over ``{"expert": 2}`` (top-1 and top-2,
  capacity that drops tokens): output, auxiliary loss and gradients
  against one device and against the reference's MoE.

Tolerance 1e-5 for one forward/backward (the ring's blockwise softmax
and the exchanged sums add in another order than one device; they agree
to ~4e-7 here).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from analytics_zoo_tpu.common.zoo_context import init_zoo_context as jinit
from analytics_zoo_tpu.ops.attention import (
    scaled_dot_product_attention as jsdpa)
from analytics_zoo_tpu.parallel.mesh import create_mesh as jcreate_mesh
from analytics_zoo_tpu.parallel.pipeline import (
    pipeline_apply as jpipeline_apply, stack_stage_params as jstack)
from analytics_zoo_tpu.parallel.ring_attention import (
    ring_attention as jring)
from analytics_zoo_tpu.pipeline.api.keras.engine import Layer as JLayer
from analytics_zoo_tpu.pipeline.api.keras.layers.moe import MoE as JMoE

from analytics_zoo_torch.common import config as tconfig
from analytics_zoo_torch.common import zoo_context as tctx
from analytics_zoo_torch.ops import dtypes as tdtypes
from analytics_zoo_torch.pipeline.api.keras.engine import Layer
from analytics_zoo_torch.pipeline.api.keras.layers.moe import MoE

from tests import torch_dist_workers as W

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    codes, outs = W.run_world("ops", 2, tmp_path_factory.mktemp("ops"),
                              timeout=150)
    assert codes == [0, 0], codes
    return outs


@pytest.fixture
def jax_mesh(f32_policy):
    ctx = jinit()

    def make(shape):
        mesh = jcreate_mesh(shape, devices=jax.devices()[:2])
        ctx.mesh = mesh
        return mesh
    return make


@pytest.fixture
def port_cpu():
    tctx.reset_zoo_context()
    tconfig.reset_config()
    tctx.init_zoo_context(device="cpu")
    tdtypes.set_policy(param_dtype="float32", compute_dtype="float32")
    yield
    tdtypes.restore_policy(None)
    tctx.reset_zoo_context()


# ----------------------------------------------------------- collectives
def test_collectives_move_what_they_say(ranks):
    r0, r1 = ranks
    np.testing.assert_array_equal(
        r0["all_gather"], np.concatenate([np.arange(6.0).reshape(2, 3),
                                          np.arange(6.0).reshape(2, 3) + 10]))
    total = np.arange(8.0).reshape(4, 2) * 3       # rank r sends (r+1) x
    np.testing.assert_array_equal(r0["reduce_scatter"], total[:2])
    np.testing.assert_array_equal(r1["reduce_scatter"], total[2:])
    np.testing.assert_array_equal(r0["all_to_all"], [[0, 1], [10, 11]])
    np.testing.assert_array_equal(r1["all_to_all"], [[2, 3], [12, 13]])
    np.testing.assert_array_equal(r0["ppermute"], [1.0])
    np.testing.assert_array_equal(r1["ppermute"], [0.0])


@pytest.mark.parametrize("op", ["copy", "reduce", "sum", "gather",
                                "permute", "a2a"])
def test_autograd_rules_of_the_collectives(ranks, op):
    """The gradient of sum(w_r * f(x_r)) on each rank r, w_r = 1.. + 3r:
    copy/sum sum both ranks' weights, reduce keeps its own, gather
    keeps its own rows, permute and all-to-all send them back."""
    w = [np.arange(4.0).reshape(2, 2) + 1 + 3 * r for r in range(2)]
    want = {
        "copy": [w[0] + w[1]] * 2,
        "reduce": w,
        "sum": [w[0] + w[1]] * 2,
        "permute": [w[1], w[0]],
        "a2a": [np.stack([w[0][0], w[1][0]]), np.stack([w[0][1], w[1][1]])],
    }
    if op == "gather":
        wg = [np.arange(8.0).reshape(4, 2) + 1 + 3 * r for r in range(2)]
        want["gather"] = [wg[0][:2], wg[1][2:]]
    for r, out in enumerate(ranks):
        np.testing.assert_array_equal(out[f"grad_{op}"], want[op][r])


# ------------------------------------------------------------ ring attention
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_ring_attention_matches_dense_and_the_reference(ranks, jax_mesh,
                                                        causal):
    mesh = jax_mesh({"seq": 2})
    rs = np.random.RandomState(0)
    q, k, v = (rs.randn(2, 3, 16, 8).astype(np.float32) for _ in range(3))
    dout = rs.randn(2, 3, 16, 8).astype(np.float32)

    def ring(q, k, v):
        return jring(q, k, v, mesh, causal=causal)
    out, vjp = jax.vjp(ring, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    grads = vjp(jnp.asarray(dout))
    dense = jsdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                  causal=causal)
    np.testing.assert_allclose(np.asarray(out), np.asarray(dense), **TOL)
    tag = "causal" if causal else "full"
    for r, o in enumerate(ranks):
        blk = slice(r * 8, (r + 1) * 8)
        np.testing.assert_allclose(o[f"ring_{tag}_out"],
                                   o[f"dense_{tag}_out"], **TOL)
        np.testing.assert_allclose(o[f"ring_{tag}_out"],
                                   np.asarray(out)[:, :, blk], **TOL)
        for name, g in zip(("dq", "dk", "dv"), grads):
            np.testing.assert_allclose(o[f"ring_{tag}_{name}"],
                                       o[f"dense_{tag}_{name}"], **TOL)
            np.testing.assert_allclose(o[f"ring_{tag}_{name}"],
                                       np.asarray(g)[:, :, blk], **TOL)


def test_ring_attention_on_one_rank_is_dense_attention(port_cpu):
    from analytics_zoo_torch.ops.attention import (
        scaled_dot_product_attention)
    from analytics_zoo_torch.parallel.mesh import trivial_mesh
    from analytics_zoo_torch.parallel.ring_attention import ring_attention
    rs = np.random.RandomState(1)
    q, k, v = (torch.as_tensor(rs.randn(1, 2, 8, 4).astype(np.float32))
               for _ in range(3))
    torch.testing.assert_close(
        ring_attention(q, k, v, trivial_mesh(), causal=True),
        scaled_dot_product_attention(q, k, v, causal=True), rtol=0, atol=0)


# -------------------------------------------------------------- pipeline
def _sequential(stages, x):
    h = x
    for p in stages:
        h = np.tanh(h @ p["w"] + p["b"])
    return h


def test_pipeline_matches_sequential_and_the_reference(ranks, jax_mesh):
    mesh = jax_mesh({"pipe": 2})
    stages = W.stage_weights()
    x = np.random.RandomState(6).randn(8, 8).astype(np.float32)
    stacked = jstack([{k: jnp.asarray(a) for k, a in s.items()}
                      for s in stages])

    def stage_fn(p, h):
        return jnp.tanh(h @ p["w"] + p["b"])

    def loss(p):
        return jpipeline_apply(stage_fn, p, jnp.asarray(x), mesh,
                               num_microbatches=4).sum()
    out = jpipeline_apply(stage_fn, stacked, jnp.asarray(x), mesh,
                          num_microbatches=4)
    grads = jax.grad(loss)(stacked)
    np.testing.assert_allclose(np.asarray(out), _sequential(stages, x),
                               **TOL)
    for r, o in enumerate(ranks):
        np.testing.assert_allclose(o["pipe_out"], np.asarray(out), **TOL)
        for key in ("w", "b"):
            g = o[f"pipe_grad_{key}"]
            # this rank holds its stage's gradient; the other is zero
            np.testing.assert_allclose(g[r], np.asarray(grads[key])[r],
                                       **TOL)
            assert not g[1 - r].any()
    np.testing.assert_array_equal(ranks[0]["pipe_out"], ranks[1]["pipe_out"])


def test_pipeline_on_one_stage_is_the_stage(port_cpu):
    from analytics_zoo_torch.parallel.mesh import Shard, trivial_mesh
    from analytics_zoo_torch.parallel.pipeline import (
        pipeline_apply, stack_stage_params, stage_param_sharding)
    st = W.stage_weights(p=1)
    stacked = stack_stage_params([{k: torch.as_tensor(a) for k, a in
                                   st[0].items()}])
    assert stage_param_sharding(trivial_mesh(), stacked) == \
        {"w": Shard("pipe", 0), "b": Shard("pipe", 0)}
    x = torch.ones(4, 8)
    out = pipeline_apply(lambda p, h: torch.tanh(h @ p["w"] + p["b"]),
                         stacked, x, trivial_mesh(), num_microbatches=2)
    np.testing.assert_allclose(out.numpy(), _sequential(st, x.numpy()),
                               rtol=1e-6)


# ------------------------------------------------------------------- MoE
@pytest.mark.parametrize("top_k", [1, 2])
def test_moe_experts_split_over_two_ranks(ranks, jax_mesh, port_cpu,
                                          top_k):
    jax_mesh({"expert": 2})
    w = W.moe_weights()
    x = np.random.RandomState(7).randn(4, 6, 8).astype(np.float32)
    JLayer.reset_name_counters()
    jl = JMoE(4, 12, top_k=top_k, capacity_factor=1.0, input_shape=(6, 8))
    jl.init(jax.random.PRNGKey(0))

    def jloss(p, xx):
        y, aux = jl.call_with_aux(p, xx)
        return jnp.sum(y * y) + aux, (y, aux)
    (_, (jy, jaux)), (jgp, jgx) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(
        {k: jnp.asarray(a) for k, a in w.items()}, jnp.asarray(x))
    # one device, the port
    Layer.reset_name_counters()
    layer = MoE(4, 12, top_k=top_k, capacity_factor=1.0, input_shape=(6, 8))
    layer.init(torch.Generator().manual_seed(0))
    tp = {k: torch.as_tensor(a).requires_grad_() for k, a in w.items()}
    tx = torch.as_tensor(x).requires_grad_()
    ty, taux = layer.call_with_aux(tp, tx)
    ((ty * ty).sum() + taux).backward()
    # some tokens overflow their expert: the capacity drops rows
    assert (np.abs(np.asarray(jy)).sum(-1) == 0).any() or top_k == 2
    for rank, r in enumerate(ranks):
        np.testing.assert_allclose(r[f"moe{top_k}_out"], np.asarray(jy),
                                   **TOL)
        np.testing.assert_allclose(r[f"moe{top_k}_out"], ty.detach().numpy(),
                                   **TOL)
        np.testing.assert_allclose(r[f"moe{top_k}_aux"], float(jaux),
                                   rtol=1e-6)
        np.testing.assert_allclose(r[f"moe{top_k}_dx"], np.asarray(jgx),
                                   **TOL)
        for k in w:
            g = r[f"moe{top_k}_grad_{k}"]
            want, jwant = tp[k].grad.numpy(), np.asarray(jgp[k])
            if k != "router":
                # the rank's own two experts; the others' rows untouched
                mine = slice(2 * rank, 2 * rank + 2)
                assert not np.delete(g, mine, axis=0).any()
                g, want, jwant = g[mine], want[mine], jwant[mine]
            np.testing.assert_allclose(g, want, **TOL)
            np.testing.assert_allclose(g, jwant, **TOL)
