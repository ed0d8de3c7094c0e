"""PyTorch port, the mesh and its specs in one process, against the JAX
package: the six axes and the mesh's geometry, the pieces a spec cuts,
FSDP's and the layers' specs against the reference's ``NamedSharding``s
on the same mesh shape, the host-batch rules, the collective byte
estimates and their counters, the re-formation math, the launcher's
rendezvous switch, and the parallel options of the layers on a one-rank
mesh (where every one of them is the plain layer)."""

import subprocess
import sys

import numpy as np
import pytest
import torch

import jax

from analytics_zoo_tpu.common.zoo_context import init_zoo_context as jinit
from analytics_zoo_tpu.observability import collectives as jcoll
from analytics_zoo_tpu.parallel import mesh as jmesh
from analytics_zoo_tpu.parallel.sharding import (
    collect_param_shardings as jcollect)
from analytics_zoo_tpu.pipeline.api.keras import Sequential as JSequential
from analytics_zoo_tpu.pipeline.api.keras.engine import Layer as JLayer
from analytics_zoo_tpu.pipeline.api.keras import layers as jlayers
from analytics_zoo_tpu.pipeline.api.keras.layers import attention as jatt
from analytics_zoo_tpu.resilience import recovery as jrecovery

from analytics_zoo_torch.common import config as tconfig
from analytics_zoo_torch.common import zoo_context as tctx
from analytics_zoo_torch.observability import get_registry, reset_registry
from analytics_zoo_torch.observability import collectives as tcoll
from analytics_zoo_torch.ops import dtypes as tdtypes
from analytics_zoo_torch.parallel import mesh as tmesh
from analytics_zoo_torch.parallel.sharding import collect_param_shardings
from analytics_zoo_torch.pipeline.api.keras import Sequential
from analytics_zoo_torch.pipeline.api.keras import layers as tlayers
from analytics_zoo_torch.pipeline.api.keras.engine import Layer
from analytics_zoo_torch.pipeline.api.keras.layers import attention as tatt
from analytics_zoo_torch.resilience import recovery as trecovery
from analytics_zoo_torch.resilience.chaos import LostHost


@pytest.fixture(autouse=True)
def _port_cpu(f32_policy):
    tctx.reset_zoo_context()
    tconfig.reset_config()
    tctx.init_zoo_context(device="cpu")
    tdtypes.set_policy(param_dtype="float32", compute_dtype="float32")
    reset_registry()
    yield
    tdtypes.restore_policy(None)
    tctx.reset_zoo_context()


def test_axes_are_the_references():
    assert tmesh.ALL_AXES == jmesh.ALL_AXES
    assert (tmesh.DATA_AXIS, tmesh.FSDP_AXIS, tmesh.MODEL_AXIS,
            tmesh.SEQ_AXIS, tmesh.PIPE_AXIS, tmesh.EXPERT_AXIS) == \
        (jmesh.DATA_AXIS, jmesh.FSDP_AXIS, jmesh.MODEL_AXIS,
         jmesh.SEQ_AXIS, jmesh.PIPE_AXIS, jmesh.EXPERT_AXIS)


def test_one_process_mesh_and_the_contexts():
    mesh = tmesh.create_mesh()
    assert mesh.shape == {ax: 1 for ax in tmesh.ALL_AXES}
    assert mesh.world_size == 1 and mesh.dp_group() is None
    assert tmesh.create_mesh({"data": -1}).shape["data"] == 1
    with pytest.raises(ValueError, match="needs 2 devices"):
        tmesh.create_mesh({"data": 2})
    with pytest.raises(ValueError, match="unknown mesh axes"):
        tmesh.create_mesh({"tensor": 1})
    with pytest.raises(ValueError, match="at most one"):
        tmesh.create_mesh({"data": -1, "model": -1})
    ctx = tctx.get_zoo_context()
    assert ctx.process_count == 1 and ctx.process_index == 0
    assert ctx.mesh.shape == mesh.shape and ctx.is_coordinator


@pytest.mark.parametrize("shape,rank", [
    ({"data": 2, "model": 2}, 3), ({"data": 2, "fsdp": 2, "seq": 2}, 5),
    ({"pipe": 2, "expert": 2}, 2)])
def test_coordinates_are_the_row_major_layout(shape, rank):
    n = int(np.prod(list(shape.values())))
    m = tmesh.Mesh(shape, rank=rank, world_size=n)
    jm = jmesh.create_mesh(shape, devices=jax.devices()[:n])
    grid = np.vectorize(lambda d: d.id)(jm.devices)
    want = dict(zip(jmesh.ALL_AXES,
                    (int(i) for i in np.argwhere(grid == rank)[0])))
    assert m.coords == want
    assert m.dp_size == shape.get("data", 1) * shape.get("fsdp", 1)
    assert m.dp_index == want["data"] * shape.get("fsdp", 1) + want["fsdp"]


@pytest.mark.parametrize("dim,blocks", [(0, 1), (1, 1), (1, 3), (0, 2)])
def test_pieces_put_back_together(dim, blocks):
    x = torch.arange(12 * 12 * 2, dtype=torch.float32).reshape(12, 12, 2)
    n = 2
    parts = [tmesh.piece(x, dim, blocks, n, i) for i in range(n)]
    assert all(p.shape[dim] == x.shape[dim] // n for p in parts)
    torch.testing.assert_close(tmesh.unpiece(parts, dim, blocks), x)
    # each block of the dim is split alike
    blk = x.shape[dim] // blocks
    for b in range(blocks):
        for i in range(n):
            torch.testing.assert_close(
                parts[i].narrow(dim, b * blk // n, blk // n),
                x.narrow(dim, b * blk + i * blk // n, blk // n))


def _spec(named):
    """(axis, dim) of a reference NamedSharding, or None."""
    for d, ax in enumerate(named.spec):
        if ax is not None:
            return (ax, d)
    return None


@pytest.mark.parametrize("shape", [(4096,), (64, 64), (63, 128), (100, 7),
                                   (16, 256), (8, 2, 512), (3, 3, 3)])
def test_fsdp_rule_is_the_references(shape):
    jm = jmesh.create_mesh({"fsdp": 2, "data": 4})
    want = _spec(jmesh.fsdp_shardings(jm, {"w": np.zeros(shape)})["w"])
    got = tmesh.fsdp_leaf(tmesh.Mesh({"fsdp": 2}, world_size=2), shape)
    assert (None if got is None else (got.axis, got.dim)) == want


def _models():
    jmods, tmods = [], []
    for pkg, seq, lay, att in ((jlayers, JSequential, JLayer, jatt),
                               (tlayers, Sequential, Layer, tatt)):
        lay.reset_name_counters()
        m = seq()
        m.add(pkg.Embedding(50, 64, parallel_mode="dim",
                            input_shape=(8,)))
        m.add(att.MultiHeadSelfAttention(64, 4))
        m.add(att.PositionwiseFeedForward(64, 128))
        m.add(pkg.Dense(128, parallel_mode="column"))
        m.add(pkg.Dense(64, parallel_mode="row"))
        m.add(pkg.MoE(4, 32))
        m.add(pkg.Dense(64))        # 4096 weights: FSDP's
        m.add(pkg.Dense(8))
        (jmods if pkg is jlayers else tmods).append(m)
    return jmods[0], tmods[0]


def test_layer_specs_are_the_references_on_the_same_mesh():
    """Tensor-parallel, expert and FSDP specs leaf by leaf against the
    reference's on ``{"model": 2, "fsdp": 2, "expert": 2}`` (the port's
    QKV spec adds the three q/k/v blocks; its axis and dim are the
    reference's)."""
    shape = {"model": 2, "fsdp": 2, "expert": 2}
    jm = jmesh.create_mesh(shape)
    jinit().mesh = jm
    tm = tmesh.Mesh(shape, world_size=8)
    jmodel, tmodel = _models()
    jv = jmodel.init(jax.random.PRNGKey(0))
    with tmesh.active(tm):
        tv = tmodel.init(torch.Generator().manual_seed(0))
    jspecs = jcollect(jmodel, jv["params"], jm)
    tspecs = collect_param_shardings(tmodel, tv["params"], tm)
    seen = set()
    for (jn, jl), (tn, tl) in zip(jspecs.items(), tspecs.items()):
        assert jn == tn
        for k in jl:
            t = tl[k]
            got = None if t is None else (t.axis, t.dim)
            assert got == _spec(jl[k]), (tn, k)
            if t is not None:
                seen.add(t.axis)
    assert seen == {"model", "fsdp", "expert"}
    assert tspecs["multiheadselfattention_1"]["qkv_kernel"].blocks == 3


def test_host_batch_rules_in_one_process():
    jm = jmesh.create_mesh({"data": 4, "fsdp": 2})
    tm = tmesh.Mesh({"data": 4, "fsdp": 2}, world_size=8)
    for bs in (8, 16, 64):
        assert tmesh.local_batch_size(tm, bs) == \
            jmesh.local_batch_size(jm, bs)
        assert tmesh.global_batch_rows(tm, bs) == \
            jmesh.global_batch_rows(jm, bs)
    assert tmesh.data_split_across_hosts(tm) == \
        jmesh.data_split_across_hosts(jm) is False
    with pytest.raises(ValueError, match="not divisible"):
        tmesh.local_batch_size(tm, 12)
    assert tmesh.data_sharding(tm) == tmesh.Shard("data", 0)
    assert tmesh.replicated(tm) is None


@pytest.mark.parametrize("shape", [{"data": 8}, {"data": 4, "fsdp": 2},
                                   {"data": 2, "model": 4}, {"model": 8}])
@pytest.mark.parametrize("sync", ["float32", "bfloat16"])
def test_collective_estimates_are_the_references(shape, sync):
    jm = jmesh.create_mesh(shape)
    tm = tmesh.Mesh(shape, world_size=8)
    leaves = {"a": {"kernel": np.zeros((256, 64), np.float32),
                    "bias": np.zeros((64,), np.float32)},
              "b": {"kernel": np.zeros((64, 3), np.float32)}}
    tleaves = {k: {n: torch.as_tensor(a) for n, a in v.items()}
               for k, v in leaves.items()}
    assert tcoll.estimate_train_step_collectives(tleaves, tm, sync) == \
        jcoll.estimate_train_step_collectives(leaves, jm, sync)
    for n in (1, 2, 8):
        assert tcoll.ring_all_reduce_bytes(1000, n) == \
            jcoll.ring_all_reduce_bytes(1000, n)
        assert tcoll.all_gather_bytes(1000, n) == \
            jcoll.all_gather_bytes(1000, n)
        assert tcoll.estimate_pipeline_ppermute_bytes(64, n, 4) == \
            jcoll.estimate_pipeline_ppermute_bytes(64, n, 4)


def test_collective_counters_under_the_reference_names():
    tcoll.record_step_collectives({"psum_grads": 100.0}, ici_gbps=1.0,
                                  steps=3)
    text = get_registry().prometheus_text()
    for name in ('collective_bytes_total{op="psum_grads"} 300',
                 'collective_ops_total{op="psum_grads"} 3',
                 'collective_bytes_per_step{op="psum_grads"} 100',
                 'collective_seconds_total{op="psum_grads"}'):
        assert name in text, name


def test_reformation_math_is_the_references(monkeypatch):
    monkeypatch.delenv("ZOO_TPU_RUN_DIR", raising=False)
    for n in range(0, 9):
        for bs in (0, 1, 6, 24, 32):
            assert trecovery.viable_data_degree(n, bs) == \
                jrecovery.viable_data_degree(n, bs)
    assert trecovery.surviving_devices(LostHost("x", survivors=[2, 0])) \
        == [0, 2]
    assert trecovery.surviving_devices(None) == [0]
    assert trecovery._fresh_coordinator("file:///a/s", 2) == \
        "file:///a/s.reform2"
    # a host:port group re-forms only through a store in the run dir
    with pytest.raises(trecovery.NoViableTopology, match="ZOO_TPU_RUN_DIR"):
        trecovery._fresh_coordinator("localhost:1234", 1)
    with pytest.raises(trecovery.NoViableTopology, match="no viable"):
        trecovery.reform_mesh([], batch_size=8)


def test_a_host_port_group_reforms_through_a_store_in_the_run_dir(
        tmp_path, monkeypatch):
    """No port beside the coordinator's is reserved and its TCP store may
    have died with the old rank 0: the survivors meet in a file store
    under the run dir, which the launcher clears of an earlier run's."""
    from analytics_zoo_torch.parallel.launcher import ZooCluster
    stale = tmp_path / trecovery._reform_store_name("localhost:1234", 1)
    stale.write_text("an earlier run's store")
    ZooCluster(2, coordinator="localhost:1234", run_dir=str(tmp_path))
    assert not stale.exists()
    monkeypatch.setenv("ZOO_TPU_RUN_DIR", str(tmp_path))
    assert trecovery._fresh_coordinator("localhost:1234", 1) == \
        f"file://{stale}"
    assert trecovery._fresh_coordinator("tcp://10.0.0.1:29500", 2) == \
        f"file://{tmp_path / 'reform-10_0_0_1_29500.2'}"


def test_a_one_rank_reformation_keeps_a_trivial_mesh():
    from analytics_zoo_torch.resilience.recovery import reform_mesh
    mesh = reform_mesh([0], batch_size=8)
    assert mesh.world_size == 1
    assert tctx.get_zoo_context().mesh is mesh
    assert get_registry().counter("mesh_reformations_total", "").value == 1


def test_independent_clusters_leave_the_coordinator_out(tmp_path):
    from analytics_zoo_torch.parallel.launcher import ZooCluster
    joined = ZooCluster(2).worker_env(1)
    alone = ZooCluster(2, rendezvous=False).worker_env(1)
    assert joined["ZOO_TPU_COORDINATOR"].startswith("localhost:")
    assert "ZOO_TPU_COORDINATOR" not in alone
    assert alone["ZOO_TPU_NUM_PROCESSES"] == "2"
    assert alone["ZOO_TPU_PROCESS_ID"] == "1"
    out = subprocess.run([sys.executable, "-m",
                          "analytics_zoo_torch.parallel.launch_cli",
                          "--help"], capture_output=True, text=True,
                         timeout=60)
    assert out.returncode == 0 and "file://" in out.stdout
    assert tctx._init_method("host:1") == "tcp://host:1"
    assert tctx._init_method("file:///s") == "file:///s"


def test_parallel_options_on_one_rank_are_the_plain_layers():
    """Dense/Embedding(parallel_mode=) and MultiHeadSelfAttention
    (sequence_parallel=True, tensor_parallel=True) no longer raise; on a
    one-rank mesh each computes what the plain layer does."""
    rs = np.random.RandomState(0)
    x = torch.as_tensor(rs.randn(2, 8, 16).astype(np.float32))
    ids = torch.as_tensor(rs.randint(0, 20, (2, 8)))
    g = torch.Generator().manual_seed(0)
    cases = [
        (tlayers.Dense(12, parallel_mode="column"), tlayers.Dense(12), x),
        (tlayers.Dense(12, parallel_mode="row"), tlayers.Dense(12), x),
        (tlayers.Embedding(20, 16, parallel_mode="dim"),
         tlayers.Embedding(20, 16), ids),
        (tatt.MultiHeadSelfAttention(16, 4, causal=True,
                                     sequence_parallel=True,
                                     tensor_parallel=True),
         tatt.MultiHeadSelfAttention(16, 4, causal=True), x),
    ]
    for par, plain, inp in cases:
        shape = tuple(inp.shape)
        params = par.init(g, shape)["params"]
        plain.init(g, shape)
        torch.testing.assert_close(par.call(params, inp),
                                   plain.call(params, inp),
                                   rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError):
        tlayers.Dense(4, parallel_mode="diagonal")
    with pytest.raises(ValueError):
        tlayers.Embedding(4, 4, parallel_mode="row")
