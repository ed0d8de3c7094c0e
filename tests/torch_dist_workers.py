"""Worker processes for the port's multi-process tests (gloo on the CPU).

``run_world(scenario, world, tmp_path)`` starts ``world`` processes of
``python -m tests.torch_dist_workers <scenario> <out dir>``, each with the
launcher's env contract (``ZOO_TPU_COORDINATOR`` a ``file://`` store
under the test's own directory: no TCP port for parallel test workers to
collide on), a process-group timeout of ``GROUP_TIMEOUT_S`` and a wall
limit of its own: a hung collective fails the test in seconds.  Each
rank writes ``<scenario>_<rank>.npz`` and the parent reads them back.

The workers import the port only (never JAX): the tests hold their
results against the JAX package in the parent process.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GROUP_TIMEOUT_S = 30


# ------------------------------------------------------------------ parent
def run_world(scenario: str, world: int, out_dir, timeout: float = 120,
              extra_env=None, launcher=None):
    """Run ``scenario`` on ``world`` gloo ranks; returns the ranks' npz
    dicts (ordered by rank).  Kills every rank past ``timeout``."""
    out_dir = str(out_dir)
    os.makedirs(out_dir, exist_ok=True)
    store = os.path.join(out_dir, f"store-{scenario}")
    for stale in [store] + [os.path.join(out_dir, f)
                            for f in os.listdir(out_dir)
                            if f.startswith(f"store-{scenario}.reform")]:
        if os.path.exists(stale):
            os.remove(stale)      # a file store is good for one rendezvous
    env = dict(os.environ)
    env.update({
        "PYTHONPATH": REPO + os.pathsep + env.get("PYTHONPATH", ""),
        "OMP_NUM_THREADS": "1",
        "ZOO_TPU_COORDINATOR": f"file://{store}",
        "ZOO_TPU_NUM_PROCESSES": str(world),
    })
    env.pop("ZOO_TPU_RUN_DIR", None)
    env.update(extra_env or {})
    args = [scenario, out_dir]
    if launcher is not None:
        procs = [subprocess.Popen(
            [sys.executable, "-m", "analytics_zoo_torch.parallel.launch_cli",
             "-n", str(world), "--coordinator", f"file://{store}",
             "--timeout", str(timeout), __file__, *args],
            env=env, cwd=REPO)]
    else:
        procs = []
        for r in range(world):
            e = dict(env, ZOO_TPU_PROCESS_ID=str(r))
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "tests.torch_dist_workers", *args],
                env=e, cwd=REPO))
    deadline = time.time() + timeout
    codes = [None] * len(procs)
    try:
        while any(c is None for c in codes):
            for i, p in enumerate(procs):
                if codes[i] is None:
                    codes[i] = p.poll()
            if time.time() > deadline:
                raise TimeoutError(f"{scenario}: ranks still running after "
                                   f"{timeout}s (exit codes so far {codes})")
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return codes, [dict(np.load(os.path.join(out_dir, f"{scenario}_{r}.npz"),
                                allow_pickle=False))
                   if os.path.exists(os.path.join(out_dir,
                                                  f"{scenario}_{r}.npz"))
                   else None for r in range(world)]


# ----------------------------------------------------------------- shared
def problem(n=64, d=16, seed=0):
    """The regression problem of the reference's sharding-mode tests."""
    rs = np.random.RandomState(seed)
    x = rs.randn(n, d).astype(np.float32)
    w = rs.randn(d, 1).astype(np.float32)
    return x, (x @ w).astype(np.float32)


def mlp_weights(d=16, h=256, seed=1):
    rs = np.random.RandomState(seed)
    return [{"kernel": (rs.randn(d, h) / np.sqrt(d)).astype(np.float32),
             "bias": (rs.randn(h) * 0.1).astype(np.float32)},
            {"kernel": (rs.randn(h, 1) / np.sqrt(h)).astype(np.float32),
             "bias": (rs.randn(1) * 0.1).astype(np.float32)}]


def attn_weights(d=16, seed=2):
    rs = np.random.RandomState(seed)
    return {
        "mhsa": {"qkv_kernel": (rs.randn(d, 3 * d) * 0.3).astype(np.float32),
                 "qkv_bias": (rs.randn(3 * d) * 0.1).astype(np.float32),
                 "out_kernel": (rs.randn(d, d) * 0.3).astype(np.float32),
                 "out_bias": (rs.randn(d) * 0.1).astype(np.float32)},
        "ffn": {"up_kernel": (rs.randn(d, 2 * d) * 0.3).astype(np.float32),
                "up_bias": (rs.randn(2 * d) * 0.1).astype(np.float32),
                "down_kernel": (rs.randn(2 * d, d) * 0.3).astype(np.float32),
                "down_bias": (rs.randn(d) * 0.1).astype(np.float32)},
    }


def moe_weights(d=8, e=4, h=12, seed=3):
    rs = np.random.RandomState(seed)
    return {"router": (rs.randn(d, e) * 0.5).astype(np.float32),
            "w1": (rs.randn(e, d, h) * 0.3).astype(np.float32),
            "b1": (rs.randn(e, h) * 0.1).astype(np.float32),
            "w2": (rs.randn(e, h, d) * 0.3).astype(np.float32),
            "b2": (rs.randn(e, d) * 0.1).astype(np.float32)}


def stage_weights(p=2, d=8, seed=4):
    rs = np.random.RandomState(seed)
    return [{"w": (rs.randn(d, d) * 0.3).astype(np.float32),
             "b": (rs.randn(d) * 0.1).astype(np.float32)} for _ in range(p)]


# ------------------------------------------------------------------ ranks
def _t(a):
    import torch
    return torch.as_tensor(np.array(a))


def _np(t):
    return t.detach().cpu().numpy().copy()


def _context(mesh_shape=None, conf=None):
    import torch
    torch.set_num_threads(1)
    from analytics_zoo_torch.common.zoo_context import init_zoo_context
    from analytics_zoo_torch.ops import dtypes
    ctx = init_zoo_context(device="cpu", mesh_shape=mesh_shape,
                           conf={"parallel.timeout_s": GROUP_TIMEOUT_S,
                                 **(conf or {})})
    dtypes.set_policy(param_dtype="float32", compute_dtype="float32")
    return ctx


def _mlp(mode=None):
    from analytics_zoo_torch.pipeline.api.keras import Sequential
    from analytics_zoo_torch.pipeline.api.keras.engine import Layer
    from analytics_zoo_torch.pipeline.api.keras.layers import Dense
    Layer.reset_name_counters()
    m = Sequential()
    m.add(Dense(256, activation="relu", input_shape=(16,),
                parallel_mode="column" if mode == "model" else None))
    m.add(Dense(1, parallel_mode="row" if mode == "model" else None))
    return m


def _train_mode(out, mesh_shape, mode, steps=5):
    """The reference's ``_train_some`` on this rank: 5 SGD steps of the
    MLP (column/row-parallel under ``model``) over the 64-row batch; the
    hidden layer's 16 x 256 kernel is large enough for FSDP to split."""
    import torch
    from analytics_zoo_torch.parallel import mesh as mesh_lib
    from analytics_zoo_torch.parallel.trainer import DistributedTrainer
    from analytics_zoo_torch.pipeline.api.keras import objectives
    from analytics_zoo_torch.pipeline.api.keras.optimizers import SGD
    mesh = mesh_lib.create_mesh(mesh_shape)
    from analytics_zoo_torch.interop import load_jax_variables
    m = _mlp(mode)
    m.init()
    names = [l.name for l in m.layers]
    # the reference's numpy params, loaded whole (interop)
    load_jax_variables(m, {"params": dict(zip(names, mlp_weights())),
                           "state": {n: {} for n in names}})
    params = m.get_variables()["params"]
    trainer = DistributedTrainer(m, objectives.get("mse"),
                                 optim_method=SGD(0.02), mesh=mesh)
    placed = trainer.place_params(params)
    for n in names:
        for k, v in placed[n].items():
            out[f"{mode}_piece_{n}_{k}"] = np.asarray(v.shape)
    # the pieces put back together are the whole leaves, bit for bit
    back = mesh_lib.fetch_global(placed, mesh, trainer.param_shardings(None))
    out[f"{mode}_roundtrip"] = np.asarray(all(
        np.array_equal(back[n][k], params[n][k].numpy())
        for n in names for k in params[n]))
    opt_state = trainer.init_opt_state(placed)
    state = trainer.place_state({})
    x, y = problem()
    if mesh_lib.data_split_across_hosts(mesh):
        r, w = mesh.rank, mesh.world_size
        rows = slice(r * len(x) // w, (r + 1) * len(x) // w)
        x, y = x[rows], y[rows]
    batch = trainer.put_batch((x, y))
    losses = []
    for _ in range(steps):
        placed, opt_state, state, loss = trainer.train_step(
            placed, opt_state, state, batch, torch.Generator())
        losses.append(float(loss))
    whole = trainer.gather_tree(placed)
    for i, n in enumerate(names):
        for k, v in whole[n].items():
            out[f"{mode}_p{i}_{k}"] = _np(v)
    out[f"{mode}_losses"] = np.asarray(losses)


def _bn(out):
    """One training step of Dense → BatchNormalization → Dense on
    ``data=2``: each rank its half of the rows."""
    import torch
    from analytics_zoo_torch.parallel import mesh as mesh_lib
    from analytics_zoo_torch.parallel.trainer import DistributedTrainer
    from analytics_zoo_torch.pipeline.api.keras import Sequential, objectives
    from analytics_zoo_torch.pipeline.api.keras.engine import Layer
    from analytics_zoo_torch.pipeline.api.keras.layers import (
        BatchNormalization, Dense)
    from analytics_zoo_torch.pipeline.api.keras.optimizers import SGD
    mesh = mesh_lib.create_mesh({"data": 2})
    Layer.reset_name_counters()
    m = Sequential()
    m.add(Dense(8, input_shape=(16,)))
    m.add(BatchNormalization(momentum=0.9))
    m.add(Dense(1))
    v = m.init()
    w = mlp_weights(16, 8)
    names = [l.name for l in m.layers]
    params = {names[0]: {k: _t(a) for k, a in w[0].items()},
              names[1]: v["params"][names[1]],
              names[2]: {k: _t(a) for k, a in w[1].items()}}
    trainer = DistributedTrainer(m, objectives.get("mse"),
                                 optim_method=SGD(0.1), mesh=mesh)
    placed = trainer.place_params(params)
    opt_state = trainer.init_opt_state(placed)
    state = trainer.place_state(v["state"])
    x, y = problem()
    rows = slice(mesh.rank * 32, (mesh.rank + 1) * 32)
    for _ in range(2):
        placed, opt_state, state, loss = trainer.train_step(
            placed, opt_state, state, trainer.put_batch((x[rows], y[rows])),
            torch.Generator())
    out["bn_mean"] = _np(state[names[1]]["moving_mean"])
    out["bn_var"] = _np(state[names[1]]["moving_var"])
    for i, n in enumerate(names):
        for k, a in trainer.gather_tree(placed)[n].items():
            out[f"bn_p{i}_{k}"] = _np(a)
    out["bn_loss"] = np.asarray(float(loss))


def _block_model(seq_parallel="auto", tensor_parallel="auto", causal=False):
    from analytics_zoo_torch.pipeline.api.keras import Sequential
    from analytics_zoo_torch.pipeline.api.keras.engine import Layer
    from analytics_zoo_torch.pipeline.api.keras.layers.attention import (
        MultiHeadSelfAttention, PositionwiseFeedForward)
    Layer.reset_name_counters()
    m = Sequential()
    m.add(MultiHeadSelfAttention(16, 4, causal=causal,
                                 sequence_parallel=seq_parallel,
                                 tensor_parallel=tensor_parallel,
                                 input_shape=(8, 16)))
    m.add(PositionwiseFeedForward(16, 32, tensor_parallel=tensor_parallel))
    return m


def block_problem(seed=5):
    rs = np.random.RandomState(seed)
    x = rs.randn(4, 8, 16).astype(np.float32)
    y = rs.randn(4, 8, 16).astype(np.float32)
    return x, y


def _block(out, mesh_shape, tag, causal):
    """Three SGD steps of MHSA → FFN under ``mesh_shape`` (tensor or
    sequence parallel by the "auto" routes)."""
    import torch
    from analytics_zoo_torch.parallel import mesh as mesh_lib
    from analytics_zoo_torch.parallel.trainer import DistributedTrainer
    from analytics_zoo_torch.pipeline.api.keras import objectives
    from analytics_zoo_torch.pipeline.api.keras.optimizers import SGD
    mesh = mesh_lib.create_mesh(mesh_shape)
    with mesh_lib.active(mesh):
        m = _block_model(causal=causal)
        m.init()
    w = attn_weights()
    names = [l.name for l in m.layers]
    params = {names[0]: {k: _t(a) for k, a in w["mhsa"].items()},
              names[1]: {k: _t(a) for k, a in w["ffn"].items()}}
    trainer = DistributedTrainer(m, objectives.get("mse"),
                                 optim_method=SGD(0.1), mesh=mesh)
    placed = trainer.place_params(params)
    out[f"{tag}_qkv_piece"] = np.asarray(placed[names[0]]["qkv_kernel"].shape)
    out[f"{tag}_qkv_piece_values"] = _np(placed[names[0]]["qkv_kernel"])
    opt_state = trainer.init_opt_state(placed)
    state = trainer.place_state({})
    x, y = block_problem()
    batch = trainer.put_batch((x, y))
    with torch.no_grad(), mesh_lib.active(mesh):
        out[f"{tag}_forward"] = _np(m.apply(placed, _t(x))[0])
    losses = []
    for _ in range(3):
        placed, opt_state, state, loss = trainer.train_step(
            placed, opt_state, state, batch, torch.Generator())
        losses.append(float(loss))
    for i, n in enumerate(names):
        for k, a in trainer.gather_tree(placed)[n].items():
            out[f"{tag}_p{i}_{k}"] = _np(a)
    out[f"{tag}_losses"] = np.asarray(losses)


def scenario_modes(out_dir, rank):
    """Data, FSDP and model parallel, BN's global statistics, and the
    transformer block under model=2 and seq=2, on two ranks."""
    _context()
    out = {}
    _train_mode(out, {"data": 2}, "data")
    _train_mode(out, {"fsdp": 2}, "fsdp")
    _train_mode(out, {"model": 2}, "model")
    _bn(out)
    _block(out, {"model": 2}, "tp", causal=False)
    _block(out, {"seq": 2}, "sp", causal=True)
    return out


COMBOS = (({"data": 2, "model": 2}, "dm"), ({"data": 2, "fsdp": 2}, "df"),
          ({"data": 2, "seq": 2}, "ds"))


def scenario_combos(out_dir, rank):
    """Two axes at once on four ranks: every process passes the global
    batch and a rank takes its data-parallel rows (the data axes do not
    span the processes), the gradients averaged over each data group."""
    _context()
    out = {}
    for shape, tag in COMBOS:
        _block(out, shape, tag, causal=True)
    return out


def _comm(out, mesh):
    import torch
    from analytics_zoo_torch.parallel import comm
    g = mesh.group("data")
    r = mesh.rank
    x = torch.arange(6.0).reshape(2, 3) + 10 * r
    out["all_gather"] = _np(comm.all_gather_cat(x, g, 0))
    out["reduce_scatter"] = _np(comm.reduce_scatter_sum(
        torch.arange(8.0).reshape(4, 2) * (r + 1), g, 0))
    out["all_to_all"] = _np(comm.all_to_all(
        torch.arange(4.0).reshape(2, 2) + 10 * r, g))
    out["ppermute"] = _np(comm.ppermute(torch.tensor([float(r)]), g, 1))
    # the autograd rules: the gradient of sum(w * f(x)) for each op
    for name, fn in (
            ("copy", lambda t: comm.copy_to_group(t, g)),
            ("reduce", lambda t: comm.reduce_from_group(t, g)),
            ("sum", lambda t: comm.sum_across_group(t, g)),
            ("gather", lambda t: comm.gather_from_group(t, g, 0)),
            ("permute", lambda t: comm.ppermute(t, g, 1)),
            ("a2a", lambda t: comm.all_to_all(t, g))):
        t = (torch.arange(4.0) + r).reshape(2, 2).requires_grad_()
        y = fn(t)
        wgt = torch.arange(float(y.numel())).reshape(y.shape) + 1 + 3 * r
        (y * wgt).sum().backward()
        out[f"grad_{name}"] = _np(t.grad)
        out[f"value_{name}"] = _np(y)


def _ring(out):
    import torch
    from analytics_zoo_torch.ops.attention import (
        scaled_dot_product_attention)
    from analytics_zoo_torch.parallel import mesh as mesh_lib
    from analytics_zoo_torch.parallel.ring_attention import ring_attention
    mesh = mesh_lib.create_mesh({"seq": 2})
    rs = np.random.RandomState(0)
    q, k, v = (rs.randn(2, 3, 16, 8).astype(np.float32) for _ in range(3))
    dout = rs.randn(2, 3, 16, 8).astype(np.float32)
    blk = slice(mesh.rank * 8, (mesh.rank + 1) * 8)
    for causal in (False, True):
        qt, kt, vt = (_t(a[:, :, blk]).requires_grad_() for a in (q, k, v))
        o = ring_attention(qt, kt, vt, mesh, causal=causal)
        (o * _t(dout[:, :, blk])).sum().backward()
        tag = "causal" if causal else "full"
        out[f"ring_{tag}_out"] = _np(o)
        for n, t in (("dq", qt), ("dk", kt), ("dv", vt)):
            out[f"ring_{tag}_{n}"] = _np(t.grad)
        # dense attention on the whole sequence, this rank's block
        qd, kd, vd = (_t(a).requires_grad_() for a in (q, k, v))
        od = scaled_dot_product_attention(qd, kd, vd, causal=causal)
        (od * _t(dout)).sum().backward()
        out[f"dense_{tag}_out"] = _np(od[:, :, blk])
        for n, t in (("dq", qd), ("dk", kd), ("dv", vd)):
            out[f"dense_{tag}_{n}"] = _np(t.grad[:, :, blk])


def _pipeline(out):
    import torch
    from analytics_zoo_torch.parallel import mesh as mesh_lib
    from analytics_zoo_torch.parallel.pipeline import (
        pipeline_apply, stack_stage_params)
    mesh = mesh_lib.create_mesh({"pipe": 2})
    stacked = stack_stage_params([{k: _t(a) for k, a in s.items()}
                                  for s in stage_weights()])
    stacked = {k: a.requires_grad_() for k, a in stacked.items()}
    x = _t(np.random.RandomState(6).randn(8, 8).astype(np.float32))

    def stage_fn(p, h):
        return torch.tanh(h @ p["w"] + p["b"])
    y = pipeline_apply(stage_fn, stacked, x, mesh, num_microbatches=4)
    y.sum().backward()
    out["pipe_out"] = _np(y)
    for k, a in stacked.items():
        out[f"pipe_grad_{k}"] = _np(a.grad)


def _moe(out):
    import torch
    from analytics_zoo_torch.parallel import mesh as mesh_lib
    from analytics_zoo_torch.pipeline.api.keras.engine import Layer
    from analytics_zoo_torch.pipeline.api.keras.layers.moe import MoE
    mesh = mesh_lib.create_mesh({"expert": 2})
    Layer.reset_name_counters()
    for top_k in (1, 2):
        layer = MoE(4, 12, top_k=top_k, capacity_factor=1.0,
                    input_shape=(6, 8))
        with mesh_lib.active(mesh):
            layer.init(torch.Generator().manual_seed(0))
        params = {k: _t(a).requires_grad_() for k, a in moe_weights().items()}
        x = _t(np.random.RandomState(7).randn(4, 6, 8).astype(np.float32))
        x.requires_grad_()
        with mesh_lib.active(mesh):
            y, aux = layer.call_with_aux(params, x)
        (y.square().sum() + aux).backward()
        out[f"moe{top_k}_out"] = _np(y)
        out[f"moe{top_k}_aux"] = np.asarray(float(aux))
        out[f"moe{top_k}_dx"] = _np(x.grad)
        for k, a in params.items():
            out[f"moe{top_k}_grad_{k}"] = _np(a.grad)


def scenario_ops(out_dir, rank):
    """The collectives and their autograd rules, ring attention, the
    pipeline and MoE's expert exchange, on two ranks."""
    ctx = _context()
    out = {}
    _comm(out, ctx.mesh)
    _ring(out)
    _pipeline(out)
    _moe(out)
    return out


# --------------------------------------------------------------- fit/resume
def fit_model():
    from analytics_zoo_torch.pipeline.api.keras import Sequential
    from analytics_zoo_torch.pipeline.api.keras.engine import Layer
    from analytics_zoo_torch.pipeline.api.keras.layers import Dense
    Layer.reset_name_counters()
    m = Sequential()
    m.add(Dense(16, activation="relu", input_shape=(8,)))
    m.add(Dense(4))
    return m


def fit_weights(m):
    rs = np.random.RandomState(8)
    names = [l.name for l in m.layers]
    shapes = [((8, 16), (16,)), ((16, 4), (4,))]
    return {n: {"kernel": (rs.randn(*ks) * 0.3).astype(np.float32),
                "bias": (rs.randn(*bs) * 0.1).astype(np.float32)}
            for n, (ks, bs) in zip(names, shapes)}


def fit_data():
    """The full 64-row dataset, the same on every host (seeded)."""
    rs = np.random.RandomState(0)
    return (rs.randn(64, 8).astype(np.float32),
            rs.randn(64, 4).astype(np.float32))


def set_weights(m, weights):
    import torch
    v = m.init()
    m.set_variables({"params": {n: {k: torch.as_tensor(a) for k, a in
                                    w.items()} for n, w in weights.items()},
                     "state": v["state"]})


def scenario_fit(out_dir, rank):
    """The reference's two-process fit/predict/resume: each host feeds
    its own half (batch 16 a host, 32 global), 2 epochs with a snapshot
    each, a fresh Estimator resumes to 3, each host predicts its rows."""
    from analytics_zoo_torch.common.triggers import EveryEpoch, MaxEpoch
    from analytics_zoo_torch.feature.feature_set import FeatureSet
    from analytics_zoo_torch.pipeline.api.keras.optimizers import SGD
    from analytics_zoo_torch.pipeline.estimator import Estimator
    ctx = _context()
    pid = ctx.process_index
    x, y = fit_data()
    lo, hi = pid * 32, (pid + 1) * 32
    train_set = FeatureSet.from_ndarrays(x[lo:hi], y[lo:hi], shuffle=False)
    ckpt = os.path.join(out_dir, "ckpt")
    m = fit_model()
    set_weights(m, fit_weights(m))
    est = Estimator(m, optim_method=SGD(learning_rate=0.1), model_dir=ckpt)
    est.train(train_set, "mse", end_trigger=MaxEpoch(2),
              checkpoint_trigger=EveryEpoch(), batch_size=16)
    out = {"losses": np.asarray([h["loss"] for h in est.history])}
    for n, w in est.variables["params"].items():
        for k, a in w.items():
            out[f"p2_{n}_{k}"] = _np(a)
    m2 = fit_model()
    set_weights(m2, fit_weights(m2))
    est2 = Estimator(m2, optim_method=SGD(learning_rate=0.1),
                     model_dir=ckpt)
    est2.train(train_set, "mse", end_trigger=MaxEpoch(3),
               checkpoint_trigger=EveryEpoch(), batch_size=16)
    out["epoch"] = np.asarray(est2.train_state.epoch)
    for n, w in est2.variables["params"].items():
        for k, a in w.items():
            out[f"p3_{n}_{k}"] = _np(a)
    out["preds"] = np.asarray(est2.predict(x[lo:hi], batch_size=16))
    m2.save_model(os.path.join(out_dir, "fit_model.bin"))
    out["scores"] = np.asarray(est2.evaluate(
        FeatureSet.from_ndarrays(x[lo:hi], y[lo:hi], shuffle=False),
        "mse", batch_size=16)["loss"])
    return out


# ----------------------------------------------------------------- elastic
def elastic_problem(n=96):
    rs = np.random.RandomState(3)
    x = rs.randn(n, 8).astype(np.float32)
    w = rs.randn(8, 1).astype(np.float32)
    return x, (x @ w).astype(np.float32)


def elastic_weights():
    """Dense(16) and Dense(1) of the dropout-free elastic model, the
    weights the JAX package's run loads too."""
    rs = np.random.RandomState(9)
    return [{"kernel": (rs.randn(8, 16) * 0.3).astype(np.float32),
             "bias": (rs.randn(16) * 0.1).astype(np.float32)},
            {"kernel": (rs.randn(16, 1) * 0.3).astype(np.float32),
             "bias": (rs.randn(1) * 0.1).astype(np.float32)}]


def elastic_model(dropout=True):
    """Dense(16, relu) → Dropout(0.25) → Dense(1), seeded by the port's
    init; with ``dropout=False`` the two Dense layers alone, holding
    ``elastic_weights`` (the JAX package draws other dropout masks, so
    the runs held against it leave dropout out)."""
    from analytics_zoo_torch.pipeline.api.keras import Sequential
    from analytics_zoo_torch.pipeline.api.keras.engine import Layer
    from analytics_zoo_torch.pipeline.api.keras.layers import (
        Dense, Dropout)
    Layer.reset_name_counters()
    m = Sequential()
    m.add(Dense(16, activation="relu", input_shape=(8,)))
    if dropout:
        m.add(Dropout(0.25))    # draws every step: a drifted stream shows
    m.add(Dense(1))
    if not dropout:
        set_weights(m, dict(zip([l.name for l in m.layers],
                                elastic_weights())))
    return m


def _elastic_pipe(rank):
    from analytics_zoo_torch.data import DataPipeline
    x, y = elastic_problem()
    rows = slice(rank * 32, (rank + 1) * 32)
    # the host's own rows, one shard: the stream does not depend on the
    # process group, so it resumes on the re-formed one
    return DataPipeline(x[rows], y[rows], batch_size=8, seed=11,
                        name="elastic", shard_index=0, shard_count=1)


def scenario_elastic(out_dir, rank, dropout=True):
    """Three ranks, each its own pipeline of 32 rows (batch 8 a host):
    rank 2 dies before step 6, ranks 0 and 1 take a LostHost there,
    re-form a two-rank group from a fresh store, restore snapshot 4 and
    finish 2 epochs; then, on the re-formed group, a control run resumes
    from a copy of that snapshot and trains uninterrupted.  The model is
    ``elastic_model(dropout)``."""
    import shutil
    from analytics_zoo_torch.common.triggers import MaxEpoch, SeveralIteration
    from analytics_zoo_torch.observability import get_registry
    from analytics_zoo_torch.pipeline.api.keras.optimizers import SGD
    from analytics_zoo_torch.pipeline.estimator import Estimator
    from analytics_zoo_torch.resilience import (
        ChaosPlan, FaultSpec, clear_chaos, install_chaos)
    from analytics_zoo_torch.resilience.chaos import SITE_TRAINER_DISPATCH
    ctx = _context()
    d1 = os.path.join(out_dir, "elastic")
    install_chaos(ChaosPlan(
        [FaultSpec(site=SITE_TRAINER_DISPATCH, at_step=6, kind="kill",
                   process_index=2, exit_code=137)] +
        [FaultSpec(site=SITE_TRAINER_DISPATCH, at_step=6, kind="lose_host",
                   survivors=[0, 1], process_index=r) for r in (0, 1)]))
    est = Estimator(elastic_model(dropout),
                    optim_method=SGD(learning_rate=0.05), model_dir=d1)
    pipe = _elastic_pipe(rank)
    est.train(pipe, "mse", end_trigger=MaxEpoch(2),
              checkpoint_trigger=SeveralIteration(4), rng=5)
    clear_chaos()
    out = {"iteration": np.asarray(est.train_state.iteration),
           "position": np.asarray([pipe.epoch, pipe.step]),
           "world": np.asarray(ctx.mesh.world_size),
           "new_rank": np.asarray(ctx.mesh.rank),
           "degraded": np.asarray(os.path.exists(
               os.path.join(d1, "degraded.json"))),
           "reformations": np.asarray(get_registry().counter(
               "mesh_reformations_total", "").value)}
    for n, w in est.variables["params"].items():
        for k, a in w.items():
            out[f"run_{n}_{k}"] = _np(a)
    # the control: the same snapshot, the same two-rank mesh, no failure
    d2 = os.path.join(out_dir, "control")
    if ctx.mesh.rank == 0:
        os.makedirs(d2, exist_ok=True)
        shutil.copy(os.path.join(d1, "snapshot.4.ckpt"), d2)
    from analytics_zoo_torch.parallel import comm
    comm.barrier()
    ctl = Estimator(elastic_model(dropout),
                    optim_method=SGD(learning_rate=0.05), model_dir=d2)
    ctl.train(_elastic_pipe(rank), "mse", end_trigger=MaxEpoch(2),
              checkpoint_trigger=SeveralIteration(4), rng=5)
    for n, w in ctl.variables["params"].items():
        for k, a in w.items():
            out[f"ctl_{n}_{k}"] = _np(a)
    out["ctl_iteration"] = np.asarray(ctl.train_state.iteration)
    return out


SCENARIOS = {"modes": scenario_modes, "combos": scenario_combos,
             "ops": scenario_ops,
             "fit": scenario_fit, "elastic": scenario_elastic,
             "elastic_plain": lambda out_dir, rank: scenario_elastic(
                 out_dir, rank, dropout=False)}


def main(argv):
    scenario, out_dir = argv[1], argv[2]
    rank = int(os.environ.get("ZOO_TPU_PROCESS_ID", "0"))
    out = SCENARIOS[scenario](out_dir, rank)
    np.savez(os.path.join(out_dir, f"{scenario}_{rank}.npz"), **out)
    import torch.distributed as dist
    if dist.is_initialized():
        dist.barrier()
        dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv)
