"""PyTorch port, the reference's two-process fit/predict/resume
(``tests/test_multiprocess.py:30-69``) on two gloo ranks started by
``launch_cli``: each host feeds its own 32 of the 64 rows (batch 16 a
host, 32 global), trains 2 epochs with a snapshot each epoch, a fresh
Estimator resumes to epoch 3, each host predicts its own rows and both
evaluate.  Held against a one-process oracle of the port and of the JAX
package (on ``{"data": 2}``) over the same global batches (batch b =
[host 0 rows 16b:16b+16, host 1 rows 16b:16b+16]): params after 2 and 3
epochs and the predictions within 1e-5 (several steps, ROADMAP), the
hosts bit-identical to each other."""

import os

import numpy as np
import pytest
import torch

import jax

from analytics_zoo_tpu.common.triggers import MaxEpoch as JMaxEpoch
from analytics_zoo_tpu.common.zoo_context import init_zoo_context as jinit
from analytics_zoo_tpu.feature.feature_set import FeatureSet as JFeatureSet
from analytics_zoo_tpu.parallel.mesh import create_mesh as jcreate_mesh
from analytics_zoo_tpu.pipeline.api.keras import Sequential as JSequential
from analytics_zoo_tpu.pipeline.api.keras.engine import Layer as JLayer
from analytics_zoo_tpu.pipeline.api.keras.layers import Dense as JDense
from analytics_zoo_tpu.pipeline.api.keras.optimizers import SGD as JSGD
from analytics_zoo_tpu.pipeline.estimator import Estimator as JEstimator

from analytics_zoo_torch.common import config as tconfig
from analytics_zoo_torch.common import zoo_context as tctx
from analytics_zoo_torch.common.triggers import MaxEpoch
from analytics_zoo_torch.feature.feature_set import FeatureSet
from analytics_zoo_torch.ops import dtypes as tdtypes
from analytics_zoo_torch.pipeline.api.keras.optimizers import SGD
from analytics_zoo_torch.pipeline.estimator import Estimator

from tests import torch_dist_workers as W

TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    out = tmp_path_factory.mktemp("fit")
    codes, outs = W.run_world("fit", 2, out, timeout=150, launcher=True)
    assert codes == [0], codes
    return out, outs


def _order():
    return np.concatenate([np.r_[b * 16:(b + 1) * 16,
                                 32 + b * 16:32 + (b + 1) * 16]
                           for b in range(2)])


@pytest.fixture
def port_oracle(f32_policy):
    tctx.reset_zoo_context()
    tconfig.reset_config()
    tctx.init_zoo_context(device="cpu")
    tdtypes.set_policy(param_dtype="float32", compute_dtype="float32")
    x, y = W.fit_data()
    o = _order()
    m = W.fit_model()
    W.set_weights(m, W.fit_weights(m))
    est = Estimator(m, optim_method=SGD(learning_rate=0.1))
    train = FeatureSet.from_ndarrays(x[o], y[o], shuffle=False)
    est.train(train, "mse", end_trigger=MaxEpoch(2), batch_size=32)
    p2 = {f"{n}_{k}": a.numpy().copy()
          for n, w in est.variables["params"].items() for k, a in w.items()}
    losses = [h["loss"] for h in est.history]
    est.train(train, "mse", end_trigger=MaxEpoch(3), batch_size=32)
    p3 = {f"{n}_{k}": a.numpy().copy()
          for n, w in est.variables["params"].items() for k, a in w.items()}
    preds = est.predict(x, batch_size=32)
    score = est.evaluate(FeatureSet.from_ndarrays(x, y, shuffle=False),
                         "mse", batch_size=32)["loss"]
    yield p2, p3, preds, losses, score
    tdtypes.restore_policy(None)
    tctx.reset_zoo_context()


def test_hosts_agree_bit_for_bit_and_snapshot_once(run):
    out, (w0, w1) = run
    keys = [k for k in w0 if k.startswith(("p2_", "p3_"))]
    assert keys
    for k in keys + ["losses", "scores"]:
        np.testing.assert_array_equal(w0[k], w1[k], err_msg=k)
    assert any(not np.array_equal(w0[k], w0[k.replace("p2", "p3")])
               for k in keys if k.startswith("p2_"))
    assert int(w0["epoch"]) == 3
    snaps = [f for f in os.listdir(out / "ckpt") if f.endswith(".ckpt")]
    assert sorted(snaps) == ["snapshot.2.ckpt", "snapshot.4.ckpt",
                             "snapshot.6.ckpt"]
    assert not [f for f in os.listdir(out / "ckpt") if f.endswith(".tmp")]
    # save_model: rank 0 wrote the whole variables, the file loads as p3
    from analytics_zoo_torch.common import zoo_context as zc
    zc.reset_zoo_context()
    zc.init_zoo_context(device="cpu")
    try:
        m = W.fit_model()
        m.init()
        m.load_weights(str(out / "fit_model.bin"))
        for n, w in m.get_variables()["params"].items():
            for k, a in w.items():
                np.testing.assert_array_equal(a.numpy(), w0[f"p3_{n}_{k}"])
    finally:
        zc.reset_zoo_context()


def test_two_hosts_match_the_one_process_oracle(run, port_oracle):
    p2, p3, preds, losses, score = port_oracle
    for r, w in enumerate(run[1]):
        for k, a in p2.items():
            np.testing.assert_allclose(w[f"p2_{k}"], a, **TOL)
        for k, a in p3.items():
            np.testing.assert_allclose(w[f"p3_{k}"], a, **TOL)
        # each host predicted exactly its own rows
        np.testing.assert_allclose(w["preds"], preds[32 * r:32 * r + 32],
                                   **TOL)
        np.testing.assert_allclose(w["losses"], losses, rtol=1e-5)
        # the hosts' metrics summed: the 64 rows' loss
        np.testing.assert_allclose(w["scores"], score, rtol=1e-5)


def test_two_hosts_match_the_jax_package_on_the_same_mesh(run, f32_policy):
    jinit().mesh = jcreate_mesh({"data": 2}, devices=jax.devices()[:2])
    x, y = W.fit_data()
    o = _order()
    JLayer.reset_name_counters()
    m = JSequential()
    m.add(JDense(16, activation="relu", input_shape=(8,)))
    m.add(JDense(4))
    v = m.init(jax.random.PRNGKey(0))
    names = [l.name for l in m.layers]
    weights = W.fit_weights(W.fit_model())
    m.set_variables({"params": {n: weights[tn] for n, tn in
                                zip(names, weights)},
                     "state": v["state"]})
    est = JEstimator(m, optim_method=JSGD(learning_rate=0.1))
    est.train(JFeatureSet.from_ndarrays(x[o], y[o], shuffle=False), "mse",
              end_trigger=JMaxEpoch(3), batch_size=32)
    want = jax.device_get(est.variables["params"])
    for w in run[1]:
        for n, tn in zip(names, weights):
            for k in ("kernel", "bias"):
                np.testing.assert_allclose(w[f"p3_{tn}_{k}"], want[n][k],
                                           **TOL)
    torch.testing.assert_close(torch.as_tensor(run[1][0]["preds"]),
                               torch.as_tensor(np.asarray(
                                   est.predict(x, batch_size=32))[:32]),
                               rtol=1e-5, atol=1e-6)
