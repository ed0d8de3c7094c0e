"""PyTorch port, ``models/anomalydetection``: ``unroll`` and
``detect_anomalies`` equal to the JAX package's; ``AnomalyDetector`` at
its default widths (LSTM 8 -> 32 -> 15, Dense(1)) built in both packages
on the same weights (the JAX model's, loaded through
``interop.load_jax_variables``): ``predict`` within 1e-6, a 3-epoch
``fit`` with the dropouts at zero within 1e-4 of the reference's epoch
losses and parameters (ROADMAP.md's multi-step float32 tolerance), and a
``fit`` with the dropouts on that runs and returns the reference's
shapes.  The synthetic taxi series ``chip_smoke.py`` trains on is the
app's generator, value for value."""

import importlib.util
import pathlib

import numpy as np
import pytest
import torch

import jax

from analytics_zoo_tpu.models.anomalydetection import (
    AnomalyDetector as JAnomalyDetector,
    detect_anomalies as j_detect,
    unroll as j_unroll,
)
from analytics_zoo_tpu.pipeline.api.keras import optimizers as jopt
from analytics_zoo_tpu.pipeline.api.keras.engine import Layer as JLayer

from analytics_zoo_torch.common import config as tconfig
from analytics_zoo_torch.common import zoo_context as tctx
from analytics_zoo_torch.interop import load_jax_variables
from analytics_zoo_torch.models.anomalydetection import (
    AnomalyDetector, detect_anomalies, unroll,
)
from analytics_zoo_torch.ops import dtypes as tdtypes
from analytics_zoo_torch.ops import kernels
from analytics_zoo_torch.pipeline.api.keras import optimizers as topt
from analytics_zoo_torch.pipeline.api.keras.engine import Layer as TLayer

REPO = pathlib.Path(__file__).resolve().parents[1]
UNROLL = 10


@pytest.fixture(autouse=True)
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


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _series(length=202):
    app = _load("anomaly_detection_taxi",
                REPO / "apps/anomaly_detection/anomaly_detection_taxi.py")
    series, incidents = app.taxi_like_series(length, seed=0)
    return (series - series.mean()) / (series.std() + 1e-8), incidents


def test_taxi_series_is_the_apps():
    app = _load("anomaly_detection_taxi",
                REPO / "apps/anomaly_detection/anomaly_detection_taxi.py")
    smoke = _load("chip_smoke", REPO / "chip_smoke.py")
    for length, seed in ((600, 0), (10_320, 3)):
        want = app.taxi_like_series(length, seed)
        got = smoke.taxi_like_series(length, seed)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1] == want[1]


@pytest.mark.parametrize("features", [1, 3])
def test_unroll_matches_the_reference(features):
    data = np.random.RandomState(0).randn(50, features).astype(np.float32)
    if features == 1:
        data = data[:, 0]
    for length in (1, 7, 24):
        jx, jy = j_unroll(data, length)
        tx, ty = unroll(data, length)
        np.testing.assert_array_equal(tx, jx)
        np.testing.assert_array_equal(ty, jy)
        assert tx.dtype == jx.dtype and ty.shape == jy.shape


def test_detect_anomalies_matches_the_reference():
    rs = np.random.RandomState(1)
    y = rs.randn(300, 1).astype(np.float32)
    pred = y + 0.01 * rs.randn(300, 1).astype(np.float32)
    pred[[17, 90, 91, 250]] += 3.0
    for size in (1, 4, 6, 20):
        np.testing.assert_array_equal(detect_anomalies(y, pred, size),
                                      j_detect(y, pred, size))
    np.testing.assert_array_equal(detect_anomalies(y, pred, 4),
                                  [17, 90, 91, 250])
    # ties at the threshold are all flagged, as in the reference
    tie = np.zeros(10, np.float32)
    tie_pred = np.array([0, 1, 1, 1, 0, 0, 0, 0, 0, 0], np.float32)
    np.testing.assert_array_equal(detect_anomalies(tie, tie_pred, 2),
                                  j_detect(tie, tie_pred, 2))


def _pair(dropouts=(0.2, 0.2, 0.2)):
    JLayer.reset_name_counters()
    jm = JAnomalyDetector((UNROLL, 1), dropouts=dropouts)
    TLayer.reset_name_counters()
    tm = AnomalyDetector((UNROLL, 1), dropouts=dropouts)
    jvars = jax.device_get(jm.model.init(jax.random.PRNGKey(0)))
    load_jax_variables(tm, jvars)
    return jm, tm


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], f"{prefix}/{k}"))
        return out
    return {prefix: tree.detach().cpu().numpy()
            if isinstance(tree, torch.Tensor) else np.asarray(tree)}


def test_model_layout_matches_the_reference():
    jm, tm = _pair()
    assert [type(l).__name__ for l in tm.model.layers] == \
        [type(l).__name__ for l in jm.model.layers] == \
        ["LSTM", "Dropout", "LSTM", "Dropout", "LSTM", "Dropout", "Dense"]
    jp = _flat(jax.device_get(jm.get_variables()["params"]))
    tp = _flat(tm.get_variables()["params"])
    assert {k: v.shape for k, v in tp.items()} == \
        {k: v.shape for k, v in jp.items()}
    assert tm.model.get_output_shape() == (None, 1)


def test_predict_matches_the_reference():
    x, _ = unroll(_series()[0], UNROLL)
    jm, tm = _pair()
    want = np.asarray(jm.predict(x, batch_size=64))
    got = tm.predict(x, batch_size=64)
    assert got.shape == want.shape == (len(x), 1)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def test_fit_without_dropout_matches_the_reference():
    x, y = unroll(_series()[0], UNROLL)
    split = int(len(x) * 0.8)
    jm, tm = _pair(dropouts=(0.0, 0.0, 0.0))
    jm.compile(jopt.Adam(lr=0.01), "mse")
    tm.compile(topt.Adam(lr=0.01), "mse")
    jhist = jm.fit(x[:split], y[:split], batch_size=32, nb_epoch=3)
    thist = tm.fit(x[:split], y[:split], batch_size=32, nb_epoch=3, rng=0)
    assert [h["epoch"] for h in thist] == [h["epoch"] for h in jhist] == \
        [1, 2, 3]
    np.testing.assert_allclose([h["loss"] for h in thist],
                               [h["loss"] for h in jhist], atol=1e-4, rtol=0)
    jp = _flat(jax.device_get(jm.get_variables()["params"]))
    tp = _flat(tm.get_variables()["params"])
    for k in jp:
        np.testing.assert_allclose(tp[k], jp[k], atol=1e-4, rtol=0,
                                   err_msg=k)
    want = np.asarray(jm.predict(x[split:], batch_size=64))
    got = tm.predict(x[split:], batch_size=64)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    np.testing.assert_array_equal(
        detect_anomalies(y[split:], got, 3), j_detect(y[split:], want, 3))


def test_fit_with_dropout_runs_and_returns_the_reference_shapes():
    x, y = unroll(_series()[0], UNROLL)
    jm, tm = _pair()
    jm.compile(jopt.Adam(lr=0.01), "mse")
    tm.compile(topt.Adam(lr=0.01), "mse")
    jhist = jm.fit(x, y, batch_size=32, nb_epoch=2)
    thist = tm.fit(x, y, batch_size=32, nb_epoch=2, rng=0)
    assert len(thist) == len(jhist) == 2
    assert set(thist[0]) == set(jhist[0])
    assert all(np.isfinite(h["loss"]) for h in thist)
    # dropout on: the epoch loss is no longer the zero-dropout one
    _, plain = _pair(dropouts=(0.0, 0.0, 0.0))
    plain.compile(topt.Adam(lr=0.01), "mse")
    assert plain.fit(x, y, batch_size=32, nb_epoch=1, rng=0)[0]["loss"] \
        != thist[0]["loss"]
    got, want = tm.predict(x), np.asarray(jm.predict(x))
    assert got.shape == want.shape == (len(x), 1)
    assert np.isfinite(got).all()
    flagged = detect_anomalies(y, got, 5)
    assert flagged.shape == j_detect(y, want, 5).shape == (5,)
