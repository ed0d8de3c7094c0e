"""PyTorch port, NNFrames: ``NNClassifier`` fitting a small Wide & Deep
through a packed ``features`` column and ``SplitColumns`` (BASELINE config
2's path) in both packages on the same weights and the same pandas frame
(the epoch losses, the params after ``fit`` and ``transform``'s
predictions), ``NNEstimator``/``NNModel`` on a ``Sequential`` with
validation, clipping and ``set_tensorboard`` (the same scalars: tags,
steps and values), the ``save``/``load`` round trips (the variables
pickled as CPU tensors), ``NNImageReader`` over a directory of images, and
a frame that is not pandas (the duck-typed surface the estimators
read)."""

import os
import pickle

import cv2
import numpy as np
import pandas as pd
import pytest
import torch

import jax

from analytics_zoo_tpu.common.triggers import EveryEpoch as JEveryEpoch
from analytics_zoo_tpu.feature.common import SplitColumns as JSplitColumns
from analytics_zoo_tpu.models.recommendation import (
    ColumnFeatureInfo as JColumnFeatureInfo, WideAndDeep as JWideAndDeep,
)
from analytics_zoo_tpu.pipeline.api.keras import Sequential as JSequential
from analytics_zoo_tpu.pipeline.api.keras import layers as jlayers
from analytics_zoo_tpu.pipeline.api.keras import metrics as jmetrics
from analytics_zoo_tpu.pipeline.api.keras import optimizers as jopt
from analytics_zoo_tpu.pipeline.api.keras.engine import Layer as JLayer
from analytics_zoo_tpu.pipeline.nnframes import (
    NNClassifier as JNNClassifier, NNEstimator as JNNEstimator,
    NNImageReader as JNNImageReader,
)
from analytics_zoo_tpu.utils.summary import (
    TrainSummary as JTrainSummary, ValidationSummary as JValidationSummary,
)

from analytics_zoo_torch.common import config as tconfig
from analytics_zoo_torch.common import zoo_context as tctx
from analytics_zoo_torch.common.triggers import EveryEpoch
from analytics_zoo_torch.feature.common import SplitColumns
from analytics_zoo_torch.interop import load_jax_variables
from analytics_zoo_torch.models.recommendation import (
    ColumnFeatureInfo, WideAndDeep,
)
from analytics_zoo_torch.ops import dtypes as tdtypes
from analytics_zoo_torch.pipeline.api.keras import Sequential
from analytics_zoo_torch.pipeline.api.keras import layers as tlayers
from analytics_zoo_torch.pipeline.api.keras import metrics as tmetrics
from analytics_zoo_torch.pipeline.api.keras import optimizers as topt
from analytics_zoo_torch.pipeline.api.keras.engine import Layer as TLayer
from analytics_zoo_torch.pipeline.nnframes import (
    NNClassifier, NNClassifierModel, NNEstimator, NNImageReader, NNModel,
)
from analytics_zoo_torch.utils.summary import (
    TrainSummary, ValidationSummary,
)

LOSS = "sparse_categorical_crossentropy_with_logits"
# multi-step losses and params: the reference's own cross-program float32
# tolerance (ROADMAP.md, ground rules)
STEP_ATOL = 1e-4
# one forward in float32 (other summation orders, ~1e-7 relative)
PREDICT_ATOL = 1e-6
WD_INFO = dict(wide_base_cols=["a", "b"], wide_base_dims=[3, 5],
               wide_cross_cols=["ab"], wide_cross_dims=[15],
               embed_cols=["d", "e"], embed_in_dims=[6, 4],
               embed_out_dims=[3, 2], continuous_cols=["f", "g"])


@pytest.fixture(autouse=True)
def _port_cpu(f32_policy):
    tctx.reset_zoo_context()
    tconfig.reset_config()
    tctx.init_zoo_context(device="cpu")
    tdtypes.set_policy(param_dtype="float32", compute_dtype="float32")
    yield
    tdtypes.restore_policy(None)
    tctx.reset_zoo_context()
    tconfig.reset_config()


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _wd_frame(n, seed=5):
    """A Wide & Deep frame as ``benchmarks/wide_deep.py`` builds it: the
    model's inputs packed into one float32 ``features`` column."""
    JLayer.reset_name_counters()
    jwd = JWideAndDeep(2, JColumnFeatureInfo(**WD_INFO), "wide_n_deep",
                       hidden_layers=(8, 4))
    TLayer.reset_name_counters()
    twd = WideAndDeep(2, ColumnFeatureInfo(**WD_INFO), "wide_n_deep",
                      hidden_layers=(8, 4))
    rs = np.random.RandomState(seed)
    variables = _np(jwd.get_variables())
    for p in variables["params"].values():     # a non-zero wide table
        if "embeddings" in p and p["embeddings"].shape[1] == 2:
            p["embeddings"] = rs.randn(*p["embeddings"].shape).astype(
                np.float32) * 0.1
    jwd.model.set_variables(variables)
    load_jax_variables(twd, variables)
    a, b = rs.randint(0, 3, n), rs.randint(0, 5, n)
    cols = {"a": a, "b": b, "ab": a * 5 + b, "d": rs.randint(0, 7, n),
            "e": rs.randint(0, 5, n), "f": rs.rand(n).astype(np.float32),
            "g": rs.randn(n).astype(np.float32)}
    label = (a + b + rs.randint(0, 2, n) > 3).astype(np.int64)
    feats = twd.features_from_columns(cols)
    for g, w in zip(feats, jwd.features_from_columns(cols)):
        np.testing.assert_array_equal(g, w)
    sizes = [f.shape[1] for f in feats]
    packed = np.concatenate([f.astype(np.float32) for f in feats], axis=1)
    return jwd, twd, sizes, pd.DataFrame({"features": list(packed),
                                          "label": label})


def test_nnclassifier_on_wide_and_deep_matches_reference():
    jwd, twd, sizes, df = _wd_frame(96)
    fits = {}
    for pkg, clf_cls, split, opt, wd in (
            ("jax", JNNClassifier, JSplitColumns, jopt, jwd),
            ("torch", NNClassifier, SplitColumns, topt, twd)):
        clf = (clf_cls(wd.model, LOSS,
                       feature_preprocessing=split(sizes))
               .set_batch_size(16).set_max_epoch(3)
               .set_optim_method(opt.Adam(lr=1e-2)))
        fits[pkg] = (clf, clf.fit(df))
    (jclf, jm), (tclf, tm) = fits["jax"], fits["torch"]
    assert isinstance(tm, NNClassifierModel)
    jhist, thist = jclf.fitted_estimator.history, \
        tclf.fitted_estimator.history
    assert len(thist) == len(jhist) == 3
    for t, j in zip(thist, jhist):
        assert t["epoch"] == j["epoch"]
        np.testing.assert_allclose(t["loss"], j["loss"], atol=STEP_ATOL,
                                   rtol=0)
    jparams = _np(jwd.get_variables()["params"])
    tparams = twd.get_variables()["params"]
    for layer in jparams:
        for name in jparams[layer]:
            np.testing.assert_allclose(
                tparams[layer][name].numpy(), jparams[layer][name],
                atol=STEP_ATOL, rtol=0, err_msg=f"{layer}/{name}")
    got, want = tm.transform(df), jm.transform(df)
    assert list(got.columns) == list(want.columns) == \
        ["features", "label", "prediction"]
    assert got["prediction"].dtype == want["prediction"].dtype == np.int64
    np.testing.assert_array_equal(got["prediction"].to_numpy(),
                                  want["prediction"].to_numpy())
    assert "prediction" not in df.columns     # transform copies the frame


def _dense_pair(d=6, classes=3):
    JLayer.reset_name_counters()
    jm = JSequential()
    jm.add(jlayers.Dense(8, activation="relu", input_shape=(d,)))
    jm.add(jlayers.Dense(classes))
    TLayer.reset_name_counters()
    tm = Sequential()
    tm.add(tlayers.Dense(8, activation="relu", input_shape=(d,)))
    tm.add(tlayers.Dense(classes))
    load_jax_variables(tm, _np(jm.init()))
    return jm, tm


def _frame(n=64, d=6, classes=3, seed=0):
    rs = np.random.RandomState(seed)
    x = rs.randn(n, d).astype(np.float32)
    y = np.argmax(x @ rs.randn(d, classes), -1).astype(np.int64)
    return pd.DataFrame({"f": list(x), "y": y})


def test_estimator_tensorboard_writes_the_reference_scalars(tmp_path):
    """Loss at the dispatch crossing each multiple of 20, Throughput and
    the validation scores each epoch: the same tags and steps, the same
    values (Throughput's are wall-clock and differ); with validation,
    L2 clipping and renamed columns."""
    jm, tm = _dense_pair()
    df, vdf = _frame(64), _frame(32, seed=1)
    ests = {}
    for pkg, est_cls, opt, met, every in (
            ("jax", JNNEstimator, jopt, jmetrics, JEveryEpoch),
            ("torch", NNEstimator, topt, tmetrics, EveryEpoch)):
        est = (est_cls(jm if pkg == "jax" else tm, LOSS)
               .setFeaturesCol("f").setLabelCol("y").setBatchSize(8)
               .setMaxEpoch(4).setOptimMethod(opt.Adam(lr=1e-2))
               .setValidation(every(), vdf, [met.SparseCategoricalAccuracy()], 8)
               .set_tensorboard(str(tmp_path / pkg), "app"))
        est.set_gradient_clipping_by_l2_norm(0.5)
        ests[pkg] = (est, est.fit(df))
    (jest, jmodel), (test, tmodel) = ests["jax"], ests["torch"]
    for t, j in zip(test.fitted_estimator.history,
                    jest.fitted_estimator.history):
        np.testing.assert_allclose(t["loss"], j["loss"], atol=STEP_ATOL)
        assert t["val"].keys() == j["val"].keys()
        for k in j["val"]:
            assert t["val"][k] == pytest.approx(j["val"][k], abs=1e-6)
    for kinds in ((TrainSummary, JTrainSummary),
                  (ValidationSummary, JValidationSummary)):
        tags = ("Loss", "Throughput") if kinds[0] is TrainSummary else \
            tuple(jest.fitted_estimator.history[0]["val"])
        for tag in tags:
            got = kinds[0](str(tmp_path / "torch"), "app").read_scalar(tag)
            want = kinds[1](str(tmp_path / "jax"), "app").read_scalar(tag)
            assert [s for s, _ in got] == [s for s, _ in want], tag
            assert got, tag
            if tag != "Throughput":
                np.testing.assert_allclose([v for _, v in got],
                                           [v for _, v in want],
                                           atol=STEP_ATOL, rtol=0)
    # each epoch of 8 steps is one dispatch (the HBM epoch route), so the
    # count crosses 20 in the dispatch that ends at 24
    assert [s for s, _ in TrainSummary(str(tmp_path / "torch"), "app")
            .read_scalar("Loss")] == [24]
    assert os.listdir(tmp_path / "torch" / "app" / "train")
    np.testing.assert_allclose(
        np.stack(tmodel.transform(vdf)["prediction"].to_numpy()),
        np.stack(jmodel.transform(vdf)["prediction"].to_numpy()),
        atol=PREDICT_ATOL, rtol=0)


def test_save_and_load_round_trips(tmp_path):
    """``NNEstimator.save``/``load`` and ``NNModel.save``/``load`` (the
    classifier's model class kept): the loaded objects predict what the
    saved ones did, the pickle holds CPU tensors, and the live model keeps
    its variables."""
    _, tm = _dense_pair()
    df = _frame(48)
    clf = (NNClassifier(tm, LOSS).setFeaturesCol("f").setLabelCol("y")
           .setBatchSize(16).setMaxEpoch(2)
           .setOptimMethod(topt.Adam(lr=1e-2)))
    model = clf.fit(df)
    want = model.transform(df)["prediction"].to_numpy()
    before = tm.get_variables()
    model.save(str(tmp_path / "m"))
    assert tm.get_variables() is before
    with open(tmp_path / "m" / "payload.pkl", "rb") as f:
        saved = pickle.load(f)["model"].get_variables()
    assert all(t.device.type == "cpu" and isinstance(t, torch.Tensor)
               for layer in saved["params"].values() for t in layer.values())
    loaded = NNModel.load(str(tmp_path / "m"))
    assert type(loaded) is NNClassifierModel
    assert loaded.features_col == "f" and loaded.batch_size == 16
    np.testing.assert_array_equal(
        loaded.transform(df)["prediction"].to_numpy(), want)
    raw = NNModel(tm).set_features_col("f")
    raw.save(str(tmp_path / "raw"))
    np.testing.assert_array_equal(
        np.stack(NNModel.load(str(tmp_path / "raw")).transform(df)
                 ["prediction"].to_numpy()),
        np.stack(raw.transform(df)["prediction"].to_numpy()))

    clf.save(str(tmp_path / "est"))
    est = NNEstimator.load(str(tmp_path / "est"))
    assert type(est) is NNClassifier
    assert (est.features_col, est.label_col, est.batch_size,
            est.max_epoch) == ("f", "y", 16, 2)
    np.testing.assert_allclose(est.model.predict(np.stack(df["f"])),
                               tm.predict(np.stack(df["f"])), atol=0)
    # the loaded estimator trains on
    refit = est.set_max_epoch(1).fit(df)
    assert np.isfinite(est.fitted_estimator.history[0]["loss"])
    assert len(refit.transform(df)) == len(df)


class _Column:
    """The column surface the estimators read: ``iloc``, iteration,
    ``to_numpy``."""

    def __init__(self, values):
        self._values = list(values)
        self.iloc = self._values

    def __iter__(self):
        return iter(self._values)

    def to_numpy(self):
        return np.asarray(self._values)


class _Frame:
    def __init__(self, columns):
        self._cols = dict(columns)

    @property
    def columns(self):
        return list(self._cols)

    def __getitem__(self, name):
        return _Column(self._cols[name])

    def __setitem__(self, name, values):
        self._cols[name] = list(values)

    def copy(self):
        return _Frame(self._cols)


def test_a_frame_that_is_not_pandas():
    """The estimators read only the duck-typed surface: a dict-backed
    frame fits and transforms as the pandas frame does."""
    _, tm = _dense_pair()
    df = _frame(32)
    mine = _Frame({"f": list(df["f"]), "y": list(df["y"])})
    clf = (NNClassifier(tm, LOSS).setFeaturesCol("f").setLabelCol("y")
           .setBatchSize(8).setMaxEpoch(1))
    model = clf.fit(mine)
    got = model.transform(mine)
    assert got.columns == ["f", "y", "prediction"]
    assert mine.columns == ["f", "y"]
    np.testing.assert_array_equal(
        got["prediction"].to_numpy(),
        model.transform(df)["prediction"].to_numpy())


def test_image_reader_matches_reference(tmp_path):
    rs = np.random.RandomState(3)
    for i in range(3):
        img = rs.randint(0, 256, (10 + i, 12, 3)).astype(np.uint8)
        cv2.imwrite(str(tmp_path / f"{i}.jpg"), img)
    os.makedirs(tmp_path / "sub")
    cv2.imwrite(str(tmp_path / "sub" / "s.png"),
                rs.randint(0, 256, (7, 5, 3)).astype(np.uint8))
    for kw in ({}, {"resize_h": 8, "resize_w": 6},
               {"pattern": "*.png"}):
        got = NNImageReader.read_images(str(tmp_path), **kw)
        want = JNNImageReader.readImages(str(tmp_path), **kw)
        assert list(got.columns) == list(want.columns) == [
            "origin", "height", "width", "n_channels", "mode", "data"]
        assert len(got) == len(want) > 0
        for (_, g), (_, w) in zip(got.iterrows(), want.iterrows()):
            for col in ("origin", "height", "width", "n_channels", "mode"):
                assert g[col] == w[col]
            assert g["data"].dtype == np.float32
            np.testing.assert_array_equal(g["data"], w["data"])
