"""PyTorch port, ``LocalEstimator`` against the JAX package's on the CPU.

Both packages start from the JAX package's initial weights (loaded into
the port with ``load_jax_variables``), take the same numpy batches and
run under the float32 policy; every dropout rate is 0 (the frameworks
draw other random numbers).

- ``fit`` on a small ``Sequential`` and on a 2-block transformer
  ``TextClassifier``: the per-epoch ``history`` losses within 1e-4 (the
  reference's cross-program float32 tolerance), the params after one
  step within 1e-6, ``evaluate`` and ``predict`` within 1e-6.
- The ``DataPipeline`` route: the same batches, the same losses.
- The step takes the optimizer's own update, never the fused one: a
  ``fused_adam`` launch, or a call into the fused update, fails the test.
- Frozen layers keep their params bit for bit, and ``train.remat`` takes
  the same steps."""

import jax
import numpy as np
import pytest
import torch

from analytics_zoo_tpu.common import config as jconfig
from analytics_zoo_tpu.data import DataPipeline as JDataPipeline
from analytics_zoo_tpu.models.textclassification.text_classifier import (
    TextClassifier as JTextClassifier)
from analytics_zoo_tpu.ops import dtypes as jdtypes
from analytics_zoo_tpu.pipeline.api.keras import Sequential as JSequential
from analytics_zoo_tpu.pipeline.api.keras.engine import Layer as JLayer
from analytics_zoo_tpu.pipeline.api.keras.layers import Dense as JDense
from analytics_zoo_tpu.pipeline.api.keras.optimizers import (
    SGD as JSGD, Adam as JAdam)
from analytics_zoo_tpu.pipeline.estimator import (
    LocalEstimator as JLocalEstimator)

from analytics_zoo_torch.common import config as tconfig
from analytics_zoo_torch.common import zoo_context as tctx
from analytics_zoo_torch.data import DataPipeline
from analytics_zoo_torch.interop import load_jax_variables
from analytics_zoo_torch.models.textclassification import TextClassifier
from analytics_zoo_torch.ops import dtypes as tdtypes
from analytics_zoo_torch.ops import fused, kernels
from analytics_zoo_torch.pipeline.api.keras import Sequential
from analytics_zoo_torch.pipeline.api.keras.engine import Layer as TLayer
from analytics_zoo_torch.pipeline.api.keras.layers import Dense
from analytics_zoo_torch.pipeline.api.keras.optimizers import SGD, Adam
from analytics_zoo_torch.pipeline.api.keras.topology import tree_leaves
from analytics_zoo_torch.pipeline.estimator import LocalEstimator

LOSS_ATOL = 1e-4     # multi-step losses: the reference's f32 tolerance
ONE_STEP_ATOL = 1e-6  # one step's params, evaluate, predict
CLS = "sparse_categorical_crossentropy_with_logits"
TEXT = dict(class_num=5, token_length=32, sequence_length=48,
            encoder="transformer", n_head=2, n_block=2, max_words_num=60)


@pytest.fixture(autouse=True)
def _port_cpu():
    tctx.reset_zoo_context()
    tconfig.reset_config()
    tdtypes.restore_policy(None)
    tctx.init_zoo_context(device="cpu")
    kernels.reset_launch_counts()
    tdtypes.set_policy(param_dtype="float32", compute_dtype="float32")
    jdtypes.set_policy(param_dtype="float32", compute_dtype="float32")
    yield
    tdtypes.restore_policy(None)
    jdtypes.restore_policy(None)
    tctx.reset_zoo_context()
    tconfig.reset_config()
    jconfig.reset_config()


def _dense_pair():
    JLayer.reset_name_counters()
    jm = JSequential()
    jm.add(JDense(16, activation="relu", input_shape=(8,)))
    jm.add(JDense(3))
    TLayer.reset_name_counters()
    tm = Sequential()
    tm.add(Dense(16, activation="relu", input_shape=(8,)))
    tm.add(Dense(3))
    load_jax_variables(tm, jax.tree_util.tree_map(
        np.asarray, jm.get_variables()))
    return jm, tm


def _dense_data(n=96):
    rs = np.random.RandomState(0)
    return (rs.randn(n, 8).astype(np.float32),
            rs.randn(n, 3).astype(np.float32))


def _zero_dropout(model):
    for layer in model.model.layers:
        if hasattr(layer, "p"):
            layer.p = 0.0
        if hasattr(layer, "attn_dropout"):
            layer.attn_dropout = 0.0


def _text_pair():
    JLayer.reset_name_counters()
    jm = JTextClassifier(**TEXT)
    _zero_dropout(jm)
    TLayer.reset_name_counters()
    tm = TextClassifier(**TEXT)
    _zero_dropout(tm)
    load_jax_variables(tm, jax.tree_util.tree_map(
        np.asarray, jm.get_variables()))
    return jm.model, tm.model


def _text_data(n=32):
    rs = np.random.RandomState(3)
    return (rs.randint(0, 61, size=(n, TEXT["sequence_length"])),
            rs.randint(0, 5, size=(n,)))


def _assert_params_close(jmodel, tmodel, atol):
    jl = [np.asarray(a) for a in
          jax.tree_util.tree_leaves(jmodel.get_variables()["params"])]
    tl = [a.detach().numpy() for a in
          tree_leaves(tmodel.get_variables()["params"])]
    assert len(jl) == len(tl)
    for j, t in zip(jl, tl):
        np.testing.assert_allclose(t, j, atol=atol, rtol=0)


def _histories(jle, tle):
    assert [r["epoch"] for r in tle.history] == \
        [r["epoch"] for r in jle.history]
    np.testing.assert_allclose([r["loss"] for r in tle.history],
                               [r["loss"] for r in jle.history],
                               atol=LOSS_ATOL, rtol=0)


# ------------------------------------------------------------- Sequential
@pytest.mark.parametrize("optim", ["sgd", "adam"])
def test_one_step_params_match_the_reference(optim):
    jm, tm = _dense_pair()
    x, y = _dense_data(32)
    make = {"sgd": (lambda: JSGD(0.1), lambda: SGD(0.1)),
            "adam": (lambda: JAdam(1e-2), lambda: Adam(1e-2))}[optim]
    jle = JLocalEstimator(jm, "mse", make[0]())
    tle = LocalEstimator(tm, "mse", make[1]())
    jle.fit(x, y, batch_size=32, epochs=1)    # exactly one step
    tle.fit(x, y, batch_size=32, epochs=1)
    _histories(jle, tle)
    _assert_params_close(jm, tm, ONE_STEP_ATOL)


def test_fit_evaluate_predict_match_the_reference():
    jm, tm = _dense_pair()
    x, y = _dense_data()
    jle = JLocalEstimator(jm, "mse", JAdam(1e-2), metrics=["mae"])
    tle = LocalEstimator(tm, "mse", Adam(1e-2), metrics=["mae"])
    jle.fit(x, y, validation_data=(x, y), batch_size=16, epochs=3)
    tle.fit(x, y, validation_data=(x, y), batch_size=16, epochs=3)
    _histories(jle, tle)
    for jr, tr in zip(jle.history, tle.history):
        assert set(tr["val"]) == set(jr["val"])
        for k in jr["val"]:
            assert tr["val"][k] == pytest.approx(jr["val"][k],
                                                 abs=LOSS_ATOL)
    # after the fit both models hold their trained variables: the
    # evaluate and predict of the same weights agree to 1e-6
    load_jax_variables(tm, jax.tree_util.tree_map(
        np.asarray, jm.get_variables()))
    want = jle.evaluate(x, y, batch_size=20)
    got = tle.evaluate(x, y, batch_size=20)
    assert set(got) == set(want)
    for k in want:
        assert got[k] == pytest.approx(want[k], abs=ONE_STEP_ATOL)
    np.testing.assert_allclose(tle.predict(x, batch_size=40),
                               np.asarray(jle.predict(x, batch_size=40)),
                               atol=ONE_STEP_ATOL, rtol=0)


def test_the_step_takes_the_optimizers_own_update(monkeypatch):
    """The reference's step calls ``optim.update``: never the fused
    update, which only the DistributedTrainer takes."""
    def refuse(*a, **k):
        raise AssertionError("LocalEstimator reached the fused update")
    monkeypatch.setattr(fused, "build_fused_update", refuse)
    monkeypatch.setattr(fused, "adam_multi_update", refuse)
    monkeypatch.setattr(fused, "adam_leaf_update", refuse)
    _, tm = _dense_pair()
    x, y = _dense_data()
    le = LocalEstimator(tm, "mse", Adam(1e-2))
    le.fit(x, y, batch_size=16, epochs=2)
    assert len(le.history) == 2
    assert kernels.launch_counts().get("fused_adam", 0) == 0


def test_the_model_keeps_its_variables_until_the_end():
    """fit trains on copies: the model's own tensors are never written,
    and the trained values reach the model when fit returns."""
    _, tm = _dense_pair()
    before = [t.clone() for t in tree_leaves(tm.get_variables()["params"])]
    held = tree_leaves(tm.get_variables()["params"])
    x, y = _dense_data()
    LocalEstimator(tm, "mse", SGD(0.1)).fit(x, y, batch_size=16)
    for b, h in zip(before, held):
        assert torch.equal(b, h)
    after = tree_leaves(tm.get_variables()["params"])
    assert any(not torch.equal(b, a) for b, a in zip(before, after))


def test_frozen_layers_and_remat_as_in_the_reference():
    jm, tm = _dense_pair()
    first = tm.layers[0].name
    jm.freeze(first)
    tm.freeze(first)
    frozen = {k: v.clone() for k, v in
              tm.get_variables()["params"][first].items()}
    jconfig.get_config().set("train.remat", True)
    tconfig.get_config().set("train.remat", True)
    x, y = _dense_data()
    jle = JLocalEstimator(jm, "mse", JSGD(0.1))
    tle = LocalEstimator(tm, "mse", SGD(0.1))
    jle.fit(x, y, batch_size=16, epochs=2)
    tle.fit(x, y, batch_size=16, epochs=2)
    _histories(jle, tle)
    for k, v in tm.get_variables()["params"][first].items():
        assert torch.equal(v, frozen[k])
    _assert_params_close(jm, tm, LOSS_ATOL)


# ------------------------------------------------------- TextClassifier
def test_transformer_text_classifier_matches_the_reference():
    jm, tm = _text_pair()
    x, y = _text_data()
    # one SGD step: the params within 1e-6
    jle = JLocalEstimator(jm, CLS, JSGD(0.05))
    tle = LocalEstimator(tm, CLS, SGD(0.05))
    jle.fit(x[:16], y[:16], batch_size=16, epochs=1)
    tle.fit(x[:16], y[:16], batch_size=16, epochs=1)
    _histories(jle, tle)
    _assert_params_close(jm, tm, ONE_STEP_ATOL)
    # then Adam epochs from the same weights: the losses within 1e-4
    jle = JLocalEstimator(jm, CLS, JAdam(1e-3), metrics=["accuracy"])
    tle = LocalEstimator(tm, CLS, Adam(1e-3), metrics=["accuracy"])
    jle.fit(x, y, batch_size=8, epochs=2)
    tle.fit(x, y, batch_size=8, epochs=2)
    _histories(jle, tle)
    load_jax_variables(tm, jax.tree_util.tree_map(
        np.asarray, jm.get_variables()))
    np.testing.assert_allclose(tle.predict(x, batch_size=8),
                               np.asarray(jle.predict(x, batch_size=8)),
                               atol=ONE_STEP_ATOL, rtol=0)
    want, got = jle.evaluate(x, y, batch_size=8), \
        tle.evaluate(x, y, batch_size=8)
    for k in want:
        assert got[k] == pytest.approx(want[k], abs=ONE_STEP_ATOL)


# ---------------------------------------------------------- the pipeline
def test_the_pipeline_route_matches_the_reference():
    jm, tm = _dense_pair()
    x, y = _dense_data()
    jp = JDataPipeline(x, y, batch_size=16, seed=5)
    tp = DataPipeline(x, y, batch_size=16, seed=5)
    jle = JLocalEstimator(jm, "mse", JSGD(0.05))
    tle = LocalEstimator(tm, "mse", SGD(0.05))
    jle.fit(jp, None, epochs=3)
    tle.fit(tp, None, epochs=3)
    _histories(jle, tle)
    _assert_params_close(jm, tm, LOSS_ATOL)
    # each epoch consumed the whole pipeline epoch: the positions agree
    assert tp.state_dict() == jp.state_dict()
