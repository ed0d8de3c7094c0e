"""PyTorch port, the training slice: objectives, metrics and FeatureSet
against the JAX package, device-side dropout, and a small transformer
TextClassifier trained in both packages from the same weights — five
``train_step``s, then ``fit`` and ``evaluate`` — compared on the CPU.

Dropout is set to 0 on both models after build (the two frameworks draw
different random numbers), and both run ``dtype.compute=float32`` so the
comparison is of the algorithm, not of bf16 rounding."""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from analytics_zoo_tpu.feature.feature_set import FeatureSet as JFeatureSet
from analytics_zoo_tpu.models.textclassification.text_classifier import (
    TextClassifier as JTextClassifier,
)
from analytics_zoo_tpu.parallel.trainer import (
    ClipSpec as JClip, DistributedTrainer as JTrainer,
)
from analytics_zoo_tpu.pipeline.api.keras import metrics as jmetrics
from analytics_zoo_tpu.pipeline.api.keras import objectives as jobj
from analytics_zoo_tpu.pipeline.api.keras import optimizers as jopt
from analytics_zoo_tpu.pipeline.api.keras.engine import Layer as JLayer

from analytics_zoo_torch.common import config as tconfig
from analytics_zoo_torch.common import zoo_context as tctx
from analytics_zoo_torch.feature import FeatureSet
from analytics_zoo_torch.interop import load_jax_opt_state, load_jax_variables
from analytics_zoo_torch.models.textclassification import TextClassifier
from analytics_zoo_torch.ops import dtypes as tdtypes
from analytics_zoo_torch.ops import kernels
from analytics_zoo_torch.parallel.trainer import (
    ClipSpec, DistributedTrainer, step_generator,
)
from analytics_zoo_torch.pipeline.api.keras import metrics as tmetrics
from analytics_zoo_torch.pipeline.api.keras import objectives as tobj
from analytics_zoo_torch.pipeline.api.keras import optimizers as topt
from analytics_zoo_torch.pipeline.api.keras.engine import Layer as TLayer
from analytics_zoo_torch.pipeline.api.keras.layers import Dropout

LOSS = "sparse_categorical_crossentropy_with_logits"
# Adam moves each element by about lr * m/sqrt(v), whatever the gradient's
# size, so an element whose gradient sits within float32 summation noise
# of zero can move differently in the two packages: at lr 1e-3 over five
# steps, one qkv_bias element of ~1.3M differed by 2.1e-5.  Bound: a tenth
# of one step's lr.
PARAM_ATOL = 1e-4
CONFIG = dict(class_num=5, token_length=128, sequence_length=256,
              encoder="transformer", n_head=2, n_block=2, max_words_num=100)


@pytest.fixture(autouse=True)
def _port_cpu():
    tctx.reset_zoo_context()
    tconfig.reset_config()
    tdtypes.restore_policy(None)
    tctx.init_zoo_context(device="cpu")
    kernels.reset_launch_counts()
    yield
    tdtypes.restore_policy(None)
    tctx.reset_zoo_context()
    tconfig.reset_config()


# ------------------------------------------------ objectives and metrics
@pytest.mark.parametrize("label_shape", ["flat", "column"])
def test_sparse_crossentropy_with_logits_matches_reference(label_shape):
    rs = np.random.RandomState(0)
    logits = (rs.randn(16, 7) * 3).astype(np.float32)
    labels = rs.randint(0, 7, size=16)
    if label_shape == "column":
        labels = labels[:, None]
    want, jgrad = jax.value_and_grad(
        lambda z: jobj.get(LOSS)(jnp.asarray(labels), z))(
            jnp.asarray(logits))
    z = torch.from_numpy(logits).requires_grad_()
    got = tobj.get(LOSS)(torch.from_numpy(labels), z)
    (grad,) = torch.autograd.grad(got, z)
    np.testing.assert_allclose(float(got.detach()), float(want), atol=1e-6,
                               rtol=0)
    np.testing.assert_allclose(grad.numpy(), np.asarray(jgrad), atol=1e-7,
                               rtol=0)
    with pytest.raises(ValueError, match="unknown loss"):
        tobj.get("f1")


def test_metrics_are_exact_under_the_tail_padding_mask():
    rs = np.random.RandomState(1)
    scores = rs.randn(10, 5).astype(np.float32)
    labels = rs.randint(0, 5, size=(10, 1))
    mask = np.array([1] * 7 + [0] * 3, np.float32)
    for jm, tm in ((jmetrics.get("accuracy"), tmetrics.get("accuracy")),
                   (jmetrics.Loss(LOSS), tmetrics.Loss(LOSS))):
        assert tm.name == jm.name
        want = jm.batch_update(jnp.asarray(labels), jnp.asarray(scores),
                               jnp.asarray(mask))
        got = tm.batch_update(torch.from_numpy(labels),
                              torch.from_numpy(scores),
                              torch.from_numpy(mask))
        for g, w in zip(got, want):
            np.testing.assert_allclose(float(g), float(w), atol=1e-5,
                                       rtol=0)
        # the padded rows contribute nothing: same score as the 7 real rows
        real = tm.batch_update(torch.from_numpy(labels[:7]),
                               torch.from_numpy(scores[:7]),
                               torch.ones(7))
        assert tm.finalize(got) == pytest.approx(tm.finalize(real),
                                                 abs=1e-6)
    scores = tmetrics.accumulate(
        [tmetrics.get("acc")],
        [((torch.tensor(3.0), torch.tensor(4.0)),),
         ((torch.tensor(1.0), torch.tensor(4.0)),)])
    assert scores == {"sparse_categorical_accuracy": 0.5}
    # every metric of the reference's registry resolves in the port
    assert isinstance(tmetrics.get("auc"), tmetrics.AUC)
    with pytest.raises(ValueError, match="unknown metric"):
        tmetrics.get("f1")


@pytest.mark.parametrize("seed", [1, 7, 12345])
def test_feature_set_batches_are_the_reference_batches(seed):
    rs = np.random.RandomState(2)
    x = rs.randint(0, 100, size=(37, 6))
    y = rs.randint(0, 5, size=(37,))
    jfs = JFeatureSet.from_ndarrays(x, y, seed=seed)
    tfs = FeatureSet.from_ndarrays(x, y, seed=seed)
    for epoch in range(3):
        np.testing.assert_array_equal(tfs._epoch_perm(epoch),
                                      jfs._epoch_perm(epoch))
    for train in (True, False):
        assert tfs.num_batches(8, train) == jfs.num_batches(8, train)
        pairs = list(zip(tfs.epoch_batches(2, 8, train),
                         jfs.epoch_batches(2, 8, train)))
        assert len(pairs) == jfs.num_batches(8, train)
        for got, want in pairs:
            assert len(got) == len(want)
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g, w)
    with pytest.raises(ValueError, match="samples"):
        FeatureSet.from_ndarrays(x, y[:5])


def test_feature_set_default_seed_is_the_config_seed():
    x = np.arange(20).reshape(10, 2)
    assert FeatureSet.from_ndarrays(x).seed == \
        JFeatureSet.from_ndarrays(x).seed == 1


# --------------------------------------------------------------- dropout
def test_dropout_draws_on_the_input_device_with_rate_and_scaling():
    layer = Dropout(0.3)
    x = torch.full((200, 500), 2.0)
    gen = step_generator(5, 0, x.device)
    assert gen.device == x.device
    out = layer.call({}, x, training=True, rng=gen)
    dropped = float((out == 0).float().mean())
    assert abs(dropped - 0.3) < 0.01          # 100k draws: sd 0.0015
    kept = out[out != 0]
    torch.testing.assert_close(kept, torch.full_like(kept, 2.0 / 0.7))
    again = layer.call({}, x, training=True, rng=step_generator(5, 0, "cpu"))
    assert torch.equal(out, again)
    other = layer.call({}, x, training=True, rng=step_generator(5, 1, "cpu"))
    assert not torch.equal(out, other)
    # inference never draws
    assert layer.call({}, x, training=False, rng=None) is x
    with pytest.raises(ValueError, match="rng"):
        layer.call({}, x, training=True, rng=None)


# ------------------------------------------------------ the slice, whole
def _zero_dropout(model):
    for layer in model.model.layers:
        if hasattr(layer, "p"):
            layer.p = 0.0
        if hasattr(layer, "attn_dropout"):
            layer.attn_dropout = 0.0


def _both_models():
    JLayer.reset_name_counters()
    jmodel = JTextClassifier(**CONFIG)
    _zero_dropout(jmodel)
    TLayer.reset_name_counters()
    tmodel = TextClassifier(**CONFIG)
    _zero_dropout(tmodel)
    load_jax_variables(tmodel, jax.tree_util.tree_map(
        np.asarray, jmodel.get_variables()))
    return jmodel, tmodel


def _data(n=32):
    rs = np.random.RandomState(3)
    return (rs.randint(0, 101, size=(n, 256)),
            rs.randint(0, 5, size=(n,)))


def _f32(f32_policy):
    tdtypes.set_policy(param_dtype="float32", compute_dtype="float32")


def _assert_params_close(tparams, jparams, atol):
    for layer in sorted(jparams):
        for name in sorted(jparams[layer]):
            np.testing.assert_allclose(
                tparams[layer][name].detach().numpy(),
                np.asarray(jparams[layer][name]), atol=atol, rtol=0,
                err_msg=f"{layer}/{name}")


def test_train_steps_match_reference_and_resume_from_carried_state(
        f32_policy):
    """Five steps of Adam with an l2-norm clip in both packages; then the
    port resumes from the JAX run's params and optimizer state and both
    take two more steps."""
    _f32(f32_policy)
    jmodel, tmodel = _both_models()
    x, y = _data(8)
    jtr = JTrainer(jmodel.model, jobj.get(LOSS),
                   optim_method=jopt.Adam(lr=1e-3), clip=JClip("l2norm", 1.0))
    ttr = DistributedTrainer(tmodel.model, tobj.get(LOSS),
                             optim_method=topt.Adam(lr=1e-3),
                             clip=ClipSpec("l2norm", 1.0))
    assert ttr.fused_optimizer_active
    jv, tv = jmodel.get_variables(), tmodel.get_variables()
    jp, js = jtr.place_params(jv["params"]), jtr.replicate(jv["state"])
    jo = jtr.init_opt_state(jp)
    tp, ts = ttr.place_params(tv["params"]), ttr.replicate(tv["state"])
    to = ttr.init_opt_state(tp)
    jb, tb = jtr.put_batch((x, y)), ttr.put_batch((x, y))
    rng = jax.random.PRNGKey(0)

    def run(steps, jp, jo, js, tp, to, ts):
        for i in range(steps):
            jp, jo, js, jloss = jtr.train_step(jp, jo, js, jb,
                                               jax.random.fold_in(rng, i))
            tp, to, ts, tloss = ttr.train_step(tp, to, ts, tb,
                                               step_generator(0, i, "cpu"))
            assert tloss.dim() == 0 and not tloss.requires_grad
            np.testing.assert_allclose(float(tloss), float(jloss),
                                       atol=1e-4, rtol=0)
        return jp, jo, js, tp, to, ts

    jp, jo, js, tp, to, ts = run(5, jp, jo, js, tp, to, ts)
    _assert_params_close(tp, jax.device_get(jp), atol=PARAM_ATOL)
    assert int(to[0].count) == 5

    carried = load_jax_opt_state(ttr.optim, jax.tree_util.tree_map(
        np.asarray, jax.device_get(jo)))
    tp = ttr.place_params(jax.tree_util.tree_map(
        lambda a: torch.from_numpy(np.array(a)), jax.device_get(jp)))
    jp, jo, js, tp, to, ts = run(2, jp, jo, js, tp, carried, ts)
    _assert_params_close(tp, jax.device_get(jp), atol=PARAM_ATOL)
    assert sum(kernels.launch_counts().values()) == 0


def test_fit_and_evaluate_match_reference(f32_policy):
    _f32(f32_policy)
    jmodel, tmodel = _both_models()
    x, y = _data(32)
    for model, opt in ((jmodel, jopt), (tmodel, topt)):
        out = model.compile(opt.Adam(lr=1e-3), LOSS, metrics=["accuracy"])
        assert out is model
    jhist = jmodel.fit(x, y, batch_size=8, nb_epoch=2)
    thist = tmodel.fit(x, y, batch_size=8, nb_epoch=2)
    assert [h["epoch"] for h in thist] == [h["epoch"] for h in jhist] == [1, 2]
    for t, j in zip(thist, jhist):
        assert set(t) == {"epoch", "loss", "throughput", "wall_s"}
        np.testing.assert_allclose(t["loss"], j["loss"], atol=1e-4, rtol=0)
    jscores = jmodel.evaluate(x, y, batch_size=10)
    tscores = tmodel.evaluate(x, y, batch_size=10)
    assert set(tscores) == set(jscores) == {"loss",
                                            "sparse_categorical_accuracy"}
    np.testing.assert_allclose(tscores["loss"], jscores["loss"], atol=1e-4,
                               rtol=0)
    assert tscores["sparse_categorical_accuracy"] == \
        jscores["sparse_categorical_accuracy"]
    np.testing.assert_allclose(tmodel.predict(x[:5], batch_size=4),
                               np.asarray(jmodel.predict(x[:5],
                                                         batch_size=4)),
                               atol=1e-4, rtol=0)


def test_fit_is_reproducible_with_dropout_and_sgd_clipping(tmp_path):
    """With dropout on, the same fit seed gives the same run; the unfused
    and fused updates agree; validation_split needs ndarray data;
    ``set_tensorboard`` writes the train and validation summaries
    (``tests/test_torch_nnframes.py`` holds their scalars to the
    reference's); ``train.remat`` trains."""
    x, y = _data(16)

    def fit(fused, seed):
        tconfig.get_config().set("train.fused_optimizer", fused)
        TLayer.reset_name_counters()
        model = TextClassifier(**CONFIG)
        model.compile(topt.SGD(0.05, momentum=0.9), LOSS)
        model.model.set_constant_gradient_clipping(-0.1, 0.1)
        hist = model.fit(x, y, batch_size=8, nb_epoch=1, rng=seed)
        return hist[0]["loss"], model.get_weights()

    loss_a, w_a = fit(True, 3)
    loss_b, w_b = fit(True, 3)
    loss_c, w_c = fit(False, 3)
    loss_d, _ = fit(True, 4)
    assert loss_a == loss_b and loss_a == loss_c and loss_a != loss_d
    for a, b, c in zip(w_a, w_b, w_c):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_allclose(a, c, atol=1e-6, rtol=0)

    model = TextClassifier(**CONFIG)
    model.compile("adam", LOSS)
    with pytest.raises(ValueError, match="validation_split"):
        model.fit(FeatureSet.from_ndarrays(x, y), batch_size=8, nb_epoch=1,
                  validation_split=0.25)
    with pytest.raises(ValueError, match="exceeds"):
        model.fit(x, y, batch_size=64, nb_epoch=1)
    from analytics_zoo_torch.pipeline.estimator import Estimator
    est = Estimator(model.model)
    est.set_tensorboard(str(tmp_path), "app")
    assert os.path.isdir(tmp_path / "app" / "train")
    assert os.path.isdir(tmp_path / "app" / "validation")
    # train.remat trains (its step's parity: test_torch_training_switches)
    tconfig.get_config().set("train.remat", True)
    hist = model.fit(x, y, batch_size=8, nb_epoch=1)
    assert np.isfinite(hist[0]["loss"])
