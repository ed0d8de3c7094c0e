"""PyTorch port, the whole serving slice: a transformer TextClassifier
built in both packages, the JAX weights carried over with
``load_jax_variables``, and ``InferenceModel.predict`` compared on one
integer batch, with a batch size that divides it and one that pads."""

import numpy as np
import pytest
import torch

import jax

from analytics_zoo_tpu.models.textclassification.text_classifier import (
    TextClassifier as JTextClassifier,
)
from analytics_zoo_tpu.ops import dtypes as jdtypes
from analytics_zoo_tpu.pipeline.api.keras.engine import Layer as JLayer
from analytics_zoo_tpu.pipeline.inference.inference_model import (
    InferenceModel as JInferenceModel,
)

from analytics_zoo_torch.common import config as tconfig
from analytics_zoo_torch.common import zoo_context as tctx
from analytics_zoo_torch.interop import load_jax_variables
from analytics_zoo_torch.models.textclassification import TextClassifier
from analytics_zoo_torch.ops import dtypes as tdtypes
from analytics_zoo_torch.ops import kernels
from analytics_zoo_torch.pipeline.api.keras.engine import Layer as TLayer
from analytics_zoo_torch.pipeline.inference import InferenceModel

CONFIG = dict(class_num=5, token_length=128, sequence_length=256,
              encoder="transformer", n_head=2, n_block=2, max_words_num=100)

# Under the default policy both packages round every product's operands
# to bf16.  The roundings are the same operations, but their inputs come
# out of f32 sums taken in different orders (XLA vs PyTorch); where two
# such sums straddle a bf16 rounding boundary, one operand moves by one
# bf16 step (2^-8 relative) and carries through the following layers.
# Seen on the CPU: 2.9e-3 on logits of magnitude 0.77; bound 1e-2.
BF16_ATOL = 1e-2


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


def _key_paths(tree, prefix=()):
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in
                _key_paths(tree[k], prefix + (k,))]
    return [(prefix, tuple(tree.shape))]


def _both_models():
    JLayer.reset_name_counters()
    jmodel = JTextClassifier(**CONFIG)
    jvars = jax.tree_util.tree_map(np.asarray, jmodel.get_variables())
    TLayer.reset_name_counters()
    tmodel = TextClassifier(**CONFIG)
    load_jax_variables(tmodel, jvars)
    return jmodel, tmodel


def _tokens():
    return np.random.RandomState(0).randint(0, 101, size=(4, 256))


def _predict_both(batch_size):
    jmodel, tmodel = _both_models()
    assert _key_paths(jmodel.get_variables()["params"]) == \
        _key_paths(tmodel.get_variables()["params"])
    x = _tokens()
    want = JInferenceModel().load_zoo(jmodel).predict(x, batch_size=batch_size)
    got = InferenceModel().load_zoo(tmodel).predict(x, batch_size=batch_size)
    assert got.shape == want.shape == (4, 5)
    assert np.isfinite(got).all()
    assert sum(kernels.launch_counts().values()) == 0
    return got, np.asarray(want)


@pytest.mark.parametrize("batch_size", [4, 3])
def test_slice_matches_reference_f32(f32_policy, batch_size):
    tdtypes.set_policy(param_dtype="float32", compute_dtype="float32")
    got, want = _predict_both(batch_size)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("batch_size", [4, 3])
def test_slice_matches_reference_bf16_compute(batch_size):
    assert jdtypes.get_policy().compute_dtype == jax.numpy.bfloat16
    assert tdtypes.get_policy().compute_dtype == torch.bfloat16
    got, want = _predict_both(batch_size)
    np.testing.assert_allclose(got, want, atol=BF16_ATOL, rtol=0)


def test_key_paths_and_shapes_match_reference():
    jmodel, tmodel = _both_models()
    jparams = jmodel.get_variables()["params"]
    tparams = tmodel.get_variables()["params"]
    assert _key_paths(jparams) == _key_paths(tparams)
    assert "multiheadselfattention_1" in tparams
    assert tuple(tparams["multiheadselfattention_1"]["qkv_kernel"].shape) \
        == (128, 384)
    for layer, params in tparams.items():
        for name, t in params.items():
            np.testing.assert_array_equal(t.numpy(),
                                          np.asarray(jparams[layer][name]))


def test_carry_over_rejects_a_different_tree():
    _, tmodel = _both_models()
    good = {"params": {k: {p: t.numpy() for p, t in v.items()}
                       for k, v in tmodel.get_variables()["params"].items()},
            "state": {k: {} for k in tmodel.get_variables()["state"]}}
    bad = {**good, "params": dict(good["params"])}
    del bad["params"]["dense_1"]
    with pytest.raises(ValueError, match="missing keys"):
        load_jax_variables(tmodel, bad)
    bad["params"] = {**good["params"], "extra_1": {}}
    with pytest.raises(ValueError, match="extra keys"):
        load_jax_variables(tmodel, bad)
    bad["params"] = {**good["params"],
                     "dense_1": {**good["params"]["dense_1"],
                                 "kernel": np.zeros((3, 3), np.float32)}}
    with pytest.raises(ValueError, match="shape"):
        load_jax_variables(tmodel, bad)
    bad["params"]["dense_1"]["kernel"] = \
        good["params"]["dense_1"]["kernel"].astype(np.float64)
    with pytest.raises(ValueError, match="dtype"):
        load_jax_variables(tmodel, bad)
    load_jax_variables(tmodel, good)


def test_get_and_set_weights_round_trip():
    jmodel, tmodel = _both_models()
    weights = tmodel.get_weights()
    ref = jmodel.model.get_weights()
    assert [w.shape for w in weights] == [w.shape for w in ref]
    for a, b in zip(weights, ref):
        np.testing.assert_array_equal(a, b)
    tmodel.set_weights([w * 2 for w in weights])
    for a, b in zip(tmodel.get_weights(), ref):
        np.testing.assert_array_equal(a, b * 2)
    with pytest.raises(ValueError, match="arrays"):
        tmodel.set_weights(weights[:-1])


def test_cnn_encoder_matches_reference(f32_policy):
    """The cnn encoder (Convolution1D → global max-pool) under this file's
    CONFIG widths, served through ``InferenceModel`` in both packages."""
    tdtypes.set_policy(param_dtype="float32", compute_dtype="float32")
    cnn = {**CONFIG, "encoder": "cnn", "encoder_output_dim": 64}
    JLayer.reset_name_counters()
    jmodel = JTextClassifier(**cnn)
    TLayer.reset_name_counters()
    tmodel = TextClassifier(**cnn)
    load_jax_variables(tmodel, jax.tree_util.tree_map(
        np.asarray, jmodel.get_variables()))
    x = _tokens()
    want = JInferenceModel().load_zoo(jmodel).predict(x, batch_size=3)
    got = InferenceModel().load_zoo(tmodel).predict(x, batch_size=3)
    assert got.shape == (4, 5)
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-6, rtol=0)


RECURRENT = {**CONFIG, "encoder_output_dim": 64}


def _recurrent_models(encoder):
    cfg = {**RECURRENT, "encoder": encoder}
    JLayer.reset_name_counters()
    jmodel = JTextClassifier(**cfg)
    TLayer.reset_name_counters()
    tmodel = TextClassifier(**cfg)
    load_jax_variables(tmodel, jax.tree_util.tree_map(
        np.asarray, jmodel.get_variables()))
    return jmodel, tmodel


@pytest.mark.parametrize("encoder", ["lstm", "gru"])
def test_recurrent_encoder_matches_reference(f32_policy, encoder):
    """The lstm/gru encoders (one recurrent layer over the 256 embedded
    tokens, its last hidden state the encoding) at this file's CONFIG
    widths, served through ``InferenceModel`` in both packages."""
    tdtypes.set_policy(param_dtype="float32", compute_dtype="float32")
    jmodel, tmodel = _recurrent_models(encoder)
    layer = f"{encoder}_1"
    gates = {"lstm": 4, "gru": 3}[encoder]
    assert tuple(tmodel.get_variables()["params"][layer][
        "recurrent_kernel"].shape) == (64, gates * 64)
    x = _tokens()
    want = JInferenceModel().load_zoo(jmodel).predict(x, batch_size=3)
    got = InferenceModel().load_zoo(tmodel).predict(x, batch_size=3)
    assert got.shape == (4, 5)
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-6, rtol=0)
    assert sum(kernels.launch_counts().values()) == 0


def test_lstm_weight_only_int8_matches_reference(f32_policy):
    """``quantize=True`` on the lstm model: every float32 leaf of rank >= 2
    and >= 1024 elements (the recurrent kernels among them) int8 with
    per-column scales, dequantized in each predict, as the reference."""
    tdtypes.set_policy(param_dtype="float32", compute_dtype="float32")
    jmodel, tmodel = _recurrent_models("lstm")
    x = _tokens()
    want = JInferenceModel().load_zoo(jmodel, quantize=True).predict(
        x, batch_size=4)
    im = InferenceModel().load_zoo(tmodel, quantize=True)
    lstm = im._variables["params"]["lstm_1"]
    assert lstm["kernel"].dtype == lstm["recurrent_kernel"].dtype == \
        torch.int8
    got = im.predict(x, batch_size=4)
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-6, rtol=0)


def test_lstm_calibrated_int8_carries_the_reference_recurrent_quirk(
        f32_policy):
    """The reference's ``quantize_model`` turns every tapped layer's
    ``kernel`` int8, the LSTM's included, but its recurrent product
    applies no scale: the LSTM multiplies by the raw int8 values.  The
    port follows the reference on purpose (ROADMAP.md, queue 3): equal
    int8 params, equal logits, and logits far from float32's."""
    tdtypes.set_policy(param_dtype="float32", compute_dtype="float32")
    jmodel, tmodel = _recurrent_models("lstm")
    x = _tokens()
    calib = np.random.RandomState(1).randint(0, 101, size=(8, 256))
    kw = dict(quantize="calibrated", calib_set=calib, calib_batch_size=4,
              calib_batches=2)
    jq = JInferenceModel().load_zoo(jmodel, **kw)
    tq = InferenceModel().load_zoo(tmodel, **kw)
    jparams = jq._variables["params"]
    tparams = tq._variables["params"]
    quantized = sorted(k for k, p in tparams.items() if "kernel_scale" in p)
    assert quantized == sorted(k for k, p in jparams.items()
                               if "kernel_scale" in p)
    assert "lstm_1" in quantized
    for layer in quantized:
        for name in ("kernel", "kernel_scale"):
            np.testing.assert_array_equal(
                tparams[layer][name].numpy(),
                np.asarray(jparams[layer][name]), err_msg=(layer, name))
    # the LSTM's input range is the embedding's rows, exact in both; the
    # Denses after it see the recurrence's float32 sums, taken in
    # another order (one ulp seen)
    np.testing.assert_array_equal(tparams["lstm_1"]["act_scale"].numpy(),
                                  np.asarray(jparams["lstm_1"]["act_scale"]))
    for layer in quantized:
        np.testing.assert_allclose(tparams[layer]["act_scale"].numpy(),
                                   np.asarray(jparams[layer]["act_scale"]),
                                   rtol=1e-6, atol=0, err_msg=layer)
    assert tparams["lstm_1"]["kernel"].dtype == torch.int8
    assert tparams["lstm_1"]["recurrent_kernel"].dtype == torch.float32
    got = tq.predict(x, batch_size=4)
    np.testing.assert_allclose(got, np.asarray(jq.predict(x, batch_size=4)),
                               atol=1e-6, rtol=0)
    # the reference's calibrated tree itself, carried by interop into a
    # float32 port model, runs quantized to the same logits
    JLayer.reset_name_counters()
    TLayer.reset_name_counters()
    carried = TextClassifier(**{**RECURRENT, "encoder": "lstm"})
    load_jax_variables(carried, jax.tree_util.tree_map(
        np.asarray, jq._variables))
    assert carried.get_variables()["params"]["lstm_1"]["kernel"].dtype == \
        torch.int8
    np.testing.assert_allclose(
        InferenceModel().load_zoo(carried).predict(x, batch_size=4), got,
        atol=1e-6, rtol=0)
    f32 = InferenceModel().load_zoo(tmodel).predict(x, batch_size=4)
    # a scaled int8 product stays inside the bar of 0.1 of the float32
    # logits' scale that test_torch_quant.py holds calibrated models to;
    # the raw one does not (seen: 1.19)
    rel = np.abs(got - f32).max() / np.abs(f32).max()
    assert rel > 0.5, rel


def test_inference_paths_not_ported_raise():
    """``load_torch`` and ``load_tf`` are ported now (they raised before
    the interop slice; ``tests/test_torch_net.py`` and
    ``test_torch_tfpark.py`` hold them to the reference): ``load_torch``
    serves a module as its own forward does, and ``load_tf`` of a path
    that holds no SavedModel raises rather than serving."""
    module = torch.nn.Sequential(torch.nn.Linear(3, 2))
    x = np.random.RandomState(0).randn(4, 3).astype(np.float32)
    got = InferenceModel().load_torch(module, (3,)).predict(x)
    with torch.no_grad():
        want = module(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    with pytest.raises((ImportError, OSError)):
        InferenceModel().load_tf("model_dir")
