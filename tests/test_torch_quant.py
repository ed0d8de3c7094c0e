"""PyTorch port, int8 inference: the int8 products (``ops/quant.py``)
against the JAX package's on the same numpy inputs, the calibration taps,
``calibrate_model``/``quantize_model`` and the weight-only
``quantize_params``, and the models that run them (NeuralCF both ways,
Wide & Deep, a ``Sequential`` Conv2D + Dense classifier, the transformer
TextClassifier weight-only) through ``quantize``, ``predict``, the
recommender API, ``InferenceModel.load_zoo(quantize=...)`` and both
packages' Cluster Serving CLIs started with ``--quantize``; plus the JAX
package's bars (``tests/test_quant_int8.py``) and a quantized JAX tree
carried over by ``interop``.

Both packages run ``dtype.compute=float32``.  The int8 products are
exact integer arithmetic in both and their epilogues the same float32
operations, so an int8 layer's output is bit-identical; what differs is
the float32 layers around them (other orders of summation)."""

import contextlib
import threading
from unittest import mock

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import analytics_zoo_tpu.serving.client as jclient
import analytics_zoo_tpu.serving.redis_client as jredis
from analytics_zoo_tpu.models.recommendation import (
    ColumnFeatureInfo as JColumnFeatureInfo, NeuralCF as JNeuralCF,
    WideAndDeep as JWideAndDeep,
)
from analytics_zoo_tpu.models.textclassification.text_classifier import (
    TextClassifier as JTextClassifier,
)
from analytics_zoo_tpu.ops import quant as jquant
from analytics_zoo_tpu.pipeline.api.keras import Sequential as JSequential
from analytics_zoo_tpu.pipeline.api.keras import layers as jlayers
from analytics_zoo_tpu.pipeline.api.keras.engine import Layer as JLayer
from analytics_zoo_tpu.pipeline.inference import inference_model as jim
from analytics_zoo_tpu.serving import cli as jcli

import analytics_zoo_torch.serving.client as tclient
import analytics_zoo_torch.serving.redis_client as tredis
from analytics_zoo_torch.common import config as tconfig
from analytics_zoo_torch.common import zoo_context as tctx
from analytics_zoo_torch.interop import load_jax_variables
from analytics_zoo_torch.models.recommendation import (
    ColumnFeatureInfo, NeuralCF, UserItemFeature, WideAndDeep,
)
from analytics_zoo_torch.models.textclassification import TextClassifier
from analytics_zoo_torch.observability import (
    get_registry, get_tracer, reset_registry, reset_tracer,
)
from analytics_zoo_torch.ops import dtypes as tdtypes
from analytics_zoo_torch.ops import kernels
from analytics_zoo_torch.ops import quant as tquant
from analytics_zoo_torch.pipeline.api.keras import Sequential
from analytics_zoo_torch.pipeline.api.keras import layers as tlayers
from analytics_zoo_torch.pipeline.api.keras.engine import (
    Layer as TLayer, record_activations, tap_activation,
)
from analytics_zoo_torch.pipeline.inference import inference_model as tim
from analytics_zoo_torch.serving import cli as tcli

# a whole float32 forward around the int8 layers: the two frameworks sum
# the float32 products in other orders (seen: 3.0e-8 on NCF logits)
PREDICT_ATOL = 1e-6
# the JAX package's int8 bars against float32 (tests/test_quant_int8.py)
PROB_ATOL_INT8 = 2e-2
AGREE_MIN = 0.97
WAIT_S = 30.0


@pytest.fixture(autouse=True)
def _port_cpu(f32_policy):
    tctx.reset_zoo_context()
    tconfig.reset_config()
    tdtypes.restore_policy(None)
    tctx.init_zoo_context(device="cpu")
    tdtypes.set_policy(param_dtype="float32", compute_dtype="float32")
    kernels.reset_launch_counts()
    reset_registry()
    reset_tracer()
    yield
    tdtypes.restore_policy(None)
    tctx.reset_zoo_context()
    tconfig.reset_config()
    reset_registry()
    reset_tracer()


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _shared(jbuild, tbuild):
    """The same model in both packages, the port holding the JAX weights."""
    JLayer.reset_name_counters()
    jmodel = jbuild()
    TLayer.reset_name_counters()
    tmodel = tbuild()
    load_jax_variables(tmodel, _np_tree(jmodel.get_variables()))
    return jmodel, tmodel


def _softmax(z):
    e = np.exp(z - z.max(-1, keepdims=True))
    return e / e.sum(-1, keepdims=True)


# ------------------------------------------------------------ primitives
def test_quantize_activation_saturates_at_127_and_matches_reference():
    x = np.array([1e6, -1e6, 0.0, 1.0, 2.5, -2.5, 3.5, 126.6, -127.4],
                 np.float32)
    want = np.asarray(jquant.quantize_activation(jnp.asarray(x),
                                                 jnp.float32(1.0)))
    got = tquant.quantize_activation(torch.from_numpy(x),
                                     torch.tensor(1.0)).numpy()
    assert got.dtype == np.int8
    np.testing.assert_array_equal(got, want)
    assert got[0] == 127 and got[1] == -127 and -128 not in got
    assert list(got[2:7]) == [0, 1, 2, -2, 4]       # half to even
    x = np.random.RandomState(0).randn(64, 33).astype(np.float32) * 5
    for s in (0.013, 0.0371, 1.7):
        np.testing.assert_array_equal(
            tquant.quantize_activation(torch.from_numpy(x),
                                       torch.tensor(np.float32(s))).numpy(),
            np.asarray(jquant.quantize_activation(jnp.asarray(x),
                                                  jnp.float32(s))))


# (x shape, out): rows below _int_mm's 17, inner and output dims that are
# not multiples of 8, a rank-3 input
MM_SHAPES = [((4, 32), 16), ((1, 13), 2), ((3, 5, 24), 10), ((40, 96), 2)]


@pytest.mark.parametrize("xshape,out", MM_SHAPES)
def test_quantized_matmul_is_bit_identical_to_reference(xshape, out):
    rs = np.random.RandomState(len(xshape) + out)
    x = rs.randn(*xshape).astype(np.float32) * 3
    kq = rs.randint(-127, 128, (xshape[-1], out)).astype(np.int8)
    ks = ((rs.rand(1, out) + 0.1) * 0.01).astype(np.float32)
    a = np.float32(0.0371)
    want = np.asarray(jquant.quantized_matmul(
        jnp.asarray(x), jnp.asarray(kq), jnp.asarray(ks), jnp.asarray(a)))
    got = tquant.quantized_matmul(torch.from_numpy(x), torch.from_numpy(kq),
                                  torch.from_numpy(ks), torch.tensor(a))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    # the card route's construction (padding, _int_mm) on the CPU
    xq = tquant.quantize_activation(torch.from_numpy(x), torch.tensor(a))
    card = tquant._int_mm_card(xq.reshape(-1, xshape[-1]),
                               torch.from_numpy(kq))
    assert torch.equal(card.reshape(*xshape[:-1], out),
                       tquant.int8_matmul(xq, torch.from_numpy(kq)))


def test_card_route_meets_int_mm_cuda_shape_rules():
    """Every ``torch._int_mm`` call the card route makes has more than 16
    rows, inner and output dims that are multiples of 8 and a column-major
    second operand, whatever the operands; the zero padding is sliced off
    the result."""
    real = torch._int_mm
    seen = []

    def checked(a, b):
        seen.append((tuple(a.shape), tuple(b.shape)))
        assert a.shape[0] > 16 and a.shape[1] % 8 == 0 \
            and b.shape[1] % 8 == 0 and a.is_contiguous() \
            and b.t().is_contiguous()
        return real(a, b)

    rs = np.random.RandomState(3)
    with mock.patch.object(torch, "_int_mm", side_effect=checked):
        for m, k, n in ((1, 13, 2), (16, 8, 8), (17, 768, 256), (5, 96, 2),
                        (33, 7, 9)):
            a = torch.from_numpy(rs.randint(-127, 128, (m, k)).astype(
                np.int8))
            b = torch.from_numpy(rs.randint(-127, 128, (k, n)).astype(
                np.int8))
            got = tquant._int_mm_card(a, b)
            assert tuple(got.shape) == (m, n)
            assert torch.equal(got, (a.long() @ b.long()).int())
    assert seen[2] == ((17, 768), (768, 256))       # no padding when it fits
    # quantize_model's kernels are column-major already: no copy a call
    kq = tquant.quantize_model(
        {"params": {"d": {"kernel": torch.randn(96, 40)}}, "state": {}},
        {"d": 1.0}, min_size=1)["params"]["d"]["kernel"]
    assert kq.shape == (96, 40) and kq.t().is_contiguous()
    assert tquant._column_major(kq) is kq


def test_quantized_matmul_dequant_round_trip():
    """Exactly representable inputs: quantize → int32 accumulate →
    rescale reproduces the float32 product (the JAX package's bar)."""
    rs = np.random.RandomState(1)
    w = rs.randint(-127, 128, (32, 16)).astype(np.float32)
    x = rs.randint(-100, 101, (4, 32)).astype(np.float32)
    got = tquant.quantized_matmul(
        torch.from_numpy(x), torch.from_numpy(w.astype(np.int8)),
        torch.ones(1, 16), torch.tensor(1.0))
    np.testing.assert_allclose(got.numpy(), x @ w, rtol=1e-6)


def test_taps_read_nothing_without_a_recorder():
    """No recorder: a tap returns before touching its input (no reduction,
    no host read).  With one: each layer's float input absmax, integer
    inputs skipped."""
    calls = []
    real_abs = torch.Tensor.abs

    def counting_abs(self):
        calls.append(1)
        return real_abs(self)

    x = torch.tensor([[1.0, -3.0]])
    with mock.patch.object(torch.Tensor, "abs", counting_abs):
        tap_activation("a", x)
        assert not calls
        with record_activations() as taps:
            tap_activation("a", x)
            tap_activation("a", [x * 0.5, torch.tensor([-4.0])])
            tap_activation("ids", torch.tensor([7, -9]))
    assert taps == {"a": 4.0}
    assert len(calls) == 3


# ------------------------------------------------------------- NeuralCF
def _ncf_pair(include_mf=True, hidden=(128, 64)):
    kw = dict(class_num=2, user_embed=64, item_embed=64, mf_embed=64,
              hidden_layers=hidden, include_mf=include_mf)
    return _shared(lambda: JNeuralCF(200, 100, **kw),
                   lambda: NeuralCF(200, 100, **kw))


def _ncf_feats(model, n=1024, seed=0):
    rs = np.random.RandomState(seed)
    return model.pair_features(rs.randint(1, 201, n), rs.randint(1, 101, n))


@pytest.mark.parametrize("include_mf", [True, False])
def test_ncf_calibration_and_quantized_params_match_reference(include_mf):
    jmodel, tmodel = _ncf_pair(include_mf)
    feats = _ncf_feats(tmodel)
    jr = jquant.calibrate_model(jmodel.model, feats, batch_size=256,
                                max_batches=4)
    tr = tquant.calibrate_model(tmodel.model, feats, batch_size=256,
                                max_batches=4)
    assert tr == jr                        # every layer's input range
    jq = jquant.quantize_model(jmodel.get_variables(), jr)["params"]
    tq = tquant.quantize_model(tmodel.get_variables(), tr)["params"]
    assert sorted(tq) == sorted(jq)
    n_q = 0
    for layer in jq:
        assert sorted(tq[layer]) == sorted(jq[layer])
        for k, v in jq[layer].items():
            want = np.asarray(v)
            got = tq[layer][k]
            assert got.numpy().dtype == want.dtype and \
                tuple(got.shape) == want.shape, f"{layer}/{k}"
            np.testing.assert_array_equal(got.numpy(), want)
        if "kernel_scale" in jq[layer]:
            n_q += 1
            k = tq[layer]["kernel"]
            s = tq[layer]["kernel_scale"]
            assert k.dtype == torch.int8 and int(k.abs().max()) <= 127
            assert tuple(s.shape) == (1,) * (k.ndim - 1) + (k.shape[-1],)
            assert tq[layer]["act_scale"].shape == () and bool((s > 0).all())
    assert n_q >= 2, "expected at least the two MLP kernels int8"


@pytest.mark.parametrize("include_mf", [True, False])
def test_ncf_quantize_and_predict_match_reference(include_mf):
    jmodel, tmodel = _ncf_pair(include_mf)
    feats = _ncf_feats(tmodel)
    want32 = np.asarray(jmodel.predict(feats, batch_size=256))
    got32 = tmodel.predict(feats, batch_size=256)
    np.testing.assert_allclose(got32, want32, atol=PREDICT_ATOL, rtol=0)

    calls = []
    real = tquant.quantized_matmul
    with mock.patch.object(tquant, "quantized_matmul",
                           side_effect=lambda *a, **k: calls.append(1) or
                           real(*a, **k)):
        assert tmodel.quantize(feats, batch_size=256, max_batches=4) \
            is tmodel
        got = tmodel.predict(feats, batch_size=256)
    jmodel.quantize(feats, batch_size=256, max_batches=4)
    want = np.asarray(jmodel.predict(feats, batch_size=256))
    assert calls, "quantized_matmul never executed"
    assert tmodel.is_quantized and tmodel.model.is_quantized
    np.testing.assert_allclose(got, want, atol=PREDICT_ATOL, rtol=0)
    # the JAX package's bars against float32
    assert np.max(np.abs(_softmax(got32) - _softmax(got))) < PROB_ATOL_INT8
    assert np.mean(np.argmax(got32, -1) == np.argmax(got, -1)) >= AGREE_MIN


def test_recommender_api_runs_quantized():
    jmodel, tmodel = _ncf_pair(hidden=(64, 32))
    feats = _ncf_feats(tmodel, 256, seed=1)
    jmodel.quantize(feats, batch_size=64, max_batches=2)
    tmodel.quantize(feats, batch_size=64, max_batches=2)
    rs = np.random.RandomState(1)
    pairs = list(zip(rs.randint(1, 201, 32), rs.randint(1, 101, 32)))
    from analytics_zoo_tpu.models.recommendation.recommender import (
        UserItemFeature as JUserItemFeature)
    want = jmodel.predict_user_item_pair(
        [JUserItemFeature(int(u), int(i), {}) for u, i in pairs],
        batch_size=32)
    got = tmodel.predict_user_item_pair(
        [UserItemFeature(int(u), int(i), {}) for u, i in pairs],
        batch_size=32)
    assert len(got) == 32
    assert all(p.prediction in (1, 2) for p in got)
    assert [(p.user_id, p.item_id, p.prediction) for p in got] == \
        [(p.user_id, p.item_id, p.prediction) for p in want]
    np.testing.assert_allclose([p.probability for p in got],
                               [p.probability for p in want],
                               atol=PREDICT_ATOL, rtol=0)
    recs = tmodel.recommend_for_user([1, 2], range(1, 101), 5)
    assert sorted(recs) == [1, 2] and all(len(r) == 5 for r in recs.values())


def test_wide_deep_quantizes_and_matches_reference():
    def info(cls):
        return cls(wide_base_cols=["a"], wide_base_dims=[4],
                   embed_cols=["b"], embed_in_dims=[16], embed_out_dims=[8],
                   continuous_cols=["c"])
    jmodel, tmodel = _shared(
        lambda: JWideAndDeep(2, info(JColumnFeatureInfo),
                             model_type="wide_n_deep", hidden_layers=(64, 32)),
        lambda: WideAndDeep(2, info(ColumnFeatureInfo),
                            model_type="wide_n_deep", hidden_layers=(64, 32)))
    rs = np.random.RandomState(0)
    cols = {"a": rs.randint(0, 4, 512), "b": rs.randint(0, 16, 512),
            "c": rs.rand(512).astype(np.float32)}
    feats = tmodel.features_from_columns(cols)
    f32 = tmodel.predict(feats, batch_size=128)
    jmodel.quantize(jmodel.features_from_columns(cols), batch_size=128,
                    max_batches=4)
    tmodel.quantize(feats, batch_size=128, max_batches=4)
    assert tmodel.is_quantized
    got = tmodel.predict(feats, batch_size=128)
    want = np.asarray(jmodel.predict(jmodel.features_from_columns(cols),
                                     batch_size=128))
    np.testing.assert_allclose(got, want, atol=PREDICT_ATOL, rtol=0)
    assert np.max(np.abs(_softmax(f32) - _softmax(got))) < PROB_ATOL_INT8


# ---------------------------------------------------- Sequential conv net
def _conv_classifier(layers):
    m = (JSequential if layers is jlayers else Sequential)()
    m.add(layers.Convolution2D(16, 3, 3, input_shape=(8, 8, 3),
                               activation="relu", border_mode="same"))
    m.add(layers.Flatten())
    m.add(layers.Dense(64, activation="relu"))
    m.add(layers.Dense(4))
    return m


def test_sequential_conv_classifier_matches_reference():
    jmodel, tmodel = _shared(lambda: _conv_classifier(jlayers),
                             lambda: _conv_classifier(tlayers))
    assert [l.name for l in tmodel.layers] == [l.name for l in jmodel.layers]
    assert tmodel.get_output_shape() == (None, 4)
    x = np.random.RandomState(0).randn(20, 8, 8, 3).astype(np.float32)
    want32 = np.asarray(jim.InferenceModel().load_zoo(jmodel).predict(
        x, batch_size=8))
    got32 = tim.InferenceModel().load_zoo(tmodel).predict(x, batch_size=8)
    np.testing.assert_allclose(got32, want32, atol=PREDICT_ATOL, rtol=0)
    np.testing.assert_allclose(tmodel.predict(x, batch_size=8), want32,
                               atol=PREDICT_ATOL, rtol=0)
    calib = np.random.RandomState(1).randn(32, 8, 8, 3).astype(np.float32)
    kw = dict(quantize="calibrated", calib_set=calib, quant_min_size=16)
    jq = jim.InferenceModel().load_zoo(jmodel, **kw)
    tq = tim.InferenceModel().load_zoo(tmodel, **kw)
    params = tq._variables["params"]
    quant_layers = sorted(k for k, p in params.items()
                          if "kernel_scale" in p)
    assert quant_layers == ["convolution2d_1", "dense_1", "dense_2"]
    for layer in quant_layers:
        assert params[layer]["kernel"].dtype == torch.int8
        assert float(params[layer]["act_scale"]) > 0
    got = tq.predict(x, batch_size=8)
    np.testing.assert_allclose(got, np.asarray(jq.predict(x, batch_size=8)),
                               atol=PREDICT_ATOL, rtol=0)
    rel = np.abs(got - got32) / (np.abs(got32).max() + 1e-6)
    assert rel.max() < 0.1                     # the JAX package's bar


# ------------------------------------------- weight-only, InferenceModel
# a transformer TextClassifier whose every product kernel and the
# embedding tables hold at least 1024 elements
TRANSFORMER = dict(class_num=5, token_length=32, sequence_length=16,
                   encoder="transformer", n_head=2, n_block=2,
                   max_words_num=50, encoder_output_dim=32)


def test_weight_only_params_and_predict_match_reference():
    jmodel, tmodel = _shared(lambda: JTextClassifier(**TRANSFORMER),
                             lambda: TextClassifier(**TRANSFORMER))
    jqp, jscales = jim.quantize_params(jmodel.get_variables()["params"])
    tqp, tscales = tim.quantize_params(tmodel.get_variables()["params"])
    jleaves = jax.tree_util.tree_leaves(jqp)
    from analytics_zoo_torch.pipeline.api.keras.topology import tree_leaves
    tleaves = tree_leaves(tqp)
    assert len(tleaves) == len(jleaves) == len(tscales) == len(jscales)
    n_int8 = 0
    for g, w, gs, ws in zip(tleaves, jleaves, tscales, jscales):
        assert g.numpy().dtype == np.asarray(w).dtype
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        assert (gs is None) == (ws is None)
        if ws is not None:
            n_int8 += 1
            assert g.dtype == torch.int8
            np.testing.assert_array_equal(gs.numpy(), ws)
    assert n_int8 >= 8
    deq = tim.dequantize_params(tqp, tscales)
    for g, w in zip(tree_leaves(deq), jax.tree_util.tree_leaves(
            jim.dequantize_params(jqp, jscales))):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))

    x = np.random.RandomState(0).randint(0, 51, (6, 16))
    want = np.asarray(jim.InferenceModel().load_zoo(
        jmodel, quantize=True).predict(x, batch_size=4))
    im = tim.InferenceModel().load_zoo(tmodel, quantize=True)
    assert im.is_quantized
    got = im.predict(x, batch_size=4)
    np.testing.assert_allclose(got, want, atol=PREDICT_ATOL, rtol=0)
    # int8 stays int8 on the device; no float32 copy of a quantized leaf
    held = tree_leaves(im._variables["params"])
    assert sum(t.dtype == torch.int8 for t in held) == n_int8
    assert all(t.dtype in (torch.int8, torch.float32) for t in held)
    f32 = tim.InferenceModel().load_zoo(tmodel).predict(x, batch_size=4)
    rel = np.abs(got - f32) / (np.abs(f32).max() + 1e-6)
    assert rel.max() < 0.05                    # the JAX package's bar


def test_inference_model_labels_int8_and_needs_calib_set():
    _, tmodel = _ncf_pair(hidden=(64, 32))
    with pytest.raises(ValueError, match="calib_set"):
        tim.InferenceModel().load_zoo(tmodel, quantize="calibrated")
    feats = _ncf_feats(tmodel, 64)
    for quantize, backend in ((False, "f32"), (True, "int8"),
                              ("calibrated", "int8")):
        reset_registry()
        reset_tracer()
        im = tim.InferenceModel().load_zoo(tmodel, quantize=quantize,
                                           calib_set=feats)
        assert im.is_quantized == (backend == "int8")
        assert im.predict(feats, batch_size=32).shape == (64, 2)
        spans = [e for e in get_tracer().events()
                 if e["name"] == "inference_predict"]
        assert [e["args"]["backend"] for e in spans] == [backend]
        reg = get_registry()
        assert reg.counter("inference_records_total", "",
                           labels=("backend",)).labels(backend).value == 64
        assert reg.counter("inference_predict_total", "",
                           labels=("backend",)).labels(backend).value == 1
    assert not tmodel.is_quantized             # load_zoo left it float32


def test_interop_loads_a_quantized_jax_tree():
    """The JAX model quantized (int8 ``kernel``, keepdims ``kernel_scale``,
    0-d ``act_scale``) and exported as numpy loads into a float32 port
    model of the same graph, which then predicts quantized."""
    jmodel, _ = _ncf_pair()
    feats = _ncf_feats(jmodel, 512)
    jmodel.quantize(feats, batch_size=256, max_batches=2)
    jvars = _np_tree(jmodel.get_variables())
    TLayer.reset_name_counters()
    tmodel = NeuralCF(200, 100, class_num=2, user_embed=64, item_embed=64,
                      mf_embed=64, hidden_layers=(128, 64))
    assert not tmodel.is_quantized
    load_jax_variables(tmodel, jvars)
    assert tmodel.is_quantized
    tp = tmodel.get_variables()["params"]
    for layer, p in jvars["params"].items():
        for k, v in p.items():
            assert tp[layer][k].numpy().dtype == v.dtype
            np.testing.assert_array_equal(tp[layer][k].numpy(), v)
    np.testing.assert_allclose(
        tmodel.predict(feats, batch_size=256),
        np.asarray(jmodel.predict(feats, batch_size=256)),
        atol=PREDICT_ATOL, rtol=0)
    # a scale of the wrong shape is refused
    bad = _np_tree(jvars)
    layer = next(k for k, p in bad["params"].items() if "kernel_scale" in p)
    bad["params"][layer]["kernel_scale"] = \
        bad["params"][layer]["kernel_scale"].reshape(-1)
    TLayer.reset_name_counters()
    fresh = NeuralCF(200, 100, class_num=2, user_embed=64, item_embed=64,
                     mf_embed=64, hidden_layers=(128, 64))
    with pytest.raises(ValueError, match="kernel_scale: shape"):
        load_jax_variables(fresh, bad)


# ------------------------------------------------- CLI start --quantize
CLI = dict(class_num=4, token_length=32, sequence_length=16,
           encoder="transformer", n_head=2, n_block=1, max_words_num=50)


def jax_cli_builder():
    """The JAX CLI's builder: it draws the weights itself (``init()``)."""
    JLayer.reset_name_counters()
    return JTextClassifier(**CLI).model


def torch_cli_builder():
    """The port CLI's builder: a port model holding the weights the JAX
    CLI draws; the CLI's ``init()`` keeps them."""
    jnet = jax_cli_builder()
    jvars = _np_tree(jnet.init())
    TLayer.reset_name_counters()
    net = TextClassifier(**CLI).model
    load_jax_variables(net, jvars)
    net.init = lambda *a, **k: net.get_variables()
    return net


@contextlib.contextmanager
def _cli_server(cli, redis, builder, tmp_path, tag):
    srv = redis.BrokerServer(redis.EmbeddedBroker())
    config = tmp_path / f"{tag}.yaml"
    config.write_text(
        "model:\n"
        f"  builder: {__name__}:{builder}\n"
        "data:\n"
        f"  src: {srv.url}\n"
        "params:\n"
        "  batch_size: 2\n"
        "  top_n: 3\n"
        "  input_shape: 16\n"
        f"  log_dir: {tmp_path / tag}\n")
    rc = []
    t = threading.Thread(target=lambda: rc.append(
        cli.main(["start", "--quantize", "--config", str(config)])))
    t.start()
    try:
        yield srv.url
    finally:
        cli.main(["stop", "--config", str(config)])
        t.join(WAIT_S)
        srv.stop()
    assert not t.is_alive() and rc == [0]


def _served(client, url, records):
    inq, outq = client.InputQueue(url), client.OutputQueue(url)
    for i, rec in enumerate(records):
        inq.enqueue(f"q{i}", rec)
    return [outq.query(f"q{i}", timeout_s=WAIT_S)
            for i in range(len(records))]


def test_cli_start_quantize_serves_the_reference_top_n(tmp_path):
    records = np.random.RandomState(7).randint(0, 51, (5, 16))
    with _cli_server(jcli, jredis, "jax_cli_builder", tmp_path,
                     "jax") as url:
        want = _served(jclient, url, records)
    with _cli_server(tcli, tredis, "torch_cli_builder", tmp_path,
                     "torch") as url:
        got = _served(tclient, url, records)
    for g, w in zip(got, want):
        assert g is not None and w is not None and len(g) == 3
        assert [c for c, _ in g] == [c for c, _ in w]
        np.testing.assert_allclose([p for _, p in g], [p for _, p in w],
                                   atol=1e-5, rtol=0)
