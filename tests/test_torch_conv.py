"""PyTorch port, the conv layers and the ``cnn`` TextClassifier: each
``_ConvND`` layer (1D/2D/3D, atrous, groups, ``tf``/``th`` ordering,
``valid``/``same``, stride 2) built in both packages on the same weights
and inputs, float32 and int8 (the JAX layer's params quantized by the
JAX ``quantize_model`` and carried over), ``WordEmbedding``, and the
``cnn`` TextClassifier (default-shaped at small widths) through
``predict`` and ``InferenceModel``, float32 and calibrated int8."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from analytics_zoo_tpu.models.textclassification.text_classifier import (
    TextClassifier as JTextClassifier,
)
from analytics_zoo_tpu.ops import dtypes as jdtypes
from analytics_zoo_tpu.ops import quant as jquant
from analytics_zoo_tpu.pipeline.api.keras import layers as jlayers
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
from analytics_zoo_torch.ops import quant as tquant
from analytics_zoo_torch.pipeline.api.keras import layers as tlayers
from analytics_zoo_torch.pipeline.api.keras.engine import Layer as TLayer
from analytics_zoo_torch.pipeline.inference import InferenceModel

# one float32 convolution: the two frameworks sum a window's products in
# other orders (seen on the CPU: at most 7.2e-7, on outputs up to ~8)
CONV_ATOL = 2e-6
# a whole float32 model forward (the same cause through a few layers)
PREDICT_ATOL = 1e-6


@pytest.fixture(autouse=True)
def _port_cpu(f32_policy):
    tctx.reset_zoo_context()
    tconfig.reset_config()
    tdtypes.restore_policy(None)
    tctx.init_zoo_context(device="cpu")
    tdtypes.set_policy(param_dtype="float32", compute_dtype="float32")
    kernels.reset_launch_counts()
    yield
    tdtypes.restore_policy(None)
    tctx.reset_zoo_context()
    tconfig.reset_config()


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _torch_tree(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


# (class name, args, kwargs, input shape without the batch)
LAYERS = [
    ("Convolution1D", (6, 3), {}, (10, 4)),
    ("Convolution1D", (6, 3), dict(border_mode="same", strides=(2,)),
     (11, 4)),
    ("Convolution1D", (6, 4), dict(groups=2, border_mode="same"), (9, 4)),
    ("AtrousConvolution1D", (5, 3), dict(atrous_rate=2), (12, 3)),
    ("AtrousConvolution1D", (5, 3),
     dict(atrous_rate=2, subsample_length=2, border_mode="same"), (12, 3)),
    ("Convolution2D", (5, 3, 3), {}, (9, 9, 3)),
    ("Convolution2D", (5, 3, 3), dict(border_mode="same"), (9, 9, 3)),
    ("Convolution2D", (5, 3, 3), dict(subsample=(2, 2)), (9, 9, 3)),
    ("Convolution2D", (5, 3, 3), dict(subsample=(2, 2), border_mode="same"),
     (9, 8, 3)),
    ("Convolution2D", (6, 2, 3), dict(groups=2, activation="relu"),
     (7, 8, 4)),
    ("Convolution2D", (4, 3, 3), dict(dim_ordering="th"), (3, 8, 8)),
    ("Convolution2D", (4, 3, 3),
     dict(dim_ordering="th", border_mode="same", subsample=(2, 2)),
     (3, 7, 8)),
    ("AtrousConvolution2D", (3, 3, 3), dict(atrous_rate=(2, 2)), (12, 12, 2)),
    ("AtrousConvolution2D", (3, 3, 2),
     dict(atrous_rate=(2, 1), border_mode="same"), (10, 9, 2)),
    ("Convolution3D", (4, 2, 3, 2), {}, (5, 6, 4, 3)),
    ("Convolution3D", (4, 3, 3, 3),
     dict(border_mode="same", subsample=(2, 2, 2)), (5, 6, 7, 2)),
    ("Convolution3D", (4, 2, 2, 2), dict(dim_ordering="th", groups=2),
     (4, 5, 4, 3)),
]
IDS = [f"{n}-{i}" for i, (n, *_rest) in enumerate(LAYERS)]


def _layer_pair(i):
    name, args, kwargs, shape = LAYERS[i]
    jl = getattr(jlayers, name)(*args, **kwargs)
    tl = getattr(tlayers, name)(*args, **kwargs)
    jv = jl.init(jax.random.PRNGKey(i), shape)
    x = np.random.RandomState(i).randn(2, *shape).astype(np.float32) * 2
    return jl, tl, _np_tree(jv["params"]), x, shape


@pytest.mark.parametrize("i", range(len(LAYERS)), ids=IDS)
def test_conv_layer_matches_reference_f32(i):
    jl, tl, jparams, x, shape = _layer_pair(i)
    tv = tl.init(torch.Generator().manual_seed(0), shape)
    assert {k: tuple(v.shape) for k, v in tv["params"].items()} == \
        {k: v.shape for k, v in jparams.items()}
    want, _ = jl.apply(jparams, jnp.asarray(x))
    got, _ = tl.apply(_torch_tree(jparams), torch.from_numpy(x))
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape
    assert tl.compute_output_shape((None,) + shape) == \
        jl.compute_output_shape((None,) + shape) == (None,) + want.shape[1:]
    np.testing.assert_allclose(got.numpy(), want, atol=CONV_ATOL, rtol=0)


@pytest.mark.parametrize("i", range(len(LAYERS)), ids=IDS)
def test_conv_layer_int8_is_bit_identical(i):
    """The JAX layer's params quantized by the JAX ``quantize_model``
    (min_size 1), carried over: the int8 products are exact in both, and
    the epilogue, bias and activation are the same float32 operations."""
    jl, tl, jparams, x, shape = _layer_pair(i)
    rng_max = float(np.abs(x).max())
    jq = jquant.quantize_model({"params": {"c": jparams}, "state": {}},
                               {"c": rng_max}, min_size=1)["params"]["c"]
    tq = tquant.quantize_model({"params": {"c": _torch_tree(jparams)},
                                "state": {}},
                               {"c": rng_max}, min_size=1)["params"]["c"]
    for k in ("kernel", "kernel_scale", "act_scale", "bias"):
        np.testing.assert_array_equal(tq[k].numpy(), np.asarray(jq[k]))
        assert tq[k].dtype == torch.from_numpy(np.array(jq[k])).dtype
    want, _ = jl.apply(_np_tree(jq), jnp.asarray(x))
    got, _ = tl.apply(tq, torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("i", range(len(LAYERS)), ids=IDS)
def test_unfolded_int8_conv_equals_plain_route(i):
    """The card route's construction (the unfolded taps through
    ``torch._int_mm``, which runs on the CPU too) against the plain
    route, on the CPU."""
    name, args, kwargs, shape = LAYERS[i]
    tl = getattr(tlayers, name)(*args, **kwargs)
    kq = torch.randint(-127, 128, tuple(tl.init(
        torch.Generator().manual_seed(0), shape)["params"]["kernel"].shape),
        generator=torch.Generator().manual_seed(i), dtype=torch.int8)
    x = torch.from_numpy(np.random.RandomState(i).randint(
        -127, 128, (3, *shape)).astype(np.int8))
    if tl.dim_ordering == "th":
        x = x.movedim(1, -1)
    padding = tl.border_mode.upper()
    pads = tquant.conv_padding(x.shape[1:-1], kq.shape[:-2], tl.strides,
                               tl.dilation, padding)
    card = tquant._int_conv_card(x, kq, tl.strides, pads, tl.dilation,
                                 tl.groups)
    plain = tquant.int8_conv(x, kq, tl.strides, padding, tl.dilation,
                             tl.groups)
    assert card.dtype == plain.dtype == torch.int32
    assert torch.equal(card, plain)


def test_conv_returns_the_compute_dtype_under_bf16():
    """``lax.conv_general_dilated`` returns its operands' dtype: under the
    bf16 policy both packages' float route gives bf16 before the bias."""
    jdtypes.set_policy(param_dtype="float32", compute_dtype="bfloat16")
    tdtypes.set_policy(param_dtype="float32", compute_dtype="bfloat16")
    jl, tl, jparams, x, _ = _layer_pair(5)
    want = jl._convolve(jnp.asarray(x), jnp.asarray(jparams["kernel"]))
    got = tl._convolve(torch.from_numpy(x),
                       torch.from_numpy(np.array(jparams["kernel"])))
    assert want.dtype == jnp.bfloat16 and got.dtype == torch.bfloat16
    # the same bf16 operands, float32 sums in other orders, rounded to
    # bf16 once: at most one bf16 step apart
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=2 ** -7, atol=2 ** -7)


def test_word_embedding_matches_reference():
    mat = np.random.RandomState(0).randn(12, 5).astype(np.float32)
    jl = jlayers.WordEmbedding(mat)
    tl = tlayers.WordEmbedding(mat)
    jv = jl.init(jax.random.PRNGKey(0), (7,))
    tv = tl.init(torch.Generator().manual_seed(0), (7,))
    np.testing.assert_array_equal(tv["params"]["embeddings"].numpy(), mat)
    ids = np.random.RandomState(1).randint(0, 12, (3, 7))
    want, _ = jl.apply(jv["params"], jnp.asarray(ids))
    got, _ = tl.apply(tv["params"], torch.from_numpy(ids))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # frozen by default: no gradient reaches the table
    emb = tv["params"]["embeddings"].clone().requires_grad_(True)
    out, _ = tl.apply({"embeddings": emb}, torch.from_numpy(ids))
    assert not out.requires_grad


# the JAX TextClassifier's cnn defaults, cut in width: sequence 40,
# tokens 16, 32 filters of width 5, 60 words, 4 classes
CNN = dict(class_num=4, token_length=16, sequence_length=40, encoder="cnn",
           encoder_output_dim=32, max_words_num=60)


def _cnn_pair(**kw):
    JLayer.reset_name_counters()
    jmodel = JTextClassifier(**{**CNN, **kw})
    TLayer.reset_name_counters()
    tmodel = TextClassifier(**{**CNN, **kw})
    load_jax_variables(tmodel, _np_tree(jmodel.get_variables()))
    return jmodel, tmodel


def _cnn_tokens(n=24, seed=0):
    return np.random.RandomState(seed).randint(0, CNN["max_words_num"] + 1,
                                               (n, CNN["sequence_length"]))


def test_cnn_text_classifier_matches_reference_f32():
    jmodel, tmodel = _cnn_pair()
    jparams = jmodel.get_variables()["params"]
    assert "convolution1d_1" in jparams
    assert jparams["convolution1d_1"]["kernel"].shape == (5, 16, 32)
    x = _cnn_tokens()
    want = np.asarray(jmodel.predict(x, batch_size=8))
    got = tmodel.predict(x, batch_size=8)
    assert got.shape == want.shape == (24, 4)
    np.testing.assert_allclose(got, want, atol=PREDICT_ATOL, rtol=0)
    got_im = InferenceModel().load_zoo(tmodel).predict(x, batch_size=5)
    np.testing.assert_allclose(got_im, want, atol=PREDICT_ATOL, rtol=0)


def test_cnn_text_classifier_calibrated_matches_reference():
    """``quantize(calib)`` in both packages: the same ranges, the same
    int8 conv and Dense params bit for bit, predictions within float32
    noise (the unquantized 32 x 4 head sums in other orders)."""
    jmodel, tmodel = _cnn_pair()
    calib, x = _cnn_tokens(32, seed=1), _cnn_tokens()
    jr = jquant.calibrate_model(jmodel.model, calib, batch_size=8,
                                max_batches=4)
    tr = tquant.calibrate_model(tmodel.model, calib, batch_size=8,
                                max_batches=4)
    assert sorted(tr) == sorted(jr)
    for name in jr:
        assert tr[name] == pytest.approx(jr[name], rel=1e-6, abs=0)
    jmodel.quantize(calib, batch_size=8, max_batches=4, min_size=256)
    tmodel.quantize(calib, batch_size=8, max_batches=4, min_size=256)
    assert tmodel.is_quantized and jmodel.is_quantized
    jq = jmodel.get_variables()["params"]
    tq = tmodel.get_variables()["params"]
    quantized = sorted(k for k, p in tq.items() if "kernel_scale" in p)
    assert quantized == sorted(k for k, p in jq.items()
                               if "kernel_scale" in p)
    assert "convolution1d_1" in quantized and "dense_1" in quantized
    for layer in quantized:
        for k in ("kernel", "kernel_scale", "act_scale"):
            np.testing.assert_array_equal(tq[layer][k].numpy(),
                                          np.asarray(jq[layer][k]))
    want = np.asarray(jmodel.predict(x, batch_size=8))
    got = tmodel.predict(x, batch_size=8)
    np.testing.assert_allclose(got, want, atol=PREDICT_ATOL, rtol=0)


def test_cnn_inference_model_calibrated_matches_reference():
    jmodel, tmodel = _cnn_pair()
    calib, x = _cnn_tokens(16, seed=2), _cnn_tokens(10, seed=3)
    kw = dict(quantize="calibrated", calib_set=calib, calib_batch_size=8,
              calib_batches=2, quant_min_size=256)
    jim = JInferenceModel().load_zoo(jmodel, **kw)
    tim = InferenceModel().load_zoo(tmodel, **kw)
    assert tim.is_quantized and jim.is_quantized
    assert not tmodel.is_quantized           # the model keeps float32
    np.testing.assert_allclose(tim.predict(x, batch_size=4),
                               np.asarray(jim.predict(x, batch_size=4)),
                               atol=PREDICT_ATOL, rtol=0)


def test_cnn_text_classifier_with_embedding_matrix():
    mat = np.random.RandomState(5).randn(61, 16).astype(np.float32)
    jmodel, tmodel = _cnn_pair(embedding_matrix=mat)
    assert "wordembedding_1" in tmodel.get_variables()["params"]
    x = _cnn_tokens(6, seed=4)
    np.testing.assert_allclose(tmodel.predict(x),
                               np.asarray(jmodel.predict(x)),
                               atol=PREDICT_ATOL, rtol=0)
