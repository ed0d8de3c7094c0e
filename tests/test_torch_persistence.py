"""PyTorch port, model persistence: the port's stdlib msgpack codec against
flax's (byte-identical encodings, flax's bytes decoded, the chunked form,
a hypothesis round trip, malformed bytes raising), ``to_bytes``/
``from_bytes`` and ``load_variables`` with its positional fallback,
``Checkpoint``, each model's ``save_model`` file moved both ways between
the packages, ``InferenceModel.load_zoo_file`` and the serving CLI's
``weights:``, ``Estimator(model_dir=)``'s resume (bit-identical on the
CPU, and across the packages both ways) and retry, and the recovery
policy (copies of ``tests/test_resilience.py``'s budget and policy
cases).  flax, msgpack and the JAX package are only the oracle here."""

import collections
import logging
import os
import shutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax
from flax import serialization as fser
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st
from hypothesis.extra import numpy as hnp

from analytics_zoo_tpu.models.image.imageclassification.nets import (
    ImageClassifier as JImageClassifier,
)
from analytics_zoo_tpu.models.recommendation import NeuralCF as JNeuralCF
from analytics_zoo_tpu.models.seq2seq import Seq2seq as JSeq2seq
from analytics_zoo_tpu.models.textclassification.text_classifier import (
    TextClassifier as JTextClassifier,
)
from analytics_zoo_tpu.pipeline.api.keras import optimizers as jopt
from analytics_zoo_tpu.pipeline.api.keras.engine import Layer as JLayer

from analytics_zoo_torch.common import config as tconfig
from analytics_zoo_torch.common import zoo_context as tctx
from analytics_zoo_torch.models.image import ImageClassifier
from analytics_zoo_torch.models.recommendation import NeuralCF
from analytics_zoo_torch.models.seq2seq import Seq2seq
from analytics_zoo_torch.models.textclassification import TextClassifier
from analytics_zoo_torch.observability import get_registry, reset_registry
from analytics_zoo_torch.ops import dtypes as tdtypes
from analytics_zoo_torch.ops import kernels
from analytics_zoo_torch.pipeline.api.keras import optimizers as topt
from analytics_zoo_torch.pipeline.api.keras.engine import Layer as TLayer
from analytics_zoo_torch.pipeline.inference import InferenceModel
from analytics_zoo_torch.resilience.chaos import (
    ChaosPlan, FaultSpec, LostHost, PoisonedState, TransientFault,
    clear_chaos, install_chaos)
from analytics_zoo_torch.resilience.detector import FailureClass
from analytics_zoo_torch.resilience.policy import (
    RecoveryAction, RecoveryPolicy, RetryBudget)
from analytics_zoo_torch.serving import cli
from analytics_zoo_torch.utils import msgpack_codec as codec
from analytics_zoo_torch.utils import serialization as ser

LOSS = "sparse_categorical_crossentropy_with_logits"
# a model file moved between the packages: the same float32 weights, each
# framework's forward summing its products in its own order (seen on the
# CPU: 3.0e-7 on ResNet-18's logits, 1e-8 or less on the others)
PREDICT_ATOL = 1e-6
# the transformer's attention and LayerNorm→GeLU in each framework's own
# float32 code differ by more on identical weights: 0.7e-6 to 1.4e-6 on
# logits of magnitude 0.8 over five seeded batches of 4 x 16 tokens
# (tests/test_torch_text_classifier.py holds the slice at 1e-4)
TRANSFORMER_PREDICT_ATOL = 1e-5
# several steps in each package from the same snapshot (ROADMAP.md's
# multi-step float32 tolerance)
RESUME_ATOL = 1e-4
TRANSFORMER = dict(class_num=5, token_length=128, sequence_length=16,
                   encoder="transformer", n_head=2, n_block=2,
                   max_words_num=100)


@pytest.fixture(autouse=True)
def _port_cpu(f32_policy):
    tctx.reset_zoo_context()
    tconfig.reset_config()
    tctx.init_zoo_context(device="cpu")
    tdtypes.set_policy(param_dtype="float32", compute_dtype="float32")
    kernels.reset_launch_counts()
    reset_registry()
    clear_chaos()
    yield
    clear_chaos()
    assert sum(kernels.launch_counts().values()) == 0
    tdtypes.restore_policy(None)
    tctx.reset_zoo_context()
    tconfig.reset_config()


# ------------------------------------------------------------ the codec
def _bf16(a):
    """A numpy bfloat16 array (ml_dtypes, through jax) of ``a``."""
    return np.asarray(jnp.asarray(a, jnp.bfloat16))


def _trees():
    rs = np.random.RandomState(0)
    adam = optax.ScaleByAdamState(
        count=np.zeros((), np.int32),
        mu={"dense": {"kernel": rs.randn(3, 2).astype(np.float32)}},
        nu={"dense": {"kernel": rs.rand(3, 2).astype(np.float32)}})
    return {
        "float32": {"w": rs.randn(3, 4).astype(np.float32),
                    "b": rs.randn(4).astype(np.float32)},
        "float16_int32_int8": {
            "h": rs.randn(2, 3).astype(np.float16),
            "i": rs.randint(-2 ** 31, 2 ** 31, (5,)).astype(np.int32),
            "q": rs.randint(-128, 128, (2, 2)).astype(np.int8)},
        "bfloat16": {"x": _bf16(rs.randn(3, 2)), "y": _bf16(rs.randn(40))},
        "zero_d_and_empty": {"s": np.array(2.5, np.float32),
                             "c": np.zeros((), np.int32),
                             "e": np.zeros((0, 3), np.float32)},
        "numpy_scalars": {"f32": np.float32(1.5), "i64": np.int64(-7),
                          "b": np.bool_(True), "f64": np.float64(2.0),
                          "u8": np.uint8(200)},
        "python_leaves": {"int": 5, "big": 2 ** 40, "huge": 2 ** 64 - 1,
                          "neg": -129, "min": -2 ** 63, "float": 0.1,
                          "str": "héllo", "long_str": "x" * 300,
                          "bool": False, "none": None, "bytes": b"\x00ab"},
        "empty_dicts": {"a": {}, "b": {"c": {}}, "d": [{}, []]},
        "many_keys": {f"k{i}": i for i in range(40)},
        "optax_states": {"opt_state": (adam, optax.EmptyState()),
                         "trace": (optax.TraceState(
                             trace={"w": rs.randn(4).astype(np.float32)}),)},
        "tuples_and_lists": {"t": (rs.randn(2).astype(np.float32),
                                   (np.int32(3), 4)),
                             "l": [rs.randn(3).astype(np.float64), "x"]},
    }


TREES = sorted(_trees())
HAS_TUPLES = {"optax_states", "tuples_and_lists"}


def _assert_same(got, want, path=""):
    """``got`` (the port's decoding) holds what ``want`` (flax's) holds:
    the same keys in the same order, arrays bit for bit."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want), path
        for k in want:
            _assert_same(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_same(g, w, f"{path}/{i}")
    elif isinstance(want, np.ndarray):
        assert isinstance(got, torch.Tensor), path
        assert tuple(got.shape) == want.shape, path
        assert codec.dtype_name(got.dtype) == want.dtype.name, path
        g = got.view(torch.int16) if got.dtype == torch.bfloat16 else got
        w = want.view(np.int16) if want.dtype.name == "bfloat16" else want
        np.testing.assert_array_equal(g.numpy(), w, err_msg=path)
    elif isinstance(want, np.generic):
        assert type(got) is type(want) and got == want, path
    else:
        assert type(got) is type(want) and got == want, path


@pytest.mark.parametrize("name", TREES)
def test_encoding_is_flax_bytes(name):
    tree = _trees()[name]
    assert ser.to_bytes(tree) == fser.to_bytes(_trees()[name])
    if name not in HAS_TUPLES:     # msgpack's strict types refuse tuples
        assert codec.packb(tree) == fser.msgpack_serialize(
            _trees()[name], in_place=True)


@pytest.mark.parametrize("name", TREES)
def test_decoding_flax_bytes_is_msgpack_restore(name):
    data = fser.to_bytes(_trees()[name])
    _assert_same(codec.unpackb(data, device="cpu"),
                 fser.msgpack_restore(data))


def test_torch_leaves_encode_from_their_bytes():
    """Tensors (CPU or not) write the bytes and dtype names numpy arrays
    write; bfloat16 through its bits."""
    rs = np.random.RandomState(1)
    w = rs.randn(4, 3).astype(np.float32)
    bits = rs.randint(-2 ** 15, 2 ** 15, (6,)).astype(np.int16)
    ids = rs.randint(-2 ** 40, 2 ** 40, (2, 2)).astype(np.int64)
    mask = rs.rand(5) > 0.5
    tree = {"w": torch.from_numpy(w).t().contiguous().t(),   # strided
            "bf": torch.from_numpy(bits).view(torch.bfloat16),
            "ids": torch.from_numpy(ids), "mask": torch.from_numpy(mask),
            "count": torch.zeros((), dtype=torch.int32)}
    want = {"w": w, "bf": bits.view(_bf16(0.0).dtype), "ids": ids,
            "mask": mask, "count": np.zeros((), np.int32)}
    data = codec.packb(tree)
    assert data == fser.msgpack_serialize(want, in_place=True)
    back = codec.unpackb(data, device="cpu")
    for k in tree:
        assert back[k].dtype == tree[k].dtype
        assert torch.equal(back[k].view(-1).view(torch.uint8),
                           tree[k].contiguous().view(-1).view(torch.uint8))


def test_chunked_arrays_match_flax(monkeypatch):
    """Arrays over the chunk size become flax's chunked maps (the tree
    itself, and values of maps within maps, not list items), on write and
    on read; the chunk size lowered in both modules."""
    monkeypatch.setattr(codec, "MAX_CHUNK_SIZE", 64)
    monkeypatch.setattr(fser, "MAX_CHUNK_SIZE", 64)
    rs = np.random.RandomState(2)

    def tree():
        r = np.random.RandomState(2)
        return {"a": r.randn(5, 7).astype(np.float32),
                "b": {"c": _bf16(r.randn(3, 30)), "d": r.randn(3)},
                "l": [r.randn(40).astype(np.float32)],
                "small": r.randn(4).astype(np.float32)}
    data = fser.msgpack_serialize(tree(), in_place=True)
    assert codec.packb(tree()) == data
    assert ser.to_bytes(tree()) == fser.to_bytes(tree())
    assert b"__msgpack_chunked_array__" in data
    _assert_same(codec.unpackb(data, device="cpu"),
                 fser.msgpack_restore(data))
    torch_tree = {"a": torch.from_numpy(tree()["a"])}
    assert codec.packb(torch_tree) == fser.msgpack_serialize(
        {"a": tree()["a"]}, in_place=True)
    # the tree itself an array over the chunk size
    whole = rs.randn(33).astype(np.float32)
    whole_bytes = fser.msgpack_serialize(whole.copy(), in_place=True)
    assert codec.packb(whole) == whole_bytes
    np.testing.assert_array_equal(
        codec.unpackb(whole_bytes, device="cpu").numpy(), whole)


_DTYPE_STRATEGY = st.sampled_from(
    [np.float32, np.float16, np.float64, np.int8, np.int16, np.int32,
     np.int64, np.uint8, np.bool_])
_LEAVES = st.one_of(
    st.none(), st.booleans(),
    st.integers(min_value=-2 ** 63, max_value=2 ** 64 - 1),
    st.floats(allow_nan=False), st.text(max_size=40),
    st.binary(max_size=40),
    _DTYPE_STRATEGY.flatmap(lambda dt: hnp.arrays(
        dt, hnp.array_shapes(min_dims=0, max_dims=3, max_side=4))),
    _DTYPE_STRATEGY.flatmap(lambda dt: hnp.from_dtype(np.dtype(dt)))
    .map(lambda v: np.asarray(v)[()]))
_TREES = st.recursive(
    _LEAVES,
    lambda inner: st.one_of(
        st.lists(inner, max_size=4),
        st.dictionaries(st.text(max_size=8), inner, max_size=4)),
    max_leaves=12)


@settings(max_examples=80, deadline=None, derandomize=True, database=None,
          suppress_health_check=[HealthCheck.too_slow,
                                 HealthCheck.data_too_large])
@given(_TREES)
def test_codec_round_trip(tree):
    """Any tree of msgpack's types, numpy arrays and numpy scalars: the
    port's bytes are flax's, and decoding them and encoding again gives
    the same bytes."""
    data = codec.packb(tree)
    assert data == fser.msgpack_serialize(tree, in_place=True)
    assert codec.packb(codec.unpackb(data, device="cpu")) == data


def test_malformed_bytes_raise():
    data = ser.to_bytes({"w": np.arange(12, dtype=np.float32), "n": 3})
    for cut in (1, 5, len(data) // 2, len(data) - 1):
        with pytest.raises(ValueError):
            codec.unpackb(data[:cut])
    with pytest.raises(ValueError, match="after its object"):
        codec.unpackb(data + b"\x00")
    with pytest.raises(ValueError, match="not msgpack"):
        codec.unpackb(b"\xc1")
    # an array whose payload is shorter than its shape says
    bad = bytearray(codec.packb(np.arange(4, dtype=np.int32)))
    bad[5] = 5                       # the shape (4,) becomes (5,)
    with pytest.raises(ValueError, match="holds 16 bytes"):
        codec.unpackb(bytes(bad))
    with pytest.raises(ValueError, match="ext type"):
        codec.unpackb(b"\xd4\x07\x00")
    with pytest.raises(TypeError):
        codec.packb({"t": (1, 2)})    # msgpack's strict types, as flax
    with pytest.raises(TypeError):
        codec.packb(object())


# ------------------------------------------------ restoring into a tree
AdamState = collections.namedtuple("AdamState", "count mu nu")


def _like():
    return {"params": {"dense": {"kernel": torch.zeros(3, 2),
                                 "bias": torch.zeros(2)}},
            "opt": (AdamState(torch.zeros((), dtype=torch.int32),
                              {"k": torch.zeros(2)}, {"k": torch.zeros(2)}),
                    ()),
            "epoch": 0}


def test_from_bytes_restores_the_structure_and_raises_on_a_mismatch():
    rs = np.random.RandomState(3)
    saved = {"params": {"dense": {"kernel": rs.randn(3, 2).astype(
        np.float32), "bias": rs.randn(2).astype(np.float32)}},
        "opt": (optax.ScaleByAdamState(
            np.array(7, np.int32), {"k": np.ones(2, np.float32)},
            {"k": np.full(2, 2.0, np.float32)}), ()),
        "epoch": 4}
    data = fser.to_bytes(saved)
    got = ser.from_bytes(_like(), data)
    assert isinstance(got["opt"][0], AdamState) and got["opt"][1] == ()
    assert int(got["opt"][0].count) == 7 and got["epoch"] == 4
    np.testing.assert_array_equal(got["params"]["dense"]["kernel"].numpy(),
                                  saved["params"]["dense"]["kernel"])
    assert got["opt"][0].count.dtype == torch.int32
    # and back: the port's bytes of the restored tree are flax's
    assert ser.to_bytes(got) == data

    def mismatch(edit, match):
        like = _like()
        edit(like)
        with pytest.raises(ValueError, match=match):
            ser.from_bytes(like, data)
    mismatch(lambda l: l["params"]["dense"].pop("bias"), "extra")
    mismatch(lambda l: l["params"].update(other={}), "missing")
    mismatch(lambda l: l["params"]["dense"].update(
        kernel=torch.zeros(2, 3)), "does not match")
    mismatch(lambda l: l["params"]["dense"].update(
        bias=torch.zeros(2, dtype=torch.float64)), "does not match")
    mismatch(lambda l: l.update(epoch=torch.zeros(())), "expected an array")


def _small_transformer(**kw):
    return TextClassifier(**{**TRANSFORMER, **kw})


def test_load_weights_matches_positionally_when_names_shift(tmp_path,
                                                            caplog):
    TLayer.reset_name_counters()
    model = _small_transformer()
    model.model.init(torch.Generator().manual_seed(1))
    path = str(tmp_path / "model.ckpt")
    model.save_model(path)
    shifted = _small_transformer()         # names go on counting
    assert set(shifted.get_variables()["params"]).isdisjoint(
        model.get_variables()["params"])
    with caplog.at_level(logging.WARNING, logger="analytics_zoo_torch"):
        shifted.load_weights(path)
    assert "positionally" in caplog.text
    for a, b in zip(shifted.get_weights(), model.get_weights()):
        np.testing.assert_array_equal(a, b)
    wider = _small_transformer(token_length=64)
    with pytest.raises(ValueError, match="keys differ"):
        wider.load_weights(path)
    TLayer.reset_name_counters()
    narrow = _small_transformer(class_num=4)
    with pytest.raises(ValueError, match="does not match"):
        narrow.load_weights(path)


def test_checkpoint_retention_latest_and_no_tmp_left(tmp_path):
    ckpt = ser.Checkpoint(str(tmp_path / "snaps"), keep=2)
    assert ckpt.latest_path() is None and ckpt.restore_latest({}) is None
    like = {"w": torch.zeros(3), "iteration": 0}
    for step in (3, 10, 7, 12):
        ckpt.save({"w": torch.full((3,), float(step)), "iteration": step},
                  step=step)
    names = sorted(os.listdir(ckpt.directory))
    assert names == ["snapshot.10.ckpt", "snapshot.12.ckpt"]
    assert ckpt.latest_path().endswith("snapshot.12.ckpt")
    got = ckpt.restore_latest(like)
    assert got["iteration"] == 12 and torch.equal(got["w"],
                                                  torch.full((3,), 12.0))
    assert ser.Checkpoint(str(tmp_path / "other")).keep == 5
    # the JAX package's Checkpoint reads the port's snapshot
    from analytics_zoo_tpu.utils.serialization import Checkpoint as JCkpt
    jgot = JCkpt(ckpt.directory, keep=2).restore_latest(
        {"w": np.zeros(3, np.float32), "iteration": 0})
    assert jgot["iteration"] == 12
    np.testing.assert_array_equal(jgot["w"], np.full(3, 12.0, np.float32))


def test_save_model_refuses_overwrite_and_bad_files_raise(tmp_path):
    TLayer.reset_name_counters()
    model = _small_transformer()
    path = str(tmp_path / "sub" / "model.ckpt")
    model.save_model(path)
    assert os.listdir(tmp_path / "sub") == ["model.ckpt"]
    with pytest.raises(FileExistsError):
        model.save_model(path, over_write=False)
    with pytest.raises(FileNotFoundError):
        model.load_weights(str(tmp_path / "missing.ckpt"))
    data = open(path, "rb").read()
    bad = tmp_path / "truncated.ckpt"
    bad.write_bytes(data[:len(data) // 3])
    with pytest.raises(ValueError, match="truncated"):
        model.load_weights(str(bad))
    bad.write_bytes(b"not a checkpoint")
    with pytest.raises(ValueError):
        model.load_weights(str(bad))


# ---------------------------------------- model files between packages
def _models():
    rs = np.random.RandomState(0)
    ncf = dict(user_embed=8, item_embed=8, mf_embed=4, hidden_layers=(16, 8))
    lstm = dict(class_num=5, token_length=16, sequence_length=12,
                encoder="lstm", encoder_output_dim=24, max_words_num=100)
    s2s = dict(vocab_size=16, embed_dim=8, hidden_sizes=(12,))
    return {
        "transformer": (lambda: JTextClassifier(**TRANSFORMER),
                        lambda: TextClassifier(**TRANSFORMER),
                        rs.randint(0, 100, (4, 16))),
        "neuralcf": (lambda: JNeuralCF(50, 40, **ncf),
                     lambda: NeuralCF(50, 40, **ncf),
                     [rs.randint(1, 51, (6, 1)).astype(np.int32),
                      rs.randint(1, 41, (6, 1)).astype(np.int32)]),
        "lstm": (lambda: JTextClassifier(**lstm),
                 lambda: TextClassifier(**lstm),
                 rs.randint(0, 100, (4, 12))),
        "resnet18": (lambda: JImageClassifier(
            "resnet-18", num_classes=5, input_shape=(32, 32, 3)),
            lambda: ImageClassifier("resnet-18", num_classes=5,
                                    input_shape=(32, 32, 3)),
            rs.randn(2, 32, 32, 3).astype(np.float32)),
        "seq2seq": (lambda: JSeq2seq(**s2s), lambda: Seq2seq(**s2s),
                    [rs.randint(3, 16, (4, 5)).astype(np.int32),
                     rs.randint(3, 16, (4, 6)).astype(np.int32)]),
    }


def _net(model):
    return getattr(model, "model", model)


def _np(tree):
    """``tree`` with numpy leaves, its dicts' key order kept (jax's
    tree_map would sort it)."""
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    return tree.numpy()


def _in_order_of(tree, order):
    """``tree`` with its dicts' keys in ``order``'s order."""
    if isinstance(order, dict):
        return {k: _in_order_of(tree[k], order[k]) for k in order}
    return tree


@pytest.mark.parametrize("name", sorted(_models()))
def test_model_files_move_both_ways(name, tmp_path):
    """Weights drawn in the port (moving statistics too), set into the
    JAX model; each package's ``save_model`` file loads into the other's
    fresh model bit for bit and predicts there within PREDICT_ATOL of the
    saving package; in the same key order the two files are the same
    bytes."""
    jbuild, tbuild, x = _models()[name]
    JLayer.reset_name_counters()
    jm = jbuild()
    TLayer.reset_name_counters()
    tm = tbuild()
    drawn = _net(tm).init(torch.Generator().manual_seed(0))
    rs = np.random.RandomState(5)
    # non-trivial BatchNormalization moving statistics
    drawn["state"] = {k: {s: torch.from_numpy(
        (rs.rand(*v.shape) + 0.5).astype(np.float32)) for s, v in d.items()}
        for k, d in drawn["state"].items()}
    _net(tm).set_variables(drawn)
    jm.set_variables(jax.tree_util.tree_map(
        lambda t: jnp.asarray(t.numpy()), drawn))
    if name == "resnet18":
        assert any(drawn["state"].values())

    jpath, tpath = str(tmp_path / "jax.ckpt"), str(tmp_path / "port.ckpt")
    jm.save_model(jpath)
    tm.save_model(tpath)
    TLayer.reset_name_counters()
    t_loaded = tbuild().load_weights(jpath)
    JLayer.reset_name_counters()
    j_loaded = jbuild()
    j_loaded.load_weights(tpath)
    for a, b in zip(jax.tree_util.tree_leaves(j_loaded.get_variables()),
                    jax.tree_util.tree_leaves(jm.get_variables())):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    for a, b in zip(jax.tree_util.tree_leaves(_np(t_loaded.get_variables())),
                    jax.tree_util.tree_leaves(_np(drawn))):
        np.testing.assert_array_equal(a, b)
    atol = TRANSFORMER_PREDICT_ATOL if name == "transformer" \
        else PREDICT_ATOL
    want_j = np.asarray(jm.predict(x, batch_size=4))
    want_t = tm.predict(x, batch_size=4)
    got_t = t_loaded.predict(x, batch_size=4)
    got_j = np.asarray(j_loaded.predict(x, batch_size=4))
    np.testing.assert_allclose(got_t, want_j, atol=atol, rtol=0)
    np.testing.assert_allclose(got_j, want_t, atol=atol, rtol=0)
    # the same weights in the same package: the same answers
    np.testing.assert_array_equal(got_t, want_t)
    np.testing.assert_array_equal(got_j, want_j)
    assert ser.to_bytes(_in_order_of(tm.get_variables(),
                                     jm.get_variables())) == \
        open(jpath, "rb").read()
    assert open(tpath, "rb").read() == fser.to_bytes(
        _np(tm.get_variables()))


# ------------------------------------------------------------- loaders
def cli_builder():
    return _small_transformer()


def _saved_transformer(tmp_path):
    TLayer.reset_name_counters()
    model = _small_transformer()
    model.model.init(torch.Generator().manual_seed(2))
    path = str(tmp_path / "model.ckpt")
    model.save_model(path)
    return model, path


def test_load_zoo_file_is_load_zoo_of_the_saved_model(tmp_path):
    model, path = _saved_transformer(tmp_path)
    x = np.random.RandomState(4).randint(0, 100, (3, 16))
    for quantize in (False, True):
        TLayer.reset_name_counters()
        got = InferenceModel().load_zoo_file(_small_transformer(), path,
                                             quantize=quantize)
        want = InferenceModel().load_zoo(model, quantize=quantize)
        np.testing.assert_array_equal(got.predict(x), want.predict(x))
        assert got.is_quantized is quantize
    with pytest.raises(FileNotFoundError):
        InferenceModel().load_zoo_file(_small_transformer(),
                                       str(tmp_path / "none.ckpt"))
    TLayer.reset_name_counters()
    with pytest.raises(ValueError):
        InferenceModel().load_zoo_file(_small_transformer(class_num=3),
                                       path)


def test_cli_weights_load_the_file_and_never_fall_back(tmp_path):
    model, path = _saved_transformer(tmp_path)
    TLayer.reset_name_counters()
    built = cli._build_model(f"{__name__}:cli_builder", weights=path)
    for a, b in zip(built.get_weights(), model.get_weights()):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(FileNotFoundError):
        cli._build_model(f"{__name__}:cli_builder",
                         weights=str(tmp_path / "none.ckpt"))
    (tmp_path / "junk.ckpt").write_bytes(b"\x93\x01")
    with pytest.raises(ValueError):
        cli._build_model(f"{__name__}:cli_builder",
                         weights=str(tmp_path / "junk.ckpt"))


# ------------------------------------------------- Estimator(model_dir=)
def _data(n=32, seed=3):
    rs = np.random.RandomState(seed)
    return rs.randint(0, 100, size=(n, 16)), rs.randint(0, 5, size=(n,))


def _zero_dropout(model):
    for layer in model.model.layers:
        if hasattr(layer, "p"):
            layer.p = 0.0
        if hasattr(layer, "attn_dropout"):
            layer.attn_dropout = 0.0


def _port_fit(epochs, model_dir=None, seed=0, dropout=True, weights=0):
    TLayer.reset_name_counters()
    model = _small_transformer()
    if not dropout:
        _zero_dropout(model)
    model.model.init(torch.Generator().manual_seed(weights))
    model.compile(topt.Adam(lr=1e-3), LOSS)
    if model_dir is not None:
        model.model.set_checkpoint(str(model_dir))
    x, y = _data()
    history = model.fit(x, y, batch_size=8, nb_epoch=epochs, rng=seed)
    return model, history


def _counter(name):
    return get_registry().counter(name).value


def test_resume_is_bit_identical_to_an_uninterrupted_run(tmp_path):
    """Two epochs into a model_dir, then a fresh model's fit to three
    epochs there resumes at epoch 2, iteration 8, and ends where three
    uninterrupted epochs end, dropout on."""
    ckpt = tmp_path / "ckpt"
    _, first = _port_fit(2, ckpt)
    assert sorted(os.listdir(ckpt)) == ["snapshot.4.ckpt", "snapshot.8.ckpt"]
    assert _counter("checkpoint_save_total") == 2
    assert _counter("checkpoint_restore_total") == 0
    resumed, rest = _port_fit(3, ckpt, weights=9)
    assert _counter("checkpoint_restore_total") == 1
    assert [h["epoch"] for h in rest] == [3]
    whole, history = _port_fit(3)
    assert [h["loss"] for h in first + rest] == [h["loss"] for h in history]
    for a, b in zip(resumed.get_weights(), whole.get_weights()):
        np.testing.assert_array_equal(a, b)
    assert sorted(os.listdir(ckpt)) == [
        "snapshot.12.ckpt", "snapshot.4.ckpt", "snapshot.8.ckpt"]
    assert not [n for n in os.listdir(ckpt) if n.endswith(".tmp")]


def _jax_fit(epochs, model_dir):
    JLayer.reset_name_counters()
    model = JTextClassifier(**TRANSFORMER)
    _zero_dropout(model)
    model.compile(jopt.Adam(lr=1e-3), LOSS)
    model.model.set_checkpoint(str(model_dir))
    x, y = _data()
    history = model.fit(x, y, batch_size=8, nb_epoch=epochs)
    return model, history


def _assert_params_close(tparams, jparams):
    for layer in sorted(jparams):
        for name in sorted(jparams[layer]):
            np.testing.assert_allclose(
                tparams[layer][name].numpy(), np.asarray(jparams[layer][name]),
                atol=RESUME_ATOL, rtol=0, err_msg=f"{layer}/{name}")


def test_snapshots_resume_across_the_packages_both_ways(tmp_path):
    """A JAX Estimator's snapshot after two epochs resumes in the port for
    a third, and the port's in the JAX package: each third epoch within
    RESUME_ATOL of the saving package's own third epoch."""
    jdir, pdir = tmp_path / "jax", tmp_path / "port"
    _jax_fit(2, jdir)
    shutil.copytree(jdir, tmp_path / "jax_copy")
    jwhole, jrest = _jax_fit(3, jdir)
    port_from_jax, prest = _port_fit(3, tmp_path / "jax_copy",
                                     dropout=False)
    assert [h["epoch"] for h in prest] == [h["epoch"] for h in jrest] == [3]
    np.testing.assert_allclose(prest[0]["loss"], jrest[0]["loss"],
                               atol=RESUME_ATOL, rtol=0)
    _assert_params_close(port_from_jax.get_variables()["params"],
                         jax.device_get(jwhole.get_variables()["params"]))

    _port_fit(2, pdir, dropout=False)
    shutil.copytree(pdir, tmp_path / "port_copy")
    pwhole, prest = _port_fit(3, pdir, dropout=False)
    jax_from_port, jrest = _jax_fit(3, tmp_path / "port_copy")
    assert [h["epoch"] for h in jrest] == [3]
    np.testing.assert_allclose(jrest[0]["loss"], prest[0]["loss"],
                               atol=RESUME_ATOL, rtol=0)
    _assert_params_close(pwhole.get_variables()["params"],
                         jax.device_get(jax_from_port.get_variables()[
                             "params"]))


def test_a_transient_fault_restores_once_and_replays(tmp_path):
    """A TransientFault before step 6 (the second epoch's third) restores
    the iteration-4 snapshot and replays: the run ends where the run
    without the fault ends, bit for bit."""
    install_chaos(ChaosPlan([FaultSpec("trainer.dispatch", at_step=6)]))
    faulted, fh = _port_fit(3, tmp_path / "ckpt")
    clear_chaos()
    assert _counter("checkpoint_restore_total") == 1
    assert _counter("train_retry_total") == 1
    assert get_registry().counter(
        "train_failures_total", labels=("class",)).labels(
        "transient").value == 1
    clean, ch = _port_fit(3)
    assert [h["loss"] for h in fh] == [h["loss"] for h in ch]
    for a, b in zip(faulted.get_weights(), clean.get_weights()):
        np.testing.assert_array_equal(a, b)


def test_failures_the_policy_does_not_absorb_raise(tmp_path):
    install_chaos(ChaosPlan([FaultSpec("trainer.dispatch", at_step=5)]))
    with pytest.raises(TransientFault):          # no model_dir
        _port_fit(2)
    install_chaos(ChaosPlan([FaultSpec("trainer.dispatch", at_step=5,
                                       kind="poison")]))
    with pytest.raises(PoisonedState):
        _port_fit(2, tmp_path / "a")
    tconfig.get_config().set("train.retry_times", 1)
    install_chaos(ChaosPlan([FaultSpec("trainer.dispatch", at_step=5),
                             FaultSpec("trainer.dispatch", at_step=6)]))
    with pytest.raises(TransientFault):          # budget exhausted
        _port_fit(2, tmp_path / "b")
    assert _counter("train_retry_total") == 1


def test_resume_refuses_a_snapshot_it_cannot_read(tmp_path):
    ckpt = tmp_path / "ckpt"
    _port_fit(1, ckpt)
    (ckpt / "snapshot.99.ckpt").write_bytes(b"\x85garbage")
    with pytest.raises(ValueError):
        _port_fit(2, ckpt)
    os.remove(ckpt / "snapshot.99.ckpt")
    TLayer.reset_name_counters()
    other = _small_transformer(class_num=3)
    other.compile(topt.Adam(lr=1e-3), LOSS)
    other.model.set_checkpoint(str(ckpt))
    x, y = _data()
    with pytest.raises(ValueError, match="does not match"):
        other.fit(x, y % 3, batch_size=8, nb_epoch=2)
    TLayer.reset_name_counters()
    sgd = _small_transformer()
    sgd.compile(topt.SGD(0.1, momentum=0.9), LOSS)
    sgd.model.set_checkpoint(str(ckpt))
    with pytest.raises(ValueError):
        sgd.fit(x, y, batch_size=8, nb_epoch=2)


# ------------------------------------ the policy (tests/test_resilience)
class TestRetryBudget:
    def test_consume_and_exhaust(self):
        clk = [0.0]
        b = RetryBudget(2, 10.0, clock=lambda: clk[0])
        assert b.consume() is True
        assert b.consume() is True
        assert b.consume() is False          # 3rd failure in window

    def test_refills_past_window_boundary(self):
        clk = [0.0]
        b = RetryBudget(1, 10.0, clock=lambda: clk[0])
        assert b.consume() is True
        clk[0] = 10.0                         # exactly the boundary:
        assert b.consume() is False           # NOT yet refilled (>)
        clk[0] = 20.1                         # past the boundary
        assert b.consume() is True

    def test_window_measures_between_failures(self):
        clk = [0.0]
        b = RetryBudget(1, 10.0, clock=lambda: clk[0])
        for t in (0.0, 11.0, 22.0, 33.0):
            clk[0] = t
            assert b.consume() is True

    def test_default_clock_is_monotonic(self):
        import time
        assert RetryBudget(1, 1.0)._clock is time.perf_counter


class TrainingHalted(RuntimeError):
    """Stands for the JAX package's watchdog halt, which the classifier
    recognises by name."""


class TestRecoveryPolicy:
    def _policy(self, retries=3, elastic=True, max_reformations=2):
        return RecoveryPolicy(RetryBudget(retries, 100.0),
                              elastic=elastic,
                              max_reformations=max_reformations)

    def test_poisoned_always_raises(self):
        d = self._policy().decide(PoisonedState("nan"),
                                  have_checkpoint=True)
        assert d.action is RecoveryAction.RAISE
        assert d.failure_class is FailureClass.POISONED_STATE

    def test_unrecoverable_always_raises(self):
        d = self._policy().decide(TrainingHalted("halt"),
                                  have_checkpoint=True)
        assert d.action is RecoveryAction.RAISE
        assert d.failure_class is FailureClass.UNRECOVERABLE

    def test_lost_host_reforms_then_degrades(self):
        p = self._policy(max_reformations=1)
        d1 = p.decide(LostHost("gone"), have_checkpoint=True)
        assert d1.action is RecoveryAction.REFORM_MESH
        d2 = p.decide(LostHost("gone again"), have_checkpoint=True)
        assert d2.action is RecoveryAction.DEGRADE

    def test_lost_host_without_elastic_uses_retry_budget(self):
        p = self._policy(retries=1, elastic=False)
        d1 = p.decide(LostHost("gone"), have_checkpoint=True)
        assert d1.action is RecoveryAction.RETRY
        d2 = p.decide(LostHost("gone"), have_checkpoint=True)
        assert d2.action is RecoveryAction.RAISE

    def test_transient_needs_checkpoint(self):
        d = self._policy().decide(TransientFault("flake"),
                                  have_checkpoint=False)
        assert d.action is RecoveryAction.RAISE
        assert "model_dir" in d.reason

    def test_transient_budget_exhaustion(self):
        p = self._policy(retries=1)
        assert p.decide(TransientFault("a"), True).action \
            is RecoveryAction.RETRY
        d = p.decide(TransientFault("b"), True)
        assert d.action is RecoveryAction.RAISE
        assert "exhausted" in d.reason

    def test_unknown_treated_like_transient(self):
        d = self._policy().decide(ValueError("???"),
                                  have_checkpoint=True)
        assert d.action is RecoveryAction.RETRY
        assert d.failure_class is FailureClass.UNKNOWN
