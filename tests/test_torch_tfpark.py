"""PyTorch port, TFPark and the TensorFlow-facing layers: both packages
convert the same tf.keras models (every converter case of
``tests/test_interop.py`` and more of the layer set; variables equal leaf
by leaf, forwards within 1e-5), ``KerasModel``'s compile mapping (the
reference's SGD fault included) and ``fit`` losses within 1e-4 on
dropout-free models, every ``TFDataset`` factory, ``TFOptimizer``'s three
factories and refusals, ``TFEstimator``, ``TFPredictor``, the TF1
``train_op`` importer on ``tests/test_tf1_train_op.py``'s graphs, the GAN's
D and G steps on given noise within 1e-6, the topology test against
``isinstance``, the committed Inception-v1 spec against TensorFlow and its
stand-in against the real model, both benchmarks at a small size, and
``TFNet``/``InferenceModel.load_tf`` forward and gradient against the
reference and against TensorFlow."""

import os

import numpy as np
import pytest
import torch

tf = pytest.importorskip("tensorflow")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from analytics_zoo_tpu.common.triggers import MaxEpoch as JMaxEpoch  # noqa: E402
from analytics_zoo_tpu.pipeline.api.keras import Sequential as JSequential  # noqa: E402
from analytics_zoo_tpu.pipeline.api.keras import layers as jlayers  # noqa: E402
from analytics_zoo_tpu.pipeline.api.keras import optimizers as jopt  # noqa: E402
from analytics_zoo_tpu.pipeline.api.keras.engine import Layer as JLayer  # noqa: E402
from analytics_zoo_tpu.pipeline.api.net import TFNet as JTFNet  # noqa: E402
from analytics_zoo_tpu.pipeline.inference import (  # noqa: E402
    InferenceModel as JInferenceModel,
)
from analytics_zoo_tpu import tfpark as jtfpark  # noqa: E402
from analytics_zoo_tpu.tfpark import converter as jconverter  # noqa: E402
from analytics_zoo_tpu.tfpark import tf1_graph as jtf1  # noqa: E402
from analytics_zoo_tpu.tfpark import tf_dataset as jtfd  # noqa: E402
from analytics_zoo_tpu.tfpark.gan import gan_estimator as jgan  # noqa: E402

from analytics_zoo_torch.common import config as tconfig  # noqa: E402
from analytics_zoo_torch.common import zoo_context as tctx  # noqa: E402
from analytics_zoo_torch.common.triggers import MaxEpoch  # noqa: E402
from analytics_zoo_torch.compile import engine as tengine  # noqa: E402
from analytics_zoo_torch.feature.feature_set import FeatureSet  # noqa: E402
from analytics_zoo_torch.interop import load_jax_variables  # noqa: E402
from analytics_zoo_torch.ops import dtypes as tdtypes  # noqa: E402
from analytics_zoo_torch.pipeline.api.keras import Sequential  # noqa: E402
from analytics_zoo_torch.pipeline.api.keras import layers as tlayers  # noqa: E402
from analytics_zoo_torch.pipeline.api.keras import optimizers as topt  # noqa: E402
from analytics_zoo_torch.pipeline.api.keras.engine import Layer as TLayer  # noqa: E402
from analytics_zoo_torch.pipeline.api.net import TFNet  # noqa: E402
from analytics_zoo_torch.pipeline.inference import InferenceModel  # noqa: E402
from analytics_zoo_torch import tfpark  # noqa: E402
from analytics_zoo_torch.tfpark import converter  # noqa: E402
from analytics_zoo_torch.tfpark import tf1_graph  # noqa: E402
from analytics_zoo_torch.tfpark import tf_dataset as ttfd  # noqa: E402
from analytics_zoo_torch.tfpark.gan import gan_estimator as tgan  # noqa: E402

FWD_TOL = 1e-5
TF_TOL = 1e-4
STEP_ATOL = 1e-4
GAN_TOL = 1e-6
LOGITS = "sparse_categorical_crossentropy_with_logits"
L = tf.keras.layers


@pytest.fixture(autouse=True)
def _port_cpu(f32_policy):
    tctx.reset_zoo_context()
    tconfig.reset_config()
    tctx.init_zoo_context(device="cpu")
    tdtypes.set_policy(param_dtype="float32", compute_dtype="float32")
    TLayer.reset_name_counters()
    tf.keras.backend.clear_session()
    tf.keras.utils.set_random_seed(0)
    yield
    tdtypes.restore_policy(None)
    tctx.reset_zoo_context()
    tconfig.reset_config()


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def assert_trees_equal(got, want, path="", tol=0.0):
    """A port tree (tensors) against a reference tree (arrays), leaf by
    leaf: the same keys, shapes, dtypes, values within ``tol``."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(want), \
            (path, sorted(got) if isinstance(got, dict) else got,
             sorted(want))
        for k in want:
            assert_trees_equal(got[k], want[k], f"{path}/{k}", tol)
        return
    if isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_trees_equal(g, w, f"{path}/{i}", tol)
        return
    g = got.detach().cpu().numpy() if torch.is_tensor(got) else \
        np.asarray(got)
    w = np.asarray(want)
    assert g.shape == w.shape and g.dtype == w.dtype, (path, g.shape,
                                                       w.shape, g.dtype,
                                                       w.dtype)
    np.testing.assert_allclose(g, w, atol=tol, rtol=0, err_msg=path)


def _tnp(tree):
    """A port tree as numpy arrays."""
    if isinstance(tree, dict):
        return {k: _tnp(v) for k, v in tree.items()}
    return tree.detach().cpu().numpy()


def convert_both(tfm):
    JLayer.reset_name_counters()
    jm = jconverter.convert_keras_model(tfm)
    TLayer.reset_name_counters()
    tm = converter.convert_keras_model(tfm)
    assert [l.name for l in tm.layers] == [l.name for l in jm.layers]
    assert [type(l).__name__ for l in tm.layers] == \
        [type(l).__name__ for l in jm.layers]
    assert_trees_equal(tm.get_variables(), _np(jm.get_variables()))
    return jm, tm


def forward_both(jm, tm, xs):
    jv, tv = jm.get_variables(), tm.get_variables()
    jx = [jnp.asarray(x) for x in xs]
    tx = [torch.from_numpy(np.ascontiguousarray(x)) for x in xs]
    jout, _ = jm.apply(jv["params"], jx if len(jx) > 1 else jx[0],
                       state=jv["state"], training=False)
    tout, _ = tm.apply(tv["params"], tx if len(tx) > 1 else tx[0],
                       state=tv["state"], training=False)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout),
                               rtol=FWD_TOL, atol=FWD_TOL)
    return tout.numpy()


# ------------------------------------------------------------- tf models
def seq_mlp(dropout=True, optimizer=None, loss="sparse_categorical_crossentropy",
            metrics=("accuracy",)):
    """``TestTFPark._tf_model`` (``dropout=True``)."""
    layers = [L.Input((10,)), L.Dense(32, activation="relu")]
    if dropout:
        layers.append(L.Dropout(0.1))
    layers.append(L.Dense(3, activation="softmax"))
    m = tf.keras.Sequential(layers)
    m.compile(optimizer=optimizer or tf.keras.optimizers.Adam(0.01),
              loss=loss, metrics=list(metrics))
    return m


def two_tower():
    user = tf.keras.Input(shape=(8,), name="user_feat")
    item = tf.keras.Input(shape=(8,), name="item_feat")
    shared = L.Dense(16, activation="relu", name="shared_proj")
    u, i = shared(user), shared(item)
    both = L.Concatenate(name="cat")([u, i])
    h = L.Dense(8, activation="relu", name="h")(both)
    d = L.Subtract(name="diff")([u, i])
    merged = L.Concatenate(name="cat2")([h, d])
    out = L.Dense(2, name="logits")(merged)
    return tf.keras.Model([user, item], out)


def residual_bn():
    inp = tf.keras.Input(shape=(12,))
    h = L.Dense(12, activation="relu")(inp)
    h = L.BatchNormalization()(h)
    res = L.Add()([inp, h])
    out = L.Dense(3)(res)
    m = tf.keras.Model(inp, out)
    m.layers[2].set_weights([
        np.random.RandomState(1).rand(12).astype(np.float32) + 0.5,
        np.random.RandomState(2).randn(12).astype(np.float32),
        np.random.RandomState(3).randn(12).astype(np.float32),
        np.random.RandomState(4).rand(12).astype(np.float32) + 0.5])
    return m


def dot_bn_no_scale():
    a = tf.keras.Input(shape=(6,), name="a")
    b = tf.keras.Input(shape=(6,), name="b")
    ha = L.Dense(4, name="pa")(a)
    hb = L.Dense(4, name="pb")(b)
    ha = L.BatchNormalization(scale=False, name="bn")(ha)
    sim = L.Dot(axes=1, normalize=True, name="cos")([ha, hb])
    return tf.keras.Model([a, b], sim)


def seq_convnet():
    return tf.keras.Sequential([
        L.Input((12, 12, 3)),
        L.Conv2D(4, 3, padding="same", activation="relu"),
        L.MaxPooling2D(2),
        L.BatchNormalization(),
        L.AveragePooling2D(2, padding="same"),
        L.Conv2D(5, 2, strides=2),
        L.Activation("tanh"),
        L.Flatten(),
        L.Dense(3)])


def layer_zoo():
    inp = tf.keras.Input(shape=(10, 6))
    c = L.Conv1D(4, 3, padding="same", activation="relu")(inp)
    c = L.LayerNormalization(epsilon=1e-3)(c)
    g1 = L.GlobalAveragePooling1D()(c)
    g2 = L.GlobalMaxPooling1D()(c)
    r = L.Reshape((2, 10))(L.Flatten()(L.Conv1D(2, 1)(inp)))
    r = L.Flatten()(r)
    acts = [L.ReLU()(g1), L.LeakyReLU(0.2)(g2), L.ELU(0.5)(g1),
            L.Softmax()(g2)]
    merged = [L.Multiply()(acts[:2]), L.Average()(acts[1:3]),
              L.Maximum()(acts[2:]), L.Minimum()([acts[0], acts[3]]),
              L.Dot(axes=-1)([acts[0], acts[1]])]
    out = L.Concatenate()(merged + [L.Dense(3)(r)])
    return tf.keras.Model(inp, out)


def seq_rnn():
    return tf.keras.Sequential([
        L.Input((7,)), L.Embedding(20, 6),
        L.LSTM(5, return_sequences=True), L.GRU(4), L.Dense(2)])


def gap_net():
    inp = tf.keras.Input(shape=(8, 8, 3))
    h = L.Conv2D(6, 3, strides=2, padding="valid", use_bias=False)(inp)
    out = L.Concatenate()([L.GlobalAveragePooling2D()(h),
                           L.GlobalMaxPooling2D()(h)])
    return tf.keras.Model(inp, out)


def _randomize(tfm, seed=7):
    """Non-trivial BatchNormalization statistics."""
    rs = np.random.RandomState(seed)
    for layer in tfm.layers:
        if type(layer).__name__ == "BatchNormalization":
            layer.set_weights([
                (rs.rand(*w.shape) + 0.5).astype(np.float32)
                if i in (0, len(layer.get_weights()) - 1)
                else rs.randn(*w.shape).astype(np.float32)
                for i, w in enumerate(layer.get_weights())])
    return tfm


CONVERT = {
    "seq_mlp_dropout": (lambda: seq_mlp(), [(8, 10)], True),
    "two_tower": (two_tower, [(6, 8), (6, 8)], True),
    "residual_bn": (residual_bn, [(5, 12)], True),
    "dot_normalize_bn_no_scale": (dot_bn_no_scale, [(5, 6), (5, 6)], True),
    "seq_convnet": (lambda: _randomize(seq_convnet()), [(4, 12, 12, 3)],
                    True),
    "layer_zoo": (layer_zoo, [(3, 10, 6)], True),
    "gap_net": (gap_net, [(2, 8, 8, 3)], True),
    # the reference folds GRU's two bias rows into one: held to it only
    "seq_rnn": (seq_rnn, [(3, 7)], False),
}


@pytest.mark.parametrize("case", sorted(CONVERT))
def test_both_packages_convert_the_same_model(case):
    build, shapes, vs_tf = CONVERT[case]
    tfm = build()
    jm, tm = convert_both(tfm)
    rs = np.random.RandomState(0)
    if case == "seq_rnn":
        xs = [rs.randint(0, 20, shapes[0]).astype(np.int32)]
    else:
        xs = [rs.randn(*s).astype(np.float32) for s in shapes]
    got = forward_both(jm, tm, xs)
    if vs_tf:
        want = tfm(xs if len(xs) > 1 else xs[0], training=False).numpy()
        np.testing.assert_allclose(got, want, rtol=TF_TOL, atol=TF_TOL)


def test_shared_layer_is_a_single_instance():
    jm, tm = convert_both(two_tower())
    names = [l.name for l in tm.layers]
    assert names.count("shared_proj") == 1
    assert "shared_proj" in tm.get_variables()["params"]


def test_topology_is_decided_as_isinstance_decides():
    class Sub(tf.keras.Model):
        def __init__(self):
            super().__init__()
            self.d = L.Dense(2)

        def call(self, x):
            return self.d(x)
    sub = Sub()
    sub(np.zeros((1, 3), np.float32))
    models = [seq_mlp(), seq_convnet(), seq_rnn(), two_tower(),
              residual_bn(), layer_zoo(), sub]
    for m in models:
        assert converter.is_sequential(m) == isinstance(
            m, tf.keras.Sequential), type(m).__name__
    with pytest.raises(NotImplementedError, match="functional") as terr:
        converter.convert_keras_model(sub)
    with pytest.raises(NotImplementedError, match="functional") as jerr:
        jconverter.convert_keras_model(sub)
    assert str(terr.value) == str(jerr.value)


def test_unsupported_layer_and_dot_axes_refused_in_both():
    for build in (lambda: tf.keras.Sequential([L.Input((4,)), L.Dense(3),
                                               L.GaussianNoise(0.1)]),
                  lambda: tf.keras.Model(*(lambda a, b: ([a, b], L.Dot(
                      axes=1)([a, b])))(tf.keras.Input((3, 4)),
                                        tf.keras.Input((3, 4))))):
        tfm = build()
        with pytest.raises(NotImplementedError) as jerr:
            jconverter.convert_keras_model(tfm)
        with pytest.raises(NotImplementedError) as terr:
            converter.convert_keras_model(tfm)
        assert str(terr.value) == str(jerr.value)


# --------------------------------------------------------------- KerasModel
def keras_both(tfm):
    JLayer.reset_name_counters()
    jk = jtfpark.KerasModel(tfm)
    TLayer.reset_name_counters()
    tk = tfpark.KerasModel(tfm)
    assert_trees_equal(tk.model.get_variables(),
                       _np(jk.model.get_variables()))
    return jk, tk


@pytest.mark.parametrize("opt", ["sgd_momentum", "adam", "rmsprop",
                                 "adagrad", "none"])
def test_compile_mapping_matches_the_reference(opt):
    """ROADMAP queue 3, fault (a): any tf.keras SGD maps to ``SGD(lr)``,
    its momentum dropped, in both packages; an optimizer the mapping
    lacks becomes Adam at its learning rate."""
    optimizer = {"sgd_momentum": tf.keras.optimizers.SGD(0.0898,
                                                        momentum=0.9),
                 "adam": tf.keras.optimizers.Adam(0.01),
                 "rmsprop": tf.keras.optimizers.RMSprop(0.002),
                 "adagrad": tf.keras.optimizers.Adagrad(0.03),
                 "none": tf.keras.optimizers.Adam(0.01)}[opt]
    tfm = seq_mlp(dropout=False, optimizer=optimizer,
                  loss="hinge" if opt == "none" else "mse")
    jk, tk = keras_both(tfm)
    assert tk._compiled == jk._compiled == (opt != "none")
    if opt == "none":
        assert tk.model.optim_method is None
        with pytest.raises(AssertionError, match="compile"):
            tk.fit(np.zeros((8, 10), np.float32), np.zeros((8, 3)))
        return
    jo, to = jk.model.optim_method, tk.model.optim_method
    assert type(to).__name__ == type(jo).__name__
    assert to._init_kwargs == jo._init_kwargs
    if opt == "sgd_momentum":
        assert to._init_kwargs["momentum"] == 0.0
        assert to._init_kwargs["learning_rate"] == 0.08980000019073486
    assert tk.model.loss.name == jk.model.loss.name
    assert [type(m).__name__ for m in tk.model.metrics] == \
        [type(m).__name__ for m in jk.model.metrics]


def test_keras_model_fit_evaluate_predict_and_weights(tmp_path):
    """``fit`` losses within 1e-4 of the reference's on a dropout-free
    model, then ``train_on_batch``, ``evaluate``, ``predict`` and the
    weight methods."""
    tfm = seq_mlp(dropout=False)
    jk, tk = keras_both(tfm)
    rs = np.random.RandomState(0)
    x = rs.randn(64, 10).astype(np.float32)
    y = np.argmax(x @ rs.randn(10, 3), -1).astype(np.int32)
    jh = jk.fit(x, y, batch_size=16, epochs=3)
    th = tk.fit(x, y, batch_size=16, epochs=3)
    np.testing.assert_allclose([h["loss"] for h in th],
                               [h["loss"] for h in jh], atol=STEP_ATOL)
    assert th[-1]["loss"] < th[0]["loss"]
    jl = jk.train_on_batch(x[:16], y[:16])
    tl = tk.train_on_batch(x[:16], y[:16])
    assert abs(tl - jl) <= STEP_ATOL
    js, ts = jk.evaluate(x, y, batch_size=16), tk.evaluate(x, y,
                                                           batch_size=16)
    assert ts.keys() == js.keys()
    for k in js:
        np.testing.assert_allclose(ts[k], js[k], atol=STEP_ATOL)
    np.testing.assert_allclose(tk.predict(x, batch_size=32),
                               np.asarray(jk.predict(x, batch_size=32)),
                               atol=STEP_ATOL)
    w = tk.get_weights()
    assert [a.shape for a in w] == [np.asarray(a).shape
                                    for a in jk.get_weights()]
    path = str(tmp_path / "km.zoo")
    tk.save_model(path)
    tk.set_weights([np.zeros_like(a) for a in w])
    assert not np.any(tk.predict(x[:4]) - 1 / 3)
    tk.load_weights(path)
    for a, b in zip(tk.get_weights(), w):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------- TFDataset
def fs_equal(got, want):
    assert got.size == want.size
    assert_trees_equal([torch.from_numpy(np.asarray(a)) for a in
                        (got.x if isinstance(got.x, list) else [got.x])],
                       [np.asarray(a) for a in
                        (want.x if isinstance(want.x, list) else [want.x])])
    if want.y is None:
        assert got.y is None
    else:
        np.testing.assert_array_equal(np.asarray(got.y), np.asarray(want.y))


def _png(img):
    import cv2
    ok, buf = cv2.imencode(".png", img[..., ::-1])
    assert ok
    return buf.tobytes()


def test_every_tf_dataset_factory_matches_the_reference(tmp_path):
    import pandas as pd

    from analytics_zoo_tpu.feature.image import ImageSet as JImageSet
    from analytics_zoo_tpu.feature.text import TextSet as JTextSet
    from analytics_zoo_torch.feature.image import ImageSet
    from analytics_zoo_torch.feature.text import TextSet
    from analytics_zoo_torch.feature.tfrecord import (make_example,
                                                      write_tfrecord)
    rs = np.random.RandomState(0)
    x = rs.randn(12, 5).astype(np.float32)
    y = rs.randint(0, 3, 12)
    J, T = jtfd.TFDataset, ttfd.TFDataset

    jd = J.from_ndarrays((x, y), batch_size=4, val_tensors=(x[:4], y[:4]))
    td = T.from_ndarrays((x, y), batch_size=4, val_tensors=(x[:4], y[:4]))
    fs_equal(td.feature_set, jd.feature_set)
    fs_equal(td.val_set, jd.val_set)
    assert td.get_training_batch_size() == 4

    ds = tf.data.Dataset.from_tensor_slices((x, y))
    fs_equal(T.from_tf_data_dataset(ds, batch_size=4, max_items=9)
             .feature_set,
             J.from_tf_data_dataset(ds, batch_size=4, max_items=9)
             .feature_set)
    fs = FeatureSet.from_ndarrays(x, y)
    assert T.from_feature_set(fs, batch_per_thread=3).feature_set is fs

    path = str(tmp_path / "d.tfrecord")
    write_tfrecord(path, [make_example({"a": x[i], "b": x[i, :2],
                                        "label": y[i:i + 1]})
                          for i in range(12)])
    for feats in (["a"], ["a", "b"]):
        fs_equal(T.from_tfrecord_file([path], feats, "label").feature_set,
                 J.from_tfrecord_file([path], feats, "label").feature_set)
    with pytest.raises(ValueError, match="nope") as terr:
        T.from_tfrecord_file([path], ["nope"])
    with pytest.raises(ValueError, match="nope") as jerr:
        J.from_tfrecord_file([path], ["nope"])
    assert str(terr.value) == str(jerr.value)

    imgs = rs.randint(0, 256, (6, 8, 8, 3)).astype(np.uint8)
    labels = np.arange(6) % 2
    fs_equal(T.from_image_set(ImageSet.from_ndarrays(imgs, labels))
             .feature_set,
             J.from_image_set(JImageSet.from_ndarrays(imgs, labels))
             .feature_set)
    records = [_png(im) for im in imgs]
    tb, jb = T.from_bytes(records, labels), J.from_bytes(records, labels)
    fs_equal(tb.feature_set, jb.feature_set)
    np.testing.assert_array_equal(tb.feature_set.x, imgs)

    texts = ["the cat sat", "a dog ran far away", "the dog sat down",
             "cats and dogs"]
    fs_equal(T.from_text_set(TextSet.from_texts(texts, [0, 1, 1, 0])
                             .tokenize().word2idx().shape_sequence(5))
             .feature_set,
             J.from_text_set(JTextSet.from_texts(texts, [0, 1, 1, 0])
                             .tokenize().word2idx().shape_sequence(5))
             .feature_set)
    ts = T.from_strings(texts, [0, 1, 1, 0], sequence_length=6)
    js = J.from_strings(texts, [0, 1, 1, 0], sequence_length=6)
    fs_equal(ts.feature_set, js.feature_set)
    assert ts.word_index == js.word_index

    df = pd.DataFrame({"v": list(x[:, :3]), "s": x[:, 3], "lab": y})
    for cols in (["v"], ["v", "s"]):
        fs_equal(T.from_dataframe(df, cols, "lab").feature_set,
                 J.from_dataframe(df, cols, "lab").feature_set)
    for name in ("from_string_rdd", "from_rdd", "from_bytes_rdd"):
        with pytest.raises(NotImplementedError):
            getattr(T, name)()
    with pytest.raises(ValueError, match="batch_size"):
        T.from_ndarrays((x, y), batch_per_thread=4).get_training_batch_size()


# ---------------------------------------------------------------- TFOptimizer
def test_tf_optimizer_from_keras_trains_as_the_reference():
    tfm = two_tower()
    tfm.compile(optimizer=tf.keras.optimizers.Adam(0.01),
                loss="sparse_categorical_crossentropy")
    rs = np.random.RandomState(0)
    xu = rs.randn(64, 8).astype(np.float32)
    xi = rs.randn(64, 8).astype(np.float32)
    y = (np.sum(xu * xi, -1) > 0).astype(np.int32)
    JLayer.reset_name_counters()
    jo = jtfpark.TFOptimizer.from_keras(tfm, ([xu, xi], y))
    TLayer.reset_name_counters()
    to = tfpark.TFOptimizer.from_keras(tfm, ([xu, xi], y))
    assert_trees_equal(to.model.get_variables(),
                       _np(jo.model.get_variables()))
    jo.batch_size = to.batch_size = 16
    assert to.set_constant_gradient_clipping(-1.0, 1.0) is to
    jo.set_constant_gradient_clipping(-1.0, 1.0)
    jh = jo.optimize(end_trigger=JMaxEpoch(3))
    th = to.optimize(end_trigger=MaxEpoch(3))
    np.testing.assert_allclose([h["loss"] for h in th],
                               [h["loss"] for h in jh], atol=STEP_ATOL)


def test_tf_optimizer_from_loss_with_a_tf_dataset():
    rs = np.random.RandomState(1)
    x = rs.randn(48, 6).astype(np.float32)
    y = (x @ rs.randn(6, 1)).astype(np.float32)
    JLayer.reset_name_counters()
    jm = JSequential()
    jm.add(jlayers.Dense(1, input_shape=(6,)))
    TLayer.reset_name_counters()
    tm = Sequential()
    tm.add(tlayers.Dense(1, input_shape=(6,)))
    load_jax_variables(tm, _np(jm.init(jax.random.PRNGKey(0))))
    jo = jtfpark.TFOptimizer.from_loss(
        jm, "mse", jtfpark.TFDataset.from_ndarrays(
            (x, y), batch_size=16, val_tensors=(x[:16], y[:16])),
        optim_method="adam")
    to = tfpark.TFOptimizer.from_loss(
        tm, "mse", tfpark.TFDataset.from_ndarrays(
            (x, y), batch_size=16, val_tensors=(x[:16], y[:16])),
        optim_method="adam")
    assert to.batch_size == 16 and to.val_set is not None
    assert to.set_gradient_clipping_by_l2_norm(0.5) is to
    jo.set_gradient_clipping_by_l2_norm(0.5)
    jh = jo.optimize(end_trigger=JMaxEpoch(2))
    th = to.optimize(end_trigger=MaxEpoch(2))
    for t, j in zip(th, jh):
        np.testing.assert_allclose(t["loss"], j["loss"], atol=STEP_ATOL)
        assert t["val"].keys() == j["val"].keys()
        for k in j["val"]:
            np.testing.assert_allclose(t["val"][k], j["val"][k],
                                       atol=STEP_ATOL)


def test_tf_optimizer_refusals_match_the_reference():
    cases = [
        (ValueError, dict()),
        (NotImplementedError, dict(dataset=([], []), updates=["u"])),
        (NotImplementedError, dict(dataset=([], []), tensor_with_value={})),
        (NotImplementedError, dict(dataset=([], []), metrics={"acc": 1})),
    ]
    for exc, kw in cases:
        with pytest.raises(exc) as jerr:
            jtfpark.TFOptimizer.from_train_op(None, None, **kw)
        with pytest.raises(exc) as terr:
            tfpark.TFOptimizer.from_train_op(None, None, **kw)
        assert str(terr.value) == str(jerr.value)
    with pytest.raises(TypeError, match="unsupported dataset"):
        tfpark.TFOptimizer.from_loss(Sequential(), "mse", [1, 2])
    with pytest.raises(ValueError, match="sess="):
        with tf.Graph().as_default():
            tfpark.TFOptimizer.from_train_op(None, None, dataset=([], []))


# ----------------------------------------------------- estimator, predictor
def test_tf_estimator_and_tf_predictor_match_the_reference():
    rs = np.random.RandomState(2)
    x = rs.randn(48, 5).astype(np.float32)
    y = np.argmax(x @ rs.randn(5, 3), -1).astype(np.int32)
    JLayer.reset_name_counters()
    jm = JSequential()
    jm.add(jlayers.Dense(8, activation="relu", input_shape=(5,)))
    jm.add(jlayers.Dense(3))
    TLayer.reset_name_counters()
    tm = Sequential()
    tm.add(tlayers.Dense(8, activation="relu", input_shape=(5,)))
    tm.add(tlayers.Dense(3))
    load_jax_variables(tm, _np(jm.init(jax.random.PRNGKey(0))))
    results = {}
    from analytics_zoo_tpu.pipeline.api.keras import metrics as jmet
    from analytics_zoo_torch.pipeline.api.keras import metrics as tmet
    for pkg, mod, model, opt, met in (("jax", jtfpark, jm, jopt, jmet),
                                      ("torch", tfpark, tm, topt, tmet)):
        def model_fn(features, labels, mode, model=model, mod=mod, opt=opt):
            return mod.TFEstimatorSpec(mode, predictions=model, loss=LOGITS,
                                       optim_method=opt.Adam(lr=0.02))
        est = mod.TFEstimator(model_fn)
        est.train(lambda mod=mod: mod.TFDataset.from_ndarrays(
            (x, y), batch_size=16), steps=6)
        scores = est.evaluate(mod.TFDataset.from_ndarrays(
            (x, y), batch_per_thread=16),
            eval_methods=[met.SparseCategoricalAccuracy()])
        preds = est.predict(mod.TFDataset.from_ndarrays(
            x, batch_per_thread=16))
        predictor = mod.TFPredictor.from_outputs(
            model, mod.TFDataset.from_ndarrays(x, batch_per_thread=8))
        results[pkg] = (scores, np.asarray(preds),
                        np.asarray(predictor.predict(batch_per_thread=4)))
    (js, jp, jq), (ts, tp, tq) = results["jax"], results["torch"]
    assert ts.keys() == js.keys()
    for k in js:
        np.testing.assert_allclose(ts[k], js[k], atol=STEP_ATOL)
    np.testing.assert_allclose(tp, jp, atol=STEP_ATOL)
    np.testing.assert_allclose(tq, jq, atol=STEP_ATOL)
    np.testing.assert_allclose(tq, tp, atol=1e-6)
    assert tfpark.ModeKeys.PREDICT == jtfpark.ModeKeys.PREDICT == "infer"
    with pytest.raises(TypeError, match="TFEstimatorSpec"):
        tfpark.TFEstimator(lambda **kw: None).train(([x], y))


def test_tf_predictor_from_keras():
    tfm = seq_mlp()
    x = np.random.RandomState(3).randn(10, 10).astype(np.float32)
    JLayer.reset_name_counters()
    jp = jtfpark.TFPredictor.from_keras(
        tfm, jtfpark.TFDataset.from_ndarrays(x, batch_per_thread=4))
    TLayer.reset_name_counters()
    tp = tfpark.TFPredictor.from_keras(
        tfm, tfpark.TFDataset.from_ndarrays(x, batch_per_thread=4))
    got = tp.predict()
    np.testing.assert_allclose(got, np.asarray(jp.predict()), atol=FWD_TOL)
    np.testing.assert_allclose(got, tfm(x, training=False).numpy(),
                               atol=TF_TOL)


# ---------------------------------------------------------------- TF1 graphs
def _mlp_graph(optimizer_fn, n_in=8, n_hidden=16, n_out=3, seed=0):
    """``tests/test_tf1_train_op.py``'s TF1 MLP: placeholders +
    get_variable + minimize()."""
    g = tf.Graph()
    with g.as_default():
        tf.compat.v1.set_random_seed(seed)
        x = tf.compat.v1.placeholder(tf.float32, [None, n_in], name="x")
        y = tf.compat.v1.placeholder(tf.int32, [None], name="y")
        w1 = tf.compat.v1.get_variable("w1", [n_in, n_hidden])
        b1 = tf.compat.v1.get_variable(
            "b1", [n_hidden], initializer=tf.zeros_initializer())
        w2 = tf.compat.v1.get_variable("w2", [n_hidden, n_out])
        b2 = tf.compat.v1.get_variable(
            "b2", [n_out], initializer=tf.zeros_initializer())
        h = tf.nn.relu(tf.nn.bias_add(tf.matmul(x, w1), b1))
        logits = tf.nn.bias_add(tf.matmul(h, w2), b2)
        loss = tf.reduce_mean(
            tf.nn.sparse_softmax_cross_entropy_with_logits(
                labels=y, logits=logits))
        train_op = optimizer_fn().minimize(loss)
        init = tf.compat.v1.global_variables_initializer()
    sess = tf.compat.v1.Session(graph=g)
    sess.run(init)
    return dict(graph=g, sess=sess, x=x, y=y, logits=logits, loss=loss,
                train_op=train_op)


def _toy_data(n=128, n_in=8, n_out=3, seed=1):
    rs = np.random.RandomState(seed)
    x = rs.randn(n, n_in).astype(np.float32)
    return x, np.abs(x[:, :n_out]).argmax(1).astype(np.int32)


def test_tf1_recognition_matches_the_reference():
    for make in (lambda: tf.compat.v1.train.AdamOptimizer(
                     learning_rate=0.0123, beta1=0.8, beta2=0.95,
                     epsilon=1e-5),
                 lambda: tf.compat.v1.train.GradientDescentOptimizer(0.05),
                 lambda: tf.compat.v1.train.MomentumOptimizer(
                     0.01, momentum=0.9, use_nesterov=True),
                 lambda: tf.compat.v1.train.AdagradOptimizer(0.1),
                 lambda: tf.compat.v1.train.RMSPropOptimizer(0.01)):
        env = _mlp_graph(make)
        jm, jvars = jtf1.recognize_optimizer(env["train_op"], env["sess"])
        tm, tvars = tf1_graph.recognize_optimizer(env["train_op"],
                                                  env["sess"])
        assert tm.name == jm.name and tm._init_kwargs == jm._init_kwargs
        assert [v.name for v in tvars] == [v.name for v in jvars]
        jl, jy, jc = jtf1.split_loss(env["loss"])
        tl, ty, tc = tf1_graph.split_loss(env["loss"])
        assert (tl.name, ty.name, tc) == (jl.name, jy.name, jc)


def test_tf1_exotic_graphs_refused_as_the_reference():
    g = tf.Graph()
    with g.as_default():
        x = tf.compat.v1.placeholder(tf.float32, [None, 4], name="x")
        w = tf.compat.v1.get_variable("w", [4, 1])
        loss = tf.reduce_sum(tf.matmul(x, w))
        assign = tf.compat.v1.assign(w, w * 0.9)
        y = tf.compat.v1.placeholder(tf.int32, [None], name="y")
        w3 = tf.compat.v1.get_variable("w3", [4, 3])
        ce = tf.reduce_mean(tf.nn.sparse_softmax_cross_entropy_with_logits(
            labels=y, logits=tf.matmul(x, w3)))
        opt = tf.compat.v1.train.GradientDescentOptimizer(0.1)
        clipped = opt.apply_gradients(
            [(tf.clip_by_norm(gg, 1.0), vv)
             for gg, vv in opt.compute_gradients(ce, var_list=[w3])])
    for call in (lambda m: m.split_loss(loss),
                 lambda m: m.recognize_optimizer(assign.op, None),
                 lambda m: m.recognize_optimizer(clipped, None)):
        with pytest.raises(NotImplementedError) as jerr:
            call(jtf1)
        with pytest.raises(NotImplementedError) as terr:
            call(tf1_graph)
        assert str(terr.value) == str(jerr.value)


def test_tf1_frozen_variables_become_constants():
    g = tf.Graph()
    with g.as_default():
        x = tf.compat.v1.placeholder(tf.float32, [None, 4], name="x")
        y = tf.compat.v1.placeholder(tf.int32, [None], name="y")
        frozen = tf.compat.v1.get_variable("proj", [4, 6], trainable=False)
        w = tf.compat.v1.get_variable("w", [6, 3])
        logits = tf.nn.tanh(tf.matmul(tf.matmul(x, frozen), w))
        loss = tf.reduce_mean(
            tf.nn.sparse_softmax_cross_entropy_with_logits(
                labels=y, logits=logits))
        train_op = tf.compat.v1.train.GradientDescentOptimizer(
            0.1).minimize(loss)
        init = tf.compat.v1.global_variables_initializer()
    sess = tf.compat.v1.Session(graph=g)
    sess.run(init)
    net, crit, method = tf1_graph.recompile_train_op(train_op, loss, sess)
    jnet, jcrit, _ = jtf1.recompile_train_op(train_op, loss, sess)
    assert crit == jcrit and method.name == "sgd"
    assert "proj" in net._constants and "proj" not in net._values
    xb = np.random.RandomState(0).randn(8, 4).astype(np.float32)
    got = net.call(net.build(None, (None, 4)), xb).numpy()
    want = np.asarray(jnet.call(jnet.build(None, (None, 4)), xb))
    np.testing.assert_allclose(got, want, rtol=FWD_TOL, atol=FWD_TOL)
    np.testing.assert_allclose(got, sess.run(logits, {x: xb}),
                               rtol=FWD_TOL, atol=FWD_TOL)


def test_tf1_from_train_op_end_to_end_matches_the_reference():
    env = _mlp_graph(lambda: tf.compat.v1.train.AdamOptimizer(1e-2))
    x, y = _toy_data()
    JLayer.reset_name_counters()
    jo = jtfpark.TFOptimizer.from_train_op(
        env["train_op"], env["loss"], sess=env["sess"], dataset=(x, y))
    TLayer.reset_name_counters()
    to = tfpark.TFOptimizer.from_train_op(
        env["train_op"], env["loss"], sess=env["sess"], dataset=(x, y))
    assert_trees_equal(to.model.get_variables(),
                       _np(jo.model.get_variables()))
    want = env["sess"].run(env["logits"], {env["x"]: x[:32]})
    got = to.model.predict(x[:32], batch_size=32)
    np.testing.assert_allclose(got, want, rtol=FWD_TOL, atol=FWD_TOL)
    jo.batch_size = to.batch_size = 32
    jh = jo.optimize(end_trigger=JMaxEpoch(3))
    th = to.optimize(end_trigger=MaxEpoch(3))
    np.testing.assert_allclose([h["loss"] for h in th],
                               [h["loss"] for h in jh], atol=STEP_ATOL)
    assert th[-1]["loss"] < th[0]["loss"]


# ---------------------------------------------------------------------- GAN
def _gan_models(pkg_layers, seq_cls):
    g = seq_cls()
    g.add(pkg_layers.Dense(16, activation="relu", input_shape=(4,)))
    g.add(pkg_layers.Dense(6))
    d = seq_cls()
    d.add(pkg_layers.Dense(8, activation="tanh", input_shape=(6,)))
    d.add(pkg_layers.Dense(1))
    return g, d


@pytest.mark.parametrize("losses", ["modified", "wasserstein",
                                    "least_squares"])
def test_gan_steps_match_the_reference(losses):
    kw = lambda mod: dict(  # noqa: E731
        generator_loss_fn=getattr(mod, f"{losses}_generator_loss"),
        discriminator_loss_fn=getattr(mod, f"{losses}_discriminator_loss"))
    JLayer.reset_name_counters()
    jest = jgan.GANEstimator(*_gan_models(jlayers, JSequential),
                             **kw(jgan))
    jest._build(jax.random.PRNGKey(0))
    TLayer.reset_name_counters()
    test_ = tgan.GANEstimator(*_gan_models(tlayers, Sequential), **kw(tgan))
    test_._build(torch.Generator().manual_seed(0))
    tv = lambda t: {k: {n: torch.from_numpy(np.array(a))  # noqa: E731
                        for n, a in v.items()} for k, v in _np(t).items()}
    test_.g_params, test_.d_params = tv(jest.g_params), tv(jest.d_params)
    test_.g_opt_state = test_.g_optim.init(test_.g_params)
    test_.d_opt_state = test_.d_optim.init(test_.d_params)
    rs = np.random.RandomState(0)
    for step in range(2):
        real = rs.randn(8, 6).astype(np.float32)
        noise = rs.randn(8, 4).astype(np.float32)
        jd = jest._d_step(jest.g_params, jest.d_params, jest.g_state,
                          jest.d_state, jest.d_opt_state, jnp.asarray(real),
                          jnp.asarray(noise), jax.random.PRNGKey(step))
        td = test_._d_step(test_.g_params, test_.d_params, test_.g_state,
                           test_.d_state, test_.d_opt_state,
                           torch.from_numpy(real), torch.from_numpy(noise),
                           torch.Generator().manual_seed(step))
        assert abs(float(td[3]) - float(jd[3])) <= GAN_TOL
        assert_trees_equal(td[0], _np(jd[0]), tol=GAN_TOL)
        jest.d_params, jest.d_state, jest.d_opt_state = jd[:3]
        test_.d_params, test_.d_state, test_.d_opt_state = td[:3]
        noise = rs.randn(8, 4).astype(np.float32)
        jg = jest._g_step(jest.g_params, jest.d_params, jest.g_state,
                          jest.d_state, jest.g_opt_state, jnp.asarray(noise),
                          jax.random.PRNGKey(step))
        tg = test_._g_step(test_.g_params, test_.d_params, test_.g_state,
                           test_.d_state, test_.g_opt_state,
                           torch.from_numpy(noise),
                           torch.Generator().manual_seed(step))
        assert abs(float(tg[3]) - float(jg[3])) <= GAN_TOL
        assert_trees_equal(tg[0], _np(jg[0]), tol=GAN_TOL)
        jest.g_params, jest.g_state, jest.g_opt_state = jg[:3]
        test_.g_params, test_.g_state, test_.g_opt_state = tg[:3]
    # the six losses on the same logits
    a = rs.randn(16).astype(np.float32)
    b = rs.randn(16).astype(np.float32)
    for name in ("modified", "wasserstein", "least_squares"):
        got = getattr(tgan, f"{name}_discriminator_loss")(
            torch.from_numpy(a), torch.from_numpy(b))
        want = getattr(jgan, f"{name}_discriminator_loss")(a, b)
        assert abs(float(got) - float(want)) <= GAN_TOL
        got = getattr(tgan, f"{name}_generator_loss")(torch.from_numpy(b))
        want = getattr(jgan, f"{name}_generator_loss")(b)
        assert abs(float(got) - float(want)) <= GAN_TOL


def test_gan_train_and_generate():
    from analytics_zoo_torch.tfpark.gan import GANEstimator
    TLayer.reset_name_counters()
    g, d = _gan_models(tlayers, Sequential)
    est = GANEstimator(g, d, generator_optim_method=topt.Adam(lr=1e-3),
                       discriminator_optim_method=topt.Adam(lr=1e-3),
                       d_steps=2)
    real = np.random.RandomState(1).randn(64, 6).astype(np.float32) + 2.0
    hist = est.train(real, noise_dim=4, batch_size=16, steps=6, rng=3)
    assert len(hist) == 6
    assert all(np.isfinite(h["d_loss"]) and np.isfinite(h["g_loss"])
               for h in hist)
    out = est.generate(np.zeros((5, 4), np.float32))
    assert out.shape == (5, 6)
    # the same seed draws the same run
    TLayer.reset_name_counters()
    g2, d2 = _gan_models(tlayers, Sequential)
    est2 = GANEstimator(g2, d2, generator_optim_method=topt.Adam(lr=1e-3),
                        discriminator_optim_method=topt.Adam(lr=1e-3),
                        d_steps=2)
    assert est2.train(real, noise_dim=4, batch_size=16, steps=6,
                      rng=3) == hist


# ----------------------------------------------------- Inception-v1, benches
def test_committed_inception_spec_is_what_tensorflow_builds():
    from analytics_zoo_torch.benchmarks import inception
    real = inception.build_tf_inception_v1(1000, 224)
    assert inception.keras_spec(real) == inception.inception_v1_spec()


def test_inception_stand_in_converts_as_the_real_model():
    """The stand-in ``chip_smoke.py`` builds from the committed spec
    converts to the same port model as the real tf.keras model holding
    the stand-in's weights; both map to the same compile (SGD at the
    float32 learning rate, momentum dropped)."""
    import chip_smoke
    from analytics_zoo_torch.benchmarks import inception
    spec = inception.inception_v1_spec()
    stand_in = chip_smoke.KerasStandIn(spec, seed=0)
    real = inception.build_tf_inception_v1(1000, 224)
    assert len(stand_in.layers) == len(real.layers) == 83
    for a, b in zip(stand_in.layers, real.layers):
        assert (a.name, type(a).__name__) == (b.name, type(b).__name__)
        b.set_weights(a.get_weights())
    assert converter.is_sequential(stand_in) is False
    TLayer.reset_name_counters()
    from_stand_in = tfpark.KerasModel(stand_in)
    TLayer.reset_name_counters()
    from_real = tfpark.KerasModel(real)
    assert [l.name for l in from_stand_in.model.layers] == \
        [l.name for l in from_real.model.layers]
    assert from_stand_in.model.get_output_shape() == (None, 1000)
    assert_trees_equal(from_stand_in.model.get_variables(),
                       _tnp(from_real.model.get_variables()))
    assert from_stand_in.model.optim_method._init_kwargs == \
        from_real.model.optim_method._init_kwargs
    assert from_real.model.optim_method._init_kwargs["momentum"] == 0.0
    n = sum(int(np.prod(s)) for e in spec["layers"]
            for s in e["weight_shapes"])
    assert n == real.count_params() == 6998552


def test_inception_bench_small_matches_the_reference():
    from analytics_zoo_tpu.benchmarks import inception as jbench
    from analytics_zoo_torch.benchmarks import inception as tbench
    kw = dict(image_size=32, num_classes=10, batch_size=8, rows=16,
              timed_epochs=2, warm_epochs=1)
    want = jbench.run_inception_bench(jax.devices()[0], **kw)
    tf.keras.backend.clear_session()
    got = tbench.run_inception_bench(torch.device("cpu"), **kw)
    assert got.keys() == want.keys()
    assert got["device_kind"] == "cpu" and got["tf_layers_converted"] == \
        want["tf_layers_converted"] == 83
    assert len(got["epoch_throughputs"]) == 3 and got["value"] > 0
    # the converted model's eval forward against the reference's
    tf.keras.backend.clear_session()
    tfm = tbench.build_tf_inception_v1(10, 32)
    jm, tm = convert_both(tfm)
    x = np.random.RandomState(0).rand(4, 32, 32, 3).astype(np.float32)
    got_p = forward_both(jm, tm, [x])
    np.testing.assert_allclose(got_p.sum(-1), 1.0, atol=1e-5)


def test_bench_device_kind_is_where_the_models_run():
    """The benches label their result with the zoo context's device, the
    one the models run on; asked for another device they refuse before
    building anything."""
    from analytics_zoo_torch.benchmarks import inception, wide_deep
    assert inception.device_kind(torch.device("cpu")) == "cpu"
    refused = dict(expected_exception=(RuntimeError, ValueError),
                   match="cuda|zoo context")
    with pytest.raises(**refused):
        wide_deep.run_wide_deep_bench("cuda:0", rows=1 << 10)
    with pytest.raises(**refused):
        inception.run_inception_bench("cuda:0", rows=8)


def test_wide_deep_bench_small_matches_the_reference():
    from analytics_zoo_tpu.benchmarks import wide_deep as jbench
    from analytics_zoo_torch.benchmarks import wide_deep as tbench
    kw = dict(rows=1 << 12, batch_size=1024, timed_epochs=2, warm_epochs=1)
    want = jbench.run_wide_deep_bench(jax.devices()[0], **kw)
    got = tbench.run_wide_deep_bench(torch.device("cpu"), **kw)
    assert got.keys() == want.keys()
    assert len(got["epoch_throughputs"]) == 3
    assert 0.5 < got["train_accuracy"] <= 1.0
    # the bench's model on the reference's variables: the eval forward
    from analytics_zoo_tpu.models.recommendation import (
        ColumnFeatureInfo as JInfo, WideAndDeep as JWD)
    from analytics_zoo_torch.models.recommendation import (
        ColumnFeatureInfo, WideAndDeep)
    info = dict(wide_base_cols=["gender", "age_bucket", "education"],
                wide_base_dims=[3, 10, 16],
                wide_cross_cols=["gender_age", "edu_age"],
                wide_cross_dims=[30, 160],
                embed_cols=["occupation", "relationship"],
                embed_in_dims=[48, 8], embed_out_dims=[16, 8],
                continuous_cols=["hours_per_week", "capital_gain"])
    JLayer.reset_name_counters()
    jwd = JWD(2, JInfo(**info), model_type="wide_n_deep",
              hidden_layers=(64, 32, 16))
    TLayer.reset_name_counters()
    twd = WideAndDeep(2, ColumnFeatureInfo(**info), model_type="wide_n_deep",
                      hidden_layers=(64, 32, 16))
    load_jax_variables(twd, _np(jwd.get_variables()))
    rs = np.random.RandomState(0)
    n = 64
    cols = {"gender": rs.randint(0, 3, n), "age_bucket": rs.randint(0, 10, n),
            "education": rs.randint(0, 16, n),
            "occupation": rs.randint(0, 48, n),
            "relationship": rs.randint(0, 8, n),
            "hours_per_week": rs.rand(n).astype(np.float32),
            "capital_gain": rs.rand(n).astype(np.float32)}
    cols["gender_age"] = cols["gender"] * 10 + cols["age_bucket"]
    cols["edu_age"] = cols["education"] * 10 + cols["age_bucket"]
    feats = twd.features_from_columns(cols)
    np.testing.assert_allclose(twd.predict(feats, batch_size=32),
                               np.asarray(jwd.predict(feats, batch_size=32)),
                               rtol=FWD_TOL, atol=FWD_TOL)


# ------------------------------------------------------------------- TFNet
def _dense_keras():
    return tf.keras.Sequential([L.Input((6,)),
                                L.Dense(10, activation="tanh"),
                                L.Dense(2)])


def test_tfnet_from_keras_forward_and_gradient():
    tfm = _dense_keras()
    jnet, tnet = JTFNet.from_keras(tfm), TFNet.from_keras(tfm)
    x = np.random.RandomState(0).randn(5, 6).astype(np.float32)
    got = tnet.predict(x, batch_size=2)
    np.testing.assert_allclose(got, jnet.predict(x), atol=FWD_TOL)
    np.testing.assert_allclose(got, tfm(x).numpy(), atol=FWD_TOL)
    # call_tf's gradient, and the layer's stopped one
    w = np.random.RandomState(1).randn(5, 2).astype(np.float32)
    jg = jax.grad(lambda a: (jnet._jax_fn(a) * w).sum())(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    (tnet.tf_fn(xt) * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jg),
                               rtol=FWD_TOL, atol=FWD_TOL)
    xv = tf.constant(x)
    with tf.GradientTape() as tape:
        tape.watch(xv)
        out = tf.reduce_sum(tfm(xv) * w)
    np.testing.assert_allclose(xt.grad.numpy(),
                               tape.gradient(out, xv).numpy(),
                               rtol=FWD_TOL, atol=FWD_TOL)
    jg0 = jax.grad(lambda a: jnet.call({}, a).sum())(jnp.asarray(x))
    assert not np.any(np.asarray(jg0))
    assert not tnet.call({}, torch.from_numpy(x)).requires_grad
    assert tnet.compute_output_shape((None, 6)) == \
        jnet.compute_output_shape((None, 6)) == (None, 2)


def test_tfnet_saved_model_net_load_tf_and_inference_model(tmp_path):
    from analytics_zoo_torch.pipeline.api.net import Net
    tfm = tf.keras.Sequential([L.Input((4,)),
                               L.Dense(3, activation="softmax")])
    path = str(tmp_path / "sm")
    tf.saved_model.save(tfm, path)
    x = np.random.RandomState(0).randn(5, 4).astype(np.float32)
    net = Net.load_tf(path)
    assert isinstance(net, TFNet)
    np.testing.assert_allclose(net.predict(x), tfm(x).numpy(), atol=FWD_TOL)
    np.testing.assert_allclose(net.predict(x),
                               JTFNet.from_saved_model(path).predict(x),
                               atol=FWD_TOL)
    mark = len(tengine.CAPTURE_LOG)
    for source in (path, tfm):
        im = InferenceModel().load_tf(source)
        got = im.predict(x, batch_size=2)
        want = np.asarray(JInferenceModel().load_tf(source).predict(x))
        np.testing.assert_allclose(got, want, atol=FWD_TOL)
        assert im.warm((4,), 2)
    eager = [c for c in tengine.CAPTURE_LOG[mark:]]
    assert [c["fn"] for c in eager] == ["inference_tf_predict"] * 2
    assert all(c["eager"] and c["fallback"] is None for c in eager)


def test_tfdataset_module_imports_no_tensorflow():
    """The port's TFPark modules import TensorFlow only inside the
    functions that need it (the isolation test checks the sources)."""
    import subprocess
    import sys
    code = ("import sys; import analytics_zoo_torch.tfpark, "
            "analytics_zoo_torch.tfpark.gan, "
            "analytics_zoo_torch.tfpark.tf1_graph, "
            "analytics_zoo_torch.pipeline.api.net, "
            "analytics_zoo_torch.benchmarks.inception; "
            "print(sorted(m for m in sys.modules if m.startswith("
            "('tensorflow', 'jax', 'analytics_zoo_tpu'))))")
    env = dict(os.environ, PYTHONPATH=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_zero_padding_config_fails_as_in_the_reference():
    """ROADMAP queue 3, fault (c): Keras 3 serialises ``ZeroPadding2D(1)``
    as ``((1, 1), (1, 1))``, which both converters pass to their layer and
    fail on alike."""
    tfm = tf.keras.Sequential([L.Input((6, 6, 3)), L.ZeroPadding2D(1),
                               L.Flatten(), L.Dense(2)])
    with pytest.raises(TypeError) as jerr:
        jconverter.convert_keras_model(tfm)
    with pytest.raises(TypeError) as terr:
        converter.convert_keras_model(tfm)
    assert str(terr.value) == str(jerr.value)
