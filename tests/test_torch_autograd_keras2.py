"""PyTorch port, ``pipeline/api/autograd.py``, ``pipeline/api/keras2`` and
``pipeline/api/keras/datasets`` held to the JAX package.

autograd: every one of the 21 functions, the operators, ``Parameter``
(trainable and not), ``Constant``, ``create_lambda`` and ``CustomLoss``
built in both packages on the same inputs and weights, forward and
gradients within 1e-6 (+ 1e-6 relative), and the reference's defaults
(``mean``/``sum`` reduce axis 0 with ``keep_dims=False``).  keras2: each
layer on the same weights within 1e-6, the Keras-2 defaults that differ
from Keras-1 (``bias_initializer``, ``data_format``, ``padding``,
``dilation_rate``) and the ``epochs`` spelling of ``fit``.  The dataset
loaders are copies: bit-identical arrays on their synthetic fallbacks
and on ``.npz`` archives written to ``tmp_path``."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from analytics_zoo_tpu.pipeline.api import autograd as JA
from analytics_zoo_tpu.pipeline.api import keras2 as jk2
from analytics_zoo_tpu.pipeline.api.keras import Model as JModel
from analytics_zoo_tpu.pipeline.api.keras import Sequential as JSequential
from analytics_zoo_tpu.pipeline.api.keras import datasets as jdatasets
from analytics_zoo_tpu.pipeline.api.keras import optimizers as jopt
from analytics_zoo_tpu.pipeline.api.keras.engine import Layer as JLayer
from analytics_zoo_tpu.pipeline.api.keras.layers import Dense as JDense

from analytics_zoo_torch.common import config as tconfig
from analytics_zoo_torch.common import zoo_context as tctx
from analytics_zoo_torch.interop import load_jax_variables
from analytics_zoo_torch.ops import dtypes as tdtypes
from analytics_zoo_torch.ops import kernels
from analytics_zoo_torch.pipeline.api import autograd as A
from analytics_zoo_torch.pipeline.api import keras2 as k2
from analytics_zoo_torch.pipeline.api.keras import Model, Sequential
from analytics_zoo_torch.pipeline.api.keras import datasets
from analytics_zoo_torch.pipeline.api.keras import optimizers as topt
from analytics_zoo_torch.pipeline.api.keras.engine import Layer as TLayer
from analytics_zoo_torch.pipeline.api.keras.layers import Dense
from analytics_zoo_torch.pipeline.api.keras.topology import tree_leaves


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


def _arr(shape, seed, positive=False):
    a = np.random.RandomState(seed).randn(*shape).astype(np.float32)
    return np.abs(a) + 0.1 if positive else a


def _pair(build, shapes):
    """The same Variable function built by ``create_lambda`` in both
    packages, the port's weights the reference's."""
    JLayer.reset_name_counters()
    jm = JA.create_lambda(lambda *vs: build(JA, *vs), shapes)
    TLayer.reset_name_counters()
    tm = A.create_lambda(lambda *vs: build(A, *vs), shapes)
    jvars = jax.device_get(jm.init(jax.random.PRNGKey(0)))
    load_jax_variables(tm, jvars)
    return jm, tm, jvars


def _check(build, shapes, positive=False, grads=True):
    jm, tm, jvars = _pair(build, shapes)
    single = not isinstance(shapes[0], (list, tuple))
    all_shapes = [shapes] if single else list(shapes)
    xs = [_arr((3,) + tuple(s), i, positive) for i, s in
          enumerate(all_shapes)]
    jin = xs[0] if single else xs
    want, _ = jm.apply(jvars["params"], jin, state=jvars["state"])
    want = np.asarray(want)
    tx = [torch.as_tensor(x).requires_grad_() for x in xs]
    tp = {k: {n: t.detach().requires_grad_() for n, t in v.items()}
          for k, v in tm.get_variables()["params"].items()}
    got, _ = tm.apply(tp, tx[0] if single else tx, state={})
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-6,
                               rtol=1e-6)
    if not grads:
        return got
    w = _arr(want.shape, 99)

    def jloss(p, ins):
        out, _ = jm.apply(p, ins[0] if single else ins,
                          state=jvars["state"])
        return jnp.sum(out * w)
    jgp, jgx = jax.device_get(jax.grad(jloss, argnums=(0, 1))(
        jvars["params"], [jnp.asarray(x) for x in xs]))
    (got * torch.as_tensor(w)).sum().backward()
    for t, g in zip(tx, jgx):
        np.testing.assert_allclose(t.grad.numpy(), g, atol=1e-6, rtol=1e-6)
    for layer in jgp:
        for name, g in jgp[layer].items():
            tg = tp[layer][name].grad
            tg = np.zeros_like(g) if tg is None else tg.numpy()
            np.testing.assert_allclose(tg, g, atol=1e-6, rtol=1e-6)
    return got


# ------------------------------------------------------ the 21 functions
FUNCTIONS = {
    "mean": (lambda M, v: M.mean(v, axis=1), (4, 5)),
    "mean_default_axis0": (lambda M, v: M.mean(v), (4,)),
    "mean_keep_dims": (lambda M, v: M.mean(v, axis=2, keep_dims=True),
                       (4, 5)),
    "sum": (lambda M, v: M.sum(v, axis=1, keep_dims=True), (4, 5)),
    "sum_default_axis0": (lambda M, v: M.sum(v), (4,)),
    "abs": (lambda M, v: M.abs(v), (5,)),
    "clip": (lambda M, v: M.clip(v, -0.5, 0.7), (5,)),
    "square": (lambda M, v: M.square(v), (5,)),
    "sqrt": (lambda M, v: M.sqrt(v), (5,)),
    "exp": (lambda M, v: M.exp(v), (5,)),
    "log": (lambda M, v: M.log(v), (5,)),
    "pow": (lambda M, v: M.pow(v, 1.5), (5,)),
    "pow_int": (lambda M, v: M.pow(v, 3), (5,)),
    "maximum": (lambda M, v: M.maximum(v, M.square(v) - 1.0), (5,)),
    "maximum_scalar": (lambda M, v: M.maximum(v, 0.3), (5,)),
    "minimum": (lambda M, v: M.minimum(M.exp(v), v + 1.0), (5,)),
    "minimum_scalar": (lambda M, v: M.minimum(v, -0.2), (5,)),
    "softsign": (lambda M, v: M.softsign(v), (5,)),
    "softplus": (lambda M, v: M.softplus(v * 10.0), (5,)),
    "expand_dims": (lambda M, v: M.expand_dims(v, 1), (5,)),
    "expand_dims_last": (lambda M, v: M.expand_dims(v, -1), (5,)),
    "contiguous": (lambda M, v: M.contiguous(v) * 2.0, (5,)),
    "l2_normalize": (lambda M, v: M.l2_normalize(v, axis=-1), (4, 5)),
    "l2_normalize_axis1": (lambda M, v: M.l2_normalize(v, axis=1), (4, 5)),
    "mm": (lambda M, a, b: M.mm(a, b), [(3, 4), (4, 2)]),
    "mm_axes": (lambda M, a, b: M.mm(a, b, axes=[[2], [1]]),
                [(3, 4), (4, 2)]),
    "batch_dot": (lambda M, a, b: M.batch_dot(a, b, axes=(1, 1)),
                  [(4,), (4,)]),
    "batch_dot_3d": (lambda M, a, b: M.batch_dot(a, b), [(3, 4), (4, 3)]),
    "dot": (lambda M, a, b: M.dot(a, b), [(6,), (6,)]),
    "stack": (lambda M, a, b: M.stack([a, b], axis=1), [(4,), (4,)]),
    "stack_axis2": (lambda M, a, b: M.stack([a, b], axis=2),
                    [(3, 4), (3, 4)]),
    "concatenate": (lambda M, a, b: M.concatenate([a, b]), [(4,), (2,)]),
    "concatenate_axis1": (lambda M, a, b: M.concatenate([a, b], axis=1),
                          [(2, 4), (3, 4)]),
}
POSITIVE = {"sqrt", "log", "pow"}


@pytest.mark.parametrize("name", sorted(FUNCTIONS))
def test_autograd_function_matches_the_reference(name):
    build, shapes = FUNCTIONS[name]
    _check(build, shapes, positive=name in POSITIVE)


def test_every_function_is_covered():
    names = {"mean", "sum", "abs", "clip", "square", "sqrt", "exp", "log",
             "pow", "maximum", "minimum", "softsign", "softplus",
             "expand_dims", "contiguous", "l2_normalize", "mm",
             "batch_dot", "dot", "stack", "concatenate"}
    assert len(names) == 21
    assert all(callable(getattr(A, n)) for n in names)
    assert names <= {k.split("_default")[0].split("_keep")[0]
                     .split("_scalar")[0].split("_axis")[0]
                     .split("_int")[0].split("_3d")[0].split("_last")[0]
                     for k in FUNCTIONS}


OPERATORS = {
    "arith": (lambda M, a, b: (a * 2.0 + b - 1.0) / 2.0, [(4,), (4,)]),
    "reflected": (lambda M, a, b: 1.0 - a + 2.0 * b - 3.0 / (M.abs(a) + 1),
                  [(4,), (4,)]),
    "vv": (lambda M, a, b: a * b - a / (M.square(b) + 1.0) + (-a),
           [(4,), (4,)]),
    "pow_op": (lambda M, a: M.abs(a) ** 2.5, (4,)),
    "getitem": (lambda M, a: a[:, 1:3] * 3.0, (5,)),
    "index_select": (lambda M, a: a.index_select(1, 2), (4, 3)),
    "slice": (lambda M, a: a.slice(1, 2, 3), (6, 3)),
}


@pytest.mark.parametrize("name", sorted(OPERATORS))
def test_variable_operators_match_the_reference(name):
    build, shapes = OPERATORS[name]
    _check(build, shapes)


@pytest.mark.parametrize("trainable", [True, False])
def test_parameters_and_constants_match_the_reference(trainable):
    def build(M, v):
        w = M.Parameter((4, 3), init="uniform", trainable=trainable)
        b = M.Parameter((3,), init="one")
        c = M.Constant(np.array([1.0, -2.0, 0.5], np.float64))
        return (M.mm(v, w) + b) * c - M.Constant([[0.25, 0.5, 1.0]])
    out = _check(build, (4,))
    assert out.dtype == torch.float32
    # both Parameters are leaves; the non-trainable one enters detached,
    # so _check held its gradient at the reference's zero
    net = A.create_lambda(lambda v: build(A, v), (4,))
    assert len(tree_leaves(net.get_variables()["params"])) == 2
    with pytest.raises(ValueError, match="no batch input"):
        A.Parameter((2,)) + A.Parameter((2,))


def test_non_trainable_parameter_stays_fixed_through_fit():
    x = A.Variable(input_shape=(2,))
    w = A.Parameter((2, 2), init="one", trainable=False)
    model = Model(x.node, A.mm(x, w).node)
    model.compile(topt.Adam(lr=0.1), "mse")
    xs = np.random.RandomState(0).randn(64, 2).astype(np.float32)
    model.fit(xs, np.zeros((64, 2), np.float32), batch_size=32, nb_epoch=3)
    leaf, = tree_leaves(model.get_variables()["params"])
    np.testing.assert_array_equal(leaf.numpy(), np.ones((2, 2)))


def _custom_loss(M):
    # custom_loss_example.py's huber-ish loss
    def loss(y_true, y_pred):
        err = M.abs(y_true - y_pred)
        return M.mean(M.minimum(M.square(err), err), axis=1)
    return loss


def test_custom_loss_matches_the_reference_and_trains():
    jl = JA.CustomLoss(_custom_loss(JA), y_pred_shape=(3,))
    tl = A.CustomLoss(_custom_loss(A), y_pred_shape=(3,))
    yt = _arr((8, 3), 1)
    yp = _arr((8, 3), 2)
    np.testing.assert_allclose(
        float(tl(torch.as_tensor(yt), torch.as_tensor(yp))),
        float(jl(jnp.asarray(yt), jnp.asarray(yp))), atol=1e-6)
    # the example's model and data, both packages, the same weights
    rs = np.random.RandomState(0)
    x = rs.randn(512, 4).astype(np.float32)
    y = (x @ rs.randn(4, 1)).astype(np.float32)
    nets = []
    for pkg in ("jax", "port"):
        seq = (JSequential if pkg == "jax" else Sequential)()
        D = JDense if pkg == "jax" else Dense
        seq.add(D(8, activation="relu", input_shape=(4,), name="h"))
        seq.add(D(1, name="o"))
        nets.append(seq)
    jm, tm = nets
    load_jax_variables(tm, jax.device_get(jm.init(jax.random.PRNGKey(1))))
    jm.compile(jopt.Adam(lr=0.02), jl)
    tm.compile(topt.Adam(lr=0.02), tl)
    jh = jm.fit(x, y, batch_size=64, nb_epoch=3, shuffle=False)
    th = tm.fit(x, y, batch_size=64, nb_epoch=3, shuffle=False)
    np.testing.assert_allclose([h["loss"] for h in th],
                               [h["loss"] for h in jh], atol=1e-4)
    assert th[-1]["loss"] < th[0]["loss"]


def test_create_lambda_is_a_layer_in_a_graph():
    swish = A.create_lambda(
        lambda v: v * A.clip(v + 3.0, 0.0, 6.0) / 6.0, input_shapes=(5,))
    arr = _arr((4, 5), 3)
    variables = swish.init(torch.Generator().manual_seed(0))
    out, _ = swish.apply(variables["params"], torch.as_tensor(arr),
                         state=variables["state"])
    np.testing.assert_allclose(out.numpy(),
                               arr * np.clip(arr + 3, 0, 6) / 6, rtol=1e-6)
    two = A.create_lambda(lambda a, b: A.dot(a, b), [(3,), (3,)])
    assert two.get_output_shape() == (None, 1)


# ------------------------------------------------------------------ keras2
def _k2_pair(make, in_shape, seed=0):
    JLayer.reset_name_counters()
    jseq = jk2.Sequential()
    jseq.add(make(jk2, in_shape))
    TLayer.reset_name_counters()
    tseq = k2.Sequential()
    tseq.add(make(k2, in_shape))
    jvars = jax.device_get(jseq.init(jax.random.PRNGKey(seed)))
    load_jax_variables(tseq, jvars)
    x = _arr((3,) + tuple(in_shape), seed + 5)
    want = np.asarray(jseq.predict(x, batch_size=3))
    got = tseq.predict(x, batch_size=3)
    assert got.shape == want.shape
    assert tseq.get_output_shape() == jseq.get_output_shape()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)
    return jseq, tseq


KERAS2 = {
    "Dense": (lambda M, s: M.Dense(5, activation="tanh", input_shape=s),
              (4,)),
    "Dense_no_bias": (lambda M, s: M.Dense(5, use_bias=False,
                                           input_shape=s), (4,)),
    "Conv1D": (lambda M, s: M.Conv1D(4, 3, strides=2, input_shape=s),
               (9, 3)),
    "Conv1D_same": (lambda M, s: M.Conv1D(4, 3, padding="same",
                                          input_shape=s), (9, 3)),
    "Conv2D": (lambda M, s: M.Conv2D(4, (3, 2), input_shape=s), (7, 6, 2)),
    "Conv2D_same_strided": (lambda M, s: M.Conv2D(
        4, 3, strides=2, padding="same", input_shape=s), (7, 6, 2)),
    "Conv2D_dilated": (lambda M, s: M.Conv2D(
        3, 3, dilation_rate=(2, 2), input_shape=s), (9, 8, 2)),
    "Conv2D_channels_first": (lambda M, s: M.Conv2D(
        3, 2, data_format="channels_first", input_shape=s), (2, 6, 5)),
    "MaxPooling1D": (lambda M, s: M.MaxPooling1D(2, input_shape=s), (8, 3)),
    "AveragePooling1D": (lambda M, s: M.AveragePooling1D(
        3, strides=2, padding="same", input_shape=s), (8, 3)),
    "MaxPooling2D": (lambda M, s: M.MaxPooling2D(input_shape=s), (6, 6, 2)),
    "AveragePooling2D": (lambda M, s: M.AveragePooling2D(
        (3, 2), strides=(1, 2), input_shape=s), (6, 6, 2)),
    "GlobalAveragePooling1D": (lambda M, s: M.GlobalAveragePooling1D(
        input_shape=s), (5, 3)),
    "GlobalAveragePooling2D": (lambda M, s: M.GlobalAveragePooling2D(
        input_shape=s), (4, 5, 3)),
    "GlobalAveragePooling3D": (lambda M, s: M.GlobalAveragePooling3D(
        input_shape=s), (3, 4, 5, 2)),
    "GlobalMaxPooling1D": (lambda M, s: M.GlobalMaxPooling1D(
        input_shape=s), (5, 3)),
    "GlobalMaxPooling2D": (lambda M, s: M.GlobalMaxPooling2D(
        input_shape=s), (4, 5, 3)),
    "GlobalMaxPooling3D": (lambda M, s: M.GlobalMaxPooling3D(
        input_shape=s), (3, 4, 5, 2)),
    "Cropping1D": (lambda M, s: M.Cropping1D((1, 2), input_shape=s),
                   (7, 3)),
    "LocallyConnected1D": (lambda M, s: M.LocallyConnected1D(
        4, 3, strides=2, input_shape=s), (9, 3)),
    "Activation": (lambda M, s: M.Activation("relu", input_shape=s), (5,)),
    "Dropout": (lambda M, s: M.Dropout(0.3, input_shape=s), (5,)),
    "Flatten": (lambda M, s: M.Flatten(input_shape=s), (3, 4)),
    "Softmax": (lambda M, s: M.Softmax(input_shape=s), (3, 4)),
    "Softmax_axis1": (lambda M, s: M.Softmax(axis=1, input_shape=s),
                      (3, 4)),
    "LSTM": (lambda M, s: M.LSTM(4, return_sequences=True, input_shape=s),
             (5, 3)),
    "GRU": (lambda M, s: M.GRU(4, go_backwards=True, input_shape=s),
            (5, 3)),
    "SimpleRNN": (lambda M, s: M.SimpleRNN(4, activation="relu",
                                           input_shape=s), (5, 3)),
    "BatchNormalization": (lambda M, s: M.BatchNormalization(
        input_shape=s), (5,)),
}


@pytest.mark.parametrize("name", sorted(KERAS2))
def test_keras2_layer_matches_the_reference(name):
    make, shape = KERAS2[name]
    _k2_pair(make, shape)


def test_keras2_embedding_and_lstm_defaults_match_the_reference():
    def make(M, s):
        return M.Embedding(20, 6, input_shape=s)
    jseq, tseq = (jk2.Sequential(), k2.Sequential())
    JLayer.reset_name_counters()
    jseq.add(make(jk2, (5,)))
    jseq.add(jk2.LSTM(3))
    TLayer.reset_name_counters()
    tseq.add(make(k2, (5,)))
    tseq.add(k2.LSTM(3))
    jvars = jax.device_get(jseq.init(jax.random.PRNGKey(2)))
    load_jax_variables(tseq, jvars)
    x = np.random.RandomState(0).randint(0, 20, (4, 5)).astype(np.int32)
    np.testing.assert_allclose(tseq.predict(x), np.asarray(jseq.predict(x)),
                               atol=1e-6)
    # keras-2's LSTM starts its forget gate's bias at 1, keras-1's at 0
    own = k2.LSTM(3, input_shape=(5, 6)).init(
        torch.Generator().manual_seed(0))["params"]
    np.testing.assert_array_equal(own["bias"][3:6].numpy(), 1.0)
    np.testing.assert_array_equal(own["bias"][:3].numpy(), 0.0)
    with pytest.warns(UserWarning, match="mask_zero"):
        k2.Embedding(10, 4, mask_zero=True)


def test_keras2_merges_match_the_reference():
    from analytics_zoo_tpu.pipeline.api.keras import Input as JInput
    from analytics_zoo_torch.pipeline.api.keras import Input
    pairs = ["add", "multiply", "average", "maximum", "minimum",
             "subtract", "concatenate"]
    for fn in pairs:
        nets = []
        for M, In, Mo in ((jk2, JInput, JModel), (k2, Input, Model)):
            a, b = In(shape=(4,)), In(shape=(4,))
            nets.append(Mo([a, b], getattr(M, fn)([a, b])))
        jm, tm = nets
        xa, xb = _arr((3, 4), 1), _arr((3, 4), 2)
        want = np.asarray(jm.predict([xa, xb]))
        np.testing.assert_allclose(tm.predict([xa, xb]), want, atol=1e-6)
    for cls in ("Add", "Multiply", "Average", "Maximum", "Minimum",
                "Subtract", "Concatenate"):
        assert issubclass(getattr(k2, cls), k2.layers.k1.Merge)


def test_keras2_defaults_differ_from_keras1_as_in_the_reference():
    # bias_initializer: zeros by default, any initializer when asked
    TLayer.reset_name_counters()
    d0 = k2.Dense(4, input_shape=(3,)).init(
        torch.Generator().manual_seed(0))["params"]
    np.testing.assert_array_equal(d0["bias"].numpy(), 0.0)
    d1 = k2.Dense(4, bias_initializer="one", input_shape=(3,)).init(
        torch.Generator().manual_seed(0))["params"]
    np.testing.assert_array_equal(d1["bias"].numpy(), 1.0)
    c1 = k2.Conv2D(3, 2, bias_initializer="uniform",
                   input_shape=(5, 5, 2)).init(
        torch.Generator().manual_seed(0))["params"]
    assert float(c1["bias"].abs().sum()) > 0
    jc = jk2.Conv2D(3, 2, bias_initializer="uniform", input_shape=(5, 5, 2))
    tc = k2.Conv2D(3, 2, bias_initializer="uniform", input_shape=(5, 5, 2))
    assert tc.border_mode == jc.border_mode == "valid"
    assert tc.dim_ordering == jc.dim_ordering == "tf"
    assert tc.dilation == jc.dilation == (1, 1)
    tf = k2.Conv2D(3, 2, data_format="channels_first",
                   dilation_rate=2, input_shape=(2, 5, 5))
    assert tf.dim_ordering == "th" and tf.dilation == (2, 2)
    assert k2.Dropout(0.25).p == 0.25
    with pytest.raises(ValueError, match="data_format"):
        k2.Conv2D(3, 2, data_format="nchw")
    with pytest.raises(NotImplementedError, match="channels_last"):
        k2.MaxPooling2D(data_format="channels_first")
    with pytest.raises(ValueError, match="valid"):
        k2.LocallyConnected1D(3, 2, padding="same")


def test_keras2_fit_takes_epochs():
    JLayer.reset_name_counters()
    jm = jk2.Sequential()
    jm.add(jk2.Dense(6, activation="relu", input_shape=(4,)))
    jm.add(jk2.Dense(1))
    TLayer.reset_name_counters()
    tm = k2.Sequential()
    tm.add(k2.Dense(6, activation="relu", input_shape=(4,)))
    tm.add(k2.Dense(1))
    load_jax_variables(tm, jax.device_get(jm.init(jax.random.PRNGKey(0))))
    x = _arr((64, 4), 0)
    y = x.sum(axis=1, keepdims=True)
    jm.compile(jopt.Adam(lr=0.01), "mse")
    tm.compile(topt.Adam(lr=0.01), "mse")
    jh = jm.fit(x, y, batch_size=16, epochs=3, shuffle=False)
    th = tm.fit(x, y, batch_size=16, epochs=3, shuffle=False)
    assert len(th) == 3
    np.testing.assert_allclose([h["loss"] for h in th],
                               [h["loss"] for h in jh], atol=1e-4)


# ---------------------------------------------------------------- datasets
def _same(got, want):
    if isinstance(want, tuple):
        assert isinstance(got, tuple) and len(got) == len(want)
        for g, w in zip(got, want):
            _same(g, w)
        return
    assert got.dtype == want.dtype and got.shape == want.shape
    if want.dtype == object:
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
            assert g.dtype == w.dtype
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name,kw", [
    ("mnist", {"n_train": 300, "n_test": 50}),
    ("boston_housing", {}),
    ("boston_housing", {"n_train": 100, "n_test": 20, "seed": 5}),
    ("imdb", {"n_train": 200, "n_test": 50}),
    ("imdb", {"n_train": 100, "n_test": 30, "num_words": 80,
              "maxlen": 40}),
    ("reuters", {"n_train": 200, "n_test": 50}),
    ("reuters", {"n_train": 100, "n_test": 30, "num_words": 500})])
def test_dataset_synthetic_fallback_is_the_references(name, kw):
    got = getattr(datasets, name).load_data(**kw)
    want = getattr(jdatasets, name).load_data(**kw)
    _same(got, want)


def test_dataset_archives_load_as_in_the_reference(tmp_path):
    rs = np.random.RandomState(0)
    mnist = tmp_path / "mnist.npz"
    np.savez(mnist, x_train=rs.randint(0, 255, (20, 28, 28)).astype(
        np.uint8), y_train=rs.randint(0, 10, 20).astype(np.uint8),
        x_test=rs.randint(0, 255, (5, 28, 28)).astype(np.uint8),
        y_test=rs.randint(0, 10, 5).astype(np.uint8))
    _same(datasets.mnist.load_data(path=str(mnist)),
          jdatasets.mnist.load_data(path=str(mnist)))
    boston = tmp_path / "boston.npz"
    np.savez(boston, x=rs.rand(60, 13), y=rs.rand(60))
    _same(datasets.boston_housing.load_data(str(boston), 40, 20),
          jdatasets.boston_housing.load_data(str(boston), 40, 20))
    seqs = np.empty(30, dtype=object)
    seqs[:] = [rs.randint(1, 300, rs.randint(3, 12)) for _ in range(30)]
    raw = tmp_path / "raw.npz"
    np.savez(raw, x=seqs, y=rs.randint(0, 2, 30))
    split = tmp_path / "split.npz"
    np.savez(split, x_train=seqs[:20], y_train=rs.randint(0, 46, 20),
             x_test=seqs[20:], y_test=rs.randint(0, 46, 10))
    for mod in ("imdb", "reuters"):
        for path in (raw, split):
            for words in (None, 100):
                _same(getattr(datasets, mod).load_data(
                          path=str(path), num_words=words),
                      getattr(jdatasets, mod).load_data(
                          path=str(path), num_words=words))
    with pytest.raises(ValueError, match="maxlen"):
        datasets.imdb.load_data(maxlen=8)
