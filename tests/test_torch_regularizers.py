"""PyTorch port, the regularizers: ``keras/regularizers.py``, the
``regularizer=`` of ``Layer.add_weight``, ``Layer.regularization_loss``
and ``Container.regularization_loss_tree``, and the trainer's objective
``loss + penalty`` (the reported loss, the history and ``evaluate``
without it), against the JAX package on shared weights under a float32
compute policy.  Every reference constructor that takes a
``W_regularizer``, ``U_regularizer`` or ``b_regularizer`` takes it in the
port too (read from the reference's sources with ``ast``)."""

import ast
import inspect
import pathlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from analytics_zoo_tpu.pipeline.api.keras import Input as JInput
from analytics_zoo_tpu.pipeline.api.keras import Model as JModel
from analytics_zoo_tpu.pipeline.api.keras import Sequential as JSequential
from analytics_zoo_tpu.pipeline.api.keras import layers as jl
from analytics_zoo_tpu.pipeline.api.keras import optimizers as jopt
from analytics_zoo_tpu.pipeline.api.keras import regularizers as jreg
from analytics_zoo_tpu.pipeline.api.keras.engine import Layer as JLayer

from analytics_zoo_torch.common import config as tconfig
from analytics_zoo_torch.common import zoo_context as tctx
from analytics_zoo_torch.interop import load_jax_variables
from analytics_zoo_torch.ops import dtypes as tdtypes
from analytics_zoo_torch.ops import kernels
from analytics_zoo_torch.parallel.trainer import DistributedTrainer
from analytics_zoo_torch.pipeline.api.keras import Input as TInput
from analytics_zoo_torch.pipeline.api.keras import Model as TModel
from analytics_zoo_torch.pipeline.api.keras import Sequential as TSequential
from analytics_zoo_torch.pipeline.api.keras import layers as tl
from analytics_zoo_torch.pipeline.api.keras import objectives as tobj
from analytics_zoo_torch.pipeline.api.keras import optimizers as topt
from analytics_zoo_torch.pipeline.api.keras import regularizers as treg
from analytics_zoo_torch.pipeline.api.keras.engine import Layer as TLayer

REPO = pathlib.Path(__file__).resolve().parents[1]
REF_LAYERS = REPO / "analytics_zoo_tpu/pipeline/api/keras/layers"
ATOL = 1e-6


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


def test_regularizer_creators_match_the_reference():
    for name in ("l1", "l2", "l1l2", "L1Regularizer", "L2Regularizer",
                 "L1L2Regularizer"):
        assert getattr(treg, name)() == getattr(jreg, name)()
    assert treg.l1(0.3) == jreg.l1(0.3) == (0.3, 0.0)
    assert treg.l2(0.3) == jreg.l2(0.3) == (0.0, 0.3)
    assert treg.l1l2(0.1, 0.2) == jreg.l1l2(0.1, 0.2) == (0.1, 0.2)


def _regularizer_params(path):
    """``{class: [regularizer args of its __init__]}`` of one reference
    source."""
    out = {}
    for node in ast.walk(ast.parse(path.read_text())):
        if not isinstance(node, ast.ClassDef):
            continue
        for fn in node.body:
            if isinstance(fn, ast.FunctionDef) and fn.name == "__init__":
                args = [a.arg for a in fn.args.args + fn.args.kwonlyargs
                        if a.arg.endswith("_regularizer")]
                if args:
                    out[node.name] = args
    return out


def _subclasses(cls):
    for sub in cls.__subclasses__():
        yield sub
        yield from _subclasses(sub)


def test_every_reference_regularizer_argument_has_its_counterpart():
    """The reference's 27 lines that use ``regularizer=`` (signatures and
    ``add_weight`` calls) sit in five files; each class that declares a
    regularizer argument, and each of its subclasses, takes the same
    arguments in the port."""
    uses = sum(1 for p in REF_LAYERS.glob("*.py")
               for line in p.read_text().splitlines()
               if "regularizer=" in line)
    assert uses == 27
    declared = {}
    for path in sorted(REF_LAYERS.glob("*.py")):
        declared.update(_regularizer_params(path))
    assert set(declared) == {"Dense", "Highway", "MaxoutDense", "_ConvND",
                             "CAdd", "CMul", "Embedding", "SparseEmbedding",
                             "_RNNBase"}
    # keras2's Conv1D/Conv2D and LSTM/GRU/SimpleRNN subclass these bases
    # too: imported here, so that the subclasses seen do not depend on
    # what an earlier test in the same process imported
    import analytics_zoo_torch.pipeline.api.keras2  # noqa: F401
    import analytics_zoo_tpu.pipeline.api.keras2  # noqa: F401
    from analytics_zoo_tpu.pipeline.api.keras.layers import (
        conv as jconv, recurrent as jrec)
    from analytics_zoo_torch.pipeline.api.keras.layers import (
        conv as tconv, recurrent as trec)
    bases = {"_ConvND": (jconv._ConvND, tconv._ConvND),
             "_RNNBase": (jrec._RNNBase, trec._RNNBase)}
    checked = 0
    for name, args in declared.items():
        if name in bases:
            jbase, tbase = bases[name]
            names = {(c.__module__.split(".", 1)[1], c.__name__)
                     for c in _subclasses(jbase)}
            # every reference subclass that the port has, by module and
            # name, and the base itself
            pairs = [(tbase, args)] + [
                (c, args) for c in _subclasses(tbase)
                if (c.__module__.split(".", 1)[1], c.__name__) in names]
        else:
            pairs = [(getattr(tl, name), args)]
        for cls, want in pairs:
            for arg in want:
                # the arg itself, or **kwargs handed on to a base that has
                # it with the default None
                for klass in cls.__mro__:
                    params = inspect.signature(klass.__init__).parameters
                    if arg in params:
                        assert params[arg].default is None, (cls, arg)
                        break
                    assert any(p.kind is p.VAR_KEYWORD
                               for p in params.values()), (cls, arg)
                else:
                    raise AssertionError((cls.__name__, arg))
            checked += 1
    # 7 classes, _ConvND and its 6 subclasses and keras2's 2, _RNNBase
    # and its 3 and keras2's 3
    assert checked == 23


# a nested model: a graph Model over a Sequential of recurrent and conv
# layers, then a Sequential of dense-family layers; every penalty kind,
# and a b_regularizer on a Dense without a bias, which is ignored
def _nested(L, K):
    Input, Model, Sequential = K
    reg = jreg if L is jl else treg
    seq = Sequential()
    seq.add(L.Convolution1D(8, 3, input_shape=(6, 4),
                            W_regularizer=reg.l2(1e-2),
                            b_regularizer=reg.l1(2e-2)))
    seq.add(L.LSTM(6, return_sequences=True, W_regularizer=reg.l1(1e-3),
                   U_regularizer=reg.l2(1e-2),
                   b_regularizer=reg.l1l2(1e-3, 2e-3)))
    seq.add(L.GRU(5, return_sequences=True, U_regularizer=reg.l1(3e-3)))
    seq.add(L.SimpleRNN(5, W_regularizer=reg.l2(5e-3)))
    head = Sequential()
    head.add(L.Dense(8, input_shape=(5,), W_regularizer=reg.l1l2(1e-2, 2e-2),
                     b_regularizer=reg.l2(3e-2)))
    head.add(L.Highway(W_regularizer=reg.l2(1e-2), b_regularizer=reg.l1(1e-2)))
    head.add(L.MaxoutDense(4, nb_feature=2, W_regularizer=reg.l1(1e-2),
                           b_regularizer=reg.l2(1e-2)))
    head.add(L.CMul((1, 4), W_regularizer=reg.l2(0.1)))
    head.add(L.CAdd((1, 4), b_regularizer=reg.l1(0.1)))
    head.add(L.Dense(3, bias=False, b_regularizer=reg.l2(0.5)))
    inp = Input(shape=(6, 4))
    return Model(inp, head(seq(inp)))


def _embeddings(L, K):
    Input, Model, _ = K
    reg = jreg if L is jl else treg
    inp = Input(shape=(5,))
    a = L.Embedding(30, 4, W_regularizer=reg.l1l2(1e-2, 1e-1))(inp)
    b = L.SparseEmbedding(30, 4, W_regularizer=reg.l2(0.2))(inp)
    return Model(inp, [a, b])


JK = (JInput, JModel, JSequential)
TK = (TInput, TModel, TSequential)


def _fill(tree, rs):
    if isinstance(tree, dict):
        return {k: _fill(tree[k], rs) for k in sorted(tree)}
    return (rs.randn(*np.shape(tree)) * 0.5).astype(np.float32)


def _pair(build, seed=0):
    JLayer.reset_name_counters()
    jm = build(jl, JK)
    jvars = jax.device_get(jm.init(jax.random.PRNGKey(0)))
    jvars = {"params": _fill(jvars["params"], np.random.RandomState(seed)),
             "state": jvars["state"]}
    jm.set_variables(jax.tree_util.tree_map(jnp.asarray, jvars))
    TLayer.reset_name_counters()
    tm = build(tl, TK)
    tm.init(torch.Generator().manual_seed(0))
    load_jax_variables(tm, jvars)
    return jm, tm


@pytest.mark.parametrize("build", [_nested, _embeddings],
                         ids=["nested", "embeddings"])
def test_penalty_equals_the_reference(build):
    jm, tm = _pair(build)
    want = float(jm.regularization_loss(jm.get_variables()["params"]))
    got = tm.regularization_loss(tm.get_variables()["params"])
    assert torch.is_tensor(got)
    assert want > 0.1
    np.testing.assert_allclose(float(got), want, rtol=1e-6, atol=0)


def test_a_regularizer_on_a_leaf_the_layer_lacks_is_ignored():
    """``Dense(bias=False, b_regularizer=...)`` creates no bias and
    registers no bias penalty; a registered name the params lack (here a
    bias dropped from the tree) is skipped, as at the reference's
    ``engine.py:269-270``."""
    w = np.arange(12, dtype=np.float32).reshape(4, 3) / 10
    losses = []
    for L, reg, rng, arr in (
            (jl, jreg, jax.random.PRNGKey(0), jnp.asarray),
            (tl, treg, torch.Generator().manual_seed(0), torch.from_numpy)):
        layer = L.Dense(3, bias=False, W_regularizer=reg.l2(0.5),
                        b_regularizer=reg.l2(0.5))
        params = layer.init(rng, (None, 4))["params"]
        assert set(params) == set(layer.param_regularizers) == {"kernel"}
        biased = L.Dense(3, W_regularizer=reg.l2(0.5),
                         b_regularizer=reg.l1(0.5))
        biased.init(rng, (None, 4))
        assert set(biased.param_regularizers) == {"kernel", "bias"}
        losses.append((float(layer.regularization_loss({"kernel": arr(w)})),
                       float(biased.regularization_loss({"kernel": arr(w)}))))
    want = 0.5 * float(np.sum(w ** 2))
    for got in losses[1]:
        assert got == pytest.approx(want, rel=1e-6)
    assert losses[1] == pytest.approx(losses[0], rel=1e-6)


def test_no_regularizer_gives_a_float_zero():
    m = TSequential()
    m.add(tl.Dense(3, input_shape=(4,)))
    params = m.init(torch.Generator().manual_seed(0))["params"]
    assert m.regularization_loss(params) == 0.0
    assert not torch.is_tensor(m.regularization_loss(params))


def _data(n=16, seed=3):
    rs = np.random.RandomState(seed)
    return (rs.randn(n, 6, 4).astype(np.float32),
            rs.randn(n, 3).astype(np.float32))


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], f"{prefix}/{k}"))
        return out
    return {prefix: np.asarray(tree.detach().cpu().numpy()
                               if isinstance(tree, torch.Tensor) else tree)}


@pytest.mark.parametrize("optim", ["sgd", "adam"])
def test_one_step_with_regularizers_matches_the_reference(optim):
    """One ``fit`` step of 16 rows: the same parameters within 1e-6, the
    same reported loss, which is the loss without the penalty; the
    penalty moved the parameters (against the same step with every
    regularizer removed)."""
    x, y = _data()
    # Adam's first step is lr * g / (|g| + eps): at eps 1e-8 an element
    # whose gradient cancels to ~2e-7 (one does here) turns an ulp-level
    # difference of g into ~2e-5 of step; eps 1e-3 keeps the step a
    # well-conditioned function of g
    make = {"sgd": (lambda P: P.SGD(0.1)),
            "adam": (lambda P: P.Adam(1e-2, epsilon=1e-3))}
    jm, tm = _pair(_nested)
    jm.compile(make[optim](jopt), "mse")
    tm.compile(make[optim](topt), "mse")
    jhist = jm.fit(x, y, batch_size=16, nb_epoch=1, shuffle=False)
    thist = tm.fit(x, y, batch_size=16, nb_epoch=1, shuffle=False, rng=0)
    np.testing.assert_allclose(thist[0]["loss"], jhist[0]["loss"],
                               atol=ATOL, rtol=0)
    jp = _flat(jax.device_get(jm.get_variables()["params"]))
    tp = _flat(tm.get_variables()["params"])
    assert sorted(jp) == sorted(tp)
    for k in jp:
        np.testing.assert_allclose(tp[k], jp[k], atol=ATOL, rtol=0,
                                   err_msg=k)

    # the same step without the regularizers: the same reported loss (the
    # loss at the starting weights), other parameters
    _, plain = _pair(_nested)
    for layer in _all_layers(plain):
        layer.param_regularizers = {}
    plain.compile(make[optim](topt), "mse")
    phist = plain.fit(x, y, batch_size=16, nb_epoch=1, shuffle=False, rng=0)
    assert phist[0]["loss"] == thist[0]["loss"]
    pp = _flat(plain.get_variables()["params"])
    moved = max(float(np.abs(pp[k] - tp[k]).max()) for k in tp)
    assert moved > 1e-4
    # evaluate reports the loss alone too
    np.testing.assert_allclose(tm.evaluate(x, y, batch_size=16)["loss"],
                               jm.evaluate(x, y, batch_size=16)["loss"],
                               atol=ATOL, rtol=0)


def _all_layers(model):
    for layer in model.layers:
        yield layer
        if hasattr(layer, "layers"):
            yield from _all_layers(layer)


def test_gradients_are_those_of_loss_plus_penalty():
    """The trainer's gradients against ``jax.grad`` of the reference's
    objective, and its loss against the loss alone."""
    x, y = _data(8, seed=4)
    jm, tm = _pair(_nested)
    jparams = jm.get_variables()["params"]
    from analytics_zoo_tpu.pipeline.api.keras import objectives as jobj
    jloss_fn = jobj.get("mse")

    def objective(p):
        out, _ = jm.apply(p, jnp.asarray(x), training=True)
        loss = jloss_fn(jnp.asarray(y), out)
        return loss + jm.regularization_loss(p), loss

    jgrads, jloss = jax.grad(objective, has_aux=True)(jparams)
    tr = DistributedTrainer(tm, tobj.get("mse"), optim_method=topt.SGD(0.1))
    tparams = tm.get_variables()["params"]
    loss, grads, _ = tr.loss_and_grads(tparams, {}, tr.put_batch((x, y)),
                                       None)
    np.testing.assert_allclose(float(loss), float(jloss), atol=ATOL, rtol=0)
    jg, tg = _flat(jax.device_get(jgrads)), _flat(grads)
    assert sorted(jg) == sorted(tg)
    for k in jg:
        np.testing.assert_allclose(tg[k], jg[k], atol=ATOL, rtol=0,
                                   err_msg=k)
