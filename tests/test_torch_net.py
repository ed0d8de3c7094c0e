"""PyTorch port, ``pipeline/api/net``: ``TorchNet`` against the JAX
package's ``TorchNet`` and against the module's own forward on the same
weights (the modules of ``tests/test_interop.py::TestTorchNet`` and more
of the emitter's modules, functions and methods; forwards within 1e-5),
``TorchCriterion`` against both, ``fit`` losses of a TorchNet and of a
TorchCriterion-driven model within 1e-4 of the reference's, the refusals
(an unsupported module, function or method named in both; a TorchNet over
BatchNorm refused at training in both, with a ``TypeError``, while
serving it works in both), ``InferenceModel.load_torch``, and ``Net``'s
dispatch (``load_caffe`` raises).  ``TFNet`` and ``load_tf`` need
TensorFlow and are tested in ``tests/test_torch_tfpark.py``."""

import numpy as np
import pytest
import torch
import torch.nn as nn

import jax
import jax.numpy as jnp

from analytics_zoo_tpu.pipeline.api.keras import Sequential as JSequential
from analytics_zoo_tpu.pipeline.api.keras import optimizers as jopt
from analytics_zoo_tpu.pipeline.api.keras.layers import Dense as JDense
from analytics_zoo_tpu.pipeline.api.net import (
    TorchCriterion as JTorchCriterion, TorchNet as JTorchNet,
)
from analytics_zoo_tpu.pipeline.inference import (
    InferenceModel as JInferenceModel,
)

from analytics_zoo_torch.common import config as tconfig
from analytics_zoo_torch.common import zoo_context as tctx
from analytics_zoo_torch.interop import load_jax_variables
from analytics_zoo_torch.ops import dtypes as tdtypes
from analytics_zoo_torch.pipeline.api.keras import Sequential
from analytics_zoo_torch.pipeline.api.keras import optimizers as topt
from analytics_zoo_torch.pipeline.api.keras.engine import Layer as TLayer
from analytics_zoo_torch.pipeline.api.keras.layers import Dense
from analytics_zoo_torch.pipeline.api.net import (
    Net, TorchCriterion, TorchNet,
)
from analytics_zoo_torch.pipeline.inference import InferenceModel

FWD_TOL = 1e-5
STEP_ATOL = 1e-4
LOSS = "sparse_categorical_crossentropy_with_logits"


@pytest.fixture(autouse=True)
def _port_cpu(f32_policy):
    tctx.reset_zoo_context()
    tconfig.reset_config()
    tctx.init_zoo_context(device="cpu")
    tdtypes.set_policy(param_dtype="float32", compute_dtype="float32")
    TLayer.reset_name_counters()
    yield
    tdtypes.restore_policy(None)
    tctx.reset_zoo_context()
    tconfig.reset_config()


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# ----------------------------------------------------------------- modules
def mlp():
    return nn.Sequential(nn.Linear(8, 16), nn.ReLU(), nn.Dropout(0.1),
                         nn.Linear(16, 3))


class ConvNet(nn.Module):
    """``TestTorchNet.test_convnet_matches_torch``'s module."""

    def __init__(self):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 8, 3, padding=1)
        self.bn = nn.BatchNorm2d(8)
        self.pool = nn.MaxPool2d(2)
        self.fc = nn.Linear(8 * 4 * 4, 5)

    def forward(self, x):
        x = self.pool(torch.relu(self.bn(self.conv1(x))))
        x = torch.flatten(x, 1)
        return self.fc(x)


class Surface(nn.Module):
    """More of the emitter's modules, functions and methods; its forward
    is torch's own except ``nn.GELU`` (the reference emits the tanh
    approximation) and ``F.avg_pool2d`` (a VALID window strided by the
    kernel, as given here)."""

    def __init__(self, gelu=False):
        super().__init__()
        self.conv = nn.Conv2d(4, 6, 3, stride=2, padding=1, groups=2)
        self.conv_same = nn.Conv2d(6, 6, 3, padding="same", bias=False)
        self.avg = nn.AvgPool2d(2)
        self.gap = nn.AdaptiveAvgPool2d(1)
        self.lin = nn.Linear(6, 10)
        self.ln = nn.LayerNorm(10)
        self.act = nn.GELU() if gelu else nn.Tanh()
        self.sig = nn.Sigmoid()
        self.soft = nn.Softmax(dim=1)
        self.flat = nn.Flatten()
        self.ident = nn.Identity()
        self.bn1 = nn.BatchNorm1d(10)

    def forward(self, x):
        h = self.conv(x)
        h = torch.tanh(self.conv_same(h)) + h * 0.5
        a = self.avg(h)
        a = torch.nn.functional.avg_pool2d(a, 2)
        g = self.flat(self.gap(h))
        g = g.view(g.size(0), -1)
        z = self.ident(self.act(self.ln(self.lin(g))))
        z = self.bn1(z)
        p = h.permute(0, 2, 3, 1).mean(1)
        p = torch.sum(p.transpose(1, 2).unsqueeze(1).squeeze(1), dim=2)
        q = torch.cat([z, torch.abs(p) ** 2, torch.clamp(p, min=-0.1)], 1)
        q = torch.matmul(q, q.transpose(0, 1).contiguous())
        out = torch.sum(torch.exp(self.sig(q) * 0.1), dim=1, keepdim=True)
        return torch.cat([self.soft(z), out - torch.mean(
            a.flatten(1), dim=1, keepdim=True)], 1)


class EmbedBag(nn.Module):
    def __init__(self):
        super().__init__()
        self.emb = nn.Embedding(20, 6)
        self.fc = nn.Linear(6, 2)

    def forward(self, ids):
        return self.fc(self.emb(ids).mean(1))


def _randomize_bn(module, seed=0):
    rs = np.random.RandomState(seed)
    for m in module.modules():
        if isinstance(m, (nn.BatchNorm1d, nn.BatchNorm2d)):
            n = m.num_features
            m.running_mean.copy_(torch.from_numpy(
                rs.randn(n).astype(np.float32)))
            m.running_var.copy_(torch.from_numpy(
                rs.rand(n).astype(np.float32) + 0.5))
            m.weight.data.copy_(torch.from_numpy(
                rs.rand(n).astype(np.float32) + 0.5))
    return module


def forward_both(module, x, input_shape):
    """(port output, reference output) of the module's TorchNet, the port
    holding the reference's params leaf by leaf."""
    jnet = JTorchNet.from_pytorch(module, input_shape=input_shape)
    jv = _np(jnet.init(jax.random.PRNGKey(0), input_shape))
    tnet = TorchNet.from_pytorch(module, input_shape=input_shape)
    tv = tnet.init(torch.Generator().manual_seed(0), input_shape)
    assert sorted(tv["params"]) == sorted(jv["params"])
    for k, v in jv["params"].items():
        got = tv["params"][k]
        assert got.numpy().dtype == v.dtype, (k, got.dtype, v.dtype)
        np.testing.assert_array_equal(got.numpy(), v, err_msg=k)
    assert tnet.get_output_shape() == jnet.get_output_shape()
    tout, _ = tnet.apply(tv["params"], torch.from_numpy(x), state={})
    jout, _ = jnet.apply(jv["params"], jnp.asarray(x), state={})
    return tout.numpy(), np.asarray(jout)


@pytest.mark.parametrize("case", ["mlp", "convnet", "surface",
                                  "surface_gelu", "embedding"])
def test_torchnet_matches_the_reference_and_the_module(case):
    rs = np.random.RandomState(0)
    torch.manual_seed(0)
    if case == "mlp":
        module, x, shape = mlp(), rs.randn(4, 8).astype(np.float32), (8,)
    elif case == "convnet":
        module, shape = _randomize_bn(ConvNet()), (3, 8, 8)
        x = rs.randn(2, 3, 8, 8).astype(np.float32)
    elif case == "embedding":
        module, shape = EmbedBag(), (5,)
        x = rs.randint(0, 20, (3, 5)).astype(np.float32)
    else:
        module = _randomize_bn(Surface(gelu=case == "surface_gelu"))
        x, shape = rs.randn(3, 4, 8, 8).astype(np.float32), (4, 8, 8)
    got, want = forward_both(module, x, shape)
    np.testing.assert_allclose(got, want, rtol=FWD_TOL, atol=FWD_TOL)
    if case != "surface_gelu":
        with torch.no_grad():
            inp = torch.from_numpy(x)
            own = module(inp.long() if case == "embedding" else inp)
        np.testing.assert_allclose(got, own.numpy(), rtol=FWD_TOL,
                                   atol=FWD_TOL)


def test_torchnet_dropout_draws_in_training():
    module = mlp()
    net = TorchNet.from_pytorch(module, input_shape=(8,))
    v = net.init(torch.Generator().manual_seed(0), (8,))
    x = torch.from_numpy(np.random.RandomState(1).randn(64, 8)
                         .astype(np.float32))
    eval_out, _ = net.apply(v["params"], x, state={})
    a, _ = net.apply(v["params"], x, state={}, training=True,
                     rng=torch.Generator().manual_seed(3))
    b, _ = net.apply(v["params"], x, state={}, training=True,
                     rng=torch.Generator().manual_seed(3))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.allclose(a, eval_out)
    with pytest.raises(ValueError, match="rng"):
        net.apply(v["params"], x, state={}, training=True)


@pytest.mark.parametrize("what", ["module", "function", "method"])
def test_unsupported_parts_are_named_in_both(what):
    class F(nn.Module):
        def forward(self, x):
            return torch.cumsum(x, 1)

    class M(nn.Module):
        def forward(self, x):
            return x.cumsum(1)
    module, name = {
        "module": (nn.Sequential(nn.Linear(4, 4), nn.PixelShuffle(2)),
                   "PixelShuffle"),
        "function": (F(), "cumsum"),
        "method": (M(), "cumsum")}[what]
    jnet = JTorchNet.from_pytorch(module, input_shape=(4,))
    with pytest.raises(NotImplementedError, match=name) as jerr:
        jnet.init(jax.random.PRNGKey(0), (4,))
    tnet = TorchNet.from_pytorch(module, input_shape=(4,))
    with pytest.raises(NotImplementedError, match=name) as terr:
        tnet.init(torch.Generator().manual_seed(0), (4,))
    assert str(terr.value).split(":")[0] == str(jerr.value).split(":")[0]


def test_torchnet_fit_matches_the_reference():
    """``TestTorchNet.test_torchnet_trains_in_zoo_engine``'s run on a
    dropout-free MLP (dropout draws differ between the packages): epoch
    losses and params within 1e-4."""
    torch.manual_seed(1)
    module = nn.Sequential(nn.Linear(8, 16), nn.ReLU(), nn.Linear(16, 3))
    rs = np.random.RandomState(0)
    x = rs.randn(64, 8).astype(np.float32)
    y = np.argmax(x @ rs.randn(8, 3).astype(np.float32), -1)
    jm = JSequential()
    jm.add(JTorchNet.from_pytorch(module, input_shape=(8,)))
    jm.compile(optimizer=jopt.Adam(lr=0.02), loss=LOSS)
    tm = Sequential()
    tm.add(TorchNet.from_pytorch(module, input_shape=(8,)))
    tm.compile(optimizer=topt.Adam(lr=0.02), loss=LOSS)
    jh = jm.fit(x, y.astype(np.int32), batch_size=16, nb_epoch=4)
    th = tm.fit(x, y, batch_size=16, nb_epoch=4)
    np.testing.assert_allclose([h["loss"] for h in th],
                               [h["loss"] for h in jh], atol=STEP_ATOL)
    jp = _np(jm.get_variables()["params"])
    tp = tm.get_variables()["params"]
    for layer in jp:
        for name in jp[layer]:
            np.testing.assert_allclose(tp[layer][name].numpy(),
                                       jp[layer][name], atol=STEP_ATOL)
    assert th[-1]["loss"] < th[0]["loss"]


def test_batchnorm_torchnet_serves_but_cannot_train_in_both():
    """ROADMAP queue 3, fault (b): BatchNorm's ``num_batches_tracked`` is an
    int32 param in both packages; ``fit`` refuses it with a ``TypeError``
    (the port names the leaf), ``InferenceModel.load_torch`` serves it."""
    torch.manual_seed(2)
    module = _randomize_bn(ConvNet())
    rs = np.random.RandomState(3)
    x = rs.randn(8, 3, 8, 8).astype(np.float32)
    y = rs.randint(0, 5, 8)
    jm = JSequential()
    jm.add(JTorchNet.from_pytorch(module, input_shape=(3, 8, 8)))
    jm.compile(optimizer=jopt.Adam(lr=0.01), loss=LOSS)
    with pytest.raises(TypeError, match="int32"):
        jm.fit(x, y.astype(np.int32), batch_size=8, nb_epoch=1)
    tm = Sequential()
    tm.add(TorchNet.from_pytorch(module, input_shape=(3, 8, 8)))
    tm.compile(optimizer=topt.Adam(lr=0.01), loss=LOSS)
    with pytest.raises(TypeError, match="num_batches_tracked.*int32"):
        tm.fit(x, y, batch_size=8, nb_epoch=1)
    got = InferenceModel().load_torch(module, (3, 8, 8)).predict(x)
    want = JInferenceModel().load_torch(module, (3, 8, 8)).predict(x)
    np.testing.assert_allclose(got, np.asarray(want), rtol=FWD_TOL,
                               atol=FWD_TOL)
    with torch.no_grad():
        own = module(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, own, rtol=FWD_TOL, atol=FWD_TOL)


class Weighted(nn.Module):
    def forward(self, input, target):
        return ((input - target) ** 2 * 3.0).mean()


@pytest.mark.parametrize("crit", ["mse", "l1", "mse_sum", "weighted"])
def test_torch_criterion_matches_the_reference_and_torch(crit):
    tcrit = {"mse": nn.MSELoss(), "l1": nn.L1Loss(),
             "mse_sum": nn.MSELoss(reduction="sum"),
             "weighted": Weighted()}[crit]
    rs = np.random.RandomState(0)
    yt = rs.randn(6, 4).astype(np.float32)
    yp = rs.randn(6, 4).astype(np.float32)
    got = float(TorchCriterion.from_pytorch(tcrit)(torch.from_numpy(yt),
                                                   torch.from_numpy(yp)))
    want = float(JTorchCriterion.from_pytorch(tcrit)(jnp.asarray(yt),
                                                     jnp.asarray(yp)))
    own = float(tcrit(torch.from_numpy(yp), torch.from_numpy(yt)))
    assert abs(got - want) <= FWD_TOL * max(1.0, abs(want))
    assert abs(got - own) <= FWD_TOL * max(1.0, abs(own))
    assert TorchCriterion(tcrit).__name__ == type(tcrit).__name__


def test_cross_entropy_criterion_is_refused_in_both():
    """``nn.CrossEntropyLoss`` traces to ``F.cross_entropy``, which the
    reference's emitter does not take; the port refuses it the same way."""
    with pytest.raises(NotImplementedError, match="cross_entropy") as jerr:
        JTorchCriterion(nn.CrossEntropyLoss())(
            jnp.zeros((2, 3)), jnp.zeros((2, 3)))
    with pytest.raises(NotImplementedError, match="cross_entropy") as terr:
        TorchCriterion(nn.CrossEntropyLoss())(
            torch.zeros(2, 3), torch.zeros(2, 3))
    assert str(terr.value) == str(jerr.value)


def test_torch_criterion_drives_fit_as_the_reference():
    rs = np.random.RandomState(0)
    x = rs.randn(64, 4).astype(np.float32)
    y = (x @ rs.randn(4, 1)).astype(np.float32)
    jm = JSequential()
    jm.add(JDense(1, input_shape=(4,)))
    jv = _np(jm.init(jax.random.PRNGKey(0)))
    tm = Sequential()
    tm.add(Dense(1, input_shape=(4,)))
    load_jax_variables(tm, jv)
    jm.compile(optimizer=jopt.Adam(lr=0.05),
               loss=JTorchCriterion.from_pytorch(nn.MSELoss()))
    tm.compile(optimizer=topt.Adam(lr=0.05),
               loss=TorchCriterion.from_pytorch(nn.MSELoss()))
    jh = jm.fit(x, y, batch_size=16, nb_epoch=5)
    th = tm.fit(x, y, batch_size=16, nb_epoch=5)
    np.testing.assert_allclose([h["loss"] for h in th],
                               [h["loss"] for h in jh], atol=STEP_ATOL)
    assert th[-1]["loss"] < th[0]["loss"] * 0.5


def test_load_torch_serves_as_the_reference_and_is_captured_like_load_zoo():
    torch.manual_seed(4)
    module = nn.Sequential(nn.Conv2d(3, 4, 3), nn.ReLU(), nn.Flatten(),
                           nn.Linear(4 * 6 * 6, 3))
    x = np.random.RandomState(5).randn(5, 3, 8, 8).astype(np.float32)
    im = InferenceModel().load_torch(module, (3, 8, 8))
    assert isinstance(im.model, Sequential)
    assert isinstance(im.model.layers[0], TorchNet)
    got = im.predict(x, batch_size=2)
    want = np.asarray(JInferenceModel().load_torch(module, (3, 8, 8))
                      .predict(x))
    np.testing.assert_allclose(got, want, rtol=FWD_TOL, atol=FWD_TOL)
    assert im.warm((3, 8, 8), 2)


def test_net_dispatch(tmp_path):
    from analytics_zoo_torch.pipeline.api.onnx import onnx_pb as pb
    from analytics_zoo_torch.pipeline.api.keras.topology import Model
    # load_torch: a module (and a TorchNet back)
    net = Net.load_torch(nn.Sequential(nn.Linear(3, 2)), (3,))
    assert isinstance(net, TorchNet) and net.get_output_shape() == (None, 2)
    # load_onnx: serialized bytes
    g = pb.GraphProto(
        node=[pb.NodeProto(input=["x"], output=["y"], op_type="Relu")],
        name="g", input=[pb.make_value_info("x", [0, 3])],
        output=[pb.make_value_info("y", [0, 3])])
    model = Net.load_onnx(pb.ModelProto(
        ir_version=7, graph=g,
        opset_import=[pb.OperatorSetIdProto(version=11)]).encode())
    assert isinstance(model, Model) and model.name == "g"
    # load / load_bigdl: weights saved by save_model into a built model
    src = Sequential()
    src.add(Dense(2, input_shape=(3,)))
    src.init(torch.Generator().manual_seed(1))
    path = str(tmp_path / "m.zoo")
    src.save_model(path)
    TLayer.reset_name_counters()
    into = Sequential()
    into.add(Dense(2, input_shape=(3,)))
    into.init(torch.Generator().manual_seed(2))
    for loader in (Net.load, Net.load_bigdl):
        loader(path, into)
        for a, b in zip(into.get_weights(), src.get_weights()):
            np.testing.assert_array_equal(a, b)
    assert Net.load_bigdl is Net.load
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Net.load_caffe("net.prototxt", "net.caffemodel")
