"""PyTorch port, the rest of the Keras layer surface: each of the 64
layer classes ported with the regularizers (core, advanced activations,
elementwise, noise, shape ops, normalization, embedding, conv, local)
against its JAX layer.

Each case builds a one-layer graph ``Model`` in both packages (two
inputs for ``GaussianSampler`` and ``SelectTable``, several outputs for
``SplitTensor``), gives the JAX model seeded numpy values under its own
key paths, exports them as numpy and loads them into the port with
``interop.load_jax_variables``.  Both run the same numpy batch under a
float32 compute policy; the forward, and the gradients of
``sum(out * ct)`` with respect to every parameter and the input, must
agree within 1e-6 absolute, or the tolerance written beside the case
with its reason.

The random layers cannot draw the same bits (``torch.Generator`` is not
``jax.random``): their eval paths and their p = 0 training paths are
held exactly here, and their training paths by the statistics the
reference defines (mask shape, keep rate, the noise's mean and spread
over a large draw) in ``test_random_layer_training_statistics``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from analytics_zoo_tpu.pipeline.api.keras import Input as JInput
from analytics_zoo_tpu.pipeline.api.keras import Model as JModel
from analytics_zoo_tpu.pipeline.api.keras import layers as jl
from analytics_zoo_tpu.pipeline.api.keras.engine import Layer as JLayer

from analytics_zoo_torch.common import config as tconfig
from analytics_zoo_torch.common import zoo_context as tctx
from analytics_zoo_torch.interop import load_jax_variables
from analytics_zoo_torch.ops import dtypes as tdtypes
from analytics_zoo_torch.ops import kernels
from analytics_zoo_torch.pipeline.api.keras import Input as TInput
from analytics_zoo_torch.pipeline.api.keras import Model as TModel
from analytics_zoo_torch.pipeline.api.keras import layers as tl
from analytics_zoo_torch.pipeline.api.keras.engine import Layer as TLayer

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


def _x(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _pos(seed, *shape):
    """Strictly positive inputs (Log, Sqrt, fractional Power)."""
    return np.abs(_x(seed, *shape)) + 0.1


def _ids(seed, shape, vocab, pad_frac=0.3):
    """Id rows padded with -1 (SparseEmbedding's contract); row 0 is all
    padding."""
    rs = np.random.RandomState(seed)
    ids = rs.randint(0, vocab, size=shape)
    ids[rs.rand(*shape) < pad_frac] = -1
    ids[0] = -1
    return ids.astype(np.int32)


class Case:
    """One layer at one configuration: ``make(L)`` builds it from either
    package's ``layers`` module; ``inputs`` one array or a list (a
    multi-input layer)."""

    def __init__(self, name, make, inputs, atol=ATOL, reason=None,
                 grad=True, training=False, rng=False, scaled=False):
        if atol > ATOL or scaled:
            assert reason, f"{name}: a tolerance above {ATOL} needs a reason"
        self.name, self.make, self.inputs = name, make, inputs
        self.atol, self.grad = atol, grad
        self.training, self.rng = training, rng
        self.scaled = scaled

    def tol(self, want):
        """The absolute tolerance for ``want``: ``atol``, or with
        ``scaled`` ``atol`` times the largest magnitude in ``want`` (when
        above 1)."""
        if not self.scaled:
            return self.atol
        return self.atol * max(1.0, float(np.abs(want).max()))


# Convolution gradients: each kernel and bias gradient sums over every
# output position (B x OH x OW, up to 760 terms, sums up to ~30 here), and
# XLA's and ATen's convolution backward add in different orders, so they
# agree to 1e-6 of the largest magnitude, not 1e-6 absolute.
CONV_SUMS = dict(scaled=True, reason="convolution gradients: sums over "
                 "every output position in another order")


X3 = _x(1, 3, 6, 8)          # (B, T, F)
X2 = _x(2, 4, 10)            # (B, F)
IMG = _x(3, 2, 7, 6, 5)      # (B, H, W, C)
IMG_TH = _x(4, 2, 5, 7, 6)   # (B, C, H, W)
VOL = _x(5, 2, 5, 4, 6, 3)   # (B, D, H, W, C)

CASES = [
    # ---------------------------------------------------------- core.py
    Case("Reshape", lambda L: L.Reshape((4, -1)), X3),
    Case("Permute", lambda L: L.Permute((2, 1)), X3),
    Case("RepeatVector", lambda L: L.RepeatVector(3), X2),
    Case("Masking", lambda L: L.Masking(0.0),
         np.where(np.arange(6)[None, :, None] % 3 == 0, 0.0, X3)
         .astype(np.float32)),
    Case("Highway", lambda L: L.Highway(), X3),
    Case("Highway-relu-nobias",
         lambda L: L.Highway(activation="relu", bias=False), X2),
    Case("MaxoutDense", lambda L: L.MaxoutDense(5, nb_feature=3), X2),
    Case("MaxoutDense-nobias", lambda L: L.MaxoutDense(5, bias=False), X3),
    Case("SparseDense",
         lambda L: L.SparseDense(6, activation="tanh"),
         np.where(_x(6, 4, 12) > 0.8, _x(7, 4, 12), 0.0).astype(np.float32)),
    # ------------------------------------------- advanced_activations.py
    Case("LeakyReLU", lambda L: L.LeakyReLU(0.2), X3),
    Case("ELU", lambda L: L.ELU(0.7), X3),
    Case("ThresholdedReLU", lambda L: L.ThresholdedReLU(0.5), X3),
    Case("PReLU", lambda L: L.PReLU(), X3),
    Case("SReLU", lambda L: L.SReLU(), X3),
    Case("Softmax", lambda L: L.Softmax(), X3),
    # ---------------------------------------------------- elementwise.py
    Case("AddConstant", lambda L: L.AddConstant(1.5), X3),
    Case("MulConstant", lambda L: L.MulConstant(-0.75), X3),
    Case("Exp", lambda L: L.Exp(), X3),
    Case("Log", lambda L: L.Log(), _pos(8, 3, 6, 8)),
    Case("Sqrt", lambda L: L.Sqrt(), _pos(9, 3, 6, 8)),
    Case("Square", lambda L: L.Square(), X3),
    Case("Power", lambda L: L.Power(2.0), X3),
    Case("Power-fractional",
         lambda L: L.Power(1.5, scale=0.5, shift=0.2), _pos(10, 3, 6, 8)),
    Case("Negative", lambda L: L.Negative(), X3),
    Case("Identity", lambda L: L.Identity(), X3),
    Case("Threshold", lambda L: L.Threshold(0.1, -0.5), X3),
    Case("BinaryThreshold", lambda L: L.BinaryThreshold(0.2), X3),
    Case("HardShrink", lambda L: L.HardShrink(0.4), X3),
    Case("SoftShrink", lambda L: L.SoftShrink(0.4), X3),
    Case("HardTanh", lambda L: L.HardTanh(-0.5, 0.8), X3),
    Case("RReLU-eval", lambda L: L.RReLU(), X3),
    # without an rng the reference takes the mean slope in training too
    Case("RReLU-train-no-rng", lambda L: L.RReLU(0.1, 0.3), X3,
         training=True),
    Case("CAdd", lambda L: L.CAdd((1, 6, 8)), X3),
    Case("CAdd-broadcast", lambda L: L.CAdd((1, 1, 8)), X3),
    Case("CMul", lambda L: L.CMul((1, 6, 1)), X3),
    Case("Mul", lambda L: L.Mul(), X3),
    Case("Scale", lambda L: L.Scale((1, 1, 8)), X3),
    # the window sum raised to the fractional power 0.75: the two
    # frameworks' CPU pow differ by an ulp or two on (k + a/n * sum)
    Case("LRN2D-tf", lambda L: L.LRN2D(alpha=1e-2, n=5), IMG),
    Case("LRN2D-th", lambda L: L.LRN2D(alpha=1e-2, k=2.0, beta=0.6, n=3,
                                       dim_ordering="th"), IMG_TH),
    Case("WithinChannelLRN2D", lambda L: L.WithinChannelLRN2D(size=3),
         IMG),
    Case("WithinChannelLRN2D-even", lambda L: L.WithinChannelLRN2D(
        size=4, alpha=0.5, beta=0.6), IMG),
    Case("ResizeBilinear-up-tf", lambda L: L.ResizeBilinear(11, 9), IMG),
    Case("ResizeBilinear-down-tf", lambda L: L.ResizeBilinear(3, 4), IMG),
    Case("ResizeBilinear-mixed-th",
         lambda L: L.ResizeBilinear(3, 10, dim_ordering="th"), IMG_TH),
    Case("ResizeBilinear-down-th",
         lambda L: L.ResizeBilinear(2, 3, dim_ordering="th"), IMG_TH),
    Case("ResizeBilinear-same-height",
         lambda L: L.ResizeBilinear(7, 3), IMG),
    Case("ResizeBilinear-align-up-tf",
         lambda L: L.ResizeBilinear(10, 11, align_corners=True), IMG),
    Case("ResizeBilinear-align-down-th",
         lambda L: L.ResizeBilinear(3, 1, align_corners=True,
                                    dim_ordering="th"), IMG_TH),
    Case("GaussianSampler-eval", lambda L: L.GaussianSampler(),
         [_x(11, 4, 5), _x(12, 4, 5)]),
    # ---------------------------------------------------------- noise.py
    Case("GaussianNoise-eval", lambda L: L.GaussianNoise(0.5), X3),
    Case("GaussianDropout-eval", lambda L: L.GaussianDropout(0.3), X3),
    Case("GaussianDropout-p0", lambda L: L.GaussianDropout(0.0), X3,
         training=True, rng=True),
    Case("SpatialDropout1D-eval", lambda L: L.SpatialDropout1D(0.4), X3),
    Case("SpatialDropout1D-p0", lambda L: L.SpatialDropout1D(0.0), X3,
         training=True, rng=True),
    Case("SpatialDropout2D-eval", lambda L: L.SpatialDropout2D(0.4), IMG),
    Case("SpatialDropout2D-p0", lambda L: L.SpatialDropout2D(0.0), IMG,
         training=True, rng=True),
    Case("SpatialDropout3D-eval", lambda L: L.SpatialDropout3D(0.4), VOL),
    Case("SpatialDropout3D-p0", lambda L: L.SpatialDropout3D(0.0), VOL,
         training=True, rng=True),
    # ------------------------------------------------------ shape_ops.py
    Case("Select", lambda L: L.Select(1, 3), X3),
    Case("Select-negative", lambda L: L.Select(-2, -1), X3),
    Case("Narrow", lambda L: L.Narrow(1, 2, 4), X3),
    Case("Narrow-to-end", lambda L: L.Narrow(0, 1, -1), X3),
    Case("Squeeze", lambda L: L.Squeeze(0), _x(13, 3, 1, 5)),
    Case("Squeeze-all", lambda L: L.Squeeze(), _x(14, 3, 1, 5, 1)),
    Case("ExpandDim", lambda L: L.ExpandDim(1), X3),
    Case("ExpandDim-negative", lambda L: L.ExpandDim(-1), X3),
    Case("Expand", lambda L: L.Expand((-1, 4, 8)), _x(15, 3, 6, 1, 8)),
    Case("SplitTensor", lambda L: L.SplitTensor(0, 3), X3),
    Case("SplitTensor-last", lambda L: L.SplitTensor(-1, 2), X3),
    Case("SelectTable", lambda L: L.SelectTable(1),
         [_x(16, 3, 4), _x(17, 3, 4)]),
    Case("Max", lambda L: L.Max(1), X3),
    Case("Max-argmax", lambda L: L.Max(-1, return_value=False), X3,
         grad=False),
    Case("GetShape", lambda L: L.GetShape(), X3, grad=False),
    # -------------------------------------------------- normalization.py
    Case("L2Normalization", lambda L: L.L2Normalization(), X3),
    Case("L2Normalization-axis1", lambda L: L.L2Normalization(axis=1), X3),
    Case("NormalizeScale", lambda L: L.NormalizeScale(), IMG),
    # the scale's gradient sums B x H x W = 84 terms (up to ~2.4) in
    # another order than XLA's
    Case("NormalizeScale-axis1", lambda L: L.NormalizeScale(axis=1),
         IMG_TH, scaled=True, reason="a sum of 84 terms in another order"),
    # ------------------------------------------------------ embedding.py
    Case("SparseEmbedding-sum", lambda L: L.SparseEmbedding(20, 6),
         _ids(18, (5, 7), 20), grad=True),
    Case("SparseEmbedding-mean",
         lambda L: L.SparseEmbedding(20, 6, combiner="mean"),
         _ids(19, (5, 7), 20)),
    Case("SparseEmbedding-sqrtn-maxnorm",
         lambda L: L.SparseEmbedding(20, 6, combiner="sqrtn",
                                     max_norm=0.5),
         _ids(20, (5, 7), 20)),
    # ----------------------------------------------------------- conv.py
    Case("SeparableConvolution2D",
         lambda L: L.SeparableConvolution2D(4, 3, 3), IMG, **CONV_SUMS),
    Case("SeparableConvolution2D-same-strided",
         lambda L: L.SeparableConvolution2D(
             3, 2, 3, subsample=(2, 2), border_mode="same",
             depth_multiplier=2, activation="relu"), IMG, **CONV_SUMS),
    Case("Cropping1D", lambda L: L.Cropping1D((1, 2)), X3),
    Case("Cropping2D", lambda L: L.Cropping2D(((1, 2), (0, 1))), IMG),
    Case("Cropping3D", lambda L: L.Cropping3D(), VOL),
    Case("UpSampling1D", lambda L: L.UpSampling1D(3), X3),
    Case("UpSampling2D", lambda L: L.UpSampling2D((2, 3)), IMG),
    Case("UpSampling3D", lambda L: L.UpSampling3D((1, 2, 2)), VOL),
    Case("ShareConvolution2D", lambda L: L.ShareConvolution2D(
        4, 3, 3, pad_h=1, pad_w=2), IMG, **CONV_SUMS),
    Case("ShareConvolution2D-th", lambda L: L.ShareConvolution2D(
        4, 2, 3, subsample=(2, 1), pad_h=1, dim_ordering="th"), IMG_TH,
        **CONV_SUMS),
    # ---------------------------------------------------------- local.py
    Case("LocallyConnected1D", lambda L: L.LocallyConnected1D(5, 3), X3),
    Case("LocallyConnected1D-strided", lambda L: L.LocallyConnected1D(
        4, 2, activation="relu", subsample_length=2, bias=False), X3),
    Case("LocallyConnected2D", lambda L: L.LocallyConnected2D(3, 3, 2),
         IMG),
    Case("LocallyConnected2D-strided", lambda L: L.LocallyConnected2D(
        4, 2, 3, activation="tanh", subsample=(2, 2)), IMG),
]

# Deconvolution2D: odd and even kernels at strides 1 and 2, SAME and
# VALID, and a stride above the kernel (where VALID pads past it)
for _k in ((3, 3), (2, 2), (4, 3)):
    for _s in ((1, 1), (2, 2)):
        for _mode in ("same", "valid"):
            CASES.append(Case(
                f"Deconvolution2D-k{_k[0]}{_k[1]}-s{_s[0]}-{_mode}",
                lambda L, k=_k, s=_s, m=_mode: L.Deconvolution2D(
                    3, k[0], k[1], subsample=s, border_mode=m), IMG,
                **CONV_SUMS))
CASES.append(Case("Deconvolution2D-k2-s3-valid", lambda L: L.Deconvolution2D(
    2, 2, 2, subsample=(3, 3), border_mode="valid", activation="relu"),
    IMG, **CONV_SUMS))

NEW_CLASSES = {
    "Reshape", "Permute", "RepeatVector", "Masking", "Highway",
    "MaxoutDense", "SparseDense",
    "LeakyReLU", "ELU", "ThresholdedReLU", "PReLU", "SReLU", "Softmax",
    "AddConstant", "MulConstant", "Exp", "Log", "Sqrt", "Square", "Power",
    "Negative", "Identity", "Threshold", "BinaryThreshold", "HardShrink",
    "SoftShrink", "HardTanh", "RReLU", "CAdd", "CMul", "Mul", "Scale",
    "LRN2D", "WithinChannelLRN2D", "ResizeBilinear", "GaussianSampler",
    "GaussianNoise", "GaussianDropout", "SpatialDropout1D",
    "SpatialDropout2D", "SpatialDropout3D",
    "Select", "Narrow", "Squeeze", "ExpandDim", "Expand", "SplitTensor",
    "SelectTable", "Max", "GetShape",
    "L2Normalization", "NormalizeScale", "SparseEmbedding",
    "SeparableConvolution2D", "Deconvolution2D", "Cropping1D",
    "Cropping2D", "Cropping3D", "UpSampling1D", "UpSampling2D",
    "UpSampling3D", "ShareConvolution2D",
    "LocallyConnected1D", "LocallyConnected2D",
}


def test_the_cases_cover_all_64_classes():
    assert len(NEW_CLASSES) == 64
    covered = {type(c.make(tl)).__name__ for c in CASES}
    assert covered == NEW_CLASSES
    for name in NEW_CLASSES:
        assert name in tl.__all__


def _graph(Input, Model, layer, inputs):
    if isinstance(inputs, list):
        ins = [Input(shape=a.shape[1:]) for a in inputs]
        return Model(ins, layer(ins))
    inp = Input(shape=inputs.shape[1:])
    out = layer(inp)
    return Model(inp, out)


def _fill(tree, rs):
    """Seeded values in place of each leaf of a numpy params tree."""
    if isinstance(tree, dict):
        return {k: _fill(tree[k], rs) for k in sorted(tree)}
    return (rs.randn(*np.shape(tree)) * 0.5).astype(np.float32)


def _np(v):
    if isinstance(v, (list, tuple)):
        return [_np(a) for a in v]
    return v.detach().numpy() if isinstance(v, torch.Tensor) \
        else np.asarray(v)


def _flat_grads(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat_grads(tree[k], f"{prefix}/{k}"))
        return out
    return {prefix: _np(tree)}


def _build_pair(case):
    """The case's layer in both packages, the JAX model's seeded params
    loaded into the port's through ``load_jax_variables``."""
    JLayer.reset_name_counters()
    jm = _graph(JInput, JModel, case.make(jl), case.inputs)
    jvars = jax.device_get(jm.init(jax.random.PRNGKey(0)))
    jvars = {"params": _fill(jvars["params"], np.random.RandomState(7)),
             "state": jvars["state"]}
    jm.set_variables(jax.tree_util.tree_map(jnp.asarray, jvars))
    TLayer.reset_name_counters()
    tm = _graph(TInput, TModel, case.make(tl), case.inputs)
    load_jax_variables(tm, jax.device_get(jm.get_variables()))
    return jm, tm


def _run_jax(jm, params, x, case):
    rng = jax.random.PRNGKey(3) if case.rng else None
    return jm.apply(params, x, training=case.training, rng=rng)[0]


def _run_port(tm, params, x, case):
    rng = torch.Generator().manual_seed(3) if case.rng else None
    return tm.apply(params, x, training=case.training, rng=rng)[0]


@pytest.mark.parametrize("case", CASES, ids=[c.name for c in CASES])
def test_layer_matches_reference(case):
    jm, tm = _build_pair(case)
    jparams = jm.get_variables()["params"]
    tparams = tm.get_variables()["params"]
    inputs = case.inputs
    jx = [jnp.asarray(a) for a in inputs] if isinstance(inputs, list) \
        else jnp.asarray(inputs)
    tx = [torch.from_numpy(a) for a in inputs] \
        if isinstance(inputs, list) else torch.from_numpy(inputs)
    want = _np(_run_jax(jm, jparams, jx, case))
    got = _np(_run_port(tm, tparams, tx, case))
    if isinstance(want, list):
        assert len(got) == len(want)
    else:
        want, got = [want], [got]
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype, \
            (g.shape, w.shape, g.dtype, w.dtype)
        np.testing.assert_allclose(g, w, atol=case.tol(w), rtol=0)
    # the symbolic shapes agree with what ran (batch dim excluded)
    out_shape = tm._output_shape
    shapes = out_shape if isinstance(out_shape, list) else [out_shape]
    for s, g in zip(shapes, got):
        if case.name != "GetShape":
            assert tuple(s[1:]) == g.shape[1:]
    if not case.grad:
        return

    cts = [np.random.RandomState(11 + i).randn(*w.shape).astype(np.float32)
           for i, w in enumerate(want)]
    float_in = not isinstance(inputs, list) and \
        np.issubdtype(inputs.dtype, np.floating)

    def jloss(p, x):
        out = _run_jax(jm, p, x, case)
        outs = out if isinstance(out, list) else [out]
        return sum(jnp.sum(o * c) for o, c in zip(outs, cts))

    argnums = (0, 1) if float_in else (0,)
    jg = jax.grad(jloss, argnums=argnums)(jparams, jx)

    leaves = {f"/{layer}/{k}": v.detach().clone().requires_grad_()
              for layer, d in sorted(tparams.items())
              for k, v in sorted(d.items())}
    live = {layer: {k: leaves[f"/{layer}/{k}"] for k in d}
            for layer, d in tparams.items()}
    tx_live = tx.clone().requires_grad_() if float_in else tx
    out = _run_port(tm, live, tx_live, case)
    outs = out if isinstance(out, list) else [out]
    loss = sum((o * torch.from_numpy(c)).sum() for o, c in zip(outs, cts))
    wrt = list(leaves.values()) + ([tx_live] if float_in else [])
    if loss.requires_grad:
        tg = torch.autograd.grad(loss, wrt, allow_unused=True,
                                 materialize_grads=True)
    else:                     # a step function: zero gradients, as JAX's
        tg = [torch.zeros_like(w) for w in wrt]
    want_p = _flat_grads(jax.device_get(jg[0]))
    assert sorted(want_p) == sorted(leaves)
    for (name, _), g in zip(leaves.items(), tg):
        np.testing.assert_allclose(g.numpy(), want_p[name],
                                   atol=case.tol(want_p[name]), rtol=0,
                                   err_msg=name)
    if float_in:
        want_x = np.asarray(jg[1])
        np.testing.assert_allclose(tg[-1].numpy(), want_x,
                                   atol=case.tol(want_x), rtol=0,
                                   err_msg="input")


# --------------------------------------------------- Power's edge values
POWER_EDGES = np.array([[-np.inf, -4.0, -0.0, 0.0, 1e-6, 4.0, np.inf,
                         np.nan]], np.float32)


@pytest.mark.parametrize("power,scale,shift", [
    *((p, 1.0, 0.0) for p in (0.5, -0.5, 1.5, 2.0, 3.0, 1 / 3, -1.0, 0.0)),
    # -0.0 + (-2 * 0.0) is -0.0: the input 0.0 reaches the power as -0.0
    (-0.5, -2.0, -0.0)])
def test_power_edge_values_match_reference(power, scale, shift):
    """IEEE ``pow``'s values at -inf, -4, -0.0, 0.0, 1e-6, 4, inf and NaN,
    as ``jnp.power`` gives them: equal values (NaN equal to NaN) and the
    same sign on every zero and infinity."""
    case = Case("Power-edges",
                lambda L: L.Power(power, scale=scale, shift=shift),
                POWER_EDGES)
    jm, tm = _build_pair(case)
    want = _np(_run_jax(jm, jm.get_variables()["params"],
                        jnp.asarray(POWER_EDGES), case))
    got = _np(_run_port(tm, tm.get_variables()["params"],
                        torch.from_numpy(POWER_EDGES), case))
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    edge = (want == 0) | np.isinf(want)
    np.testing.assert_array_equal(np.signbit(got[edge]),
                                  np.signbit(want[edge]))


# ------------------------------------------- the random layers, training
N_DRAW = 200_000


def _draw(layer_j, layer_t, x, extra=None):
    """One training draw from each package on the same input."""
    jx = jnp.asarray(x) if extra is None else [jnp.asarray(x),
                                               jnp.asarray(extra)]
    tx = torch.from_numpy(x) if extra is None else [
        torch.from_numpy(x), torch.from_numpy(extra)]
    j = np.asarray(layer_j.call({}, jx, training=True,
                                rng=jax.random.PRNGKey(5)))
    t = layer_t.call({}, tx, training=True,
                     rng=torch.Generator().manual_seed(5)).numpy()
    return j, t


def _moments_close(j, t, mean, std, what):
    """Both draws' mean and spread against the defined ones, within five
    standard errors of the sample."""
    n = j.size
    for name, d in (("jax", j), ("port", t)):
        assert abs(d.mean() - mean) < 5 * std / np.sqrt(n) + 1e-7, \
            (what, name, d.mean(), mean)
        assert abs(d.std() - std) < 5 * std / np.sqrt(2 * n) + 1e-7, \
            (what, name, d.std(), std)


def test_random_layer_training_statistics():
    x = _pos(21, 100, N_DRAW // 100)
    # GaussianNoise: x + sigma * N(0, 1)
    j, t = _draw(jl.GaussianNoise(0.5), tl.GaussianNoise(0.5), x)
    _moments_close((j - x) / 0.5, (t - x) / 0.5, 0.0, 1.0, "GaussianNoise")
    # GaussianDropout: x * N(1, p / (1 - p))
    p = 0.3
    j, t = _draw(jl.GaussianDropout(p), tl.GaussianDropout(p), x)
    _moments_close(j / x, t / x, 1.0, np.sqrt(p / (1 - p)),
                   "GaussianDropout")
    # RReLU in training with an rng: slopes U(lower, upper), positive
    # inputs untouched
    lo, hi = 0.1, 0.4
    xs = np.concatenate([-x, x], axis=1)
    j, t = _draw(jl.RReLU(lo, hi), tl.RReLU(lo, hi), xs)
    for name, d in (("jax", j), ("port", t)):
        np.testing.assert_array_equal(d[:, x.shape[1]:], x, err_msg=name)
        slope = d[:, :x.shape[1]] / -x
        assert lo - 1e-6 <= slope.min() and slope.max() <= hi + 1e-6
    _moments_close(j[:, :x.shape[1]] / -x, t[:, :x.shape[1]] / -x,
                   (lo + hi) / 2, (hi - lo) / np.sqrt(12), "RReLU")
    # GaussianSampler samples whenever it has an rng: mean + exp(lv/2) eps
    mean, lv = _x(22, 100, N_DRAW // 100), _x(23, 100, N_DRAW // 100)
    j, t = _draw(jl.GaussianSampler(), tl.GaussianSampler(), mean, lv)
    scale = np.exp(lv * 0.5)
    _moments_close((j - mean) / scale, (t - mean) / scale, 0.0, 1.0,
                   "GaussianSampler")
    eval_t = tl.GaussianSampler().call(
        {}, [torch.from_numpy(mean), torch.from_numpy(lv)], training=False,
        rng=torch.Generator().manual_seed(1)).numpy()
    assert not np.array_equal(eval_t, mean)      # it sampled in eval too


@pytest.mark.parametrize("spatial", [1, 2, 3])
def test_spatial_dropout_training_drops_whole_channels(spatial):
    p, keep = 0.3, 0.7
    shape = (400,) + (3,) * spatial + (50,)
    x = _pos(24, *shape)
    cls_j = getattr(jl, f"SpatialDropout{spatial}D")
    cls_t = getattr(tl, f"SpatialDropout{spatial}D")
    j, t = _draw(cls_j(p), cls_t(p), x)
    for name, d in (("jax", j), ("port", t)):
        kept = d != 0
        # one draw per (example, channel), the same over every position
        flat = kept.reshape(shape[0], -1, shape[-1])
        assert (flat == flat[:, :1]).all(), name
        np.testing.assert_allclose(d[kept], x[kept] / keep, rtol=1e-6,
                                   err_msg=name)
        rate = flat[:, 0].mean()
        n = shape[0] * shape[-1]
        assert abs(rate - keep) < 5 * np.sqrt(keep * p / n), (name, rate)


def test_random_layers_refuse_to_train_without_an_rng():
    x = torch.from_numpy(X3)
    for layer in (tl.GaussianNoise(0.5), tl.GaussianDropout(0.3),
                  tl.SpatialDropout1D(0.4)):
        with pytest.raises(ValueError, match="needs an rng"):
            layer.call({}, x, training=True)
    with pytest.raises(ValueError, match="needs an rng"):
        tl.GaussianSampler().call({}, [x, x], training=True)


def test_random_layers_draw_from_the_given_generator_only():
    """The same generator seed gives the same draw, whatever the global
    generator's state."""
    x = torch.from_numpy(X3)
    for layer in (tl.GaussianNoise(0.5), tl.GaussianDropout(0.3),
                  tl.SpatialDropout1D(0.4), tl.RReLU()):
        torch.manual_seed(0)
        a = layer.call({}, x, training=True,
                       rng=torch.Generator().manual_seed(9))
        torch.manual_seed(1)
        b = layer.call({}, x, training=True,
                       rng=torch.Generator().manual_seed(9))
        assert torch.equal(a, b), layer.name
