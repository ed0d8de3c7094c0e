"""PyTorch port, the image classification models: the nets built in both
packages, the port holding the JAX model's variables
(``load_jax_variables``, params and BN moving statistics), then compared
on the same inputs on the CPU: eval-mode logits of ResNet-18, LeNet,
Inception-v1, MobileNet and the other published families at small
sizes; the ``ImageClassifier`` catalog against the reference's variable
trees; ``predict_image_set`` and ``predict_image_classes``; and
``InferenceModel.load_zoo`` of an ``ImageClassifier``.  Training is in
``test_torch_image_training.py``, ResNet-50 in
``test_torch_image_resnet50.py``.

Both packages run ``dtype.compute=float32``."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from analytics_zoo_tpu.feature import image as jimage
from analytics_zoo_tpu.models.image import common as jcommon
from analytics_zoo_tpu.models.image.imageclassification import nets as jnets
from analytics_zoo_tpu.pipeline.api.keras.engine import Layer as JLayer

from analytics_zoo_torch.common import config as tconfig
from analytics_zoo_torch.common import zoo_context as tctx
from analytics_zoo_torch.feature import image as timage
from analytics_zoo_torch.interop import load_jax_variables
from analytics_zoo_torch.models.image import (
    ImageClassifier, ImageConfigure, ImageModel,
)
from analytics_zoo_torch.models.image.imageclassification import nets as tnets
from analytics_zoo_torch.ops import dtypes as tdtypes
from analytics_zoo_torch.ops import kernels
from analytics_zoo_torch.pipeline.api.keras.engine import Layer as TLayer
from analytics_zoo_torch.pipeline.inference import InferenceModel

# eval-mode logits of a whole float32 net: the frameworks sum each
# convolution's products in other orders (seen: at most 4.2e-7)
LOGITS_ATOL = 1e-5


def _port_context():
    tctx.reset_zoo_context()
    tconfig.reset_config()
    tdtypes.restore_policy(None)
    tctx.init_zoo_context(device="cpu")
    tdtypes.set_policy(param_dtype="float32", compute_dtype="float32")


@pytest.fixture(autouse=True)
def _port_cpu(f32_policy):
    _port_context()
    kernels.reset_launch_counts()
    yield
    tdtypes.restore_policy(None)
    tctx.reset_zoo_context()
    tconfig.reset_config()


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _shared(jbuild, tbuild):
    """The same net built in both packages, the port holding the JAX
    net's variables (``load_jax_variables``).  The values are drawn by
    the port's initializers and set into the JAX net first: the JAX
    package's initializers take 10-30 s a net on this CPU, one compile
    per parameter shape."""
    JLayer.reset_name_counters()
    jm = jbuild()
    TLayer.reset_name_counters()
    tm = tbuild()
    drawn = getattr(tm, "model", tm).init(torch.Generator().manual_seed(0))
    jm.set_variables(jax.tree_util.tree_map(
        lambda t: jnp.asarray(t.numpy()), drawn))
    load_jax_variables(tm, _np(jm.get_variables()))
    return jm, tm


def _images(n, shape, seed=0):
    return np.random.RandomState(seed).randn(n, *shape).astype(np.float32)


# (id, builder kwargs, input shape): each family at a small input its
# builder accepts, 7 classes
NETS = [
    ("resnet-18", dict(depth=18), (32, 32, 3)),
    ("resnet-18-s2d-torch", dict(depth=18, stem="space_to_depth",
                                 conv_padding="torch"), (32, 32, 3)),
    # odd extents, where SAME pads a stride-2 window 0/1 and the torch
    # padding 1/1 (the space-to-depth stem needs an even input: 34 -> 17)
    ("resnet-18-odd", dict(depth=18), (33, 35, 3)),
    ("resnet-18-torch-odd", dict(depth=18, conv_padding="torch"),
     (35, 33, 3)),
    ("resnet-18-s2d-odd", dict(depth=18, stem="space_to_depth"),
     (34, 38, 3)),
    ("lenet", {}, (28, 28, 1)),
    ("inception-v1", {}, (32, 32, 3)),
    ("inception-v1-torchvision", dict(variant="torchvision"), (32, 32, 3)),
    ("mobilenet-relu6", dict(alpha=0.25, activation="relu6"), (32, 32, 3)),
    ("mobilenet", dict(alpha=0.25), (32, 32, 3)),
    ("vgg-16", dict(depth=16), (32, 32, 3)),
    ("squeezenet", {}, (32, 32, 3)),
    ("densenet-121", dict(depth=121, blocks=(2, 2, 2, 2)), (32, 32, 3)),
    ("densenet-121-torch", dict(depth=121, blocks=(1, 2, 1, 1),
                                conv_padding="torch"), (32, 32, 3)),
    ("alexnet", {}, (67, 67, 3)),
    ("alexnet-torchvision", dict(variant="torchvision"), (63, 63, 3)),
]


def _builder(mod, name):
    family = name.split("-")[0]
    return {"resnet": mod.resnet, "lenet": mod.lenet,
            "inception": mod.inception_v1, "mobilenet": mod.mobilenet,
            "vgg": mod.vgg, "squeezenet": mod.squeezenet,
            "densenet": mod.densenet, "alexnet": mod.alexnet}[family]


@pytest.mark.parametrize("i", range(len(NETS)), ids=[n for n, *_ in NETS])
def test_net_eval_logits_match_reference(i):
    name, kw, shape = NETS[i]
    jm, tm = _shared(
        lambda: _builder(jnets, name)(num_classes=7, input_shape=shape, **kw),
        lambda: _builder(tnets, name)(num_classes=7, input_shape=shape, **kw))
    x = _images(2, shape, seed=i)
    want = np.asarray(jm.predict(x, batch_size=2))
    got = tm.predict(x, batch_size=2)
    assert got.shape == want.shape == (2, 7)
    np.testing.assert_allclose(got, want, atol=LOGITS_ATOL, rtol=0)


# --------------------------------------------------------------- catalog
# the smallest input each name's builder takes here (lenet: its default)
CATALOG_SHAPES = {"lenet": (28, 28, 1), "alexnet": (67, 67, 3)}


@pytest.mark.parametrize("name", sorted(tnets._BUILDERS))
def test_image_classifier_catalog_matches_reference(name):
    """Every name builds, its variables have the reference's key paths,
    shapes and dtypes, and its output shape is right (each family's
    forward is held to the reference's in
    ``test_net_eval_logits_match_reference``)."""
    assert sorted(tnets._BUILDERS) == sorted(jnets._BUILDERS)
    shape = CATALOG_SHAPES.get(name, (32, 32, 3))
    JLayer.reset_name_counters()
    jm = jnets.ImageClassifier(name, num_classes=5, input_shape=shape)
    want = jax.eval_shape(lambda k: JLayer.init(jm.model, k, None),
                          jax.random.PRNGKey(0))
    TLayer.reset_name_counters()
    tm = ImageClassifier(name, num_classes=5, input_shape=shape)
    got = tm.get_variables()
    assert jax.tree_util.tree_structure(got) == \
        jax.tree_util.tree_structure(want)
    for g, w in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(want)):
        assert tuple(g.shape) == tuple(w.shape)
        assert g.dtype == torch.float32 and w.dtype == np.float32
    assert tm.model.get_output_shape() == \
        jm.model.get_output_shape() == (None, 5)


def test_image_classifier_refuses_unknown_names_and_pretrained():
    with pytest.raises(ValueError, match="unknown model"):
        ImageClassifier("resnet-7")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ImageClassifier("resnet-18", pretrained="weights.pth")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tnets.load_pretrained(None, "weights.pth")
    with pytest.raises(ValueError, match="conv_padding"):
        tnets.resnet(18, conv_padding="reflect")
    with pytest.raises(ValueError, match="stem"):
        tnets.resnet(18, stem="conv5")


# ------------------------------------------------ ImageSet and serving
def _classifier_pair(config_of):
    return _shared(
        lambda: jnets.ImageClassifier("resnet-18", num_classes=6,
                                      input_shape=(16, 16, 3),
                                      config=config_of(jimage, jcommon)),
        lambda: ImageClassifier("resnet-18", num_classes=6,
                                input_shape=(16, 16, 3),
                                config=config_of(timage, None)))


def _configure(img_mod, common_mod):
    cls = ImageConfigure if common_mod is None else common_mod.ImageConfigure
    return cls(preprocessor=img_mod.ImageCenterCrop(16, 16) >>
               img_mod.ImageChannelNormalize(123.0, 117.0, 104.0, 58.4,
                                             57.1, 57.4),
               label_map={f"class{i}": i for i in range(6)})


def test_predict_image_set_and_classes_match_reference():
    jm, tm = _classifier_pair(_configure)
    assert isinstance(tm, ImageModel)
    raw = np.random.RandomState(2).randint(0, 256, (5, 20, 18, 3)).astype(
        np.uint8)
    jset = jimage.ImageSet.from_ndarrays(raw)
    tset = timage.ImageSet.from_ndarrays(raw)
    want = np.asarray(jm.predict_image_set(jset, batch_size=2))
    got = tm.predict_image_set(tset, batch_size=2)
    assert got.shape == (5, 6)
    np.testing.assert_allclose(got, want, atol=LOGITS_ATOL, rtol=0)
    top = np.sort(want, axis=-1)[:, ::-1]
    assert (top[:, :3] - top[:, 1:4]).min() > 10 * LOGITS_ATOL
    assert tm.predict_image_classes(tset, top_k=3) == \
        jm.predict_image_classes(jset, top_k=3)
    # a postprocessor, through an explicit configure
    cfg = ImageConfigure(preprocessor=timage.ImageCenterCrop(16, 16),
                         postprocessor=lambda out: out.argmax(-1))
    np.testing.assert_array_equal(
        tm.predict_image_set(tset, configure=cfg),
        jm.predict_image_set(jset, configure=jcommon.ImageConfigure(
            preprocessor=jimage.ImageCenterCrop(16, 16),
            postprocessor=lambda out: np.asarray(out).argmax(-1))))


def test_inference_model_serves_an_image_classifier():
    """``load_zoo`` reads the moving statistics (eval mode) and a batch
    padded to its shape does not change a row's answer."""
    m = ImageClassifier("resnet-18", num_classes=6, input_shape=(8, 8, 3))
    v = m.get_variables()
    initial = {k: dict(s) for k, s in v["state"].items()}
    rs = np.random.RandomState(9)
    for s in v["state"].values():
        if s:
            d = s["moving_mean"].shape[0]
            s["moving_mean"] = torch.from_numpy(
                rs.randn(d).astype(np.float32))
            s["moving_var"] = torch.from_numpy(
                rs.rand(d).astype(np.float32) + 0.5)
    x = _images(3, (8, 8, 3), seed=9)
    want = m.predict(x)                       # one batch of 256, padded
    im = InferenceModel().load_zoo(m)
    # batches of other sizes: the CPU's convolutions sum in other orders
    # (seen: 4.8e-6 on logits of ~5)
    np.testing.assert_allclose(im.predict(x), want, atol=LOGITS_ATOL,
                               rtol=0)
    padded = im.predict(x, batch_size=4)      # one batch, a row padded
    singles = np.concatenate([im.predict(x[i:i + 1]) for i in range(3)])
    np.testing.assert_allclose(padded, want, atol=LOGITS_ATOL, rtol=0)
    np.testing.assert_allclose(singles, want, atol=LOGITS_ATOL, rtol=0)
    # eval mode reads the statistics: at their initial values the answer
    # differs
    m.set_variables({"params": v["params"], "state": initial})
    assert not np.allclose(m.predict(x), want, atol=1e-3)
