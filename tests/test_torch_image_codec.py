"""PyTorch port, images in: the codec entry points of ``feature/image``
(``decode_image_bytes``, ``read_image``, ``ImageResize``, ``ImageHue``,
``ImageColorJitter``'s hue stage, ``ImageSet.read``) bit-identical to the
JAX package's on OpenCV and again with ``_HAS_CV2`` patched false in both
modules (the PIL path); the 3-D transforms of ``feature/image3d``;
``utils/file_io``'s ``list_files`` and ``makedirs``; and Cluster Serving's
``image`` records served end to end by both packages on the same weights,
a poison record answered with an error while the records after it are
served."""

import base64
import os

import cv2
import numpy as np
import pytest

import jax

import analytics_zoo_tpu.serving.client as jclient
import analytics_zoo_tpu.serving.redis_client as jredis
import analytics_zoo_tpu.serving.server as jserver
from analytics_zoo_tpu.feature import image as jimage
from analytics_zoo_tpu.feature import image3d as jimage3d
from analytics_zoo_tpu.pipeline.api.keras import Sequential as JSequential
from analytics_zoo_tpu.pipeline.api.keras import layers as jlayers
from analytics_zoo_tpu.pipeline.inference.inference_model import (
    InferenceModel as JInferenceModel,
)
from analytics_zoo_tpu.utils import file_io as jfile_io

import analytics_zoo_torch.serving.client as tclient
import analytics_zoo_torch.serving.redis_client as tredis
import analytics_zoo_torch.serving.server as tserver
from analytics_zoo_torch.common import config as tconfig
from analytics_zoo_torch.common import zoo_context as tctx
from analytics_zoo_torch.feature import image as timage
from analytics_zoo_torch.feature import image3d as timage3d
from analytics_zoo_torch.interop import load_jax_variables
from analytics_zoo_torch.observability import (
    reset_flightrec, reset_registry, reset_request_log, reset_tracer)
from analytics_zoo_torch.ops import dtypes as tdtypes
from analytics_zoo_torch.pipeline.api.keras import Sequential as TSequential
from analytics_zoo_torch.pipeline.api.keras import layers as tlayers
from analytics_zoo_torch.pipeline.api.keras.engine import Layer as TLayer
from analytics_zoo_torch.pipeline.inference import InferenceModel
from analytics_zoo_torch.resilience.chaos import clear_chaos
from analytics_zoo_torch.utils import file_io as tfile_io

# both packages call the same scipy.ndimage on the same float64 matrix
IMAGE3D_ATOL = 1e-6
# served probabilities: the same float32 small classifier in both
# frameworks (a 3x3 convolution, a mean and a Dense, ~1e-7 relative)
PROB_ATOL = 1e-5


@pytest.fixture(autouse=True)
def _port_cpu(f32_policy):
    tctx.reset_zoo_context()
    tconfig.reset_config()
    tctx.init_zoo_context(device="cpu")
    tdtypes.set_policy(param_dtype="float32", compute_dtype="float32")
    for reset in (reset_registry, reset_tracer, reset_request_log,
                  reset_flightrec, clear_chaos):
        reset()
    yield
    tdtypes.restore_policy(None)
    tctx.reset_zoo_context()
    tconfig.reset_config()


@pytest.fixture(params=["cv2", "pil"])
def codec(request, monkeypatch):
    """Run the test on OpenCV, then with ``_HAS_CV2`` false in both
    packages' modules (PIL)."""
    if request.param == "pil":
        monkeypatch.setattr(jimage, "_HAS_CV2", False)
        monkeypatch.setattr(timage, "_HAS_CV2", False)
    return request.param


def _images(n, h, w, seed):
    return np.random.RandomState(seed).randint(
        0, 256, (n, h, w, 3)).astype(np.uint8)


def _encoded(img, ext):
    return cv2.imencode(ext, img)[1].tobytes()


def _assert_same(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


# ------------------------------------------------------------------ codec
@pytest.mark.parametrize("ext", [".jpg", ".png"])
@pytest.mark.parametrize("to_rgb", [True, False])
def test_decode_is_bit_identical(codec, ext, to_rgb):
    for img in _images(3, 17, 23, seed=1):
        data = _encoded(img, ext)
        got = timage.decode_image_bytes(data, to_rgb=to_rgb)
        _assert_same(got, jimage.decode_image_bytes(data, to_rgb=to_rgb))
        assert got.dtype == np.uint8 and got.shape == (17, 23, 3)


def test_pil_bgr_is_a_reversed_view_that_serving_copies(monkeypatch):
    """PIL's BGR result is a negative-stride view, as the reference
    returns it; the serving decode hands the batcher a contiguous array."""
    monkeypatch.setattr(timage, "_HAS_CV2", False)
    img = _images(1, 9, 7, seed=2)[0]
    bgr = timage.decode_image_bytes(_encoded(img, ".png"), to_rgb=False)
    assert bgr.strides[-1] < 0
    uri, arr, rid = tserver.decode_field(
        {"uri": b"u", "image": base64.b64encode(_encoded(img, ".png"))})
    assert arr.flags["C_CONTIGUOUS"] and arr.dtype == np.float32
    np.testing.assert_array_equal(arr, bgr.astype(np.float32))
    assert (uri, rid) == ("u", None)


def test_read_image_is_bit_identical(codec, tmp_path):
    for i, img in enumerate(_images(2, 15, 11, seed=3)):
        for ext in (".jpg", ".png"):
            path = tmp_path / f"{i}{ext}"
            path.write_bytes(_encoded(img, ext))
            _assert_same(timage.read_image(str(path)),
                         jimage.read_image(str(path)))
            if codec == "cv2":
                _assert_same(timage.read_image(str(path), to_rgb=False),
                             jimage.read_image(str(path), to_rgb=False))


def test_bad_bytes_raise_ioerror_naming_the_context(codec, tmp_path):
    with pytest.raises(IOError, match="cannot decode image rec-7"):
        timage.decode_image_bytes(b"not-a-jpeg", context="rec-7")
    with pytest.raises(IOError, match="cannot decode image bytes"):
        timage.decode_image_bytes(b"\xff\xd8\xff")
    if codec == "cv2":
        bad = tmp_path / "bad.jpg"
        bad.write_bytes(b"not-a-jpeg")
        with pytest.raises(IOError, match="bad.jpg"):
            timage.read_image(str(bad))


@pytest.mark.parametrize("size", [(8, 9), (40, 31)])
def test_resize_is_bit_identical(codec, size):
    for img in _images(2, 19, 25, seed=4):
        _assert_same(timage.ImageResize(*size).apply(img),
                     jimage.ImageResize(*size).apply(img))


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_hue_and_color_jitter_are_bit_identical(codec, dtype):
    imgs = _images(3, 14, 10, seed=5).astype(dtype)
    th, jh = timage.ImageHue(40.0, seed=3), jimage.ImageHue(40.0, seed=3)
    tj, jj = timage.ImageColorJitter(seed=6), jimage.ImageColorJitter(seed=6)
    for img in imgs:
        _assert_same(th.apply(img), jh.apply(img))
        _assert_same(tj.apply(img), jj.apply(img))
    th.reseed(9)
    jh.reseed(9)
    _assert_same(th.apply(imgs[0]), jh.apply(imgs[0]))


@pytest.mark.parametrize("with_label", [False, True])
def test_imageset_read_matches_reference(codec, tmp_path, with_label):
    """A tree of JPEGs and PNGs written here: the same images, labels and
    label map, for the default pattern and for ``*.png``."""
    imgs = iter(_images(7, 13, 9, seed=7))
    if with_label:
        for cls, n in (("cat", 2), ("dog", 1), ("ant", 2)):
            os.makedirs(tmp_path / cls)
            for i in range(n):
                img = next(imgs)
                (tmp_path / cls / f"{i}.jpg").write_bytes(
                    _encoded(img, ".jpg"))
                (tmp_path / cls / f"p{i}.png").write_bytes(
                    _encoded(img, ".png"))
    else:
        for i, img in enumerate(imgs):
            ext = ".jpg" if i % 2 else ".png"
            (tmp_path / f"{i:02d}{ext}").write_bytes(_encoded(img, ext))
    for pattern in ("*.jpg", "*.png"):
        got = timage.ImageSet.read(str(tmp_path), with_label, pattern)
        want = jimage.ImageSet.read(str(tmp_path), with_label, pattern)
        assert len(got) == len(want) > 0
        for g, w in zip(got.images, want.images):
            _assert_same(g, w)
        assert got.label_map == want.label_map
        if with_label:
            _assert_same(got.labels, want.labels)
            assert got.label_map == {"ant": 0, "cat": 1, "dog": 2}
        else:
            assert got.labels is None and want.labels is None


# ------------------------------------------------------------------ 3-D
def _volume():
    return np.random.RandomState(8).rand(9, 11, 10).astype(np.float32)


@pytest.mark.parametrize("name,args", [
    ("Crop3D", ((1, 2, 3), (4, 5, 6))),
    ("CenterCrop3D", ((5, 6, 4),)),
    ("RandomCrop3D", ((4, 4, 4),)),
    ("Rotate3D", (30.0,)),
    ("Rotate3D", (-75.0, (1, 2), 3)),
    ("AffineTransform3D", (np.array([[1.0, 0.1, 0.0], [0.0, 0.9, 0.2],
                                     [0.05, 0.0, 1.1]]), (0.5, -1.0, 2.0))),
    ("AffineTransform3D", (np.eye(3) * 0.8, None, 0)),
])
def test_image3d_matches_reference(name, args):
    vol = _volume()
    tt = getattr(timage3d, name)(*args)
    jt = getattr(jimage3d, name)(*args)
    for _ in range(2):   # RandomCrop3D draws twice
        got, want = tt.apply(vol), jt.apply(vol)
        assert got.shape == want.shape and got.dtype == want.dtype
        np.testing.assert_allclose(got, want, atol=IMAGE3D_ATOL, rtol=0)


# --------------------------------------------------------------- file_io
def test_list_files_and_makedirs_match_reference(tmp_path):
    tfile_io.makedirs(str(tmp_path / "a" / "b"))
    tfile_io.makedirs(str(tmp_path / "a" / "b"))      # exists: no error
    for name in ("z.jpg", "a.jpg", "m.png"):
        (tmp_path / "a" / "b" / name).write_bytes(b"x")
    for pattern in ("*.jpg", "*", "*.gif"):
        pat = str(tmp_path / "a" / "b" / pattern)
        assert tfile_io.list_files(pat) == jfile_io.list_files(pat)
    assert [os.path.basename(p) for p in tfile_io.list_files(
        str(tmp_path / "a" / "b" / "*.jpg"))] == ["a.jpg", "z.jpg"]


# --------------------------------------------------------------- serving
def _classifiers():
    """The reference's ``small_classifier`` at 16x16x3 with 6 classes in
    both packages, on the port's seeded weights."""
    TLayer.reset_name_counters()
    tm = TSequential()
    tm.add(tlayers.Convolution2D(4, 3, 3, input_shape=(16, 16, 3),
                                 activation="relu"))
    tm.add(tlayers.GlobalAveragePooling2D())
    tm.add(tlayers.Dense(6))
    tm.init()
    jm = JSequential()
    jm.add(jlayers.Convolution2D(4, 3, 3, input_shape=(16, 16, 3),
                                 activation="relu"))
    jm.add(jlayers.GlobalAveragePooling2D())
    jm.add(jlayers.Dense(6))
    jvars = jax.tree_util.tree_map(np.asarray, jm.init())
    tv = jax.tree_util.tree_map(lambda a: a.numpy(), tm.get_variables())
    scaled = jax.tree_util.tree_map(lambda a: a * 0.05, tv)
    jm.set_variables(jax.tree_util.tree_map(
        lambda w, a: a.astype(w.dtype), jvars, scaled))
    load_jax_variables(tm, scaled)
    return tm, jm


PACKAGES = {"jax": (jserver, jclient, jredis),
            "torch": (tserver, tclient, tredis)}


def _serve_images(pkg, im, records):
    """``records``: (uri, JPEG bytes or an HWC uint8 array) enqueued with
    ``enqueue_image`` and served by ``pkg``'s ClusterServing on an
    ``EmbeddedBroker``; the results by uri."""
    server, client, redis = PACKAGES[pkg]
    broker = redis.EmbeddedBroker()
    serving = server.ClusterServing(
        im, server.ServingConfig(batch_size=4, top_n=3), broker=broker)
    try:
        inq = client.InputQueue(broker=broker)
        for uri, image in records:
            inq.enqueue_image(uri, image)
        while serving.run_once(block_ms=10):
            pass
        outq = client.OutputQueue(broker=broker)
        return {uri: outq.query(uri) for uri, _ in records}
    finally:
        serving.close()


def test_jpeg_records_served_as_the_reference_serves_them(codec, tmp_path):
    """JPEG bytes, an HWC array, a PNG and a file path (the client's four
    forms), a poison record among them."""
    tm, jm = _classifiers()
    imgs = _images(9, 16, 16, seed=9)
    records = [(f"img-{i}", _encoded(img, ".jpg"))
               for i, img in enumerate(imgs[:6])]
    path = tmp_path / "rec.jpg"
    path.write_bytes(_encoded(imgs[8], ".jpg"))
    records += [("arr-0", imgs[6]), ("png-0", _encoded(imgs[7], ".png")),
                ("path-0", str(path))]
    records.insert(3, ("poison", b"not-a-jpeg"))
    got = _serve_images("torch", InferenceModel().load_zoo(tm), records)
    want = _serve_images("jax", JInferenceModel().load_zoo(jm), records)
    assert set(got) == set(want) == {uri for uri, _ in records}
    for uri, _ in records:
        if uri == "poison":
            assert "error" in got[uri] and "error" in want[uri]
            assert "cannot decode image poison" in got[uri]["error"]
            continue
        assert len(got[uri]) == 3
        assert [c for c, _ in got[uri]] == [c for c, _ in want[uri]], uri
        np.testing.assert_allclose([p for _, p in got[uri]],
                                   [p for _, p in want[uri]],
                                   atol=PROB_ATOL, rtol=0)
    # the served top-3 is the model's on the decoded BGR array
    bgr = timage.decode_image_bytes(records[0][1], to_rgb=False)
    probs = InferenceModel().load_zoo(tm).predict(
        bgr[None].astype(np.float32))
    assert [c for c, _ in got["img-0"]] == \
        list(np.argsort(-probs[0], kind="stable")[:3])
