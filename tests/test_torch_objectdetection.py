"""PyTorch port, object detection: the box codec, NMS (random boxes, exact
score ties, pools smaller than the output), prior matching, the MultiBox
loss and its gradients (tied negative losses included), the SSD-300
priors and variable tree, ``ssd_lite``'s forward and ``detect`` (best
class and per-class NMS), five ``DistributedTrainer`` steps under Adam,
VOC mAP, the VOC reader with every box-aware transform and the padded
feature set, and the ``ObjectDetector`` facade (a detector file saved by
the JAX package loaded in the port, ``predict_image_set`` with its padded
tail, ``visualize``), each against the JAX package on the same inputs and
weights.  Both packages run ``dtype.compute=float32``; each JAX program is
built once a module."""

import os

import cv2
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from analytics_zoo_tpu.common import zoo_context as jctx
from analytics_zoo_tpu.feature import image as jimage
from analytics_zoo_tpu.feature import image_detection as jdet
from analytics_zoo_tpu.models.image import objectdetection as jod
from analytics_zoo_tpu.parallel.trainer import DistributedTrainer as JTrainer
from analytics_zoo_tpu.pipeline.api.keras import optimizers as jopt
from analytics_zoo_tpu.pipeline.api.keras.engine import Layer as JLayer

from analytics_zoo_torch.common import config as tconfig
from analytics_zoo_torch.common import zoo_context as tctx
from analytics_zoo_torch.feature import image as timage
from analytics_zoo_torch.feature import image_detection as tdet
from analytics_zoo_torch.interop import load_jax_variables
from analytics_zoo_torch.models.image import objectdetection as tod
from analytics_zoo_torch.ops import dtypes as tdtypes
from analytics_zoo_torch.ops import kernels
from analytics_zoo_torch.parallel.trainer import DistributedTrainer
from analytics_zoo_torch.pipeline.api.keras import optimizers as topt
from analytics_zoo_torch.pipeline.api.keras.engine import Layer as TLayer

# elementwise box arithmetic in float32 (the same formulas; XLA may keep
# an intermediate in a register where torch rounds it)
BOX_ATOL = 1e-6
# the losses and gradients: sums over 1344 priors in other orders, held
# to 1e-6 of the largest value (the scale)
LOSS_RTOL = 1e-6
# one eval forward of ssd_lite: five conv/BN layers and the heads
FWD_ATOL = 1e-5
# multi-step losses: the reference's own cross-program float32 tolerance
STEP_ATOL = 1e-4
SIZE = 64


@pytest.fixture(autouse=True)
def _port_cpu(f32_policy):
    tctx.reset_zoo_context()
    tconfig.reset_config()
    tctx.init_zoo_context(device="cpu")
    tdtypes.set_policy(param_dtype="float32", compute_dtype="float32")
    kernels.reset_launch_counts()
    yield
    tdtypes.restore_policy(None)
    tctx.reset_zoo_context()
    tconfig.reset_config()


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _boxes(rs, n, lo=0.0, hi=1.0):
    """``n`` valid corner boxes in [lo, hi]."""
    a = rs.uniform(lo, hi, (n, 2, 2)).astype(np.float32)
    return np.concatenate([a.min(axis=1), a.max(axis=1)], axis=1)


def _assert_close(got, want, atol, what=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), atol=atol, rtol=0,
                               err_msg=what)


# ------------------------------------------------------------------ boxes
def test_box_codec_matches_reference():
    rs = np.random.RandomState(0)
    a, b = _boxes(rs, 13), _boxes(rs, 17)
    b[3] = b[4]                                     # a degenerate overlap
    b[5, 2:] = b[5, :2]                             # a zero-area box
    _assert_close(tod.iou_matrix(torch.from_numpy(a), torch.from_numpy(b)),
                  jod.iou_matrix(a, b), BOX_ATOL)
    priors = jod.ssd_priors(SIZE, (8, 4), (10, 25), (25, 45),
                            ((2.0,), (2.0, 3.0)))
    gt = _boxes(rs, len(priors), 0.05, 0.95)
    enc = tod.encode_boxes(torch.from_numpy(gt), torch.from_numpy(priors))
    _assert_close(enc, jod.encode_boxes(gt, priors), BOX_ATOL)
    loc = rs.randn(3, len(priors), 4).astype(np.float32)
    _assert_close(tod.decode_boxes(torch.from_numpy(loc),
                                   torch.from_numpy(priors)),
                  jod.decode_boxes(loc, priors), BOX_ATOL)


# -------------------------------------------------------------------- NMS
NMS_CASES = {
    "random": dict(n=60, levels=None, max_output=20, thr=0.0),
    "ties": dict(n=60, levels=4, max_output=30, thr=0.1),
    "small_pool": dict(n=6, levels=3, max_output=10, thr=0.0),
}


@pytest.mark.parametrize("case", sorted(NMS_CASES))
@pytest.mark.parametrize("iou", [0.3, 0.6])
def test_nms_returns_the_reference_indices(case, iou):
    c = NMS_CASES[case]
    rs = np.random.RandomState(len(case))
    boxes = np.stack([_boxes(rs, c["n"]) for _ in range(3)])
    scores = rs.rand(3, c["n"]).astype(np.float32)
    if c["levels"]:                 # exact ties among the scores
        scores = np.floor(scores * c["levels"]) / c["levels"]
    boxes[1, 4] = boxes[1, 3]       # a duplicate box
    idx, valid = tod.nms(torch.from_numpy(boxes), torch.from_numpy(scores),
                         iou, c["max_output"], c["thr"])
    assert idx.shape == valid.shape == (3, c["max_output"])
    for i in range(3):
        widx, wvalid = jod.nms(jnp.asarray(boxes[i]), jnp.asarray(scores[i]),
                               iou, c["max_output"], c["thr"])
        np.testing.assert_array_equal(idx[i].numpy(), np.asarray(widx))
        np.testing.assert_array_equal(valid[i].numpy(), np.asarray(wvalid))
    if case == "small_pool":
        assert (idx[:, c["n"]:] == -1).all()


@pytest.mark.parametrize("case", ["random", "ties", "small_pool"])
def test_multiclass_nms_matches_reference(case):
    rs = np.random.RandomState(3)
    p, c, topk, d = {"random": (40, 4, 12, 20), "ties": (40, 4, 12, 20),
                     "small_pool": (5, 3, 4, 30)}[case]
    boxes = np.stack([_boxes(rs, p) for _ in range(2)])
    probs = rs.dirichlet(np.ones(c), (2, p)).astype(np.float32)
    if case != "random":
        probs = np.floor(probs * 5) / 5
    got = tod.multiclass_nms(torch.from_numpy(boxes), torch.from_numpy(probs),
                             0.45, 0.05, topk, d)
    for i in range(2):
        want = jod.multiclass_nms(jnp.asarray(boxes[i]),
                                  jnp.asarray(probs[i]), 0.45, 0.05, topk, d)
        for g, w in zip(got, want):
            assert g.shape[1:] == w.shape
            np.testing.assert_array_equal(g[i].numpy(), np.asarray(w))


# --------------------------------------------------------------- matching
def _gt(rs, b, g, priors):
    """Padded ground truths: some rows masked, two gts on one box (they
    claim the same prior), one gt a prior itself."""
    boxes = np.stack([_boxes(rs, g, 0.05, 0.95) for _ in range(b)])
    boxes[0, 1] = boxes[0, 0]
    boxes[1, 0] = priors[37]
    labels = rs.randint(1, 4, (b, g)).astype(np.int32)
    mask = np.ones((b, g), np.float32)
    mask[0, g - 1] = mask[2, 1:] = 0.0
    return boxes, labels, mask


def test_match_priors_matches_reference():
    rs = np.random.RandomState(4)
    _, priors = jod.ssd_lite(num_classes=4, image_size=SIZE)
    boxes, labels, mask = _gt(rs, 3, 5, priors)
    loc, cls = tod.match_priors(torch.from_numpy(boxes),
                                torch.from_numpy(labels),
                                torch.from_numpy(mask).bool(),
                                torch.from_numpy(priors))
    for i in range(3):
        wloc, wcls = jod.match_priors(boxes[i], labels[i],
                                      mask[i].astype(bool), priors)
        np.testing.assert_array_equal(cls[i].numpy(), np.asarray(wcls))
        _assert_close(loc[i], wloc, BOX_ATOL * 10)
    assert (cls > 0).sum() > 3


@pytest.mark.parametrize("tied", [False, True])
def test_multibox_loss_and_gradients_match_reference(tied):
    """The loss and its gradients in both location and confidence; with
    ``tied`` every prior gives the same confidence logits, so every
    negative's loss ties and the mining keeps the lowest indices."""
    rs = np.random.RandomState(5)
    _, priors = jod.ssd_lite(num_classes=4, image_size=SIZE)
    p = len(priors)
    boxes, labels, mask = _gt(rs, 3, 5, priors)
    loc = rs.randn(3, p, 4).astype(np.float32)
    conf = rs.randn(3, p, 4).astype(np.float32)
    if tied:
        conf[:] = conf[:, :1]
    jloss = jod.MultiBoxLoss(priors)
    want, (wgl, wgc) = jax.value_and_grad(
        lambda l, c: jloss((boxes, labels, mask), (l, c)),
        argnums=(0, 1))(jnp.asarray(loc), jnp.asarray(conf))
    tl = torch.from_numpy(loc).requires_grad_()
    tc = torch.from_numpy(conf).requires_grad_()
    got = tod.MultiBoxLoss(priors)(
        tuple(torch.from_numpy(a) for a in (boxes, labels, mask)), (tl, tc))
    got.backward()
    assert abs(float(got.detach()) - float(want)) <= \
        LOSS_RTOL * abs(float(want))
    for g, w in ((tl.grad, wgl), (tc.grad, wgc)):
        w = np.asarray(w)
        _assert_close(g, w, LOSS_RTOL * float(np.abs(w).max()))
        # the same priors get a gradient: the same negatives were mined
        np.testing.assert_array_equal(g.abs().sum(-1).numpy() > 0,
                                      np.abs(w).sum(-1) > 0)


# -------------------------------------------------------------------- SSD
def test_ssd_vgg300_priors_and_variable_tree_match_reference():
    JLayer.reset_name_counters()
    jm, jpriors = jod.ssd_vgg300(num_classes=21)
    TLayer.reset_name_counters()
    tm, tpriors = tod.ssd_vgg300(num_classes=21)
    assert tpriors.shape == (8732, 4) and tpriors.dtype == np.float32
    np.testing.assert_array_equal(tpriors, jpriors)
    want = jax.eval_shape(lambda k: JLayer.init(jm, k, None),
                          jax.random.PRNGKey(0))
    got = tm.get_variables()
    assert jax.tree_util.tree_structure(got) == \
        jax.tree_util.tree_structure(want)
    for (path, g), w in zip(jax.tree_util.tree_leaves_with_path(got),
                            jax.tree_util.tree_leaves(want)):
        assert tuple(g.shape) == tuple(w.shape), path
        assert g.dtype == torch.float32
    assert tm.get_output_shape() == [(None, 8732, 4), (None, 8732, 21)]


@pytest.fixture(scope="module")
def lite():
    """``ssd_lite`` (4 classes, 64x64) in both packages on the port's
    seeded weights, the heads' kernels scaled up so the scores spread."""
    JLayer.reset_name_counters()
    jm, priors = jod.ssd_lite(num_classes=4, image_size=SIZE)
    TLayer.reset_name_counters()
    tm, tpriors = tod.ssd_lite(num_classes=4, image_size=SIZE)
    # drawn on the CPU without placing (no zoo context yet at module scope)
    drawn = TLayer.init(tm, torch.Generator().manual_seed(0), None)
    variables = jax.tree_util.tree_map(lambda t: t.numpy().copy(), drawn)
    for layer, p in variables["params"].items():
        if "bias" in p:                     # the heads have biases
            p["kernel"] = p["kernel"] * 8.0
    jm.set_variables(jax.tree_util.tree_map(jnp.asarray, variables))
    np.testing.assert_array_equal(tpriors, priors)
    return jm, priors, variables


def _port_lite(variables):
    TLayer.reset_name_counters()
    tm, priors = tod.ssd_lite(num_classes=4, image_size=SIZE)
    load_jax_variables(tm, variables)
    return tm, priors


def _lite_images(n, seed):
    return np.random.RandomState(seed).rand(n, SIZE, SIZE, 3).astype(
        np.float32)


def test_ssd_lite_forward_matches_reference(lite):
    jm, _, variables = lite
    tm, _ = _port_lite(variables)
    x = _lite_images(3, 6)
    want = jm.predict(x, batch_size=3)
    got = tm.predict(x, batch_size=3)
    assert [g.shape for g in got] == [(3, 1344, 4), (3, 1344, 4)]
    for g, w in zip(got, want):
        _assert_close(g, w, FWD_ATOL)


@pytest.mark.parametrize("per_class", [False, True])
def test_ssd_lite_detect_matches_reference(lite, per_class):
    jm, priors, variables = lite
    tm, _ = _port_lite(variables)
    kw = dict(num_classes=4, score_threshold=0.3, max_detections=25,
              per_class_nms=per_class, topk_per_class=50)
    x = _lite_images(4, 7)
    want = jod.SSDDetector(jm, priors, **kw).detect(x)
    got = tod.SSDDetector(tm, priors, **kw).detect(x)
    assert len(got) == len(want) == 4
    n = 0
    for (gb, gs, gl), (wb, ws, wl) in zip(got, want):
        assert len(gl) == len(wl)
        n += len(gl)
        np.testing.assert_array_equal(gl, np.asarray(wl))
        _assert_close(gb, wb, FWD_ATOL)
        _assert_close(gs, ws, FWD_ATOL)
    assert n > 8


def test_five_adam_steps_match_reference(lite):
    """Five ``train_step``s of the MultiBox loss under Adam on the same
    batches: the losses, then the params and moving statistics."""
    jm, priors, variables = lite
    tm, _ = _port_lite(variables)
    rs = np.random.RandomState(8)
    x = _lite_images(8, 9)
    y = _gt(rs, 8, 4, priors)
    # the JAX batch whole on one data shard, as the port takes BN's
    # statistics over the whole batch
    jctx.init_zoo_context(mesh_shape={"data": 1, "model": 8})
    jtr = JTrainer(jm, jod.MultiBoxLoss(priors),
                   optim_method=jopt.Adam(lr=1e-3))
    ttr = DistributedTrainer(tm, tod.MultiBoxLoss(priors),
                             optim_method=topt.Adam(lr=1e-3))
    runs = {}
    for name, tr, v, rng in (("jax", jtr, variables, jax.random.PRNGKey(0)),
                             ("torch", ttr, tm.get_variables(), None)):
        params = tr.place_params(v["params"])
        state = tr.replicate(v["state"])
        opt_state = tr.init_opt_state(params)
        batch = tr.put_batch((x, y))
        losses = []
        for _ in range(5):
            params, opt_state, state, loss = tr.train_step(
                params, opt_state, state, batch, rng)
            losses.append(float(loss))
        runs[name] = (losses, params, state)
    (jl, jp, js), (tl, tp, ts) = runs["jax"], runs["torch"]
    np.testing.assert_allclose(tl, jl, atol=STEP_ATOL, rtol=0)
    assert tl[-1] < tl[0]
    for got, want in ((tp, _np(jp)), (ts, _np(js))):
        for layer in want:
            for k, w in want[layer].items():
                _assert_close(got[layer][k], w, STEP_ATOL, f"{layer}/{k}")


# -------------------------------------------------------------- mAP
@pytest.mark.parametrize("use_07", [False, True])
def test_mean_average_precision_matches_reference(use_07):
    rs = np.random.RandomState(10)
    t, j = (mod.MeanAveragePrecision(4, 0.5, use_07) for mod in (tod, jod))
    for _ in range(6):
        gt = _boxes(rs, 3, 0.0, 0.9)
        gl = rs.randint(1, 4, 3)
        diff = rs.rand(3) < 0.3
        det = np.concatenate([gt + rs.randn(3, 4).astype(np.float32) * 0.03,
                              _boxes(rs, 4)])
        ds = rs.rand(7).astype(np.float32)
        dl = np.concatenate([gl, rs.randint(1, 4, 4)])
        for m in (t, j):
            m.add(det, ds, dl, gt, gl, diff)
    assert t.result() == j.result()
    assert 0.0 < t.result()["mAP"] <= 1.0


# -------------------------------------------------------------------- VOC
def _write_voc(root, n=6, size=48, seed=0):
    """A VOCdevkit tree written from a seed: JPEG images with bright
    squares and their XML (a difficult box, an unknown class), and a
    split file."""
    rs = np.random.RandomState(seed)
    for d in ("JPEGImages", "Annotations", os.path.join("ImageSets",
                                                       "Main")):
        os.makedirs(os.path.join(root, d), exist_ok=True)
    ids = []
    for i in range(n):
        img = (rs.rand(size, size + 8, 3) * 60).astype(np.uint8)
        objs = []
        for k in range(1 + i % 3):
            w = rs.randint(size // 6, size // 3)
            x0, y0 = rs.randint(0, size - w), rs.randint(0, size - w)
            img[y0:y0 + w, x0:x0 + w] = 200 + 20 * k
            objs.append((("car", "dog", "cat")[k], int(k == 1),
                         x0 + 1, y0 + 1, x0 + w, y0 + w))
        img_id = f"im{i:03d}"
        ids.append(img_id)
        cv2.imwrite(os.path.join(root, "JPEGImages", img_id + ".jpg"), img)
        body = "".join(
            f"<object><name>{name}</name><difficult>{d}</difficult>"
            f"<bndbox><xmin>{a}</xmin><ymin>{b}</ymin><xmax>{c}</xmax>"
            f"<ymax>{e}</ymax></bndbox></object>"
            for name, d, a, b, c, e in objs)
        body += ("<object><name>unknown</name><bndbox><xmin>1</xmin>"
                 "<ymin>1</ymin><xmax>5</xmax><ymax>5</ymax></bndbox>"
                 "</object>")
        with open(os.path.join(root, "Annotations", img_id + ".xml"),
                  "w") as f:
            f.write(f"<annotation>{body}</annotation>")
    with open(os.path.join(root, "ImageSets", "Main", "train.txt"),
              "w") as f:
        f.write("\n".join(ids[1:]) + "\n")
    return ids


@pytest.mark.parametrize("split", [None, "train"])
def test_detection_set_matches_reference(tmp_path, split):
    """Read, the lazy chain of every box-aware transform over two epochs,
    and ``to_feature_set``'s padding."""
    ids = _write_voc(str(tmp_path))
    t = tdet.DetectionSet.read_voc(str(tmp_path), split=split)
    j = jdet.DetectionSet.read_voc(str(tmp_path), split=split)
    assert len(t) == len(j) == (len(ids) if split is None else len(ids) - 1)
    for a, b in zip(t.samples, j.samples):
        assert a["id"] == b["id"]
        for k in ("image", "boxes", "labels", "difficult"):
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k])
    assert any(s["difficult"].any() for s in t.samples)
    stages = {}
    for mod, ds in (("t", t), ("j", j)):
        m = tdet if mod == "t" else jdet
        stages[mod] = ds >> m.DetExpand(max_ratio=1.5, prob=0.7, seed=1) \
            >> m.DetRandomCrop(min_scale=0.5, prob=0.8, seed=2) \
            >> m.DetHFlip(prob=0.5, seed=3) >> m.DetColorJitter(seed=4) \
            >> m.DetResize(40, 40) \
            >> m.DetNormalize((120, 115, 100), (60, 60, 60))
    for epoch in (0, 1):
        ta = stages["t"].materialize(epoch).samples
        ja = stages["j"].materialize(epoch).samples
        for a, b in zip(ta, ja):
            for k in ("image", "boxes", "labels", "difficult"):
                assert a[k].dtype == b[k].dtype, k
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        tf = stages["t"].to_feature_set(max_boxes=2, shuffle=False,
                                        include_difficult=epoch == 0,
                                        epoch=epoch)
        jf = stages["j"].to_feature_set(max_boxes=2, shuffle=False,
                                        include_difficult=epoch == 0,
                                        epoch=epoch)
        np.testing.assert_array_equal(tf.x, jf.x)
        for g, w in zip(tf.y, jf.y):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
    # the source samples are untouched by the lazy chain
    np.testing.assert_array_equal(t.samples[0]["boxes"],
                                  j.samples[0]["boxes"])


# ---------------------------------------------------------------- facade
def test_detector_saved_by_the_jax_package_loads_in_the_port(tmp_path):
    JLayer.reset_name_counters()
    jd = jod.ObjectDetector("ssd_lite", num_classes=3, image_size=32,
                            score_threshold=0.0, max_detections=10,
                            label_map={"bg": 0, "cat": 1, "dog": 2})
    path = str(tmp_path / "det.zoomodel")
    jd.save_model(path)
    td = tod.ObjectDetector.load_model(path)
    assert td.config.label_map == {"bg": 0, "cat": 1, "dog": 2}
    assert (td.num_classes, td.image_size, td.max_detections) == (3, 32, 10)
    x = np.random.RandomState(11).rand(5, 32, 32, 3).astype(np.float32)
    s = timage.ImageSet.from_ndarrays(x)
    got = td.predict_image_set(s, batch_size=4)       # a padded tail
    want = jd.predict_image_set(jimage.ImageSet.from_ndarrays(x),
                                batch_size=4)
    assert len(got) == len(want) == 5
    for (gb, gs, gl), (wb, ws, wl) in zip(got, want):
        np.testing.assert_array_equal(gl, np.asarray(wl))
        _assert_close(gb, wb, FWD_ATOL)
        _assert_close(gs, ws, FWD_ATOL)
    assert td.label_names([1, 2, 5]) == jd.label_names([1, 2, 5]) == \
        ["cat", "dog", "5"]
    b, sc, lb = got[0]
    for img in (x[0], (x[0] * 255).astype(np.uint8)):
        np.testing.assert_array_equal(td.visualize(img, b, sc, lb),
                                      jd.visualize(img, b, sc, lb))
    # and back: the port's file loads in the JAX package
    td.save_model(path)
    back = jod.ObjectDetector.load_model(path)
    for g, w in zip(back.detect(x[:2]), td.detect(x[:2])):
        np.testing.assert_array_equal(np.asarray(g[2]), w[2])
    # a file whose meta does not match its variables is refused
    TLayer.reset_name_counters()
    mine = tod.ObjectDetector("ssd_lite", num_classes=3, image_size=32)
    mine.num_classes = 7            # the meta says 7, the graph has 3
    mine.save_model(path)
    with pytest.raises(ValueError, match="does not match"):
        tod.ObjectDetector.load_model(path)


def test_detector_names_and_the_pretrained_detectors():
    with pytest.raises(ValueError, match="unknown detector"):
        tod.ObjectDetector("yolo")
    for name in ("ssd300_vgg16", "ssdlite320_mobilenet_v3"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            tod.ObjectDetector(name)
    d = tod.ObjectDetector("ssd_lite", num_classes=3, image_size=32,
                           score_threshold=0.0)
    first = d.detector
    assert d.detector is first
    d.iou_threshold = 0.3           # a threshold edit rebuilds
    assert d.detector is not first
