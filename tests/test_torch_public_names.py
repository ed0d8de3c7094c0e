"""PyTorch port, public names: for each package of the port that has a
counterpart in the JAX package, every public name of the reference's
``__init__.py`` (the names it imports, defines or assigns, read with
``ast`` so that no JAX is imported) is an attribute of the port's
package, less the names listed in ``OWED``, which ROADMAP.md's queue 1
still owes.  Each owed name must really be missing (a name that is
ported leaves the list), and the list holds none of the 64 layer classes
that came with the regularizers and ``AnomalyDetector``."""

import ast
import importlib
import pathlib

import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT = REPO / "analytics_zoo_torch"
REF = REPO / "analytics_zoo_tpu"

OWED = {
    "pipeline.api.keras.layers": set(),
    "pipeline.estimator": set(),
    "serving": set(),
    # queue 1 item 9 (MFU)
    "observability": {"publish_mfu"},
    "parallel": set(),
    "tfpark": set(),
    # the torchvision-derived pretrained detectors (pretrained.py,
    # pretrained_ssdlite.py): they wait for checkpoint files
    "models.image.objectdetection": {
        "COCO_91_LABELS", "coco_label_map", "detection_configure",
        "load_object_detector", "load_torch_ssd300", "ssd300_vgg16",
        "tv_default_boxes", "load_torch_ssdlite320",
        "ssdlite320_mobilenet_v3", "ssdlite_default_boxes"},
    # queue 1 item 9: the benchmarks' MFU helpers
    "benchmarks": {"PEAK_FLOPS", "calibrate_chip", "compiled_flops",
                   "cost_of_compiled", "mfu_estimate"},
}

THIS_SLICE = {
    "Reshape", "Permute", "RepeatVector", "Masking", "Highway",
    "MaxoutDense", "SparseDense", "LeakyReLU", "ELU", "ThresholdedReLU",
    "PReLU", "SReLU", "Softmax", "AddConstant", "MulConstant", "Exp", "Log",
    "Sqrt", "Square", "Power", "Negative", "Identity", "Threshold",
    "BinaryThreshold", "HardShrink", "SoftShrink", "HardTanh", "RReLU",
    "CAdd", "CMul", "Mul", "Scale", "LRN2D", "WithinChannelLRN2D",
    "ResizeBilinear", "GaussianSampler", "GaussianNoise", "GaussianDropout",
    "SpatialDropout1D", "SpatialDropout2D", "SpatialDropout3D", "Select",
    "Narrow", "Squeeze", "ExpandDim", "Expand", "SplitTensor",
    "SelectTable", "Max", "GetShape", "L2Normalization", "NormalizeScale",
    "SparseEmbedding", "SeparableConvolution2D", "Deconvolution2D",
    "Cropping1D", "Cropping2D", "Cropping3D", "UpSampling1D",
    "UpSampling2D", "UpSampling3D", "ShareConvolution2D",
    "LocallyConnected1D", "LocallyConnected2D",
    "AnomalyDetector", "detect_anomalies", "unroll",
}


def _public_names(init: pathlib.Path):
    """The public names a package's ``__init__.py`` binds at top level."""
    out = set()
    for node in ast.parse(init.read_text()).body:
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            out.update((a.asname or a.name).split(".")[0]
                       for a in node.names)
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                               ast.ClassDef)):
            out.add(node.name)
        elif isinstance(node, ast.Assign):
            out.update(t.id for t in node.targets
                       if isinstance(t, ast.Name))
    return {n for n in out if not n.startswith("_") and n != "annotations"}


def _packages():
    pkgs = []
    for init in sorted(PORT.rglob("__init__.py")):
        rel = init.parent.relative_to(PORT)
        if (REF / rel / "__init__.py").exists():
            pkgs.append(".".join(rel.parts))
    return pkgs


PACKAGES = _packages()


def test_the_port_packages_with_a_counterpart():
    assert "" in PACKAGES and "common" in PACKAGES and "ops" in PACKAGES
    assert "compile" in PACKAGES
    assert "models.anomalydetection" in PACKAGES
    assert {"models.textmatching", "pipeline.api.keras2",
            "pipeline.api.keras.datasets", "pipeline.nnframes",
            "models.image.objectdetection", "pipeline.api.net",
            "pipeline.api.onnx", "tfpark.gan"} <= set(PACKAGES)
    assert set(OWED) <= set(PACKAGES)
    assert not THIS_SLICE & set().union(*OWED.values())


@pytest.mark.parametrize("pkg", PACKAGES, ids=[p or "root" for p in PACKAGES])
def test_public_names_match_the_reference(pkg):
    rel = pathlib.Path(*pkg.split(".")) if pkg else pathlib.Path()
    ref_names = _public_names(REF / rel / "__init__.py")
    mod = importlib.import_module(
        "analytics_zoo_torch" + (f".{pkg}" if pkg else ""))
    owed = OWED.get(pkg, set())
    assert owed <= ref_names, sorted(owed - ref_names)
    missing = sorted(n for n in ref_names - owed if not hasattr(mod, n))
    assert missing == [], f"analytics_zoo_torch.{pkg} lacks {missing}"
    # an owed name that the port has is no longer owed
    ported = sorted(n for n in owed if hasattr(mod, n))
    assert ported == [], f"ported, take them off OWED: {ported}"


def test_the_repaired_re_exports():
    from analytics_zoo_torch.common import (  # noqa: F401
        EveryEpoch, MaxEpoch, MaxIteration, MaxScore, MinLoss,
        SeveralIteration, Trigger, TriggerAnd, TriggerOr)
    from analytics_zoo_torch.common import triggers
    from analytics_zoo_torch.ops import Policy, get_policy, set_policy
    from analytics_zoo_torch.ops import dtypes
    assert EveryEpoch is triggers.EveryEpoch and MaxEpoch is triggers.MaxEpoch
    assert (Policy, get_policy, set_policy) == \
        (dtypes.Policy, dtypes.get_policy, dtypes.set_policy)


def test_layers_all_is_the_references_less_the_owed():
    tree = ast.parse((REF / "pipeline/api/keras/layers/__init__.py")
                     .read_text())
    ref_all = next(node.value for node in tree.body
                   if isinstance(node, ast.Assign) and
                   any(isinstance(t, ast.Name) and t.id == "__all__"
                       for t in node.targets))
    ref_all = {ast.literal_eval(e) for e in ref_all.elts}
    from analytics_zoo_torch.pipeline.api.keras import layers
    assert set(layers.__all__) == ref_all - OWED["pipeline.api.keras.layers"]
    assert len(layers.__all__) == len(set(layers.__all__))
