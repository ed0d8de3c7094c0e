"""PyTorch port, isolation: importing the port (and every module of the
serving, training, Cluster Serving, recommender, recurrent/generative,
persistence, transformer-model, Keras-layer/AnomalyDetector and
text-matching/autograd/keras2/datasets and compile slices)
pulls in none of ``jax``, ``analytics_zoo_tpu``, ``flax``, ``msgpack``,
``tensorflow`` and ``transformers``, no port source imports the first
four or loads a file of the JAX package by path, TensorFlow is imported
only inside the BERT checkpoint loader's google reader, and the context
refuses to fall back to the CPU quietly. Each import check runs in a
fresh interpreter, since this test process has both loaded."""

import os
import pathlib
import re
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT = REPO / "analytics_zoo_torch"

SLICE_MODULES = [
    "analytics_zoo_torch",
    "analytics_zoo_torch.common.config",
    "analytics_zoo_torch.common.zoo_context",
    "analytics_zoo_torch.ops.dtypes",
    "analytics_zoo_torch.ops.initializers",
    "analytics_zoo_torch.ops.activations",
    "analytics_zoo_torch.ops.attention",
    "analytics_zoo_torch.ops.flash_attention",
    "analytics_zoo_torch.ops.fused",
    "analytics_zoo_torch.ops.kernels",
    "analytics_zoo_torch.pipeline.api.keras",
    "analytics_zoo_torch.pipeline.api.keras.layers",
    "analytics_zoo_torch.models.textclassification",
    "analytics_zoo_torch.pipeline.inference",
    "analytics_zoo_torch.interop",
    "analytics_zoo_torch.common.triggers",
    "analytics_zoo_torch.feature",
    "analytics_zoo_torch.parallel.trainer",
    "analytics_zoo_torch.pipeline.estimator",
    "analytics_zoo_torch.pipeline.api.keras.objectives",
    "analytics_zoo_torch.pipeline.api.keras.optimizers",
    "analytics_zoo_torch.pipeline.api.keras.metrics",
    "analytics_zoo_torch.common.fsutil",
    "analytics_zoo_torch.observability",
    "analytics_zoo_torch.observability.metrics",
    "analytics_zoo_torch.observability.tracing",
    "analytics_zoo_torch.observability.reqtrace",
    "analytics_zoo_torch.observability.flightrec",
    "analytics_zoo_torch.observability.exporter",
    "analytics_zoo_torch.observability.telemetry",
    "analytics_zoo_torch.resilience",
    "analytics_zoo_torch.data",
    "analytics_zoo_torch.utils.summary",
    "analytics_zoo_torch.utils.tb_writer",
    "analytics_zoo_torch.serving",
    "analytics_zoo_torch.serving.engine",
    "analytics_zoo_torch.serving.redis_client",
    "analytics_zoo_torch.serving.server",
    "analytics_zoo_torch.serving.client",
    "analytics_zoo_torch.serving.cli",
    "analytics_zoo_torch.feature.datasets.movielens",
    "analytics_zoo_torch.models.recommendation",
    "analytics_zoo_torch.pipeline.api.keras.layers.recurrent",
    "analytics_zoo_torch.models.seq2seq",
    "analytics_zoo_torch.models.recommendation.session_recommender",
    "analytics_zoo_torch.serving.engine.decode",
    "analytics_zoo_torch.pipeline.api.keras.layers.normalization",
    "analytics_zoo_torch.pipeline.api.keras.layers.pooling",
    "analytics_zoo_torch.feature.common",
    "analytics_zoo_torch.feature.image",
    "analytics_zoo_torch.models.image",
    "analytics_zoo_torch.models.image.imageclassification",
    "analytics_zoo_torch.benchmarks",
    "analytics_zoo_torch.benchmarks.attention",
    "analytics_zoo_torch.utils.msgpack_codec",
    "analytics_zoo_torch.utils.serialization",
    "analytics_zoo_torch.utils.file_io",
    "analytics_zoo_torch.resilience.policy",
    "analytics_zoo_torch.pipeline.api.keras.layers.wrappers",
    "analytics_zoo_torch.pipeline.api.keras.layers.attention",
    "analytics_zoo_torch.tfpark",
    "analytics_zoo_torch.tfpark.text",
    "analytics_zoo_torch.tfpark.text.estimator",
    "analytics_zoo_torch.tfpark.text.bert_checkpoint",
    "analytics_zoo_torch.tfpark.text.keras_models",
    "analytics_zoo_torch.pipeline.api.keras.regularizers",
    "analytics_zoo_torch.pipeline.api.keras.layers.advanced_activations",
    "analytics_zoo_torch.pipeline.api.keras.layers.elementwise",
    "analytics_zoo_torch.pipeline.api.keras.layers.noise",
    "analytics_zoo_torch.pipeline.api.keras.layers.shape_ops",
    "analytics_zoo_torch.pipeline.api.keras.layers.local",
    "analytics_zoo_torch.models.anomalydetection",
    "analytics_zoo_torch.feature.text",
    "analytics_zoo_torch.models.common_ranker",
    "analytics_zoo_torch.models.textmatching",
    "analytics_zoo_torch.models.textmatching.knrm",
    "analytics_zoo_torch.pipeline.api.autograd",
    "analytics_zoo_torch.pipeline.api.keras.layers.convlstm",
    "analytics_zoo_torch.pipeline.api.keras.layers.moe",
    "analytics_zoo_torch.pipeline.api.keras2",
    "analytics_zoo_torch.pipeline.api.keras2.layers",
    "analytics_zoo_torch.pipeline.api.keras2.models",
    "analytics_zoo_torch.pipeline.api.keras.datasets",
    "analytics_zoo_torch.pipeline.api.keras.datasets.mnist",
    "analytics_zoo_torch.pipeline.api.keras.datasets.imdb",
    "analytics_zoo_torch.pipeline.api.keras.datasets.reuters",
    "analytics_zoo_torch.pipeline.api.keras.datasets.boston_housing",
    "analytics_zoo_torch.compile",
    "analytics_zoo_torch.compile.engine",
    "analytics_zoo_torch.compile.cache",
    "analytics_zoo_torch.observability.diagnostics",
]


def _run(code: str) -> subprocess.CompletedProcess:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    return subprocess.run([sys.executable, "-c", code], cwd=str(REPO),
                          env=env, capture_output=True, text=True,
                          timeout=120)


def test_port_imports_no_jax_and_no_reference_package():
    code = "\n".join(
        [f"import {m}" for m in SLICE_MODULES] +
        ["import sys",
         "bad = sorted(m for m in sys.modules if m in ('jax', 'flax', "
         "'msgpack', 'tensorflow', 'transformers') or m.startswith(("
         "'jax.', 'jaxlib', 'flax.', 'msgpack.', 'analytics_zoo_tpu', "
         "'tensorflow.', 'transformers.')))",
         "print('LOADED', bad)",
         "sys.exit(1 if bad else 0)"])
    proc = _run(code)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_port_sources_import_neither():
    pattern = re.compile(
        r"^\s*(import|from)\s+(jax|jaxlib|analytics_zoo_tpu|flax|msgpack)\b",
        re.M)
    offenders = [str(p.relative_to(REPO)) for p in PORT.rglob("*.py")
                 if pattern.search(p.read_text())]
    assert offenders == []


def test_tensorflow_is_imported_only_by_the_google_checkpoint_reader():
    pattern = re.compile(r"^(\s*)(import|from)\s+(tensorflow|transformers)\b",
                         re.M)
    found = {str(p.relative_to(REPO)): [m.group(1) for m in
                                        pattern.finditer(p.read_text())]
             for p in PORT.rglob("*.py")}
    found = {k: v for k, v in found.items() if v}
    assert list(found) == ["analytics_zoo_torch/tfpark/text/bert_checkpoint.py"]
    # one import, indented: inside _google_reader, run only when called
    assert found["analytics_zoo_torch/tfpark/text/bert_checkpoint.py"] == \
        ["    "]


def test_port_sources_load_no_reference_file_by_path():
    """The port keeps its own copies: no file-path loader
    (``scripts/_analysis_loader.py``, ``spec_from_file_location``)."""
    pattern = re.compile(r"_analysis_loader|spec_from_file_location|"
                         r"SourceFileLoader|runpy")
    offenders = [str(p.relative_to(REPO)) for p in PORT.rglob("*.py")
                 if pattern.search(p.read_text())]
    assert offenders == []


def test_context_without_a_gpu_raises_unless_cpu_is_asked_for():
    code = "\n".join([
        "import torch",
        "torch.cuda.is_available = lambda: False",
        "from analytics_zoo_torch import init_zoo_context, reset_zoo_context",
        "try:",
        "    init_zoo_context()",
        "except RuntimeError as e:",
        "    assert \"device='cpu'\" in str(e), e",
        "else:",
        "    raise SystemExit('no error without a GPU')",
        "ctx = init_zoo_context(device='cpu')",
        "assert ctx.device.type == 'cpu'",
        "assert torch.backends.cuda.matmul.allow_tf32 is False",
        "assert torch.backends.cudnn.allow_tf32 is False",
        "print('OK')",
    ])
    proc = _run(code)
    assert proc.returncode == 0 and "OK" in proc.stdout, \
        proc.stdout + proc.stderr


@pytest.mark.parametrize("device", ["cuda", "cuda:0"])
def test_model_init_without_a_gpu_raises(device):
    code = "\n".join([
        "import torch",
        "torch.cuda.is_available = lambda: False",
        "from analytics_zoo_torch import init_zoo_context",
        "from analytics_zoo_torch.pipeline.api.keras.layers import Dense",
        "from analytics_zoo_torch.pipeline.api.keras import Input, Model",
        "x = Input(shape=(4,))",
        "m = Model(x, Dense(2)(x))",
        "try:",
        f"    init_zoo_context(device={device!r})",
        "except RuntimeError:",
        "    pass",
        "else:",
        "    raise SystemExit('no error without a GPU')",
        "try:",
        "    m.init()",
        "except RuntimeError:",
        "    print('OK')",
    ])
    proc = _run(code)
    assert proc.returncode == 0 and "OK" in proc.stdout, \
        proc.stdout + proc.stderr
