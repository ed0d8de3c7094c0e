"""PyTorch port, isolation: importing the port (and every module of the
serving, training, Cluster Serving, recommender, recurrent/generative,
persistence, transformer-model, Keras-layer/AnomalyDetector,
text-matching/autograd/keras2/datasets, compile, data-pipeline and
batch-scoring, and image-decode/NNFrames/object-detection slices)
pulls in none of ``jax``, ``analytics_zoo_tpu``, ``flax``, ``msgpack``,
``tensorflow`` and ``transformers``, no port source imports the first
four or loads a file of the JAX package by path (the one file-path
loader, the batch worker's ``resolve_ref`` for a user's builder file,
refuses the JAX package's files), TensorFlow is imported only inside the
functions that call it (the BERT checkpoint loader's google reader, TFNet,
the TF1 ``train_op`` importer, the Inception-v1 builder) and ``torch.fx``
only inside TorchNet's, and the context refuses to fall back to the CPU
quietly. Each import check runs in a fresh interpreter,
since this test process has both loaded."""

import ast
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
    "analytics_zoo_torch.data.source",
    "analytics_zoo_torch.data.sampler",
    "analytics_zoo_torch.data.stages",
    "analytics_zoo_torch.data.pipeline",
    "analytics_zoo_torch.data.device_loader",
    "analytics_zoo_torch.data.adapters",
    "analytics_zoo_torch.utils.crc32c",
    "analytics_zoo_torch.utils.pbwire",
    "analytics_zoo_torch.feature.tfrecord",
    "analytics_zoo_torch.observability.aggregator",
    "analytics_zoo_torch.parallel.launcher",
    "analytics_zoo_torch.batchjobs",
    "analytics_zoo_torch.batchjobs.spec",
    "analytics_zoo_torch.batchjobs.manifest",
    "analytics_zoo_torch.batchjobs.report",
    "analytics_zoo_torch.batchjobs.worker",
    "analytics_zoo_torch.batchjobs.coordinator",
    "analytics_zoo_torch.batchjobs.demo",
    "analytics_zoo_torch.batchjobs.cli",
    "analytics_zoo_torch.feature.image3d",
    "analytics_zoo_torch.feature.image_detection",
    "analytics_zoo_torch.pipeline.nnframes",
    "analytics_zoo_torch.pipeline.nnframes.nn_estimator",
    "analytics_zoo_torch.pipeline.nnframes.nn_image_reader",
    "analytics_zoo_torch.models.image.objectdetection",
    "analytics_zoo_torch.pipeline.api.onnx",
    "analytics_zoo_torch.pipeline.api.onnx.onnx_pb",
    "analytics_zoo_torch.pipeline.api.onnx.mapper",
    "analytics_zoo_torch.pipeline.api.onnx.onnx_loader",
    "analytics_zoo_torch.pipeline.api.net",
    "analytics_zoo_torch.pipeline.api.net.torch_net",
    "analytics_zoo_torch.pipeline.api.net.tf_net",
    "analytics_zoo_torch.pipeline.api.net.net",
    "analytics_zoo_torch.tfpark.converter",
    "analytics_zoo_torch.tfpark.model",
    "analytics_zoo_torch.tfpark.tf_dataset",
    "analytics_zoo_torch.tfpark.tf_optimizer",
    "analytics_zoo_torch.tfpark.estimator",
    "analytics_zoo_torch.tfpark.tf_predictor",
    "analytics_zoo_torch.tfpark.tf1_graph",
    "analytics_zoo_torch.tfpark.gan",
    "analytics_zoo_torch.tfpark.gan.gan_estimator",
    "analytics_zoo_torch.benchmarks.inception",
    "analytics_zoo_torch.benchmarks.wide_deep",
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


# the modules that call TensorFlow (or trace with torch.fx), each import
# inside the functions that need it
TF_IMPORTERS = {
    "analytics_zoo_torch/tfpark/text/bert_checkpoint.py": 1,
    "analytics_zoo_torch/pipeline/api/net/tf_net.py": 4,
    "analytics_zoo_torch/tfpark/tf1_graph.py": 1,
    "analytics_zoo_torch/tfpark/tf_optimizer.py": 1,
    "analytics_zoo_torch/benchmarks/inception.py": 1,
}
FX_IMPORTERS = {"analytics_zoo_torch/pipeline/api/net/torch_net.py": 3}


def _indented_imports(pattern):
    found = {str(p.relative_to(REPO)): [m.group(1) for m in
                                        pattern.finditer(p.read_text())]
             for p in PORT.rglob("*.py")}
    return {k: v for k, v in found.items() if v}


def test_tensorflow_is_imported_only_by_the_google_checkpoint_reader():
    """TensorFlow (and transformers) are imported by the BERT checkpoint
    loader's google reader and by the TensorFlow-facing modules of TFPark
    and ``pipeline/api/net``, every import indented: inside a function,
    run only when called (the TFPark converter decides the topology from
    the model object and imports none); ``torch.fx`` likewise only inside
    TorchNet's functions."""
    found = _indented_imports(re.compile(
        r"^(\s*)(import|from)\s+(tensorflow|transformers)\b", re.M))
    assert {k: len(v) for k, v in found.items()} == TF_IMPORTERS
    assert all(indent for v in found.values() for indent in v)
    fx = _indented_imports(re.compile(r"^(\s*)(import|from)\s+torch\.fx\b",
                                      re.M))
    assert {k: len(v) for k, v in fx.items()} == FX_IMPORTERS
    assert all(indent for v in fx.values() for indent in v)


# the one place a file is loaded by path: a batch job's builder ref
# ``/path/to/file.py:attr`` (the reference's ``resolve_ref``), which
# refuses the JAX package's files
PATH_LOADER = ("analytics_zoo_torch/batchjobs/worker.py", "resolve_ref")


def _function_lines(path: pathlib.Path, name: str):
    tree = ast.parse(path.read_text())
    fn = next(n for n in tree.body
              if isinstance(n, ast.FunctionDef) and n.name == name)
    return range(fn.lineno, fn.end_lineno + 1)


def test_port_sources_load_no_reference_file_by_path():
    """The port keeps its own copies: no file-path loader
    (``scripts/_analysis_loader.py``, ``spec_from_file_location``,
    ``SourceFileLoader``, ``runpy``) but ``spec_from_file_location`` in
    ``batchjobs/worker.py::resolve_ref``."""
    pattern = re.compile(r"_analysis_loader|spec_from_file_location|"
                         r"SourceFileLoader|runpy")
    allowed = _function_lines(REPO / PATH_LOADER[0], PATH_LOADER[1])
    offenders = []
    for p in PORT.rglob("*.py"):
        rel = str(p.relative_to(REPO))
        for i, line in enumerate(p.read_text().splitlines(), 1):
            m = pattern.search(line)
            if m is None:
                continue
            if rel == PATH_LOADER[0] and i in allowed and \
                    m.group(0) == "spec_from_file_location":
                continue
            offenders.append(f"{rel}:{i}")
    assert offenders == []
    # and the function does use it, once: the allowance is not stale
    worker = (REPO / PATH_LOADER[0]).read_text().splitlines()
    assert sum("spec_from_file_location" in worker[i - 1]
               for i in allowed) == 1


@pytest.mark.parametrize("target", [
    "analytics_zoo_tpu/batchjobs/demo.py",
    "analytics_zoo_tpu/../analytics_zoo_tpu/data/source.py",
    "analytics_zoo_tpu/batchjobs/no_such_file.py",
])
def test_resolve_ref_refuses_the_reference_package(target, tmp_path):
    """A builder file under the JAX package's directory is refused before
    anything is loaded; a file elsewhere loads."""
    code = "\n".join([
        "import sys",
        "from analytics_zoo_torch.batchjobs.worker import resolve_ref",
        "before = set(sys.modules)",
        "try:",
        f"    resolve_ref({str(REPO / target)!r} + ':demo_model')",
        "except ValueError as e:",
        "    assert 'JAX package' in str(e), e",
        "else:",
        "    raise SystemExit('loaded a file of the JAX package')",
        "new = sorted(m for m in set(sys.modules) - before",
        "             if 'builder' in m or 'analytics_zoo_tpu' in m)",
        "assert not new, new",
        f"path = {str(tmp_path / 'builder.py')!r}",
        "open(path, 'w').write('def make(k=1):\\n    return k + 1\\n')",
        "assert resolve_ref(path + ':make')(k=2) == 3",
        "print('OK')",
    ])
    proc = _run(code)
    assert proc.returncode == 0 and "OK" in proc.stdout, \
        proc.stdout + proc.stderr


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
