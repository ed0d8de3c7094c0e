"""PyTorch port, Cluster Serving end to end: the transformer
TextClassifier built in both packages (the JAX weights carried over with
``load_jax_variables``) and served by each package's ``ClusterServing``
over the Redis-stream and HTTP transports; a client of either package
against a server of the other over TCP; the ``InferenceModel`` surface
serving adds (``warm``, the ``inference_predict`` span and metrics, the
model's CUDA device on a server thread); the launch counter under
threads; and the CLI's ``start``/``stop``."""

import contextlib
import sys
import threading
import types

import jax
import numpy as np
import pytest
import torch

import analytics_zoo_tpu.serving.client as jclient
import analytics_zoo_tpu.serving.redis_client as jredis
import analytics_zoo_tpu.serving.server as jserver
from analytics_zoo_tpu.models.textclassification.text_classifier import (
    TextClassifier as JTextClassifier,
)
from analytics_zoo_tpu.ops import dtypes as jdtypes
from analytics_zoo_tpu.pipeline.api.keras.engine import Layer as JLayer
from analytics_zoo_tpu.pipeline.inference.inference_model import (
    InferenceModel as JInferenceModel,
)

import analytics_zoo_torch.serving.client as tclient
import analytics_zoo_torch.serving.redis_client as tredis
import analytics_zoo_torch.serving.server as tserver
from analytics_zoo_torch.common import config as tconfig
from analytics_zoo_torch.common import zoo_context as tctx
from analytics_zoo_torch.interop import load_jax_variables
from analytics_zoo_torch.models.textclassification import TextClassifier
from analytics_zoo_torch.observability import (
    get_registry, get_tracer, reset_flightrec, reset_registry,
    reset_request_log, reset_tracer)
from analytics_zoo_torch.ops import dtypes as tdtypes
from analytics_zoo_torch.ops import kernels
from analytics_zoo_torch.pipeline.api.keras.engine import Layer as TLayer
from analytics_zoo_torch.pipeline.inference import InferenceModel
from analytics_zoo_torch.resilience.chaos import clear_chaos
from analytics_zoo_torch.serving import cli

# the CONFIG of tests/test_torch_text_classifier.py: 2 blocks, width 128
CONFIG = dict(class_num=5, token_length=128, sequence_length=256,
              encoder="transformer", n_head=2, n_block=2, max_words_num=100)
SEQ = CONFIG["sequence_length"]
# f32 policy on both sides: slice 1's logits agree to 8.9e-7, and a
# softmax moves a probability by at most a quarter of a logit's move
PROB_ATOL = 1e-5
WAIT_S = 30.0

PACKAGES = {
    "jax": types.SimpleNamespace(server=jserver, client=jclient,
                                 redis=jredis),
    "torch": types.SimpleNamespace(server=tserver, client=tclient,
                                   redis=tredis),
}


@pytest.fixture(scope="module")
def models():
    """Both packages' InferenceModels on the same weights, f32 policy."""
    jold, told = jdtypes.get_policy(), tdtypes.get_policy()
    jdtypes.set_policy(param_dtype="float32", compute_dtype="float32")
    tdtypes.set_policy(param_dtype="float32", compute_dtype="float32")
    tctx.reset_zoo_context()
    tconfig.reset_config()
    tctx.init_zoo_context(device="cpu")
    JLayer.reset_name_counters()
    jmodel = JTextClassifier(**CONFIG)
    jvars = jax.tree_util.tree_map(np.asarray, jmodel.get_variables())
    TLayer.reset_name_counters()
    tmodel = TextClassifier(**CONFIG)
    load_jax_variables(tmodel, jvars)
    yield {"jax": JInferenceModel().load_zoo(jmodel),
           "torch": InferenceModel().load_zoo(tmodel),
           "torch_model": tmodel}
    jdtypes.restore_policy(jold)
    tdtypes.restore_policy(told)
    tctx.reset_zoo_context()
    tconfig.reset_config()


@pytest.fixture(autouse=True)
def _fresh_port_singletons():
    """The repo conftest resets only the JAX package's globals."""
    def reset():
        reset_registry()
        reset_tracer()
        reset_request_log()
        reset_flightrec()
        clear_chaos()
        kernels.reset_launch_counts()
    reset()
    yield
    reset()


def _records(n=10, seed=0):
    return np.random.RandomState(seed).randint(0, 101, size=(n, SEQ))


def _config(pkg, **kw):
    return PACKAGES[pkg].server.ServingConfig(
        batch_size=4, top_n=3, batch_buckets="1,2,4",
        metrics_host="127.0.0.1", **kw)


def _serve_stream(server_pkg, client_pkg, im, records, broker=None,
                  url=None):
    """Enqueue ``records`` with ``client_pkg``'s queues, serve them with
    ``server_pkg``'s ClusterServing until none is left, and read the
    results back: ``[{"value", "request_id"}, ...]``."""
    s, c = PACKAGES[server_pkg], PACKAGES[client_pkg]
    serving = s.server.ClusterServing(
        im, _config(server_pkg, redis_url=url), broker=broker)
    try:
        inq = c.client.InputQueue(url, broker=broker)
        for i, rec in enumerate(records):
            inq.enqueue(f"r{i}", rec, request_id=f"rid-{i}")
        served = 0
        while served < len(records):
            n = serving.run_once(block_ms=100)
            assert n, "a record was not served"
            served += n
        outq = c.client.OutputQueue(url, broker=broker)
        out = [outq.query_meta(f"r{i}") for i in range(len(records))]
    finally:
        serving.close()
    for i, meta in enumerate(out):
        assert meta["request_id"] == f"rid-{i}"
    return [{"value": m["value"], "request_id": m["request_id"]}
            for m in out]


def _serve_http(server_pkg, client_pkg, im, records):
    s, c = PACKAGES[server_pkg], PACKAGES[client_pkg]
    serving = s.server.ClusterServing(
        im, _config(server_pkg, http_port=0),
        broker=s.redis.EmbeddedBroker())
    try:
        http = c.client.ServingHttpClient(serving.http_transport.url)
        out = [http.predict_http("default", rec, request_id=f"h{i}")
               for i, rec in enumerate(records)]
    finally:
        serving.close()
    return [{"value": d["value"], "request_id": d["request_id"]}
            for d in out]


def _assert_same_results(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g["request_id"] == w["request_id"]
        assert [c for c, _ in g["value"]] == [c for c, _ in w["value"]]
        np.testing.assert_allclose([p for _, p in g["value"]],
                                   [p for _, p in w["value"]],
                                   atol=PROB_ATOL, rtol=0)


# ------------------------------------------------ the port against the JAX
def test_redis_path_matches_reference(models):
    records = _records()
    want = _serve_stream("jax", "jax", models["jax"], records,
                         broker=jredis.EmbeddedBroker())
    got = _serve_stream("torch", "torch", models["torch"], records,
                        broker=tredis.EmbeddedBroker())
    _assert_same_results(got, want)
    assert all(len(r["value"]) == 3 for r in got)
    assert sum(kernels.launch_counts().values()) == 0    # CPU: no kernel


def test_http_path_matches_reference(models):
    records = _records(2, seed=1)
    want = _serve_http("jax", "jax", models["jax"], records)
    got = _serve_http("torch", "torch", models["torch"], records)
    _assert_same_results(got, want)


def test_served_result_is_the_models_top_n(models):
    """What the server writes is ``predict`` of the record through the
    top-N softmax, each record alone or padded with its co-riders."""
    records = _records(3, seed=2)
    got = _serve_stream("torch", "torch", models["torch"], records,
                        broker=tredis.EmbeddedBroker())
    logits = models["torch"].predict(records)
    e = np.exp(logits - logits.max(-1, keepdims=True))
    probs = e / e.sum(-1, keepdims=True)
    for row, res in zip(probs, got):
        top = np.argsort(-row)[:3]
        assert [c for c, _ in res["value"]] == [int(i) for i in top]
        np.testing.assert_allclose([p for _, p in res["value"]], row[top],
                                   atol=1e-6, rtol=0)


@pytest.mark.parametrize("server_pkg,client_pkg",
                         [("torch", "jax"), ("jax", "torch")])
def test_cross_package_wire_over_tcp(models, server_pkg, client_pkg):
    """A client of one package against a server of the other over one
    TCP broker (the client's package's ``BrokerServer``), and over HTTP:
    the results are identical to the server's own package's client."""
    records = _records(6, seed=3)
    im = models[server_pkg]
    srv = PACKAGES[client_pkg].redis.BrokerServer(
        PACKAGES[client_pkg].redis.EmbeddedBroker())
    try:
        cross = _serve_stream(server_pkg, client_pkg, im, records,
                              url=srv.url)
    finally:
        srv.stop()
    same = _serve_stream(server_pkg, server_pkg, im, records,
                         broker=PACKAGES[server_pkg].redis.EmbeddedBroker())
    assert cross == same
    assert _serve_http(server_pkg, client_pkg, im, records[:2]) == \
        _serve_http(server_pkg, server_pkg, im, records[:2])


# --------------------------------------------- the InferenceModel surface
def test_warm_returns_true_per_bucket_and_counts_nothing(models):
    im = InferenceModel().load_zoo(models["torch_model"])
    for b in (1, 2, 4):
        assert im.warm((SEQ,), b) is True
        assert im.warm((SEQ,), b, dtype=np.int64) is True
    reg = get_registry()
    for name in ("inference_predict_total", "inference_records_total"):
        fam = reg.counter(name, "", labels=("backend",))
        assert fam.labels("f32").value == 0, name
    assert not [e for e in get_tracer().events()
                if e["name"] == "inference_predict"]
    serving = tserver.ClusterServing(
        im, _config("torch", input_shape=(SEQ,)),
        broker=tredis.EmbeddedBroker())
    try:
        assert serving.engine.warm_start() == {"default": 3}
        assert serving.warm_start() is True
    finally:
        serving.close()


def test_warm_runs_its_forward_on_a_thread_that_ends(models):
    """CUDA's per-thread library state passes on when a thread ends, so
    ``warm`` runs its forward on a thread of its own that is gone when
    it returns; a forward that fails raises through ``warm`` and leaves
    the shape cold."""
    im = InferenceModel().load_zoo(models["torch_model"])
    forward = im._predict_fn
    threads = []

    def recording(params, state, x):
        threads.append(threading.current_thread())
        return forward(params, state, x)

    im._predict_fn = recording
    assert im.warm((SEQ,), 2) is True
    assert len(threads) == 1
    assert threads[0] is not threading.current_thread()
    assert not threads[0].is_alive()

    def failing(params, state, x):
        raise RuntimeError("forward failed")

    im._predict_fn = failing
    with pytest.raises(RuntimeError, match="forward failed"):
        im.warm((SEQ,), 4)
    im._predict_fn = recording
    assert im.warm((SEQ,), 4) is True
    assert len(threads) == 2


def test_predict_records_the_metrics_and_the_span(models):
    im = InferenceModel().load_zoo(models["torch_model"])
    x = _records(5)
    out = im.predict(x, batch_size=2)
    im.predict(x[:1])
    assert out.shape == (5, CONFIG["class_num"])
    reg = get_registry()
    assert reg.counter("inference_predict_total", "",
                       labels=("backend",)).labels("f32").value == 2
    assert reg.counter("inference_records_total", "",
                       labels=("backend",)).labels("f32").value == 6
    hist = reg.histogram("inference_predict_latency_seconds", "",
                         labels=("backend",)).labels("f32")
    assert hist.count == 2 and hist.sum > 0
    spans = [e for e in get_tracer().events()
             if e["name"] == "inference_predict"]
    assert len(spans) == 2
    assert all(e["args"] == {"backend": "f32"} for e in spans)


def test_predict_and_warm_run_under_the_models_cuda_device(models,
                                                           monkeypatch):
    """The current CUDA device is per host thread; a model on cuda:1
    predicted from a server thread must make cuda:1 current there (a
    mocked ``torch.cuda.device`` records it; no card is touched)."""
    current = threading.local()

    @contextlib.contextmanager
    def fake_device(device):
        prev = getattr(current, "device", None)
        current.device = torch.device(device)
        try:
            yield
        finally:
            current.device = prev

    im = InferenceModel().load_zoo(models["torch_model"])
    seen, built = [], []
    forward = im._predict_fn

    def recording(params, state, x):
        seen.append(getattr(current, "device", None))
        return forward(params, state, x)

    monkeypatch.setattr(torch.cuda, "device", fake_device)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda device=None: None)
    monkeypatch.setattr(kernels, "build_all", built.append)
    monkeypatch.setattr(im, "_to_device", torch.as_tensor)
    im._predict_fn = recording
    im.device = torch.device("cuda", 1)
    errors = []

    def server_thread():
        try:
            im.warm((SEQ,), 2)
            im.predict(_records(3))
        except Exception as e:   # noqa: BLE001 — reported below
            errors.append(e)

    t = threading.Thread(target=server_thread)
    t.start()
    t.join(WAIT_S)
    assert not t.is_alive() and not errors, errors
    assert seen == [torch.device("cuda", 1)] * 2
    assert built == [list(kernels.FORWARD_KERNELS)]


def test_launch_counts_lose_no_increment_across_threads(monkeypatch):
    """Concurrent predicts count every launch: 8 threads x 2000
    launches through ``kernels.launch`` with the C entry point and the
    device queries mocked, under a tiny switch interval."""
    monkeypatch.setattr(kernels, "entry", lambda name: (lambda *a: 0))
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: types.SimpleNamespace(cuda_stream=0))
    dev = torch.device("cuda", 0)
    threads, per_thread = 8, 2000

    def launches():
        for _ in range(per_thread):
            kernels.launch("bias_gelu", dev)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        pool = [threading.Thread(target=launches) for _ in range(threads)]
        for t in pool:
            t.start()
        for t in pool:
            t.join(WAIT_S)
        assert not any(t.is_alive() for t in pool)
    finally:
        sys.setswitchinterval(old)
    counts = kernels.launch_counts()
    assert counts["bias_gelu"] == threads * per_thread
    assert sum(counts.values()) == threads * per_thread


# ------------------------------------------------------------------- CLI
def cli_builder():
    """The builder a config.yaml names: a small port TextClassifier."""
    return TextClassifier(class_num=3, token_length=32, sequence_length=16,
                          encoder="transformer", n_head=2, n_block=1,
                          max_words_num=50)


def test_cli_start_stop_round_trip(models, tmp_path):
    """``start`` (config.yaml → builder → InferenceModel →
    ClusterServing.run) serves records over a TCP embedded broker until
    ``stop`` sets the stop key; the summary lands under ``log_dir``."""
    srv = tredis.BrokerServer(tredis.EmbeddedBroker())
    config = tmp_path / "config.yaml"
    config.write_text(
        "model:\n"
        f"  builder: {__name__}:cli_builder\n"
        "data:\n"
        f"  src: {srv.url}\n"
        "params:\n"
        "  batch_size: 2\n"
        "  top_n: 2\n"
        "  input_shape: 16\n"
        f"  log_dir: {tmp_path / 'logs'}\n")
    rc = []
    t = threading.Thread(target=lambda: rc.append(
        cli.main(["start", "--config", str(config)])))
    t.start()
    try:
        inq = tclient.InputQueue(srv.url)
        outq = tclient.OutputQueue(srv.url)
        tokens = np.random.RandomState(4).randint(0, 50, size=(3, 16))
        for i, rec in enumerate(tokens):
            inq.enqueue(f"c{i}", rec)
        results = [outq.query(f"c{i}", timeout_s=WAIT_S) for i in range(3)]
        assert cli.main(["stop", "--config", str(config)]) == 0
        t.join(WAIT_S)
        assert not t.is_alive() and rc == [0]
    finally:
        if t.is_alive():                     # a failed check above
            cli.main(["stop", "--config", str(config)])
            t.join(WAIT_S)
        srv.stop()
    for res in results:
        assert res is not None and len(res) == 2
        assert {c for c, _ in res} <= {0, 1, 2}
        assert 0.0 < sum(p for _, p in res) <= 1.0 + 1e-6
    assert (tmp_path / "logs" / "serving" / "inference"
            / "events.jsonl").exists()


def test_cli_refuses_checkpoint_weights_naming_roadmap(tmp_path):
    """``model: weights:`` that cannot be read raises: the CLI never
    serves random weights in their place."""
    with pytest.raises(FileNotFoundError):
        cli._build_model(f"{__name__}:cli_builder",
                         weights=str(tmp_path / "model.ckpt"))
    with pytest.raises(SystemExit):
        cli._build_model("no_colon_here")
