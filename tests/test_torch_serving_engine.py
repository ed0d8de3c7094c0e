"""PyTorch port, Cluster Serving's engine held to the contracts of
``tests/test_serving_engine.py`` and ``tests/test_serving_resilience.py``:
bucket ladders, continuous batching, weighted round-robin, failure
isolation, exactly-once consumer groups with reclaim after a mid-batch
kill, dead-lettering and the circuit breaker, with duck-typed models.

Where a scenario is deterministic, the same script runs through both
packages' ``ServingEngine`` and the recorded dispatch sequences (padded
batch lengths, endpoint order) must be equal.  The part not ported yet
(image records) must fail explicitly; generative serving has its own file,
``test_torch_generative_serving.py``."""

import json
import threading
import time
import types

import numpy as np
import pytest

import analytics_zoo_tpu.serving.engine as jengine
import analytics_zoo_tpu.serving.engine.executor as jexecutor

import analytics_zoo_torch.serving.engine as tengine
import analytics_zoo_torch.serving.engine.executor as texecutor
from analytics_zoo_torch.observability import (
    get_registry, reset_flightrec, reset_registry, reset_request_log,
    reset_tracer)
from analytics_zoo_torch.resilience.chaos import (
    SITE_SERVING_REDIS, ChaosPlan, FaultSpec, clear_chaos, install_chaos)
from analytics_zoo_torch.serving.client import (
    InputQueue, OutputQueue, ServingHttpClient, ServingHttpError)
from analytics_zoo_torch.serving.engine.transport import HttpTransport
from analytics_zoo_torch.serving.redis_client import (
    BREAKER_CLOSED, BREAKER_OPEN, BreakerClient, CircuitBreaker,
    CircuitOpenError, EmbeddedBroker)
from analytics_zoo_torch.serving.server import (
    DEAD_LETTER_STREAM, ClusterServing, ServingConfig)

WAIT_S = 10.0          # bound on every wait; each test ends far inside it

PACKAGES = {
    "jax": types.SimpleNamespace(engine=jengine, executor=jexecutor),
    "torch": types.SimpleNamespace(engine=tengine, executor=texecutor),
}


@pytest.fixture(autouse=True)
def _fresh_port_singletons():
    """The repo conftest resets only the JAX package's globals; the
    port's registry, tracer, request log, flight recorder and chaos plan
    are its own."""
    def reset():
        reset_registry()
        reset_tracer()
        reset_request_log()
        reset_flightrec()
        clear_chaos()
    reset()
    yield
    reset()


def _req(ns, uri="u", endpoint="default", shape=(3,)):
    return ns.engine.Request(endpoint=endpoint, uri=uri,
                             data=np.zeros(shape, np.float32))


class GateModel:
    """Duck-typed model whose predict can be held closed — the
    executor-busy window every batcher test scripts against."""

    def __init__(self, classes=4):
        self.classes = classes
        self.gate = threading.Event()
        self.gate.set()
        self.entered = threading.Event()
        self.calls = []          # padded batch length per call

    def predict(self, x, batch_size=None):
        self.entered.set()
        assert self.gate.wait(WAIT_S), "gate never opened"
        self.calls.append(len(x))
        return np.tile(np.arange(self.classes, dtype=np.float32),
                       (len(x), 1))


def _engine(ns, model, max_wait_ms, batch_size=4):
    eng = ns.engine.ServingEngine(max_wait_ms=max_wait_ms)
    eng.register("default", model, top_n=1, batch_size=batch_size)
    eng.start()
    return eng


def _done(requests):
    for r in requests:
        assert r.wait(WAIT_S), f"{r.uri} never completed"
        assert r.error is None, (r.uri, r.error)


# --------------------------------------------------- deterministic scripts
def _partial_bucket_on_free(ns):
    """Requests that arrive WHILE the executor is busy are dispatched as
    a partial bucket the moment it frees, although batch_max_wait_ms is
    10 s: the bounded waits below are far shorter."""
    model = GateModel()
    eng = _engine(ns, model, max_wait_ms=10_000)
    try:
        model.gate.clear()
        first = [_req(ns, f"a{i}") for i in range(4)]
        eng.submit(first)                    # a full bucket: no fill wait
        assert model.entered.wait(WAIT_S)
        r1, r2 = _req(ns, "b0"), _req(ns, "b1")
        eng.submit([r1])
        eng.submit([r2])
        assert not r1.done and not r2.done
        model.gate.set()
        _done([r1, r2] + first)
        return model.calls
    finally:
        eng.stop()


def _lone_request_within_max_wait(ns):
    model = GateModel()
    eng = _engine(ns, model, max_wait_ms=100)
    try:
        result = eng.predict("default", np.zeros(3, np.float32),
                             timeout_s=WAIT_S)
        assert result and result[0][0] in range(4)
        return model.calls                   # the smallest bucket
    finally:
        eng.stop()


def _max_wait_zero(ns):
    model = GateModel()
    eng = _engine(ns, model, max_wait_ms=0)
    try:
        r = _req(ns)
        eng.submit([r])
        _done([r])
        return model.calls
    finally:
        eng.stop()


def _fill_wait_ends_on_full_bucket(ns):
    model = GateModel()
    eng = _engine(ns, model, max_wait_ms=10_000)
    try:
        reqs = [_req(ns, f"c{i}") for i in range(4)]
        for r in reqs:
            eng.submit([r])
        _done(reqs)                          # ≪ 10 s: ended on full
        return model.calls
    finally:
        eng.stop()


def _weighted_round_robin(ns):
    order = []
    gate = threading.Event()

    class NamedModel:
        def __init__(self, name):
            self.name = name

        def predict(self, x, batch_size=None):
            assert gate.wait(WAIT_S)
            order.append(self.name)
            return np.zeros((len(x), 4), np.float32)

    eng = ns.engine.ServingEngine(max_wait_ms=0)
    eng.register("a", NamedModel("a"), weight=2, batch_size=4)
    eng.register("b", NamedModel("b"), weight=1, batch_size=4)
    eng.start()
    try:
        # the first group executes (held on the gate) while full-bucket
        # groups pile up on both endpoints
        groups = [[_req(ns, f"a{g}-{i}", endpoint="a") for i in range(4)]
                  for g in range(5)]
        eng.submit(groups[0])
        for g in groups[1:]:
            eng.submit(g)
        bgroups = [[_req(ns, f"b{g}-{i}", endpoint="b") for i in range(4)]
                   for g in range(2)]
        for g in bgroups:
            eng.submit(g)
        gate.set()
        _done([r for g in groups + bgroups for r in g])
        return order
    finally:
        eng.stop()


def _mismatched_shapes(ns):
    """Two groups whose records cannot np.stack together each ride
    their own batch, and both succeed."""
    model = GateModel()
    eng = _engine(ns, model, max_wait_ms=0)
    try:
        model.gate.clear()
        blocker = [_req(ns, "x0")]
        eng.submit(blocker)
        assert model.entered.wait(WAIT_S)
        g1 = [_req(ns, f"s3-{i}", shape=(3,)) for i in range(2)]
        g2 = [_req(ns, f"s5-{i}", shape=(5,)) for i in range(2)]
        eng.submit(g1)
        eng.submit(g2)
        model.gate.set()
        _done(blocker + g1 + g2)
        return model.calls
    finally:
        eng.stop()


SCRIPTS = {
    "partial_bucket_on_free": (_partial_bucket_on_free, [4, 2]),
    "lone_request_within_max_wait": (_lone_request_within_max_wait, [1]),
    "max_wait_zero": (_max_wait_zero, [1]),
    "fill_wait_ends_on_full_bucket": (_fill_wait_ends_on_full_bucket, [4]),
    "weighted_round_robin": (_weighted_round_robin,
                             ["a", "a", "b", "a", "a", "b", "a"]),
    "mismatched_shapes": (_mismatched_shapes, [1, 2, 2]),
}


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_dispatch_sequence_matches_reference(name):
    script, want = SCRIPTS[name]
    got = script(PACKAGES["torch"])
    assert got == want
    assert script(PACKAGES["jax"]) == got


# ------------------------------------------------------------- buckets
@pytest.mark.parametrize("batch_size", [1, 4, 6, 8, 32])
def test_default_ladder_matches_reference(batch_size):
    got = texecutor.default_buckets(batch_size)
    assert got == jexecutor.default_buckets(batch_size)
    assert got[-1] == batch_size and list(got) == sorted(set(got))
    assert texecutor.default_buckets(32) == (1, 2, 4, 8, 16, 32)


@pytest.mark.parametrize("spec,batch_size,want", [
    ("1,4,16", 16, (1, 4, 16)),
    ("1,4,64", 16, (1, 4, 16)),        # capped; batch_size always present
    (None, 8, (1, 2, 4, 8)),
    ([2, 2, 8], 8, (2, 8)),
    ("1,2,4,8", 8, (1, 2, 4, 8)),
])
def test_parse_buckets_matches_reference(spec, batch_size, want):
    assert texecutor.parse_buckets(spec, batch_size) == want
    assert jexecutor.parse_buckets(spec, batch_size) == want


# ---------------------------------------------------- failure isolation
def test_unknown_endpoint_fails_fast():
    eng = tengine.ServingEngine()
    eng.register("default", GateModel())
    eng.start()
    try:
        with pytest.raises(KeyError, match="unknown serving"):
            eng.predict("nope", np.zeros(3, np.float32), timeout_s=5)
    finally:
        eng.stop()


def test_model_error_fails_exactly_its_own_batch():
    class FlakyModel(GateModel):
        def predict(self, x, batch_size=None):
            if len(x) == 2:          # the poisoned group's bucket
                raise ValueError("boom")
            return super().predict(x, batch_size)

    ns = PACKAGES["torch"]
    model = FlakyModel()
    eng = _engine(ns, model, max_wait_ms=0)
    try:
        model.gate.clear()
        blocker = [_req(ns, "x0")]
        eng.submit(blocker)
        assert model.entered.wait(WAIT_S)
        bad = [_req(ns, f"bad-{i}", shape=(3,)) for i in range(2)]
        good = [_req(ns, f"good-{i}", shape=(5,)) for i in range(4)]
        eng.submit(bad)
        eng.submit(good)
        model.gate.set()
        for r in bad:
            assert r.wait(WAIT_S)
            assert isinstance(r.error, ValueError)
        _done(blocker + good)
        assert eng.alive                     # the batcher survived
    finally:
        eng.stop()


# -------------------------------------- exactly-once, reclaim after a kill
class ArgmaxLastModel:
    """Routing witness: top-1 class is always 3."""

    def predict(self, x, batch_size=None):
        return np.tile(np.arange(4, dtype=np.float32), (len(x), 1))


class ArgmaxFirstModel:
    """Routing witness: top-1 class is always 0."""

    def predict(self, x, batch_size=None):
        return np.tile(np.arange(4, 0, -1, dtype=np.float32), (len(x), 1))


class _SimulatedReplicaDeath(BaseException):
    """Escapes ``except Exception`` the way a process kill escapes the
    worker: the batch stays un-acked in the pending list."""


def test_exactly_once_with_reclaim_after_a_mid_batch_kill():
    """Two endpoints on one consumer group: the first worker dies
    mid-batch, a peer reclaims its pending entries, and every record gets
    exactly one correctly-routed result; then the peer's HTTP fast path
    serves both endpoints and answers 404 for an unknown one."""
    broker = EmbeddedBroker()

    class DiesOnFirstBatch(ArgmaxLastModel):
        calls = 0

        def predict(self, x, batch_size=None):
            DiesOnFirstBatch.calls += 1
            if DiesOnFirstBatch.calls == 1:
                raise _SimulatedReplicaDeath("killed mid-batch")
            return super().predict(x, batch_size)

    w1 = ClusterServing(
        DiesOnFirstBatch(),
        ServingConfig(batch_size=4, top_n=1, consumer_group="serve",
                      consumer_name="w1"),
        broker=broker)
    w1.register_endpoint("beta", ArgmaxFirstModel())
    inq = InputQueue(broker=broker)
    for i in range(4):
        inq.enqueue(f"alpha-{i}", np.zeros(3, np.float32))
    for i in range(4):
        inq.enqueue(f"beta-{i}", np.zeros(3, np.float32), endpoint="beta")

    def run_until_death():
        try:
            w1.run(poll_ms=5)
        except _SimulatedReplicaDeath:
            pass

    t = threading.Thread(target=run_until_death)
    t.start()
    t.join(timeout=30)
    assert not t.is_alive()
    pending = broker._groups[("serving_stream", "serve")]["pending"]
    assert len(pending) >= 4                 # un-acked, not lost

    w2 = ClusterServing(
        ArgmaxLastModel(),
        ServingConfig(batch_size=4, top_n=1, consumer_group="serve",
                      consumer_name="w2", reclaim_min_idle_ms=0,
                      http_port=0, metrics_host="127.0.0.1"),
        broker=broker)
    w2.register_endpoint("beta", ArgmaxFirstModel())
    try:
        deadline = time.time() + 30
        while w1.total_records + w2.total_records < 8 \
                and time.time() < deadline:
            if w2.run_once(block_ms=10) == 0:
                w2._reclaim_stale(min_idle_ms=0)
        outq = OutputQueue(broker=broker)
        for i in range(4):
            assert outq.query(f"alpha-{i}")[0][0] == 3
            assert outq.query(f"beta-{i}")[0][0] == 0
        assert w1.total_records + w2.total_records == 8
        assert not broker._groups[("serving_stream", "serve")]["pending"]

        http = ServingHttpClient(f"http://127.0.0.1:{w2.http_transport.port}")
        assert http.predict_http("default",
                                 np.zeros(3, np.float32))["value"][0][0] == 3
        assert http.predict_http("beta",
                                 np.zeros(3, np.float32))["value"][0][0] == 0
        assert set(http.endpoints()) == {"default", "beta"}
        with pytest.raises(ServingHttpError) as ei:
            http.predict_http("gamma", np.zeros(3, np.float32))
        assert ei.value.status == 404
        fam = get_registry().counter(
            "serving_endpoint_requests_total",
            "requests submitted per serving endpoint", labels=("endpoint",))
        assert fam.labels("default").value >= 5
        assert fam.labels("beta").value >= 5
    finally:
        w2.close()
        w1.close()


# -------------------------------------------------------- HTTP transport
def test_http_bad_payload_unknown_endpoint_and_timeout_statuses():
    eng = tengine.ServingEngine()
    model = GateModel()
    eng.register("default", model)
    eng.start()
    tr = HttpTransport(eng, port=0, timeout_s=0.3)
    try:
        assert tr.handle_predict("default", b"not json")[0] == 400
        assert tr.handle_predict("default", b'{"x": 1}')[0] == 400
        code, doc = tr.handle_predict("nope", b'{"data": [1.0]}')
        assert code == 404 and doc["endpoints"] == ["default"]
        model.gate.clear()                   # wedge the executor
        code, _ = tr.handle_predict("default", b'{"data": [1.0, 2.0, 3.0]}')
        assert code == 504
    finally:
        model.gate.set()
        tr.stop()
        eng.stop()


def test_http_client_connection_retries_are_bounded():
    from urllib.error import URLError
    client = ServingHttpClient("http://127.0.0.1:9", retries=2)
    t0 = time.monotonic()
    with pytest.raises((URLError, OSError)):
        client.predict_http("default", [1.0, 2.0], timeout_s=0.5)
    assert time.monotonic() - t0 < 30.0


# ---------------------------------------------------------- dead letters
def _dead_letters(broker):
    return [{k: v.decode() if isinstance(v, bytes) else v
             for k, v in fields.items()}
            for _id, fields in broker.xread(DEAD_LETTER_STREAM, "0-0",
                                            count=1000)]


def _dead_letter_family():
    return get_registry().counter(
        "serving_dead_letter_total",
        "records written to the serving_dead_letter stream, by reason",
        labels=("reason",))


def test_dead_letter_entry_fields_and_reason_counter():
    broker = EmbeddedBroker()
    s = ClusterServing(ArgmaxLastModel(), ServingConfig(batch_size=2),
                       broker=broker)
    try:
        assert s.dead_letter(
            "shed", uri="u1", request_id="r1", cause="deadline",
            error=TimeoutError("too old"), extra={"age_ms": "512"}) is True
        [fields] = _dead_letters(broker)
        assert fields["reason"] == "shed" and fields["uri"] == "u1"
        assert fields["request_id"] == "r1"
        assert fields["cause"] == "deadline" and fields["age_ms"] == "512"
        assert "TimeoutError" in fields["error"]
        assert _dead_letter_family().labels("shed").value == 1
    finally:
        s.close()


def test_dead_letter_broker_failure_is_absorbed():
    class DeadBroker(EmbeddedBroker):
        def xadd(self, stream, fields):
            raise ConnectionError("broker down")

    s = ClusterServing(ArgmaxLastModel(),
                       ServingConfig(batch_size=2, breaker_failures=0),
                       broker=DeadBroker())
    try:
        assert s.dead_letter("poison", uri="u",
                             extra={"deliveries": "3"}) is False
    finally:
        s.close()


def test_dead_letter_all_three_reasons_flow_through_the_helper():
    fam = _dead_letter_family()
    broker = EmbeddedBroker()
    s = ClusterServing(
        ArgmaxLastModel(),
        ServingConfig(batch_size=2, consumer_group="serve",
                      request_deadline_ms=50, result_write_retries=1),
        broker=broker)
    try:
        old_id = f"{int(time.time() * 1000) - 60_000}-1"
        assert s._shed_expired([(old_id, {"uri": b"old-1"})]) == []
        s._quarantine("1-1", {"uri": b"p-1"}, deliveries=2)
        orig = broker.hset
        broker.hset = lambda *a, **k: (_ for _ in ()).throw(
            ConnectionError("down"))
        assert s._write_result("w-1", "[]", retries=1) is False
        broker.hset = orig
        for reason in ("shed", "poison", "write_abandoned"):
            assert fam.labels(reason).value == 1, reason
        assert {f["reason"] for f in _dead_letters(broker)} == {
            "shed", "poison", "write_abandoned"}
    finally:
        s.close()


# ------------------------------------------------------ circuit breaker
def test_breaker_state_machine():
    clock = [0.0]
    b = CircuitBreaker(failures=3, cooldown_s=1.0, clock=lambda: clock[0])
    for _ in range(2):
        assert b.allow()
        b.record_failure()
    assert b.state == BREAKER_CLOSED
    b.record_failure()
    assert b.state == BREAKER_OPEN and not b.allow()
    clock[0] = 1.5
    assert b.allow() and not b.allow()       # exactly one half-open probe
    b.record_failure()
    assert b.state == BREAKER_OPEN
    clock[0] = 3.0
    assert b.allow()
    b.record_success()
    assert b.state == BREAKER_CLOSED and b.allow()


def test_breaker_client_fast_fails_without_io_while_broker_down():
    class FlakyConn:
        calls = 0
        broken = True

        def ping(self):
            self.calls += 1
            if self.broken:
                raise ConnectionError("broker down")
            return True

        def close(self):
            pass

    conn = FlakyConn()
    client = BreakerClient(lambda: conn, failures=2, cooldown_s=0.1,
                           conn=conn)
    for _ in range(2):
        with pytest.raises(ConnectionError):
            client.ping()
    calls_at_open = conn.calls
    with pytest.raises(CircuitOpenError):
        client.ping()                        # open: no socket touched
    assert conn.calls == calls_at_open
    time.sleep(0.15)
    conn.broken = False
    assert client.ping() is True             # half-open probe reconnects
    assert client.breaker.state == BREAKER_CLOSED


def test_worker_idles_on_an_open_breaker_and_recovers():
    """Chaos site ``serving.redis`` takes the broker down: the breaker
    opens, the worker stays alive (readiness names the reason), and
    serving resumes once a half-open probe outlives the outage."""
    broker = EmbeddedBroker()
    serving = ClusterServing(
        ArgmaxLastModel(),
        ServingConfig(batch_size=2, breaker_failures=3,
                      breaker_cooldown_s=0.1),
        broker=broker)
    inq, outq = InputQueue(broker=broker), OutputQueue(broker=broker)
    t = threading.Thread(target=serving.run, kwargs={"poll_ms": 5})
    t.start()
    try:
        inq.enqueue("pre-0", np.zeros(3, np.float32))
        assert outq.query("pre-0", timeout_s=WAIT_S) is not None
        install_chaos(ChaosPlan([FaultSpec(
            site=SITE_SERVING_REDIS, at_step=0, kind="raise", times=10,
            message="connection reset by injected outage")]))
        deadline = time.time() + WAIT_S
        while serving.broker.breaker.state != BREAKER_OPEN \
                and time.time() < deadline:
            time.sleep(0.01)
        assert serving.broker.breaker.state == BREAKER_OPEN
        assert t.is_alive()
        assert serving.readiness() == {
            "reason": "breaker_open",
            "cooldown_s": serving.config.breaker_cooldown_s}
        deadline = time.time() + 2 * WAIT_S
        while serving.broker.breaker.state != BREAKER_CLOSED \
                and time.time() < deadline:
            time.sleep(0.02)
        assert serving.broker.breaker.state == BREAKER_CLOSED
        inq.enqueue("post-0", np.zeros(3, np.float32))
        assert outq.query("post-0", timeout_s=WAIT_S) is not None
        assert serving.readiness() is None
    finally:
        serving.stop()
        t.join(timeout=WAIT_S)
    assert not t.is_alive()


# --------------------------------------- what is not ported fails loudly
def test_image_record_gets_the_undecodable_record_path():
    """An ``image`` record that is not a decodable JPEG and a record whose
    ``data`` is not a .npy both get an explicit error result naming the
    decode failure, count as errors, are acked, and leave the dead-letter
    stream empty; the healthy record beside them is served."""
    import base64
    broker = EmbeddedBroker()
    s = ClusterServing(ArgmaxLastModel(),
                       ServingConfig(batch_size=4, consumer_group="g"),
                       broker=broker)
    try:
        broker.xadd("serving_stream", {
            "uri": "img-0", "image": base64.b64encode(b"\xff\xd8jpeg"),
            "request_id": "r-img"})
        broker.xadd("serving_stream", {
            "uri": "bad-0", "data": base64.b64encode(b"not npy"),
            "request_id": "r-bad"})
        InputQueue(broker=broker).enqueue("ok-0", np.zeros(3, np.float32))
        assert s.run_once(block_ms=0) == 1
        outq = OutputQueue(broker=broker)
        img = outq.query_meta("img-0")
        assert "OSError" in img["value"]["error"]
        assert "cannot decode image img-0" in img["value"]["error"]
        assert img["request_id"] == "r-img"
        assert "error" in outq.query("bad-0")
        assert outq.query("ok-0")[0][0] == 3
        errors = get_registry().counter(
            "serving_errors_total",
            "records acked with an error result (decode/poison)")
        assert errors.value == 2
        assert _dead_letters(broker) == []
        assert not broker._groups[("serving_stream", "g")]["pending"]
        raw = broker.hgetall("result:img-0")
        assert json.loads(raw["value"])["error"].startswith("OSError")
    finally:
        s.close()
