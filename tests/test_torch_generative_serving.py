"""PyTorch port, generative serving: the decode-slot scheduler
(``serving/engine/decode.py``) behind ``ServingEngine``, the Redis
transport and the HTTP ``/generate`` route, held to the JAX package's
contracts (``tests/test_generative_serving.py``) on the CPU.

* The slot pool: admit/retire/backfill with the EOS-freed slot reused the
  SAME scheduler iteration, per-request token budgets, streaming order, a
  failed prefill consuming exactly its batch, the abandoned sweep, a
  failed iteration failing the active sequences while the pool recovers,
  and ``warm`` leaving the pool at rest at every bucket (the reference's
  zero-recompile and cache warm-start cases test XLA compilation, which
  the port has not).
* Redis transport: a worker dying mid-decode leaves its group un-acked
  for a peer to reclaim, every sequence exactly once; ``max_tokens``
  rides the stream.
* HTTP: chunked per-token ``/generate`` with ``ServingHttpClient.generate``
  and its status contract; a client that hangs up frees its slot.
* Cross-package: a ``Seq2seq`` on the same weights served by both
  packages' engines gives the same tokens, and those are ``infer``'s row
  cut at the budget and the first stop token.
"""

import json
import threading
import time

import numpy as np
import pytest
import torch

import jax

from analytics_zoo_tpu.models.seq2seq import Seq2seq as JSeq2seq
from analytics_zoo_tpu.pipeline.api.keras.engine import Layer as JLayer
from analytics_zoo_tpu.serving.engine import (
    Request as JRequest, ServingEngine as JServingEngine)

from analytics_zoo_torch.common import config as tconfig
from analytics_zoo_torch.common import zoo_context as tctx
from analytics_zoo_torch.interop import load_jax_variables
from analytics_zoo_torch.models.seq2seq import Seq2seq
from analytics_zoo_torch.observability import get_registry, reset_registry
from analytics_zoo_torch.ops import dtypes as tdtypes
from analytics_zoo_torch.pipeline.api.keras.engine import Layer as TLayer
from analytics_zoo_torch.serving.client import (
    InputQueue, OutputQueue, ServingHttpClient, ServingHttpError)
from analytics_zoo_torch.serving.engine import (
    DecodeSlotPool, GenerativeEndpoint, Request, ServingEngine)
from analytics_zoo_torch.serving.engine.transport import HttpTransport
from analytics_zoo_torch.serving.redis_client import EmbeddedBroker
from analytics_zoo_torch.serving.server import ClusterServing, ServingConfig

START, STOP = 0, 9


@pytest.fixture(autouse=True)
def _port_cpu():
    tctx.reset_zoo_context()
    tconfig.reset_config()
    reset_registry()
    tctx.init_zoo_context(device="cpu")
    yield
    tdtypes.restore_policy(None)
    tctx.reset_zoo_context()
    tconfig.reset_config()


class CountdownModel:
    """Deterministic generative duck model (the Seq2seq decode contract
    in torch): a sequence whose first encoder token is ``s`` emits
    ``s, s+1, ..., STOP`` — per-request lengths set by the input."""

    def decode_params(self):
        return {"w": torch.zeros(())}

    def prefill(self, params, enc_ids):
        h = torch.zeros((enc_ids.shape[0], 4), dtype=torch.float32)
        h[:, 0] = enc_ids[:, 0].to(torch.float32)
        return ((h, h * 0.0),)

    def decode_step(self, params, tok, carries):
        (h, c), = carries
        first = h[:, 0].to(torch.int32)
        nxt = torch.where(tok == START, first, tok + 1)
        return nxt, ((h, c),)

    def initial_carries(self, batch):
        z = torch.zeros((batch, 4), dtype=torch.float32)
        return ((z, z),)


def _expected(first_tok: int):
    return list(range(first_tok, STOP + 1))


def _gen_engine(slots=4, max_seq_len=16, **kw):
    eng = ServingEngine(**kw)
    ep = eng.register_generative(
        "gen", CountdownModel(), enc_len=3, start_sign=START,
        stop_sign=STOP, max_seq_len=max_seq_len, slots=slots)
    eng.start()
    return eng, ep


def _req(first_tok, uri=None, **kw):
    return Request(endpoint="gen", uri=uri or f"u{first_tok}",
                   data=np.array([first_tok, 0, 0], np.int32), **kw)


class Stateless:
    def predict(self, x, batch_size=None):
        return np.zeros((len(x), 4), np.float32)


# ==================================================== slot pool
class TestDecodeSlotPool:
    def test_admit_retire_backfill_and_results(self):
        """8 mixed-length sequences through a 4-slot pool: every result
        correct, and at least one EOS-freed slot is reused by a
        backfilled sequence in the SAME scheduler iteration."""
        eng, ep = _gen_engine(slots=4)
        try:
            firsts = [5, 6, 7, 8, 5, 6, 7, 8]
            reqs = [_req(f, uri=f"u{i}") for i, f in enumerate(firsts)]
            eng.submit_wait(reqs, timeout_s=60)
            for r, f in zip(reqs, firsts):
                assert r.error is None, (r.uri, r.error)
                assert r.result == _expected(f), (r.uri, r.result)
            retired = set(ep.pool.retire_log)
            assert any(entry in retired
                       for entry in ep.pool.admit_log), (
                ep.pool.admit_log, ep.pool.retire_log)
            assert ep.pool.active_count == 0
            assert ep.pool.admitted_total == 8
            reg = get_registry()
            assert reg.counter("serving_tokens_total", "",
                               labels=("endpoint",)).labels("gen").value \
                == sum(len(_expected(f)) for f in firsts)
            assert reg.counter("serving_decode_retired_total", "",
                               labels=("endpoint", "cause")
                               ).labels("gen", "eos").value == 8
        finally:
            eng.stop()

    def test_iteration_scheduling_beats_whole_sequence_step_count(self):
        """On mixed-length traffic the scheduler executes >= 2x fewer
        decode steps than whole-sequence decode (max_seq_len a batch)."""
        max_len = 16
        eng, ep = _gen_engine(slots=4, max_seq_len=max_len)
        try:
            firsts = [8, 7, 6, 5] * 3
            reqs = [_req(f, uri=f"m{i}") for i, f in enumerate(firsts)]
            eng.submit_wait(reqs, timeout_s=60)
            assert all(r.error is None for r in reqs)
            naive_steps = (len(firsts) // 4) * max_len
            assert ep.pool.iterations * 2 <= naive_steps, (
                ep.pool.iterations, naive_steps)
        finally:
            eng.stop()

    def test_per_request_max_tokens(self):
        eng, ep = _gen_engine(slots=2)
        try:
            capped = _req(3, uri="capped", max_tokens=2)
            free = _req(8, uri="free")
            eng.submit_wait([capped, free], timeout_s=60)
            assert capped.result == [3, 4]          # budget cut
            assert free.result == _expected(8)      # EOS cut
        finally:
            eng.stop()

    def test_generative_request_breaks_stateless_fill_wait(self):
        """A sequence arriving while a stateless peer holds the idle-edge
        fill-wait does not sit behind the 10 s co-rider timer."""
        eng = ServingEngine(max_wait_ms=10_000)
        eng.register("plain", Stateless(), batch_size=4)
        eng.register_generative(
            "gen", CountdownModel(), enc_len=3, start_sign=START,
            stop_sign=STOP, max_seq_len=16, slots=4)
        eng.start()
        try:
            plain = Request(endpoint="plain", uri="p",
                            data=np.zeros(3, np.float32))
            eng.submit([plain])          # enters the idle-edge wait
            time.sleep(0.1)
            gen = _req(7, uri="g")
            eng.submit([gen])
            assert gen.wait(5), "first token sat behind the timer"
            assert gen.error is None and gen.result == _expected(7)
            assert plain.wait(5) and plain.error is None
        finally:
            eng.stop()

    def test_streaming_callback_order(self):
        eng, ep = _gen_engine(slots=2)
        try:
            seen = []
            r = _req(6, on_token=lambda i, t: seen.append((i, t)))
            eng.submit_wait([r], timeout_s=60)
            assert r.result == _expected(6)
            assert seen == list(enumerate(_expected(6)))
        finally:
            eng.stop()

    @pytest.mark.parametrize("slots,buckets", [(4, ()), (5, (2,)),
                                               (3, (1, 3))])
    def test_warm_runs_every_bucket_and_leaves_the_pool_at_rest(
            self, slots, buckets):
        """``warm`` runs step and prefill at every bucket of the ladder
        (lanes on the sink row), takes no slot, counts no iteration, and
        leaves every slot's state fresh; traffic after it is served."""
        ep = GenerativeEndpoint(
            "gen", CountdownModel(), enc_len=3, start_sign=START,
            stop_sign=STOP, max_seq_len=16, slots=slots, buckets=buckets)
        pool = ep.pool
        calls = []
        step, prefill = pool._step_fn, pool._prefill_fn

        def spy_step(*args):
            calls.append(("step", args[-1].tolist()))
            return step(*args)

        def spy_prefill(*args):
            calls.append(("prefill", args[-1].tolist()))
            return prefill(*args)

        pool._step_fn, pool._prefill_fn = spy_step, spy_prefill
        n = len(pool.buckets)
        assert ep.warm() == 2 * n
        assert pool.aot_signatures == 2 * n
        assert sorted(len(ids) for _, ids in calls) == \
            sorted(2 * list(pool.buckets))
        assert all(ids == [slots] * len(ids) for _, ids in calls)
        assert pool.iterations == 0 and pool.active_count == 0
        assert pool._free == list(range(slots))
        assert pool.admit_log == [] and pool.retire_log == []
        assert tuple(pool._tokens.shape) == (slots + 1,)
        assert (pool._tokens == START).all()
        assert all(leaf.shape[0] == slots + 1 and not leaf.any()
                   for (h, c) in pool._carries for leaf in (h, c))
        h, c = pool._carries[0]
        assert h.data_ptr() != c.data_ptr()   # aliased carries copied
        reqs = [_req(5 + i % 4, uri=f"w{i}") for i in range(slots)]
        assert pool.admit(reqs) == slots
        while pool.active_count:
            pool.step_once()
        assert [r.result for r in reqs] == \
            [_expected(5 + i % 4) for i in range(slots)]
        assert ep.warm() == 2 * n and pool.aot_signatures == 2 * n

    def test_failed_prefill_consumes_exactly_its_batch(self):
        eng, ep = _gen_engine(slots=2)
        try:
            orig = ep.pool._prefill
            calls = {"n": 0}

            def bomb(*args):
                calls["n"] += 1
                if calls["n"] == 1:
                    raise ValueError("prefill boom")
                return orig(*args)

            ep.pool._prefill = bomb
            bad = _req(5, uri="bad")
            eng.submit_wait([bad], timeout_s=60)
            assert isinstance(bad.error, ValueError)
            good = _req(7, uri="good")
            eng.submit_wait([good], timeout_s=60)
            assert good.error is None and good.result == _expected(7)
            assert len(ep.pool._free) == 2      # no leaked slots
        finally:
            eng.stop()

    def test_abandoned_request_swept_without_decoding(self):
        ep = GenerativeEndpoint(
            "gen", CountdownModel(), enc_len=3, start_sign=START,
            stop_sign=STOP, max_seq_len=16, slots=2)
        gone, live = _req(3, uri="gone"), _req(8, uri="live")
        ep.pool.admit([gone, live])
        gone.fail(TimeoutError("client gave up"))
        while ep.pool.active_count:
            assert ep.pool.step_once() <= 1   # only 'live' decodes
        assert live.result == _expected(8)
        assert gone.result is None            # never decoded
        assert len(ep.pool._free) == 2

    def test_failed_iteration_fails_active_and_pool_recovers(self):
        eng, ep = _gen_engine(slots=2)
        try:
            orig = ep.pool._step
            calls = {"n": 0}

            def bomb(*args):
                calls["n"] += 1
                if calls["n"] == 1:
                    raise ValueError("decode boom")
                return orig(*args)

            ep.pool._step = bomb
            bad = [_req(5, uri="bad-0"), _req(6, uri="bad-1")]
            eng.submit_wait(bad, timeout_s=60)
            for r in bad:
                assert isinstance(r.error, ValueError), r.error
            assert ep.pool.active_count == 0
            good = _req(7, uri="good")
            eng.submit_wait([good], timeout_s=60)
            assert good.error is None
            assert good.result == _expected(7)
        finally:
            eng.stop()

    def test_pool_lives_on_the_model_device_with_a_sink_row(self):
        pool = DecodeSlotPool(
            CountdownModel(), capacity=3, enc_len=3, start_sign=START,
            stop_sign=STOP, max_seq_len=8)
        assert pool.device.type == "cpu"
        assert pool.buckets == (1, 2, 3)
        ids = pool._pad_ids([0, 2], 3)
        assert ids.dtype == torch.int64 and ids.tolist() == [0, 2, 3]


# ================================== Redis transport: exactly-once
class _SimulatedReplicaDeath(BaseException):
    """Escapes ``except Exception`` the way a process kill escapes the
    worker: the batch stays un-acked in the PEL."""


class TestGenerativeRedisExactlyOnce:
    def test_mid_decode_kill_reclaimed_exactly_once(self):
        broker = EmbeddedBroker()
        w1 = ClusterServing(
            None,
            ServingConfig(batch_size=4, consumer_group="serve",
                          consumer_name="w1"),
            broker=broker)
        ep1 = w1.register_generative_endpoint(
            "gen", CountdownModel(), enc_len=3, start_sign=START,
            stop_sign=STOP, max_seq_len=16)
        orig = ep1.pool._step
        calls = {"n": 0}

        def dies(*args):
            calls["n"] += 1
            if calls["n"] == 1:
                raise _SimulatedReplicaDeath("killed mid-decode")
            return orig(*args)

        ep1.pool._step = dies
        inq = InputQueue(broker=broker)
        firsts = [5, 6, 7, 8]
        for i, f in enumerate(firsts):
            inq.enqueue(f"g{i}", np.array([f, 0, 0], np.int32),
                        endpoint="gen")

        def _run_until_death():
            try:
                w1.run(poll_ms=5)
            except _SimulatedReplicaDeath:
                pass
        t = threading.Thread(target=_run_until_death)
        t.start()
        t.join(timeout=30)
        assert not t.is_alive()
        pend = broker._groups[("serving_stream", "serve")]["pending"]
        assert len(pend) == 4        # un-acked, not lost

        w2 = ClusterServing(
            None,
            ServingConfig(batch_size=4, consumer_group="serve",
                          consumer_name="w2",
                          reclaim_min_idle_ms=0),
            broker=broker)
        w2.register_generative_endpoint(
            "gen", CountdownModel(), enc_len=3, start_sign=START,
            stop_sign=STOP, max_seq_len=16)
        try:
            deadline = time.time() + 30
            while (w1.total_records + w2.total_records) < 4 \
                    and time.time() < deadline:
                if w2.run_once(block_ms=10) == 0:
                    w2._reclaim_stale(min_idle_ms=0)
            outq = OutputQueue(broker=broker)
            for i, f in enumerate(firsts):
                res = outq.query(f"g{i}")
                assert res == _expected(f), (i, res)
            assert w1.total_records + w2.total_records == 4
            assert not broker._groups[("serving_stream",
                                       "serve")]["pending"]
        finally:
            w2.close()
            w1.close()

    def test_max_tokens_field_rides_the_stream(self):
        broker = EmbeddedBroker()
        s = ClusterServing(None, ServingConfig(batch_size=4),
                           broker=broker)
        ep = s.register_generative_endpoint(
            "gen", CountdownModel(), enc_len=3, start_sign=START,
            stop_sign=STOP, max_seq_len=16)
        assert ep.pool.capacity == 4       # slots default to batch_size
        try:
            inq = InputQueue(broker=broker)
            inq.enqueue("capped", np.array([3, 0, 0], np.int32),
                        endpoint="gen", max_tokens=2)
            inq.enqueue("full", np.array([8, 0, 0], np.int32),
                        endpoint="gen")
            served = 0
            deadline = time.time() + 30
            while served < 2 and time.time() < deadline:
                served += s.run_once(block_ms=10)
            outq = OutputQueue(broker=broker)
            assert outq.query("capped") == [3, 4]
            assert outq.query("full") == _expected(8)
        finally:
            s.close()


# ======================================= HTTP streaming fast path
class TestGenerativeHttpStreaming:
    def _serving(self):
        eng, ep = _gen_engine(slots=4)
        eng.register("plain", Stateless(), batch_size=2)
        tr = HttpTransport(eng, port=0).start()
        return eng, ep, tr

    def test_streams_tokens_then_done(self):
        eng, ep, tr = self._serving()
        try:
            client = ServingHttpClient(f"http://127.0.0.1:{tr.port}")
            seen = []
            doc = client.generate(
                "gen", [6, 0, 0],
                on_token=lambda i, t: seen.append((i, t)))
            assert doc["tokens"] == _expected(6)
            assert seen == list(enumerate(_expected(6)))
            assert doc["endpoint"] == "gen" and doc["request_id"]
            capped = client.generate("gen", [3, 0, 0], max_tokens=3)
            assert capped["tokens"] == [3, 4, 5]
        finally:
            tr.stop()
            eng.stop()

    def test_status_contract(self):
        eng, ep, tr = self._serving()
        try:
            client = ServingHttpClient(f"http://127.0.0.1:{tr.port}")
            with pytest.raises(ServingHttpError) as ei:
                client.generate("nope", [1, 2, 3])
            assert ei.value.status == 404
            # generate against a stateless endpoint is a 400, with a
            # pointer at the right route
            with pytest.raises(ServingHttpError) as ei:
                client.generate("plain", [1, 2, 3])
            assert ei.value.status == 400
            assert "/predict/plain" in str(ei.value)
            eps = client.endpoints()
            assert eps["gen"]["generative"] is True
            assert eps["gen"]["slots"] == 4
            assert "generative" not in eps["plain"]
        finally:
            tr.stop()
            eng.stop()

    def test_client_disconnect_mid_stream_frees_slot(self):
        """A client hanging up mid-stream fails its request, so the
        abandoned sweep retires the slot instead of decoding to
        max_seq_len for nobody."""
        eng, ep = _gen_engine(slots=2, max_seq_len=10_000)
        tr = HttpTransport(eng, port=0)    # no socket: direct handler

        class DropsAfterFirstToken:
            def _respond(self, code, doc):
                raise AssertionError(f"unexpected status {code}")

            def start_stream(self, code=200):
                pass

            def stream_line(self, doc):
                if "token" in doc:
                    raise BrokenPipeError("client gone")

            def end_stream(self):
                pass

        try:
            # start token far from STOP: without the sweep this
            # sequence would decode for thousands of iterations
            body = json.dumps(
                {"data": [100, 0, 0], "dtype": "int32"}).encode()
            tr.handle_generate("gen", body, DropsAfterFirstToken())
            deadline = time.monotonic() + 10
            while ep.pool.active_count and time.monotonic() < deadline:
                time.sleep(0.02)
            assert ep.pool.active_count == 0, \
                "disconnected stream still holds its slot"
            assert len(ep.pool._free) == 2
        finally:
            eng.stop()

    def test_connection_retries_are_bounded(self):
        from urllib.error import URLError
        client = ServingHttpClient("http://127.0.0.1:9", retries=2)
        t0 = time.monotonic()
        with pytest.raises((URLError, OSError)):
            client.generate("gen", [1, 2, 3], timeout_s=0.5)
        assert time.monotonic() - t0 < 30.0


# ============================ cross-package: Seq2seq on shared weights
def _seq2seq_pair():
    cfg = dict(vocab_size=24, embed_dim=8, hidden_sizes=(12,))
    JLayer.reset_name_counters()
    jm = JSeq2seq(**cfg)
    jm.init(jax.random.PRNGKey(0))
    rs = np.random.RandomState(11)
    jm.set_variables(jax.tree_util.tree_map(
        lambda a: jax.numpy.asarray(
            rs.randn(*a.shape).astype(np.float32) * 0.5),
        jm.get_variables()))
    TLayer.reset_name_counters()
    tm = Seq2seq(**cfg)
    load_jax_variables(tm, jax.tree_util.tree_map(np.asarray,
                                                  jm.get_variables()))
    return jm, tm


def test_both_engines_serve_the_same_tokens_as_infer(f32_policy):
    """12 requests with mixed budgets through a 4-slot pool in each
    package: equal tokens, and each is ``infer``'s row cut at its budget
    and its first stop token."""
    tdtypes.set_policy(param_dtype="float32", compute_dtype="float32")
    jm, tm = _seq2seq_pair()
    enc = np.random.RandomState(3).randint(3, 24, (12, 5)).astype(np.int32)
    budgets = [3, 8, 5, 12, 2, 12, 7, 4, 12, 6, 1, 9]
    start, max_len = 1, 12
    rows = tm.infer(enc, start_sign=start, max_seq_len=max_len)
    np.testing.assert_array_equal(
        rows, jm.infer(enc, start_sign=start, max_seq_len=max_len))
    stop = int(rows[0, 1])          # reached by some rows, not all
    results = {}
    for pkg, model, engine_cls, req_cls in (
            ("jax", jm, JServingEngine, JRequest),
            ("torch", tm, ServingEngine, Request)):
        eng = engine_cls()
        eng.register_generative("chat", model, enc_len=5,
                                start_sign=start, stop_sign=stop,
                                max_seq_len=max_len, slots=4)
        try:
            reqs = [req_cls(endpoint="chat", uri=f"r{i}", data=enc[i],
                            max_tokens=budgets[i]) for i in range(12)]
            eng.submit_wait(reqs, timeout_s=120)
            assert all(r.error is None for r in reqs), pkg
            results[pkg] = [r.result for r in reqs]
        finally:
            eng.stop()
    assert results["torch"] == results["jax"]
    for i, got in enumerate(results["torch"]):
        want = list(rows[i, :budgets[i]])
        if stop in want:
            want = want[:want.index(stop) + 1]
        assert got == want, (i, got, want)
    assert any(r[-1] == stop for r in results["torch"])
