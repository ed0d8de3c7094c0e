"""PyTorch port, incident forensics (``observability/incident.py``) against
the JAX package's: the same run dirs diagnosed by both packages give the
same ``incident.json`` (byte-equal after sorting keys, less the time it
was generated), so the two rank the same hypotheses with the same
citations.

The run dirs are the reference's fixtures (``tests/test_incident.py``),
each made twice — once by the JAX package's subsystems and once by the
port's, so each package also diagnoses the other's journals:

- a broker outage: a ``BreakerClient`` under a scripted ``serving.redis``
  fault opens its breaker;
- a poison record: a ``ClusterServing`` replica dies on it twice, the
  third reclaim quarantines it;
- training numerics: an ``Estimator`` halted by the watchdog on a NaN;
- an exhausted restart budget: a ``ServingSupervisor`` whose replicas
  crash writes ``degraded.json`` (ranked first, and, alone, below the
  root-cause threshold in both: a symptom);
- a lost host: the journal events the elastic trainer leaves (the port's
  trainer has no mesh to re-form, so the events are recorded directly).

``render_incident`` gives the same text and ``write_incident`` the same
file."""

import json
import os
import sys
import threading

import numpy as np
import pytest

from analytics_zoo_tpu.observability import flightrec as jflightrec
from analytics_zoo_tpu.observability import incident as jincident

from analytics_zoo_torch.observability import flightrec as tflightrec
from analytics_zoo_torch.observability import incident as tincident

PRODUCERS = ["jax", "torch"]


@pytest.fixture(autouse=True)
def _fresh_forensics():
    from analytics_zoo_tpu.resilience.chaos import clear_chaos as jclear
    from analytics_zoo_torch.resilience.chaos import clear_chaos as tclear
    from analytics_zoo_torch.common import config as tconfig
    from analytics_zoo_torch.common import zoo_context as tctx
    jflightrec.reset_flightrec()
    tflightrec.reset_flightrec()
    jclear()
    tclear()
    tctx.reset_zoo_context()
    tconfig.reset_config()
    tctx.init_zoo_context(device="cpu")
    yield
    jclear()
    tclear()
    jflightrec.reset_flightrec()
    tflightrec.reset_flightrec()
    tctx.reset_zoo_context()
    tconfig.reset_config()


def _host_slot(tmp_path, producer):
    run_dir = str(tmp_path / "run")
    fr = jflightrec if producer == "jax" else tflightrec
    fr.init_flightrec(os.path.join(run_dir, "host-0"), process_index=0,
                      install_hooks=False)
    return run_dir, fr


def _close(fr):
    rec = fr.get_active_flightrec()
    if rec is not None:
        rec.close()


def _same_diagnosis(run_dir, expect_cause, top_cause=None):
    docs = []
    for mod in (jincident, tincident):
        doc = mod.diagnose(run_dir)
        doc.pop("generated_unix")
        docs.append(json.dumps(doc, sort_keys=True))
    assert docs[1] == docs[0]
    doc = json.loads(docs[1])
    assert doc["root_cause"] == expect_cause, doc["hypotheses"]
    top = doc["hypotheses"][0]
    assert top["cause"] == (top_cause or expect_cause)
    assert (top["confidence"] >= tincident.ROOT_CAUSE_THRESHOLD) == \
        (expect_cause is not None)
    assert top["evidence"]
    # the rendering and the file are the same too
    texts = [m.render_incident(json.loads(docs[1]))
             for m in (jincident, tincident)]
    assert texts[1] == texts[0]
    written = []
    for name, mod in (("jax", jincident), ("torch", tincident)):
        out = os.path.join(run_dir, f"incident-{name}.json")
        mod.write_incident(run_dir, out_path=out)
        d = json.load(open(out))
        d.pop("generated_unix")
        written.append(json.dumps(d, sort_keys=True))
    assert written[1] == written[0]
    return doc


def _pkg(producer):
    if producer == "jax":
        import analytics_zoo_tpu as pkg
    else:
        import analytics_zoo_torch as pkg
    return pkg.__name__


# ---------------------------------------------------------- broker outage
@pytest.mark.parametrize("producer", PRODUCERS)
def test_broker_outage(tmp_path, producer):
    import importlib
    p = _pkg(producer)
    chaos = importlib.import_module(f"{p}.resilience.chaos")
    rc = importlib.import_module(f"{p}.serving.redis_client")
    run_dir, fr = _host_slot(tmp_path, producer)

    class _Conn:
        def ping(self):
            return True

        def close(self):
            pass

    client = rc.BreakerClient(lambda: _Conn(), failures=3,
                              cooldown_s=60.0, conn=_Conn())
    chaos.install_chaos(chaos.ChaosPlan([chaos.FaultSpec(
        site=chaos.SITE_SERVING_REDIS, at_step=0, kind="raise", times=3,
        message="connection reset by injected outage")]))
    for _ in range(3):
        with pytest.raises(chaos.TransientFault):
            client.ping()
    assert client.breaker.state == rc.BREAKER_OPEN
    _close(fr)
    doc = _same_diagnosis(run_dir, "broker_outage")
    refs = [e["ref"] for e in doc["hypotheses"][0]["evidence"]]
    assert any(r.startswith("host-0/e") for r in refs)


# ---------------------------------------------------------- poison record
class _ReplicaDeath(BaseException):
    """Escapes ``except Exception`` like a real crash, leaving the batch
    un-acked in the PEL."""


class _PoisonKillsWorker:
    def predict(self, x, batch_size=None):
        if np.any(np.asarray(x) > 1e8):
            raise _ReplicaDeath("poison payload crashed the replica")
        return np.tile(np.arange(4, dtype=np.float32), (len(x), 1))


@pytest.mark.parametrize("producer", PRODUCERS)
def test_poison_record(tmp_path, producer):
    import importlib
    p = _pkg(producer)
    serving = importlib.import_module(f"{p}.serving")
    rc = importlib.import_module(f"{p}.serving.redis_client")
    server = importlib.import_module(f"{p}.serving.server")
    run_dir, fr = _host_slot(tmp_path, producer)
    broker = rc.EmbeddedBroker()

    def worker(name):
        return server.ClusterServing(
            _PoisonKillsWorker(),
            server.ServingConfig(batch_size=4, consumer_group="serve",
                                 consumer_name=name,
                                 poison_max_attempts=2),
            broker=broker)

    inq = serving.InputQueue(broker=broker)
    outq = serving.OutputQueue(broker=broker)
    inq.enqueue("h-0", np.zeros(3, np.float32))
    rid = inq.enqueue("poison", np.full(3, 1e9, np.float32))
    inq.enqueue("h-1", np.zeros(3, np.float32))
    w1 = worker("w1")

    def _run_until_death():
        try:
            w1.run(poll_ms=5)
        except _ReplicaDeath:
            pass
    t = threading.Thread(target=_run_until_death)
    t.start()
    t.join(timeout=30)
    assert not t.is_alive()
    with pytest.raises(_ReplicaDeath):
        worker("w2")._reclaim_stale(min_idle_ms=0)
    worker("w3")._reclaim_stale(min_idle_ms=0)
    res = outq.query("poison")
    assert isinstance(res, dict) and "quarantined" in res["error"]
    _close(fr)
    doc = _same_diagnosis(run_dir, "poison_record")
    assert any(rid in (e.get("note") or "")
               for e in doc["hypotheses"][0]["evidence"])


# ------------------------------------------------------ training numerics
@pytest.mark.parametrize("producer", PRODUCERS)
def test_training_numerics(tmp_path, producer):
    import importlib
    p = _pkg(producer)
    config = importlib.import_module(f"{p}.common.config")
    triggers = importlib.import_module(f"{p}.common.triggers")
    fs = importlib.import_module(f"{p}.feature.feature_set")
    keras = importlib.import_module(f"{p}.pipeline.api.keras")
    layers = importlib.import_module(f"{p}.pipeline.api.keras.layers")
    est_mod = importlib.import_module(f"{p}.pipeline.estimator")
    wd = importlib.import_module(f"{p}.observability.watchdog")
    run_dir, fr = _host_slot(tmp_path, producer)
    config.get_config().set("observability.watchdog_policy",
                            "checkpoint_and_halt")
    try:
        rs = np.random.RandomState(0)
        x = rs.randn(256, 8).astype(np.float32)
        y = rs.randn(256, 1).astype(np.float32)
        y[:32] = np.nan
        m = keras.Sequential()
        m.add(layers.Dense(1, input_shape=(8,)))
        m.compile(optimizer="sgd", loss="mse")
        est = est_mod.Estimator(m, optim_method=m.optim_method,
                                model_dir=str(tmp_path / "model"))
        with pytest.raises(wd.TrainingHalted):
            est.train(fs.FeatureSet.from_ndarrays(x, y), "mse",
                      end_trigger=triggers.MaxIteration(50),
                      batch_size=64)
    finally:
        config.get_config().set("observability.watchdog_policy", "warn")
    _close(fr)
    _same_diagnosis(run_dir, "training_numerics")


# ------------------------------------------------------ budget exhausted
@pytest.mark.parametrize("producer", PRODUCERS)
def test_restart_budget_exhausted(tmp_path, producer):
    import importlib
    p = _pkg(producer)
    sup_mod = importlib.import_module(f"{p}.serving.supervisor")
    policy = importlib.import_module(f"{p}.resilience.policy")
    run_dir = str(tmp_path / "run")
    os.makedirs(run_dir)

    def factory(index, incarnation):
        return [sys.executable, "-c", "import sys; sys.exit(3)"], {}

    sup = sup_mod.ServingSupervisor(
        factory, replicas=1, retry_times=2, retry_window_s=60.0,
        backoff_base_s=0.01, backoff_max_s=0.02, run_dir=run_dir,
        drain_timeout_s=5.0)
    with pytest.raises(policy.DegradedTraining):
        sup.run(poll_interval_s=0.02)
    assert os.path.exists(os.path.join(run_dir, "degraded.json"))
    sup._flightrec.close()
    # alone, a drained budget is a symptom: ranked, below the threshold
    _same_diagnosis(run_dir, None, top_cause="restart_budget_exhausted")


# -------------------------------------------------------------- lost host
@pytest.mark.parametrize("producer", PRODUCERS)
def test_lost_host(tmp_path, producer):
    run_dir, fr = _host_slot(tmp_path, producer)
    # the elastic trainer's journal of a lost host (the reference's
    # TestLostHostIncident leaves these)
    fr.record_event("chaos.trip", site="trainer.dispatch", step=5,
                    kind="lose_host")
    fr.record_event("train.failure", classification="lost_host",
                    action="reform_mesh", iteration=5,
                    cause="LostHost: injected")
    fr.record_event("mesh.reform", old_devices=8, new_devices=4,
                    iteration=5)
    _close(fr)
    _same_diagnosis(run_dir, "lost_host")


def test_an_unidentified_run_dir_is_the_same_in_both(tmp_path):
    run_dir, fr = _host_slot(tmp_path, "torch")
    fr.record_event("replica.spawn", replica=0, incarnation=1, pid=1)
    _close(fr)
    docs = []
    for mod in (jincident, tincident):
        doc = mod.diagnose(run_dir)
        doc.pop("generated_unix")
        docs.append(json.dumps(doc, sort_keys=True))
    assert docs[1] == docs[0]
    assert json.loads(docs[1])["identified"] is False
