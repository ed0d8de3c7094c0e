"""PyTorch port, the batch-scoring tier (``analytics_zoo_torch/batchjobs/``,
``parallel/launcher.py``, ``observability/aggregator.py``'s worker half)
against the JAX package's:

- a ``BatchJobSpec`` of the same fields writes the same ``job.json`` and
  ``manifest.json`` bytes and the same fingerprints;
- the ledger: claims are exclusive, an expired lease is stolen with its
  recompute debt, a commit happens exactly once, a stale fingerprint is
  not trusted; either package's ledger reads the other's;
- the in-process worker's shards equal the reference worker's on the
  demo ``LinearModel``, byte for byte;
- a clean fleet of two worker processes completes; a kill-and-resume
  drill recomputes less than one shard, commits none twice, and its
  output bytes equal the control's;
- an exhausted restart budget gives the structured degraded record, and
  the CLI exits 17;
- the report's keys are the reference's, it renders, and the CLI's
  ``report`` imports no torch;
- ``demo_keras_model`` builds bit-identical weights in two processes;
- ``ZooCluster``'s ``cluster.json`` and ``worker_env`` keys, and a
  worker's ``meta.json`` and ``metrics.jsonl``, are in the reference's
  layout.

Fleets run at most 2 workers and 512 rows; the Keras builders ask for
``device="cpu"``."""

import json
import os
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pytest

from analytics_zoo_tpu.batchjobs import demo as jdemo
from analytics_zoo_tpu.batchjobs import report as jreport
from analytics_zoo_tpu.batchjobs import spec as jspec
from analytics_zoo_tpu.batchjobs.manifest import ShardManifest as JManifest
from analytics_zoo_tpu.batchjobs.worker import BatchWorker as JBatchWorker
from analytics_zoo_tpu.observability import aggregator as jagg
from analytics_zoo_tpu.parallel.launcher import ZooCluster as JZooCluster

from analytics_zoo_torch.batchjobs import (
    BatchJobSpec, LeaseClient, LeaseLost, ShardManifest)
from analytics_zoo_torch.batchjobs import report as report_lib
from analytics_zoo_torch.batchjobs.demo import (
    demo_job, demo_keras_model, demo_model, demo_source, write_demo_npy)
from analytics_zoo_torch.batchjobs.spec import npy_rows
from analytics_zoo_torch.batchjobs.worker import BatchWorker
from analytics_zoo_torch.common import config as tconfig
from analytics_zoo_torch.common import zoo_context as tctx
from analytics_zoo_torch.observability import aggregator as tagg
from analytics_zoo_torch.observability import reset_registry
from analytics_zoo_torch.parallel.launcher import ZooCluster

REPO = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _port_cpu():
    tctx.reset_zoo_context()
    tconfig.reset_config()
    reset_registry()
    yield
    tctx.reset_zoo_context()
    tconfig.reset_config()


def _worker_env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    return env


def _job(tmp_path, **kw):
    kw.setdefault("num_rows", 256)
    kw.setdefault("rows_per_shard", 64)
    kw.setdefault("batch_size", 32)
    return demo_job(str(tmp_path / "out"), **kw)


def _expected(num_rows=256):
    return demo_model().predict(demo_source(num_rows).gather(
        np.arange(num_rows))[0])


def _concat(out_dir, num_shards):
    return np.concatenate([
        np.load(os.path.join(out_dir, f"shard-{i:05d}.npy"))
        for i in range(num_shards)], axis=0)


def _ledger(tmp_path, **kw):
    job = _job(tmp_path, **kw)
    run_dir = str(tmp_path / "run")
    os.makedirs(run_dir, exist_ok=True)
    ShardManifest.create(job, run_dir)
    return job, run_dir


# ==================================================================== spec
def _fields(tmp_path, npy):
    return dict(
        name="same-job",
        source={"kind": "npy_dir", "path": npy},
        model={"kind": "builder", "ref": "pkg.mod:build",
               "args": {"width": 3, "scale": 0.5, "tags": ["a", "b"]}},
        output_dir=str(tmp_path / "o"), rows_per_shard=30, batch_size=8,
        lease_timeout_s=2.5, target_deadline_s=120.0)


def test_spec_and_manifest_bytes_are_the_references(tmp_path):
    npy = write_demo_npy(str(tmp_path / "npy"), num_rows=100, dim=3)
    t = BatchJobSpec(**_fields(tmp_path, npy))
    j = jspec.BatchJobSpec(**_fields(tmp_path, npy))
    assert t.to_json() == j.to_json()
    assert npy_rows(os.path.join(npy, "x.npy")) == 100 == j.resolved_rows()
    assert t.num_shards() == j.num_shards() == 4
    for sid in range(4):
        assert t.shard_range(sid) == j.shard_range(sid)
        assert t.shard_fingerprint(sid) == j.shard_fingerprint(sid)
    assert BatchJobSpec.from_json(t.to_json()).to_dict() == t.to_dict()
    ShardManifest.create(t, str(tmp_path / "pt"))
    JManifest.create(j, str(tmp_path / "jx"))
    for name in ("job.json", "manifest.json"):
        assert (tmp_path / "pt" / "job" / name).read_bytes() == \
            (tmp_path / "jx" / "job" / name).read_bytes()
    # either package's ledger reads the other's
    assert JManifest.load(str(tmp_path / "pt")).doc == \
        ShardManifest.load(str(tmp_path / "jx")).doc
    with pytest.raises(ValueError, match="num_rows"):
        BatchJobSpec(source={"kind": "builder", "ref": "x:y"},
                     output_dir="o").resolved_rows()
    with pytest.raises(RuntimeError, match="different job"):
        ShardManifest.create(BatchJobSpec(**dict(
            _fields(tmp_path, npy), rows_per_shard=50)),
            str(tmp_path / "pt"))


# ================================================================== ledger
def test_claims_are_exclusive(tmp_path):
    _, run_dir = _ledger(tmp_path)
    a = LeaseClient(run_dir, owner="a")
    b = LeaseClient(run_dir, owner="b")
    assert [sid for sid, _ in a.claim_shards(limit=4)] == [0, 1, 2, 3]
    assert b.claim_shards(limit=4) == []


def test_an_expired_lease_is_stolen_with_its_debt(tmp_path):
    _, run_dir = _ledger(tmp_path, num_rows=64)
    now = [1000.0]
    a = LeaseClient(run_dir, owner="a", timeout_s=5.0, clock=lambda: now[0])
    b = LeaseClient(run_dir, owner="b", timeout_s=5.0, clock=lambda: now[0])
    (sid, _), = a.claim_shards(limit=1)
    a.renew(sid, rows_done=40)
    assert b.claim_shards(limit=1) == []
    now[0] += 6.0
    (sid_b, shard_b), = b.claim_shards(limit=1)
    assert sid_b == sid
    with pytest.raises(LeaseLost):
        a.renew(sid, rows_done=41)
    b.commit_shard(sid_b, fingerprint=shard_b["fingerprint"], rows=64,
                   seconds=0.5)
    assert ShardManifest.load(run_dir).committed()[sid][
        "recomputed_rows"] == 40


def test_commits_are_exactly_once_and_stale_ones_untrusted(tmp_path):
    _, run_dir = _ledger(tmp_path)
    a = LeaseClient(run_dir, owner="a")
    (sid, shard), = a.claim_shards(limit=1)
    assert a.commit_shard(sid, fingerprint=shard["fingerprint"], rows=64)
    b = LeaseClient(run_dir, owner="b")
    assert not b.commit_shard(sid, fingerprint=shard["fingerprint"],
                              rows=64)
    m = ShardManifest.load(run_dir)
    assert m.committed()[sid]["owner"] == "a"
    assert m.progress()["duplicates"] == 1
    assert JManifest(m.doc, run_dir).progress() == m.progress()
    (sid2, _), = a.claim_shards(limit=1)
    a.commit_shard(sid2, fingerprint="not-the-manifest-key", rows=64)
    m = ShardManifest.load(run_dir)
    assert sid2 not in m.committed() and not m.progress()["complete"]
    assert sid2 in [s for s, _ in LeaseClient(
        run_dir, owner="c").claim_shards(limit=4)]


# ======================================================== in-process worker
def test_the_worker_scores_the_references_bytes(tmp_path):
    job, run_dir = _ledger(tmp_path)
    w = BatchWorker(job, run_dir, source=demo_source(256),
                    model=demo_model())
    assert w.run() == {"shards": 4, "rows": 256, "steps": 8}
    jjob = jdemo.demo_job(str(tmp_path / "jout"), num_rows=256,
                          rows_per_shard=64, batch_size=32)
    jrun = str(tmp_path / "jrun")
    JManifest.create(jjob, jrun)
    JBatchWorker(jjob, jrun, source=jdemo.demo_source(256),
                 model=jdemo.demo_model()).run()
    for sid in range(4):
        name = f"shard-{sid:05d}.npy"
        assert (tmp_path / "out" / name).read_bytes() == \
            (tmp_path / "jout" / name).read_bytes()
    np.testing.assert_array_equal(_concat(job.output_dir, 4), _expected())
    # two workers on one ledger split it without overlap
    job2, run2 = _job(tmp_path / "two"), str(tmp_path / "two" / "run")
    ShardManifest.create(job2, run2)
    s = [BatchWorker(job2, run2, process_id=i, source=demo_source(256),
                     model=demo_model()).run() for i in range(2)]
    assert s[0]["shards"] + s[1]["shards"] == 4
    assert ShardManifest.load(run2).progress()["duplicates"] == 0


def test_a_tail_batch_keeps_the_batch_shape(tmp_path):
    """A model whose predict takes ``batch_size`` gets the job's: the
    short tail of a shard is padded to the compiled shape."""
    class Shapes:
        def __init__(self):
            self.seen = []

        def predict(self, x, batch_size=None):
            self.seen.append((len(x), batch_size))
            return np.asarray(x)[:, :1]
    job, run_dir = _ledger(tmp_path, num_rows=100, rows_per_shard=50,
                           batch_size=32)
    m = Shapes()
    BatchWorker(job, run_dir, source=demo_source(100), model=m).run()
    assert m.seen == [(32, 32), (18, 32)] * 2


# ================================================================== fleet
@pytest.fixture(scope="module")
def clean_run(tmp_path_factory):
    from analytics_zoo_torch.batchjobs.coordinator import run_job
    tmp = tmp_path_factory.mktemp("clean")
    job = _job(tmp)
    run_dir = str(tmp / "run")
    report = run_job(job, run_dir, num_workers=2, env=_worker_env(),
                     timeout_s=120)
    return job, run_dir, report


def test_a_clean_fleet_of_two_completes(clean_run):
    job, run_dir, report = clean_run
    assert report["status"] == "complete"
    assert report["shards_committed"] == 4 and report["restarts"] == 0
    assert report["worker_exit_codes"] == [0, 0]
    assert report["rows_per_sec_per_chip"] > 0 and report["chips_for"]
    np.testing.assert_array_equal(_concat(job.output_dir, 4), _expected())


def test_kill_and_resume_recomputes_less_than_a_shard(tmp_path):
    from analytics_zoo_torch.batchjobs.coordinator import run_job
    from analytics_zoo_torch.resilience.chaos import ChaosPlan, FaultSpec
    rows, per_shard, batch = 512, 128, 32
    control_job = demo_job(str(tmp_path / "out-control"), num_rows=rows,
                           rows_per_shard=per_shard, batch_size=batch)
    control = run_job(control_job, str(tmp_path / "run-control"),
                      num_workers=2, env=_worker_env(), timeout_s=120)
    assert control["status"] == "complete"
    assert control["resume"]["rows_recomputed"] == 0
    chaos_job = demo_job(str(tmp_path / "out-chaos"), num_rows=rows,
                         rows_per_shard=per_shard, batch_size=batch,
                         delay_s=0.15, lease_timeout_s=1.5)
    plan = ChaosPlan([FaultSpec(site="worker.step", at_step=2, kind="kill",
                                process_index=0)])
    report = run_job(chaos_job, str(tmp_path / "run-chaos"), num_workers=2,
                     env=_worker_env(), chaos=plan, timeout_s=180)
    assert report["status"] == "complete" and report["restarts"] >= 1
    assert 0 < report["resume"]["rows_recomputed"] < per_shard
    assert report["resume"]["duplicate_commits"] == 0
    assert report["resume"]["resume_overhead_fraction"] < per_shard / rows
    progress = ShardManifest.load(str(tmp_path / "run-chaos")).progress()
    assert progress["complete"] and progress["shards_committed"] == 4
    assert _concat(chaos_job.output_dir, 4).tobytes() == \
        _concat(control_job.output_dir, 4).tobytes()
    # the replacement's slot carries the reference's run-dir layout
    slot = tmp_path / "run-chaos" / "host-0"
    meta = json.loads((slot / "meta.json").read_text())
    assert meta["process_index"] == 0
    respawns = json.loads((tmp_path / "run-chaos" / "job" /
                           "respawns.json").read_text())
    assert respawns["deaths"][0]["classification"] == "signal(SIGKILL)"


def test_an_exhausted_budget_degrades_with_the_record(tmp_path):
    from analytics_zoo_torch.batchjobs.coordinator import BatchCoordinator
    from analytics_zoo_torch.resilience.chaos import (
        ENV_CHAOS, ChaosPlan, FaultSpec)
    from analytics_zoo_torch.resilience.policy import DegradedTraining
    job = _job(tmp_path, delay_s=0.2, lease_timeout_s=1.0)
    plan = ChaosPlan([FaultSpec(site="worker.step", at_step=0, kind="kill",
                                times=99)])
    run_dir = str(tmp_path / "run")

    def always_armed(index, incarnation):
        env = coord.cluster.worker_env(index)
        env["ZOO_TPU_BATCH_JOB"] = run_dir
        env[ENV_CHAOS] = plan.to_json()
        env.update(_worker_env())
        return [sys.executable, "-m",
                "analytics_zoo_torch.batchjobs.worker"], env

    coord = BatchCoordinator(job, run_dir, num_workers=1, env=_worker_env(),
                             worker_factory=always_armed, retry_times=1,
                             backoff_base_s=0.05)
    with pytest.raises(DegradedTraining) as exc:
        coord.run(timeout_s=90)
    coord.stop()
    record = exc.value.result
    assert record["status"] == "degraded" and \
        record["component"] == "batchjobs"
    assert record["classification"] == "signal(SIGKILL)"
    assert record["report"]["status"] == "degraded"
    degraded = json.loads((tmp_path / "run" / "degraded.json").read_text())
    assert degraded["reason"] == record["reason"]


def test_the_cli_exits_17_when_the_budget_runs_out(tmp_path):
    builder = tmp_path / "failing.py"
    builder.write_text("def build():\n    raise RuntimeError('no model')\n")
    job = _job(tmp_path)
    job.model = {"kind": "builder", "ref": f"{builder}:build"}
    spec = tmp_path / "job.json"
    spec.write_text(job.to_json())
    proc = subprocess.run(
        [sys.executable, "-m", "analytics_zoo_torch.batchjobs.cli", "run",
         "--spec", str(spec), "--run-dir", str(tmp_path / "run"),
         "--timeout", "120"],
        capture_output=True, text=True, timeout=180, env=_worker_env(),
        cwd=str(REPO))
    assert proc.returncode == 17, proc.stderr[-3000:]
    record = json.loads([line for line in proc.stderr.splitlines()
                         if line.startswith("{")][-1])
    assert record["status"] == "degraded"
    assert record["component"] == "batchjobs"


# ================================================================ reports
def test_the_reports_keys_are_the_references_and_it_renders(clean_run,
                                                           tmp_path):
    _, run_dir, report = clean_run
    saved = report_lib.load_report(run_dir)
    assert saved["rows_committed"] == 256
    copy = str(tmp_path / "copy")
    shutil.copytree(run_dir, copy)
    for a, b in ((report_lib.build_report(copy, num_chips=2, elapsed_s=2.0),
                  jreport.build_report(copy, num_chips=2, elapsed_s=2.0)),):
        assert a == b
        assert set(a) == set(saved) == set(report) - {"worker_exit_codes"}
        assert set(a["resume"]) == {"rows_recomputed", "duplicate_commits",
                                    "resume_overhead_fraction"}
    text = report_lib.render_report(saved)
    assert text == jreport.render_report(saved)
    assert "rows/s/chip" in text and "capacity at target deadline" in text
    assert report_lib.render_shard_table(run_dir).count("COMMITTED") == 4
    assert report_lib.render_job_section(run_dir) == \
        jreport.render_job_section(run_dir)


def test_the_cli_report_imports_no_torch(clean_run, tmp_path):
    _, run_dir, _ = clean_run
    site = tmp_path / "site"
    site.mkdir()
    (site / "torch.py").write_text(
        "raise ImportError('torch imported by the report')\n")
    env = dict(os.environ, PYTHONPATH=f"{site}{os.pathsep}{REPO}")
    proc = subprocess.run(
        [sys.executable, "-m", "analytics_zoo_torch.batchjobs.cli",
         "report", run_dir],
        capture_output=True, text=True, timeout=60, env=env, cwd=str(site))
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.count("COMMITTED") == 4
    assert "rows/s/chip" in proc.stdout


# ============================================================ device model
_KERAS_CHILD = """
import sys
import numpy as np
from analytics_zoo_torch.batchjobs.demo import demo_keras_model
im = demo_keras_model(device="cpu")
w = im._variables["params"]["demo_dense"]
x = np.random.RandomState(0).randn(5, 8).astype(np.float32)
sys.stdout.write(w["kernel"].numpy().tobytes().hex() + " " +
                 w["bias"].numpy().tobytes().hex() + " " +
                 im.predict(x, batch_size=8).tobytes().hex())
"""


def test_demo_keras_model_is_bit_identical_across_processes(tmp_path):
    outs = [subprocess.run([sys.executable, "-c", _KERAS_CHILD],
                           capture_output=True, text=True, timeout=120,
                           env=_worker_env(), check=True).stdout
            for _ in range(2)]
    assert outs[0] == outs[1] and len(outs[0].split()) == 3
    # and in process, through the worker, twice: the same shard bytes
    job, run_dir = _ledger(tmp_path, keras=True, device="cpu")
    assert job.model["args"]["device"] == "cpu"
    src = demo_source(256)
    BatchWorker(job, run_dir, source=src,
                model=demo_keras_model(device="cpu")).run()
    first = _concat(job.output_dir, 4).tobytes()
    shutil.rmtree(run_dir)
    shutil.rmtree(job.output_dir)
    os.makedirs(run_dir)
    ShardManifest.create(job, run_dir)
    BatchWorker(job, run_dir, source=src).run()   # built from the spec
    assert _concat(job.output_dir, 4).tobytes() == first


# =================================================== launcher and run dir
def test_cluster_json_and_worker_env_are_the_references(tmp_path):
    t = ZooCluster(2, run_dir=str(tmp_path / "t"))
    j = JZooCluster(2, run_dir=str(tmp_path / "j"))
    tdoc = json.loads((tmp_path / "t" / "cluster.json").read_text())
    jdoc = json.loads((tmp_path / "j" / "cluster.json").read_text())
    assert set(tdoc) == set(jdoc)
    assert [set(w) for w in tdoc["workers"]] == \
        [set(w) for w in jdoc["workers"]]
    assert [w["dir"] for w in tdoc["workers"]] == ["host-0", "host-1"]
    keys = {k for k in t.worker_env(1) if k.startswith("ZOO_TPU_")}
    assert keys == {k for k in j.worker_env(1) if k.startswith("ZOO_TPU_")}
    assert t.worker_env(1)["ZOO_TPU_PROCESS_ID"] == "1"
    health = t.check_health()
    assert health.ok and health.expected == 2 and health.alive == 0
    assert t.stop() == {}
    for name in ("CLUSTER_FILE", "META_FILE", "METRICS_FILE", "TRACE_FILE",
                 "ENV_RUN_DIR", "ENV_METRICS_DIR", "ENV_METRICS_PORT",
                 "ENV_CLOCK_ANCHOR", "ENV_PROCESS_ID"):
        assert getattr(tagg, name) == getattr(jagg, name)
    assert tagg.host_dir_name(3) == jagg.host_dir_name(3) == "host-3"


def test_a_workers_slot_is_in_the_references_layout(tmp_path):
    from analytics_zoo_torch.observability import get_registry
    slots = {}
    for name, agg in (("port", tagg), ("jax", jagg)):
        run_dir = str(tmp_path / name)
        try:
            wdir = agg.init_worker_observability(
                run_dir=run_dir, process_index=1, metrics_port=0,
                start_server=False, register_atexit=False)
            assert wdir == os.path.join(run_dir, "host-1")
            assert agg.init_worker_observability(run_dir=run_dir) == wdir
            if name == "port":
                get_registry().counter("batch_rows_total", "rows",
                                       labels=("job",)).labels("j").inc(3)
            agg.flush_worker_observability()
        finally:
            agg.reset_worker_observability()
        slots[name] = pathlib.Path(wdir)
    tmeta = json.loads((slots["port"] / "meta.json").read_text())
    jmeta = json.loads((slots["jax"] / "meta.json").read_text())
    assert set(tmeta) == set(jmeta) and tmeta["process_index"] == 1
    tline = json.loads((slots["port"] / "metrics.jsonl").read_text()
                       .splitlines()[-1])
    jline = json.loads((slots["jax"] / "metrics.jsonl").read_text()
                       .splitlines()[-1])
    assert set(tline) == set(jline) == {"wall_time", "metrics"}
    assert set(tline["metrics"]) >= {"counters"} and \
        set(jline["metrics"]) >= {"counters"}
    assert any(k.startswith("batch_rows_total")
               for k in tline["metrics"]["counters"])
    assert json.loads((slots["port"] / "trace.json").read_text()).keys() == \
        json.loads((slots["jax"] / "trace.json").read_text()).keys()
    assert tagg.flush_worker_observability() is None   # after reset
