"""Batch job coordinator — the torch-free supervisor of a scoring fleet
(port of the JAX package's ``batchjobs/coordinator.py``).

Composes the existing control planes instead of inventing new ones:

* **launcher** (``parallel/launcher.py``): a ``ZooCluster`` run dir
  gives every worker slot its ``host-<k>/`` metrics dir, a
  pre-allocated metrics port, a shared clock anchor and the
  ``cluster.json`` manifest;
* **detector** (``resilience/detector.py``): worker deaths are
  classified by exit code (``classify_exit``); preemption-like deaths
  (SIGKILL/SIGTERM) respawn under a per-slot ``RetryBudget``, real
  errors too — budget exhaustion ends the job with the structured
  degraded record (exit 17 via the CLI), never a silent hang;
* **compile farm** (``compile/cache.py``): the run dir holds the kernel
  libraries' cache — ZOO_TPU_RUN_DIR rides the worker env, process 0
  stores, replacement incarnations load them warm;
* **ledger** (``manifest.py``): completion is a property of the
  manifest (every shard committed), NOT of worker exit codes — a worker
  that dies after its last commit changes nothing, a worker that exits
  0 early is caught by the ledger staying incomplete.

Like the serving supervisor, a ``worker_factory(index, incarnation)``
hook decides each life's argv+env — chaos plans arm incarnation 0
only, so the kill-and-resume drill kills the first life and lets the
replacement finish clean.
"""

from __future__ import annotations

import logging
import os
import subprocess
import sys
import time
from typing import Callable, Dict, List, Optional, Tuple

from .spec import BatchJobSpec, ENV_BATCH_JOB
from .manifest import ShardManifest
from . import report as report_lib

log = logging.getLogger("analytics_zoo_torch.batchjobs.coordinator")

WORKER_MODULE = "analytics_zoo_torch.batchjobs.worker"


class _Slot:
    def __init__(self, index: int, budget):
        self.index = index
        self.budget = budget
        self.proc: Optional[subprocess.Popen] = None
        self.incarnation = 0
        self.done = False
        self.last_exit: Optional[int] = None
        self.next_spawn_at: Optional[float] = None


class BatchCoordinator:
    """Partition, lease, supervise, report — one offline job end to
    end.  jax-free: safe on a CPU-only control node.

    Args:
        job: the :class:`BatchJobSpec`.
        run_dir: fleet run dir (ledger lives in ``<run_dir>/job/``).
        num_workers: fleet width (the "chips" of the capacity report).
        chaos: optional :class:`ChaosPlan`/JSON armed for incarnation
            0 of each slot (fault drills).
        env: extra env for workers (e.g. PYTHONPATH in tests).
        worker_factory: override ``(index, incarnation) -> (argv,
            env)`` — the supervisor's test seam.
    """

    def __init__(self, job: BatchJobSpec, run_dir: str, *,
                 num_workers: int = 1, chaos=None,
                 env: Optional[Dict[str, str]] = None,
                 worker_factory: Optional[Callable] = None,
                 retry_times: int = 3, retry_window_s: float = 60.0,
                 backoff_base_s: float = 0.1,
                 backoff_max_s: float = 2.0):
        from analytics_zoo_torch.observability.flightrec import (
            FlightRecorder)
        from analytics_zoo_torch.parallel.launcher import ZooCluster
        from analytics_zoo_torch.resilience.policy import RetryBudget

        self.job = job
        self.run_dir = run_dir
        self.num_workers = int(num_workers)
        self.backoff_base_s = backoff_base_s
        self.backoff_max_s = backoff_max_s
        self.restarts_total = 0
        self._deaths: List[Dict] = []
        self._respawns: List[Dict] = []
        # a PRIVATE recorder into the run-level events.jsonl: the
        # process-wide slot belongs to workers (each journals into its
        # own host-<k>/), the coordinator is the fleet's control plane
        self._flightrec = FlightRecorder(run_dir, role="coordinator")

        # run-dir plumbing (host slots, ports, clock anchor,
        # cluster.json) + chaos env — reuse the launcher wholesale
        self.cluster = ZooCluster(
            num_processes=self.num_workers, env=env or {},
            run_dir=run_dir, chaos=chaos)
        self.manifest = ShardManifest.create(job, run_dir)
        self.worker_factory = worker_factory or self._default_factory
        self._slots = [
            _Slot(i, RetryBudget(retry_times=retry_times,
                                 window_s=retry_window_s))
            for i in range(self.num_workers)]

    # ------------------------------------------------------------- spawn
    def _default_factory(self, index: int,
                         incarnation: int) -> Tuple[List[str], Dict]:
        from analytics_zoo_torch.resilience.chaos import ENV_CHAOS
        env = self.cluster.worker_env(index)
        env[ENV_BATCH_JOB] = self.run_dir
        if incarnation > 0:
            # chaos arms the FIRST life only: the drill is "worker
            # dies once", not "slot dies forever"
            env.pop(ENV_CHAOS, None)
        argv = [sys.executable, "-m", WORKER_MODULE]
        return argv, env

    def _spawn(self, slot: _Slot) -> None:
        from analytics_zoo_torch.parallel.launcher import _set_pdeathsig
        argv, env = self.worker_factory(slot.index, slot.incarnation)
        # drop the dead incarnation's heartbeat (launcher/supervisor
        # contamination guard): the replacement's first beat lands
        # after model load, and a predecessor's stale timestamp would
        # make stale_hosts condemn every slow-starting respawn
        try:
            os.remove(os.path.join(
                self.run_dir, f"host-{slot.index}", "heartbeat.json"))
        except OSError:
            pass
        slot.proc = subprocess.Popen(
            argv, env=env, preexec_fn=_set_pdeathsig)
        self.cluster.monitor.register(slot.proc, index=slot.index)
        slot.incarnation += 1
        slot.next_spawn_at = None
        log.info("batch worker %d spawned (incarnation %d, pid %d)",
                 slot.index, slot.incarnation, slot.proc.pid)

    # --------------------------------------------------------- supervision
    def _handle_exit(self, slot: _Slot, code: int,
                     complete: bool) -> None:
        from analytics_zoo_torch.resilience.detector import classify_exit
        slot.proc = None
        slot.last_exit = code
        cls = classify_exit(code)
        if code == 0:
            if complete:
                slot.done = True
                log.info("batch worker %d drained (exit 0)", slot.index)
                return
            # exit 0 with shards still uncommitted: either it raced
            # the last commit (ledger will show complete next poll) or
            # it wrongly concluded the job was done — respawn through
            # the budget either way; an idle respawn exits 0 cheaply
            log.warning("batch worker %d exited 0 with the ledger "
                        "incomplete; respawning", slot.index)
        self._deaths.append({"process_index": slot.index, "code": code,
                             "classification": cls})
        if not slot.budget.consume():
            self._flightrec.record(
                "fleet.degraded", component="batchjobs",
                worker=slot.index, exit=cls,
                reason="restart budget exhausted")
            self._persist_respawns()
            raise _BudgetExhausted(slot, code, cls)
        self.restarts_total += 1
        delay = min(self.backoff_max_s,
                    self.backoff_base_s * (2 ** max(
                        0, slot.incarnation - 1)))
        slot.next_spawn_at = time.time() + delay
        self._flightrec.record(
            "worker.respawn", worker=slot.index, exit=cls, code=code,
            incarnation=slot.incarnation, delay_s=round(delay, 3),
            budget_left=slot.budget.remaining)
        self._respawns.append({
            "process_index": slot.index, "code": code,
            "classification": cls, "incarnation": slot.incarnation,
            "delay_s": round(delay, 3),
            "budget_left": slot.budget.remaining,
            "time_unix": round(time.time(), 3)})
        # persisted AT DECISION TIME, not at job end: a coordinator
        # that is itself killed later leaves the respawn ledger behind
        self._persist_respawns()
        log.warning("batch worker %d died (%s); respawn in %.2fs "
                    "(%d budget left)", slot.index, cls, delay,
                    slot.budget.remaining)

    def run(self, timeout_s: Optional[float] = None,
            poll_s: float = 0.05) -> Dict:
        """Run the job to completion.  Returns the capacity report;
        raises :class:`DegradedTraining` when a slot's restart budget
        exhausts with the ledger incomplete."""
        from analytics_zoo_torch.resilience.policy import DegradedTraining

        t0 = time.time()
        deadline = None if timeout_s is None else t0 + timeout_s
        for slot in self._slots:
            self._spawn(slot)
        try:
            while True:
                progress = self.manifest.progress()
                if progress["complete"]:
                    break
                now = time.time()
                if deadline is not None and now > deadline:
                    raise TimeoutError(
                        f"batch job {self.job.name!r} incomplete after "
                        f"{timeout_s}s: {progress}")
                for slot in self._slots:
                    if slot.done:
                        continue
                    if slot.proc is None:
                        if slot.next_spawn_at is not None \
                                and now >= slot.next_spawn_at:
                            self._spawn(slot)
                        continue
                    code = slot.proc.poll()
                    if code is not None:
                        self._handle_exit(
                            slot, code, progress["complete"])
                if all(s.done or (s.proc is None
                                  and s.next_spawn_at is None)
                       for s in self._slots):
                    raise RuntimeError(
                        f"batch job {self.job.name!r} stalled: no "
                        f"live or respawnable workers, {progress}")
                time.sleep(poll_s)
        except _BudgetExhausted as exc:
            self.stop()
            elapsed = time.time() - t0
            report = report_lib.build_report(
                self.run_dir, num_chips=self.num_workers,
                elapsed_s=elapsed, status="degraded",
                restarts=self.restarts_total)
            record = {
                "status": "degraded", "component": "batchjobs",
                "reason": (f"worker {exc.slot.index} exhausted its "
                           "restart budget"),
                "exit_code": exc.code,
                "classification": exc.classification,
                "deaths": self._deaths,
                "report": report,
            }
            self._write_degraded(record)
            raise DegradedTraining(record["reason"], result=record) \
                from None
        # ledger complete: let drained workers exit 0, then report
        codes = self._drain()
        elapsed = time.time() - t0
        report = report_lib.build_report(
            self.run_dir, num_chips=self.num_workers,
            elapsed_s=elapsed, status="complete",
            restarts=self.restarts_total)
        report["worker_exit_codes"] = codes
        log.info("batch job %r complete: %.0f rows in %.2fs "
                 "(%d restarts)", self.job.name,
                 report["rows_committed"], elapsed,
                 self.restarts_total)
        return report

    def _drain(self, timeout_s: float = 60.0) -> List[int]:
        codes: Dict[int, int] = {}
        deadline = time.time() + timeout_s
        while time.time() < deadline:
            live = False
            for slot in self._slots:
                if slot.proc is None:
                    if slot.last_exit is not None:
                        codes[slot.index] = slot.last_exit
                    continue
                code = slot.proc.poll()
                if code is None:
                    live = True
                else:
                    slot.proc = None
                    slot.last_exit = code
                    codes[slot.index] = code
            if not live:
                break
            time.sleep(0.05)
        self.stop()
        return [codes.get(i, -1) for i in range(self.num_workers)]

    def _persist_respawns(self) -> None:
        """Atomic snapshot of the death/respawn ledger
        (``<run_dir>/job/respawns.json``), in the reference's layout.
        Best-effort: supervision never fails on forensics."""
        import json
        from analytics_zoo_torch.common.fsutil import atomic_write_text
        path = os.path.join(self.run_dir, "job", "respawns.json")
        try:
            os.makedirs(os.path.dirname(path), exist_ok=True)
            atomic_write_text(path, json.dumps({
                "written_unix": round(time.time(), 3),
                "restarts_total": self.restarts_total,
                "deaths": self._deaths,
                "respawns": self._respawns,
            }, indent=2, sort_keys=True))
        except OSError:
            log.exception("could not persist respawns.json")

    def _write_degraded(self, record: Dict) -> None:
        import json
        from analytics_zoo_torch.common.fsutil import atomic_write_text
        atomic_write_text(os.path.join(self.run_dir, "degraded.json"),
                          json.dumps(record, indent=2, sort_keys=True))

    def stop(self) -> None:
        self.cluster.stop()
        for slot in self._slots:
            slot.proc = None
        try:
            self._flightrec.close()
        except Exception:   # noqa: BLE001 — teardown best-effort
            pass


class _BudgetExhausted(Exception):
    def __init__(self, slot: _Slot, code: int, classification: str):
        super().__init__(f"slot {slot.index} budget exhausted")
        self.slot = slot
        self.code = code
        self.classification = classification


def run_job(job: BatchJobSpec, run_dir: str, *, num_workers: int = 1,
            chaos=None, env: Optional[Dict[str, str]] = None,
            timeout_s: Optional[float] = None, **kw) -> Dict:
    """One-call convenience: partition, run, report."""
    coord = BatchCoordinator(job, run_dir, num_workers=num_workers,
                             chaos=chaos, env=env, **kw)
    try:
        return coord.run(timeout_s=timeout_s)
    finally:
        coord.stop()
