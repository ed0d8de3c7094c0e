"""Multi-process job launcher — the RayOnSpark analogue (port of the
JAX package's ``parallel/launcher.py``).

Reference: pyzoo/zoo/ray/raycontext.py — a Spark barrier stage starts
``ray start`` on every executor (gen_ray_start :155), ``JVMGuard``
(:32) kills the ray processes if the parent JVM dies, and
``ProcessMonitor`` tracks pids.

The launcher spawns one worker process per host (or N on one machine),
injects the env contract (ZOO_TPU_COORDINATOR / NUM_PROCESSES /
PROCESS_ID, the same keys as the reference), and guards children with
PR_SET_PDEATHSIG so they die with the launcher, plus atexit cleanup.
The reference's workers turn that contract into a ``jax.distributed``
rendezvous inside ``init_zoo_context``; the port's rendezvous
(``torch.distributed``) and ``launch_cli.py`` come with the multi-GPU
slice (ROADMAP.md, queue 1 item 8), so until then a port ``ZooCluster``
starts INDEPENDENT processes — the batch-scoring fleet
(``batchjobs/coordinator.py``) needs no collective.

Observability plane: passing ``run_dir`` makes the launcher the
cluster's rendezvous for fleet-level metrics — it creates one
``host-<k>/`` slot per worker, pre-allocates a metrics port each,
broadcasts a shared clock anchor (so per-host Chrome traces align on
one epoch), and writes a ``cluster.json`` manifest in the reference's
layout.  Workers pick the contract up from ZOO_TPU_RUN_DIR /
ZOO_TPU_METRICS_DIR / ZOO_TPU_METRICS_PORT / ZOO_TPU_CLOCK_ANCHOR via
``observability.aggregator.init_worker_observability``.
"""

from __future__ import annotations

import atexit
import ctypes
import dataclasses
import json
import logging
import os
import signal
import socket
import subprocess
import sys
import time
from typing import Dict, List, Optional, Sequence

log = logging.getLogger("analytics_zoo_torch.launcher")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("", 0))
        return s.getsockname()[1]


def _set_pdeathsig():
    """Child dies when the launcher dies (the JVMGuard role)."""
    try:
        libc = ctypes.CDLL("libc.so.6", use_errno=True)
        PR_SET_PDEATHSIG = 1
        libc.prctl(PR_SET_PDEATHSIG, signal.SIGKILL)
    except Exception:       # pragma: no cover - non-linux
        pass


class ProcessMonitor:
    """Track spawned workers; kill them all on exit
    (raycontext.py ProcessMonitor + JVMGuard)."""

    def __init__(self):
        self.procs: List[subprocess.Popen] = []
        self.indices: List[int] = []
        # exit codes observed by stop_all/poll, by process index —
        # kept after procs are cleared so post-mortems still classify
        self.exit_codes: Dict[int, Optional[int]] = {}
        atexit.register(self.stop_all)

    def register(self, proc: subprocess.Popen,
                 index: Optional[int] = None) -> None:
        self.indices.append(len(self.procs) if index is None
                            else int(index))
        self.procs.append(proc)

    def stop_all(self, timeout: float = 5.0,
                 kill_grace: float = 2.0) -> Dict[int, Optional[int]]:
        """TERM every worker, then escalate to KILL *per process* and
        reap each one — a worker that ignores/blocks SIGTERM gets
        SIGKILLed and still gets waited on, so no zombie survives a
        hang.  Returns {process_index: exit code} (None only for a
        truly unkillable process, e.g. stuck in uninterruptible IO)."""
        codes: Dict[int, Optional[int]] = {}
        for p in self.procs:
            if p.poll() is None:
                p.terminate()
        deadline = time.time() + timeout
        for idx, p in zip(self.indices, self.procs):
            try:
                codes[idx] = p.wait(max(deadline - time.time(), 0.1))
            except subprocess.TimeoutExpired:
                p.kill()
                try:
                    codes[idx] = p.wait(kill_grace)
                except subprocess.TimeoutExpired:   # pragma: no cover
                    log.error("worker %d (pid %d) survived SIGKILL "
                              "(uninterruptible state?)", idx, p.pid)
                    codes[idx] = None
        self.exit_codes.update(codes)
        self.procs.clear()
        self.indices.clear()
        return codes

    def poll_classified(self) -> List[Dict]:
        """One liveness/exit record per tracked worker, with the exit
        code classified (resilience.detector.classify_exit) — the
        launcher-side half of lost-host detection.  A worker that
        exited with the degraded protocol code is classified
        ``degraded``: an orderly checkpoint-and-queue ending, not a
        death."""
        from analytics_zoo_torch.resilience.detector import classify_exit
        from analytics_zoo_torch.resilience.policy import (
            DEGRADED_EXIT_CODE)
        out = []
        for idx, p in zip(self.indices, self.procs):
            code = p.poll()
            if code is not None:
                self.exit_codes.setdefault(idx, code)
            out.append({
                "process_index": idx,
                "pid": p.pid,
                "running": code is None,
                "code": code,
                "classification": ("degraded"
                                   if code == DEGRADED_EXIT_CODE
                                   else classify_exit(code)),
            })
        return out

    def alive(self) -> int:
        return sum(1 for p in self.procs if p.poll() is None)


class WaitResult(list):
    """``ZooCluster.wait``'s return value: still the per-process exit
    code list (index = process index) the old API promised, plus the
    forensic fields a flat list could not carry — which host died
    FIRST (on a pod, the first death is the cause; every later
    non-zero exit is usually collateral collective teardown)."""

    def __init__(self, codes: Sequence[int]):
        super().__init__(codes)
        #: [(process_index, code, wall time)] in observed exit order
        self.exit_order: List[tuple] = []
        #: first non-ok exit: {process_index, code, classification}
        self.first_failure: Optional[Dict] = None


@dataclasses.dataclass
class ClusterHealth:
    """Snapshot from ``ZooCluster.check_health``."""
    expected: int
    alive: int
    missing: List[int]                 # dead-bad or heartbeat-stale
    first_death: Optional[Dict]        # first worker seen dead-bad
    states: List[Dict]                 # poll_classified() records
    degraded: List[int] = dataclasses.field(default_factory=list)
    # ^ workers that exited DEGRADED_EXIT_CODE: orderly
    #   checkpoint-and-queue endings — neither alive nor missing

    @property
    def ok(self) -> bool:
        return not self.missing


class ZooCluster:
    """Launch ``script`` as N worker processes.

    Each worker sees ZOO_TPU_COORDINATOR / ZOO_TPU_NUM_PROCESSES /
    ZOO_TPU_PROCESS_ID, the reference's contract; the port's workers run
    independently (no rendezvous yet: see the module docstring).
    """

    def __init__(self, num_processes: int,
                 coordinator: Optional[str] = None,
                 env: Optional[Dict[str, str]] = None,
                 run_dir: Optional[str] = None,
                 chaos=None):
        self.num_processes = int(num_processes)
        self.coordinator = coordinator or \
            f"localhost:{_free_port()}"
        self.extra_env = env or {}
        # fault injection (resilience.chaos.ChaosPlan or its JSON):
        # stamped into every worker env so scripted worker
        # kill/hang/slow faults fire deterministically in-process
        self.chaos = chaos
        self._first_death: Optional[Dict] = None
        self.monitor = ProcessMonitor()
        # observability plane: per-worker metrics slots + ports and a
        # shared clock anchor, manifested in run_dir/cluster.json
        self.run_dir = run_dir
        self.clock_anchor: Optional[float] = None
        self.worker_ports: Dict[int, int] = {}
        if run_dir:
            self._prepare_run_dir(run_dir)

    def _prepare_run_dir(self, run_dir: str) -> None:
        # imported lazily: the supervisor process doesn't need the
        # observability submodules loaded unless a run dir is in play
        from analytics_zoo_torch.observability import (
            aggregator as agg_lib)
        self.clock_anchor = time.time()
        hostname = socket.gethostname()
        workers = []
        from analytics_zoo_torch.resilience.detector import (
            HEARTBEAT_FILE)
        for pid in range(self.num_processes):
            wdir = os.path.join(run_dir,
                                agg_lib.host_dir_name(pid))
            os.makedirs(wdir, exist_ok=True)
            # a REUSED run dir may hold a previous run's heartbeat;
            # left in place it would make check_health flag a live,
            # still-initializing worker as stale (same reused-run_dir
            # contamination merge_traces already guards against)
            try:
                os.remove(os.path.join(wdir, HEARTBEAT_FILE))
            except OSError:
                pass
            self.worker_ports[pid] = _free_port()
            workers.append({
                "process_index": pid,
                "dir": agg_lib.host_dir_name(pid),
                "hostname": hostname,
                "metrics_port": self.worker_ports[pid],
            })
        from analytics_zoo_torch.common.fsutil import atomic_write_text
        # cluster.json is read by the reports while the run
        # is live — publish it whole or not at all
        atomic_write_text(
            os.path.join(run_dir, agg_lib.CLUSTER_FILE),
            json.dumps({
                "clock_anchor": self.clock_anchor,
                "num_processes": self.num_processes,
                "coordinator": self.coordinator,
                "workers": workers,
            }, indent=2))

    def worker_env(self, process_id: int) -> Dict[str, str]:
        env = dict(os.environ)
        env.update(self.extra_env)
        env.update({
            "ZOO_TPU_COORDINATOR": self.coordinator,
            "ZOO_TPU_NUM_PROCESSES": str(self.num_processes),
            "ZOO_TPU_PROCESS_ID": str(process_id),
        })
        if self.chaos is not None:
            from analytics_zoo_torch.resilience.chaos import ENV_CHAOS
            env[ENV_CHAOS] = (self.chaos if isinstance(self.chaos, str)
                              else self.chaos.to_json())
        if self.run_dir:
            from analytics_zoo_torch.observability import (
                aggregator as agg_lib)
            env.update({
                agg_lib.ENV_RUN_DIR: self.run_dir,
                agg_lib.ENV_METRICS_DIR: os.path.join(
                    self.run_dir, agg_lib.host_dir_name(process_id)),
                agg_lib.ENV_METRICS_PORT:
                    str(self.worker_ports[process_id]),
                agg_lib.ENV_CLOCK_ANCHOR: repr(self.clock_anchor),
            })
        return env

    def start(self, script: str, args: Sequence[str] = ()) -> None:
        for pid in range(self.num_processes):
            proc = subprocess.Popen(
                [sys.executable, script, *args],
                env=self.worker_env(pid),
                preexec_fn=_set_pdeathsig,
            )
            self.monitor.register(proc, index=pid)

    def wait(self, timeout: Optional[float] = None) -> WaitResult:
        """Wait for every worker; returns the exit-code list (ordered
        by process index, as before) as a :class:`WaitResult` that
        also records the observed EXIT ORDER and the first failure —
        on a pod, the first host to die is the root cause and the
        rest are collective-teardown collateral, so "which died
        first" is the question a flat code list cannot answer.

        Raises ``subprocess.TimeoutExpired`` when workers outlive
        ``timeout`` (unchanged contract)."""
        deadline = None if timeout is None else time.time() + timeout
        pending = dict(zip(self.monitor.indices, self.monitor.procs))
        by_index: Dict[int, int] = {}
        exit_order: List[tuple] = []
        from analytics_zoo_torch.resilience.policy import (
            DEGRADED_EXIT_CODE)
        while pending:
            for idx in sorted(pending):
                code = pending[idx].poll()
                if code is None:
                    continue
                del pending[idx]
                by_index[idx] = code
                exit_order.append((idx, code, time.time()))
                if code not in (0, DEGRADED_EXIT_CODE):
                    # exit-17 is the orderly checkpoint-and-queue
                    # protocol, not a death — it must never be named
                    # the root cause of a later real failure
                    self._record_death(idx, code)
            if not pending:
                break
            if deadline is not None and time.time() > deadline:
                raise subprocess.TimeoutExpired(
                    cmd=f"zoo-cluster({self.num_processes} workers)",
                    timeout=timeout)
            time.sleep(0.05)
        result = WaitResult([by_index[i] for i in sorted(by_index)])
        result.exit_order = exit_order
        for idx, code, _t in exit_order:
            if code not in (0, DEGRADED_EXIT_CODE):
                from analytics_zoo_torch.resilience.detector import (
                    classify_exit)
                result.first_failure = {
                    "process_index": idx, "code": code,
                    "classification": classify_exit(code)}
                break
        return result

    def _record_death(self, idx: int, code: int) -> None:
        if self._first_death is not None:
            return
        from analytics_zoo_torch.resilience.detector import classify_exit
        self._first_death = {
            "process_index": idx, "code": code,
            "classification": classify_exit(code),
            "observed_unix": round(time.time(), 3)}
        log.error("worker %d died first (%s) — later failures are "
                  "likely collateral", idx,
                  self._first_death["classification"])

    def check_health(self,
                     heartbeat_timeout_s: Optional[float] = None
                     ) -> ClusterHealth:
        """Classify worker liveness NOW — before a collective hangs on
        a dead peer.  Combines process polling (exit-code
        classification) with run-dir heartbeat staleness (a process
        can be alive but wedged in a dead collective: its heartbeat
        goes stale while poll() still says running).  Surfaces the
        ``cluster_hosts_expected``/``cluster_hosts_missing``
        gauges so dashboards see the loss the moment the launcher
        does."""
        states = self.monitor.poll_classified()
        dead_bad, exited_ok, running, degraded = [], set(), set(), []
        for s in states:
            if s["running"]:
                running.add(s["process_index"])
            elif s["classification"] == "ok":
                exited_ok.add(s["process_index"])
            elif s["classification"] == "degraded":
                # orderly checkpoint-and-queue exit: neither alive
                # nor missing — must not inflate cluster_hosts_missing
                degraded.append(s["process_index"])
            else:
                dead_bad.append(s)
        if dead_bad and self._first_death is None:
            self._record_death(dead_bad[0]["process_index"],
                               dead_bad[0]["code"])
        stale: List[int] = []
        if self.run_dir and running:
            from analytics_zoo_torch.common.config import get_config
            from analytics_zoo_torch.resilience.detector import stale_hosts
            if heartbeat_timeout_s is None:
                heartbeat_timeout_s = float(get_config().get(
                    "resilience.heartbeat_timeout_s", 30.0))
            # only among workers that have beaten at least once AND
            # are still supposed to be running: a worker that exited
            # (cleanly or not) stops beating by design, and one that
            # has not started training yet has nothing to report
            stale = [i for i in stale_hosts(self.run_dir,
                                            heartbeat_timeout_s)
                     if i in running]
        missing = sorted({s["process_index"] for s in dead_bad}
                         | set(stale))
        health = ClusterHealth(
            expected=self.num_processes,
            alive=len(running),
            missing=missing,
            first_death=self._first_death,
            states=states,
            degraded=sorted(degraded))
        self._export_health(health)
        if missing:
            log.error(
                "cluster hosts missing: %s (%d/%d alive) — collectives "
                "including them will hang; recover or re-form now",
                missing, health.alive, health.expected)
        return health

    def _export_health(self, health: ClusterHealth) -> None:
        # same gauge names the reference's aggregator derives offline, now
        # live from the launcher; best-effort by the usual contract
        try:
            from analytics_zoo_torch.observability import get_registry
            reg = get_registry()
            reg.gauge("cluster_hosts_expected",
                      "workers the launcher started").set(
                float(health.expected))
            reg.gauge("cluster_hosts_missing",
                      "workers dead or heartbeat-stale").set(
                float(len(health.missing)))
        except Exception:   # noqa: BLE001
            pass

    def stop(self) -> Dict[int, Optional[int]]:
        return self.monitor.stop_all()
