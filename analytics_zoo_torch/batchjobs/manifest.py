"""Shard manifest + lease ledger: the exactly-once commit protocol (port
of the JAX package's ``batchjobs/manifest.py``: the same files, so
either package's workers and reports read the other's ledger).

The coordinator partitions the dataset ONCE into a persisted
``manifest.json`` (shard id → row range → input fingerprint).  From
then on all coordination is files under ``<run_dir>/job/``:

* ``leases/shard-<id>.json`` — a worker's claim on a shard.  Created
  with ``O_CREAT|O_EXCL`` (the filesystem is the arbiter: exactly one
  creator wins).  Renewed every batch by atomic replace; a lease whose
  ``renewed_at`` is older than ``lease_timeout_s`` belongs to a dead
  or preempted worker and may be *stolen* — again by atomic replace,
  so two stealers racing still converge on one owner (renewal reads
  the file back and detects loss).
* ``commits/shard-<id>.json`` — the exactly-once marker, created with
  ``O_EXCL`` **after** the output shard's atomic write-then-rename.
  First creator wins; a racing duplicate sees ``FileExistsError``,
  counts itself as a duplicate, and releases.  Because scoring is
  deterministic, the loser's already-renamed output bytes are
  identical to the winner's — last-rename-wins never changes content.

Crash windows, audited:

* die holding a lease → lease lapses, shard is stolen, recompute.
* die after output rename, before marker → recompute produces
  byte-identical output; the rename is a no-op content-wise; marker
  then lands.  Never a torn or half shard visible (rename is atomic).
* marker exists but fingerprint ≠ manifest (spec changed between
  runs) → marker is ignored and the shard recomputed: a commit is
  only trusted for the exact (shard_id, input fingerprint) it names.

CONTRACT: stdlib-only (the CLI's ``report`` imports no torch).
"""

from __future__ import annotations

import json
import os
import socket
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from . import spec as _spec

__all__ = [
    "ShardManifest", "LeaseClient", "LeaseLost", "shard_lease_path",
    "shard_commit_path", "shard_output_path", "read_leases",
    "read_commits",
]


class LeaseLost(RuntimeError):
    """Raised when a renewal discovers the lease was stolen — the
    worker must abandon the shard (the thief recomputes it)."""


def _flight(kind: str, **detail) -> None:
    """Best-effort flight-recorder event.  Guarded lazy import: this
    module stays stdlib-only at import time."""
    try:
        from analytics_zoo_torch.observability.flightrec import (
            record_event)
        record_event(kind, **detail)
    except Exception:   # noqa: BLE001 — forensics never blocks leasing
        pass


def shard_lease_path(run_dir: str, shard_id: int) -> str:
    return os.path.join(
        _spec.job_dir(run_dir), _spec.LEASE_DIR, f"shard-{shard_id:05d}.json")


def shard_commit_path(run_dir: str, shard_id: int) -> str:
    return os.path.join(
        _spec.job_dir(run_dir), _spec.COMMIT_DIR, f"shard-{shard_id:05d}.json")


def shard_output_path(output_dir: str, shard_id: int) -> str:
    return os.path.join(output_dir, f"shard-{shard_id:05d}.npy")


def _write_json_atomic(path: str, doc: Dict[str, Any]) -> None:
    # local twin of common.fsutil.atomic_write_text, hand-rolled on
    # purpose: this module is stdlib-only, and lease/commit markers
    # additionally
    # fsync before the rename — the exactly-once protocol trusts the
    # marker only if its bytes are durable
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(doc, f, sort_keys=True)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def _read_json(path: str) -> Optional[Dict[str, Any]]:
    try:
        with open(path) as f:
            return json.load(f)
    except (FileNotFoundError, json.JSONDecodeError):
        # a concurrent atomic replace never leaves a torn file, but the
        # file may vanish (release) between listdir and open
        return None


class ShardManifest:
    """The persisted partition of a job: the ground truth every
    incarnation of every worker and the coordinator agree on."""

    def __init__(self, doc: Dict[str, Any], run_dir: str):
        self.doc = doc
        self.run_dir = run_dir

    # ------------------------------------------------------------- create
    @classmethod
    def create(cls, job: "_spec.BatchJobSpec", run_dir: str) -> "ShardManifest":
        """Partition ``job`` and persist the manifest (idempotent: an
        existing manifest for the same job geometry is reused so a
        resumed coordinator sees the SAME partition)."""
        jdir = _spec.job_dir(run_dir)
        os.makedirs(os.path.join(jdir, _spec.LEASE_DIR), exist_ok=True)
        os.makedirs(os.path.join(jdir, _spec.COMMIT_DIR), exist_ok=True)
        if job.output_dir:
            os.makedirs(job.output_dir, exist_ok=True)

        path = os.path.join(jdir, _spec.MANIFEST_FILE)
        shards = []
        for sid in range(job.num_shards()):
            start, end = job.shard_range(sid)
            shards.append({
                "shard_id": sid, "start": start, "end": end,
                "fingerprint": job.shard_fingerprint(sid),
            })
        doc = {
            "job": job.name,
            "num_rows": job.resolved_rows(),
            "rows_per_shard": job.rows_per_shard,
            "lease_timeout_s": job.lease_timeout_s,
            "output_dir": job.output_dir,
            "shards": shards,
        }
        existing = _read_json(path)
        if existing is not None:
            if existing.get("shards") != shards:
                raise RuntimeError(
                    f"{path}: existing manifest partitions a different job "
                    "— refusing to mix output shards (use a fresh run dir)")
            doc = existing
        else:
            _write_json_atomic(path, doc)
        _write_json_atomic(os.path.join(jdir, _spec.JOB_FILE), job.to_dict())
        return cls(doc, run_dir)

    @classmethod
    def load(cls, run_dir: str) -> "ShardManifest":
        path = os.path.join(_spec.job_dir(run_dir), _spec.MANIFEST_FILE)
        doc = _read_json(path)
        if doc is None:
            raise FileNotFoundError(f"no shard manifest at {path}")
        return cls(doc, run_dir)

    # ------------------------------------------------------------ queries
    @property
    def shards(self) -> List[Dict[str, Any]]:
        return self.doc["shards"]

    @property
    def lease_timeout_s(self) -> float:
        return float(self.doc.get("lease_timeout_s", 30.0))

    def shard(self, shard_id: int) -> Dict[str, Any]:
        return self.shards[shard_id]

    def committed(self) -> Dict[int, Dict[str, Any]]:
        """shard_id → commit marker, for markers whose fingerprint
        still matches the manifest (stale markers are not trusted)."""
        out = {}
        for s in self.shards:
            marker = _read_json(shard_commit_path(self.run_dir, s["shard_id"]))
            if marker and marker.get("fingerprint") == s["fingerprint"]:
                out[s["shard_id"]] = marker
        return out

    def pending(self) -> List[Dict[str, Any]]:
        done = self.committed()
        return [s for s in self.shards if s["shard_id"] not in done]

    def progress(self) -> Dict[str, Any]:
        done = self.committed()
        rows_done = sum(m.get("rows", 0) for m in done.values())
        return {
            "shards_total": len(self.shards),
            "shards_committed": len(done),
            "rows_total": int(self.doc["num_rows"]),
            "rows_committed": rows_done,
            "rows_recomputed": sum(
                m.get("recomputed_rows", 0) for m in done.values()),
            "duplicates": sum(
                int(m.get("duplicates", 0)) for m in done.values()),
            "complete": len(done) == len(self.shards),
        }


class LeaseClient:
    """One worker's handle on the shard ledger.

    The claim→settle loop it supports is the same obligation shape the
    serving consumer carries (zoolint ACK013): every shard returned by
    :meth:`claim_shards` MUST reach exactly one of ``commit_shard``,
    ``release_shard``, or a propagated raise — the lint now checks
    that statically for the reference's ``batchjobs/``).
    """

    def __init__(self, run_dir: str, owner: str = None, *,
                 timeout_s: float = None,
                 clock: Callable[[], float] = time.time):
        self.run_dir = run_dir
        self.manifest = ShardManifest.load(run_dir)
        self.owner = owner or f"{socket.gethostname()}:{os.getpid()}"
        self.timeout_s = (self.manifest.lease_timeout_s
                          if timeout_s is None else float(timeout_s))
        self._clock = clock
        # resume bookkeeping: rows a stolen lease's victim had already
        # scored — the recompute cost this incarnation is paying
        self._stolen_rows: Dict[int, int] = {}

    # ------------------------------------------------------------- claim
    def claim_shards(self, limit: int = 1) -> List[Tuple[int, Dict[str, Any]]]:
        """Claim up to ``limit`` uncommitted, unleased (or
        expired-lease) shards.  Returns ``(shard_id, shard)`` pairs;
        every returned shard carries the settle obligation above."""
        claimed: List[Tuple[int, Dict[str, Any]]] = []
        for s in self.manifest.pending():
            if len(claimed) >= limit:
                break
            sid = s["shard_id"]
            if self._try_acquire(sid):
                claimed.append((sid, s))
        return claimed

    def _lease_doc(self, shard_id: int, rows_done: int = 0) -> Dict[str, Any]:
        now = self._clock()
        return {
            "shard_id": shard_id, "owner": self.owner,
            "created_at": now, "renewed_at": now, "rows_done": rows_done,
        }

    def _try_acquire(self, shard_id: int) -> bool:
        path = shard_lease_path(self.run_dir, shard_id)
        doc = self._lease_doc(shard_id)
        try:
            fd = os.open(path, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
        except FileExistsError:
            return self._try_steal(shard_id, path)
        with os.fdopen(fd, "w") as f:
            json.dump(doc, f)
            f.flush()
            os.fsync(f.fileno())
        _flight("lease.claim", shard=shard_id, owner=self.owner)
        return True

    def _try_steal(self, shard_id: int, path: str) -> bool:
        held = _read_json(path)
        if held is None:
            # released between listdir and read — retry the O_EXCL path
            # on the next claim round rather than spinning here
            return False
        if held.get("owner") == self.owner:
            return True  # our own (e.g. re-claim after coordinator restart)
        age = self._clock() - float(held.get("renewed_at", 0.0))
        if age <= self.timeout_s:
            return False  # live lease — someone else is scoring it
        # expired: the owner is dead or preempted.  Steal by atomic
        # replace; the victim's rows_done is the recompute debt.
        self._stolen_rows[shard_id] = int(held.get("rows_done", 0))
        _write_json_atomic(path, self._lease_doc(shard_id))
        _flight("lease.steal", shard=shard_id, owner=self.owner,
                victim=str(held.get("owner", "")),
                stolen_rows=self._stolen_rows[shard_id],
                age_s=round(age, 3))
        return True

    # ------------------------------------------------------------- renew
    def renew(self, shard_id: int, rows_done: int = 0) -> None:
        """Refresh the lease (call every batch).  Raises
        :class:`LeaseLost` if the lease was stolen — the caller must
        stop scoring this shard and claim another."""
        path = shard_lease_path(self.run_dir, shard_id)
        held = _read_json(path)
        if held is None or held.get("owner") != self.owner:
            thief = held.get("owner") if held else "release"
            _flight("lease.lost", shard=shard_id, owner=self.owner,
                    to=str(thief))
            raise LeaseLost(f"shard {shard_id}: lease lost to {thief}")
        held["renewed_at"] = self._clock()
        held["rows_done"] = int(rows_done)
        _write_json_atomic(path, held)

    # ------------------------------------------------------------ settle
    def commit_shard(self, shard_id: int, *, fingerprint: str,
                     rows: int, seconds: float = 0.0) -> bool:
        """Settle a claim as done: write the exactly-once marker and
        drop the lease.  Returns True if THIS call created the marker,
        False if a racing duplicate got there first (either way the
        obligation is discharged and the shard is committed)."""
        path = shard_commit_path(self.run_dir, shard_id)
        doc = {
            "shard_id": shard_id, "fingerprint": fingerprint,
            "rows": int(rows), "seconds": float(seconds),
            "owner": self.owner, "committed_at": self._clock(),
            "recomputed_rows": int(self._stolen_rows.pop(shard_id, 0)),
            "duplicates": 0,
        }
        created = True
        try:
            fd = os.open(path, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
            with os.fdopen(fd, "w") as f:
                json.dump(doc, f, sort_keys=True)
                f.flush()
                os.fsync(f.fileno())
        except FileExistsError:
            created = False
            existing = _read_json(path)
            if existing is not None:
                existing["duplicates"] = int(existing.get("duplicates", 0)) + 1
                _write_json_atomic(path, existing)
        self.release_shard(shard_id)
        return created

    def release_shard(self, shard_id: int) -> None:
        """Settle a claim as abandoned: drop the lease so another
        worker can claim immediately (no timeout wait)."""
        path = shard_lease_path(self.run_dir, shard_id)
        held = _read_json(path)
        if held is not None and held.get("owner") == self.owner:
            try:
                os.unlink(path)
            except FileNotFoundError:
                pass


# --------------------------------------------------------------- reports
def read_leases(run_dir: str) -> List[Dict[str, Any]]:
    ldir = os.path.join(_spec.job_dir(run_dir), _spec.LEASE_DIR)
    out = []
    try:
        names = sorted(os.listdir(ldir))
    except FileNotFoundError:
        return out
    for name in names:
        doc = _read_json(os.path.join(ldir, name))
        if doc is not None:
            out.append(doc)
    return out


def read_commits(run_dir: str) -> List[Dict[str, Any]]:
    cdir = os.path.join(_spec.job_dir(run_dir), _spec.COMMIT_DIR)
    out = []
    try:
        names = sorted(os.listdir(cdir))
    except FileNotFoundError:
        return out
    for name in names:
        doc = _read_json(os.path.join(cdir, name))
        if doc is not None:
            out.append(doc)
    return out
