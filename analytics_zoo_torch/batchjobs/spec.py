"""BatchJobSpec — the declarative description of one offline scoring job
(port of the JAX package's ``batchjobs/spec.py``: the same code, so the
same ``job.json`` bytes and fingerprints for the same fields).

Reference: NNFrames/NNEstimator ``transform``-style batch inference
(SURVEY.md L7; BigDL arXiv 1804.05839, BigDL 2.0 arXiv 2204.01715) —
"score this dataset with this model, write the results" as a *job*,
not a serving request stream.  The job is a JSON document binding
three things:

* an **input**: a :class:`~analytics_zoo_torch.data.source.Source`
  builder (``module:function`` or ``/path/to/file.py:function``) or an
  ``NpyDirSource`` directory — the random-access contract is what makes
  shard partitioning trivial and deterministic;
* a **model**: a builder returning anything with ``.predict(x)``
  (an ``InferenceModel``, a zoo ``KerasNet``, or a serving
  ``Endpoint`` — the worker unwraps/warms each);
* an **output sink**: a directory of committed ``shard-<id>.npy``
  files whose in-order concatenation IS the scored dataset.

The spec is the single artifact that crosses the coordinator/worker
boundary: the torch-free coordinator partitions and supervises from it,
workers reconstruct source+model from it.  CONTRACT: this module is
stdlib-only (``python -m analytics_zoo_torch.batchjobs.cli report``
renders a ledger without importing torch).
"""

from __future__ import annotations

import ast
import dataclasses
import hashlib
import json
import os
import struct
import zlib
from typing import Any, Dict, Optional

SPEC_VERSION = 1

#: file names under ``<run_dir>/job/``
JOB_DIR = "job"
JOB_FILE = "job.json"
MANIFEST_FILE = "manifest.json"
REPORT_FILE = "report.json"
LEASE_DIR = "leases"
COMMIT_DIR = "commits"

ENV_BATCH_JOB = "ZOO_TPU_BATCH_JOB"


def job_dir(run_dir: str) -> str:
    return os.path.join(run_dir, JOB_DIR)


@dataclasses.dataclass
class BatchJobSpec:
    """One offline scoring/transform job.

    Args:
        name: job label (rides metric labels and the report).
        source: input binding — ``{"kind": "builder", "ref":
            "module:fn" | "/path.py:fn", "args": {...}}`` or
            ``{"kind": "npy_dir", "path": DIR}``.
        model: model binding — ``{"kind": "builder", "ref": ...,
            "args": {...}}``.
        output_dir: committed output shards land here as
            ``shard-<id>.npy`` (created if absent).
        num_rows: dataset length.  Required for builder sources (the
            torch-free coordinator cannot construct the source to ask);
            derived from the ``x.npy`` header for ``npy_dir``.
        rows_per_shard: partition granularity — also the resume
            granularity bound: a preempted worker loses AT MOST one
            shard of work.
        batch_size: rows per device batch inside a shard.
        lease_timeout_s: a lease not renewed for this long is
            reclaimable — renewal happens every batch, so this is the
            preemption-detection latency at the shard ledger.
        target_deadline_s: the capacity report answers "how many chips
            to finish a dataset like this inside this deadline".
    """

    name: str = "batch-job"
    source: Dict[str, Any] = dataclasses.field(default_factory=dict)
    model: Dict[str, Any] = dataclasses.field(default_factory=dict)
    output_dir: str = ""
    num_rows: Optional[int] = None
    rows_per_shard: int = 1024
    batch_size: int = 128
    lease_timeout_s: float = 30.0
    target_deadline_s: float = 3600.0

    def __post_init__(self):
        self.rows_per_shard = int(self.rows_per_shard)
        self.batch_size = int(self.batch_size)
        if self.rows_per_shard <= 0:
            raise ValueError("rows_per_shard must be positive")
        if self.batch_size <= 0:
            raise ValueError("batch_size must be positive")

    # ------------------------------------------------------------ geometry
    def resolved_rows(self) -> int:
        """Dataset length, from the spec or (npy_dir) the npy header —
        header-only, so the torch-free coordinator never maps the data."""
        if self.num_rows is not None:
            return int(self.num_rows)
        if self.source.get("kind") == "npy_dir":
            return npy_rows(os.path.join(self.source["path"], "x.npy"))
        raise ValueError(
            "num_rows is required for builder sources (the coordinator "
            "partitions without constructing the source)")

    def num_shards(self) -> int:
        rows = self.resolved_rows()
        return (rows + self.rows_per_shard - 1) // self.rows_per_shard

    def shard_range(self, shard_id: int) -> tuple:
        rows = self.resolved_rows()
        start = shard_id * self.rows_per_shard
        return start, min(start + self.rows_per_shard, rows)

    # --------------------------------------------------------- fingerprint
    def shard_fingerprint(self, shard_id: int) -> str:
        """Content key of one shard's INPUT: the source/model identity
        plus the exact row range.  A commit marker carries this; on
        resume a marker whose fingerprint no longer matches the
        manifest describes a DIFFERENT computation and is recomputed
        instead of trusted."""
        start, end = self.shard_range(shard_id)
        doc = json.dumps({
            "source": self.source, "model": self.model,
            "batch_size": self.batch_size,
            "shard_id": shard_id, "start": start, "end": end,
        }, sort_keys=True)
        return hashlib.sha256(doc.encode()).hexdigest()[:32]

    # -------------------------------------------------------- serialization
    def to_dict(self) -> Dict[str, Any]:
        out = dataclasses.asdict(self)
        out["version"] = SPEC_VERSION
        return out

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "BatchJobSpec":
        d = dict(d)
        version = int(d.pop("version", SPEC_VERSION))
        if version != SPEC_VERSION:
            raise ValueError(
                f"batch job spec version {version} != {SPEC_VERSION}")
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2, sort_keys=True)

    @classmethod
    def from_json(cls, raw: str) -> "BatchJobSpec":
        return cls.from_dict(json.loads(raw))

    @classmethod
    def load(cls, run_dir: str) -> "BatchJobSpec":
        with open(os.path.join(job_dir(run_dir), JOB_FILE)) as f:
            return cls.from_dict(json.load(f))


def npy_rows(path: str) -> int:
    """Leading-axis length of a ``.npy`` file from its HEADER alone
    (stdlib: magic + struct + ast.literal_eval) — no numpy import, no
    data mapping, so the coordinator stays torch/numpy-free."""
    with open(path, "rb") as f:
        magic = f.read(6)
        if magic != b"\x93NUMPY":
            raise ValueError(f"{path}: not an npy file")
        major, _minor = f.read(1)[0], f.read(1)[0]
        if major == 1:
            (hlen,) = struct.unpack("<H", f.read(2))
        else:
            (hlen,) = struct.unpack("<I", f.read(4))
        header = ast.literal_eval(f.read(hlen).decode("latin1"))
    shape = header.get("shape", ())
    if not shape:
        raise ValueError(f"{path}: scalar npy has no row axis")
    return int(shape[0])


def input_crc(path: str, max_bytes: int = 1 << 20) -> int:
    """Cheap content check over a file head (crc32) — used by the
    demo/test sources to make fingerprints content-sensitive without
    hashing terabytes."""
    crc = 0
    with open(path, "rb") as f:
        chunk = f.read(max_bytes)
        crc = zlib.crc32(chunk, crc)
    return crc
