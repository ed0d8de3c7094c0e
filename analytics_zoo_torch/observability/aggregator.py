"""Cluster-wide observability plane (port of the JAX package's
``observability/aggregator.py``): federate per-worker registries into
cluster views, attribute stragglers, and merge per-host traces and
request logs.

* **run directory** — the launcher (``parallel/launcher.py``) or the
  serving supervisor gives every worker ``<run_dir>/host-<k>/`` plus a
  metrics port and a shared clock anchor; workers drop ``meta.json`` /
  ``metrics.jsonl`` / ``trace.json`` / ``requests.json`` there and
  sample the TSDB into ``tsdb/`` (:func:`init_worker_observability`,
  :func:`flush_worker_observability`).
* **federation** — :class:`ClusterAggregator` pulls each worker's
  snapshot (HTTP ``/metrics.json`` while live, JSONL merge offline)
  and merges: counters summed, histograms merged bucket-wise, gauges
  kept as per-host vectors.  Host 0's :class:`MetricsServer` exposes
  the result at ``/metrics/cluster``.
* **attribution** — :func:`straggler_report`: per-host mean step wall,
  barrier-wait share, max−median skew (the straggler), pipeline bubble
  fraction, and the collective byte/time accounting when a worker
  records it.
* **trace merge** — :func:`merge_traces` aligns per-host Chrome traces
  on the launcher's clock anchor into one cluster timeline;
  :func:`merge_requests` joins the request timelines by trace id.

Every artifact is the JAX package's, byte for byte, so either
package's tools read the other's run dirs.

IMPORT DISCIPLINE: module level is stdlib-only (no torch, no numpy),
as in the reference: the merge runs on a host with neither.  The
registry, tracer, request log, TSDB and recorder are imported lazily
inside the functions, by plain imports of this package's modules.
"""

from __future__ import annotations

import json
import logging
import os
import socket
import threading
import time
import urllib.request
from typing import Callable, Dict, List, Optional, Tuple

log = logging.getLogger("analytics_zoo_torch.observability")

CLUSTER_FILE = "cluster.json"      # written by the launcher
META_FILE = "meta.json"            # written by each worker
METRICS_FILE = "metrics.jsonl"     # registry snapshots, append-only
TRACE_FILE = "trace.json"          # Chrome trace per worker
REQUESTS_FILE = "requests.json"    # request-timeline log per worker

# env contract injected by the launcher (parallel/launcher.py)
ENV_RUN_DIR = "ZOO_TPU_RUN_DIR"
ENV_METRICS_DIR = "ZOO_TPU_METRICS_DIR"
ENV_METRICS_PORT = "ZOO_TPU_METRICS_PORT"
ENV_CLOCK_ANCHOR = "ZOO_TPU_CLOCK_ANCHOR"
ENV_PROCESS_ID = "ZOO_TPU_PROCESS_ID"


def host_dir_name(process_index: int) -> str:
    return f"host-{int(process_index)}"


# ---------------------------------------------------------- key parsing
def parse_series_key(key: str) -> Tuple[str, Tuple[Tuple[str, str], ...]]:
    """Split a snapshot series key ``name{a="x",b="y"}`` into
    ``(name, ((a, x), (b, y)))``; label-free keys give ``(key, ())``.
    Handles the registry's label-value escaping (\\\\, \\n, \\")."""
    if "{" not in key:
        return key, ()
    name, _, rest = key.partition("{")
    body = rest.rsplit("}", 1)[0]
    pairs: List[Tuple[str, str]] = []
    i = 0
    while i < len(body):
        eq = body.index("=", i)
        lname = body[i:eq]
        # value starts at eq+2 (skip the opening quote)
        j = eq + 2
        val = []
        while j < len(body):
            ch = body[j]
            if ch == "\\" and j + 1 < len(body):
                val.append({"n": "\n"}.get(body[j + 1], body[j + 1]))
                j += 2
                continue
            if ch == '"':
                break
            val.append(ch)
            j += 1
        pairs.append((lname, "".join(val)))
        i = j + 1
        if i < len(body) and body[i] == ",":
            i += 1
    return name, tuple(pairs)


def format_series_key(name: str,
                      pairs: Tuple[Tuple[str, str], ...]) -> str:
    if not pairs:
        return name
    def esc(v: str) -> str:
        return (v.replace("\\", r"\\").replace("\n", r"\n")
                .replace('"', r'\"'))
    body = ",".join(f'{k}="{esc(v)}"' for k, v in pairs)
    return f"{name}{{{body}}}"


def with_label(key: str, label: str, value: str) -> str:
    """Append one label to a series key (skips if already present)."""
    name, pairs = parse_series_key(key)
    if any(k == label for k, _ in pairs):
        return key
    return format_series_key(name, pairs + ((label, str(value)),))


# ------------------------------------------------------- snapshot merge
def _merge_histogram(acc: Dict, h: Dict) -> Dict:
    """Merge one host's histogram summary into the accumulator.
    Bucket-wise when both carry the same ladder (exact merged
    percentiles); degrades to count/sum only on a ladder mismatch."""
    if acc is None:
        return {
            "count": int(h.get("count", 0)),
            "sum": float(h.get("sum", 0.0)),
            "le": list(h.get("le") or []),
            "cum": list(h.get("cum") or []),
        }
    acc["count"] += int(h.get("count", 0))
    acc["sum"] += float(h.get("sum", 0.0))
    if acc.get("le") and acc["le"] == list(h.get("le") or []):
        acc["cum"] = [a + b for a, b in zip(acc["cum"], h["cum"])]
    else:
        acc["le"], acc["cum"] = [], []
    return acc


def _histogram_percentile(le: List[float], cum: List[int],
                          count: int, p: float) -> float:
    """Same convention as _HistogramChild.percentile: the bound of the
    first cumulative bucket covering p% of the count."""
    if count <= 0:
        return 0.0
    target = p / 100.0 * count
    for bound, c in zip(le, cum):
        if c >= target:
            return bound
    return le[-1] if le else 0.0


def merge_snapshots(host_snaps: Dict[str, Dict]) -> Dict:
    """Federate per-host registry snapshots into ONE cluster snapshot:

    * counters — summed across hosts (cluster totals);
    * histograms — merged bucket-wise (count/sum/recomputed p50/p95/p99);
    * gauges — kept as a per-host vector: each series gains a
      ``host`` label (a gauge like queue depth has no meaningful sum).

    ``host_snaps`` maps a host label (e.g. ``"hostname/0"``) to that
    worker's ``MetricsRegistry.snapshot()``.
    """
    out: Dict[str, Dict] = {"counters": {}, "gauges": {},
                            "histograms": {}}
    hists: Dict[str, Optional[Dict]] = {}
    for host in sorted(host_snaps):
        snap = host_snaps[host] or {}
        for key, val in (snap.get("counters") or {}).items():
            out["counters"][key] = out["counters"].get(key, 0.0) \
                + float(val)
        for key, val in (snap.get("gauges") or {}).items():
            out["gauges"][with_label(key, "host", host)] = float(val)
        for key, h in (snap.get("histograms") or {}).items():
            hists[key] = _merge_histogram(hists.get(key), h)
    for key, h in hists.items():
        le, cum, count = h.get("le") or [], h.get("cum") or [], h["count"]
        merged = {"count": count, "sum": round(h["sum"], 6)}
        if le:
            for p in (50, 95, 99):
                merged[f"p{p}"] = _histogram_percentile(le, cum, count, p)
            merged["le"], merged["cum"] = le, cum
        else:   # ladder mismatch across hosts: percentiles undefined
            merged["p50"] = merged["p95"] = merged["p99"] = 0.0
        out["histograms"][key] = merged
    return out


def snapshot_prometheus_text(snap: Dict, prefix_help: str = "") -> str:
    """Render a (merged) snapshot back into Prometheus text exposition
    — what ``/metrics/cluster`` serves.  Histograms keep their bucket
    lines when the merged bucket data survived."""
    lines: List[str] = []
    for key in sorted(snap.get("counters", {})):
        name, _ = parse_series_key(key)
        lines.append(f"{key} {_num(snap['counters'][key])}")
    for key in sorted(snap.get("gauges", {})):
        lines.append(f"{key} {_num(snap['gauges'][key])}")
    for key in sorted(snap.get("histograms", {})):
        h = snap["histograms"][key]
        name, pairs = parse_series_key(key)
        for bound, c in zip(h.get("le") or [], h.get("cum") or []):
            lines.append(
                format_series_key(
                    name + "_bucket",
                    pairs + (("le", _num(bound)),)) + f" {c}")
        if h.get("le"):
            lines.append(
                format_series_key(name + "_bucket",
                                  pairs + (("le", "+Inf"),))
                + f" {h['count']}")
        lines.append(f"{name}_sum"
                     f"{format_series_key('', pairs)} {_num(h['sum'])}"
                     if pairs else f"{name}_sum {_num(h['sum'])}")
        lines.append(f"{name}_count"
                     f"{format_series_key('', pairs)} {h['count']}"
                     if pairs else f"{name}_count {h['count']}")
    return "\n".join(lines) + "\n"


def _num(v) -> str:
    f = float(v)
    if f.is_integer() and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


# --------------------------------------------------------- attribution
def _hist_totals(snap: Dict, metric: str) -> Tuple[int, float, float]:
    """(count, sum, p50) aggregated over every label variant of one
    histogram family in one host's snapshot."""
    count, total, p50s = 0, 0.0, []
    for key, h in (snap.get("histograms") or {}).items():
        name, _ = parse_series_key(key)
        if name != metric or not h.get("count"):
            continue
        count += int(h["count"])
        total += float(h["sum"])
        p50s.append(float(h.get("p50", 0.0)))
    return count, total, max(p50s) if p50s else 0.0


def _gauge_max(snap: Dict, metric: str) -> Optional[float]:
    vals = [float(v) for key, v in (snap.get("gauges") or {}).items()
            if parse_series_key(key)[0] == metric]
    return max(vals) if vals else None


def _median(vals: List[float]) -> float:
    s = sorted(vals)
    n = len(s)
    if not n:
        return 0.0
    return s[n // 2] if n % 2 else 0.5 * (s[n // 2 - 1] + s[n // 2])


def straggler_report(host_snaps: Dict[str, Dict],
                     step_metric: str = "train_step_latency_seconds",
                     barrier_metric: str = "train_barrier_wait_seconds",
                     skew_threshold: float = 0.10) -> Dict:
    """Cross-host skew and collective attribution.

    Per host: mean/p50 step wall (``step_metric``) and mean barrier
    wait (``barrier_metric`` — the time the FASTER hosts spend parked
    in the sampled cross-host sync, so a near-zero barrier wait plus
    the highest step time is the straggler signature).  Cluster level:
    max−median step-time skew; the max host is named straggler when
    the skew fraction exceeds ``skew_threshold``.  Also surfaces the
    worst pipeline bubble fraction and the summed collective
    byte/second counters (observability/collectives.py).
    """
    per_host: Dict[str, Dict] = {}
    for host, snap in host_snaps.items():
        n, total, p50 = _hist_totals(snap, step_metric)
        bn, btotal, _ = _hist_totals(snap, barrier_metric)
        per_host[host] = {
            "steps": n,
            "mean_step_s": total / n if n else 0.0,
            "p50_step_s": p50,
            "mean_barrier_wait_s": btotal / bn if bn else 0.0,
            "pipeline_bubble_fraction":
                _gauge_max(snap, "pipeline_bubble_fraction"),
        }
    means = {h: d["mean_step_s"] for h, d in per_host.items()
             if d["steps"]}
    report: Dict = {"hosts": sorted(host_snaps), "per_host": per_host,
                    "straggler": None, "skew_seconds": 0.0,
                    "skew_fraction": 0.0}
    if len(means) >= 2:
        med = _median(list(means.values()))
        worst = max(means, key=lambda h: means[h])
        skew = means[worst] - med
        frac = skew / med if med > 0 else 0.0
        report["median_step_s"] = med
        report["skew_seconds"] = skew
        report["skew_fraction"] = frac
        if frac > skew_threshold:
            report["straggler"] = worst
    bubbles = [d["pipeline_bubble_fraction"] for d in per_host.values()
               if d["pipeline_bubble_fraction"] is not None]
    if bubbles:
        report["pipeline_bubble_fraction"] = max(bubbles)
    # collective accounting: cluster-summed bytes/seconds per op
    coll: Dict[str, Dict[str, float]] = {}
    for snap in host_snaps.values():
        for key, val in (snap.get("counters") or {}).items():
            name, pairs = parse_series_key(key)
            if name not in ("collective_bytes_total",
                            "collective_seconds_total"):
                continue
            op = dict(pairs).get("op", "?")
            field = "bytes" if name == "collective_bytes_total" \
                else "seconds"
            coll.setdefault(op, {"bytes": 0.0, "seconds": 0.0})
            coll[op][field] += float(val)
    if coll:
        report["collectives"] = coll
    return report


def cluster_gauges(report: Dict) -> Dict[str, float]:
    """The straggler report distilled into scrapeable gauges — merged
    into the ``/metrics/cluster`` exposition so alerting needs no
    report parsing."""
    out: Dict[str, float] = {
        "cluster_hosts": float(len(report.get("hosts", []))),
        "cluster_step_skew_seconds": float(
            report.get("skew_seconds", 0.0)),
        "cluster_step_skew_fraction": float(
            report.get("skew_fraction", 0.0)),
    }
    if report.get("pipeline_bubble_fraction") is not None:
        out["cluster_pipeline_bubble_fraction"] = float(
            report["pipeline_bubble_fraction"])
    for host in report.get("hosts", []):
        is_straggler = 1.0 if host == report.get("straggler") else 0.0
        out[format_series_key("cluster_is_straggler",
                              (("host", host),))] = is_straggler
    return out


# ------------------------------------------------------------ federation
class WorkerSource:
    """One worker's snapshot source: live HTTP endpoint (preferred)
    with the run-dir JSONL as offline fallback."""

    def __init__(self, name: str, url: Optional[str] = None,
                 path: Optional[str] = None,
                 fetch: Optional[Callable[[], Dict]] = None):
        self.name = name              # host label, e.g. "tpu-a/0"
        self.url = url                # http://host:port (no trailing /)
        self.path = path              # <run_dir>/host-<k>
        self._fetch = fetch           # injectable (tests)

    def snapshot(self, timeout_s: float = 2.0) -> Optional[Dict]:
        if self._fetch is not None:
            try:
                return self._fetch()
            except Exception:
                return None
        if self.url:
            try:
                with urllib.request.urlopen(
                        self.url.rstrip("/") + "/metrics.json",
                        timeout=timeout_s) as resp:
                    return json.loads(resp.read().decode())
            except Exception:
                pass   # fall back to the offline file
        if self.path:
            return _last_jsonl_snapshot(
                os.path.join(self.path, METRICS_FILE))
        return None


def _last_jsonl_snapshot(path: str) -> Optional[Dict]:
    """Latest snapshot record of an append-only registry JSONL.

    Reads from the TAIL (expanding window) and scans lines newest-
    first: the live aggregator calls this per scrape for every worker
    that fell back to its file, and a long run's per-epoch flushes
    grow the file without bound — parsing the whole history per
    scrape would put O(file) work inside the HTTP handler."""
    try:
        size = os.path.getsize(path)
    except OSError:
        return None
    window = 1 << 18
    with open(path, "rb") as f:
        while True:
            start = max(0, size - window)
            f.seek(start)
            chunk = f.read(size - start)
            lines = chunk.splitlines()
            if start > 0:
                lines = lines[1:]   # first line may be cut mid-record
            for raw in reversed(lines):
                raw = raw.strip()
                if not raw:
                    continue
                try:
                    rec = json.loads(raw.decode())
                except (json.JSONDecodeError, UnicodeDecodeError):
                    continue   # torn tail line of a crashed worker
                if isinstance(rec, dict) and \
                        isinstance(rec.get("metrics"), dict):
                    return rec["metrics"]
                if isinstance(rec, dict) and "counters" in rec:
                    return rec
            if start == 0:
                return None
            window *= 4


def load_meta(worker_dir: str) -> Dict:
    try:
        with open(os.path.join(worker_dir, META_FILE)) as f:
            return json.load(f)
    except Exception:
        return {}


class ClusterAggregator:
    """Host-0's federation point over the workers of one run.

    ``collect()`` pulls every worker's latest snapshot (HTTP when the
    worker is live, run-dir JSONL otherwise); ``cluster_snapshot()``
    merges them and folds in the straggler report;
    ``prometheus_text()`` renders the merged view for the
    ``/metrics/cluster`` route.
    """

    def __init__(self, sources: List[WorkerSource],
                 timeout_s: float = 2.0,
                 skew_threshold: float = 0.10):
        self.sources = list(sources)
        self.timeout_s = float(timeout_s)
        self.skew_threshold = float(skew_threshold)

    @classmethod
    def from_run_dir(cls, run_dir: str, offline: bool = False,
                     **kw) -> "ClusterAggregator":
        """Build sources from ``cluster.json`` (launcher manifest) or,
        absent that, by scanning ``host-*/`` worker dirs.

        ``offline=True`` (what ``obs_report --merge-hosts`` uses)
        reads ONLY the on-disk snapshots: a finished run's recorded
        host:port may have been reused by an unrelated process, and
        scraping it would silently merge someone else's registry into
        this run's report (it also avoids per-host connect timeouts on
        an scp'd run dir whose pod hostnames don't resolve)."""
        sources: List[WorkerSource] = []
        manifest = {}
        try:
            with open(os.path.join(run_dir, CLUSTER_FILE)) as f:
                manifest = json.load(f)
        except Exception:
            manifest = {}
        workers = manifest.get("workers")
        if workers:
            for w in workers:
                wdir = os.path.join(run_dir, w.get(
                    "dir", host_dir_name(w.get("process_index", 0))))
                meta = load_meta(wdir)
                port = meta.get("metrics_port", w.get("metrics_port"))
                hostname = meta.get("hostname",
                                    w.get("hostname", "localhost"))
                name = meta.get("name") or \
                    f"{hostname}/{w.get('process_index', 0)}"
                url = None if offline else (
                    f"http://{hostname}:{port}" if port else None)
                sources.append(WorkerSource(name, url=url, path=wdir))
        else:
            for entry in sorted(os.listdir(run_dir)):
                wdir = os.path.join(run_dir, entry)
                if not (entry.startswith("host-")
                        and os.path.isdir(wdir)):
                    continue
                meta = load_meta(wdir)
                name = meta.get("name") or entry
                port = meta.get("metrics_port")
                hostname = meta.get("hostname", "localhost")
                url = None if offline else (
                    f"http://{hostname}:{port}" if port else None)
                sources.append(WorkerSource(name, url=url, path=wdir))
        return cls(sources, **kw)

    def collect(self) -> Dict[str, Dict]:
        """host label -> latest snapshot; unreachable workers are
        skipped (a dead worker must not take the cluster view down).
        Workers are polled CONCURRENTLY, so a scrape of
        ``/metrics/cluster`` costs ~one timeout even with several
        unreachable hosts, not O(hosts) serial timeouts."""
        out: Dict[str, Dict] = {}
        if not self.sources:
            return out
        if len(self.sources) == 1:
            snap = self.sources[0].snapshot(self.timeout_s)
            if snap is not None:
                out[self.sources[0].name] = snap
            return out
        from concurrent.futures import ThreadPoolExecutor
        with ThreadPoolExecutor(
                max_workers=min(16, len(self.sources)),
                thread_name_prefix="zoo-cluster-pull") as pool:
            futs = [(src.name,
                     pool.submit(src.snapshot, self.timeout_s))
                    for src in self.sources]
            for name, fut in futs:
                try:
                    snap = fut.result()
                except Exception:
                    snap = None
                if snap is not None:
                    out[name] = snap
        return out

    def cluster_view(self) -> Tuple[Dict[str, Dict], Dict]:
        """One collect → (host_snaps, merged-with-report): the single
        source of truth shared by the live ``/metrics/cluster`` routes
        and the offline ``obs_report --merge-hosts`` path, so both
        views carry the same skew gauges AND the same expected-vs-
        missing host accounting."""
        host_snaps = self.collect()
        merged = merge_snapshots(host_snaps)
        report = straggler_report(host_snaps,
                                  skew_threshold=self.skew_threshold)
        # an unreachable worker degrades to its last flushed file, or
        # drops out entirely — either way the view must SAY so, not
        # just shrink: expected-vs-reporting is the alerting signal
        missing = sorted(set(s.name for s in self.sources)
                         - set(host_snaps))
        report["expected_hosts"] = len(self.sources)
        if missing:
            report["missing_hosts"] = missing
            log.warning(
                "cluster view is missing %d of %d workers: %s "
                "(no live endpoint and no flushed snapshot)",
                len(missing), len(self.sources), missing)
        merged["gauges"].update(cluster_gauges(report))
        merged["gauges"]["cluster_hosts_expected"] = float(
            len(self.sources))
        merged["gauges"]["cluster_hosts_missing"] = float(len(missing))
        merged["cluster"] = report
        return host_snaps, merged

    def cluster_snapshot(self) -> Dict:
        return self.cluster_view()[1]

    def prometheus_text(self) -> str:
        snap = self.cluster_snapshot()
        snap.pop("cluster", None)
        return snapshot_prometheus_text(snap)


# ------------------------------------------------------------ trace merge
def merge_traces(run_dir: str, out_path: Optional[str] = None) -> Dict:
    """Merge per-host Chrome traces into one cluster timeline.

    Each worker's tracer exports timestamps relative to its own start;
    its ``meta.json`` carries ``clock_anchor`` (the launcher's startup
    wall time, broadcast through the env) and the trace carries
    ``wall_time_origin`` (that worker's wall clock at tracer start).
    Aligning is a pure shift: ``ts += (wall_time_origin - anchor)``,
    so "t=0" of the merged timeline is the launcher start on every
    host.  Events are re-homed to ``pid = process_index`` with Chrome
    ``process_name`` metadata, so Perfetto renders one labelled track
    group per host.
    """
    events: List[Dict] = []
    anchors: List[float] = []
    hosts = 0
    # the manifest names THIS run's workers; a reused run_dir may hold
    # stale host-*/ dirs from an earlier, larger launch whose traces
    # must not contaminate the merge — dir scanning is the fallback
    # only when no manifest exists
    entries = None
    try:
        with open(os.path.join(run_dir, CLUSTER_FILE)) as f:
            manifest = json.load(f)
        entries = sorted(
            w.get("dir", host_dir_name(w.get("process_index", 0)))
            for w in manifest.get("workers", []))
    except Exception:
        entries = None
    if not entries:
        entries = sorted(os.listdir(run_dir))
    for entry in entries:
        wdir = os.path.join(run_dir, entry)
        if not (entry.startswith("host-") and os.path.isdir(wdir)):
            continue
        trace_path = os.path.join(wdir, TRACE_FILE)
        try:
            with open(trace_path) as f:
                doc = json.load(f)
        except Exception:
            continue
        meta = load_meta(wdir)
        pidx = int(meta.get("process_index",
                            entry.split("-", 1)[-1] or hosts))
        name = meta.get("name", entry)
        origin = float((doc.get("otherData") or {}).get(
            "wall_time_origin", 0.0))
        anchor = float(meta.get("clock_anchor", origin))
        anchors.append(anchor)
        shift_us = (origin - anchor) * 1e6
        hosts += 1
        events.append({"name": "process_name", "ph": "M", "pid": pidx,
                       "args": {"name": name}})
        for e in doc.get("traceEvents", []):
            ev = dict(e)
            if "ts" in ev:
                ev["ts"] = ev["ts"] + shift_us
            ev["pid"] = pidx
            events.append(ev)
    merged = {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "otherData": {
            # the merged trace's producer tag is part of the wire format
            # both packages write, byte for byte
            "producer": "analytics_zoo_tpu.observability.aggregator",
            "hosts_merged": hosts,
            "clock_anchor": min(anchors) if anchors else 0.0,
        },
    }
    if out_path:
        _atomic_dump_json(merged, out_path)
    return merged


def _atomic_dump_json(doc: Dict, out_path: str) -> None:
    """Local twin of ``common.fsutil.atomic_write_text`` (pid-unique
    tmp + ``os.replace``), kept here as in the reference's module."""
    tmp = f"{out_path}.{os.getpid()}.tmp"
    with open(tmp, "w") as f:
        json.dump(doc, f)
    os.replace(tmp, out_path)


# ---------------------------------------------------------- request merge
def merge_requests(run_dir: str,
                   out_path: Optional[str] = None) -> Dict:
    """Merge per-host ``requests.json`` request-timeline logs into one
    document: timelines sharing a trace_id across replicas (or the
    client process) are joined and re-anchored on the earliest
    ``wall0`` (see ``reqtrace.merge_timeline_dicts``).  Host selection
    follows :func:`merge_traces`: the ``cluster.json`` manifest names
    THIS run's workers; directory scanning is the fallback only when
    no manifest exists.  Accepts a single ``requests.json`` FILE path
    too (the loadgen's ``--requests-out`` artifact)."""
    docs: List[Dict] = []
    hosts = 0
    if os.path.isfile(run_dir):
        try:
            with open(run_dir) as f:
                docs.append(json.load(f))
            hosts = 1
        except Exception:
            pass
    else:
        entries = None
        try:
            with open(os.path.join(run_dir, CLUSTER_FILE)) as f:
                manifest = json.load(f)
            entries = sorted(
                w.get("dir", host_dir_name(w.get("process_index", 0)))
                for w in manifest.get("workers", []))
        except Exception:
            entries = None
        if not entries:
            entries = sorted(os.listdir(run_dir)) \
                if os.path.isdir(run_dir) else []
        for entry in entries:
            wdir = os.path.join(run_dir, entry)
            if not (entry.startswith("host-") and os.path.isdir(wdir)):
                continue
            try:
                with open(os.path.join(wdir, REQUESTS_FILE)) as f:
                    docs.append(json.load(f))
                hosts += 1
            except Exception:
                continue
    # a plain import, kept lazy: reqtrace's module level is stdlib-only,
    # so the merge still runs where torch is not installed
    from analytics_zoo_torch.observability import reqtrace
    merged = {
        "kind": "zoo_request_timelines",
        "hosts_merged": hosts,
        "kept": sum(int(d.get("kept", 0)) for d in docs),
        "dropped": sum(int(d.get("dropped", 0)) for d in docs),
        "timelines": reqtrace.merge_timeline_dicts(docs),
    }
    if out_path:
        _atomic_dump_json(merged, out_path)
    return merged


# --------------------------------------------------- worker-side bring-up
# bring-up state is check-then-act shared between the caller's thread,
# atexit, and tests' reset — the lock makes init idempotence and
# init-vs-reset ordering actually atomic
_worker_state: Dict = {}
_worker_lock = threading.Lock()


def init_worker_observability(run_dir: Optional[str] = None,
                              process_index: Optional[int] = None,
                              metrics_port: Optional[int] = None,
                              start_server: bool = True,
                              register_atexit: bool = True
                              ) -> Optional[str]:
    """Worker half of the plane, driven by the launcher's env contract.

    Reads ``ZOO_TPU_RUN_DIR`` / ``ZOO_TPU_PROCESS_ID`` /
    ``ZOO_TPU_METRICS_PORT`` / ``ZOO_TPU_CLOCK_ANCHOR`` (explicit args
    override), then:

    1. stamps the immutable ``host``/``process_index`` const labels on
       the process registry,
    2. creates ``<run_dir>/host-<k>/`` and writes ``meta.json``,
    3. starts a ``MetricsServer`` on the injected port (host 0
       additionally gets the :class:`ClusterAggregator` attached, so
       its endpoint serves ``/metrics/cluster``),
    4. registers an atexit flush (final ``metrics.jsonl`` snapshot +
       ``trace.json``) so offline aggregation works even for workers
       that die between scrapes.

    Idempotent; returns the worker dir (None when no run dir is
    configured).  Imports the package lazily: this module's level
    stays stdlib-only.
    """
    with _worker_lock:
        # idempotence check and the state commit below share the lock:
        # without it two racing bring-ups both pass the check and both
        # start a MetricsServer (the loser's listener leaks)
        if _worker_state.get("dir"):
            return _worker_state["dir"]
        run_dir = run_dir if run_dir is not None \
            else os.environ.get(ENV_RUN_DIR)
        if not run_dir:
            return None
        if process_index is None:
            process_index = int(os.environ.get(ENV_PROCESS_ID, "0"))
        if metrics_port is None:
            raw = os.environ.get(ENV_METRICS_PORT)
            metrics_port = int(raw) if raw else 0
        anchor = float(os.environ.get(ENV_CLOCK_ANCHOR, time.time()))
        hostname = socket.gethostname()
        name = f"{hostname}/{process_index}"

        wdir = os.environ.get(ENV_METRICS_DIR) or \
            os.path.join(run_dir, host_dir_name(process_index))
        os.makedirs(wdir, exist_ok=True)

        from analytics_zoo_torch.observability.metrics import get_registry
        registry = get_registry()
        registry.set_const_labels(host=hostname,
                                  process_index=str(process_index))

        server = None
        if start_server:
            try:
                from analytics_zoo_torch.observability.exporter import \
                    MetricsServer
                aggregator = None
                if process_index == 0:
                    aggregator = ClusterAggregator.from_run_dir(run_dir)
                    for src in aggregator.sources:
                        # host 0's own snapshot comes straight from the
                        # in-process registry — no HTTP round trip to
                        # self
                        if src.name == name:
                            src._fetch = registry.snapshot
                server = MetricsServer(port=metrics_port,
                                       aggregator=aggregator).start()
                metrics_port = server.port
            except Exception:
                log.exception("worker metrics server failed to start")
                server = None

        meta = {
            "name": name,
            "hostname": hostname,
            "process_index": int(process_index),
            "pid": os.getpid(),
            "metrics_port": metrics_port,
            "clock_anchor": anchor,
            "started_unix": time.time(),
        }
        with open(os.path.join(wdir, META_FILE), "w") as f:
            json.dump(meta, f, indent=2)

        # the historical layer: a tsdb writer + jittered
        # background sampler in this worker's slot, so burn-rate /
        # drift questions have data the moment the run dir exists
        try:
            from analytics_zoo_torch.common.config import get_config
            from analytics_zoo_torch.observability import tsdb as _tsdb
            cfg = get_config()
            if bool(cfg.get("observability.tsdb", True)):
                _tsdb.init_tsdb(
                    os.path.join(wdir, _tsdb.TSDB_DIRNAME),
                    interval_s=float(
                        cfg.get("observability.tsdb_interval_s", 10.0)),
                    retention_bytes=int(float(cfg.get(
                        "observability.tsdb_retention_mb", 64))
                        * 1024 * 1024),
                    retention_age_s=float(cfg.get(
                        "observability.tsdb_retention_age_s", 86400.0)),
                    registry=registry)
        except Exception:
            log.exception("worker tsdb bring-up failed")

        # the black-box flight recorder: lifecycle events
        # spool to host-<k>/events.jsonl from the first breath, and
        # the crash hooks (atexit / excepthook / fatal signal) are
        # armed so any death leaves a blackbox.json
        try:
            from analytics_zoo_torch.observability import \
                flightrec as _flightrec
            _flightrec.init_flightrec(
                wdir, process_index=int(process_index),
                clock_anchor=anchor)
        except Exception:
            log.exception("worker flight-recorder bring-up failed")

        _worker_state.update({"dir": wdir, "meta": meta,
                              "server": server, "run_dir": run_dir})
    if register_atexit:
        import atexit
        atexit.register(flush_worker_observability)
    log.info("cluster observability worker %s -> %s (port %s)",
             name, wdir, metrics_port)
    return wdir


def flush_worker_observability() -> Optional[str]:
    """Append a registry snapshot line and (re)write the Chrome trace
    into this worker's run-dir slot.  Safe to call repeatedly (epoch
    boundaries, atexit); no-op before :func:`init_worker_observability`."""
    wdir = _worker_state.get("dir")
    if not wdir:
        return None
    try:
        from analytics_zoo_torch.observability.metrics import get_registry
        get_registry().write_jsonl(os.path.join(wdir, METRICS_FILE))
    except Exception:
        log.exception("worker metrics flush failed")
    try:
        from analytics_zoo_torch.observability.tracing import get_tracer
        get_tracer().export_chrome_trace(os.path.join(wdir, TRACE_FILE))
    except Exception:
        log.exception("worker trace flush failed")
    try:
        from analytics_zoo_torch.observability.reqtrace import \
            get_request_log
        get_request_log().export(os.path.join(wdir, REQUESTS_FILE))
    except Exception:
        log.exception("worker request-log flush failed")
    try:
        from analytics_zoo_torch.observability.tsdb import \
            flush_active_tsdb
        flush_active_tsdb()   # the run dir ends on a fresh sample
    except Exception:
        log.exception("worker tsdb flush failed")
    try:
        from analytics_zoo_torch.observability import \
            flightrec as _flightrec
        _flightrec.flush_active_flightrec(
            "flush",
            registry_snapshot=_flightrec._default_registry_snapshot(),
            request_snapshot=_flightrec._default_request_snapshot())
    except Exception:
        log.exception("worker blackbox flush failed")
    return wdir


def reset_worker_observability() -> None:
    """Drop worker bring-up state (test helper); stops the server."""
    with _worker_lock:
        server = _worker_state.get("server")
        if server is not None:
            try:
                server.stop()
            except Exception:
                pass
        _worker_state.clear()
    try:
        from analytics_zoo_torch.observability.tsdb import reset_tsdb
        reset_tsdb()
    except Exception:
        pass
    try:
        from analytics_zoo_torch.observability.flightrec import \
            reset_flightrec
        reset_flightrec()
    except Exception:
        pass
