"""Per-query operator profiler + rolling per-table stats.

Copy of pinot_tpu/obs/profiler.py, its imports rebased onto
pinot_tpu_torch; `profiled_device_get` is a torch twin of the JAX one
(query/execution.py:pull funnels its one device→host copy through it).

Answers VERDICT.md's "where does the time go" ask with attribution the
flat metrics cannot give: per query, how many docs were scanned, how
many segments were pruned vs matched, which execution path served each
segment (star-tree cube, device scan kernel, host fallback, mesh-
sharded), how many kernel dispatches ran and how many bytes crossed the
device→host boundary (each dispatch's one batched pull,
`profiled_device_get`).

The profile travels server→broker as a compact JSON blob in DataTable
metadata ("profileInfo"); the broker folds every query's profile into a
`TableStatsAggregator` — rolling per-table operator stats served from
the broker's debug API.

The ambient context is a per-thread slot: the server executor activates
(profile, trace) around a query, worker-pool threads re-activate the
captured context inside their closure, and the hot-path check when
nothing is active is a single threading.local attribute read.
"""
from __future__ import annotations

import json
import threading
import time
from contextlib import contextmanager
from typing import Dict, Optional, Tuple

_tls = threading.local()


def current() -> Optional[Tuple["QueryProfile", object]]:
    """The (profile, trace) pair active on this thread, or None."""
    return getattr(_tls, "ctx", None)


@contextmanager
def active(profile: Optional["QueryProfile"], trace=None):
    """Activate a profile (+ trace) for this thread."""
    prev = getattr(_tls, "ctx", None)
    _tls.ctx = (profile, trace) if profile is not None else None
    try:
        yield
    finally:
        _tls.ctx = prev


@contextmanager
def reactivate(ctx: Optional[tuple]):
    """Re-establish a captured ambient context on a worker thread."""
    prev = getattr(_tls, "ctx", None)
    _tls.ctx = ctx
    try:
        yield
    finally:
        _tls.ctx = prev


@contextmanager
def obs_span(name: str, **attrs):
    """A trace span on the ambient trace (noop when nothing is active)."""
    ctx = getattr(_tls, "ctx", None)
    if ctx is None or ctx[1] is None or not ctx[1].enabled:
        yield None
        return
    with ctx[1].span(name, **attrs) as s:
        yield s


def profiled_device_get(pull, outs):
    """`pull(outs)` (a dispatch's one device→host copy, numpy out) with
    dispatch/transfer accounting: the ambient profile counts the
    dispatch and the host-side bytes, and the ambient trace gets a
    `kernelDispatch` span. With nothing active this is pull(outs) + one
    threading.local read."""
    ctx = getattr(_tls, "ctx", None)
    if ctx is None:
        return pull(outs)
    t0 = time.perf_counter()
    host = pull(outs)
    ms = (time.perf_counter() - t0) * 1e3
    nbytes = sum(int(getattr(a, "nbytes", 0)) for a in host.values())
    profile, trace = ctx
    if profile is not None:
        profile.add_dispatch(nbytes, ms)
    if trace is not None and trace.enabled:
        trace.record("kernelDispatch", ms, bytes=nbytes)
    return host


def count_path(path: str, n: int = 1) -> None:
    """Attribute n segments to an execution path on the ambient profile
    ("cube" star-tree, "scan" device kernel, "host" numpy fallback,
    "sharded" mesh combine)."""
    ctx = getattr(_tls, "ctx", None)
    if ctx is not None and ctx[0] is not None:
        ctx[0].count_path(path, n)


class QueryProfile:
    """One query's operator-level execution accounting (server side)."""

    __slots__ = ("table", "docs_scanned", "segments_processed",
                 "segments_matched", "segments_pruned", "paths",
                 "dispatches", "transfer_bytes", "kernel_ms",
                 "batch_size", "_lock")

    def __init__(self, table: str = ""):
        self.table = table
        self.docs_scanned = 0
        self.segments_processed = 0
        self.segments_matched = 0
        self.segments_pruned = 0
        self.paths: Dict[str, int] = {}
        self.dispatches = 0
        self.transfer_bytes = 0
        self.kernel_ms = 0.0
        # queries served by this query's batch window (1 == unbatched;
        # set by the coalescer runner when the query rode a batch)
        self.batch_size = 1
        self._lock = threading.Lock()

    def add_dispatch(self, nbytes: int, ms: float) -> None:
        with self._lock:
            self.dispatches += 1
            self.transfer_bytes += nbytes
            self.kernel_ms += ms

    def count_path(self, path: str, n: int = 1) -> None:
        with self._lock:
            self.paths[path] = self.paths.get(path, 0) + n

    def finish_from_stats(self, stats) -> None:
        """Fold the combined block's ExecutionStats in at query end."""
        self.docs_scanned = stats.num_docs_scanned
        self.segments_processed = stats.num_segments_processed
        self.segments_matched = stats.num_segments_matched
        self.segments_pruned = stats.num_segments_pruned

    def to_json(self) -> dict:
        with self._lock:
            return {
                "docsScanned": self.docs_scanned,
                "segmentsProcessed": self.segments_processed,
                "segmentsMatched": self.segments_matched,
                "segmentsPruned": self.segments_pruned,
                "paths": dict(self.paths),
                "kernelDispatches": self.dispatches,
                "deviceTransferBytes": self.transfer_bytes,
                "kernelMs": round(self.kernel_ms, 3),
                "batchSize": self.batch_size,
            }

    def to_json_str(self) -> str:
        return json.dumps(self.to_json())


class TableStatsAggregator:
    """Rolling per-table operator stats at the broker.

    Each table keeps lifetime counters plus a bounded ring of the most
    recent per-query profiles, so the debug view can answer both "what
    does this table's traffic look like" and "what did the last N
    queries actually do".
    """

    RECENT = 64

    def __init__(self):
        self._tables: Dict[str, dict] = {}
        self._lock = threading.Lock()

    def record(self, table: str, profile: dict,
               time_used_ms: Optional[float] = None) -> None:
        with self._lock:
            t = self._tables.get(table)
            if t is None:
                t = self._tables[table] = {
                    "queries": 0, "docsScanned": 0, "segmentsProcessed": 0,
                    "segmentsMatched": 0, "segmentsPruned": 0,
                    "kernelDispatches": 0, "deviceTransferBytes": 0,
                    "kernelMs": 0.0, "paths": {}, "recent": []}
            t["queries"] += 1
            for k in ("docsScanned", "segmentsProcessed", "segmentsMatched",
                      "segmentsPruned", "kernelDispatches",
                      "deviceTransferBytes"):
                t[k] += int(profile.get(k, 0))
            t["kernelMs"] = round(t["kernelMs"] +
                                  float(profile.get("kernelMs", 0.0)), 3)
            for path, n in (profile.get("paths") or {}).items():
                t["paths"][path] = t["paths"].get(path, 0) + int(n)
            entry = dict(profile)
            if time_used_ms is not None:
                entry["timeUsedMs"] = round(time_used_ms, 3)
            recent = t["recent"]
            recent.append(entry)
            if len(recent) > self.RECENT:
                del recent[0]

    def table_names(self):
        with self._lock:
            return list(self._tables)

    def snapshot(self, table: Optional[str] = None) -> dict:
        """Isolated copy of the stats. Only the shallow copy happens
        under the lock — the JSON round-trip (which deep-copies the
        recent-profile rings) runs outside it so a debug scrape never
        stalls the query path's record() calls."""

        def copy_table(t: dict) -> dict:
            out = dict(t)
            out["paths"] = dict(t["paths"])
            out["recent"] = list(t["recent"])
            return out

        with self._lock:
            if table is not None:
                t = self._tables.get(table)
                shallow = copy_table(t) if t else None
            else:
                shallow = {name: copy_table(t)
                           for name, t in self._tables.items()}
        if shallow is None:
            return {}
        return json.loads(json.dumps(shallow))
