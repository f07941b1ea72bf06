"""Hierarchical distributed tracing: trace-id/span-id spans with parent
links, carried explicitly through the query path.

Copy of pinot_tpu/obs/tracing.py (JAX-free), its imports rebased onto
pinot_tpu_torch.

Parity: pinot-core/.../util/trace/TraceContext.java (request-scoped
trace tree enabled by the query's `trace` option, serialized into
response metadata) upgraded to the Dapper span model (PAPERS.md): every
span carries `spanId` + `parentId`, the broker stamps its dispatch
span's id into the `InstanceRequest`, the server roots its spans under
that id, and the broker reduce step merges every participant's span
list into ONE tree with correct cross-process parent links.

Design notes:

- Spans are plain dicts ``{"name", "ms", "spanId", "parentId"}`` (+
  optional ``"attrs"``) appended to a per-request list under a lock —
  the flat list stays cheap to serialize into DataTable metadata, and
  the tree is assembled once, at the broker, by `build_trace_tree`.
- Parenting is a per-THREAD stack inside the context: the broker path
  is async and the server path fans segments onto a worker pool, so a
  single global stack would interleave spans across threads. Workers
  seed their stack with `attach(parent_id)`.
- `NoopTraceContext` keeps the disabled path allocation- and
  lock-free: `make_trace_context(False)` must add no measurable
  per-query overhead (the acceptance bar for trace=false).

Wire format (DataTable metadata "traceInfo" / InstanceRequest):
``{"traceId": ..., "rootSpanId": ..., "spans": [...]}``; the legacy
flat ``[{"name", "ms"}, ...]`` list still parses (version skew).
"""
from __future__ import annotations

import itertools
import json
import os
import threading
import time
from contextlib import contextmanager
from typing import Dict, List, Optional


def _new_id() -> str:
    """A 12-hex-char id, unique enough for one trace's span namespace."""
    return os.urandom(6).hex()


class TraceContext:
    """One request's span collection (broker- or server-side half)."""

    enabled = True

    def __init__(self, trace_id: Optional[str] = None,
                 parent_span_id: Optional[str] = None,
                 root_name: str = "query"):
        self.trace_id = trace_id or _new_id()
        # span ids are prefix+counter: one urandom call per context, not
        # per span (spans are created on the hot path)
        self._prefix = _new_id()
        self._counter = itertools.count(1)
        self.spans: List[Dict[str, object]] = []
        self._lock = threading.Lock()
        self._tls = threading.local()
        self.root_span_id = self._next_id()
        self._root = {"name": root_name, "ms": 0.0,
                      "spanId": self.root_span_id,
                      "parentId": parent_span_id}
        self.spans.append(self._root)
        self._t0 = time.perf_counter()

    def _next_id(self) -> str:
        return f"{self._prefix}.{next(self._counter)}"

    # -- parenting stack (per thread) ---------------------------------------
    def _stack(self) -> list:
        s = getattr(self._tls, "stack", None)
        if s is None:
            s = self._tls.stack = []
        return s

    def current_span_id(self) -> Optional[str]:
        s = self._stack()
        return s[-1] if s else self.root_span_id

    @contextmanager
    def attach(self, parent_id: Optional[str]):
        """Seed THIS thread's parent stack (worker-pool fan-out: the
        submitting thread captures a span id, the worker attaches it)."""
        s = self._stack()
        s.append(parent_id or self.root_span_id)
        try:
            yield
        finally:
            s.pop()

    # -- span creation ------------------------------------------------------
    def record(self, name: str, ms: float,
               parent_id: Optional[str] = None, **attrs) -> dict:
        """Append a completed span (for durations measured externally,
        e.g. scheduler queue-wait)."""
        span: Dict[str, object] = {
            "name": name, "ms": round(ms, 3), "spanId": self._next_id(),
            "parentId": parent_id or self.current_span_id()}
        if attrs:
            span["attrs"] = attrs
        with self._lock:
            self.spans.append(span)
        return span

    @contextmanager
    def span(self, name: str, parent_id: Optional[str] = None, **attrs):
        """Open a span; children created on this thread nest under it."""
        s: Dict[str, object] = {
            "name": name, "ms": 0.0, "spanId": self._next_id(),
            "parentId": parent_id or self.current_span_id()}
        if attrs:
            s["attrs"] = attrs
        with self._lock:
            self.spans.append(s)
        stack = self._stack()
        stack.append(s["spanId"])
        t0 = time.perf_counter()
        try:
            yield s
        finally:
            s["ms"] = round((time.perf_counter() - t0) * 1e3, 3)
            # pop by value: interleaved async spans on one thread may
            # close out of LIFO order
            if stack and stack[-1] == s["spanId"]:
                stack.pop()
            else:
                try:
                    stack.remove(s["spanId"])
                except ValueError:
                    pass

    def finish_root(self) -> None:
        self._root["ms"] = round((time.perf_counter() - self._t0) * 1e3, 3)

    # -- (de)serialization --------------------------------------------------
    def to_list(self) -> List[Dict[str, object]]:
        with self._lock:
            return list(self.spans)

    def to_json_str(self) -> str:
        self.finish_root()
        return json.dumps({"traceId": self.trace_id,
                           "rootSpanId": self.root_span_id,
                           "spans": self.to_list()})

    @staticmethod
    def from_json_str(s: str) -> "TraceContext":
        d = json.loads(s)
        if isinstance(d, list):
            # legacy flat phase list from a version-skewed peer
            t = TraceContext()
            t.spans = [dict(x) for x in d]
            return t
        t = TraceContext(trace_id=d.get("traceId"))
        t.spans = [dict(x) for x in d.get("spans", [])]
        if d.get("rootSpanId"):
            t.root_span_id = d["rootSpanId"]
        return t


class NoopTraceContext(TraceContext):
    """Zero-cost stand-in when tracing is disabled — no ids, no locks,
    no appends. `bool(ctx.enabled)` is the cheap branch for callers."""

    enabled = False

    def __init__(self, *_a, **_k):  # noqa: D401 — no state at all
        self.trace_id = None
        self.root_span_id = None
        self.spans = []

    def current_span_id(self) -> Optional[str]:
        return None

    @contextmanager
    def attach(self, parent_id: Optional[str]):
        yield

    def record(self, name: str, ms: float,
               parent_id: Optional[str] = None, **attrs) -> dict:
        return {}

    @contextmanager
    def span(self, name: str, parent_id: Optional[str] = None, **attrs):
        yield None

    def finish_root(self) -> None:
        pass

    def to_list(self) -> List[Dict[str, object]]:
        return []

    def to_json_str(self) -> str:
        return "{}"


def make_trace_context(enabled: bool, trace_id: Optional[str] = None,
                       parent_span_id: Optional[str] = None,
                       root_name: str = "query") -> TraceContext:
    if not enabled:
        return NoopTraceContext()
    return TraceContext(trace_id=trace_id, parent_span_id=parent_span_id,
                        root_name=root_name)


def build_trace_tree(spans: List[Dict[str, object]],
                     trace_id: Optional[str] = None) -> Optional[dict]:
    """Assemble one tree from every participant's flat span list.

    Nodes keep their source dict's fields plus ``children``. Spans whose
    parent is unknown (skewed peer, lost dispatch span) attach under the
    root rather than vanishing — a trace must degrade, not lie by
    omission. Returns None when there are no spans at all.
    """
    if not spans:
        return None
    nodes: Dict[str, dict] = {}
    order: List[dict] = []
    for s in spans:
        node = dict(s)
        node["children"] = []
        sid = node.get("spanId")
        if sid is not None:
            nodes[str(sid)] = node
        order.append(node)
    true_roots: List[dict] = []
    orphans: List[dict] = []
    for node in order:
        pid = node.get("parentId")
        parent = nodes.get(str(pid)) if pid is not None else None
        if parent is not None and parent is not node:
            parent["children"].append(node)
        elif pid is None:
            true_roots.append(node)
        else:
            orphans.append(node)
    if len(true_roots) == 1:
        tree = true_roots[0]
        tree["children"].extend(orphans)
    else:
        # zero or several parentless spans: synthesize one wrapper
        roots = true_roots + orphans
        tree = {"name": "trace", "ms": sum(float(r.get("ms", 0))
                                           for r in roots),
                "spanId": None, "parentId": None, "children": roots}
    if trace_id is not None:
        tree["traceId"] = trace_id
    return tree
