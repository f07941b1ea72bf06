"""Wire serde: request JSON tree + typed binary object serde.

Parity: pinot-common's Thrift request serialization (request.thrift via
TCompactProtocol, ScheduledRequestHandler.java:63) and the typed object
serde registry (core/common/ObjectSerDeUtils.java:55-83 — AvgPair,
MinMaxRangePair, HLL, percentile maps...). We use JSON for the request tree
(control-plane friendly, schema evolvable) and a compact tagged binary
format for result objects (sets/maps/pairs cross the server→broker wire in
DataTable cells).
"""
from __future__ import annotations

import json
import struct
from typing import Any, List, Optional

from pinot_tpu_torch.common.request import (AggregationInfo, BrokerRequest,
                                      FilterOperator, FilterQueryTree,
                                      GroupBy, HavingNode, InstanceRequest,
                                      JoinSpec, QueryOptions, Selection,
                                      SelectionSort, VectorSimilarity,
                                      WindowSpec)
from pinot_tpu_torch.common.sketches import HyperLogLog, TDigest

# ---------------------------------------------------------------------------
# Request JSON
# ---------------------------------------------------------------------------


def filter_to_json(n: Optional[FilterQueryTree]) -> Optional[dict]:
    if n is None:
        return None
    return {
        "op": n.operator.value, "col": n.column, "vals": n.values,
        "children": [filter_to_json(c) for c in n.children],
        "lo": n.lower, "hi": n.upper,
        "loInc": n.lower_inclusive, "hiInc": n.upper_inclusive,
    }


def filter_from_json(d: Optional[dict]) -> Optional[FilterQueryTree]:
    if d is None:
        return None
    return FilterQueryTree(
        operator=FilterOperator(d["op"]), column=d.get("col"),
        values=d.get("vals") or [],
        children=[filter_from_json(c) for c in d.get("children") or []],
        lower=d.get("lo"), upper=d.get("hi"),
        lower_inclusive=d.get("loInc", True),
        upper_inclusive=d.get("hiInc", True))


def _having_to_json(n: Optional[HavingNode]) -> Optional[dict]:
    if n is None:
        return None
    return {
        "op": n.operator.value,
        "agg": None if n.agg is None else
        {"fn": n.agg.function_name, "col": n.agg.column},
        "vals": n.values,
        "children": [_having_to_json(c) for c in n.children],
        "lo": n.lower, "hi": n.upper,
        "loInc": n.lower_inclusive, "hiInc": n.upper_inclusive,
    }


def _having_from_json(d: Optional[dict]) -> Optional[HavingNode]:
    if d is None:
        return None
    agg = d.get("agg")
    return HavingNode(
        operator=FilterOperator(d["op"]),
        agg=None if agg is None else AggregationInfo(agg["fn"], agg["col"]),
        values=d.get("vals") or [],
        children=[_having_from_json(c) for c in d.get("children") or []],
        lower=d.get("lo"), upper=d.get("hi"),
        lower_inclusive=d.get("loInc", True),
        upper_inclusive=d.get("hiInc", True))


def request_to_json(r: BrokerRequest) -> dict:
    return {
        "table": r.table_name,
        "filter": filter_to_json(r.filter),
        "aggregations": [{"fn": a.function_name, "col": a.column}
                         for a in r.aggregations],
        "groupBy": None if r.group_by is None else
        {"columns": r.group_by.columns, "topN": r.group_by.top_n},
        "selection": None if r.selection is None else {
            "columns": r.selection.columns,
            "orderBy": [{"col": s.column, "asc": s.ascending}
                        for s in r.selection.order_by],
            "offset": r.selection.offset, "size": r.selection.size},
        # optional vector-similarity clause (absent pre-vector payloads
        # parse unchanged; older peers ignore the extra key)
        "vector": None if r.vector is None else {
            "col": r.vector.column,
            "q": [float(x) for x in r.vector.query],
            "k": r.vector.k, "metric": r.vector.metric,
            "nprobe": r.vector.nprobe},
        # optional multi-stage clauses (same version-skew contract)
        "join": None if r.join is None else {
            "dimTable": r.join.dim_table,
            "factKey": r.join.fact_key, "dimKey": r.join.dim_key,
            "dimFilter": filter_to_json(r.join.dim_filter),
            "dimColumns": list(r.join.dim_columns)},
        "windows": [{
            "fn": w.function, "col": w.column,
            "partitionBy": list(w.partition_by),
            "orderBy": [{"col": s.column, "asc": s.ascending}
                        for s in w.order_by]} for w in r.windows],
        "having": _having_to_json(r.having),
        "options": {"trace": r.query_options.trace,
                    "timeoutMs": r.query_options.timeout_ms,
                    "debug": r.query_options.debug_options,
                    "options": r.query_options.options},
        "limit": r.limit,
    }


def request_from_json(d: dict) -> BrokerRequest:
    sel = d.get("selection")
    gb = d.get("groupBy")
    vec = d.get("vector")
    jn = d.get("join")
    opts = d.get("options") or {}
    return BrokerRequest(
        table_name=d["table"],
        filter=filter_from_json(d.get("filter")),
        aggregations=[AggregationInfo(a["fn"], a["col"])
                      for a in d.get("aggregations") or []],
        group_by=None if gb is None else GroupBy(gb["columns"], gb["topN"]),
        selection=None if sel is None else Selection(
            columns=sel["columns"],
            order_by=[SelectionSort(s["col"], s["asc"])
                      for s in sel.get("orderBy") or []],
            offset=sel.get("offset", 0), size=sel.get("size", 10)),
        vector=None if vec is None else VectorSimilarity(
            column=vec["col"], query=list(vec["q"]),
            k=vec.get("k", 10), metric=vec.get("metric", "COSINE"),
            nprobe=int(vec.get("nprobe", 0))),
        join=None if jn is None else JoinSpec(
            dim_table=jn["dimTable"], fact_key=jn["factKey"],
            dim_key=jn["dimKey"],
            dim_filter=filter_from_json(jn.get("dimFilter")),
            dim_columns=list(jn.get("dimColumns") or [])),
        windows=[WindowSpec(
            function=w["fn"], column=w.get("col"),
            partition_by=list(w.get("partitionBy") or []),
            order_by=[SelectionSort(s["col"], s["asc"])
                      for s in w.get("orderBy") or []])
            for w in d.get("windows") or []],
        having=_having_from_json(d.get("having")),
        query_options=QueryOptions(
            trace=opts.get("trace", False),
            timeout_ms=opts.get("timeoutMs"),
            debug_options=opts.get("debug") or {},
            options=opts.get("options") or {}),
        limit=d.get("limit", 10))


def instance_request_to_bytes(r: InstanceRequest) -> bytes:
    d = {
        "requestId": r.request_id,
        "query": request_to_json(r.query),
        "searchSegments": r.search_segments,
        "enableTrace": r.enable_trace,
        "brokerId": r.broker_id,
    }
    if r.deadline_budget_ms is not None:
        # optional key: payloads from older brokers stay parseable and
        # payloads to older servers are ignored, not rejected
        d["deadlineBudgetMs"] = r.deadline_budget_ms
    if r.trace_id is not None:
        # optional for the same version-skew reason: the tracing
        # context only travels when the query is traced
        d["traceId"] = r.trace_id
        d["parentSpanId"] = r.parent_span_id
    if r.workload is not None:
        # optional: a tenant tag from a newer broker is scheduling
        # advice an older server simply ignores
        d["workload"] = r.workload
    if r.hedge:
        d["hedge"] = True
    if r.publish_exchange is not None:
        # multi-stage exchange plane (optional keys, version-skew safe):
        # a stage-1 producer publishes its result under the exchange id;
        # a stage-2 consumer fetches the listed peer blocks first
        d["publishExchange"] = r.publish_exchange
    if r.exchange_sources is not None:
        d["exchangeSources"] = r.exchange_sources
    return json.dumps(d).encode("utf-8")


def instance_request_from_bytes(b: bytes) -> InstanceRequest:
    d = json.loads(b.decode("utf-8"))
    return InstanceRequest(
        request_id=d["requestId"],
        query=request_from_json(d["query"]),
        search_segments=d.get("searchSegments"),
        enable_trace=d.get("enableTrace", False),
        broker_id=d.get("brokerId", ""),
        deadline_budget_ms=d.get("deadlineBudgetMs"),
        trace_id=d.get("traceId"),
        parent_span_id=d.get("parentSpanId"),
        workload=d.get("workload"),
        hedge=d.get("hedge", False),
        publish_exchange=d.get("publishExchange"),
        exchange_sources=d.get("exchangeSources"))


# ---------------------------------------------------------------------------
# Typed binary object serde (DataTable cells / aggregation intermediates)
#
# Tags: N null, B bool, i int64, I bigint(str), d float64, s str, b bytes,
#       t tuple, l list, S set, D dict (sorted by key bytes for determinism),
#       H HyperLogLog, T TDigest (sketch custom objects —
#       ObjectSerDeUtils.ObjectType HyperLogLog/TDigest parity)
# ---------------------------------------------------------------------------

_I64 = struct.Struct(">q")
_F64 = struct.Struct(">d")
_U32 = struct.Struct(">I")


def obj_to_bytes(v: Any) -> bytes:
    out = bytearray()
    _write_obj(out, v)
    return bytes(out)


def obj_from_bytes(b) -> Any:
    """`b`: any buffer (bytes / memoryview) — the zero-copy DataTable
    decode path hands frame memoryviews straight in."""
    v, off = _read_obj(b, 0)
    return v


def _write_obj(out: bytearray, v: Any) -> None:
    import numpy as np
    if isinstance(v, np.generic):
        v = v.item()
    if v is None:
        out += b"N"
    elif isinstance(v, bool):
        out += b"B"
        out += b"\x01" if v else b"\x00"
    elif isinstance(v, int):
        if -(2**63) <= v < 2**63:
            out += b"i"
            out += _I64.pack(v)
        else:
            s = str(v).encode()
            out += b"I"
            out += _U32.pack(len(s))
            out += s
    elif isinstance(v, float):
        out += b"d"
        out += _F64.pack(v)
    elif isinstance(v, str):
        s = v.encode("utf-8")
        out += b"s"
        out += _U32.pack(len(s))
        out += s
    elif isinstance(v, bytes):
        out += b"b"
        out += _U32.pack(len(v))
        out += v
    elif isinstance(v, tuple):
        out += b"t"
        out += _U32.pack(len(v))
        for x in v:
            _write_obj(out, x)
    elif isinstance(v, list):
        out += b"l"
        out += _U32.pack(len(v))
        for x in v:
            _write_obj(out, x)
    elif isinstance(v, (set, frozenset)):
        items = [obj_to_bytes(x) for x in v]
        items.sort()
        out += b"S"
        out += _U32.pack(len(items))
        for ib in items:
            out += ib
    elif isinstance(v, dict):
        items = sorted((obj_to_bytes(k), obj_to_bytes(x))
                       for k, x in v.items())
        out += b"D"
        out += _U32.pack(len(items))
        for kb, vb in items:
            out += kb
            out += vb
    elif isinstance(v, HyperLogLog):
        payload = v.to_bytes()
        out += b"H"
        out += _U32.pack(len(payload))
        out += payload
    elif isinstance(v, TDigest):
        payload = v.to_bytes()
        out += b"T"
        out += _U32.pack(len(payload))
        out += payload
    else:
        raise TypeError(f"unserializable object type {type(v)}")


def _read_obj(b, off: int):
    # str(buf, "utf-8") decodes bytes AND memoryview slices — .decode()
    # exists only on bytes, and the zero-copy frame path passes views
    tag = b[off:off + 1]
    off += 1
    if tag == b"N":
        return None, off
    if tag == b"B":
        return b[off] != 0, off + 1
    if tag == b"i":
        return _I64.unpack_from(b, off)[0], off + 8
    if tag == b"I":
        n = _U32.unpack_from(b, off)[0]
        off += 4
        return int(str(b[off:off + n], "ascii")), off + n
    if tag == b"d":
        return _F64.unpack_from(b, off)[0], off + 8
    if tag == b"s":
        n = _U32.unpack_from(b, off)[0]
        off += 4
        return str(b[off:off + n], "utf-8"), off + n
    if tag == b"b":
        n = _U32.unpack_from(b, off)[0]
        off += 4
        return bytes(b[off:off + n]), off + n
    if tag in (b"t", b"l"):
        n = _U32.unpack_from(b, off)[0]
        off += 4
        items: List[Any] = []
        for _ in range(n):
            v, off = _read_obj(b, off)
            items.append(v)
        return (tuple(items) if tag == b"t" else items), off
    if tag == b"S":
        n = _U32.unpack_from(b, off)[0]
        off += 4
        out = set()
        for _ in range(n):
            v, off = _read_obj(b, off)
            out.add(v)
        return out, off
    if tag == b"D":
        n = _U32.unpack_from(b, off)[0]
        off += 4
        d = {}
        for _ in range(n):
            k, off = _read_obj(b, off)
            v, off = _read_obj(b, off)
            d[k] = v
        return d, off
    if tag in (b"H", b"T"):
        n = _U32.unpack_from(b, off)[0]
        off += 4
        cls = HyperLogLog if tag == b"H" else TDigest
        return cls.from_bytes(bytes(b[off:off + n])), off + n
    raise ValueError(f"bad object tag {tag!r} at {off - 1}")
