"""Request JSON: the canonical tree form of a BrokerRequest.

The two functions of pinot_tpu/common/serde.py (`filter_to_json` :30,
`request_to_json` :81) that query/fingerprint.py hashes, with the HAVING
tree they call; the typed binary object serde and the decoders stay in
the JAX package until the port's wire layer needs them.
"""
from __future__ import annotations

from typing import Optional

from pinot_tpu_torch.common.request import BrokerRequest, FilterQueryTree, \
    HavingNode


def filter_to_json(n: Optional[FilterQueryTree]) -> Optional[dict]:
    if n is None:
        return None
    return {
        "op": n.operator.value, "col": n.column, "vals": n.values,
        "children": [filter_to_json(c) for c in n.children],
        "lo": n.lower, "hi": n.upper,
        "loInc": n.lower_inclusive, "hiInc": n.upper_inclusive,
    }


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
