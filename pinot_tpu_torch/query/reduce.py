"""Broker reduce: merge per-server blocks → final BrokerResponse.

Parity: pinot-core/.../query/reduce/BrokerReduceService.java:72-524 —
selection merge, aggregation merge + extractFinalResult, group-by top-N per
function, HAVING post-filter — and CombineService for the two-block case.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from pinot_tpu_torch.common.request import (BrokerRequest, FilterOperator,
                                      HavingNode)
from pinot_tpu_torch.common.response import (AggregationResult, BrokerResponse,
                                       SelectionResults, exception_entry)
from pinot_tpu_torch.query.aggregation import AggregationFunction, make_functions
from pinot_tpu_torch.query.blocks import IntermediateResultsBlock
from pinot_tpu_torch.query.combine import (combine_blocks, group_map_of,
                                     np_foldable, sortable_desc_key)


class BrokerReduceService:
    def reduce(self, request: BrokerRequest,
               blocks: List[IntermediateResultsBlock],
               num_servers_queried: int = 1,
               num_servers_responded: int = 1) -> BrokerResponse:
        merged = combine_blocks(request, list(blocks))
        resp = BrokerResponse()
        stats = merged.stats
        resp.num_docs_scanned = stats.num_docs_scanned
        resp.num_entries_scanned_in_filter = \
            stats.num_entries_scanned_in_filter
        resp.num_entries_scanned_post_filter = \
            stats.num_entries_scanned_post_filter
        resp.num_segments_processed = stats.num_segments_processed
        resp.num_segments_matched = stats.num_segments_matched
        resp.num_groups_limit_reached = stats.num_groups_limit_reached
        resp.total_docs = stats.total_docs
        resp.num_consuming_segments_queried = \
            stats.num_consuming_segments_processed
        resp.min_consuming_freshness_time_ms = \
            stats.min_consuming_freshness_ms
        resp.num_servers_queried = num_servers_queried
        resp.num_servers_responded = num_servers_responded
        # structured degradation: every per-segment/server exception
        # string carries errorCode + machine cause so clients and the
        # soak's SLO gate never have to string-match message text
        resp.exceptions = [exception_entry(e) for e in merged.exceptions]

        if request.is_group_by:
            self._reduce_group_by(request, merged, resp)
        elif request.is_aggregation:
            functions = make_functions(request.aggregations)
            inters = merged.agg_intermediates or [None] * len(functions)
            resp.aggregation_results = [
                AggregationResult(function=f.result_name,
                                  value=_final_str(f.extract_final(x)))
                for f, x in zip(functions, inters)]
        if request.is_selection:
            sel = request.selection
            columns = merged.selection_columns or sel.columns
            if merged.selection_cols is not None:
                # columnar payload: slice the window first, materialize
                # row lists only for the ≤ size emitted rows
                cols = [c[sel.offset: sel.offset + sel.size]
                        for c in merged.selection_cols]
                rows = list(zip(*[c.tolist()
                                  if isinstance(c, np.ndarray) else c
                                  for c in cols])) if cols else []
            else:
                rows = merged.selection_rows or []
                rows = rows[sel.offset: sel.offset + sel.size]
            n = merged.selection_display_cols
            if n is not None and n < len(columns):
                columns = columns[:n]
                rows = [row[:n] for row in rows]
            resp.selection_results = SelectionResults(
                columns=columns,
                results=[[_json_val(v) for v in row] for row in rows])
        return resp

    def _reduce_group_by(self, request: BrokerRequest,
                         merged: IntermediateResultsBlock,
                         resp: BrokerResponse) -> None:
        functions = make_functions(request.aggregations)
        if merged.group_cols is not None and request.having is None and \
                np_foldable(functions) and \
                all(isinstance(c, np.ndarray) and c.dtype.kind in "if"
                    for c in merged.group_cols[1]):
            self._reduce_group_cols(request, merged, resp, functions)
            return
        group_map = group_map_of(merged) or {}
        # final values per group per function
        finals: Dict[Tuple, List] = {
            key: [f.extract_final(x) for f, x in zip(functions, inters)]
            for key, inters in group_map.items()}
        if request.having is not None:
            finals = {k: v for k, v in finals.items()
                      if _eval_having(request.having, functions, v)}
        top_n = request.group_by.top_n
        results = []
        for fi, f in enumerate(functions):
            ordered = sorted(
                finals.items(),
                key=lambda kv: f.sortable_final(group_map[kv[0]][fi],
                                                final=kv[1][fi]),
                reverse=True)[:top_n]
            results.append(AggregationResult(
                function=f.result_name,
                group_by_columns=list(request.group_by.columns),
                group_by_result=[
                    {"group": [_json_val(g) for g in key], "value":
                     _final_str(vals[fi])}
                    for key, vals in ordered]))
        resp.aggregation_results = results

    def _reduce_group_cols(self, request: BrokerRequest,
                           merged: IntermediateResultsBlock,
                           resp: BrokerResponse,
                           functions: List[AggregationFunction]) -> None:
        """Vectorized finals for columnar group payloads: top-N per
        function via ONE stable argsort over the intermediate column —
        no per-group tuple keys, no python sort lambda per row. Bit
        parity with the row path: stable argsort of the negated values
        IS sorted(reverse=True) over first-occurrence group order, and
        per-cell finals go through the same extract_final/_fmt."""
        key_cols, inter_cols = merged.group_cols
        top_n = request.group_by.top_n
        results = []
        for fi, f in enumerate(functions):
            vals = inter_cols[fi]
            # sortable_desc_key reproduces sortable_final's comparison
            # semantics (exact int for COUNT, float for the rest), so
            # top-N ties land exactly where the row oracle's do
            order = np.argsort(sortable_desc_key(f, vals),
                               kind="stable")[:top_n]
            group_by_result = []
            for i in order:
                key = [_json_val(c[i]) if isinstance(c, np.ndarray)
                       else c[i] for c in key_cols]
                group_by_result.append(
                    {"group": key,
                     "value": _final_str(f.extract_final(
                         _json_val(vals[i])))})
            results.append(AggregationResult(
                function=f.result_name,
                group_by_columns=list(request.group_by.columns),
                group_by_result=group_by_result))
        resp.aggregation_results = results


def _eval_having(node: HavingNode, functions: List[AggregationFunction],
                 finals: List) -> bool:
    if node.operator == FilterOperator.AND:
        return all(_eval_having(c, functions, finals) for c in node.children)
    if node.operator == FilterOperator.OR:
        return any(_eval_having(c, functions, finals) for c in node.children)
    # leaf: find the function index matching the agg call
    idx = None
    for i, f in enumerate(functions):
        if f.name == node.agg.function_name.upper() and \
                f.column == node.agg.column:
            idx = i
            break
    if idx is None:
        raise ValueError(
            f"HAVING references {node.agg.call} not present in SELECT")
    v = finals[idx]
    if not isinstance(v, (int, float)):
        raise ValueError("HAVING on non-numeric aggregation result")
    if node.operator == FilterOperator.EQUALITY:
        return v == float(node.values[0])
    if node.operator == FilterOperator.NOT:
        return v != float(node.values[0])
    if node.operator == FilterOperator.IN:
        return any(v == float(x) for x in node.values)
    if node.operator == FilterOperator.RANGE:
        ok = True
        if node.lower is not None:
            lo = float(node.lower)
            ok &= (v >= lo) if node.lower_inclusive else (v > lo)
        if node.upper is not None:
            hi = float(node.upper)
            ok &= (v <= hi) if node.upper_inclusive else (v < hi)
        return ok
    raise ValueError(f"unsupported HAVING operator {node.operator}")


def _final_str(v):
    from pinot_tpu_torch.common.response import _fmt
    return _fmt(v)


def _json_val(v):
    import numpy as np
    if isinstance(v, np.generic):
        return v.item()
    if isinstance(v, bytes):
        return v.hex()
    return v
