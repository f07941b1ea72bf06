"""Broker-side two-stage requests: the stage-1 scans of a join and of a
window query.

Copy of the request builders of pinot_tpu/query/stages/broker.py
(`dim_scan_request`, `window_scan_request`). The JAX broker then
scatters them to the servers, collects the publish acks and stamps the
sources into the stage-2 requests; that asynchronous scatter waits for
the port's broker and TCP transport. Until then a caller runs stage 1
itself: each builder's request through a ServerQueryExecutor over the
table's segments, its DataTable published with ExchangeManager.put.

A join query runs: stage 1, the dim-side scan (dim WHERE conjuncts, join
key + referenced dim columns) on the dim table; stage 2, the fact scan
with the dim blocks as its JoinContext (stages/join.py:build_context).
A window query runs: stage 1, the scan (display + window input columns)
of every fact segment; stage 2, one coordinator fetching every block and
running the window kernels (stages/window.py:execute_window_stage).
"""
from __future__ import annotations

import copy

from pinot_tpu_torch.common.request import BrokerRequest, Selection
from pinot_tpu_torch.query.stages.join import DIM_CAP
from pinot_tpu_torch.query.stages.window import WINDOW_CAP, scan_columns


def dim_scan_request(request: BrokerRequest) -> BrokerRequest:
    """The stage-1 dim scan: dim-side WHERE + (key, referenced columns)
    selection, capped at the broadcast window (the publisher fails
    loudly when the filtered dim side exceeds it)."""
    join = request.join
    cols = [join.dim_key] + [c for c in join.dim_columns
                             if c != join.dim_key]
    return BrokerRequest(
        table_name=join.dim_table, filter=join.dim_filter,
        selection=Selection(columns=cols, order_by=[], offset=0,
                            size=DIM_CAP),
        limit=DIM_CAP)


def window_scan_request(sub: BrokerRequest,
                        request: BrokerRequest) -> BrokerRequest:
    """The stage-1 window scan for one physical sub-request: same table
    and filter, selecting display + window input columns, no windows."""
    scan = copy.copy(sub)
    scan.windows = []
    scan.selection = Selection(columns=scan_columns(request), order_by=[],
                               offset=0, size=WINDOW_CAP)
    scan.limit = WINDOW_CAP
    return scan
