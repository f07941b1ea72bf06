"""Stage-2 window executor: exchanged scan blocks → window rows.

Copy of pinot_tpu/query/stages/window.py. The device path runs the
port's K12 radix_sort and K13 window_scan (ops/csrc/sort_window.cu)
where the JAX package runs its jitted build_window_kernel; the host
twin `_host_window` is the JAX module's numpy, unchanged.

The broker's stage 1 scatters a plain selection scan (display columns +
window inputs) that every routed server publishes to the exchange; one
coordinator server fetches all blocks (its own through the in-process
registry), concatenates the columns in deterministic source order, and
runs the window kernels: ONE stable sort by (partition codes,
window-order keys), the input index breaking ties, then the row numbers
and running sums rebased at partition starts. The host oracle twin here mirrors it with a stable
np.lexsort and the same int32 arithmetic, so both paths are
bit-identical by construction.

Exactness contract:
- all windows of a query share one PARTITION BY / ORDER BY (one sort =
  one deterministic output order) — typed error otherwise;
- SUM(...) OVER is INTEGER-only and the executor rejects inputs whose
  running sums could leave int32 (the dtype every backend shares);
- output rows come back ordered by (partition, window order, input
  order) — the input order is itself deterministic (blocks sorted by
  source server, scan rows in segment order).
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from pinot_tpu_torch.common.request import BrokerRequest
from pinot_tpu_torch.query.blocks import ExecutionStats, \
    IntermediateResultsBlock
from pinot_tpu_torch.query.stages import exchange
from pinot_tpu_torch.query.stages.errors import StageCompileError
from pinot_tpu_torch.query.stages.join import columns_of

#: total row cap for one window evaluation (the exchanged blocks are
#: device-sorted as one array; past this, callers must narrow the WHERE)
WINDOW_CAP = 1 << 16


def scan_columns(request: BrokerRequest) -> List[str]:
    """Columns the stage-1 scan must ship: display + window inputs."""
    cols = list(request.selection.columns)
    for w in request.windows:
        for c in list(w.partition_by) + [s.column for s in w.order_by] + \
                ([w.column] if w.column else []):
            if c not in cols:
                cols.append(c)
    return cols


def _shared_window_frame(request: BrokerRequest):
    """(partition_by, order_by) shared by every window of the query."""
    w0 = request.windows[0]
    frame = (tuple(w0.partition_by),
             tuple((s.column, s.ascending) for s in w0.order_by))
    for w in request.windows[1:]:
        if (tuple(w.partition_by),
                tuple((s.column, s.ascending) for s in w.order_by)) != frame:
            raise StageCompileError(
                "all window functions of one query must share the same "
                "PARTITION BY and ORDER BY (one sort defines one "
                "deterministic output order)")
    return w0.partition_by, w0.order_by


def _factorize_i32(col) -> np.ndarray:
    arr = col if isinstance(col, np.ndarray) else \
        np.asarray(col, dtype=object)
    _uniq, inv = np.unique(arr, return_inverse=True)
    return inv.astype(np.int32)


def _int_lane(col, name: str, part: np.ndarray) -> np.ndarray:
    arr = col if isinstance(col, np.ndarray) else np.asarray(col)
    if arr.dtype.kind not in "iu":
        raise StageCompileError(
            f"SUM(...) OVER is integer-only (the int32 running-sum "
            f"exactness contract); column '{name}' decoded as "
            f"{arr.dtype}")
    if len(arr):
        # exact PER-PARTITION bound: running sums only accumulate
        # within a partition, so a query whose partitions each fit
        # int32 is safe even when the global abs-sum is not
        per_part = np.bincount(part,
                               weights=np.abs(arr.astype(np.int64)))
        if per_part.size and float(per_part.max()) >= 2 ** 31:
            raise StageCompileError(
                f"SUM({name}) OVER running sums can exceed int32 — "
                "narrow the scan (the int32 accumulator is the "
                "cross-backend exactness contract)")
    return arr.astype(np.int32)


def _host_window(part: np.ndarray, orders: List[np.ndarray],
                 sums: List[np.ndarray]):
    """Host oracle twin of the JAX build_window_kernel (same total sort
    order — stable lexsort with the input index as final tie-break —
    and the same int32 running sums)."""
    n = len(part)
    iota = np.arange(n, dtype=np.int64)
    keys = [iota] + [o for o in reversed(orders)] + [part]
    perm = np.lexsort(tuple(keys))
    sp = part[perm]
    new = np.ones(n, dtype=bool)
    new[1:] = sp[1:] != sp[:-1]
    starts = np.maximum.accumulate(np.where(new, iota, 0))
    # rank fits int32 trivially (row count is capped at WINDOW_CAP)
    rn = (iota - starts).astype(np.int32) + np.int32(1)
    run_sums = []
    for v in sums:
        sv = v[perm].astype(np.int64)
        cs = np.cumsum(sv)
        base = cs[starts] - sv[starts]
        run_sums.append((cs - base).astype(np.int32))
    return perm.astype(np.int64), rn, run_sums


def window_lanes(request: BrokerRequest, columns: Dict[str, object],
                 num_rows: int):
    """The window's int32 lanes over `num_rows` (> 0) assembled rows:
    (partition codes, order keys with DESC as ~code, SUM lanes)."""
    partition_by, order_by = _shared_window_frame(request)
    if partition_by:
        codes = [_factorize_i32(columns[c]) for c in partition_by]
        part = codes[0].astype(np.int64)
        for c in codes[1:]:
            part = part * (int(c.max()) + 1 if len(c) else 1) + c
        _u, inv = np.unique(part, return_inverse=True)
        part = inv.astype(np.int32)
    else:
        part = np.zeros(num_rows, dtype=np.int32)
    orders = []
    for s in order_by:
        code = _factorize_i32(columns[s.column])
        orders.append(code if s.ascending else ~code)
    sums = [_int_lane(columns[w.column], w.column, part)
            for w in request.windows if w.function == "SUM"]
    return part, orders, sums


def padded_lanes(part: np.ndarray, orders: List[np.ndarray],
                 sums: List[np.ndarray], device):
    """The lanes padded to a power of two, as the JAX kernel takes them,
    in one upload to `device`: (part, [order keys], [SUM lanes]), int32
    tensors [n_pad] each."""
    import torch

    from pinot_tpu_torch.ops import kernels
    n = len(part)
    n_pad = kernels.pow2_bucket(max(n, 1))
    lanes = np.zeros((1 + len(orders) + len(sums), n_pad), dtype=np.int32)
    for row, a in enumerate([part] + list(orders) + list(sums)):
        lanes[row, :n] = a
    dev = torch.from_numpy(lanes).to(device)
    return dev[0], list(dev[1:1 + len(orders)]), list(dev[1 + len(orders):])


def _device_window(part: np.ndarray, orders: List[np.ndarray],
                   sums: List[np.ndarray], device):
    """The window on `device`: K12 sorts, K13 numbers and sums
    (ops/kernels.py:run_window_kernel) over the padded lanes; one upload
    of the lanes, one download of the outputs. The lanes are ledgered
    (kind "window") for the dispatch's duration."""
    from pinot_tpu_torch.obs import residency
    from pinot_tpu_torch.ops import kernels
    from pinot_tpu_torch.query.execution import pull
    n = len(part)
    dpart, dorders, dsums = padded_lanes(part, orders, sums, device)
    owner = f"win:{id(dpart)}"
    residency.LEDGER.register(owner, table="", segment="", kind="window",
                              nbytes=dpart.untyped_storage().nbytes())
    try:
        outs = pull(kernels.run_window_kernel(dpart, tuple(dorders),
                                              tuple(dsums), n))
    finally:
        residency.LEDGER.release(owner)
    perm = outs["win.perm"][:n].astype(np.int64)
    rn = outs["win.rn"][:n].astype(np.int32)
    run_sums = [outs[f"win.sum{j}"][:n].astype(np.int32)
                for j in range(len(sums))]
    return perm, rn, run_sums


def execute_window(request: BrokerRequest,
                   columns: Dict[str, object],
                   num_rows: int,
                   use_device: bool = True,
                   device=None) -> IntermediateResultsBlock:
    """Window evaluation over assembled columns → selection block whose
    rows are (display cols..., window values...) in window order.
    use_device: the kernels on `device` (None: the card; "cpu": their
    plain versions), else the numpy twin."""
    if num_rows > WINDOW_CAP:
        raise StageCompileError(
            f"window input has {num_rows} rows > cap {WINDOW_CAP} — "
            "narrow the WHERE filter")
    _shared_window_frame(request)
    if num_rows:
        part, orders, sums = window_lanes(request, columns, num_rows)
        if use_device:
            from pinot_tpu_torch.common.device import resolve_device
            perm, rn, run_sums = _device_window(part, orders, sums,
                                                resolve_device(device))
        else:
            perm, rn, run_sums = _host_window(part, orders, sums)
    else:
        perm = np.zeros(0, np.int64)
        rn = np.zeros(0, np.int32)
        run_sums = [np.zeros(0, np.int32)
                    for w in request.windows if w.function == "SUM"]

    display = list(request.selection.columns)
    out_cols: List[object] = []
    for c in display:
        col = columns[c]
        if isinstance(col, np.ndarray):
            out_cols.append(col[perm])
        else:
            out_cols.append([col[i] for i in perm])
    si = 0
    for w in request.windows:
        if w.function == "ROW_NUMBER":
            out_cols.append(rn.astype(np.int64))
        else:
            out_cols.append(run_sums[si].astype(np.int64))
            si += 1

    blk = IntermediateResultsBlock()
    blk.selection_cols = out_cols
    blk.selection_columns = display + [w.result_name
                                       for w in request.windows]
    blk.stats = ExecutionStats(num_docs_scanned=num_rows,
                               num_segments_processed=0,
                               total_docs=num_rows)
    return blk


def execute_window_stage(request: BrokerRequest, sources: List[dict],
                         deadline_s: Optional[float] = None,
                         use_device: bool = True, device=None
                         ) -> IntermediateResultsBlock:
    """Coordinator entry: fetch every stage-1 block, concatenate columns
    in deterministic source order, run the window kernel."""
    ordered = sorted(sources, key=lambda s: (str(s.get("server")),
                                             str(s.get("id"))))
    blocks = exchange.fetch_blocks(ordered, deadline_s)
    names = scan_columns(request)
    col_parts: Dict[str, list] = {c: [] for c in names}
    total = 0
    for dt in blocks:
        cols = columns_of(dt)
        n = dt.num_rows()
        total += n
        for c in names:
            if c not in cols:
                raise StageCompileError(
                    f"stage-1 window block is missing column '{c}'")
            col_parts[c].append(cols[c])
    columns: Dict[str, object] = {}
    for c, parts in col_parts.items():
        if parts and all(isinstance(p, np.ndarray) for p in parts):
            columns[c] = np.concatenate(parts)
        else:
            merged: list = []
            for p in parts:
                merged.extend(list(p))
            columns[c] = merged
    return execute_window(request, columns, total, use_device=use_device,
                          device=device)
