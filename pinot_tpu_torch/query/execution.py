"""Segment plan execution: run the device kernels, finish results host-side.

Counterpart of pinot_tpu/query/execution.py. One dispatch per segment
(K1, then K3, or K2 with K4 / K5, and K6 for a selection; K9 ahead
of K1 for an IVF probe and K8 ahead of K6 for a vector selection:
ops/kernels.py:run_segment_kernel) and one device→host pull: for a
group-by only the non-empty groups cross, picked out on the device first,
so a 2^21-slot table never crosses PCIe whole; a selection's [k] docids
and gathered columns cross in the same single copy.
The host finishers are the JAX package's (exact int64 shift-combine of
part sums, histogram and dictId → value decode, mixed-radix key decode),
reading the same output names. Plans of one segment that share a compiled
spec run batched (execute_segment_plans_batched): one launch per kernel
for up to 8 of them, and one pull.
"""
from __future__ import annotations

import copy
import time
from typing import Dict, List, Tuple

import numpy as np
import torch

from pinot_tpu_torch.common import expression as expr_mod
from pinot_tpu_torch.common.request import VECTOR_RESULT_COLUMNS
from pinot_tpu_torch.common.sketches import DEFAULT_LOG2M, HyperLogLog, \
    union_serialized_hlls
from pinot_tpu_torch.obs import profiler as obs_profiler
from pinot_tpu_torch.ops import kernels
from pinot_tpu_torch.query.blocks import ExecutionStats, \
    IntermediateResultsBlock


def _count_filter_leaves(spec) -> int:
    if spec is None or spec[0] in ("match_all", "empty"):
        return 0
    if spec[0] in ("and", "or"):
        return sum(_count_filter_leaves(c) for c in spec[1])
    if spec[0] == "pred" and spec[1] in ("vdoc", "ivf_probe"):
        return 0      # engine-injected (upsert mask, ANN probe), not a
    return 1          # query leaf


def gather_operands_for(segment, needed_cols) -> Dict[str, torch.Tensor]:
    cols: Dict[str, torch.Tensor] = {}
    for col, kind in needed_cols:
        if kind == "vdoc":
            # upsert validDocIds: the segment's own liveness lane, cached
            # by the bitmap's version (loader.device_valid_lane)
            cols[f"{col}.vdoc"] = segment.device_valid_lane()
            continue
        ds = segment.data_source(col)
        if kind == "ids":
            cols[f"{col}.ids"] = ds.device_dict_ids()
        elif kind == "mv":
            cols[f"{col}.mv"] = ds.device_mv_dict_ids()
        elif kind == "raw":
            cols[f"{col}.raw"] = ds.device_raw_values()
        elif kind == "parts":
            cols[f"{col}.parts"] = ds.device_part_lanes()
        elif kind == "vlane":
            cols[f"{col}.vlane"] = ds.device_value_lane()
        elif kind == "hllidx":
            cols[f"{col}.hllidx"] = ds.device_hll_idx()
        elif kind == "hllrank":
            cols[f"{col}.hllrank"] = ds.device_hll_rank()
        elif kind == "vec":
            cols[f"{col}.vec"] = ds.device_vec_values()
        elif kind == "ivfa":
            cols[f"{col}.ivfa"] = ds.device_ivf_assign()
        elif kind == "ivfc":
            cols[f"{col}.ivfc"] = ds.device_ivf_centroids()
        elif kind == "ivfv":
            cols[f"{col}.ivfv"] = ds.device_ivf_valid()
        else:
            raise ValueError(f"lane kind {kind}")
    return cols


def gather_operands(plan) -> Dict[str, torch.Tensor]:
    return gather_operands_for(plan.segment, plan.needed_cols)


def pull(outs: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """Device tensors → numpy in ONE device→host copy: every output is
    viewed as bytes, the widest elements first (so each output starts at
    a multiple of its element size), concatenated on the device, copied
    once, and cut back into arrays of the original dtypes and shapes.
    The copy counts as a dispatch on the ambient query profile
    (obs/profiler.py:profiled_device_get)."""
    return obs_profiler.profiled_device_get(_pull, outs)


def _pull(outs: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    if not outs:
        return {}
    names = sorted(outs, key=lambda n: -outs[n].element_size())
    flat = [outs[n].contiguous().reshape(-1).view(torch.uint8)
            for n in names]
    host = torch.cat(flat).cpu().numpy()
    res: Dict[str, np.ndarray] = {}
    pos = 0
    for n, f in zip(names, flat):
        arr = host[pos:pos + f.numel()].view(_np_dtype(outs[n].dtype))
        res[n] = arr.reshape(tuple(outs[n].shape))
        pos += f.numel()
    return res


def _np_dtype(dtype: torch.dtype) -> np.dtype:
    return np.dtype(str(dtype).replace("torch.", ""))


def execute_segment_plan(plan) -> IntermediateResultsBlock:
    if plan.fast_path_result is not None:
        return plan.fast_path_result
    return _execute_segment_plan(plan)


def _execute_segment_plan(plan) -> IntermediateResultsBlock:
    segment = plan.segment
    t0 = time.perf_counter()
    cols = gather_operands(plan)
    blk = IntermediateResultsBlock()
    if plan.group_spec is not None:
        from pinot_tpu_torch.query.plan import drive_group_execution

        def run(agg_specs, group_spec, extra_params=()):
            return pull_group_outputs(kernels.run_segment_kernel(
                segment.padded_docs, plan.filter_spec, agg_specs,
                group_spec, plan.select_spec, cols, tuple(plan.params),
                segment.num_docs, segment.device,
                tuple(plan.group_params) + tuple(extra_params)
                if group_spec is not None else ()))

        outs, spec_used = drive_group_execution(
            run, plan.group_spec, segment.padded_docs, segment.num_docs)
        finish_group_outputs(plan, spec_used, outs, blk)
        matched = int(outs["stats.num_docs_matched"])
    else:
        outs = pull(kernels.run_segment_kernel(
            segment.padded_docs, plan.filter_spec, plan.agg_specs, None,
            plan.select_spec, cols, tuple(plan.params), segment.num_docs,
            segment.device))
        matched = _finish_block(plan, outs, blk)
    blk.stats = _segment_stats(plan, matched,
                               (time.perf_counter() - t0) * 1e3)
    return blk


def execute_segment_plans_batched(plans) -> List[IntermediateResultsBlock]:
    """N plans over ONE segment that share a batch_signature
    (query/plan.py): each kernel launches once per chunk of up to 8
    members (ops/kernels.py:run_segment_kernel_batched), the lanes
    gathered once from the lead plan and read once per chunk, and every
    member's outputs cross to the host in one pull. Each member's slice
    goes through the sequential path's finishers, so batched and
    sequential answers agree bit for bit; each member reports its own
    matches and the batch's wall time, as
    pinot_tpu/query/execution.py:execute_segment_plans_batched does."""
    if len(plans) == 1:
        return [execute_segment_plan(plans[0])]
    lead = plans[0]
    segment = lead.segment
    t0 = time.perf_counter()
    cols = gather_operands(lead)
    outs_b = pull(kernels.run_segment_kernel_batched(
        segment.padded_docs, lead.filter_spec, lead.agg_specs,
        lead.select_spec, cols, [tuple(p.params) for p in plans],
        segment.num_docs, segment.device))
    elapsed_ms = (time.perf_counter() - t0) * 1e3
    blocks = []
    for b, plan in enumerate(plans):
        blk = IntermediateResultsBlock()
        matched = _finish_block(plan, {k: v[b] for k, v in outs_b.items()},
                                blk)
        blk.stats = _segment_stats(plan, matched, elapsed_ms)
        blocks.append(blk)
    return blocks


def _finish_block(plan, outs, blk) -> int:
    """A plan without group-by: its aggregations and selection finished
    into `blk` from the pulled outputs; returns its matched rows."""
    if plan.agg_specs:
        _finish_aggregation(plan, outs, blk)
    if plan.select_spec is not None:
        if plan.select_spec[0] == "vector":
            _finish_vector(plan, outs, blk)
        else:
            _finish_selection(plan, outs, blk)
    return int(outs["stats.num_docs_matched"])


def _segment_stats(plan, matched: int, time_ms: float) -> ExecutionStats:
    segment = plan.segment
    n_leaves = _count_filter_leaves(plan.filter_spec)
    n_project = len({c for c, _ in plan.needed_cols})
    return ExecutionStats(
        num_docs_scanned=matched,
        num_entries_scanned_in_filter=n_leaves * segment.num_docs,
        num_entries_scanned_post_filter=matched * max(n_project - n_leaves, 0),
        num_segments_processed=1,
        num_segments_matched=1 if matched else 0,
        total_docs=segment.num_docs,
        time_used_ms=time_ms)


def _nonempty_groups(outs: Dict[str, torch.Tensor]
                     ) -> Dict[str, torch.Tensor]:
    """Select the groups with count > 0 on the device: `group.nz` holds
    their keys, every per-group output keeps only those slots; the stats
    outputs and the overflow flag pass as they are."""
    count = outs["group.count"]
    nz = torch.nonzero(count).reshape(-1)
    sel: Dict[str, torch.Tensor] = {
        "group.nz": nz.to(torch.int64),
        "group.count": count[nz]}
    for name, t in outs.items():
        if name.startswith("gagg"):
            sel[name] = t[..., nz]
        elif name.startswith("stats.") or name == "group.overflow":
            sel[name] = t
    return sel


def _ranked_groups(outs: Dict[str, torch.Tensor]
                   ) -> Dict[str, torch.Tensor]:
    """The ranked layout's [.., cap] tables cut to the most distinct keys
    any segment holds: ranks past a segment's own count hold nothing."""
    n = int((outs["group.rcount"] > 0).sum(-1).max())
    return {name: t[..., :n] if name.startswith(("gagg", "group.r"))
            else t for name, t in outs.items()}


def pull_group_outputs(outs: Dict[str, torch.Tensor]
                       ) -> Dict[str, np.ndarray]:
    """A group-by dispatch's outputs on the host: dense tables cut to
    their non-empty groups on the device, ranked ones to their used
    ranks; a scout's (no group tables) as they are."""
    if "group.rkeys" in outs:
        return pull(_ranked_groups(outs))
    if "group.count" in outs:
        return pull(_nonempty_groups(outs))
    return pull(outs)


def finish_group_outputs(plan, spec_used, outs, blk) -> None:
    """blk.group_map from drive_group_execution's result: empty when the
    scout matched nothing (spec_used None), else finished under the spec
    the tables were made with (its remaps decode the keys)."""
    if spec_used is None:
        blk.group_map = {}
        return
    _finish_group_by(_with_group_spec(plan, spec_used), outs, blk)


def _with_group_spec(plan, spec_used):
    """The plan to finish with: a copy holding the spec the tables were
    made with (an adaptive remap's), so that the cached plan is never
    changed."""
    if spec_used is plan.group_spec:
        return plan
    p = copy.copy(plan)
    p.group_spec = spec_used
    return p


# ---------------------------------------------------------------------------


def _decode_gather_columns(segment, gather_cols, outs) -> List:
    """Per-column decoded value arrays of a selection's gathered lanes."""
    col_values = []
    for col, source in gather_cols:
        ds = segment.data_source(col)
        lane = np.asarray(outs[f"sel.{col}"])
        if source == "sv":
            vals = ds.dictionary.decode(np.clip(lane, 0,
                                                ds.metadata.cardinality - 1))
        elif source == "raw":
            vals = lane
        else:  # mv: [k, W] padded ids
            card = ds.metadata.cardinality
            vals = [[_plain(ds.dictionary.get(i)) for i in row if i < card]
                    for row in lane]
        col_values.append(vals)
    return col_values


def vector_segment_identity(segment) -> Tuple[str, int]:
    """(logical segment name, docid base) of vector result rows
    (pinot_tpu/query/execution.py:vector_segment_identity): a consuming
    segment's `__frozen` / `__tail` views name one logical segment, the
    tail's docids offset by its start."""
    name = getattr(segment, "segment_name", "?")
    for suffix in ("__frozen", "__tail"):
        if name.endswith(suffix):
            name = name[: -len(suffix)]
    return name, int(getattr(segment, "start", 0) or 0)


def vector_result_rows(decode_segment, select_spec, outs, seg_name: str,
                       doc_base: int) -> List[tuple]:
    """Rows (user columns..., $docId, $segmentName, $score) of one
    segment's vector selection, in the kernel's order (score descending,
    then docid). `decode_segment` gives the decode tables (the union view
    on the stacked path); the name and base give the rows' identity."""
    _kind, _k, _order, gather_cols = select_spec
    docids = np.asarray(outs["sel.docids"])
    scores = np.asarray(outs["sel.scores"])
    col_values = _decode_gather_columns(decode_segment, gather_cols, outs)
    return [tuple(_plain(cv[r]) for cv in col_values) +
            (int(docids[r]) + doc_base, seg_name, float(scores[r]))
            for r in range(len(docids)) if docids[r] >= 0]


def _finish_vector(plan, outs, blk) -> None:
    name, base = vector_segment_identity(plan.segment)
    blk.selection_rows = vector_result_rows(plan.segment, plan.select_spec,
                                            outs, name, base)
    blk.selection_columns = [c for c, _ in plan.select_spec[3]] + \
        list(VECTOR_RESULT_COLUMNS)
    blk.selection_display_cols = None


def _finish_selection(plan, outs, blk) -> None:
    """Rows of the valid docids, in the kernel's order, decoded."""
    _kind, _k, _order, gather_cols = plan.select_spec
    docids = np.asarray(outs["sel.docids"])
    valid = docids >= 0
    col_values = _decode_gather_columns(plan.segment, gather_cols, outs)
    blk.selection_rows = [tuple(_plain(cv[r]) for cv in col_values)
                          for r in range(len(docids)) if valid[r]]
    blk.selection_columns = [c for c, _ in gather_cols]
    blk.selection_display_cols = plan.select_display


def _finish_aggregation(plan, outs, blk) -> None:
    inters: List = []
    for i, (f, spec) in enumerate(zip(plan.functions, plan.agg_specs)):
        fname, col, source, extra = spec
        strategy = extra[0] if isinstance(extra, tuple) else None
        if fname in ("count", "countmv"):
            inters.append(int(outs[f"agg{i}"]))
        elif fname == "hll":
            # the fused K4's registers → the HyperLogLog intermediate every combine
            # and reduce layer merges by register max
            regs = np.asarray(outs[f"agg{i}.hll"]).astype(np.uint8)
            inters.append(HyperLogLog(DEFAULT_LOG2M, regs))
        elif source == "sv" and fname in ("sum", "avg") and \
                strategy in ("parts", "vlane"):
            cnt = int(outs[f"agg{i}.count"])
            if strategy == "parts":
                n_parts, min_v = plan.segment.data_source(col).int_part_info()
                # [n_parts] fully device-reduced sums, exact int64 combine
                arr = np.asarray(outs[f"agg{i}.parts"]).astype(
                    np.int64).reshape(-1, n_parts).sum(axis=0)
                s = float(sum(int(arr[k]) << (7 * k)
                              for k in range(n_parts)) + min_v * cnt)
            else:
                s = float(np.asarray(outs[f"agg{i}.vsum"],
                                     dtype=np.float64).sum())
            inters.append(s if fname == "sum" else (s, cnt))
        elif fname == "hist":
            # expression aggregation: transform the dictionary value table
            # (O(cardinality)) and finish from the device histogram
            src_vals = np.asarray(
                plan.segment.data_source(col).dictionary.values)
            tv = np.asarray(expr_mod.evaluate(f.column, lambda _: src_vals))
            inters.append(f.from_histogram(np.asarray(outs[f"agg{i}"]), tv))
        elif source in ("sv", "mv") and fname in (
                "sum", "avg", "percentile", "distinctcount"):
            # dictId (or MV entry) histogram: the function finishes from
            # the counts and the dictionary values
            ds = plan.segment.data_source(col)
            dict_vals = ds.dictionary.values
            if f.info.base == "FASTHLL" and \
                    getattr(ds.metadata, "derived_metric_type",
                            None) == "HLL":
                # derived serialized-HLL column: union the sketches of the
                # present dictionary values
                hist = np.asarray(outs[f"agg{i}"])[: len(dict_vals)]
                inters.append(union_serialized_hlls(
                    np.asarray(dict_vals)[np.nonzero(hist)[0]]))
            else:
                inters.append(f.from_histogram(np.asarray(outs[f"agg{i}"]),
                                               dict_vals))
        elif source in ("sv", "mv") and fname in ("min", "max",
                                                  "minmaxrange"):
            dict_vals = plan.segment.data_source(col).dictionary.values
            mn = outs.get(f"agg{i}.min")
            mx = outs.get(f"agg{i}.max")
            inters.append(f.from_minmax_ids(
                None if mn is None else int(mn),
                None if mx is None else int(mx), dict_vals))
        elif source == "raw":
            if fname in ("sum", "avg"):
                s = float(np.asarray(outs[f"agg{i}.vsum"],
                                     dtype=np.float64).sum())
                inters.append(s if fname == "sum" else
                              (s, int(outs[f"agg{i}.count"])))
            else:
                mn = outs.get(f"agg{i}.min")
                mx = outs.get(f"agg{i}.max")
                mn = None if mn is None or not np.isfinite(mn) else float(mn)
                mx = None if mx is None or not np.isfinite(mx) else float(mx)
                inters.append(mn if fname == "min" else
                              mx if fname == "max" else (mn, mx))
        else:
            raise ValueError(f"unexpected agg spec {spec}")
    blk.agg_intermediates = inters


def _decode_group_values(plan, nz: np.ndarray) -> List[np.ndarray]:
    """Mixed-radix decode of group keys `nz` into per-column value arrays:
    expression keys through their transformed value table (collisions
    merge in _assemble_group_map), a join's jcode / jraw keys through the
    dim value table (their codes are its indices already,
    pinot_tpu/query/execution.py:329-333), rawoff keys as id + min, the
    others through the dictionary; the adaptive remaps first map back
    to dictIds (idoff: + the offset, idrank: the present id of the rank),
    as pinot_tpu/query/execution.py:308-345 does."""
    gcols, strides, _g_pad, _specs, _kmax = plan.group_spec
    vtables = plan.group_value_tables or (None,) * len(gcols)
    value_cols = []
    for (c, gkind, off, card), stride, tv in zip(gcols, strides, vtables):
        ids = (nz // stride) % card
        if gkind == "idoff":
            ids = ids + off              # re-base the offset remap
        elif gkind == "idrank":
            # `off` holds the present ids; only non-empty groups reach
            # here, so every rank is one of them
            ids = np.asarray(off)[ids]
        if tv is not None:
            value_cols.append(tv[ids])
        elif gkind == "rawoff":
            value_cols.append(ids.astype(np.int64) + off)
        else:
            value_cols.append(
                plan.segment.data_source(c).dictionary.decode(ids))
    return value_cols


def _decode_extreme_ids(plan, spec, arr: np.ndarray, which: str
                        ) -> np.ndarray:
    """dictId-domain per-group extrema → float values (inf when empty);
    raw-column extrema are values already."""
    _fname, col, source, extra = spec
    if source == "sv" and isinstance(extra, tuple) and extra[0] == "ids":
        vals = plan.segment.data_source(col).dictionary.values
        card = len(vals)
        if which == "min":
            valid = arr < card
            sentinel = np.inf
        else:
            valid = arr >= 0
            sentinel = -np.inf
        out = np.full(len(arr), sentinel)
        safe = np.clip(arr, 0, card - 1)
        out[valid] = np.asarray(vals, dtype=np.float64)[safe][valid]
        return out
    return arr


def _assemble_group_map(plan, blk, value_cols, per_agg_arrays,
                        n_groups: int) -> None:
    group_map: Dict[Tuple, List] = {}
    for row in range(n_groups):
        key = tuple(_plain(vc[row]) for vc in value_cols)
        inters: List = []
        for kind, a, b in per_agg_arrays:
            if kind == "count":
                inters.append(int(a[row]))
            elif kind == "sum":
                inters.append(float(a[row]))
            elif kind == "avg":
                inters.append((float(a[row]), int(b[row])))
            elif kind in ("min", "max"):
                v = float(a[row])
                inters.append(None if not np.isfinite(v) else v)
            else:  # minmaxrange
                mn, mx = float(a[row]), float(b[row])
                inters.append((None if not np.isfinite(mn) else mn,
                               None if not np.isfinite(mx) else mx))
        old = group_map.get(key)
        if old is not None:
            # expression keys can collide (a non-injective transform):
            # merge as the cross-segment combine does
            inters = [f.merge(o, v) for f, o, v in
                      zip(plan.functions, old, inters)]
        group_map[key] = inters
    blk.group_map = group_map


def _finish_group_by(plan, outs, blk) -> None:
    """`outs` holds the non-empty groups only (_nonempty_groups): their
    keys in `group.nz`, their counts and sums in the JAX output names
    (K3's psums / csums, the compacted tables' cpsums, [C, L, nz] chunks
    added here in int64, and sum); a ranked layout's go to
    _finish_group_by_ranked."""
    if "group.rkeys" in outs:
        _finish_group_by_ranked(plan, outs, blk)
        return
    gcols, strides, g_pad, agg_specs, kmax = plan.group_spec
    nz = outs["group.nz"]
    counts = outs["group.count"]
    value_cols = _decode_group_values(plan, nz)

    def _sum_array(i, spec):
        """Exact f64 per-group sums from the device partials."""
        fname, col, source, extra = spec
        if f"gagg{i}.csums" in outs:
            return np.asarray(outs[f"gagg{i}.csums"], dtype=np.float64)
        if f"gagg{i}.sum" in outs:
            return np.asarray(outs[f"gagg{i}.sum"], dtype=np.float64)
        arr = np.asarray(outs[f"gagg{i}.psums"] if f"gagg{i}.psums" in outs
                         else outs[f"gagg{i}.cpsums"]).astype(np.int64)
        if arr.ndim == 3:                  # [C, L, nz] chunks
            arr = arr.sum(axis=0)
        _, min_v = plan.segment.data_source(col).int_part_info()
        shifts = np.left_shift(np.int64(1),
                               7 * np.arange(arr.shape[0], dtype=np.int64))
        totals = (arr * shifts[:, None]).sum(0)
        totals = totals + np.int64(min_v) * counts.astype(np.int64)
        return totals.astype(np.float64)

    def _extreme_array(i, spec, which):
        """Per-group min/max as float values (inf sentinels when empty)."""
        return _decode_extreme_ids(plan, spec, outs[f"gagg{i}.{which}"],
                                   which)

    per_agg_arrays = []
    for i, spec in enumerate(agg_specs):
        fname = spec[0]
        if fname == "count":
            per_agg_arrays.append(("count", counts, None))
        elif fname == "sum":
            per_agg_arrays.append(("sum", _sum_array(i, spec), None))
        elif fname == "avg":
            per_agg_arrays.append(("avg", _sum_array(i, spec), counts))
        elif fname in ("min", "max"):
            per_agg_arrays.append((fname, _extreme_array(i, spec, fname),
                                   None))
        elif fname == "minmaxrange":
            per_agg_arrays.append(("minmaxrange",
                                   _extreme_array(i, spec, "min"),
                                   _extreme_array(i, spec, "max")))
        else:
            raise ValueError(fname)

    _assemble_group_map(plan, blk, value_cols, per_agg_arrays, len(nz))


def _finish_group_by_ranked(plan, outs, blk) -> None:
    """The ranked layout (pinot_tpu/query/execution.py:
    _finish_group_by_ranked): tables addressed by each segment's group
    ranks beside group.rkeys ([K], or [S, K] over a stack); every
    segment's valid (key, partial) entries merge by key here, columnar
    (np.unique, np.add.at, minimum.at / maximum.at)."""
    gcols, strides, g_pad, agg_specs, kmax = plan.group_spec
    rkeys = np.asarray(outs["group.rkeys"])
    rcount = np.asarray(outs["group.rcount"])
    single = rkeys.ndim == 1
    if single:                               # one segment: [S=1, K]
        rkeys, rcount = rkeys[None], rcount[None]
    valid = rkeys < g_pad                    # [S, K]
    nz, inverse = np.unique(rkeys[valid], return_inverse=True)
    counts_nz = np.zeros(len(nz), np.int64)
    np.add.at(counts_nz, inverse, rcount[valid].astype(np.int64))
    value_cols = _decode_group_values(plan, nz)

    def _sum_array(i, spec):
        fname, col, source, extra = spec
        if f"gagg{i}.rpsums" in outs:
            a = np.asarray(outs[f"gagg{i}.rpsums"]).astype(np.int64)
            if single:                       # [L, K] or [C, L, K]
                a = (a.sum(axis=0) if a.ndim == 3 else a)[None]
            elif a.ndim == 4:                # [S, C, L, K]
                a = a.sum(axis=1)
            vals = np.moveaxis(a, 1, 2)[valid]          # [M, L]
            sums = np.zeros((len(nz), vals.shape[1]), np.int64)
            np.add.at(sums, inverse, vals)
            _, min_v = plan.segment.data_source(col).int_part_info()
            shifts = np.left_shift(
                np.int64(1), 7 * np.arange(sums.shape[1], dtype=np.int64))
            totals = (sums * shifts[None, :]).sum(1)
            return (totals + np.int64(min_v) * counts_nz).astype(np.float64)
        a = np.asarray(outs[f"gagg{i}.rsum"], dtype=np.float64)
        if a.ndim == 1:
            a = a[None]
        sums = np.zeros(len(nz), np.float64)
        np.add.at(sums, inverse, a[valid])
        return sums

    def _extreme_array(i, spec, which):
        a = np.asarray(outs[f"gagg{i}.r{which}"])
        if a.ndim == 1:
            a = a[None]
        red = np.minimum if which == "min" else np.maximum
        if a.dtype.kind in "iu":             # dictId domain
            sentinel = spec[3][1] if which == "min" else -1
            out = np.full(len(nz), sentinel, np.int64)
            red.at(out, inverse, a[valid].astype(np.int64))
            return _decode_extreme_ids(plan, spec, out, which)
        out = np.full(len(nz), np.inf if which == "min" else -np.inf)
        red.at(out, inverse, a[valid].astype(np.float64))
        return out

    per_agg_arrays = []
    for i, spec in enumerate(agg_specs):
        fname = spec[0]
        if fname == "count":
            per_agg_arrays.append(("count", counts_nz, None))
        elif fname == "sum":
            per_agg_arrays.append(("sum", _sum_array(i, spec), None))
        elif fname == "avg":
            per_agg_arrays.append(("avg", _sum_array(i, spec), counts_nz))
        elif fname in ("min", "max"):
            per_agg_arrays.append((fname, _extreme_array(i, spec, fname),
                                   None))
        elif fname == "minmaxrange":
            per_agg_arrays.append(("minmaxrange",
                                   _extreme_array(i, spec, "min"),
                                   _extreme_array(i, spec, "max")))
        else:
            raise ValueError(fname)

    _assemble_group_map(plan, blk, value_cols, per_agg_arrays, len(nz))


def _plain(v):
    if isinstance(v, np.generic):
        return v.item()
    return v
