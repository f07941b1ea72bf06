#!/usr/bin/env python3
"""Drive pinot_tpu_torch on one CUDA card: build, kernel checks, SSB
Q1.1-Q4.3 in memory, baseballStats from disk under the QueryGenerator
mix with its selections, and VECTOR_SIMILARITY over the 10M x 128 vector
table with IVF codebooks, each table per segment and stacked (one launch
per kernel over all segments).

    python3 chip_smoke.py [--sf 10] [--segments 8] [--repeats 5] [--seed 0]
                          [--bb-rows 10000000] [--bb-segments 4]
                          [--vec-rows 10000000] [--vec-segments 4]
                          [--vec-dim 128] [--vec-queries 5]

Phases, each printed as one JSON line; any failure ends the run with a
non-zero exit and no result line:

1. device: the card's name, and its name and power limit from nvidia-smi.
2. build: nvcc builds the kernels from ops/csrc/ (one process per source,
   all at once) into build/pinot_tpu_torch/<hash>/.
3. data: the SSB lineorder table at scale factor --sf (6,000,000 rows per
   scale factor) in --segments segments, made from --seed.
4. kernel check: K1-K3 against their plain PyTorch versions on the card,
   on the lanes and parameters the SSB plans give them on segment 0
   (integer outputs equal, float64 sums within CSUMS_RTOL), timed with
   CUDA events and an L2 flush before each launch, beside their bounds.
   K3 runs on every group-by query, and where its table fits a block's
   shared memory, also with the shared tables forced on and forced off.
5. ssb: launch counts set to 0, the 13 queries run once through
   QueryEngine on the card and are checked against the numpy oracle, the
   counts read (K1-K3 must have launched); then --repeats timed runs per
   query give the p50.
6. bb_data: the baseballStats table (Apache Pinot's quickstart schema),
   --bb-rows rows in --bb-segments segments, each written by the port's
   SegmentCreator from its own seed into a directory under build/, the
   raw-key table (baseball.RAW_KEY_ROWS rows in one segment, runs, hits
   and salary without a dictionary) and the MV metric table
   (baseball.MV_METRIC_ROWS rows in one segment, a multi-value INT
   column), then loaded with QueryEngine.from_dirs on the card.
7. bb_kernel_check: K1 (raw and MV programs), K2 (runs and hits part
   lanes), K3 (sums and min / max; MV keys over position alone, position
   x league and valuein(position, ...) x league with count, SUM(hits)
   and MIN(runs); raw keys on the raw-key segment), K4 (ids, and MV
   entries of position), K5 (ids, raw, and MV entries of position and of
   an int16 MV lane built for the check) and K7 (HLL registers of
   playerName and teamID) against their plain versions on segment 0's
   lanes (min / max, counts, part sums, histograms and registers equal;
   float64 sums within CSUMS_RTOL), timed beside their bounds and, where
   one PyTorch call does the same, that call (torch.bincount for K4,
   scatter_reduce amax for K7); K3 as in phase 4.
8. select_kernel_check: K6 against its plain version on segment 0's lanes
   for each select kind (limit; order on runs, hits and on the heavily
   tied league; ordertk on salary; ordermk on teamID, salary and on int64
   / float64 lanes built for the check), at k = 16, 2048 and 65,536, under
   the masks yearID >= 2000, match-all and empty: docids, count and every
   gathered column bit-equal; timed beside its bound, the plain version
   and, where one PyTorch call does the same (torch.nonzero for limit,
   torch.topk on the masked int64 key (word, docid) for one key word),
   that call.
9. baseball: launch and path counts set to 0, the aggregation, group-by,
   HAVING, selection, two-key ORDER BY and MV group-by draws of the
   QueryGenerator mix (the reference seeds), the fixed queries and
   selections, one query per device shape (HLL, MV and expression
   aggregations, expression, MV and valuein keys), the raw-key table's
   group-bys and the MV metric table's queries (MINMV ... PERCENTILE50MV,
   COUNTMV, DISTINCTCOUNTMV, GROUP BY a numeric MV column) run once and
   are checked against the vectorised oracles; the host twin must have answered exactly the draws the JAX
   planner refuses (the 5 group-by DISTINCTCOUNT draws and
   COUNTMV(valuein(...))), and the pruner and a fast path must have
   served segments; the launch counts read (all seven kernels must have
   launched); then --repeats timed runs per device-answered query give
   the per-family p50 (the host-answered draws are timed by their one
   checked run: numpy takes seconds on them).
10. stacked_kernel_check (after phase 5, on the SSB segments stacked
   by parallel.ShardedQueryExecutor): the stacked K1 (mask and
   per-segment matches, Q1.1), K2 (one exact row per segment), K3 (int64
   part sums and csums over the whole stack, Q2.1, Q3.2, Q4.3), K6 (a top
   k per segment, two selections over lineorder) and K4, K5 and K7 over
   the stack's flat rows, each against its plain stacked version and
   against S per-segment launches on the same lanes; timed as one stacked
   launch, as S sequential launches and beside the stacked bound.
11. ssb_stacked: the 13 queries through QueryEngine(segments,
   mesh=make_mesh()): each must take the stacked route, launch each
   kernel it uses once (counts set to 0 before each query, read after),
   and give the numpy oracle's rows and the sequential port's; then the
   timed repeats, p50 beside phase 5's.
12. baseball_stacked: the baseballStats draws of phase 9 through a
   stacked engine over the same 4 segments (their own dictionaries,
   stacked through the union remap); counts set to 0 before, read after
   (all seven kernels must launch); each answer must equal phase 9's,
   which met the oracle (else the oracle judges it); routes counted:
   stacked, fast_path and not_shardable (NotShardable, with the reasons),
   host_twin (the planner's refusals: exactly the host-answered draws).
13. vec_data: the vector table of tools/vecdata.py (the JAX package's
   scripts/vec_ann_bench.py rung: --vec-rows rows of --vec-dim dims in
   --vec-segments segments, drawn around 256 centres from seed 2016),
   sealed by the port's SegmentCreator with a 256-centroid IVF codebook
   a segment trained on the card (launch counts from 0: K10 and K11 must
   launch), loaded with from_dirs and its lanes put on the card; build,
   draw, train and load seconds, device and disk bytes.
14. vector_kernel_check: K8 (both metrics), K6's vector kind, K9, K1's
   ivf_probe node, K10 and K11 against their plain versions on segment
   0's lanes, and K8, K6-vector, K9 and K1 over the stack against their
   plain stacked versions and S per-segment launches (vector_kernel_check
   says what must be equal); timed with the L2 flushed, beside their
   bounds (bytes for K8, K6 and K9, operations for K10) and the nearest
   PyTorch call (torch.mv, torch.topk, torch.topk of torch.mv, cdist with
   argmin, index_add_).
15. vector: per segment and stacked, launch counts from 0, --vec-queries
   query vectors (drawn as the script draws them) under COSINE and DOT,
   exact and at nprobe 1, 4 and 16, and one filtered exact query (WHERE
   rid < 30% of the rows), each run once: every exact answer equal to the
   chunked numpy oracle bit for bit, the stacked answers equal to the
   per-segment ones, every query on the stacked route; per rung the p50
   of --repeats timed runs, the scanned share (numDocsScanned / rows) and
   recall@10 against the exact answer; some nprobe rung under COSINE must
   reach recall@10 >= 0.95 scanning < 15% of the rows (the script's gate).
16. timing: wall seconds per phase and per part of phase 9 (first runs
   on the card, first runs on the host twin, oracle checks, timed
   repeats).

Phases 10-12 run right after the phase they build on (10 and 11 after
5, 12 after 9); 13-15 after 12. The last three lines are the card's name
and power limit, the kernels JSON line (launches over every path: SSB
and baseballStats per segment and stacked, the vector table's build, and
its queries per segment and stacked; the stacked paths' launches, the
stacked launch's time, S per-segment launches' time and the stacked
bound beside them) and
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Imports torch, numpy and pinot_tpu_torch only.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12       # H100 SXM device memory rate
SCALAR_OPS_PER_S = 67e12        # H100 SXM float32 outside the tensor cores
CSUMS_RTOL = 1e-9               # f64 atomics add in a run-dependent order
ROWS_PER_SF = 6_000_000
L2_FLUSH_BYTES = 128 << 20      # > the 50 MB L2: each timed launch is cold
SPIN_CYCLES = 2_000_000         # ~1 ms at H100 clocks


#: the kernels of the SSB and baseballStats paths (K1-K7)
TABLE_KERNELS = ("filter_mask", "masked_part_sums", "dense_group_aggregate",
                 "masked_histogram", "masked_reduce", "masked_select",
                 "hll_registers")
#: the vector path's kernels (K8, K6's vector kind, K9, K10, K11)
VECTOR_KERNELS = ("vector_scores", "masked_select_vector", "ivf_probe_select",
                  "ivf_assign", "ivf_recenter")
VEC_RECALL_GATE, VEC_SCAN_GATE = 0.95, 0.15   # scripts/vec_ann_bench.py


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def time_ms(fn, reps: int = 10, warmup: int = 2, spins: int = 1) -> float:
    """Mean device time of fn() over reps calls, L2 flushed before each.

    A spin of about `spins` milliseconds on the card precedes each call,
    so the host enqueues the call while the card is still busy and the
    events bracket the device work, not the wrapper's Python (a call that
    launches S kernels takes S spins). A call that waits for the card
    itself (the plain versions' boolean indexing) still counts its host
    time."""
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    total = 0.0
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(SPIN_CYCLES * spins)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / reps


def bound(nbytes: float, ops: float) -> tuple:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / SCALAR_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def plan_operands(seg, pql):
    from pinot_tpu_torch.pql.optimizer import BrokerRequestOptimizer
    from pinot_tpu_torch.pql.parser import compile_pql
    from pinot_tpu_torch.query.execution import gather_operands
    from pinot_tpu_torch.query.plan import InstancePlanMaker
    request = BrokerRequestOptimizer().optimize(compile_pql(pql))
    plan = InstancePlanMaker().make_segment_plan(seg, request)
    return plan, gather_operands(plan)


def group_operands(plan, cols):
    from pinot_tpu_torch.ops import kernels as K
    gcols, strides, g_pad, gaggs, _ = plan.group_spec
    params = list(plan.group_params)
    device = next(iter(cols.values())).device
    keys = [K.spec_group_key(g, cols, params, device) for g in gcols]
    parts = [cols[f"{s[1]}.parts"] for s in gaggs if s[3] and
             s[3][0] == "psums"]
    floats = [cols[f"{s[1]}.{'vlane' if s[2] == 'sv' else 'raw'}"].double()
              for s in gaggs if s[3] and s[3][0] == "csums"]
    extremes = []
    for fname, col, source, extra in gaggs:
        whiches = {"min": ("min",), "max": ("max",),
                   "minmaxrange": ("min", "max")}.get(fname, ())
        for which in whiches:
            kind = "ids" if source == "sv" else "raw"
            extremes.append((kind, cols[f"{col}.{kind}"], which,
                             extra[1] if kind == "ids" else 0))
    return keys, strides, g_pad, parts, floats, extremes


def k3_check(P, plan, cols, mask):
    """K3 against its plain version on one group-by plan, with the
    shared-memory tables as the wrapper chooses them and, where the table
    fits a block's shared memory, forced on and forced off: (report, ms,
    plain ms, bound)."""
    from pinot_tpu_torch.ops import kernels as K
    keys, strides, g_pad, parts, floats, ext = group_operands(plan, cols)
    args = (mask, keys, strides, g_pad, parts, floats, ext)
    ref = K.dense_group_aggregate_plain(*args)
    combos = int(ref[0].sum())       # (doc, MV entry combination) pairs
    n_l = sum(p.shape[0] for p in parts)
    n_raw = sum(e[0] == "raw" for e in ext)
    table = g_pad * (4 * (1 + n_l + len(ext) - n_raw) +
                     8 * (len(floats) + n_raw))
    smem_room = getattr(torch.cuda.get_device_properties(0),
                        "shared_memory_per_block_optin", 227 << 10) - 2048
    variants = {"default": K.K3_SMEM_SLOTS}
    if table <= smem_room:
        variants.update(smem_on=K.INT32_MAX, smem_off=0)
    int_err, f_err, f_ok, ext_equal = 0, 0.0, True, True
    for slots in variants.values():
        got = K.dense_group_aggregate(*args, smem_slots=slots)
        int_err = max([int_err] + [
            int((a.long() - b.long()).abs().max()) for a, b in
            ((got[0], ref[0]), (got[1], ref[1]), (got[3], ref[3]))
            if a.numel()])
        # min / max are order-free: equal, sentinels and NaN-free data alike
        ext_equal &= all(torch.equal(a, b) for a, b in zip(got[4], ref[4]))
        if floats:
            diff = (got[2] - ref[2]).abs()
            f_err = max(f_err, float(diff.max()))
            f_ok &= bool((diff <= CSUMS_RTOL *
                          ref[2].abs().clamp_min(1.0)).all())
    matched = int(mask.sum())
    if int_err != 0 or not f_ok or not ext_equal:
        raise AssertionError(f"dense_group_aggregate disagrees: int "
                             f"{int_err}, csums {f_err}, extremes equal "
                             f"{ext_equal}")
    # each input read once: the mask, the matched rows' key entries (a [W]
    # row per MV key) and metric lanes; the table written once
    row_bytes = sum(k.lane.element_size() * k.width for k in keys) + n_l + \
        8 * len(floats) + sum(e[1].element_size() for e in ext)
    ms = {v: time_ms(lambda: K.dense_group_aggregate(*args, smem_slots=s))
          for v, s in variants.items()}
    plain = time_ms(lambda: K.dense_group_aggregate_plain(*args))
    b = bound(P + matched * row_bytes + table,
              combos * (2 * len(keys) + 1 + n_l + len(floats) + len(ext)))
    report = {"g_pad": g_pad, "key_kinds": [k.kind for k in keys],
              "table_bytes": table, "matched": matched, "combos": combos,
              "max_abs_err_int": int_err, "max_abs_err_csums": f_err,
              "part_lanes": n_l, "float_lanes": len(floats),
              "extremes": len(ext), "extremes_equal": ext_equal,
              "csums_rtol": CSUMS_RTOL if floats else None,
              "smem_slots": K.K3_SMEM_SLOTS, "ms": ms["default"],
              "ms_smem_on": ms.get("smem_on"),
              "ms_smem_off": ms.get("smem_off"), "plain_ms": plain,
              "bound_ms": b[0], "bound_by": b[1]}
    return report, max(int_err, f_err), ms["default"], plain, b


def kernel_check(seg, pqls):
    """Each kernel against its plain version on segment 0's lanes."""
    from pinot_tpu_torch.ops import kernels as K
    P, n = seg.padded_docs, seg.num_docs
    report, entries = [], {}

    # K1 on every SSB filter, plus the kinds SSB does not use
    k1_err = 0
    for q, pql in pqls.items():
        plan, cols = plan_operands(seg, pql)
        got = K.filter_mask(P, plan.filter_spec, cols, plan.params, n)
        ref = K.filter_mask_plain(P, plan.filter_spec, cols, plan.params, n)
        err = int((got.int() - ref.int()).abs().max())
        report.append({"kernel": "filter_mask", "case": q,
                       "matched": int(ref.sum()), "max_abs_err": err})
        k1_err = max(k1_err, err)
    _, cols = plan_operands(seg, pqls["q4.3"])
    member = np.zeros(1024, bool)
    member[::3] = True
    extra = ("or", (("and", (("pred", "neq_id", "s_city", "sv", None),
                             ("pred", "member", "p_brand1", "sv", 1024))),
                    ("pred", "notin_ids", "c_region", "sv", 4)))
    extra_params = [np.int32(7), member, np.array([0, 1, 2, -1], np.int32)]
    got = K.filter_mask(P, extra, cols, extra_params, n)
    ref = K.filter_mask_plain(P, extra, cols, extra_params, n)
    err = int((got.int() - ref.int()).abs().max())
    report.append({"kernel": "filter_mask", "case": "neq/member/notin",
                   "matched": int(ref.sum()), "max_abs_err": err})
    k1_err = max(k1_err, err)

    # K1 and K2 timed on Q1.1 (three id lanes, three part lanes)
    plan, cols = plan_operands(seg, pqls["q1.1"])
    lanes = {k: cols[k] for k in K.filter_lane_keys(plan.filter_spec)}
    mask = K.filter_mask(P, plan.filter_spec, cols, plan.params, n)
    matched = int(mask.sum())
    k1_bytes = sum(t.numel() * t.element_size() for t in lanes.values()) + P
    entries["filter_mask"] = dict(
        max_abs_err=k1_err,
        ms=time_ms(lambda: K.filter_mask(P, plan.filter_spec, cols,
                                         plan.params, n)),
        plain_ms=time_ms(lambda: K.filter_mask_plain(
            P, plan.filter_spec, cols, plan.params, n)),
        bound=bound(k1_bytes, P * 2 * len(lanes)), library_ms=None)
    parts = [cols["lo_revenue.parts"]]
    L = parts[0].shape[0]
    got = K.masked_part_sums(mask, parts)
    ref = K.masked_part_sums_plain(mask, parts)
    k2_err = int((got.long() - ref.long()).abs().max())
    report.append({"kernel": "masked_part_sums", "case": "q1.1",
                   "matched": matched, "max_abs_err": k2_err})
    entries["masked_part_sums"] = dict(
        max_abs_err=k2_err,
        ms=time_ms(lambda: K.masked_part_sums(mask, parts)),
        plain_ms=time_ms(lambda: K.masked_part_sums_plain(mask, parts)),
        bound=bound(P + matched * L + 4 * (L + 1), P + matched * L),
        library_ms=None)

    # K3 on every group-by (g_pad 256 to 2^21); Q4.3 (one csums lane)
    # gives the kernels line its numbers
    for q, pql in pqls.items():
        plan, cols = plan_operands(seg, pql)
        if plan.group_spec is None:
            continue
        mask = K.filter_mask(P, plan.filter_spec, cols, plan.params, n)
        r, err, ms, plain, b = k3_check(P, plan, cols, mask)
        report.append({"kernel": "dense_group_aggregate", "case": q, **r})
        if q == "q4.3":
            entries["dense_group_aggregate"] = dict(
                max_abs_err=err, ms=ms, plain_ms=plain, bound=b,
                library_ms=None)
    for r in report:
        emit({"phase": "kernel_check", **r})
    if k1_err or k2_err:
        raise AssertionError(f"filter_mask err {k1_err}, masked_part_sums "
                             f"err {k2_err}")
    return entries


#: baseballStats plans whose operands the kernel check takes
BB_K1_PQLS = {
    "raw": "SELECT COUNT(*) FROM baseballStats WHERE salary > 123456.78 "
           "AND salary <= 987654.25 AND runs < 100",
    "mv": "SELECT COUNT(*) FROM baseballStats WHERE position = 'SS' OR "
          "position NOT IN ('P', 'C')",
    "mixed": "SELECT COUNT(*) FROM baseballStats WHERE (teamID IN ('BOS', "
             "'NYA') AND position = 'P') OR salary IN (1.5, 2.25) OR "
             "hits > 240",
}
BB_K3_PQLS = {
    "teamID x league": "SELECT COUNT(*), SUM(runs), AVG(salary), "
                       "MIN(runs), MAX(salary), MINMAXRANGE(average) FROM "
                       "baseballStats WHERE yearID >= 2000 GROUP BY "
                       "teamID, league TOP 2000",
    "playerName": "SELECT MIN(runs), MAX(salary), MINMAXRANGE(average), "
                  "MIN(hits) FROM baseballStats WHERE position = 'C' "
                  "GROUP BY playerName TOP 2000",
    # MV keys ("mvids", "mvin"): count, SUM(hits) part sums, MIN(runs)
    "position": "SELECT COUNT(*), SUM(hits), MIN(runs) FROM baseballStats "
                "WHERE yearID >= 2000 GROUP BY position TOP 100",
    "position x league": "SELECT COUNT(*), SUM(hits), MIN(runs) FROM "
                         "baseballStats WHERE yearID >= 2000 GROUP BY "
                         "position, league TOP 100",
    "valuein(position) x league": "SELECT COUNT(*), SUM(hits), MIN(runs) "
                                  "FROM baseballStats WHERE yearID >= 2000 "
                                  "GROUP BY valuein(position, 'P', 'C', "
                                  "'SS', 'CF'), league TOP 100",
    # float64 sums alone (csums over the raw salary lane)
    "teamID csums salary": "SELECT SUM(salary) FROM baseballStats WHERE "
                           "yearID >= 2000 GROUP BY teamID TOP 100",
}
#: the raw-key segment's K3 case ("rawoff" over int64 hits)
BB_RAW_K3_PQL = "SELECT COUNT(*), SUM(runs), MIN(hits) FROM baseballStats " \
    "WHERE yearID >= 2000 GROUP BY hits, league TOP 1000"
#: the mask and part lanes of the K2, K4 and K5 cases
BB_AGG_PQL = "SELECT SUM(runs), AVG(hits) FROM baseballStats WHERE " \
    "yearID >= 2000"


def bb_kernel_check(seg, raw_seg):
    """K1 raw / MV programs, K2, K3 (MV, valuein and, on the raw-key
    segment, raw keys), K4 (ids and MV entries), K5 (ids, raw and MV
    entries) and K7 against their plain versions on one baseballStats
    segment's lanes."""
    from pinot_tpu_torch.ops import kernels as K
    P, n = seg.padded_docs, seg.num_docs
    report, entries = [], {}

    for case, pql in BB_K1_PQLS.items():
        plan, cols = plan_operands(seg, pql)
        got = K.filter_mask(P, plan.filter_spec, cols, plan.params, n)
        ref = K.filter_mask_plain(P, plan.filter_spec, cols, plan.params, n)
        err = int((got.int() - ref.int()).abs().max())
        lanes = [cols[k] for k in K.filter_lane_keys(plan.filter_spec)]
        b = bound(sum(t.numel() * t.element_size() for t in lanes) + P,
                  P * 2 * sum(t.numel() // P for t in lanes))
        report.append({
            "kernel": "filter_mask", "case": f"baseball {case}",
            "matched": int(ref.sum()), "max_abs_err": err,
            "ms": time_ms(lambda: K.filter_mask(
                P, plan.filter_spec, cols, plan.params, n)),
            "plain_ms": time_ms(lambda: K.filter_mask_plain(
                P, plan.filter_spec, cols, plan.params, n)),
            "bound_ms": b[0], "bound_by": b[1]})
        if err:
            raise AssertionError(f"filter_mask disagrees on {case}")

    for case, pql, s in [(c, q, seg) for c, q in BB_K3_PQLS.items()] + \
            [("rawoff hits x league", BB_RAW_K3_PQL, raw_seg)]:
        plan, cols = plan_operands(s, pql)
        mask = K.filter_mask(s.padded_docs, plan.filter_spec, cols,
                             plan.params, s.num_docs)
        r, _err, _ms, _plain, _b = k3_check(s.padded_docs, plan, cols, mask)
        report.append({"kernel": "dense_group_aggregate",
                       "case": f"baseball {case}", **r})

    plan, cols = plan_operands(seg, BB_AGG_PQL)
    mask = K.filter_mask(P, plan.filter_spec, cols, plan.params, n)
    matched = int(mask.sum())
    parts = [cols["runs.parts"], cols["hits.parts"]]
    L = sum(p.shape[0] for p in parts)
    got = K.masked_part_sums(mask, parts)
    ref = K.masked_part_sums_plain(mask, parts)
    err = int((got.long() - ref.long()).abs().max())
    b = bound(P + matched * L + 4 * (L + 1), P + matched * L)
    report.append({
        "kernel": "masked_part_sums", "case": "baseball runs, hits",
        "part_lanes": L, "matched": matched, "max_abs_err": err,
        "ms": time_ms(lambda: K.masked_part_sums(mask, parts)),
        "plain_ms": time_ms(lambda: K.masked_part_sums_plain(mask, parts)),
        "bound_ms": b[0], "bound_by": b[1]})
    if err:
        raise AssertionError("masked_part_sums disagrees on runs, hits")
    lanes = {c: seg.data_source(c).device_dict_ids()
             for c in ("teamID", "playerName", "average", "runs")}
    lanes["salary"] = seg.data_source("salary").device_raw_values()
    mask_f = mask.to(torch.float32)
    for col in ("teamID", "playerName", "average"):
        ids = lanes[col]
        card_pad = K.pow2_bucket(seg.data_source(col).metadata.cardinality
                                 + 1)
        got = K.masked_histogram(mask, ids, card_pad)
        ref = K.masked_histogram_plain(mask, ids, card_pad)
        err = int((got.long() - ref.long()).abs().max())
        ids_long = ids.long()
        b = bound(P + matched * ids.element_size() + 4 * card_pad, matched)
        r = {"kernel": "masked_histogram", "case": f"baseball {col}",
             "card_pad": card_pad, "matched": matched, "max_abs_err": err,
             "ms": time_ms(lambda: K.masked_histogram(mask, ids, card_pad)),
             "plain_ms": time_ms(lambda: K.masked_histogram_plain(
                 mask, ids, card_pad)),
             "library_ms": time_ms(lambda: torch.bincount(
                 ids_long, weights=mask_f, minlength=card_pad)),
             "bound_ms": b[0], "bound_by": b[1]}
        report.append(r)
        if err:
            raise AssertionError(f"masked_histogram disagrees on {col}")
        if col == "teamID":
            entries["masked_histogram"] = dict(
                max_abs_err=err, ms=r["ms"], plain_ms=r["plain_ms"],
                bound=b, library_ms=r["library_ms"])

    for case, kind, lane, card_pad, want_sum in (
            ("salary", "raw", lanes["salary"], 0, True),
            ("runs ids", "ids", lanes["runs"], K.pow2_bucket(
                seg.data_source("runs").metadata.cardinality + 1), False)):
        got = K.masked_reduce(mask, lane, kind, card_pad, want_sum)
        ref = K.masked_reduce_plain(mask, lane, kind, card_pad, want_sum)
        equal = all(got[k].dtype == ref[k].dtype and torch.equal(got[k],
                                                                 ref[k])
                    for k in ("min", "max", "count"))
        s_err = float((got["sums"] - ref["sums"]).abs().max()) \
            if want_sum else 0.0
        s_ok = not want_sum or bool(
            ((got["sums"] - ref["sums"]).abs() <=
             CSUMS_RTOL * ref["sums"].abs().clamp_min(1.0)).all())
        out_bytes = (P // K.BLOCK) * 8 * want_sum + 24
        b = bound(P + matched * lane.element_size() + out_bytes,
                  matched * (3 if want_sum else 2))
        r = {"kernel": "masked_reduce", "case": f"baseball {case}",
             "matched": matched, "min_max_count_equal": equal,
             "max_abs_err_sums": s_err,
             "sums_rtol": CSUMS_RTOL if want_sum else None,
             "ms": time_ms(lambda: K.masked_reduce(mask, lane, kind,
                                                   card_pad, want_sum)),
             "plain_ms": time_ms(lambda: K.masked_reduce_plain(
                 mask, lane, kind, card_pad, want_sum)),
             "bound_ms": b[0], "bound_by": b[1]}
        report.append(r)
        if not equal or not s_ok:
            raise AssertionError(f"masked_reduce disagrees on {case}")
        if case == "salary":
            entries["masked_reduce"] = dict(
                max_abs_err=s_err, ms=r["ms"], plain_ms=r["plain_ms"],
                bound=b, library_ms=None)
    report.extend(mv_kernel_check(seg, mask))
    report.extend(hll_kernel_check(seg, mask, entries))
    for r in report:
        emit({"phase": "bb_kernel_check", **r})
    return entries


def mv_lanes(seg):
    """position's MV lane and an int16 MV lane built for the check:
    playerName's ids, 1-3 entries per row like position (padding entries
    hold the cardinality, 997)."""
    P, n = seg.padded_docs, seg.num_docs
    ds = seg.data_source("position")
    card = ds.metadata.cardinality
    pos = ds.device_mv_dict_ids()
    rng = np.random.default_rng(7)
    wide = np.full((P, 3), 997, np.int16)
    wide[:n] = rng.integers(0, 997, (n, 3))
    width = rng.integers(1, 4, n)
    wide[:n][np.arange(3)[None, :] >= width[:, None]] = 997
    return {"position": (pos, card),
            "int16 x 3": (torch.from_numpy(wide).to(pos.device), 997)}


def mv_kernel_check(seg, mask):
    """K4 over MV entries (position) and K5's MV entry min / max
    (position, and an int16 MV lane), against their plain versions."""
    from pinot_tpu_torch.ops import kernels as K
    P = seg.padded_docs
    matched = int(mask.sum())
    report = []
    for case, (lane, card) in mv_lanes(seg).items():
        card_pad = K.pow2_bucket(card + 1)
        W, esize = lane.shape[1], lane.element_size()
        if case == "position":
            got = K.masked_entry_histogram(mask, lane, card_pad, card)
            ref = K.masked_entry_histogram_plain(mask, lane, card_pad, card)
            equal = all(torch.equal(a, b) for a, b in zip(got, ref))
            flat = lane.reshape(-1).long()
            weight = (mask.bool()[:, None] & (lane < card)).reshape(-1) \
                .to(torch.float32)
            b = bound(P + matched * W * esize + 4 * card_pad + 4,
                      matched * W)
            report.append({
                "kernel": "masked_histogram", "case": f"baseball MV {case}",
                "card_pad": card_pad, "width": W, "matched": matched,
                "entries": int(ref[1]), "equal": equal, "max_abs_err": 0,
                "ms": time_ms(lambda: K.masked_entry_histogram(
                    mask, lane, card_pad, card)),
                "plain_ms": time_ms(lambda: K.masked_entry_histogram_plain(
                    mask, lane, card_pad, card)),
                "library_ms": time_ms(lambda: torch.bincount(
                    flat, weights=weight, minlength=card_pad)),
                "bound_ms": b[0], "bound_by": b[1]})
            if not equal:
                raise AssertionError("masked_histogram disagrees on MV "
                                     "position")
        got = K.masked_reduce(mask, lane, "ids", card_pad, card=card)
        ref = K.masked_reduce_plain(mask, lane, "ids", card_pad, card=card)
        equal = all(got[k].dtype == ref[k].dtype and torch.equal(got[k],
                                                                 ref[k])
                    for k in ("min", "max", "count"))
        b = bound(P + matched * W * esize + 24, 2 * matched * W)
        report.append({
            "kernel": "masked_reduce", "case": f"baseball MV {case}",
            "width": W, "matched": matched, "min_max_count_equal": equal,
            "min": int(got["min"]), "max": int(got["max"]),
            "ms": time_ms(lambda: K.masked_reduce(mask, lane, "ids",
                                                  card_pad, card=card)),
            "plain_ms": time_ms(lambda: K.masked_reduce_plain(
                mask, lane, "ids", card_pad, card=card)),
            "bound_ms": b[0], "bound_by": b[1]})
        if not equal:
            raise AssertionError(f"masked_reduce disagrees on MV {case}")
    return report


def hll_kernel_check(seg, mask, entries):
    """K7 on playerName and teamID, after K4 on the same mask; the
    kernels-line entry is playerName's."""
    from pinot_tpu_torch.ops import kernels as K
    from pinot_tpu_torch.common.sketches import DEFAULT_LOG2M
    m = 1 << DEFAULT_LOG2M
    report = []
    for col in ("playerName", "teamID"):
        ds = seg.data_source(col)
        card = ds.metadata.cardinality
        card_pad = K.pow2_bucket(card + 1)
        hist = K.masked_histogram(mask, ds.device_dict_ids(), card_pad)
        idx, rank = ds.device_hll_idx(), ds.device_hll_rank()
        got = K.hll_registers(hist, idx, rank, m)
        ref = K.hll_registers_plain(hist, idx, rank, m)
        equal = torch.equal(got, ref)
        idx_long = idx.long()
        zeros = torch.zeros(m, dtype=torch.int32, device=hist.device)
        b = bound(12 * card_pad + 4 * m, card_pad)
        r = {"kernel": "hll_registers", "case": f"baseball {col}",
             "card": card, "card_pad": card_pad, "registers": m,
             "nonzero_registers": int((got > 0).sum()), "equal": equal,
             "max_abs_err": int((got - ref).abs().max()),
             "ms": time_ms(lambda: K.hll_registers(hist, idx, rank, m)),
             "plain_ms": time_ms(lambda: K.hll_registers_plain(
                 hist, idx, rank, m)),
             "library_ms": time_ms(lambda: zeros.scatter_reduce(
                 0, idx_long, torch.where(hist > 0, rank, 0), "amax")),
             "bound_ms": b[0], "bound_by": b[1]}
        report.append(r)
        if not equal:
            raise AssertionError(f"hll_registers disagrees on {col}")
        if col == "playerName":
            entries["hll_registers"] = dict(
                max_abs_err=r["max_abs_err"], ms=r["ms"],
                plain_ms=r["plain_ms"], bound=b,
                library_ms=r["library_ms"])
    return report


#: the select specs of the K6 check come from these plans (segment 0's
#: lanes, with k and the mask varied)
SELECT_PQLS = {
    "limit": "SELECT playerName, salary, position FROM baseballStats "
             "LIMIT 16",
    "order runs, hits": "SELECT runs, hits, playerName FROM baseballStats "
                        "ORDER BY runs DESC, hits DESC LIMIT 16",
    "order league (ties)": "SELECT league, teamID FROM baseballStats "
                           "ORDER BY league LIMIT 16",
    "ordertk salary": "SELECT playerName, salary FROM baseballStats ORDER "
                      "BY salary DESC LIMIT 16",
    "ordermk teamID, salary": "SELECT teamID, yearID, salary FROM "
                              "baseballStats ORDER BY teamID, salary "
                              "LIMIT 16",
}
SELECT_KS = (16, 2048, 65536)


def _select_library(spec, cols, mask, words):
    """One PyTorch call computing the same docids where there is one:
    torch.nonzero for limit, torch.topk over the int64 key (word, docid)
    with masked rows at the top for one key word; else None."""
    kind, k = spec[0], spec[1]
    if kind == "limit":
        return lambda: torch.nonzero(mask)[:k]
    if len(words) != 1:
        return None
    doc = torch.arange(mask.shape[0], device=mask.device, dtype=torch.int64)
    key = ((words[0].long() + 2**31) << 31) | doc
    key = torch.where(mask.bool(), key, torch.iinfo(torch.int64).max)
    return lambda: torch.topk(key, k, largest=False, sorted=True)


def select_kernel_check(seg):
    """K6 against its plain version on one baseballStats segment, every
    select kind, k and mask; returns the kernels-line entry (ordertk on
    salary, k = 2048, yearID >= 2000: the fixed query's kind)."""
    from pinot_tpu_torch.ops import kernels as K
    P, n = seg.padded_docs, seg.num_docs
    device = seg.device
    plan, mcols = plan_operands(seg, BB_AGG_PQL)        # yearID >= 2000
    masks = {"yearID >= 2000": K.filter_mask(P, plan.filter_spec, mcols,
                                             plan.params, n),
             "match-all": K.filter_mask(P, ("match_all",), {}, [], n, device),
             "empty": torch.zeros(P, dtype=torch.uint8, device=device)}
    specs = {}
    for case, pql in SELECT_PQLS.items():
        plan, cols = plan_operands(seg, pql)
        specs[case] = (plan.select_spec, cols)
    # int64 and float64 key lanes built for the check: hits and average
    # decoded from their dictionaries
    wide = {}
    for col, dtype in (("hits", np.int64), ("average", np.float64)):
        ds = seg.data_source(col)
        lane = np.zeros(P, dtype)
        lane[:n] = np.asarray(ds.dictionary.values, dtype)[ds.dict_ids]
        wide[f"{col}.raw"] = torch.from_numpy(lane).to(device)
    specs["ordermk hits int64, average float64"] = (
        ("ordermk", 16, (("hits", False, 0, "raw"),
                         ("average", True, 0, "raw")),
         (("hits", "raw"), ("average", "raw"))), wide)
    report, entry = [], None
    for case, (spec, cols) in specs.items():
        words = K.select_key_words(spec, cols)
        key_bytes = sum(cols[K.gather_lane_key(c, s)].element_size()
                        for c, _asc, _cp, s in spec[2])
        row_bytes = sum(cols[K.gather_lane_key(c, s)][0].numel() *
                        cols[K.gather_lane_key(c, s)].element_size()
                        for c, s in spec[3])
        for mask_name, mask in masks.items():
            matched = int(mask.sum())
            for k in (k for k in SELECT_KS if k <= P):
                sk = (spec[0], k, spec[2], spec[3])
                got = K.masked_select(sk, cols, mask)
                ref = K.selection_outputs_plain(sk, cols, mask)
                equal = set(got) == set(ref) and all(
                    got[x].dtype == ref[x].dtype and torch.equal(
                        got[x].reshape(-1).view(torch.uint8),
                        ref[x].reshape(-1).view(torch.uint8))
                    for x in ref)
                if not equal:
                    raise AssertionError(f"masked_select disagrees: {case}, "
                                         f"{mask_name}, k={k}")
                lib = _select_library(sk, cols, mask, words)
                b = bound(P + matched * key_bytes + k * (4 + 2 * row_bytes)
                          + 4, 0)
                r = {"kernel": "masked_select", "case": case,
                     "kind": spec[0], "mask": mask_name, "k": k,
                     "matched": matched, "key_words": len(words),
                     "equal": equal, "max_abs_err": 0,
                     "ms": time_ms(lambda: K.masked_select(sk, cols, mask),
                                   reps=5),
                     "plain_ms": time_ms(lambda: K.selection_outputs_plain(
                         sk, cols, mask), reps=3, warmup=1),
                     "library_ms": time_ms(lib, reps=5) if lib else None,
                     "bound_ms": b[0], "bound_by": b[1]}
                report.append(r)
                if case == "ordertk salary" and k == 2048 and \
                        mask_name == "yearID >= 2000":
                    entry = dict(max_abs_err=0, ms=r["ms"],
                                 plain_ms=r["plain_ms"], bound=b,
                                 library_ms=r["library_ms"])
    for r in report:
        emit({"phase": "select_kernel_check", **r})
    return {"masked_select": entry}


#: selections over the SSB stack for the stacked K6 check (SSB has none
#: of its own): a packed dictId key ("order") and a float64 raw key
#: ("ordermk", two words)
SSB_SELECT_PQLS = {
    "order lo_revenue": "SELECT c_city, s_city, lo_revenue FROM lineorder "
                        "WHERE d_year = 1993 AND lo_discount BETWEEN 1 AND "
                        "3 ORDER BY lo_revenue DESC LIMIT 100",
    "ordermk lo_supplycost": "SELECT d_year, p_brand1, lo_supplycost FROM "
                             "lineorder WHERE c_region = 'ASIA' AND "
                             "s_region = 'ASIA' ORDER BY lo_supplycost DESC "
                             "LIMIT 1000",
}
#: the stacked K3 cases: psums only, the widest c_city x s_city key, and
#: the largest table (g_pad 2^21, psums and csums)
STACKED_K3_QUERIES = ("q2.1", "q3.2", "q4.3")


def stacked_kernel_check(st_engine, pqls):
    """The stacked launches (one over all S segments) against their plain
    stacked versions on the SSB stack, and against S per-segment launches
    of the sequential path: K1 (mask and per-segment matches), K2 (one
    row per segment), K3 (int64 part sums, csums, over the whole stack),
    K6 (per-segment top k), and K4, K5, K7 over the flat rows. Each timed
    as one stacked launch, as S sequential launches, and beside the
    stacked launch's bound. Returns {kernel: stacked numbers}."""
    from pinot_tpu_torch.ops import kernels as K
    from pinot_tpu_torch.pql.optimizer import BrokerRequestOptimizer
    from pinot_tpu_torch.pql.parser import compile_pql
    from pinot_tpu_torch.query.execution import gather_operands_for
    ex = st_engine.sharded
    stack = ex.stack_for(st_engine.segments)
    S, P = stack.n_real, stack.padded_docs
    segs, docs = stack.segments, stack.device_num_docs()
    report, out = [], {}

    def operands(pql):
        request = BrokerRequestOptimizer().optimize(compile_pql(pql))
        plan = ex.plan_maker.make_segment_plan(stack.plan_segment(), request)
        flat = K.flat_lanes(stack.gather(plan.needed_cols), S, P)
        per = [gather_operands_for(sg, plan.needed_cols) for sg in segs]
        mask, matched = K.filter_mask_stacked(P, S, plan.filter_spec, flat,
                                              plan.params, docs)
        return plan, flat, per, mask, matched

    def seg_masks(mask):
        return [mask[i * P:(i + 1) * P] for i in range(S)]

    def record(name, case, equal, ms, seq_ms, plain_ms, b, **extra):
        r = {"kernel": name, "case": case, "segments": S, "equal": equal,
             "ms": ms, "s_sequential_ms": seq_ms, "plain_ms": plain_ms,
             "bound_ms": b[0], "bound_by": b[1], **extra}
        report.append(r)
        emit({"phase": "stacked_kernel_check", **r})
        if not equal:
            raise AssertionError(f"stacked {name} disagrees on {case}")
        out.setdefault(name, dict(ms=ms, s_sequential_ms=seq_ms,
                                  plain_ms=plain_ms, bound_ms=b[0],
                                  bound_by=b[1], case=case))

    # K1 and K2 on Q1.1 (three id lanes, three part lanes)
    plan, flat, per, mask, matched = operands(pqls["q1.1"])
    ref_mask, ref_matched = K.filter_mask_stacked_plain(
        P, S, plan.filter_spec, flat, plan.params, docs)
    seq = [K.filter_mask(P, plan.filter_spec, c, plan.params, sg.num_docs)
           for sg, c in zip(segs, per)]
    equal = torch.equal(mask, ref_mask) and \
        torch.equal(matched, ref_matched) and torch.equal(torch.cat(seq),
                                                         mask)
    keys = K.filter_lane_keys(plan.filter_spec)
    n_match = int(matched.sum())
    lane_bytes = sum(flat[k].numel() * flat[k].element_size() for k in keys)
    record("filter_mask", "q1.1", equal,
           time_ms(lambda: K.filter_mask_stacked(P, S, plan.filter_spec,
                                                 flat, plan.params, docs)),
           time_ms(lambda: [K.filter_mask(P, plan.filter_spec, c,
                                          plan.params, sg.num_docs)
                            for sg, c in zip(segs, per)], spins=S),
           time_ms(lambda: K.filter_mask_stacked_plain(
               P, S, plan.filter_spec, flat, plan.params, docs), reps=3),
           bound(lane_bytes + S * P + 4 * S, S * P * 2 * len(keys)),
           matched=n_match)
    parts = [flat["lo_revenue.parts"]]
    L = parts[0].shape[0]
    got = K.masked_part_sums(mask, parts, seg_rows=P)
    equal = torch.equal(got, K.masked_part_sums_plain(mask, parts, P)) and \
        torch.equal(got, torch.stack([
            K.masked_part_sums(m, [c["lo_revenue.parts"]])
            for m, c in zip(seg_masks(mask), per)]))
    record("masked_part_sums", "q1.1", equal,
           time_ms(lambda: K.masked_part_sums(mask, parts, seg_rows=P)),
           time_ms(lambda: [K.masked_part_sums(m, [c["lo_revenue.parts"]])
                            for m, c in zip(seg_masks(mask), per)], spins=S),
           time_ms(lambda: K.masked_part_sums_plain(mask, parts, P),
                   reps=3),
           bound(S * P + n_match * L + 4 * S * (L + 1), S * P + n_match * L),
           matched=n_match, part_lanes=L,
           total_parts_sum=int(got[:, :L].long().sum()))

    # K3 over the whole stack: int64 part sums, float64 csums
    for q in STACKED_K3_QUERIES:
        plan, flat, per, mask, matched = operands(pqls[q])
        keys, strides, g_pad, kparts, floats, ext = group_operands(plan,
                                                                   flat)
        args = (mask, keys, strides, g_pad, kparts, floats, ext)
        got = K.dense_group_aggregate(*args, psums_wide=True)
        ref = K.dense_group_aggregate_plain(*args, psums_wide=True)
        seq_args = [(m,) + group_operands(plan, c) for m, c in
                    zip(seg_masks(mask), per)]
        seq = [K.dense_group_aggregate(*a) for a in seq_args]
        ints_equal = all(torch.equal(a, b) for a, b in
                         ((got[0], ref[0]), (got[1], ref[1]),
                          (got[3], ref[3]))) and \
            all(torch.equal(a, b) for a, b in zip(got[4], ref[4])) and \
            torch.equal(got[1], sum(o[1].long() for o in seq)) and \
            torch.equal(got[0], sum(o[0] for o in seq))
        f_err, f_ok = 0.0, True
        if floats:
            diff = (got[2] - ref[2]).abs()
            f_err = float(diff.max())
            f_ok = bool((diff <= CSUMS_RTOL *
                         ref[2].abs().clamp_min(1.0)).all())
        n_l = sum(p.shape[0] for p in kparts)
        n_match = int(matched.sum())
        row_bytes = sum(k.lane.element_size() for k in keys) + n_l + \
            8 * len(floats)
        table = g_pad * (4 + 8 * n_l + 8 * len(floats))
        record("dense_group_aggregate", q, ints_equal and f_ok,
               time_ms(lambda: K.dense_group_aggregate(*args,
                                                       psums_wide=True)),
               time_ms(lambda: [K.dense_group_aggregate(*a)
                                for a in seq_args], spins=S),
               time_ms(lambda: K.dense_group_aggregate_plain(
                   *args, psums_wide=True), reps=3),
               bound(S * P + n_match * row_bytes + table,
                     n_match * (2 * len(keys) + 1 + n_l + len(floats))),
               matched=n_match, g_pad=g_pad, part_lanes=n_l,
               float_lanes=len(floats), psums_table_bytes=8 * n_l * g_pad,
               per_segment_psums_bytes=4 * S * n_l * g_pad,
               max_abs_err_csums=f_err,
               csums_rtol=CSUMS_RTOL if floats else None)

    # K6: a top k per segment, [S, k]
    for case, pql in SSB_SELECT_PQLS.items():
        plan, flat, per, mask, matched = operands(pql)
        spec = plan.select_spec
        got = K.masked_select(spec, flat, mask, S)
        ref = K.selection_outputs_plain(spec, flat, mask, S)
        seq = [K.masked_select(spec, c, m)
               for c, m in zip(per, seg_masks(mask))]

        def same(a, b):
            return a.dtype == b.dtype and torch.equal(
                a.reshape(-1).view(torch.uint8), b.reshape(-1).view(
                    torch.uint8))
        equal = set(got) == set(ref) and all(
            same(got[x], ref[x]) and same(got[x], torch.stack(
                [o[x] for o in seq])) for x in ref)
        words = K.select_key_words(spec, flat)
        k = spec[1]
        key_bytes = sum(flat[K.gather_lane_key(c, src)].element_size()
                        for c, _asc, _cp, src in spec[2])
        row_bytes = sum(flat[K.gather_lane_key(c, src)][0].numel() *
                        flat[K.gather_lane_key(c, src)].element_size()
                        for c, src in spec[3])
        n_match = int(matched.sum())
        record("masked_select", case, equal,
               time_ms(lambda: K.masked_select(spec, flat, mask, S),
                       reps=5),
               time_ms(lambda: [K.masked_select(spec, c, m) for c, m in
                                zip(per, seg_masks(mask))], reps=5,
                       spins=S),
               time_ms(lambda: K.selection_outputs_plain(spec, flat, mask,
                                                         S), reps=2,
                       warmup=1),
               bound(S * P + n_match * key_bytes +
                     S * k * (4 + 2 * row_bytes) + 4 * S, 0),
               kind=spec[0], k=k, key_words=len(words), matched=n_match,
               scratch_bytes=4 * K.select_scratch_words(P, k, len(words),
                                                        S))

    # K4, K7 and K5 over the flat rows of the stack (Q4.3's mask)
    plan, flat, per, mask, matched = operands(pqls["q4.3"])
    n_match = int(matched.sum())
    ds0 = segs[0].data_source("c_city")
    card_pad = K.pow2_bucket(ds0.metadata.cardinality + 1)
    ids = K.flat_lanes({"c_city.ids": stack.lane("c_city", "ids")}, S,
                       P)["c_city.ids"]
    seg_ids = [sg.data_source("c_city").device_dict_ids() for sg in segs]
    hist = K.masked_histogram(mask, ids, card_pad)
    equal = torch.equal(hist, K.masked_histogram_plain(mask, ids,
                                                       card_pad)) and \
        torch.equal(hist, sum(K.masked_histogram(m, i, card_pad) for m, i in
                              zip(seg_masks(mask), seg_ids)))
    record("masked_histogram", "c_city, q4.3 mask", equal,
           time_ms(lambda: K.masked_histogram(mask, ids, card_pad)),
           time_ms(lambda: [K.masked_histogram(m, i, card_pad) for m, i in
                            zip(seg_masks(mask), seg_ids)], spins=S),
           time_ms(lambda: K.masked_histogram_plain(mask, ids, card_pad)),
           bound(S * P + n_match * ids.element_size() + 4 * card_pad,
                 n_match), matched=n_match, card_pad=card_pad)
    from pinot_tpu_torch.common.sketches import DEFAULT_LOG2M
    m = 1 << DEFAULT_LOG2M
    idx, rank = stack.lane("c_city", "hllidx"), stack.lane("c_city",
                                                           "hllrank")
    regs = K.hll_registers(hist, idx, rank, m)
    seg_regs = [K.hll_registers(K.masked_histogram(mm, i, card_pad),
                                sg.data_source("c_city").device_hll_idx(),
                                sg.data_source("c_city").device_hll_rank(),
                                m)
                for mm, i, sg in zip(seg_masks(mask), seg_ids, segs)]
    equal = torch.equal(regs, K.hll_registers_plain(hist, idx, rank, m)) \
        and torch.equal(regs, torch.stack(seg_regs).amax(dim=0))
    record("hll_registers", "c_city, q4.3 mask", equal,
           time_ms(lambda: K.hll_registers(hist, idx, rank, m)),
           time_ms(lambda: [K.hll_registers(hist, idx, rank, m)
                            for _ in range(S)], spins=S),
           time_ms(lambda: K.hll_registers_plain(hist, idx, rank, m)),
           bound(12 * card_pad + 4 * m, card_pad), registers=m)
    lane = flat["lo_supplycost.raw"]
    got = K.masked_reduce(mask, lane, "raw", 0, True)
    ref = K.masked_reduce_plain(mask, lane, "raw", 0, True)
    seg_lanes = [c["lo_supplycost.raw"] for c in per]
    seq = [K.masked_reduce(mm, ln, "raw", 0, True)
           for mm, ln in zip(seg_masks(mask), seg_lanes)]
    # a block of the stacked launch sums the same 8192 rows in the same
    # order as the per-segment launch: block sums equal bit for bit, and
    # reshape to [S, P / 8192]
    equal = all(torch.equal(got[x], ref[x]) for x in ("min", "max",
                                                      "count")) and \
        torch.equal(got["sums"].reshape(S, -1),
                    torch.stack([o["sums"] for o in seq])) and \
        bool(((got["sums"] - ref["sums"]).abs() <= CSUMS_RTOL *
              ref["sums"].abs().clamp_min(1.0)).all()) and \
        float(got["min"]) == min(float(o["min"]) for o in seq) and \
        float(got["max"]) == max(float(o["max"]) for o in seq)
    record("masked_reduce", "lo_supplycost, q4.3 mask", equal,
           time_ms(lambda: K.masked_reduce(mask, lane, "raw", 0, True)),
           time_ms(lambda: [K.masked_reduce(mm, ln, "raw", 0, True)
                            for mm, ln in zip(seg_masks(mask), seg_lanes)],
                   spins=S),
           time_ms(lambda: K.masked_reduce_plain(mask, lane, "raw", 0,
                                                 True)),
           bound(S * P + n_match * 8 + (S * P // K.BLOCK) * 8 + 24,
                 3 * n_match), matched=n_match)
    return out


def same_answer(a, b, rtol: float) -> bool:
    """Two BrokerResponses give the same rows: equal groups, selection
    rows and integers, floats within rtol."""
    ja, jb = a.to_json(), b.to_json()
    if bool(ja.get("exceptions")) or bool(jb.get("exceptions")) or \
            ja.get("selectionResults") != jb.get("selectionResults"):
        return False

    def values(j):
        out = {}
        for agg in j.get("aggregationResults") or []:
            rows = agg.get("groupByResult")
            if rows is None:
                out[(agg["function"], ())] = agg["value"]
            else:
                for g in rows:
                    out[(agg["function"], tuple(g["group"]))] = g["value"]
        return out
    va, vb = values(ja), values(jb)
    if va.keys() != vb.keys():
        return False
    for k, x in va.items():
        y = vb[k]
        try:
            fx, fy = float(x), float(y)
        except (TypeError, ValueError):
            if x != y:
                return False
            continue
        if not (fx == fy or abs(fx - fy) <= rtol * max(abs(fy), 1e-300)):
            return False
    return True


def run_ssb_stacked(st_engine, seq_results, oracle, repeats: int):
    """The stacked SSB path: per query, launch counts set to 0, the query
    run once through the stacked engine, the counts read (each kernel the
    query uses launched once) and its route (stacked) checked; the rows
    checked against the numpy oracle and the sequential port's rows; then
    the timed repeats. Returns the path's launch counts."""
    from pinot_tpu_torch.ops import kernels as K
    from pinot_tpu_torch.tools.ssb import SSB_PQLS, canon_response, check
    total = dict.fromkeys(K.KERNELS, 0)
    firsts = {}
    for q, pql in SSB_PQLS.items():
        K.reset_launch_counts()
        t = time.perf_counter()
        resp = st_engine.query(pql)
        torch.cuda.synchronize()
        first_ms = (time.perf_counter() - t) * 1e3
        counts = K.launch_counts()
        if st_engine.last_route != ("stacked", None):
            raise AssertionError(f"{q} left the stacked path: "
                                 f"{st_engine.last_route}")
        if any(v > 1 for v in counts.values()) or \
                not counts["filter_mask"]:
            raise AssertionError(f"{q}: stacked launches {counts}")
        for name, v in counts.items():
            total[name] += v
        if resp.exceptions:
            raise AssertionError(f"{q}: {resp.exceptions}")
        got = canon_response(q, resp)
        check(q, got, oracle[q]())
        want = seq_results[q]
        if q.startswith("q1"):
            same = got == want
        else:
            same = set(got) == set(want) and all(
                got[k][0] == want[k][0] and all(
                    abs(g - w) <= CSUMS_RTOL * max(abs(w), 1.0)
                    for g, w in zip(got[k][1:], want[k][1:]))
                for k in want)
        if not same:
            raise AssertionError(f"{q}: stacked rows differ from the "
                                 "sequential port's")
        firsts[q] = (first_ms, {k: v for k, v in counts.items() if v})
    for q, pql in SSB_PQLS.items():
        ts = []
        for _ in range(repeats):
            t = time.perf_counter()
            st_engine.query(pql)
            torch.cuda.synchronize()
            ts.append((time.perf_counter() - t) * 1e3)
        emit({"phase": "ssb_stacked", "query": q, "check": "pass",
              "route": "stacked", "first_ms": firsts[q][0],
              "launches": firsts[q][1], "p50_ms": float(np.median(ts)),
              "sequential_p50_ms": seq_results["p50_ms"][q],
              "samples_ms": ts})
    return total


def run_baseball_stacked(st_engine, answered, oracle, repeats: int,
                         seq_p50):
    """The baseballStats mix through the stacked engine over the loaded
    segments (their own dictionaries, stacked through the union remap):
    launch counts set to 0, every draw once, the counts read; each answer
    must equal the sequential port's, which met the oracle in phase
    `baseball` (where they differ, the oracle judges the stacked one);
    the routes counted; then the timed repeats of the stacked draws."""
    from pinot_tpu_torch.ops import kernels as K
    from pinot_tpu_torch.tools import baseball
    K.reset_launch_counts()
    st_engine.route_counts.clear()
    runs = []
    for family, draw, seq_resp in answered:
        t = time.perf_counter()
        resp = st_engine.query(draw.pql)
        torch.cuda.synchronize()
        runs.append((family, draw, resp, (time.perf_counter() - t) * 1e3,
                     st_engine.last_route, seq_resp))
    launches = K.launch_counts()
    routes, reasons, judged = {}, {}, 0
    for family, draw, resp, _ms, (route, reason), seq_resp in runs:
        label = route
        if route == "NotShardable":
            label = "fast_path" if reason.startswith("fast-path") else \
                "not_shardable"
            if label == "not_shardable":
                reasons[reason] = reasons.get(reason, 0) + 1
        elif route in ("UnsupportedOnDevice", "GroupsLimitExceeded"):
            label = "host_twin"
        routes[label] = routes.get(label, 0) + 1
        if (label == "host_twin") != draw.host_answered:
            raise AssertionError(f"{draw.pql}: route {route}, host twin "
                                 f"expected {draw.host_answered}")
        if not same_answer(resp, seq_resp, baseball.FLOAT_RTOL):
            baseball.check(resp, oracle, draw)
            judged += 1
    if not all(launches[name] for name in TABLE_KERNELS):
        raise AssertionError(f"a kernel never launched on the stacked "
                             f"baseballStats path: {launches}")
    if not routes.get("stacked"):
        raise AssertionError(f"no draw took the stacked route: {routes}")
    families = {}
    for family, draw, resp, first_ms, (route, _r), _s in runs:
        if route != "stacked":
            continue
        ts = []
        for _ in range(repeats):
            t0 = time.perf_counter()
            st_engine.query(draw.pql)
            torch.cuda.synchronize()
            ts.append((time.perf_counter() - t0) * 1e3)
        families.setdefault(family, []).extend(ts)
    emit({"phase": "baseball_stacked", "queries_passed": len(runs),
          "routes": routes, "not_shardable_reasons": reasons,
          "judged_by_oracle": judged,
          "p50_ms_by_family": {f: float(np.median(ts))
                               for f, ts in families.items()},
          "sequential_p50_ms_by_family": seq_p50,
          "stack_device_bytes": sum(
              st.device_bytes() for st in st_engine.sharded._stacks.values()),
          "launches": launches})
    return launches


def run_ssb(engine, oracle, repeats: int):
    """The SSB path: counts from 0, the 13 queries once, checked; then the
    timed repeats. Returns the path's launch counts and {query: canonical
    rows, "p50_ms": {query: p50}}."""
    from pinot_tpu_torch.ops import kernels as K
    from pinot_tpu_torch.tools.ssb import SSB_PQLS, canon_response, check
    K.reset_launch_counts()
    results = {}
    for q, pql in SSB_PQLS.items():
        t = time.perf_counter()
        resp = engine.query(pql)
        torch.cuda.synchronize()
        results[q] = (resp, (time.perf_counter() - t) * 1e3)
    launches = K.launch_counts()
    rows = {"p50_ms": {}}
    for q, (resp, _first_ms) in results.items():
        if resp.exceptions:
            raise AssertionError(f"{q}: {resp.exceptions}")
        rows[q] = canon_response(q, resp)
        check(q, rows[q], oracle[q]())
    for name in ("filter_mask", "masked_part_sums", "dense_group_aggregate"):
        if not launches[name]:
            raise AssertionError(f"{name} never launched on the SSB path: "
                                 f"{launches}")
    for q, pql in SSB_PQLS.items():
        ts = []
        for _ in range(repeats):
            t = time.perf_counter()
            engine.query(pql)
            torch.cuda.synchronize()
            ts.append((time.perf_counter() - t) * 1e3)
        rows["p50_ms"][q] = float(np.median(ts))
        emit({"phase": "ssb", "query": q, "check": "pass",
              "first_ms": results[q][1], "p50_ms": rows["p50_ms"][q],
              "samples_ms": ts})
    return launches, rows


def run_baseball(tables, repeats: int):
    """The baseballStats path: launch and path counts from 0, every draw
    of the mix once, and the raw-key and MV metric tables' queries on their
    own engines, checked against the vectorised oracles; then the timed
    repeats of the device-answered draws. `tables`: (engine, oracle,
    (family, draw) pairs), baseballStats first. Returns the path's launch
    counts, its seconds per part, the (family, draw, response) of each
    baseballStats draw and the p50 per family."""
    from pinot_tpu_torch.ops import kernels as K
    from pinot_tpu_torch.tools import baseball
    draws = [(f, d, e, o) for e, o, pairs in tables for f, d in pairs]
    seconds = {"device_first_runs": 0.0, "host_first_runs": 0.0}
    K.reset_launch_counts()
    for e, _o, _p in tables:
        e.executor.reset_path_counts()
    answered = []
    for family, draw, eng, orc in draws:
        host_before = eng.executor.path_counts["host"]
        t = time.perf_counter()
        resp = eng.query(draw.pql)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t
        on_host = eng.executor.path_counts["host"] > host_before
        seconds["host_first_runs" if on_host else "device_first_runs"] += \
            first_s
        answered.append((family, draw, eng, orc, resp, first_s * 1e3,
                         on_host))
    launches = K.launch_counts()
    paths = [dict(e.executor.path_counts) for e, _o, _p in tables]
    t = time.perf_counter()
    for family, draw, _e, orc, resp, _ms, on_host in answered:
        baseball.check(resp, orc, draw)
        if on_host != draw.host_answered:
            raise AssertionError(f"{draw.pql}: answered on the host: "
                                 f"{on_host}, expected {draw.host_answered}")
    seconds["oracle_checks"] = time.perf_counter() - t
    host_draws = [a[1] for a in answered if a[6]]
    # exactly the draws the JAX planner refuses: the 5 group-by
    # DISTINCTCOUNT draws and the MV expression aggregation
    n_refused = sum(d.host_answered for _f, d, _e, _o in draws)
    if len(host_draws) != n_refused or n_refused != 6 or \
            any(d.is_selection for d in host_draws):
        raise AssertionError(f"host path answered {len(host_draws)} draws, "
                             f"expected the {n_refused} refused ones")
    if not paths[0]["pruned"] or not paths[0]["fast"]:
        raise AssertionError(f"the pruner or a fast path never ran: "
                             f"{paths[0]}")
    for p in paths[1:]:
        if p["host"] or not p["scan"]:
            raise AssertionError(f"a raw-key or MV metric query left the "
                                 f"card: {p}")
    if not all(launches[name] for name in TABLE_KERNELS):
        raise AssertionError(f"a kernel never launched on the baseballStats "
                             f"path: {launches}")
    families = {}
    t = time.perf_counter()
    for family, draw, eng, _o, _resp, first_ms, on_host in answered:
        if on_host:
            ts = [first_ms]
            family = f"{family}_host"
        else:
            ts = []
            for _ in range(repeats):
                t0 = time.perf_counter()
                eng.query(draw.pql)
                torch.cuda.synchronize()
                ts.append((time.perf_counter() - t0) * 1e3)
        families.setdefault(family, []).extend(ts)
        emit({"phase": "baseball", "family": family, "pql": draw.pql,
              "check": "pass", "matched": int(draw.mask.sum()),
              "host": on_host, "p50_ms": float(np.median(ts))})
    seconds["timed_repeats"] = time.perf_counter() - t
    p50 = {f: float(np.median(ts)) for f, ts in families.items()}
    emit({"phase": "baseball_summary", "queries_passed": len(answered),
          "host_answered": len(host_draws),
          "p50_ms_by_family": p50,
          "device_table_bytes": sum(s.device_bytes()
                                    for s in tables[0][0].segments),
          "segment_paths": paths[0], "raw_key_segment_paths": paths[1],
          "mv_metric_segment_paths": paths[2], "launches": launches,
          "seconds": seconds})
    main_table = [(f, d, resp) for f, d, e, _o, resp, _ms, _h in answered
                  if e is tables[0][0]]
    return launches, seconds, main_table, p50


# ---------------------------------------------------------------------------
# VECTOR_SIMILARITY: the JAX package's vector rung (tools/vecdata.py)
# ---------------------------------------------------------------------------


def vec_data(base, args):
    """Phase vec_data: draw and seal the vector table with the port's
    SegmentCreator (IVF codebooks trained on the card: K10 and K11, their
    launches counted from 0), load it with from_dirs and put its lanes on
    the card. Returns (engine, draws, launches)."""
    from pinot_tpu_torch.engine import QueryEngine
    from pinot_tpu_torch.ops import kernels as K
    from pinot_tpu_torch.tools import vecdata
    K.reset_launch_counts()
    t0 = time.perf_counter()
    dirs, draws, secs = vecdata.build_segment_dirs(
        base, args.vec_rows, args.vec_segments, args.vec_dim)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    launches = K.launch_counts()
    if not launches["ivf_assign"] or not launches["ivf_recenter"]:
        raise AssertionError(f"IVF training left the card: {launches}")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    engine = QueryEngine.from_dirs(dirs)                  # on the card
    for seg in engine.segments:
        ds = seg.data_source("emb")
        for lane in (ds.device_vec_values, ds.device_ivf_assign,
                     ds.device_ivf_centroids, ds.device_ivf_valid,
                     seg.data_source("rid").device_dict_ids):
            lane()
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    emit({"phase": "vec_data", "rows": args.vec_rows,
          "segments": args.vec_segments, "dim": args.vec_dim,
          "centroids_per_segment": vecdata.CENTERS,
          "train_iterations": vecdata.IVF_ITERATIONS,
          "train_sample": vecdata.IVF_SAMPLE,
          "padded_rows_per_segment": engine.segments[0].padded_docs,
          "build_seconds": build_s, "draw_seconds": secs["draw"],
          "seal_seconds": secs["seal"], "train_seconds": secs["train"],
          "load_seconds": load_s,
          "device_table_bytes": sum(s.device_bytes()
                                    for s in engine.segments),
          "disk_bytes": sum(os.path.getsize(os.path.join(d, f))
                            for d in dirs for f in os.listdir(d)),
          "launches": {k: v for k, v in launches.items() if v}})
    return engine, draws, launches


def _query(q, dim: int):
    from pinot_tpu_torch.ops import kernels as K
    qp = np.zeros(dim, np.float32)
    qp[:len(q)] = q
    return qp, np.float32(np.sqrt(K.vec_tree_sum_plain(qp * qp)))


def _bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.shape == b.shape and torch.equal(a.view(torch.int32),
                                              b.view(torch.int32))


def _score_err(a: torch.Tensor, b: torch.Tensor) -> float:
    d = (a.double() - b.double()).abs().nan_to_num(0.0, 0.0, 0.0)
    return float(d.max()) if d.numel() else 0.0


def _topk_equal(got, want) -> bool:
    return all(torch.equal(got[k], want[k]) for k in want) and \
        set(got) == set(want)


def vector_kernel_check(engine, st_engine, q):
    """Phase vector_kernel_check: K8, K6's vector kind, K9 (with K1's
    ivf_probe node), K10 and K11 against their plain versions on segment
    0's lanes, and K8, K6-vector, K9 and K1 over the stack against their
    plain stacked versions and S per-segment launches. Bit-equal: K8's
    scores, K6's docids / scores / count, K9's probe lists, K1's masks;
    K10's assignments wherever the best two distances differ by more than
    1e-3 of the best, its distances within 1e-3 + 1e-4 relative; K11's
    counts equal, its centroids within 1e-5 and byte-identical run to
    run. Returns ({kernel: numbers}, {kernel: stacked numbers})."""
    from pinot_tpu_torch.ops import ivf_kernels as IK
    from pinot_tpu_torch.ops import kernels as K
    seg = engine.segments[0]
    P, n = seg.padded_docs, seg.num_docs
    ds = seg.data_source("emb")
    mat, ivfa = ds.device_vec_values(), ds.device_ivf_assign()
    cent, cvalid = ds.device_ivf_centroids(), ds.device_ivf_valid()
    dim, n_cent = mat.shape[1], int(ds.ivf_centroids.shape[0])
    c_pad = cent.shape[0]
    qp, qn = _query(q, dim)
    qt = torch.from_numpy(qp).to(mat.device)
    entries, stacked, report = {}, {}, []

    def record(name, case, equal, **numbers):
        r = {"kernel": name, "case": case, "equal": bool(equal), **numbers}
        report.append(r)
        emit({"phase": "vector_kernel_check", **r})
        if not equal:
            raise AssertionError(f"{name} disagrees with its plain version "
                                 f"on {case}: {r}")

    # K8 on segment 0, both metrics
    for metric in ("cosine", "dot"):
        got = K.vector_scores(mat, qp, qn, metric)
        ref = K.vector_scores_plain(mat, qp, qn, metric)
        record("vector_scores", metric, _bits_equal(got, ref),
               max_abs_err=_score_err(got, ref))
    k8_bytes = P * dim * 4 + P * 4
    entries["vector_scores"] = dict(
        max_abs_err=0.0,
        ms=time_ms(lambda: K.vector_scores(mat, qp, qn, "cosine")),
        plain_ms=time_ms(lambda: K.vector_scores_plain(mat, qp, qn,
                                                       "cosine"), reps=3),
        bound=bound(k8_bytes, 4.0 * P * dim),
        library_ms=time_ms(lambda: torch.mv(mat, qt)))

    # K6's vector kind on K8's cosine scores, every valid row matched
    mask = K.filter_mask(P, ("match_all",), {}, [], n, mat.device)
    scores = K.vector_scores(mat, qp, qn, "cosine")
    got = K.vector_topk(scores, mask, 16)
    ref = K.vector_topk_plain(scores, mask, 16)
    record("masked_select_vector", "cosine k=16", _topk_equal(got, ref),
           count=int(got["sel.count"]))
    masked = torch.where(mask.bool(), scores, float("-inf"))
    entries["masked_select_vector"] = dict(
        max_abs_err=0.0,
        ms=time_ms(lambda: K.vector_topk(scores, mask, 16)),
        plain_ms=time_ms(lambda: K.vector_topk_plain(scores, mask, 16),
                         reps=3),
        bound=bound(P + P * 4 + 16 * 8, P), library_ms=time_ms(
            lambda: torch.topk(torch.where(mask.bool(), scores,
                                           float("-inf")), 16)))
    del masked

    # K9 (nprobe 16) and K1's ivf_probe node (its K9 inside)
    for metric in ("cosine", "dot"):
        ids, ok = K.ivf_select_probes(cent, cvalid, qp, qn, metric, 16)
        rids, rok = K.ivf_select_probes_plain(cent, cvalid, qp, qn, metric,
                                              16)
        record("ivf_probe_select", metric,
               torch.equal(ids, rids) and torch.equal(ok, rok),
               live_centroids=int(cvalid.sum()))
    entries["ivf_probe_select"] = dict(
        max_abs_err=0.0,
        ms=time_ms(lambda: K.ivf_select_probes(cent, cvalid, qp, qn,
                                               "cosine", 16)),
        plain_ms=time_ms(lambda: K.ivf_select_probes_plain(
            cent, cvalid, qp, qn, "cosine", 16), reps=3),
        bound=bound(c_pad * dim * 4 + c_pad + 16 * 5, 4.0 * c_pad * dim),
        library_ms=time_ms(lambda: torch.topk(torch.mv(cent, qt), 16)))
    probe = ("pred", "ivf_probe", "emb", "ivf", (16, "cosine"))
    pcols = {"emb.ivfa": ivfa, "emb.ivfc": cent, "emb.ivfv": cvalid}
    got = K.filter_mask(P, probe, pcols, [qp, qn], n)
    ref = K.filter_mask_plain(P, probe, pcols, [qp, qn], n)
    record("filter_mask", "ivf_probe nprobe=16 (with its K9)",
           torch.equal(got, ref), matched=int(ref.sum()),
           ms=time_ms(lambda: K.filter_mask(P, probe, pcols, [qp, qn], n)),
           plain_ms=time_ms(lambda: K.filter_mask_plain(
               P, probe, pcols, [qp, qn], n), reps=3),
           bound_ms=bound(P * ivfa.element_size() + P +
                          c_pad * dim * 4, P * 16)[0])

    # K10 over segment 0's rows against its codebook
    data = mat[:n]
    assign, dist = IK.ivf_assign(data, cent, n, n_cent)
    ref_a, ref_d = IK.ivf_assign_plain(data, cent, n, n_cent)
    d2 = (K.vec_tree_sum_plain(data * data)[:, None] -
          2.0 * (data @ cent[:n_cent].T) +
          K.vec_tree_sum_plain(cent[:n_cent] * cent[:n_cent])[None, :])
    two = torch.topk(d2, 2, dim=1, largest=False).values
    sure = (two[:, 1] - two[:, 0]) > 1e-3 * two[:, 0].abs().clamp_min(1.0)
    del d2, two
    mismatched = int(((assign != ref_a) & sure).sum())
    record("ivf_assign", f"{n} rows x {n_cent} centroids", mismatched == 0 and
           bool(torch.allclose(dist, ref_d, rtol=1e-4, atol=1e-3)),
           mismatched_sure=mismatched, unsure_rows=int((~sure).sum()),
           differ_unsure=int(((assign != ref_a) & ~sure).sum()),
           max_abs_err=float((dist - ref_d).abs().max()))
    flops = 2.0 * n * n_cent * dim
    entries["ivf_assign"] = dict(
        max_abs_err=float((dist - ref_d).abs().max()),
        ms=time_ms(lambda: IK.ivf_assign(data, cent, n, n_cent), reps=5),
        plain_ms=time_ms(lambda: IK.ivf_assign_plain(data, cent, n, n_cent),
                         reps=3),
        bound=bound(n * dim * 4 + n_cent * dim * 4 + n * 8, flops),
        library_ms=time_ms(lambda: torch.cdist(data, cent[:n_cent])
                           .argmin(dim=1), reps=3))

    # K11 on a training sample's shape (its first rows, K10's cells)
    m = min(65536, n)
    sample = data[:m].contiguous()
    a_s, _ = IK.ivf_assign(sample, cent, m, n_cent)
    new_c, counts = IK.ivf_recenter(sample, a_s, m, cent)
    again, _ = IK.ivf_recenter(sample, a_s, m, cent)
    ref_c, ref_n = IK.ivf_recenter_plain(sample, a_s, m, cent)
    err = float((new_c - ref_c).abs().max())
    record("ivf_recenter", f"{m} rows x {c_pad} centroids",
           torch.equal(counts, ref_n) and _bits_equal(new_c, again) and
           bool(torch.allclose(new_c, ref_c, rtol=1e-5, atol=1e-5)),
           max_abs_err=err, run_to_run_bytes_equal=_bits_equal(new_c, again))
    entries["ivf_recenter"] = dict(
        max_abs_err=err,
        ms=time_ms(lambda: IK.ivf_recenter(sample, a_s, m, cent)),
        plain_ms=time_ms(lambda: IK.ivf_recenter_plain(sample, a_s, m,
                                                       cent), reps=3),
        bound=bound(m * dim * 4 + m * 4 + 2 * c_pad * dim * 4 + c_pad * 4,
                    1.0 * m * dim),
        library_ms=time_ms(lambda: torch.zeros_like(cent).index_add_(
            0, a_s.long(), sample)))

    # the stack: one launch over all S segments against S launches
    stack = st_engine.sharded.stack_for(st_engine.segments)
    S = stack.n_real
    keys = [("emb", "vec"), ("emb", "ivfa"), ("emb", "ivfc"), ("emb", "ivfv")]
    flat = K.flat_lanes(stack.gather(keys), S, P)
    segs, docs = stack.segments, stack.device_num_docs()
    per = [{k: getattr(sg.data_source("emb"), f)() for k, f in
            (("vec", "device_vec_values"), ("ivfa", "device_ivf_assign"),
             ("ivfc", "device_ivf_centroids"), ("ivfv", "device_ivf_valid"))}
           for sg in segs]
    svec = flat["emb.vec"]
    got = K.vector_scores(svec, qp, qn, "cosine")
    seq = torch.cat([K.vector_scores(p["vec"], qp, qn, "cosine")
                     for p in per])
    equal = _bits_equal(got, K.vector_scores_plain(svec, qp, qn, "cosine")) \
        and _bits_equal(got, seq)
    b = bound(S * P * dim * 4 + S * P * 4, 4.0 * S * P * dim)
    st = dict(ms=time_ms(lambda: K.vector_scores(svec, qp, qn, "cosine")),
              s_sequential_ms=time_ms(lambda: [K.vector_scores(
                  p["vec"], qp, qn, "cosine") for p in per], spins=S),
              bound_ms=b[0])
    record("vector_scores", f"stacked S={S}", equal, **st)
    stacked["vector_scores"] = st
    smask, _matched = K.filter_mask_stacked(P, S, ("match_all",), {}, [],
                                            docs, mat.device)
    got = K.vector_topk(got, smask, 16, n_segs=S)
    equal = _topk_equal(got, K.vector_topk_plain(seq, smask, 16, n_segs=S))
    seg_masks = [smask[i * P:(i + 1) * P] for i in range(S)]
    seg_scores = [seq[i * P:(i + 1) * P] for i in range(S)]
    equal = equal and all(
        torch.equal(got["sel.docids"][i],
                    K.vector_topk(seg_scores[i], seg_masks[i], 16)
                    ["sel.docids"]) for i in range(S))
    st = dict(ms=time_ms(lambda: K.vector_topk(seq, smask, 16, n_segs=S)),
              s_sequential_ms=time_ms(lambda: [
                  K.vector_topk(seg_scores[i], seg_masks[i], 16)
                  for i in range(S)], spins=S),
              bound_ms=bound(S * P * 5 + S * 16 * 8, S * P)[0])
    record("masked_select_vector", f"stacked S={S}", equal, **st)
    stacked["masked_select_vector"] = st
    scent, scv = flat["emb.ivfc"], flat["emb.ivfv"]
    ids, ok = K.ivf_select_probes(scent, scv, qp, qn, "cosine", 16)
    rids, rok = K.ivf_select_probes_plain(scent, scv, qp, qn, "cosine", 16)
    equal = torch.equal(ids, rids) and torch.equal(ok, rok) and all(
        torch.equal(ids[i], K.ivf_select_probes(
            p["ivfc"], p["ivfv"], qp, qn, "cosine", 16)[0])
        for i, p in enumerate(per))
    st = dict(ms=time_ms(lambda: K.ivf_select_probes(scent, scv, qp, qn,
                                                     "cosine", 16)),
              s_sequential_ms=time_ms(lambda: [K.ivf_select_probes(
                  p["ivfc"], p["ivfv"], qp, qn, "cosine", 16) for p in per],
                  spins=S),
              bound_ms=bound(S * (c_pad * dim * 4 + c_pad + 80),
                             4.0 * S * c_pad * dim)[0])
    record("ivf_probe_select", f"stacked S={S}", equal, **st)
    stacked["ivf_probe_select"] = st
    got_m, got_n = K.filter_mask_stacked(P, S, probe, flat, [qp, qn], docs)
    ref_m, ref_n = K.filter_mask_stacked_plain(P, S, probe, flat, [qp, qn],
                                               docs)
    record("filter_mask", f"ivf_probe stacked S={S}",
           torch.equal(got_m, ref_m) and torch.equal(got_n, ref_n),
           matched=int(ref_n.sum()))
    for name in ("ivf_assign", "ivf_recenter"):
        stacked[name] = dict(ms=None, s_sequential_ms=None, bound_ms=None)
    return entries, stacked


def _vec_pql(q, metric: str, nprobe: int, where: str = "") -> str:
    qs = ", ".join(repr(float(x)) for x in q)
    clause = f", nprobe={nprobe}" if nprobe else ""
    from pinot_tpu_torch.tools import vecdata
    return (f"SELECT rid, VECTOR_SIMILARITY(emb, [{qs}], {vecdata.K}, "
            f"'{metric}'{clause}) FROM {vecdata.TABLE} {where}").strip()


def run_vector(engine, st_engine, queries, args, repeats: int):
    """Phase vector, per segment and stacked: counts set to 0, each query
    vector under COSINE and DOT, exact and at nprobe 1, 4 and 16, and one
    filtered exact query, run once; the counts read (K1, K8, K9 and K6's
    vector kind must have launched) and the routes; every exact answer
    equal to the chunked numpy oracle bit for bit (docids, segments,
    scores), the stacked answers equal to the per-segment ones; per rung
    the recall@10 against the exact answer and the share of rows scanned
    (numDocsScanned); then the timed repeats (p50 per rung). The gate of
    scripts/vec_ann_bench.py: some nprobe rung reaches recall@10 >= 0.95
    (mean over the queries) while scanning < 15% of the rows. Returns the
    launch counts per route."""
    from pinot_tpu_torch.ops import kernels as K
    from pinot_tpu_torch.tools import vecdata
    rows = sum(s.num_docs for s in engine.segments)
    t0 = time.perf_counter()
    oracle = vecdata.VecOracle([(s.segment_name,
                                 s.data_source("emb").vec_values)
                                for s in engine.segments])
    cut = rows * 3 // 10                               # WHERE rid < cut
    rid_masks = [s.data_source("rid").dictionary.values[
        s.data_source("rid").dict_ids] < cut for s in engine.segments]
    exact = {}
    for qi, q in enumerate(queries):
        for metric in ("COSINE", "DOT"):
            exact[(qi, metric)] = oracle.topk(q, vecdata.K, metric)
    exact_filtered = oracle.topk(queries[0], vecdata.K, "COSINE", rid_masks)
    oracle_s = time.perf_counter() - t0
    rungs = [("exact", 0)] + [(f"nprobe={p}", p) for p in vecdata.NPROBES]
    launches_by_route, answers = {}, {}
    for route, eng in (("per_segment", engine), ("stacked", st_engine)):
        K.reset_launch_counts()
        eng.executor.reset_path_counts()
        eng.route_counts.clear()
        runs = {}
        for qi, q in enumerate(queries):
            for metric in ("COSINE", "DOT"):
                for rung, nprobe in rungs:
                    t = time.perf_counter()
                    resp = eng.query(_vec_pql(q, metric, nprobe))
                    torch.cuda.synchronize()
                    runs[(qi, metric, rung)] = (
                        resp, (time.perf_counter() - t) * 1e3)
        t = time.perf_counter()
        fresp = eng.query(_vec_pql(queries[0], "COSINE", 0,
                                   f"WHERE rid < {cut}"))
        torch.cuda.synchronize()
        filtered_ms = (time.perf_counter() - t) * 1e3
        launches = K.launch_counts()
        launches_by_route[route] = launches
        if route == "stacked":
            routes = dict(eng.route_counts)
            paths = dict(eng.sharded.plan_maker.path_counts)
            if routes != {"stacked": len(runs) + 1}:
                raise AssertionError(f"vector queries left the stacked "
                                     f"path: {routes}")
        else:
            routes = dict(eng.executor.path_counts)
            paths = dict(eng.executor.plan_maker.path_counts)
        for name in ("filter_mask", "vector_scores", "masked_select_vector",
                     "ivf_probe_select"):
            if not launches[name]:
                raise AssertionError(f"{name} never launched on the {route} "
                                     f"vector path: {launches}")
        got_rows = {}
        for key, (resp, _ms) in runs.items():
            if resp.exceptions:
                raise AssertionError(f"{route} {key}: {resp.exceptions}")
            got_rows[key] = [(int(r[1]), r[2], float(r[3]))
                             for r in resp.selection_results.results]
        for (qi, metric), want in exact.items():
            if got_rows[(qi, metric, "exact")] != want:
                raise AssertionError(f"{route}: exact q{qi} {metric} differs "
                                     "from the oracle")
        fgot = [(int(r[1]), r[2], float(r[3]))
                for r in fresp.selection_results.results]
        if fgot != exact_filtered:
            raise AssertionError(f"{route}: filtered query differs from the "
                                 "oracle")
        answers[route] = got_rows
        stats = {}
        for rung, nprobe in rungs:
            for metric in ("COSINE", "DOT"):
                rec, scan = [], []
                for qi in range(len(queries)):
                    resp, _ms = runs[(qi, metric, rung)]
                    rec.append(vecdata.recall(
                        [r[:2] for r in got_rows[(qi, metric, rung)]],
                        [r[:2] for r in exact[(qi, metric)]]))
                    scan.append(resp.num_docs_scanned / rows)
                stats[f"{rung} {metric}"] = {
                    "recall_at_10": float(np.mean(rec)),
                    "recall_min": float(min(rec)),
                    "scanned_share": float(np.mean(scan))}
        firsts = {rung: float(np.median([ms for (qi, m, r), (_resp, ms)
                                         in runs.items() if r == rung]))
                  for rung, _n in rungs}
        p50 = {}
        for rung, nprobe in rungs:
            ts = []
            for _ in range(repeats):
                for qi, q in enumerate(queries):
                    for metric in ("COSINE", "DOT"):
                        pql = _vec_pql(q, metric, nprobe)
                        t = time.perf_counter()
                        eng.query(pql)
                        torch.cuda.synchronize()
                        ts.append((time.perf_counter() - t) * 1e3)
            p50[rung] = float(np.median(ts))
        emit({"phase": "vector", "route": route, "rows": rows,
              "queries": len(queries), "metrics": ["COSINE", "DOT"],
              "exact_equal_oracle": True, "p50_ms": p50,
              "first_run_median_ms": firsts, "rungs": stats,
              "filtered": {"where": f"rid < {cut}", "ms": filtered_ms,
                           "scanned_share": fresp.num_docs_scanned / rows,
                           "equal_oracle": True},
              "routes": routes, "ivf_paths": paths,
              "oracle_seconds": oracle_s,
              "launches": {k: v for k, v in launches.items() if v}})
        if route == "stacked":
            if got_rows != answers["per_segment"]:
                raise AssertionError("stacked vector answers differ from "
                                     "the per-segment ones")
        gate = [r for r, s in stats.items() if r.endswith("COSINE") and
                r != "exact COSINE" and s["recall_at_10"] >= VEC_RECALL_GATE
                and s["scanned_share"] < VEC_SCAN_GATE]
        if not gate:
            raise AssertionError(f"{route}: no nprobe rung reaches recall@10 "
                                 f">= {VEC_RECALL_GATE} scanning < "
                                 f"{VEC_SCAN_GATE} of the rows: {stats}")
    return launches_by_route


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--sf", type=int, default=10)
    ap.add_argument("--segments", type=int, default=8)
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--bb-rows", type=int, default=10_000_000)
    ap.add_argument("--bb-segments", type=int, default=4)
    ap.add_argument("--vec-rows", type=int, default=10_000_000)
    ap.add_argument("--vec-segments", type=int, default=4)
    ap.add_argument("--vec-dim", type=int, default=128)
    ap.add_argument("--vec-queries", type=int, default=5)
    args = ap.parse_args()
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1

    from pinot_tpu_torch.engine import QueryEngine
    from pinot_tpu_torch.ops import build
    from pinot_tpu_torch.ops import kernels as K
    from pinot_tpu_torch.parallel import make_mesh
    from pinot_tpu_torch.pql.parser import compile_pql
    from pinot_tpu_torch.tools import baseball
    from pinot_tpu_torch.tools.datagen import make_ssb_segments
    from pinot_tpu_torch.tools.ssb import SSB_PQLS, make_cpu_queries

    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    emit({"phase": "device", "kind": kind, "count": torch.cuda.device_count(),
          "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda})
    seconds = {}                    # wall seconds per phase, host clock

    t0 = time.perf_counter()
    libs = build.build_all()
    seconds["build"] = time.perf_counter() - t0
    emit({"phase": "build", "seconds": seconds["build"],
          "dir": str(build.build_dir()),
          "libs": {s: str(p) for s, p in libs.items()},
          "ptxas": build.BUILD_INFO.get("ptxas", {})})

    # -- SSB, in memory ---------------------------------------------------
    rows = args.sf * ROWS_PER_SF
    t0 = time.perf_counter()
    table = make_ssb_segments(rows, args.segments, seed=args.seed)
    engine = QueryEngine(table.segments)                  # on the card
    oracle = make_cpu_queries(table.pools, table.ids, table.supplycost)
    seconds["data"] = time.perf_counter() - t0
    emit({"phase": "data", "scale_factor": args.sf, "rows": rows,
          "segments": args.segments,
          "padded_rows_per_segment": table.segments[0].padded_docs,
          "seconds": seconds["data"]})
    t0 = time.perf_counter()
    entries = kernel_check(engine.segments[0], SSB_PQLS)
    seconds["kernel_check"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    ssb_launches, ssb_rows = run_ssb(engine, oracle, args.repeats)
    seconds["ssb"] = time.perf_counter() - t0
    emit({"phase": "ssb_summary", "scale_factor": args.sf, "rows": rows,
          "queries_passed": len(SSB_PQLS),
          "device_table_bytes": sum(s.device_bytes()
                                    for s in engine.segments),
          "peak_device_bytes": torch.cuda.max_memory_allocated(),
          "launches": ssb_launches})
    # the same segments stacked: one launch per kernel over all of them
    st_engine = QueryEngine(engine.segments, mesh=make_mesh())
    t0 = time.perf_counter()
    stack = st_engine.sharded.stack_for(st_engine.segments)
    stack.gather(sorted({key for pql in SSB_PQLS.values() for key in
                         st_engine.sharded.plan_maker.make_segment_plan(
                             stack.plan_segment(), st_engine.optimizer
                             .optimize(compile_pql(pql))).needed_cols}))
    torch.cuda.synchronize()
    seconds["ssb_stack"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    stacked_entries = stacked_kernel_check(st_engine, SSB_PQLS)
    seconds["stacked_kernel_check"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    ssb_st_launches = run_ssb_stacked(st_engine, ssb_rows, oracle,
                                      args.repeats)
    seconds["ssb_stacked"] = time.perf_counter() - t0
    emit({"phase": "ssb_stacked_summary", "segments": stack.n_real,
          "queries_passed": len(SSB_PQLS),
          "stack_seconds": seconds["ssb_stack"],
          "stack_device_bytes": stack.device_bytes(),
          "segment_device_bytes": sum(s.device_bytes()
                                      for s in engine.segments),
          "peak_device_bytes": torch.cuda.max_memory_allocated(),
          "launches": ssb_st_launches})
    del engine, st_engine, stack, table, oracle
    torch.cuda.empty_cache()

    # -- baseballStats, from disk -----------------------------------------
    scratch = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "build")
    os.makedirs(scratch, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=scratch) as base:
        t0 = time.perf_counter()
        dirs, cols = baseball.build_segment_dirs(
            base, args.bb_rows, args.bb_segments, seed=args.seed)
        seconds["bb_data_build"] = time.perf_counter() - t0
        # the raw-key table: runs, hits and salary without a dictionary
        t0 = time.perf_counter()
        raw_dir, raw_cols = baseball.build_raw_key_dir(
            base, baseball.RAW_KEY_ROWS, seed=args.seed + args.bb_segments)
        seconds["bb_data_raw_key_build"] = time.perf_counter() - t0
        # the MV metric table: a numeric MV column
        t0 = time.perf_counter()
        mv_dir, mv_cols = baseball.build_mv_metric_dir(
            base, baseball.MV_METRIC_ROWS,
            seed=args.seed + args.bb_segments + 1)
        seconds["bb_data_mv_metric_build"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        engine = QueryEngine.from_dirs(dirs)              # on the card
        raw_engine = QueryEngine.from_dirs([raw_dir])
        mv_engine = QueryEngine.from_dirs([mv_dir])
        seconds["bb_data_load"] = time.perf_counter() - t0
        emit({"phase": "bb_data", "rows": args.bb_rows,
              "segments": args.bb_segments,
              "padded_rows_per_segment": engine.segments[0].padded_docs,
              "raw_key_rows": baseball.RAW_KEY_ROWS,
              "mv_metric_rows": baseball.MV_METRIC_ROWS,
              "build_seconds": seconds["bb_data_build"],
              "raw_key_build_seconds": seconds["bb_data_raw_key_build"],
              "mv_metric_build_seconds": seconds["bb_data_mv_metric_build"],
              "load_seconds": seconds["bb_data_load"],
              "disk_bytes": sum(os.path.getsize(os.path.join(d, f))
                                for d in dirs + [raw_dir, mv_dir]
                                for f in os.listdir(d))})
        oracle = baseball.Oracle(cols)
        raw_oracle = baseball.Oracle(raw_cols)
        mv_oracle = baseball.Oracle(mv_cols)
        t0 = time.perf_counter()
        entries.update(bb_kernel_check(engine.segments[0],
                                       raw_engine.segments[0]))
        seconds["bb_kernel_check"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        entries.update(select_kernel_check(engine.segments[0]))
        seconds["select_kernel_check"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        bb_launches, bb_seconds, bb_answered, bb_p50 = run_baseball(
            [(engine, oracle, list(baseball.all_draws(oracle))),
             (raw_engine, raw_oracle,
              [("raw_group_by", d) for d in
               baseball.raw_key_draws(raw_oracle)]),
             (mv_engine, mv_oracle,
              [("mv_metric", d) for d in
               baseball.mv_metric_draws(mv_oracle)])], args.repeats)
        seconds["baseball"] = time.perf_counter() - t0
        seconds.update({f"baseball_{k}": v for k, v in bb_seconds.items()})
        t0 = time.perf_counter()
        bb_st_launches = run_baseball_stacked(
            QueryEngine(engine.segments, mesh=make_mesh()), bb_answered,
            oracle, args.repeats, bb_p50)
        seconds["baseball_stacked"] = time.perf_counter() - t0
    del engine, raw_engine, mv_engine
    torch.cuda.empty_cache()

    # -- VECTOR_SIMILARITY, from disk -------------------------------------
    with tempfile.TemporaryDirectory(dir=scratch) as base:
        t0 = time.perf_counter()
        vec_engine, draws, vec_build_launches = vec_data(base, args)
        seconds["vec_data"] = time.perf_counter() - t0
        vec_st_engine = QueryEngine(vec_engine.segments, mesh=make_mesh())
        queries = draws.queries(args.vec_queries)
        t0 = time.perf_counter()
        vec_entries, vec_stacked = vector_kernel_check(
            vec_engine, vec_st_engine, queries[0])
        entries.update(vec_entries)
        stacked_entries.update(vec_stacked)
        seconds["vector_kernel_check"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        vec_launches = run_vector(vec_engine, vec_st_engine, queries, args,
                                  args.repeats)
        seconds["vector"] = time.perf_counter() - t0
        emit({"phase": "vector_summary", "rows": args.vec_rows,
              "segment_device_bytes": sum(s.device_bytes()
                                          for s in vec_engine.segments),
              "stack_device_bytes": sum(
                  st.device_bytes()
                  for st in vec_st_engine.sharded._stacks.values()),
              "peak_device_bytes": torch.cuda.max_memory_allocated()})
        del vec_engine, vec_st_engine
    emit({"phase": "timing", "seconds": seconds,
          "total_seconds": time.perf_counter() - t_start})

    print(smi, flush=True)
    line = []
    for name, info in K.KERNELS.items():
        e, st = entries[name], stacked_entries[name]
        st_launches = ssb_st_launches[name] + bb_st_launches[name] + \
            vec_launches["stacked"][name]
        line.append({"name": name, "route": "cuda", "source": info.source,
                     "replaces": info.replaces,
                     "launches": ssb_launches[name] + bb_launches[name] +
                     vec_build_launches[name] +
                     vec_launches["per_segment"][name] + st_launches,
                     "max_abs_err": e["max_abs_err"], "ms": e["ms"],
                     "plain_ms": e["plain_ms"], "bound_ms": e["bound"][0],
                     "bound_by": e["bound"][1],
                     "library_ms": e["library_ms"],
                     "stacked_launches": st_launches,
                     "stacked_ms": st["ms"],
                     "stacked_s_sequential_ms": st["s_sequential_ms"],
                     "stacked_bound_ms": st["bound_ms"]})
    emit({"kernels": line})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
