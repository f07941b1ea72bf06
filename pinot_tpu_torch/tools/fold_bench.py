"""K3's and K15's group-table fold on the SSB and baseballStats tables.

    python3 pinot_tpu_torch/tools/fold_bench.py [--mode MODE] [--out FILE]

On the card: the SSB lineorder table of chip_smoke.py (SF x 6,000,000
rows in SEGMENTS segments, from SEED) and chip_smoke's baseballStats
segment 0 and raw-key segment (built under build/). Modes:

  routes   (default) K3 on every SSB group-by over segment 0's operands
           (compaction off: the dense direct-keyed route), over the
           8-segment stack (int64 part sums) for STACKED_QUERIES and on
           the baseballStats cases; then `compact`. Each as chip_smoke.py's
           k3_check and compact_kernel_check run it: the call the main
           path makes and every route forced that takes the table, each
           launch bit-checked against the plain version, each timed with
           tools/timing.py:time_ms (L2 flushed), with the picked call's
           launch_breakdown.
  compact  chip_smoke.py's compact_kernel_check on every SSB group-by of
           segment 0: K3 over the remapped keys, K14, K16 and K15 on each
           compacted table.
  picked   K3 and K15 as the main path calls them (no route argument) on
           the SSB group-bys (K3 dense, K15 on each compacted table) and
           the baseballStats K3 cases: the integer outputs held to the
           plain version's, the median of PICKED_REPS launches' device
           time (L2 flushed, a 1 ms spin before each) and
           launch_breakdown. It uses only calls that the previous fold
           kernel's tree also has, so the same file, copied into an
           unpacked older commit and run from there, times that commit's
           kernels on the same data in the same chip call.

chip_smoke.py runs the same checks on every group-by case; this tool is
the quick loop while a route changes. Prints one JSON line a case (and
writes them to --out); exits 2 without a card. Run it as a file from the
repo root: it imports chip_smoke.py.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import tempfile

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

SF = 10
SEGMENTS = 8
SEED = 0
STACKED_QUERIES = ("q2.1", "q4.3")
BB_ROWS, BB_SEGMENTS = 10_000_000, 4      # chip_smoke.py's defaults
PICKED_REPS = 21
MODES = ("routes", "compact", "picked")


def median_ms(fn, reps: int = PICKED_REPS) -> float:
    """Median device time of fn() over `reps` calls, each after a dirty
    L2 flush (as tools/timing.py:time_ms flushes) and a ~1 ms spin, so the
    host enqueues the call while the card is busy: one host stall moves
    one sample, not the reading."""
    flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
    fn()
    samples = []
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(2_000_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end))
    return statistics.median(samples)


def ints_equal(got, ref, int_at) -> bool:
    """The exact outputs (indices `int_at`: counts, part sums, matched and
    the list of min / max tables) of a K3 / K15 call against the plain
    version's."""
    ok = True
    for i in int_at:
        a, b = got[i], ref[i]
        if isinstance(a, (list, tuple)):
            ok = ok and all(torch.equal(x, y) for x, y in zip(a, b))
        else:
            ok = ok and torch.equal(a.long(), b.long())
    return ok


def ssb_table():
    import chip_smoke as cs
    from pinot_tpu_torch.engine import QueryEngine
    from pinot_tpu_torch.tools.datagen import make_ssb_segments
    table = make_ssb_segments(SF * cs.ROWS_PER_SF, SEGMENTS, seed=SEED)
    return table, QueryEngine(table.segments)


def group_bys():
    """(query, pql) of the SSB group-bys."""
    from pinot_tpu_torch.tools.ssb import SSB_PQLS
    return [(q, pql) for q, pql in SSB_PQLS.items()
            if "GROUP BY" in pql.upper()]


def baseball_segments(build_dir):
    """chip_smoke's baseballStats segment 0 and its raw-key segment."""
    from pinot_tpu_torch.engine import QueryEngine
    from pinot_tpu_torch.tools import baseball
    dirs, _c = baseball.build_segment_dirs(
        build_dir, BB_ROWS // BB_SEGMENTS, 1, seed=SEED)
    raw_dir, _r = baseball.build_raw_key_dir(
        build_dir, baseball.RAW_KEY_ROWS, seed=SEED + BB_SEGMENTS)
    return (QueryEngine.from_dirs(dirs).segments[0],
            QueryEngine.from_dirs([raw_dir]).segments[0])


def bb_cases(bb, raw):
    import chip_smoke as cs
    return [(f"baseball {c}", q, bb) for c, q in cs.BB_K3_PQLS.items()] + \
        [("baseball rawoff hits x league", cs.BB_RAW_K3_PQL, raw)]


def slot_operands(seg, pql):
    """K15's arguments on `pql`'s final compacted dispatch on `seg`, built
    as chip_smoke.py's compact_kernel_check builds them, or None where the
    dispatch runs no K15 (no row matched, dense regime, sorted rung)."""
    import chip_smoke as cs
    from pinot_tpu_torch.ops import kernels as K
    from pinot_tpu_torch.pql.optimizer import BrokerRequestOptimizer
    from pinot_tpu_torch.pql.parser import compile_pql
    from pinot_tpu_torch.query.execution import gather_operands
    from pinot_tpu_torch.query.plan import InstancePlanMaker
    P, n = seg.padded_docs, seg.num_docs
    plan = InstancePlanMaker().make_segment_plan(
        seg, BrokerRequestOptimizer().optimize(compile_pql(pql)))
    cols = gather_operands(plan)
    mask = K.filter_mask(P, plan.filter_spec, cols, plan.params, n)
    if not int(mask.sum()):
        return None
    spec, extra = cs.final_group_dispatch(seg, plan, cols)
    gcols, strides, g_pad, gaggs, kmax = spec
    if not kmax:
        return None
    params = list(plan.group_params) + list(extra)
    key_params = list(params)            # popped in key order
    keys = [K.spec_group_key(g, cols, key_params, seg.device)
            for g in gcols]
    lanes = K._group_lanes(gaggs, cols)
    w = K.group_combos(keys)
    t = P * w // K.CBLOCK
    r = min(max(-(-min(kmax * w, P * w) // t), 8), K.CBLOCK)
    if r > K.SORTED_RUNG_R:
        return None
    ids_lanes = [e[1] for e in lanes.extremes if e[0] == "ids"]
    value_lanes = lanes.floats + [e[1] for e in lanes.extremes
                                  if e[0] == "raw"]
    kc, parts_c, vals_c, ids_c, _ovf, _m = K.block_compact(
        mask, keys, strides, g_pad, r, lanes.parts, value_lanes, ids_lanes)
    cap = t * r
    if g_pad > K.DENSE_G_LIMIT:
        gslot, t_slots = K.rank_slots(kc, cap, g_pad)[0], cap
    else:
        gslot, t_slots = kc, g_pad
    ext, n_id, n_raw = [], 0, len(lanes.floats)
    for kind, _lane, which, card_pad in lanes.extremes:
        if kind == "ids":
            ext.append(("ids", ids_c[n_id], which,
                        card_pad if which == "min" else -1))
            n_id += 1
        else:
            ext.append(("raw", vals_c[n_raw], which, 0))
            n_raw += 1
    return (gslot, t_slots, cap, parts_c, vals_c[:len(lanes.floats)], ext)


def picked_case(emit, kernel, case, fn, plain, int_at, **info):
    """One `picked` reading: fn() (the main path's call) against plain()
    on the integer outputs, its median time and launch_breakdown."""
    from pinot_tpu_torch.ops import kernels as K
    from pinot_tpu_torch.tools.timing import launch_breakdown
    ref = plain()
    K.reset_launch_counts()
    ok = all(ints_equal(fn(), ref, int_at) for _ in range(3))
    counts = {k: v for k, v in K.launch_counts().items()
              if k.startswith(kernel) and v}
    emit({"mode": "picked", "kernel": kernel, "case": case, **info,
          "launches": counts, "ints_equal": ok, "ms_median": median_ms(fn),
          "launch_us": launch_breakdown(fn)})
    if not ok:
        raise AssertionError(f"{kernel} {case} disagrees")


def run_picked(emit, seg, bb, raw) -> None:
    import chip_smoke as cs
    from pinot_tpu_torch.ops import kernels as K
    for q, pql in group_bys():
        plan, cols = cs.plan_operands(seg, pql)
        mask = K.filter_mask(seg.padded_docs, plan.filter_spec, cols,
                             plan.params, seg.num_docs)
        args = (mask,) + tuple(cs.group_operands(plan, cols))
        picked_case(emit, "dense_group_aggregate", q,
                    lambda: K.dense_group_aggregate(*args),
                    lambda: K.dense_group_aggregate_plain(*args),
                    (0, 1, 3, 4), g_pad=args[3], matched=int(mask.sum()))
    for q, pql in group_bys():
        a15 = slot_operands(seg, pql)
        if a15 is None:
            continue
        picked_case(emit, "slot_tables", q, lambda: K.slot_tables(*a15),
                    lambda: K.slot_tables_plain(*a15), (0, 1, 3),
                    t_slots=a15[1], cap=a15[2],
                    valid_slots=int((a15[0] < a15[1]).sum()))
    for case, pql, sg in bb_cases(bb, raw):
        plan, cols = cs.plan_operands(sg, pql)
        mask = K.filter_mask(sg.padded_docs, plan.filter_spec, cols,
                             plan.params, sg.num_docs)
        args = (mask,) + tuple(cs.group_operands(plan, cols))
        picked_case(emit, "dense_group_aggregate", case,
                    lambda: K.dense_group_aggregate(*args),
                    lambda: K.dense_group_aggregate_plain(*args),
                    (0, 1, 3, 4), g_pad=args[3], matched=int(mask.sum()))


def run_routes(emit, table, seg, bb, raw) -> None:
    import chip_smoke as cs
    from pinot_tpu_torch.engine import QueryEngine
    from pinot_tpu_torch.ops import kernels as K
    from pinot_tpu_torch.parallel import make_mesh
    from pinot_tpu_torch.pql.optimizer import BrokerRequestOptimizer
    from pinot_tpu_torch.pql.parser import compile_pql
    from pinot_tpu_torch.query.plan import InstancePlanMaker
    from pinot_tpu_torch.tools.ssb import SSB_PQLS
    for q, pql in group_bys():
        plan, cols = cs.plan_operands(seg, pql)
        mask = K.filter_mask(seg.padded_docs, plan.filter_spec, cols,
                             plan.params, seg.num_docs)
        r, *_ = cs.k3_check(seg.padded_docs, plan, cols, mask)
        emit({"kernel": "dense_group_aggregate", "case": q, **r})
    # the stack: one launch over the 8 segments, int64 part sums
    st = QueryEngine(table.segments, mesh=make_mesh())
    stack = st.sharded.stack_for(st.segments)
    S, P = stack.n_real, stack.padded_docs
    maker = InstancePlanMaker(allow_group_compaction=False)
    for q in STACKED_QUERIES:
        request = BrokerRequestOptimizer().optimize(compile_pql(SSB_PQLS[q]))
        plan = maker.make_segment_plan(stack.plan_segment(), request)
        flat = K.flat_lanes(stack.gather(plan.needed_cols), S, P)
        mask, _m = K.filter_mask_stacked(P, S, plan.filter_spec, flat,
                                         plan.params,
                                         stack.device_num_docs())
        keys, strides, g_pad, parts, floats, ext = cs.group_operands(plan,
                                                                     flat)
        args = (mask, keys, strides, g_pad, parts, floats, ext)
        ref = K.dense_group_aggregate_plain(*args, psums_wide=True)

        def fn(route=None):
            return K.dense_group_aggregate(*args, route=route,
                                           psums_wide=True)

        routes = cs.fold_routes("dense_group_aggregate", g_pad,
                                sum(p.shape[0] for p in parts), len(floats),
                                ext, wide=True)
        picked, ms, ms_routes, ints, f_err, f_ok = cs.fold_check(
            "dense_group_aggregate", fn, ref, routes, cs.k3_equal)
        emit({"kernel": "dense_group_aggregate", "case": f"stacked {q}",
              "segments": S, "g_pad": g_pad, "matched": int(mask.sum()),
              "route": picked, "ms": ms, "ms_by_route": ms_routes,
              "ints_equal": ints, "csums_max_abs_err": f_err,
              "csums_ok": f_ok, "launch_us": cs.launch_breakdown(fn)})
        if not ints or not f_ok:
            raise AssertionError(f"stacked {q} disagrees")
    del st, stack
    for case, pql, sg in bb_cases(bb, raw):
        plan, cols = cs.plan_operands(sg, pql)
        mask = K.filter_mask(sg.padded_docs, plan.filter_spec, cols,
                             plan.params, sg.num_docs)
        r, *_ = cs.k3_check(sg.padded_docs, plan, cols, mask)
        emit({"kernel": "dense_group_aggregate", "case": case, **r})


def run(mode: str) -> list:
    import chip_smoke as cs
    lines = []

    def emit(obj):
        print(json.dumps(obj), flush=True)
        lines.append(obj)

    cs.emit = emit
    table, engine = ssb_table()
    seg = engine.segments[0]
    build_dir = os.path.join(os.path.dirname(os.path.abspath(cs.__file__)),
                             "build")
    os.makedirs(build_dir, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build_dir) as base:
        bb, raw = baseball_segments(base) if mode != "compact" else (None,
                                                                     None)
        if mode == "picked":
            run_picked(emit, seg, bb, raw)
        if mode == "routes":
            run_routes(emit, table, seg, bb, raw)
        if mode in ("routes", "compact"):
            cs.compact_kernel_check(seg, group_bys())
    return lines


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--mode", choices=MODES, default="routes")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("fold_bench: no CUDA device", file=sys.stderr)
        return 2
    lines = run(args.mode)
    if args.out:
        with open(args.out, "w") as f:
            f.writelines(json.dumps(ln) + "\n" for ln in lines)
    return 0


if __name__ == "__main__":
    sys.exit(main())
