"""Where the time of K1's wide route and K14's warp route goes, on the
SSB table.

    python3 pinot_tpu_torch/tools/ssb_kernel_bench.py [--out FILE]

On the card: the SSB lineorder table of chip_smoke.py (SF x 6,000,000
rows in SEGMENTS segments, from SEED), segment 0's operands. Each case
is timed with tools/timing.py:time_ms (L2 flushed, a 5 ms spin before
each call, as chip_smoke times K1 Q1.1) beside launch_breakdown's device
time a launch. K1 on Q1.1 (with the host's time a call: calls issued
back to back, then one synchronize) and on programs of zero, one and
three lanes (the last over four copies of the segment): the fixed cost
of a launch against its cost a row; its batched form on the Q1.1 family
of the batch phase at 8 and 2 members. K14 on Q2.1 at r = 64, with an
empty mask (the mask walk alone), without the part lanes, with one key
and at r = 8. The routes' checks and their times beside the old routes
are chip_smoke.py's. Prints one JSON line a case (and writes them to
--out); exits 2 without a card. Run it as a file from the repo root: it
imports chip_smoke.py.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

SF = 10
SEGMENTS = 8
SEED = 0
SPINS = 5            # ms of spin before each timed call
HOST_CALLS = 200     # calls issued back to back for the host's time a call


def host_us(fn) -> float:
    """Wall µs a call of fn() over HOST_CALLS calls and one synchronize:
    the host's cost a call where it exceeds the card's."""
    fn()
    torch.cuda.synchronize()
    start = time.perf_counter()
    for _ in range(HOST_CALLS):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - start) / HOST_CALLS * 1e6


def run() -> list:
    import chip_smoke as cs
    from pinot_tpu_torch.engine import QueryEngine
    from pinot_tpu_torch.ops import kernels as K
    from pinot_tpu_torch.pql.optimizer import BrokerRequestOptimizer
    from pinot_tpu_torch.pql.parser import compile_pql
    from pinot_tpu_torch.query.execution import gather_operands
    from pinot_tpu_torch.query.plan import InstancePlanMaker
    from pinot_tpu_torch.tools.datagen import make_ssb_segments
    from pinot_tpu_torch.tools.ssb import Q1_TEMPLATES, SSB_PQLS, q1_batches
    from pinot_tpu_torch.tools.timing import launch_breakdown, time_ms
    lines = []

    def case(kernel, name, fn, **extra):
        obj = {"kernel": kernel, "case": name,
               "ms": time_ms(fn, spins=SPINS),
               "launch_us": launch_breakdown(fn), **extra}
        lines.append(obj)
        print(json.dumps(obj), flush=True)

    table = make_ssb_segments(SF * cs.ROWS_PER_SF, SEGMENTS, seed=SEED)
    seg = QueryEngine(table.segments).segments[0]
    P, n = seg.padded_docs, seg.num_docs

    # K1's wide route: the fixed cost of a launch and the cost a row
    plan, cols = cs.plan_operands(seg, SSB_PQLS["q1.1"])
    args = (P, plan.filter_spec, cols, plan.params, n)
    case("filter_mask", "q1.1", lambda: K.filter_mask(*args),
         host_us=host_us(lambda: K.filter_mask(*args)))
    case("filter_mask", "match_all", lambda: K.filter_mask(
        P, ("match_all",), cols, [], n, device=seg.device))
    case("filter_mask", "one eq leaf (d_year)", lambda: K.filter_mask(
        P, ("pred", "eq_id", "d_year", "sv", None), cols, [np.int32(3)], n))
    case("filter_mask", "one range leaf (lo_discount)", lambda: K.filter_mask(
        P, ("pred", "range_ids", "lo_discount", "sv", None), cols,
        [np.int32(1), np.int32(4)], n))
    four = {k: torch.cat([cols[k]] * 4)
            for k in K.filter_lane_keys(plan.filter_spec)}
    case("filter_mask", "q1.1 over 4 copies of the segment",
         lambda: K.filter_mask(4 * P, plan.filter_spec, four, plan.params,
                               4 * n))
    spec, fcols, params = cs._family_operands(
        seg, [Q1_TEMPLATES["q1.1"].format(**lits)
              for lits in q1_batches()["q1.1"]])
    for B in (8, 2):
        case("filter_mask_batched", f"q1.1 family, {B} members",
             lambda: K.filter_mask_batched(P, spec, fcols, params[:B], n))

    # K14's warp route on Q2.1's operands, part by part
    plan = InstancePlanMaker().make_segment_plan(
        seg, BrokerRequestOptimizer().optimize(compile_pql(SSB_PQLS["q2.1"])))
    cols = gather_operands(plan)
    spec, extra = cs.final_group_dispatch(seg, plan, cols)
    gcols, strides, g_pad, gaggs, _kmax = spec
    mask = K.filter_mask(P, plan.filter_spec, cols, plan.params, n)
    keys = [K.spec_group_key(g, cols, list(plan.group_params) + list(extra),
                             seg.device) for g in gcols]
    parts = K._group_lanes(gaggs, cols).parts
    zero = torch.zeros_like(mask)
    case("block_compact", "q2.1 r 64", lambda: K.block_compact(
        mask, keys, strides, g_pad, 64, parts))
    case("block_compact", "q2.1 empty mask", lambda: K.block_compact(
        zero, keys, strides, g_pad, 64, parts))
    case("block_compact", "q2.1 without parts", lambda: K.block_compact(
        mask, keys, strides, g_pad, 64))
    case("block_compact", "q2.1 one key, without parts",
         lambda: K.block_compact(mask, keys[:1], strides[:1], g_pad, 64))
    case("block_compact", "q2.1 r 8", lambda: K.block_compact(
        mask, keys, strides, g_pad, 8, parts))
    return lines


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("ssb_kernel_bench: no CUDA device", file=sys.stderr)
        return 2
    lines = run()
    if args.out:
        with open(args.out, "w") as f:
            f.writelines(json.dumps(ln) + "\n" for ln in lines)
    return 0


if __name__ == "__main__":
    sys.exit(main())
