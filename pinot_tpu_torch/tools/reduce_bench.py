"""K2 masked_part_sums, K4 masked_histogram and K5 masked_reduce on the
SSB and baseballStats tables, as the main path calls them.

    python3 pinot_tpu_torch/tools/reduce_bench.py [--out FILE]

On the card: chip_smoke.py's SSB lineorder table (SF x 6,000,000 rows in
SEGMENTS segments, from SEED) and its baseballStats segment 0 (built
under build/). The cases are chip_smoke's K2 and K5 cases: K2 on Q1.1
(one segment, the 8-segment stack, the Q1.1 family's 8 members) and on
runs + hits; K5 on salary with block sums, runs ids and position's MV
entries (one segment and the dictId family's 8 members) and on
lo_supplycost under Q4.3's mask over the stack; K4 on teamID,
playerName, an int16 lane of 10,000 ids and an int32 one of 100,000
(chip_smoke.wide_id_lane's draws) and position's MV entries (one
segment, and teamID and position at the dictId family's 8 members), on
c_city under Q4.3's mask over the stack, and DISTINCTCOUNTHLL(playerName) through kernels._agg_outputs
(the fused K4 in a tree that has it, K4 then K7 in one that does not;
both trees add the match count's K2 launch). Each call is the one the
main path makes (no route argument), its outputs held to the plain
version's (integers, min / max and count equal, block sums within
chip_smoke.CSUMS_RTOL), timed as the median of fold_bench.PICKED_REPS
launches (tools/fold_bench.py:median_ms: the L2 flushed dirty, a 1 ms
spin before each; K4's cases also with the L2 flushed by reading it,
`ms_clean_median`), with launch_breakdown. A batched case also times
its members' 8 single launches. The tool uses only calls that the
kernels before their redesign also took, so the same file, copied into
an unpacked older commit and run from there, times that commit's
kernels on the same data in the same chip call.

Prints one JSON line a case (and writes them to --out); exits 2 without
a card. Run it as a file from the repo root: it imports chip_smoke.py.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import tempfile

import numpy as np

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

SF = 10
SEGMENTS = 8
SEED = 0
BB_ROWS, BB_SEGMENTS = 10_000_000, 4      # chip_smoke.py's defaults


def same(got, ref) -> bool:
    """K2's sums, K4's counts or K5's outputs against the plain
    version's."""
    import chip_smoke as cs
    if isinstance(ref, (tuple, list)):
        return all(same(g, r) for g, r in zip(got, ref))
    if not isinstance(ref, dict):
        return torch.equal(got, ref)
    ok = all(got[k].dtype == ref[k].dtype and torch.equal(got[k], ref[k])
             for k in ("min", "max", "count"))
    if "sums" in ref:
        ok = ok and bool(((got["sums"] - ref["sums"]).abs() <= cs.CSUMS_RTOL
                          * ref["sums"].abs().clamp_min(1.0)).all())
    return ok


def median_clean_ms(fn, reps: int = 21) -> float:
    """median_ms with the L2 flushed by reading it (a sum), so the timed
    call evicts clean lines and pays no write-backs."""
    flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
    fn()
    samples = []
    for _ in range(reps):
        flush.sum(dtype=torch.int64)
        torch.cuda._sleep(2_000_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end))
    return statistics.median(samples)


def case(emit, kernel, name, fn, plain, singles=None, clean=False,
         **info) -> None:
    """One reading: fn() against plain(), its median and breakdown, the
    median of singles() (a batch's members launched one by one) and,
    with `clean`, the median under a clean flush; the launches of every
    kernel one call makes."""
    from pinot_tpu_torch.ops import kernels as K
    from pinot_tpu_torch.tools.fold_bench import median_ms
    from pinot_tpu_torch.tools.timing import launch_breakdown
    ref = plain()
    K.reset_launch_counts()
    ok = all(same(fn(), ref) for _ in range(3))
    torch.cuda.synchronize()
    counts = {k: v for k, v in K.launch_counts().items() if v}
    line = {"kernel": kernel, "case": name, **info, "launches": counts,
            "equal": ok, "ms_median": median_ms(fn),
            "launch_us": launch_breakdown(fn)}
    if clean:
        line["ms_clean_median"] = median_clean_ms(fn)
    if singles is not None:
        line["singles_ms_median"] = median_ms(singles)
    emit(line)
    if not ok:
        raise AssertionError(f"{kernel} {name} disagrees")


def ssb_cases(emit) -> None:
    import chip_smoke as cs
    from pinot_tpu_torch.engine import QueryEngine
    from pinot_tpu_torch.ops import kernels as K
    from pinot_tpu_torch.parallel import make_mesh
    from pinot_tpu_torch.pql.optimizer import BrokerRequestOptimizer
    from pinot_tpu_torch.pql.parser import compile_pql
    from pinot_tpu_torch.query.plan import InstancePlanMaker
    from pinot_tpu_torch.tools.datagen import make_ssb_segments
    from pinot_tpu_torch.tools.ssb import Q1_TEMPLATES, SSB_PQLS, q1_batches
    table = make_ssb_segments(SF * cs.ROWS_PER_SF, SEGMENTS, seed=SEED)
    seg = QueryEngine(table.segments).segments[0]
    P, n = seg.padded_docs, seg.num_docs

    plan, cols = cs.plan_operands(seg, SSB_PQLS["q1.1"])
    mask = K.filter_mask(P, plan.filter_spec, cols, plan.params, n)
    parts = [cols["lo_revenue.parts"]]
    case(emit, "masked_part_sums", "q1.1",
         lambda: K.masked_part_sums(mask, parts),
         lambda: K.masked_part_sums_plain(mask, parts),
         rows=P, matched=int(mask.sum()), part_lanes=parts[0].shape[0])

    pqls = [Q1_TEMPLATES["q1.1"].format(**lits)
            for lits in q1_batches()["q1.1"]]
    spec, fcols, params = cs._family_operands(seg, pqls)
    masks = K.filter_mask_batched(P, spec, fcols, params, n)[0]
    case(emit, "masked_part_sums", "q1.1 family, 8 members",
         lambda: K.masked_part_sums_batched(masks, parts),
         lambda: K.masked_part_sums_batched_plain(masks, parts),
         singles=lambda: [K.masked_part_sums(m, parts) for m in masks],
         rows=P, members=masks.shape[0], matched=int(masks.sum()),
         union=int(masks.any(0).sum()))

    st = QueryEngine(table.segments, mesh=make_mesh())
    stack = st.sharded.stack_for(st.segments)
    S = stack.n_real
    maker = InstancePlanMaker(allow_group_compaction=False)
    for q, key in (("q1.1", "lo_revenue.parts"), ("q4.3", "lo_supplycost.raw")):
        request = BrokerRequestOptimizer().optimize(compile_pql(SSB_PQLS[q]))
        splan = maker.make_segment_plan(stack.plan_segment(), request)
        flat = K.flat_lanes(stack.gather(splan.needed_cols), S, P)
        smask, _m = K.filter_mask_stacked(P, S, splan.filter_spec, flat,
                                          splan.params,
                                          stack.device_num_docs())
        if q == "q1.1":
            sparts = [flat[key]]
            case(emit, "masked_part_sums", f"stacked q1.1, S = {S}",
                 lambda: K.masked_part_sums(smask, sparts, seg_rows=P),
                 lambda: K.masked_part_sums_plain(smask, sparts, P),
                 rows=S * P, matched=int(smask.sum()))
        else:
            lane = flat[key]
            case(emit, "masked_reduce",
                 f"stacked lo_supplycost, q4.3 mask, S = {S}",
                 lambda: K.masked_reduce(smask, lane, "raw", 0, True),
                 lambda: K.masked_reduce_plain(smask, lane, "raw", 0, True),
                 rows=S * P, matched=int(smask.sum()))
            ids = K.flat_lanes({"c_city.ids": stack.lane("c_city", "ids")},
                               S, P)["c_city.ids"]
            cp = K.pow2_bucket(stack.segments[0].data_source(
                "c_city").metadata.cardinality + 1)
            case(emit, "masked_histogram",
                 f"stacked c_city, q4.3 mask, S = {S}",
                 lambda: K.masked_histogram(smask, ids, cp),
                 lambda: K.masked_histogram_plain(smask, ids, cp),
                 clean=True, rows=S * P, matched=int(smask.sum()),
                 card_pad=cp)


def baseball_cases(emit, base) -> None:
    import chip_smoke as cs
    from pinot_tpu_torch.engine import QueryEngine
    from pinot_tpu_torch.ops import kernels as K
    from pinot_tpu_torch.tools import baseball
    dirs, _c = baseball.build_segment_dirs(base, BB_ROWS // BB_SEGMENTS, 1,
                                           seed=SEED)
    seg = QueryEngine.from_dirs(dirs).segments[0]
    P, n = seg.padded_docs, seg.num_docs
    plan, cols = cs.plan_operands(seg, cs.BB_AGG_PQL)
    mask = K.filter_mask(P, plan.filter_spec, cols, plan.params, n)
    parts = [cols["runs.parts"], cols["hits.parts"]]
    case(emit, "masked_part_sums", "baseball runs, hits",
         lambda: K.masked_part_sums(mask, parts),
         lambda: K.masked_part_sums_plain(mask, parts),
         rows=P, matched=int(mask.sum()),
         part_lanes=sum(p.shape[0] for p in parts))
    spec, fcols, params = cs._family_operands(
        seg, cs.BB_BATCH_FILTERS["dictId"])
    masks = K.filter_mask_batched(P, spec, fcols, params, n)[0]
    case(emit, "masked_part_sums", "baseball runs, hits, 8 members",
         lambda: K.masked_part_sums_batched(masks, parts),
         lambda: K.masked_part_sums_batched_plain(masks, parts),
         singles=lambda: [K.masked_part_sums(m, parts) for m in masks],
         rows=P, members=masks.shape[0], union=int(masks.any(0).sum()))
    histogram_cases(emit, seg, mask, masks)
    runs = seg.data_source("runs")
    pos, pcard = cs.mv_lanes(seg)["position"]
    for name, lane, kind, cp, want_sum, card in (
            ("salary", seg.data_source("salary").device_raw_values(), "raw",
             0, True, None),
            ("runs ids", runs.device_dict_ids(), "ids",
             K.pow2_bucket(runs.metadata.cardinality + 1), False, None),
            ("MV position", pos, "ids", K.pow2_bucket(pcard + 1), False,
             pcard)):
        args = (kind, cp, want_sum, card)
        case(emit, "masked_reduce", f"baseball {name}",
             lambda: K.masked_reduce(mask, lane, *args),
             lambda: K.masked_reduce_plain(mask, lane, *args),
             rows=P, matched=int(mask.sum()), dtype=str(lane.dtype),
             width=lane.numel() // P)
        case(emit, "masked_reduce", f"baseball {name}, 8 members",
             lambda: K.masked_reduce_batched(masks, lane, *args),
             lambda: K.masked_reduce_batched_plain(masks, lane, *args),
             singles=lambda: [K.masked_reduce(m, lane, *args)
                              for m in masks],
             rows=P, members=masks.shape[0], union=int(masks.any(0).sum()))


def histogram_cases(emit, seg, mask, masks) -> None:
    """K4 on baseballStats segment 0 under BB_AGG_PQL's mask and the
    dictId family's 8 masks, and DISTINCTCOUNTHLL through _agg_outputs."""
    import chip_smoke as cs
    from pinot_tpu_torch.common.sketches import DEFAULT_LOG2M
    from pinot_tpu_torch.ops import kernels as K
    P = seg.padded_docs
    lanes = {c: (seg.data_source(c).device_dict_ids(), K.pow2_bucket(
        seg.data_source(c).metadata.cardinality + 1))
        for c in ("teamID", "playerName")}
    for card, dt in ((10_000, np.int16), (100_000, np.int32)):
        rng = np.random.default_rng(11)             # chip_smoke.wide_id_lane
        wide = np.zeros(P, dt)
        wide[:seg.num_docs] = rng.integers(0, card, seg.num_docs)
        lanes[f"{np.dtype(dt).name} x {card:,} ids"] = (
            torch.from_numpy(wide).to(mask.device), K.pow2_bucket(card + 1))
    for name, (ids, cp) in lanes.items():
        case(emit, "masked_histogram", f"baseball {name}",
             lambda: K.masked_histogram(mask, ids, cp),
             lambda: K.masked_histogram_plain(mask, ids, cp), clean=True,
             rows=P, matched=int(mask.sum()), card_pad=cp,
             dtype=str(ids.dtype))
    pos, pcard = cs.mv_lanes(seg)["position"]
    ppad = K.pow2_bucket(pcard + 1)
    case(emit, "masked_histogram", "baseball MV position",
         lambda: K.masked_entry_histogram(mask, pos, ppad, pcard),
         lambda: K.masked_entry_histogram_plain(mask, pos, ppad, pcard),
         clean=True, rows=P, matched=int(mask.sum()), width=pos.shape[1])
    ids, cp = lanes["teamID"]
    case(emit, "masked_histogram", "baseball teamID, 8 members",
         lambda: K.masked_histogram_batched(masks, ids, cp),
         lambda: K.masked_histogram_batched_plain(masks, ids, cp),
         singles=lambda: [K.masked_histogram(m, ids, cp) for m in masks],
         clean=True, rows=P, members=masks.shape[0],
         union=int(masks.any(0).sum()))
    case(emit, "masked_histogram", "baseball MV position, 8 members",
         lambda: K.masked_entry_histogram_batched(masks, pos, ppad, pcard),
         lambda: K.masked_entry_histogram_batched_plain(masks, pos, ppad,
                                                        pcard),
         singles=lambda: [K.masked_entry_histogram(m, pos, ppad, pcard)
                          for m in masks],
         clean=True, rows=P, members=masks.shape[0])
    m = 1 << DEFAULT_LOG2M
    pn = seg.data_source("playerName")
    ids, cp = lanes["playerName"]
    cols = {"playerName.ids": ids, "playerName.hllidx": pn.device_hll_idx(),
            "playerName.hllrank": pn.device_hll_rank()}
    specs = (("hll", "playerName", "sv", ("hll", cp, m)),)
    want = K.hll_registers_plain(K.masked_histogram_plain(mask, ids, cp),
                                 cols["playerName.hllidx"],
                                 cols["playerName.hllrank"], m)
    case(emit, "masked_histogram", "DISTINCTCOUNTHLL(playerName), "
         "_agg_outputs",
         lambda: K._agg_outputs(mask, specs, cols)["agg0.hll"],
         lambda: want, clean=True, rows=P, matched=int(mask.sum()),
         registers=m)


def run() -> list:
    import chip_smoke as cs
    lines = []

    def emit(obj):
        print(json.dumps(obj), flush=True)
        lines.append(obj)

    emit({"card": cs.nvidia_smi_line(),
          "root": os.path.dirname(os.path.abspath(cs.__file__))})
    build_dir = os.path.join(os.path.dirname(os.path.abspath(cs.__file__)),
                             "build")
    os.makedirs(build_dir, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build_dir) as base:
        baseball_cases(emit, base)
    ssb_cases(emit)
    return lines


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("reduce_bench: no CUDA device", file=sys.stderr)
        return 2
    lines = run()
    if args.out:
        with open(args.out, "w") as f:
            f.writelines(json.dumps(ln) + "\n" for ln in lines)
    return 0


if __name__ == "__main__":
    sys.exit(main())
