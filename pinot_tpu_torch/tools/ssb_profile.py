"""Where a query's time goes on the card.

    python -m pinot_tpu_torch.tools.ssb_profile [--sf 10] [--segments 8]
        [--repeats 5] [--seed 0] [--out FILE] [--mesh]
        [--table baseball --bb-rows 10000000 --bb-segments 4]

Builds the SSB table at scale factor --sf on the card (or, with --table
baseball, writes the baseballStats table to segment directories under
build/ and loads them with QueryEngine.from_dirs), runs each query once
to upload the lanes (the 13 SSB queries, or every draw of the
QueryGenerator mix: aggregations, group-bys, HAVING, selections,
two-key ORDER BYs and MV group-bys, the fixed queries and selections,
one query per device shape, the draws that the host twin answers, family
"host", the raw-key table's group-bys, family "raw_group_by", and the MV
metric table's queries, family "mv_metric"), then
--repeats times with each layer timed (pruner, planner, kernel dispatch,
device→host pull, finish, host twin, combine and reduce) and once more
under torch.profiler for the card's busy time. With --mesh the engines
take parallel.make_mesh(): a multi-segment query runs stacked, one
launch per kernel over every segment (layers stack, plan, dispatch,
select_groups, pull, finish, reduce; the sequential layers where a
query falls back, its route in `route`). Prints one JSON line per
query, and writes them all to --out if given:

- wall_ms: the query's median host wall time, ending in a synchronize;
- layers_ms: median host time per layer per query (all segments);
- device_busy_ms: the sum of the card's kernel and copy time in the
  profiled run, and device_idle_share = 1 - busy / that run's wall time;
- kernels: device time per kernel name in the profiled run.

Needs a CUDA card; it does not fall back to the CPU.
"""
from __future__ import annotations

import argparse
import collections
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch


class LayerTimer:
    """Accumulates host wall time of wrapped functions by layer name."""

    def __init__(self):
        self.ms = collections.defaultdict(float)
        self._undo = []

    def wrap(self, owner, attr: str, layer: str) -> None:
        orig = getattr(owner, attr)

        def timed(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return orig(*args, **kwargs)
            finally:
                self.ms[layer] += (time.perf_counter() - t0) * 1e3

        setattr(owner, attr, timed)
        self._undo.append((owner, attr, orig))

    def restore(self) -> None:
        for owner, attr, orig in reversed(self._undo):
            setattr(owner, attr, orig)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--sf", type=int, default=10)
    ap.add_argument("--segments", type=int, default=8)
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None)
    ap.add_argument("--table", choices=("ssb", "baseball"), default="ssb")
    ap.add_argument("--bb-rows", type=int, default=10_000_000)
    ap.add_argument("--bb-segments", type=int, default=4)
    ap.add_argument("--mesh", action="store_true",
                    help="stack the segments (QueryEngine mesh=make_mesh())")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("ssb_profile: no CUDA device", file=sys.stderr)
        return 1
    if args.table == "ssb":
        rows = profile(args, *_ssb_engine(args))
    else:
        scratch = os.path.join(os.path.dirname(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__)))), "build")
        os.makedirs(scratch, exist_ok=True)
        with tempfile.TemporaryDirectory(dir=scratch) as base:
            rows = profile(args, *_baseball_engine(args, base))
            rows += profile(args, *_raw_key_engine(args, base))
            rows += profile(args, *_mv_metric_engine(args, base))
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
    return 0


def _mesh(args):
    from pinot_tpu_torch.parallel import make_mesh
    return make_mesh() if args.mesh else None


def _ssb_engine(args):
    from pinot_tpu_torch.engine import QueryEngine
    from pinot_tpu_torch.tools.datagen import make_ssb_segments
    from pinot_tpu_torch.tools.ssb import SSB_PQLS
    table = make_ssb_segments(args.sf * 6_000_000, args.segments,
                              seed=args.seed)
    return QueryEngine(table.segments, mesh=_mesh(args)), dict(SSB_PQLS), \
        {"scale_factor": args.sf, "mesh": args.mesh}


def _baseball_engine(args, base):
    """baseballStats from disk; the queries are the mix's draws, named by
    family ("host" for those the host twin answers) and position."""
    from pinot_tpu_torch.engine import QueryEngine
    from pinot_tpu_torch.tools import baseball
    dirs, cols = baseball.build_segment_dirs(base, args.bb_rows,
                                             args.bb_segments, args.seed)
    pqls = {f"{'host' if draw.host_answered else family}{i}": draw.pql
            for i, (family, draw) in
            enumerate(baseball.all_draws(baseball.Oracle(cols)))}
    return QueryEngine.from_dirs(dirs, mesh=_mesh(args)), pqls, \
        {"table": "baseballStats", "rows": args.bb_rows,
         "segments": args.bb_segments, "mesh": args.mesh}


def _raw_key_engine(args, base):
    """The raw-key table (runs, hits, salary without a dictionary) and its
    group-bys, family "raw_group_by"."""
    from pinot_tpu_torch.engine import QueryEngine
    from pinot_tpu_torch.tools import baseball
    d, _cols = baseball.build_raw_key_dir(base, baseball.RAW_KEY_ROWS,
                                          args.seed + args.bb_segments)
    pqls = {f"raw_group_by{i}": pql
            for i, pql in enumerate(baseball.RAW_KEY_PQLS.values())}
    return QueryEngine.from_dirs([d]), pqls, \
        {"table": "baseballStats (raw keys)", "rows": baseball.RAW_KEY_ROWS,
         "segments": 1}


def _mv_metric_engine(args, base):
    """The MV metric table (a multi-value INT column) and its queries,
    family "mv_metric"."""
    from pinot_tpu_torch.engine import QueryEngine
    from pinot_tpu_torch.tools import baseball
    d, _cols = baseball.build_mv_metric_dir(
        base, baseball.MV_METRIC_ROWS, args.seed + args.bb_segments + 1)
    pqls = {f"mv_metric{i}": pql
            for i, pql in enumerate(baseball.MV_METRIC_PQLS.values())}
    return QueryEngine.from_dirs([d]), pqls, \
        {"table": "mv", "rows": baseball.MV_METRIC_ROWS, "segments": 1}


def profile(args, engine, pqls, tag) -> list:
    from pinot_tpu_torch.parallel import sharded
    from pinot_tpu_torch.query import execution, host_exec, plan
    from pinot_tpu_torch.query import executor as executor_mod
    from pinot_tpu_torch.query.reduce import BrokerReduceService
    for pql in pqls.values():
        engine.query(pql)                    # lanes uploaded once
    torch.cuda.synchronize()

    timer = LayerTimer()
    timer.wrap(executor_mod.SegmentPrunerService, "prune", "prune")
    timer.wrap(plan.InstancePlanMaker, "make_segment_plan", "plan")
    timer.wrap(execution.kernels, "run_segment_kernel", "dispatch")
    timer.wrap(execution.kernels, "run_stacked_kernel", "dispatch")
    timer.wrap(sharded.ShardedQueryExecutor, "stack_for", "stack")
    timer.wrap(sharded.StackedSegments, "gather", "stack")
    timer.wrap(execution, "_nonempty_groups", "select_groups")
    timer.wrap(execution, "pull", "pull")
    timer.wrap(execution, "_finish_aggregation", "finish")
    timer.wrap(execution, "_finish_group_by", "finish")
    timer.wrap(execution, "_finish_selection", "finish")
    timer.wrap(host_exec, "execute_host", "host")
    timer.wrap(executor_mod, "combine_blocks", "combine")
    timer.wrap(BrokerReduceService, "reduce", "reduce")
    device = torch.cuda.get_device_name(0)
    rows = []
    try:
        for q, pql in pqls.items():
            walls, layers = [], collections.defaultdict(list)
            for _ in range(args.repeats):
                timer.ms.clear()
                t0 = time.perf_counter()
                engine.query(pql)
                torch.cuda.synchronize()
                walls.append((time.perf_counter() - t0) * 1e3)
                for k, v in timer.ms.items():
                    layers[k].append(v)
            acts = [torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA]
            with torch.profiler.profile(activities=acts) as prof:
                t0 = time.perf_counter()
                engine.query(pql)
                torch.cuda.synchronize()
                prof_wall = (time.perf_counter() - t0) * 1e3
            per_kernel = collections.defaultdict(float)
            for ev in prof.key_averages():
                # kernels and copies only: a CPU op's device time repeats
                # the time of the kernels it launched
                if not str(ev.device_type).endswith("CUDA"):
                    continue
                dev_us = getattr(ev, "self_device_time_total", None)
                if dev_us is None:
                    dev_us = getattr(ev, "self_cuda_time_total", 0)
                if dev_us:
                    per_kernel[ev.key] += dev_us / 1e3
            busy = sum(per_kernel.values())
            row = {"query": q, "device": device, **tag,
                   "route": engine.last_route[0],
                   "wall_ms": float(np.median(walls)),
                   "layers_ms": {k: float(np.median(v))
                                 for k, v in layers.items()},
                   "profiled_wall_ms": prof_wall,
                   "device_busy_ms": busy if busy else None,
                   "device_idle_share": (1 - busy / prof_wall) if busy
                   else None,
                   "kernels": dict(sorted(per_kernel.items(),
                                          key=lambda kv: -kv[1])[:8])}
            rows.append(row)
            print(json.dumps(row), flush=True)
    finally:
        timer.restore()
    return rows


if __name__ == "__main__":
    sys.exit(main())
