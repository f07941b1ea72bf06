#!/usr/bin/env python3
"""Drive pinot_tpu_torch on one CUDA card: build, kernel check, SSB Q1.1-Q4.3.

    python3 chip_smoke.py [--sf 10] [--segments 8] [--repeats 5] [--seed 0]

Phases, each printed as one JSON line; any failure ends the run with a
non-zero exit and no result line:

1. device: the card's name, and its name and power limit from nvidia-smi.
2. build: nvcc builds the kernels from ops/csrc/ (one process per source,
   all at once) into build/pinot_tpu_torch/<hash>/.
3. data: the SSB lineorder table at scale factor --sf (6,000,000 rows per
   scale factor) in --segments segments, made from --seed.
4. kernel check: every kernel against its plain PyTorch version on the
   card, on the lanes and parameters the SSB plans give it on segment 0
   (integer outputs equal, float64 sums within CSUMS_RTOL), timed with
   CUDA events and an L2 flush before each launch, beside its bound.
5. ssb: launch counts set to 0, the 13 queries run once through
   QueryEngine on the card and are checked against the numpy oracle, the
   counts read (every kernel must have launched); then --repeats timed
   runs per query give the p50.

The last two lines are the kernels JSON line and
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Imports torch, numpy and pinot_tpu_torch only.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12       # H100 SXM device memory rate
SCALAR_OPS_PER_S = 67e12        # H100 SXM float32 outside the tensor cores
CSUMS_RTOL = 1e-9               # f64 atomics add in a run-dependent order
ROWS_PER_SF = 6_000_000
L2_FLUSH_BYTES = 128 << 20      # > the 50 MB L2: each timed launch is cold
SPIN_CYCLES = 2_000_000         # ~1 ms at H100 clocks


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def time_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Mean device time of fn() over reps calls, L2 flushed before each.

    A spin of about a millisecond on the card precedes each call, so the
    host enqueues the call while the card is still busy and the events
    bracket the device work, not the wrapper's Python. A call that waits
    for the card itself (the plain versions' boolean indexing) still
    counts its host time."""
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    total = 0.0
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(SPIN_CYCLES)
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
    gcols, strides, g_pad, gaggs, _ = plan.group_spec
    keys = [cols[f"{c}.ids"] for c, *_ in gcols]
    parts = [cols[f"{s[1]}.parts"] for s in gaggs if s[3] and
             s[3][0] == "psums"]
    floats = [cols[f"{s[1]}.raw"].double() for s in gaggs if s[3] and
              s[3][0] == "csums"]
    return keys, strides, g_pad, parts, floats


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

    # K3 on Q2.1 (g_pad 8192) and Q4.3 (g_pad 2^21, one csums lane)
    for q in ("q2.1", "q4.3"):
        plan, cols = plan_operands(seg, pqls[q])
        mask = K.filter_mask(P, plan.filter_spec, cols, plan.params, n)
        matched = int(mask.sum())
        keys, strides, g_pad, parts, floats = group_operands(plan, cols)
        got = K.dense_group_aggregate(mask, keys, strides, g_pad, parts,
                                      floats)
        ref = K.dense_group_aggregate_plain(mask, keys, strides, g_pad,
                                            parts, floats)
        int_err = max(int((a.long() - b.long()).abs().max()) if a.numel()
                      else 0 for a, b in ((got[0], ref[0]),
                                          (got[1], ref[1]),
                                          (got[3], ref[3])))
        f_err, f_ok = 0.0, True
        if floats:
            diff = (got[2] - ref[2]).abs()
            f_err = float(diff.max())
            f_ok = bool((diff <= CSUMS_RTOL *
                         ref[2].abs().clamp_min(1.0)).all())
        report.append({"kernel": "dense_group_aggregate", "case": q,
                       "g_pad": g_pad, "matched": matched,
                       "max_abs_err_int": int_err,
                       "max_abs_err_csums": f_err,
                       "csums_rtol": CSUMS_RTOL if floats else None})
        if int_err != 0 or not f_ok:
            raise AssertionError(f"dense_group_aggregate disagrees on {q}: "
                                 f"int {int_err}, csums {f_err}")
        row_bytes = sum(k.element_size() for k in keys) + \
            sum(p.shape[0] for p in parts) + 8 * len(floats)
        n_l = sum(p.shape[0] for p in parts)
        table = g_pad * (4 + 4 * n_l + 8 * len(floats))
        ms = time_ms(lambda: K.dense_group_aggregate(
            mask, keys, strides, g_pad, parts, floats))
        plain = time_ms(lambda: K.dense_group_aggregate_plain(
            mask, keys, strides, g_pad, parts, floats))
        b = bound(P + matched * row_bytes + table,
                  matched * (2 * len(keys) + 1 + n_l + len(floats)))
        report[-1].update(ms=ms, plain_ms=plain, bound_ms=b[0],
                          bound_by=b[1])
        if q == "q4.3":
            entries["dense_group_aggregate"] = dict(
                max_abs_err=max(int_err, f_err), ms=ms, plain_ms=plain,
                bound=b, library_ms=None)
    for r in report:
        emit({"phase": "kernel_check", **r})
    if k1_err or k2_err:
        raise AssertionError(f"filter_mask err {k1_err}, masked_part_sums "
                             f"err {k2_err}")
    return entries


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--sf", type=int, default=10)
    ap.add_argument("--segments", type=int, default=8)
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1

    from pinot_tpu_torch.engine import QueryEngine
    from pinot_tpu_torch.ops import build
    from pinot_tpu_torch.ops import kernels as K
    from pinot_tpu_torch.tools.datagen import make_ssb_segments
    from pinot_tpu_torch.tools.ssb import (SSB_PQLS, canon_response, check,
                                           make_cpu_queries)

    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    emit({"phase": "device", "kind": kind, "count": torch.cuda.device_count(),
          "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda})

    t0 = time.perf_counter()
    libs = build.build_all()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "dir": str(build.build_dir()),
          "libs": {s: str(p) for s, p in libs.items()},
          "ptxas": build.BUILD_INFO.get("ptxas", {})})

    rows = args.sf * ROWS_PER_SF
    t0 = time.perf_counter()
    table = make_ssb_segments(rows, args.segments, seed=args.seed)
    engine = QueryEngine(table.segments)                  # on the card
    oracle = make_cpu_queries(table.pools, table.ids, table.supplycost)
    emit({"phase": "data", "scale_factor": args.sf, "rows": rows,
          "segments": args.segments,
          "padded_rows_per_segment": table.segments[0].padded_docs,
          "seconds": time.perf_counter() - t0})

    entries = kernel_check(engine.segments[0], SSB_PQLS)

    # the main path: every count from 0, one run of the 13 queries
    K.reset_launch_counts()
    results = {}
    for q, pql in SSB_PQLS.items():
        t = time.perf_counter()
        resp = engine.query(pql)
        torch.cuda.synchronize()
        results[q] = (resp, (time.perf_counter() - t) * 1e3)
    launches = K.launch_counts()
    for q, (resp, first_ms) in results.items():
        if resp.exceptions:
            raise AssertionError(f"{q}: {resp.exceptions}")
        check(q, canon_response(q, resp), oracle[q]())
    if not all(launches.values()):
        raise AssertionError(f"a kernel never launched on the main path: "
                             f"{launches}")
    device_bytes = sum(s.device_bytes() for s in engine.segments)
    for q, pql in SSB_PQLS.items():
        ts = []
        for _ in range(args.repeats):
            t = time.perf_counter()
            engine.query(pql)
            torch.cuda.synchronize()
            ts.append((time.perf_counter() - t) * 1e3)
        emit({"phase": "ssb", "query": q, "check": "pass",
              "first_ms": results[q][1], "p50_ms": float(np.median(ts)),
              "samples_ms": ts})
    emit({"phase": "ssb_summary", "scale_factor": args.sf, "rows": rows,
          "queries_passed": len(results), "device_table_bytes": device_bytes,
          "peak_device_bytes": torch.cuda.max_memory_allocated(),
          "launches": launches})

    print(smi, flush=True)
    line = []
    for name, info in K.KERNELS.items():
        e = entries[name]
        line.append({"name": name, "route": "cuda", "source": info.source,
                     "replaces": info.replaces, "launches": launches[name],
                     "max_abs_err": e["max_abs_err"], "ms": e["ms"],
                     "plain_ms": e["plain_ms"], "bound_ms": e["bound"][0],
                     "bound_by": e["bound"][1],
                     "library_ms": e["library_ms"]})
    emit({"kernels": line})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
