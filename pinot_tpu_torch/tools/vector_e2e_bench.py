"""Runs chip_smoke.py's vector phases alone, for one checkout.

    python3 pinot_tpu_torch/tools/vector_e2e_bench.py [--root DIR]

Imports `chip_smoke` and the package `pinot_tpu_torch` from DIR (this
checkout by default), so that two versions run in turn in one call:
parent, change, change, parent. Run it as a file. On the card, at
chip_smoke.py's default sizes, each step through chip_smoke's own
function: the kernels' build (its seconds count a fresh build only where
DIR has built nothing yet), the 10M x 128 vector table in 4 segments
(phase vec_data), phase vector (per segment and stacked, exact and
probed, answers held to the oracle, p50 per rung) and the vecbench
families of phase batch (each member held to its own query and the
oracle, p50 beside the sequential sum). Prints chip_smoke's JSON lines,
the card's name and power limit first; a failed check raises, and the
exit code is 2 without a card.
"""
from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time

import torch

#: chip_smoke.py's defaults for the vector table and its phases
SIZES = dict(vec_rows=10_000_000, vec_segments=4, vec_dim=128,
             vec_queries=5, repeats=5, batch_repeats=3, seed=0)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", help="checkout whose chip_smoke.py and "
                    "pinot_tpu_torch to run")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("vector_e2e_bench needs a CUDA card", file=sys.stderr)
        return 2
    root = os.path.abspath(args.root or os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "..", ".."))
    sys.path.insert(0, root)
    import chip_smoke as cs
    import pinot_tpu_torch
    if not os.path.abspath(pinot_tpu_torch.__file__).startswith(root):
        print(f"vector_e2e_bench: pinot_tpu_torch came from "
              f"{pinot_tpu_torch.__file__}, not {root}", file=sys.stderr)
        return 2
    from pinot_tpu_torch.engine import QueryEngine
    from pinot_tpu_torch.ops import build
    from pinot_tpu_torch.ops import kernels as K
    from pinot_tpu_torch.parallel import make_mesh

    opts = argparse.Namespace(**SIZES)
    cs.emit({"phase": "device", "root": root,
             "nvidia_smi": cs.nvidia_smi_line()})
    t0 = time.perf_counter()
    build.build_all()
    cs.emit({"phase": "build", "seconds": time.perf_counter() - t0,
             "built": build.BUILD_INFO.get("built", [])})
    seconds = {}
    scratch = os.path.join(root, "build")
    os.makedirs(scratch, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=scratch) as base:
        t0 = time.perf_counter()
        engine, draws, _ = cs.vec_data(base, opts)
        seconds["vec_data"] = time.perf_counter() - t0
        st_engine = QueryEngine(engine.segments, mesh=make_mesh())
        queries = draws.queries(opts.vec_queries)
        t0 = time.perf_counter()
        _, oracle, exact = cs.run_vector(engine, st_engine, queries,
                                         opts, opts.repeats)
        seconds["vector"] = time.perf_counter() - t0
        batch_queries = queries + draws.queries(
            max(0, K.MAX_BATCH - len(queries)))
        t0 = time.perf_counter()
        families, check = cs.vec_batch_families(
            engine, batch_queries, oracle, exact,
            sum(s.num_docs for s in engine.segments))
        cs.run_batch("vecbench", engine, families, check,
                     opts.batch_repeats)
        seconds["vector_batch"] = time.perf_counter() - t0
    cs.emit({"phase": "timing", "seconds": seconds})
    return 0


if __name__ == "__main__":
    sys.exit(main())
