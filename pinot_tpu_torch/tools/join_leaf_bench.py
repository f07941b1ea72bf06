"""Times K1's batched join_raw leaf at the raw-key table's size.

    python3 -m pinot_tpu_torch.tools.join_leaf_bench [--out FILE]

On the card: a random int32 key lane of 7,503,872 rows (one raw-key
segment of the join table) and 8 members, each with its own sorted dim
keys, for a few (Dp, key span) cases: a span of 2,000,000 keys (the
batch takes the member-map route) and one of 2^31 - 1 (the sorted keys'
probe). For B = 2, 4 and 8 members it checks the batched launch bit for
bit against its plain version and B single K1 launches, then times with
tools/timing.py:time_ms (the L2 flushed and the card kept busy before
each run, so the device time is counted) the batched launch, B single
launches and B torch.searchsorted calls. Prints one JSON line a case
(and writes them all to --out); exits 1 on a mismatch and 2 without a
card.
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from pinot_tpu_torch.tools.timing import time_ms

ROWS = 7_503_872
CASES = ((4096, 2_000_000), (65536, 2_000_000), (65536, 2 ** 31 - 1))
SIZES = (2, 4, 8)


def run(repeats: int = 10, seed: int = 0):
    from pinot_tpu_torch.ops import kernels as K
    device = torch.device("cuda")
    rng = np.random.default_rng(seed)
    n = ROWS - 100
    lane = torch.from_numpy(rng.integers(0, 2_000_000, ROWS)
                            .astype(np.int32)).to(device)
    cols = {"k.raw": lane}
    member_map = getattr(K, "join_member_map", None)
    for dp, span in CASES:
        members = [[K.SortedKeys(np.sort(rng.choice(span, dp, replace=False))
                                 .astype(np.int32))] for _ in range(8)]
        for m in members:
            m[0].on(device)
        spec = ("pred", "join_raw", "k", "raw", dp)
        for B in SIZES:
            batch = members[:B]
            got = K.filter_mask_batched(ROWS, spec, cols, batch, n)
            want = K.filter_mask_batched_plain(ROWS, spec, cols, batch, n)
            singles = [K.filter_mask(ROWS, spec, cols, m, n) for m in batch]
            ok = torch.equal(got[0], want[0]) and \
                torch.equal(got[1], want[1]) and \
                all(torch.equal(got[0][b], s) for b, s in enumerate(singles))
            route = "search" if member_map is None or member_map(
                [m[0] for m in batch], lane) is None else "member_map"
            sks = [m[0].on(device)[0] for m in batch]
            yield {
                "dp": dp, "span": span, "members": B, "route": route,
                "equal": ok,
                "batched_ms": time_ms(lambda: K.filter_mask_batched(
                    ROWS, spec, cols, batch, n), repeats),
                "singles_ms": time_ms(lambda: [K.filter_mask(
                    ROWS, spec, cols, m, n) for m in batch], repeats,
                    spins=B),
                "searchsorted_ms": time_ms(lambda: [torch.searchsorted(
                    sk, lane) for sk in sks], repeats, spins=B)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None)
    ap.add_argument("--repeats", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("join_leaf_bench needs a CUDA card", file=sys.stderr)
        return 2
    rows, ok = [], True
    for r in run(args.repeats, args.seed):
        print(json.dumps(r), flush=True)
        rows.append(r)
        ok = ok and r["equal"]
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
