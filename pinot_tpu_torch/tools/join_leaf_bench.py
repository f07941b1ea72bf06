"""Times K1's join_raw leaf, single and batched, at the raw-key table's size.

    python3 -m pinot_tpu_torch.tools.join_leaf_bench [--out FILE]

On the card: a random int32 key lane of 7,503,872 rows (one raw-key
segment of the join table) and 8 members, each with its own sorted dim
keys, for a few (Dp, key span) cases: a span of 2,000,000 keys (the
batch takes the member-map route) and one of 2^31 - 1 (the sorted keys'
probe). For B = 2, 4 and 8 members it checks the batched launch bit for
bit against its plain version and B single K1 launches, then times with
tools/timing.py:time_ms (the L2 flushed and the card kept busy before
each run, so the device time is counted) the batched launch, B single
launches and B torch.searchsorted calls. Then the single leaf's two
routes at J2.1's shape (SINGLE_DIM of SINGLE_PARTS part keys drawn as
tools/datagen.py draws them, a lane of fact keys): the bitmap route over
the int32 keys, the probe route over the same keys and lane scaled past
JOIN_BITMAP_MAX_SPAN (by SINGLE_WIDE_INT32 in int32, by 2^26 into
int64), each as the lone leaf and under an AND (the bitmap's lone leaf
has a kernel of its own; the probe is the interpreter's either way),
checked bit for bit against the plain version and timed beside
torch.isin and torch.searchsorted. Prints one JSON line a case (and
writes them all to --out); exits 1 on a mismatch and 2 without a card.
"""
from __future__ import annotations

import argparse
import itertools
import json
import sys

import numpy as np
import torch

from pinot_tpu_torch.tools.timing import time_ms

ROWS = 7_503_872
CASES = ((4096, 2_000_000), (65536, 2_000_000), (65536, 2 ** 31 - 1))
SIZES = (2, 4, 8)
#: J2.1's dim side: 32,240 of the 800,000 part keys (padded to 32,768)
SINGLE_DIM, SINGLE_PARTS = 32_240, 800_000
#: the int32 probe case scales the keys past JOIN_BITMAP_MAX_SPAN
SINGLE_WIDE_INT32 = 383


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


def run_single(repeats: int = 10, seed: int = 0):
    """The single join_raw leaf on both routes at J2.1's shape, one
    JSON-able row each: the lone leaf (on the bitmap route
    filter_mask.cu:join_bitmap_kernel) and the same leaf in the program's
    interpreter (an AND of one child) beside torch.isin and
    torch.searchsorted."""
    from pinot_tpu_torch.ops import kernels as K
    device = torch.device("cuda")
    rng = np.random.default_rng([seed, 1])
    # tools/datagen.py:make_join_rows: part keys a sample of [1, 7 x
    # parts), fact keys drawn from them, a tenth negated (no dim row)
    parts = np.sort(rng.choice(np.arange(1, 7 * SINGLE_PARTS), SINGLE_PARTS,
                               replace=False))
    dim = np.sort(rng.choice(parts, SINGLE_DIM, replace=False))
    keys = np.full(1 << (SINGLE_DIM - 1).bit_length(), dim[-1])
    keys[:SINGLE_DIM] = dim
    lane = parts[rng.integers(0, SINGLE_PARTS, ROWS)]
    lane = np.where(rng.random(ROWS) < 0.1, -lane - 1, lane)
    n = ROWS - 100
    spec = ("pred", "join_raw", "k", "raw", len(keys))
    for route, scale, dtype in (("bitmap", 1, np.int32),
                                ("probe", SINGLE_WIDE_INT32, np.int32),
                                ("probe", K.JOIN_BITMAP_MAX_SPAN, np.int64)):
        probe = K.SortedKeys((keys * scale).astype(dtype))
        lt = torch.from_numpy((lane * scale).astype(dtype)).to(device)
        cols = {"k.raw": lt}
        ok = True
        for sp in (spec, ("and", (spec,))):
            want = K.filter_mask_plain(ROWS, sp, cols, [probe], n)
            for _ in range(repeats):
                K.reset_launch_counts()
                got = K.filter_mask(ROWS, sp, cols, [probe], n)
                ok = ok and torch.equal(got, want) and \
                    K.launch_counts()[f"filter_mask[{route}]"] == 1
        sk = probe.on(device)[0]
        dk = torch.from_numpy(probe.typed()).to(device)
        yield {"single": True, "route": route, "dtype": str(lt.dtype),
               "dp": len(keys), "span": int(np.ptp(probe.typed())) + 1,
               "matched": int(want.sum()), "equal": ok,
               "bitmap_seconds": probe.bitmap_seconds,
               "ms": time_ms(lambda: K.filter_mask(ROWS, spec, cols,
                                                   [probe], n), repeats),
               "interpreter_ms": time_ms(lambda: K.filter_mask(
                   ROWS, ("and", (spec,)), cols, [probe], n), repeats),
               "isin_ms": time_ms(lambda: torch.isin(lt, dk), repeats),
               "searchsorted_ms": time_ms(lambda: torch.searchsorted(sk, lt),
                                          repeats)}


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
    for r in itertools.chain(run(args.repeats, args.seed),
                             run_single(args.repeats, args.seed)):
        print(json.dumps(r), flush=True)
        rows.append(r)
        ok = ok and r["equal"]
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
