"""Times K8 (single and batched) and K9 with their wrappers on the card.

    python3 pinot_tpu_torch/tools/vector_kernel_bench.py [--out FILE]
        [--root DIR]

`--root DIR` measures the package `pinot_tpu_torch` under DIR (another
checkout, say the parent commit unpacked into a directory that
.gitignore lists) instead of this checkout's, so two versions compare in
one call: parent, change, change, parent. Run it as a file, so that the
package is imported from the root named.

On the card, from seed SEED: codebooks of 256 x 128 (vecbench's) and
8,192 x 128 (4 * sqrt(N) cells of a 2.5M-row segment, padded), 90% of
the centroids live, and a lane of ROWS x 128 rows (one vecbench
segment). Each case checks the kernel against its plain version (K9's
ids and ok equal, K8's scores bit for bit, K8 batched also against B
single launches), then times with tools/timing.py:time_ms, REPEATS calls
each (the L2 flushed and a ~1 ms spin on the card before each call, so
a wrapper that does not wait for the card is timed by its device work
alone), the wrapper with a numpy query (as the planner passes it), one
PyTorch call for the same function with the query on the card
(`topk(mv)`, `torch.mv`, `torch.mm`), and B single launches beside a
batched one. `kernel_us` is timing.py:launch_breakdown's device time a
launch of each kernel the call runs. `no_host_sync` says whether the
wrapper ran under torch.cuda.set_sync_debug_mode("error") without
raising, and `host_us` is the wrapper's host time a call while the card
is busy (a call that waits for the card pays the wait); the
`query_upload` case gives that time for a query's upload from pinned
memory, from pageable memory without and with a wait. Prints the card's
name and power limit, then one JSON line a case (all written to --out
too); exits 1 on a mismatch and 2 without a card.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROWS = 2_500_000
DIM = 128
SEED = 0
REPEATS = 10
CODEBOOKS = (256, 8192)
NPROBE = 16
BATCH_SIZES = (1, 2, 4, 8)


def _yardstick():
    """tools/timing.py of this file's checkout, whichever package --root
    names, so that two versions are timed the same way."""
    spec = importlib.util.spec_from_file_location(
        "pinot_tpu_torch_bench_timing",
        os.path.join(os.path.dirname(os.path.abspath(__file__)), "timing.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


T = _yardstick()


def _host_us(fn, calls: int = 200) -> float:
    """Mean host µs a call of fn() over back-to-back calls while the card
    is kept busy (a spin of ~20 ms first): a call that waits for the card
    pays the spin, one that does not pays its host work only."""
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(T.SPIN_CYCLES * 20)
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return us


def _no_host_sync(fn) -> bool:
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        fn()
        return True
    except RuntimeError:
        return False
    finally:
        torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()


def _norm(K, q):
    return np.float32(np.sqrt(K.vec_tree_sum_plain(q * q)))


def run():
    """Yields one dict a case."""
    from pinot_tpu_torch.ops import kernels as K
    dev = torch.device("cuda", torch.cuda.current_device())
    rng = np.random.default_rng(SEED)
    qs = [rng.standard_normal(DIM).astype(np.float32)
          for _ in range(max(BATCH_SIZES))]
    norms = [_norm(K, q) for q in qs]
    qmat = torch.from_numpy(np.stack(qs)).to(dev)

    # a query's upload: host µs a call in each form, the card busy
    yield {"kernel": "query_upload", "dim": DIM, "equal": True,
           "pinned_us": _host_us(lambda: torch.from_numpy(qs[0]).pin_memory()
                                 .to(dev, non_blocking=True)),
           "pageable_async_us": _host_us(lambda: torch.from_numpy(qs[0]).to(
               dev, non_blocking=True)),
           "pageable_sync_us": _host_us(lambda: torch.from_numpy(qs[0]).to(
               dev), calls=20)}

    # K9 over each codebook
    for c_pad in CODEBOOKS:
        cent = torch.from_numpy(rng.standard_normal((c_pad, DIM))
                                .astype(np.float32)).to(dev)
        cvalid = torch.from_numpy(rng.random(c_pad) < 0.9).to(dev)
        equal = True
        for metric in ("cosine", "dot"):
            for nprobe in (1, NPROBE, c_pad):
                got = K.ivf_select_probes(cent, cvalid, qs[0], norms[0],
                                          metric, nprobe)
                want = K.ivf_select_probes_plain(cent, cvalid, qs[0],
                                                 norms[0], metric, nprobe)
                equal = equal and torch.equal(got[0], want[0]) and \
                    torch.equal(got[1], want[1])

        def k9():
            return K.ivf_select_probes(cent, cvalid, qs[0], norms[0],
                                       "cosine", NPROBE)
        yield {"kernel": "ivf_probe_select", "c_pad": c_pad, "dim": DIM,
               "nprobe": NPROBE, "equal": bool(equal),
               "ms": T.time_ms(k9, REPEATS),
               "library_ms": T.time_ms(lambda: torch.topk(
                   torch.mv(cent, qmat[0]), NPROBE), REPEATS),
               "bound_ms": (c_pad * DIM * 4 + c_pad + NPROBE * 5) /
               T.HBM_BYTES_PER_S * 1e3,
               "kernel_us": T.launch_breakdown(k9), "host_us": _host_us(k9),
               "no_host_sync": _no_host_sync(k9)}

        def k9b():
            return K.ivf_select_probes_batched(cent, cvalid, qs, norms,
                                               "cosine", NPROBE)
        got = k9b()
        equal = all(torch.equal(got[0][b], K.ivf_select_probes(
            cent, cvalid, qs[b], norms[b], "cosine", NPROBE)[0])
            for b in range(len(qs)))
        yield {"kernel": "ivf_probe_select_batched", "c_pad": c_pad,
               "dim": DIM, "nprobe": NPROBE, "members": len(qs),
               "equal": bool(equal), "ms": T.time_ms(k9b, REPEATS),
               "b_single_ms": T.time_ms(lambda: [K.ivf_select_probes(
                   cent, cvalid, qs[b], norms[b], "cosine", NPROBE)
                   for b in range(len(qs))], REPEATS, spins=len(qs)),
               "kernel_us": T.launch_breakdown(k9b),
               "no_host_sync": _no_host_sync(k9b)}
        del cent, cvalid

    # K8 over a segment's lane
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    mat = torch.randn(ROWS, DIM, generator=gen, device=dev)
    mat[3] = 0.0                                # a zero-norm row
    nbytes = ROWS * DIM * 4

    def k8():
        return K.vector_scores(mat, qs[0], norms[0], "cosine")
    got = k8()
    want = K.vector_scores_plain(mat, qs[0], norms[0], "cosine")
    yield {"kernel": "vector_scores", "rows": ROWS, "dim": DIM,
           "equal": bool(torch.equal(got.view(torch.int32),
                                     want.view(torch.int32))),
           "ms": T.time_ms(k8, REPEATS),
           "library_ms": T.time_ms(lambda: torch.mv(mat, qmat[0]), REPEATS),
           "bound_ms": (nbytes + ROWS * 4) / T.HBM_BYTES_PER_S * 1e3,
           "kernel_us": T.launch_breakdown(k8), "host_us": _host_us(k8),
           "no_host_sync": _no_host_sync(k8)}
    del got, want
    for metric in ("cosine", "dot"):
        for B in BATCH_SIZES:
            if metric == "dot" and B != BATCH_SIZES[-1]:
                continue

            def k8b():
                return K.vector_scores_batched(mat, qs[:B], norms[:B],
                                               metric)
            got = k8b()
            want = K.vector_scores_batched_plain(mat, qs[:B], norms[:B],
                                                 metric)
            equal = torch.equal(got.view(torch.int32),
                                want.view(torch.int32)) and all(
                torch.equal(got[b].view(torch.int32), K.vector_scores(
                    mat, qs[b], norms[b], metric).view(torch.int32))
                for b in range(B))
            del got, want
            yield {"kernel": "vector_scores_batched", "rows": ROWS,
                   "dim": DIM, "metric": metric, "members": B,
                   "equal": bool(equal), "ms": T.time_ms(k8b, REPEATS),
                   "b_single_ms": T.time_ms(lambda: [K.vector_scores(
                       mat, qs[b], norms[b], metric) for b in range(B)],
                       REPEATS, spins=B),
                   "library_ms": T.time_ms(lambda: torch.mm(
                       mat, qmat[:B].T), REPEATS),
                   "bound_ms": (nbytes + B * ROWS * 4) /
                   T.HBM_BYTES_PER_S * 1e3,
                   "kernel_us": T.launch_breakdown(k8b),
                   "host_us": _host_us(k8b),
                   "no_host_sync": _no_host_sync(k8b)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out")
    ap.add_argument("--root", help="checkout whose pinot_tpu_torch to time")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("vector_kernel_bench: no CUDA device", file=sys.stderr)
        return 2
    root = os.path.abspath(args.root or os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "..", ".."))
    sys.path.insert(0, root)
    import pinot_tpu_torch
    if not os.path.abspath(pinot_tpu_torch.__file__).startswith(root):
        print(f"vector_kernel_bench: pinot_tpu_torch came from "
              f"{pinot_tpu_torch.__file__}, not {root}", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    head = {"device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
            "package": os.path.dirname(pinot_tpu_torch.__file__)}
    print(json.dumps(head), flush=True)
    lines, ok = [head], True
    for line in run():
        print(json.dumps(line), flush=True)
        lines.append(line)
        ok = ok and line["equal"]
    if args.out:
        with open(args.out, "w") as f:
            for line in lines:
                f.write(json.dumps(line) + "\n")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
