"""The yardstick of the port's chip measurements: device time between
CUDA events with the L2 flushed, torch.profiler's time a kernel, and the
least time the card could take for a piece of work.

`chip_smoke.py`, `tools/join_leaf_bench.py` and
`tools/vector_kernel_bench.py` time with these, so their numbers compare.
Every function here needs a CUDA card.
"""
from __future__ import annotations

import torch

HBM_BYTES_PER_S = 3.35e12       # H100 SXM device memory rate
SCALAR_OPS_PER_S = 67e12        # H100 SXM float32 outside the tensor cores
L2_FLUSH_BYTES = 128 << 20      # > the 50 MB L2: each timed launch is cold
SPIN_CYCLES = 2_000_000         # ~1 ms at H100 clocks


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


def launch_breakdown(fn, reps: int = 5) -> dict:
    """{kernel: [mean device µs a launch, launches recorded]} for the
    kernels fn() launches, under torch.profiler over `reps` calls, the L2
    flushed before each call as time_ms flushes it (the flush's own uint8
    fill is left out). The mean is over the launches the profiler
    recorded, which in a process that has profiled before can be fewer
    than reps a kernel. {"error": ...} where the profiler fails: the
    breakdown only explains a time, it checks nothing."""
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    fn()
    torch.cuda.synchronize()
    try:
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                flush.zero_()
                fn()
            torch.cuda.synchronize()
        out = {}
        for ev in prof.key_averages():
            us = getattr(ev, "self_device_time_total", None)
            if us is None:
                us = getattr(ev, "self_cuda_time_total", 0)
            if not us or not ev.count or \
                    "FillFunctor<unsigned char>" in ev.key or \
                    not str(ev.device_type).endswith("CUDA"):
                continue
            name = ev.key.replace("(anonymous namespace)::", "")
            name = name.split("(")[0].replace("void ", "").strip()[:80]
            total, n = out.get(name, (0.0, 0))
            out[name] = (total + us, n + ev.count)
        return {k: [total / n, n] for k, (total, n) in out.items()}
    except Exception as e:  # noqa: BLE001 - a diagnostic, never a check
        return {"error": repr(e)}


def bound(nbytes: float, ops: float) -> tuple:
    """(ms, "bytes" or "operations"): the larger of the bytes over the
    memory rate and the operations over the scalar f32 rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / SCALAR_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
