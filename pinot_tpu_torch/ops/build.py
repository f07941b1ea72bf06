"""Build and load the hand-written CUDA kernels.

Each source in ops/csrc/ builds with `nvcc` into its own shared library
with a plain C interface, loaded with ctypes. The build happens at first
use, from the sources in this checkout only, into
`<checkout>/build/pinot_tpu_torch/<hash>/`, where the hash covers every
source and header in csrc/ and the compiler flags, so an edited kernel
never loads a stale library. All sources compile at once, one `nvcc`
process each; a library is written under a temporary name and renamed
into place, so concurrent builders never see a partial file.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "pinot_tpu_torch"
SOURCES = ("filter_mask.cu", "masked_part_sums.cu", "dense_group_aggregate.cu",
           "masked_histogram.cu", "masked_reduce.cu", "masked_select.cu",
           "vector_scores.cu", "ivf_probe_select.cu", "ivf_assign.cu",
           "ivf_recenter.cu", "sort_window.cu", "group_compact.cu",
           "ssb_synth.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
_targets: Dict[str, Path] = {}
#: what the last build in this process did: seconds, each source's
#: seconds from the start (its nvcc running beside the others), library
#: paths, and ptxas' register, shared-memory and spill report per source
BUILD_INFO: Dict[str, object] = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.iterdir()):
        if p.suffix in (".cu", ".cuh"):
            h.update(p.name.encode())
            h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build_dir() -> Path:
    return BUILD_ROOT / source_hash()


def build_all() -> Dict[str, Path]:
    """Build every library that is missing, all nvcc processes at once;
    returns {source: library path}."""
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    targets = {src: out_dir / f"lib{Path(src).stem}.so" for src in SOURCES}
    t0 = time.perf_counter()
    procs = {}
    for src, lib in targets.items():
        if lib.exists():
            continue
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / src)]
        procs[src] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True),
                      tmp, lib)
    logs, done = {}, {}

    def wait(src, proc):
        logs[src] = proc.communicate()[0]
        done[src] = time.perf_counter() - t0

    waiters = [threading.Thread(target=wait, args=(src, proc))
               for src, (proc, _tmp, _lib) in procs.items()]
    for w in waiters:
        w.start()
    for w in waiters:
        w.join()
    ptxas = {}
    failed = []
    for src, (proc, tmp, lib) in procs.items():
        log = logs[src]
        ptxas[src] = [ln.strip() for ln in log.splitlines()
                      if "ptxas info" in ln or "spill" in ln]
        if proc.returncode != 0:
            failed.append(f"{src} (exit {proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, lib)
    if failed:
        raise RuntimeError("nvcc failed: " + "\n".join(failed))
    BUILD_INFO.update(seconds=time.perf_counter() - t0,
                      built=sorted(procs), source_seconds=done,
                      dir=str(out_dir),
                      libs={s: str(p) for s, p in targets.items()},
                      ptxas=ptxas)
    return targets


def load(source: str) -> ctypes.CDLL:
    """The loaded library of one source, building all of them first if
    needed (so a process pays for one parallel build, not one per
    source)."""
    with _lock:
        lib = _libs.get(source)
        if lib is None:
            if not _targets:
                _targets.update(build_all())
            lib = ctypes.CDLL(str(_targets[source]))
            _libs[source] = lib
        return lib
