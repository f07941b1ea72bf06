"""Native (C++) segment-build hot loops, compiled on first use.

Copy of pinot_tpu/native/__init__.py. The segment BUILD is host work
whose hot loops (cube grouping, grouped stats, fixed-bit packing) live in
seglib.cpp (the JAX package's source, copied), compiled here with g++ -O3
into a shared object cached by the source's hash under the checkout's
`build/pinot_tpu_torch_native/`, and bound via ctypes. Every entry point
has a numpy fallback so the package works without a compiler — `lib()`
returns None then and callers keep their pure-python path
(PINOT_TPU_NO_NATIVE=1 forces that).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Optional

import numpy as np

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_TRIED = False

_SRC = os.path.join(os.path.dirname(__file__), "seglib.cpp")


BUILD_ROOT = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), "build", "pinot_tpu_torch_native")


def _build_dir() -> str:
    os.makedirs(BUILD_ROOT, exist_ok=True)
    return BUILD_ROOT


def lib() -> Optional[ctypes.CDLL]:
    """The compiled library, building it if needed; None when no g++."""
    global _LIB, _TRIED
    if _LIB is not None or _TRIED:
        return _LIB
    with _LOCK:
        if _LIB is not None or _TRIED:
            return _LIB
        _TRIED = True
        if os.environ.get("PINOT_TPU_NO_NATIVE") == "1":
            return None
        try:
            with open(_SRC, "rb") as fh:
                tag = hashlib.sha256(fh.read()).hexdigest()[:16]
            so = os.path.join(_build_dir(), f"seglib-{tag}.so")
            if not os.path.exists(so):
                tmp = so + f".tmp{os.getpid()}"
                subprocess.run(
                    ["g++", "-O3", "-std=c++17", "-shared", "-fPIC",
                     "-o", tmp, _SRC],
                    check=True, capture_output=True)
                os.replace(tmp, so)      # atomic: racing builders agree
            cdll = ctypes.CDLL(so)
            _bind(cdll)
            _LIB = cdll
        except Exception:  # noqa: BLE001 — fallback is pure numpy
            _LIB = None
        return _LIB


def _bind(cdll: ctypes.CDLL) -> None:
    i64, i32, u32, f64, vp = (ctypes.c_int64, ctypes.c_int32,
                              ctypes.c_uint32, ctypes.c_double,
                              ctypes.c_void_p)
    cdll.pack_bits_u32.argtypes = [vp, i64, ctypes.c_int, vp, i64]
    cdll.unpack_bits_u32.argtypes = [vp, i64, ctypes.c_int, i64, vp]
    cdll.group_index_i64.restype = i64
    cdll.group_index_i64.argtypes = [vp, i64, vp, vp]
    cdll.group_counts_i64.argtypes = [vp, i64, i64, vp]
    cdll.group_stats_f64.argtypes = [vp, vp, i64, i64, vp, vp, vp]
    cdll.group_stats_sorted_f64.argtypes = [vp, vp, i64, i64, vp, vp, vp,
                                            vp]
    cdll.packed_key_i64.argtypes = [vp, vp, ctypes.c_int, i64, vp]


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


# ---------------------------------------------------------------------------
# numpy-signature wrappers (None return = caller takes the numpy path)
# ---------------------------------------------------------------------------


def pack_bits(ids: np.ndarray, num_bits: int) -> Optional[np.ndarray]:
    L = lib()
    if L is None:
        return None
    ids = np.ascontiguousarray(ids, dtype=np.int32)
    n = len(ids)
    n_words = (n * num_bits + 31) // 32
    out = np.empty(n_words, np.uint32)
    L.pack_bits_u32(_ptr(ids), n, num_bits, _ptr(out), n_words)
    return out


def unpack_bits(words: np.ndarray, num_bits: int,
                n: int) -> Optional[np.ndarray]:
    L = lib()
    if L is None:
        return None
    words = np.ascontiguousarray(words, dtype=np.uint32)
    out = np.empty(n, np.int32)
    L.unpack_bits_u32(_ptr(words), len(words), num_bits, n, _ptr(out))
    return out


def group_index(key: np.ndarray):
    """(sorted unique keys, per-row rank int32) or None (no native lib /
    alloc failure)."""
    L = lib()
    if L is None:
        return None
    key = np.ascontiguousarray(key, dtype=np.int64)
    n = len(key)
    uniq = np.empty(n, np.int64)
    rank = np.empty(n, np.int32)
    g = L.group_index_i64(_ptr(key), n, _ptr(uniq), _ptr(rank))
    if g < 0:
        return None
    return uniq[:g].copy(), rank


def group_counts(rank: np.ndarray, g: int) -> Optional[np.ndarray]:
    L = lib()
    if L is None:
        return None
    rank = np.ascontiguousarray(rank, dtype=np.int32)
    out = np.empty(g, np.int64)
    L.group_counts_i64(_ptr(rank), len(rank), g, _ptr(out))
    return out


def group_stats(rank: np.ndarray, vals: np.ndarray, g: int):
    """(sums, mins, maxs) float64 [g] or None."""
    L = lib()
    if L is None:
        return None
    rank = np.ascontiguousarray(rank, dtype=np.int32)
    vals = np.ascontiguousarray(vals, dtype=np.float64)
    sums = np.empty(g, np.float64)
    mins = np.empty(g, np.float64)
    maxs = np.empty(g, np.float64)
    L.group_stats_f64(_ptr(rank), _ptr(vals), len(rank), g,
                      _ptr(sums), _ptr(mins), _ptr(maxs))
    return sums, mins, maxs


def group_stats_sorted(order: np.ndarray, starts: np.ndarray, n: int,
                       vals: np.ndarray):
    """(sums, mins, maxs) per sorted-key run, gather fused in; None
    when no native lib."""
    L = lib()
    if L is None:
        return None
    order = np.ascontiguousarray(order, dtype=np.int64)
    starts = np.ascontiguousarray(starts, dtype=np.int64)
    vals = np.ascontiguousarray(vals, dtype=np.float64)
    g = len(starts)
    sums = np.empty(g, np.float64)
    mins = np.empty(g, np.float64)
    maxs = np.empty(g, np.float64)
    L.group_stats_sorted_f64(_ptr(order), _ptr(starts), g, n, _ptr(vals),
                             _ptr(sums), _ptr(mins), _ptr(maxs))
    return sums, mins, maxs


def packed_key(dims, cards) -> Optional[np.ndarray]:
    """Mixed-radix key over int32 dim lanes in one native pass."""
    L = lib()
    if L is None or not dims:
        return None
    arrs = [np.ascontiguousarray(d, dtype=np.int32) for d in dims]
    n = len(arrs[0])
    ptrs = (ctypes.c_void_p * len(arrs))(
        *[a.ctypes.data_as(ctypes.c_void_p).value for a in arrs])
    cards64 = np.asarray(cards, dtype=np.int64)
    out = np.empty(n, np.int64)
    L.packed_key_i64(ptrs, _ptr(cards64), len(arrs), n, _ptr(out))
    return out
