"""Linear-time sorted factorize shared by the dictionary and cube builders.

np.unique is an O(n log n) argsort; a hash factorize is O(n) plus a sort of
the (tiny) unique set. pandas provides the hash table; without it the
np.unique fallback keeps behavior identical.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def int_lut_factorize(arr: np.ndarray
                      ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """bincount-LUT ladder: bounded-span integers factorize with two
    O(n) passes and NO hashing (presence scatter + LUT gather) — the
    dominant SSB dictionary-build case (dims are small-range ints,
    metrics like revenue span < 2M). None when the span is too wide."""
    a = np.asarray(arr)
    if a.dtype.kind not in "iu" or not len(a):
        return None
    mn, mx = int(a.min()), int(a.max())
    span = mx - mn + 1
    if span > max(4 * len(a), 1 << 22):
        return None
    off = (a.astype(np.int64) - mn)
    presence = np.zeros(span, bool)
    presence[off] = True
    uniq_off = np.flatnonzero(presence)
    # int32 LUT: ranks are < n < 2^31; halves the peak allocation of
    # this hot build path (a 400M-slot span is 1.6GB, not 3.2GB)
    lut = np.zeros(span, np.int32)
    lut[uniq_off] = np.arange(len(uniq_off), dtype=np.int32)
    return (uniq_off + mn).astype(a.dtype), lut[off]


def sorted_factorize(arr: np.ndarray
                     ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """(sorted unique values, inverse codes) for arr, or None when the
    linear path can't run (pandas missing, or NaN-like values that
    factorize maps to the -1 sentinel — callers fall back to np.unique)."""
    fast = int_lut_factorize(arr)
    if fast is not None:
        return fast
    try:
        import pandas as pd
    except ImportError:
        return None
    codes, uniq = pd.factorize(arr)
    if len(codes) and codes.min() < 0:          # -1 = NaN sentinel
        return None
    uniq = np.asarray(uniq)
    order = np.argsort(uniq, kind="stable")      # unique set: tiny vs n
    rank = np.empty(len(order), np.int64)
    rank[order] = np.arange(len(order), dtype=np.int64)
    return uniq[order], rank[codes]


def sorted_factorize_or_unique(arr: np.ndarray
                               ) -> Tuple[np.ndarray, np.ndarray]:
    """sorted_factorize with the canonical np.unique fallback — callers
    that don't need a custom fallback (e.g. a pre-cast step) use this so
    the fallback semantics live in one place."""
    fact = sorted_factorize(arr)
    if fact is None:
        return np.unique(arr, return_inverse=True)
    return fact
