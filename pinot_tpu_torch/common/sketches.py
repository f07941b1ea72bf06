"""Mergeable sketches: dense HyperLogLog + merging t-digest.

Parity: the reference's intermediate custom objects for approximate
aggregations — com.clearspring HyperLogLog used by DISTINCTCOUNTHLL /
FASTHLL (HllConstants, pinot-common/.../startree/hll) and com.tdunning
TDigest used by PERCENTILETDIGEST (+ QuantileDigest for PERCENTILEEST),
with typed serde entries (core/common/ObjectSerDeUtils.java:55-83).
These are genuinely mergeable across segments/servers with non-shared
dictionaries — the property exact histograms lose once value sets differ.

Vectorized numpy throughout: adds are O(values) with a 6-step exact
bit-length ladder, no per-element Python.
"""
from __future__ import annotations

import hashlib
import struct
from typing import List, Optional, Tuple

import numpy as np

DEFAULT_LOG2M = 12                 # 4096 registers, ~1.6% std error
DEFAULT_COMPRESSION = 100.0

_U64 = np.uint64


def _bit_length_u64(v: np.ndarray) -> np.ndarray:
    """Exact bit length of uint64 values (vectorized, no float loss)."""
    v = v.copy()
    bl = np.zeros(v.shape, dtype=np.int64)
    for s in (32, 16, 8, 4, 2, 1):
        big = v >= (_U64(1) << _U64(s))
        bl[big] += s
        v[big] >>= _U64(s)
    bl[v > 0] += 1
    return bl


def _mix64(x: np.ndarray) -> np.ndarray:
    """splitmix64 finalizer — stable 64-bit hash for numeric values."""
    with np.errstate(over="ignore"):
        x = (x + _U64(0x9E3779B97F4A7C15))
        x = (x ^ (x >> _U64(30))) * _U64(0xBF58476D1CE4E5B9)
        x = (x ^ (x >> _U64(27))) * _U64(0x94D049BB133111EB)
        return x ^ (x >> _U64(31))


def _hash_values(values) -> np.ndarray:
    arr = np.asarray(values)
    if arr.dtype.kind in "iu":
        return _mix64(arr.astype(np.int64).view(np.uint64))
    if arr.dtype.kind == "f":
        return _mix64(arr.astype(np.float64).view(np.uint64))
    if arr.dtype.kind == "b":
        return _mix64(arr.astype(np.int64).view(np.uint64))
    # strings / objects: stable 8-byte blake2b per value
    out = np.empty(len(arr), dtype=np.uint64)
    for i, v in enumerate(arr):
        data = v if isinstance(v, bytes) else str(v).encode("utf-8")
        out[i] = int.from_bytes(
            hashlib.blake2b(data, digest_size=8).digest(), "big")
    return out


def hll_tables(values, log2m: int = DEFAULT_LOG2M
               ) -> Tuple[np.ndarray, np.ndarray]:
    """Per-value (register index, rank) int32 tables for `values`.

    The ONE hashing implementation shared by HyperLogLog.add_values and
    the device HLL kernel's per-dictId precompute (ops/kernels.py agg
    "hll"): a register array built by scatter-maxing rank over idx for
    any subset of `values` is bit-identical to
    HyperLogLog.from_values(that subset) by construction — the
    host/device/sharded register-identity contract.
    """
    if len(values) == 0:
        return (np.zeros(0, np.int32), np.zeros(0, np.int32))
    h = _hash_values(values)
    idx = (h >> _U64(64 - log2m)).astype(np.int32)
    low = h & ((_U64(1) << _U64(64 - log2m)) - _U64(1))
    # rank = (64 - log2m + 1) - bitlength, all values <= 64: int32-exact
    max_rank = 65 - log2m
    bl = _bit_length_u64(low).astype(np.int32)
    rank = np.int32(max_rank) - bl
    return idx, rank


class HyperLogLog:
    """Dense HLL with the standard bias-corrected estimator."""

    def __init__(self, log2m: int = DEFAULT_LOG2M,
                 registers: Optional[np.ndarray] = None):
        self.log2m = log2m
        self.m = 1 << log2m
        self.registers = registers if registers is not None \
            else np.zeros(self.m, dtype=np.uint8)

    @classmethod
    def from_values(cls, values, log2m: int = DEFAULT_LOG2M
                    ) -> "HyperLogLog":
        hll = cls(log2m)
        hll.add_values(values)
        return hll

    def add_values(self, values) -> None:
        if len(values) == 0:
            return
        # delegates to the shared (host+device) hash/rank tables so the
        # device register kernel stays bit-identical by construction
        idx, rank = hll_tables(values, self.log2m)
        np.maximum.at(self.registers, idx, rank.astype(np.uint8))

    def merge(self, other: "HyperLogLog") -> "HyperLogLog":
        assert self.log2m == other.log2m, "HLL log2m mismatch"
        return HyperLogLog(self.log2m,
                           np.maximum(self.registers, other.registers))

    def cardinality(self) -> float:
        m = float(self.m)
        alpha = 0.7213 / (1 + 1.079 / m)
        inv = np.ldexp(1.0, -self.registers.astype(np.int64))
        est = alpha * m * m / inv.sum()
        if est <= 2.5 * m:
            zeros = int((self.registers == 0).sum())
            if zeros:
                return m * np.log(m / zeros)       # linear counting
        elif est > (2 ** 64) / 30.0:
            est = -(2.0 ** 64) * np.log(1 - est / 2.0 ** 64)
        return float(est)

    def to_bytes(self) -> bytes:
        return struct.pack(">B", self.log2m) + self.registers.tobytes()

    @classmethod
    def from_bytes(cls, b: bytes) -> "HyperLogLog":
        log2m = b[0]
        regs = np.frombuffer(b[1:1 + (1 << log2m)],
                             dtype=np.uint8).copy()
        return cls(log2m, regs)

    def __eq__(self, other) -> bool:
        return isinstance(other, HyperLogLog) and \
            self.log2m == other.log2m and \
            bool(np.array_equal(self.registers, other.registers))


def union_serialized_hlls(hex_values) -> Optional["HyperLogLog"]:
    """Union hex-serialized HLLs (the derived-HLL-column FASTHLL path:
    each dictionary value of a derived column is one sketch). Returns
    None when no sketches matched — a default-log2m empty sketch would
    trip the log2m-mismatch assert when merged with a real segment's
    sketch at a different configured log2m; AggregationFunction.merge
    treats None as the identity."""
    out: Optional[HyperLogLog] = None
    for v in hex_values:
        h = HyperLogLog.from_bytes(bytes.fromhex(str(v)))
        out = h if out is None else out.merge(h)
    return out


class TDigest:
    """Merging t-digest (k1 arcsine scale) over (mean, weight) centroids."""

    def __init__(self, compression: float = DEFAULT_COMPRESSION,
                 means: Optional[np.ndarray] = None,
                 weights: Optional[np.ndarray] = None):
        self.compression = compression
        self.means = means if means is not None \
            else np.zeros(0, dtype=np.float64)
        self.weights = weights if weights is not None \
            else np.zeros(0, dtype=np.float64)

    @classmethod
    def from_values(cls, values, weights=None,
                    compression: float = DEFAULT_COMPRESSION) -> "TDigest":
        td = cls(compression)
        td.add_values(values, weights)
        return td

    def add_values(self, values, weights=None) -> None:
        vals = np.asarray(values, dtype=np.float64)
        if len(vals) == 0:
            return
        w = np.ones(len(vals)) if weights is None \
            else np.asarray(weights, dtype=np.float64)
        self.means = np.concatenate([self.means, vals])
        self.weights = np.concatenate([self.weights, w])
        self._compress()

    def merge(self, other: "TDigest") -> "TDigest":
        out = TDigest(self.compression,
                      np.concatenate([self.means, other.means]),
                      np.concatenate([self.weights, other.weights]))
        out._compress()
        return out

    def _k(self, q: np.ndarray) -> np.ndarray:
        return (self.compression / (2 * np.pi)) * \
            np.arcsin(np.clip(2 * q - 1, -1, 1))

    def _compress(self) -> None:
        """Vectorized k-space binning: centroids whose left-edge quantiles
        fall in the same unit k1-interval merge (weighted mean) — bounded
        bin mass with tiny tail bins, no per-element Python."""
        if len(self.means) <= 1:
            return
        order = np.argsort(self.means, kind="stable")
        means, weights = self.means[order], self.weights[order]
        total = weights.sum()
        q_left = (np.cumsum(weights) - weights) / total
        k = np.floor(self._k(q_left)).astype(np.int64)
        bin_id = np.concatenate([[0], np.cumsum(np.diff(k) != 0)])
        nbins = int(bin_id[-1]) + 1
        new_w = np.zeros(nbins)
        new_mw = np.zeros(nbins)
        np.add.at(new_w, bin_id, weights)
        np.add.at(new_mw, bin_id, means * weights)
        self.means = new_mw / new_w
        self.weights = new_w

    @property
    def total_weight(self) -> float:
        return float(self.weights.sum())

    def quantile(self, q: float) -> float:
        if len(self.means) == 0:
            return float("-inf")
        if len(self.means) == 1:
            return float(self.means[0])
        total = self.weights.sum()
        target = q * total
        cum = np.cumsum(self.weights) - self.weights / 2.0
        if target <= cum[0]:
            return float(self.means[0])
        if target >= cum[-1]:
            return float(self.means[-1])
        i = int(np.searchsorted(cum, target))
        t = (target - cum[i - 1]) / (cum[i] - cum[i - 1])
        return float(self.means[i - 1] +
                     t * (self.means[i] - self.means[i - 1]))

    def to_bytes(self) -> bytes:
        head = struct.pack(">dI", self.compression, len(self.means))
        return head + self.means.tobytes() + self.weights.tobytes()

    @classmethod
    def from_bytes(cls, b: bytes) -> "TDigest":
        compression, n = struct.unpack_from(">dI", b)
        off = struct.calcsize(">dI")
        means = np.frombuffer(b[off:off + 8 * n], dtype=np.float64).copy()
        weights = np.frombuffer(b[off + 8 * n:off + 16 * n],
                                dtype=np.float64).copy()
        return cls(compression, means, weights)

    def __eq__(self, other) -> bool:
        return isinstance(other, TDigest) and \
            self.compression == other.compression and \
            bool(np.array_equal(self.means, other.means)) and \
            bool(np.array_equal(self.weights, other.weights))
