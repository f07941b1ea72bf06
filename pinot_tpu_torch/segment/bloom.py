"""Bloom filter for segment pruning on equality predicates.

Parity: pinot-core/.../segment/creator/impl/bloom/BloomFilterCreator.java and
index/readers/BloomFilterReader.java (guava BloomFilter underneath). Same use:
the ColumnValueSegmentPruner rejects segments whose bloom filter definitely
does not contain the EQ value (SURVEY.md §2.4).
"""
from __future__ import annotations

import hashlib
import math
import os

import numpy as np

from pinot_tpu_torch.segment import format as fmt

DEFAULT_FPP = 0.05
MAX_BITS = 1 << 20  # cap per column, mirrors reference's 1MB default cap


def _hashes(value: str, num_hashes: int, num_bits: int) -> np.ndarray:
    digest = hashlib.md5(value.encode("utf-8")).digest()
    h1 = int.from_bytes(digest[:8], "little")
    h2 = int.from_bytes(digest[8:], "little") | 1
    return np.array([(h1 + i * h2) % num_bits for i in range(num_hashes)],
                    dtype=np.int64)


class BloomFilter:
    def __init__(self, num_bits: int, num_hashes: int,
                 bits: np.ndarray | None = None):
        self.num_bits = num_bits
        self.num_hashes = num_hashes
        self.bits = bits if bits is not None else np.zeros(
            (num_bits + 63) // 64, dtype=np.uint64)

    @classmethod
    def with_capacity(cls, n_items: int, fpp: float = DEFAULT_FPP
                      ) -> "BloomFilter":
        n_items = max(n_items, 1)
        m = int(-n_items * math.log(fpp) / (math.log(2) ** 2))
        m = max(64, min(m, MAX_BITS))
        k = max(1, round(m / n_items * math.log(2)))
        return cls(m, k)

    def add(self, value) -> None:
        idx = _hashes(str(value), self.num_hashes, self.num_bits)
        np.bitwise_or.at(self.bits, idx // 64,
                         np.uint64(1) << (idx % 64).astype(np.uint64))

    def might_contain(self, value) -> bool:
        idx = _hashes(str(value), self.num_hashes, self.num_bits)
        got = (self.bits[idx // 64] >> (idx % 64).astype(np.uint64)) & np.uint64(1)
        return bool(got.all())

    # -- serde -------------------------------------------------------------
    def save(self, seg_dir: str, col: str) -> None:
        header = np.array([self.num_bits, self.num_hashes], dtype=np.uint64)
        np.save(os.path.join(seg_dir, fmt.BLOOM.format(col=col)),
                np.concatenate([header, self.bits]))

    @classmethod
    def load(cls, seg_dir, col: str) -> "BloomFilter":
        arr = np.asarray(fmt.open_dir(seg_dir).load_array(
            fmt.BLOOM.format(col=col)))
        num_bits, num_hashes = int(arr[0]), int(arr[1])
        return cls(num_bits, num_hashes, arr[2:].copy())
