"""Forward indexes: bit-packed dictIds, sorted ranges, raw values, multi-value.

Counterpart of pinot_tpu/segment/fwd.py, numpy paths only: the JAX
package's optional native pack/unpack loops write the same bytes, so a
segment directory written by either package reads back in the other.

Parity: pinot-core/.../io/reader/impl/v1/{FixedBitSingleValueReader,
FixedBitMultiValueReader,FixedByteChunkSingleValueReader}.java and the
creator-side fwd index writers (core/segment/creator/impl/fwd/). On disk we
bit-pack dictIds into uint32 words exactly like the fixed-bit format; on the
card the loader keeps unpacked narrow id lanes (segment/loader.py) — the
pack exists for storage parity + compactness.
"""
from __future__ import annotations

import os
from typing import Tuple

import numpy as np

from pinot_tpu_torch.segment import format as fmt


def bits_required(cardinality: int) -> int:
    if cardinality <= 1:
        return 1
    return int(np.ceil(np.log2(cardinality))) or 1


# -- fixed-bit packing (vectorized) ---------------------------------------

def pack_bits(ids: np.ndarray, num_bits: int) -> np.ndarray:
    """Pack int32 ids (< 2**num_bits) into a dense little-endian bitstream
    stored as uint32 words.

    Pure word arithmetic: k = lcm(nb, 32)/nb ids fill exactly
    lcm(nb, 32)/32 words, so the stream is a [groups, k] view combined by
    k shift+or passes over group-scale uint64 lanes (straddling bits land
    in the next word via the uint64 carry). Measured 12x faster than the
    previous bit-matrix + np.packbits at 13 bits / 5M rows (0.13s vs
    1.56s) — the bit matrix materialized n*32 bytes and a non-contiguous
    reshape copy."""
    import math
    n = len(ids)
    n_words = (n * num_bits + 31) // 32
    lcm = math.lcm(num_bits, 32)
    k = lcm // num_bits                      # ids per group
    gw = lcm // 32                           # words per group
    npad = (-n) % k
    a = np.ascontiguousarray(ids, dtype=np.uint32).astype(np.uint64)
    if npad:
        a = np.concatenate([a, np.zeros(npad, np.uint64)])
    a = a.reshape(-1, k)
    words = np.zeros((a.shape[0], gw + 1), np.uint64)
    for j in range(k):
        o = j * num_bits
        wi, sh = o // 32, o % 32
        v = a[:, j] << np.uint64(sh)
        words[:, wi] |= v & np.uint64(0xFFFFFFFF)
        if sh + num_bits > 32:
            words[:, wi + 1] |= v >> np.uint64(32)
    return words[:, :gw].astype(np.uint32).reshape(-1)[:n_words]


def unpack_bits(words: np.ndarray, num_bits: int, n: int) -> np.ndarray:
    """Inverse of pack_bits → int32[n]."""
    byts = np.ascontiguousarray(words, dtype="<u4").view(np.uint8)
    flat = np.unpackbits(byts, bitorder="little", count=n * num_bits)
    padded = np.zeros((n, 32), np.uint8)
    padded[:, :num_bits] = flat.reshape(n, num_bits)
    return np.packbits(padded, axis=1, bitorder="little") \
        .view("<u4").reshape(n).astype(np.int32)


# -- single-value dict-encoded --------------------------------------------

class SVForwardIndexWriter:
    @staticmethod
    def write(seg_dir: str, col: str, ids: np.ndarray, cardinality: int) -> int:
        nb = bits_required(cardinality)
        words = pack_bits(ids.astype(np.int32), nb)
        np.save(os.path.join(seg_dir, fmt.SV_FWD.format(col=col)), words)
        return nb


def read_sv_fwd(seg_dir, col: str, num_bits: int, num_docs: int
                ) -> np.ndarray:
    words = fmt.open_dir(seg_dir).load_array(fmt.SV_FWD.format(col=col))
    return unpack_bits(np.asarray(words), num_bits, num_docs)


# -- sorted column ---------------------------------------------------------

def write_sorted_fwd(seg_dir: str, col: str, ids: np.ndarray,
                     cardinality: int) -> None:
    """Sorted column forward index = per-dictId [start, end) doc ranges.

    Parity: SortedIndexReaderImpl / SingleValueSortedForwardIndexCreator.
    """
    starts = np.searchsorted(ids, np.arange(cardinality), side="left")
    ends = np.searchsorted(ids, np.arange(cardinality), side="right")
    ranges = np.stack([starts, ends], axis=1).astype(np.int32)
    np.save(os.path.join(seg_dir, fmt.SV_SORTED_FWD.format(col=col)), ranges)


def read_sorted_fwd(seg_dir, col: str) -> np.ndarray:
    return np.asarray(fmt.open_dir(seg_dir).load_array(
        fmt.SV_SORTED_FWD.format(col=col)))


# -- raw (no-dictionary) ---------------------------------------------------

def write_raw_fwd(seg_dir: str, col: str, values: np.ndarray) -> None:
    np.save(os.path.join(seg_dir, fmt.SV_RAW_FWD.format(col=col)), values)


def read_raw_fwd(seg_dir, col: str) -> np.ndarray:
    return np.asarray(fmt.open_dir(seg_dir).load_array(
        fmt.SV_RAW_FWD.format(col=col)))


# -- multi-value -----------------------------------------------------------

def write_mv_fwd(seg_dir: str, col: str, flat_ids: np.ndarray,
                 offsets: np.ndarray) -> None:
    """MV fwd index as CSR: flat dictIds + int64 row offsets."""
    np.save(os.path.join(seg_dir, fmt.MV_FWD.format(col=col)),
            flat_ids.astype(np.int32))
    np.save(os.path.join(seg_dir, fmt.MV_OFFSETS.format(col=col)),
            offsets.astype(np.int64))


def read_mv_fwd(seg_dir, col: str) -> Tuple[np.ndarray, np.ndarray]:
    d = fmt.open_dir(seg_dir)
    flat = np.asarray(d.load_array(fmt.MV_FWD.format(col=col)))
    offs = np.asarray(d.load_array(fmt.MV_OFFSETS.format(col=col)))
    return flat, offs


def mv_to_padded(flat_ids: np.ndarray, offsets: np.ndarray,
                 fill_value: int) -> np.ndarray:
    """CSR → dense [num_docs, max_entries] padded matrix for device kernels.

    The fill value is the column cardinality (an invalid dictId) so predicate
    kernels can mask padding with ``id < cardinality``.
    """
    counts = np.diff(offsets)
    num_docs = len(counts)
    width = int(counts.max()) if num_docs and counts.size else 1
    width = max(width, 1)
    out = np.full((num_docs, width), fill_value, dtype=np.int32)
    rows = np.repeat(np.arange(num_docs), counts)
    cols = np.arange(len(flat_ids)) - np.repeat(offsets[:-1], counts)
    out[rows, cols] = flat_ids
    return out
