"""Bitmap inverted index: CSR postings (sorted docIds per dictId + offsets).

Counterpart of pinot_tpu/segment/inverted.py, the writer and the loader's
reader (parity: OffHeapBitmapInvertedIndexCreator and
BitmapInvertedIndexReader.java). The port's planner reads the posting
counts for the inverted-index COUNT fast path; it has no bitmap filters.
"""
from __future__ import annotations

import os
import numpy as np

from pinot_tpu_torch.segment import format as fmt


def build_inverted_csr(entry_ids: np.ndarray, doc_of_entry: np.ndarray,
                       cardinality: int):
    """CSR postings from (dictId, docId) pairs — one pair per SV doc,
    one per MV entry. Returns (docids int32, offsets int64)."""
    order = np.argsort(entry_ids, kind="stable")
    offsets = np.searchsorted(entry_ids[order],
                              np.arange(cardinality + 1)).astype(np.int64)
    return doc_of_entry[order].astype(np.int32), offsets


class InvertedIndexWriter:
    @staticmethod
    def write(seg_dir: str, col: str, ids: np.ndarray, cardinality: int) -> None:
        docids, offsets = build_inverted_csr(
            ids, np.arange(len(ids)), cardinality)
        np.save(os.path.join(seg_dir, fmt.INV_DOCIDS.format(col=col)),
                docids)
        np.save(os.path.join(seg_dir, fmt.INV_OFFSETS.format(col=col)),
                offsets)


class InvertedIndexReader:
    """CSR postings: docids[offsets[v]:offsets[v+1]] = sorted docs with value v."""

    def __init__(self, docids: np.ndarray, offsets: np.ndarray, num_docs: int):
        self.docids = docids
        self.offsets = offsets
        self.num_docs = num_docs

    @classmethod
    def load(cls, seg_dir, col: str, num_docs: int) -> "InvertedIndexReader":
        d = fmt.open_dir(seg_dir)
        docids = np.asarray(d.load_array(fmt.INV_DOCIDS.format(col=col)))
        offsets = np.asarray(d.load_array(fmt.INV_OFFSETS.format(col=col)))
        return cls(docids, offsets, num_docs)

    def postings(self, dict_id: int) -> np.ndarray:
        return self.docids[self.offsets[dict_id]:self.offsets[dict_id + 1]]

    def count(self, dict_id: int) -> int:
        return int(self.offsets[dict_id + 1] - self.offsets[dict_id])

    def count_range(self, lo: int, hi: int) -> int:
        """Total postings for dictIds in [lo, hi) — O(1) from offsets."""
        return int(self.offsets[hi] - self.offsets[lo])
