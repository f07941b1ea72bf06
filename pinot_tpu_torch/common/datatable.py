"""DataTable: the server→broker result wire format.

Parity: pinot-common/.../utils/DataTable.java + DataTableImplV2.java:40-263 —
version, metadata map, exceptions, schema (column names/types), row payload.

Three wire versions, negotiated by the leading version tag (decode handles
all of them; encode defaults to the newest):

- v1: per-row tagged object serde (one `_w_obj` per row tuple) — the
  original format, kept decodable so payloads from version-skewed servers
  still reduce.
- v2: COLUMNAR — the row payload is split into per-column blocks, like
  DataTableImplV2's fixed-size/variable-size regions. Homogeneous int64 /
  float64 / string columns serialize as fixed-width big-endian numpy
  buffers (plus a var-width utf-8 region for strings); anything else
  (pairs, sketches, sets, mixed types) falls back to one tagged object
  list per column.
- v3: ZERO-COPY columnar — same column-block layout as v2, but numeric
  blocks travel little-endian (the native order of every deployment
  target), so the decoder can hand back `np.frombuffer` VIEWS over the
  frame buffer with no byteswap and **no per-row tuple
  materialization**: a decoded v3 table carries per-column arrays
  (`col_data`) and only materializes row tuples if a legacy consumer
  asks for `.rows`. The broker combine/reduce path consumes the column
  blocks directly (vectorized numpy folds — query/combine.py).

Aliasing contract (v3 decode): a numeric column may alias the input
frame ONLY when the input is an immutable `bytes` object (or a read-only
memoryview over one) — the array then owns a reference that keeps the
frame alive. Any writable source (bytearray, shared-memory buffer, a
reused frame arena) is copied column-block-wise at memcpy cost, so
decoder output is never invalidated by frame-buffer reuse.

Three logical layouts mirror IntermediateResultsBlock's payloads:
- aggregation-only: one row, one object cell per aggregation function
- group-by: one row per group, key columns + intermediate object columns
- selection: one row per selected doc
"""
from __future__ import annotations

import struct
from typing import Dict, List, Optional

import numpy as np

from pinot_tpu_torch.common.request import BrokerRequest
from pinot_tpu_torch.common.serde import obj_from_bytes, obj_to_bytes
from pinot_tpu_torch.query.blocks import ExecutionStats, IntermediateResultsBlock

_U32 = struct.Struct(">I")
VERSION = 3
_V2_VERSION = 2
_LEGACY_VERSION = 1
_ALL_VERSIONS = (_LEGACY_VERSION, _V2_VERSION, VERSION)

KIND_EMPTY = 0
KIND_AGGREGATION = 1
KIND_GROUP_BY = 2
KIND_SELECTION = 3

# v2/v3 column-block tags (byte order of the numeric blocks is decided
# by the frame's version tag: v2 big-endian, v3 little-endian/native)
_COL_I64 = b"L"      # int64 fixed-width block
_COL_F64 = b"F"      # float64 fixed-width block
_COL_STR = b"S"      # u32 offsets (fixed region) + utf-8 blob (var region)
_COL_OBJ = b"O"      # tagged object list fallback

# Structured metadata key carrying the JSON list of segments a server was
# asked for but does not host; the broker keys its one-shot re-dispatch off
# this (not off parsing exception strings, which can drift independently).
MISSING_SEGMENTS_KEY = "missingSegments"
# Human-facing exception prefix for the same condition — shared so the
# server format and the broker's partial-response surface stay in sync.
SEGMENT_MISSING_EXC_PREFIX = "SegmentMissingError:"
# Structured metadata keys for server admission control: a shed request
# answers with SERVER_BUSY_KEY = the shed cause ("overload" | "hedge" |
# "tenantOverQuota" | "deadline" | "capacity") and RETRY_AFTER_MS_KEY =
# an estimate of when the queue will have drained. The router treats a
# busy reply as non-retriable on the SAME server (failover only).
SERVER_BUSY_KEY = "serverBusy"
RETRY_AFTER_MS_KEY = "retryAfterMs"
SERVER_BUSY_EXC_PREFIX = "ServerBusyError:"
# Metadata marker on replies served from the server result cache.
RESULT_CACHE_HIT_KEY = "resultCacheHit"
# Structured marker for multi-stage compile errors (join key type
# mismatch, non-unique dim keys, window overflow, exchange capacity):
# the value is a short machine kind, the human message rides in
# exceptions. The broker maps these to 4xx errorCodes — deterministic
# query properties, never retried as server faults.
STAGE_ERROR_KEY = "stageError"


def _col_to_list(col) -> list:
    if isinstance(col, np.ndarray):
        return col.tolist()  # tpulint: disable=host-sync -- numpy host array, not a device value
    return list(col)


class DataTable:
    """One server's serialized result payload.

    `col_data`, when set, is the columnar truth: a list with one entry
    per column, each a numpy array (i64/f64) or a python list (str /
    object cells). `.rows` materializes tuples from it lazily — the v3
    hot path (broker combine/reduce) never touches `.rows` at all.
    """

    __slots__ = ("kind", "columns", "num_group_cols", "metadata",
                 "exceptions", "col_data", "_rows", "cache_states")

    def __init__(self, kind: int = KIND_EMPTY,
                 columns: Optional[List[str]] = None,
                 rows: Optional[List[tuple]] = None,
                 num_group_cols: int = 0,
                 metadata: Optional[Dict[str, str]] = None,
                 exceptions: Optional[List[str]] = None,
                 col_data: Optional[list] = None):
        self.kind = kind
        self.columns: List[str] = list(columns) if columns else []
        self.num_group_cols = num_group_cols
        self.metadata: Dict[str, str] = metadata if metadata is not None \
            else {}
        self.exceptions: List[str] = exceptions if exceptions is not None \
            else []
        self.col_data = col_data
        self._rows = rows if rows is not None else \
            (None if col_data is not None else [])
        # set by the server execution path (segment CRC states the
        # result cache keys on); never serialized
        self.cache_states = None

    @property
    def rows(self) -> List[tuple]:
        if self._rows is None:
            cols = self.col_data or []
            self._rows = list(zip(*[_col_to_list(c) for c in cols])) \
                if cols else []
        return self._rows

    @rows.setter
    def rows(self, value) -> None:
        # hand-assigned rows supersede any decoded column blocks
        self._rows = value
        self.col_data = None

    def num_rows(self) -> int:
        if self._rows is not None:
            return len(self._rows)
        cols = self.col_data or []
        return len(cols[0]) if cols else 0

    # -- wire format -------------------------------------------------------
    def to_bytes(self, version: int = VERSION) -> bytes:
        out = bytearray()
        out += _U32.pack(version)
        out += bytes([self.kind])
        out += _U32.pack(self.num_group_cols)
        _w_obj(out, self.metadata)
        _w_obj(out, list(self.exceptions))
        _w_obj(out, list(self.columns))
        if version == _LEGACY_VERSION:
            rows = self.rows
            out += _U32.pack(len(rows))
            for row in rows:
                _w_obj(out, tuple(row))
        elif version in (_V2_VERSION, VERSION):
            if self._rows is None and self.col_data is not None:
                # columnar producer (or a decoded table re-encoded
                # untouched): write straight from the column blocks
                _write_columnar_cols(out, self.col_data, version)
            else:
                _write_columnar(out, self.rows, version)
        else:
            raise ValueError(f"unsupported DataTable version {version}")
        return bytes(out)

    @classmethod
    def from_bytes(cls, b) -> "DataTable":
        """`b`: any buffer (bytes / bytearray / memoryview). v3 numeric
        columns are zero-copy views when `b` is immutable bytes."""
        if not isinstance(b, (bytes, memoryview)):
            b = memoryview(b)
        off = 0
        version = _U32.unpack_from(b, off)[0]
        off += 4
        if version not in _ALL_VERSIONS:
            raise ValueError(f"unsupported DataTable version {version}")
        kind = b[off]
        off += 1
        num_group_cols = _U32.unpack_from(b, off)[0]
        off += 4
        metadata, off = _r_obj(b, off)
        exceptions, off = _r_obj(b, off)
        columns, off = _r_obj(b, off)
        rows = None
        col_data = None
        if version == _LEGACY_VERSION:
            n_rows = _U32.unpack_from(b, off)[0]
            off += 4
            rows = []
            for _ in range(n_rows):
                row, off = _r_obj(b, off)
                rows.append(row)
        elif version == _V2_VERSION:
            rows, off = _read_columnar_v2(b, off)
        else:
            col_data, rows, off = _read_columnar_v3(b, off)
        return cls(kind=kind, columns=list(columns), rows=rows,
                   num_group_cols=num_group_cols,
                   metadata=dict(metadata), exceptions=list(exceptions),
                   col_data=col_data)

    # -- block conversion --------------------------------------------------
    @classmethod
    def from_block(cls, request: BrokerRequest,
                   block: IntermediateResultsBlock) -> "DataTable":
        dt = cls(metadata=block.stats.to_metadata(),
                 exceptions=list(block.exceptions))
        dt.metadata["timeUsedMs"] = f"{block.stats.time_used_ms:.3f}"
        if block.execution_path is not None:
            dt.metadata["executionPath"] = block.execution_path
        # numpy-scalar normalization happens inside serde._write_obj (and
        # the columnar writer), so rows can carry intermediates as-is
        if block.group_map is not None or block.group_cols is not None:
            dt.kind = KIND_GROUP_BY
            gcols = request.group_by.columns if request.group_by else []
            dt.num_group_cols = len(gcols)
            dt.columns = list(gcols) + [a.call for a in request.aggregations]
            if block.group_map is not None:
                dt.rows = [key + tuple(inters)
                           for key, inters in block.group_map.items()]
            else:
                key_cols, inter_cols = block.group_cols
                dt.col_data = list(key_cols) + list(inter_cols)
                dt._rows = None
        elif block.agg_intermediates is not None:
            dt.kind = KIND_AGGREGATION
            dt.columns = [a.call for a in request.aggregations]
            dt.rows = [tuple(block.agg_intermediates)]
        elif block.selection_rows is not None or \
                block.selection_cols is not None:
            dt.kind = KIND_SELECTION
            dt.columns = list(block.selection_columns or [])
            if block.selection_cols is not None:
                dt.col_data = list(block.selection_cols)
                dt._rows = None
            else:
                # selection rows are already tuples on the execution
                # path — re-tupling every row was pure churn at scale
                dt.rows = [r if type(r) is tuple else tuple(r)
                           for r in block.selection_rows]
            if block.selection_display_cols is not None:
                # trailing ORDER-BY-only columns: the broker needs the
                # display split to trim after its cross-server merge
                dt.metadata["selectionDisplayCols"] = str(
                    block.selection_display_cols)
        return dt

    def to_block(self) -> IntermediateResultsBlock:
        blk = IntermediateResultsBlock(exceptions=list(self.exceptions))
        blk.stats = _stats_from_metadata(self.metadata)
        if self.kind == KIND_GROUP_BY:
            g = self.num_group_cols
            if self.col_data is not None and self._rows is None:
                # columnar payload stays columnar: combine/reduce run
                # vectorized folds, never per-row dict inserts
                blk.group_cols = (self.col_data[:g], self.col_data[g:])
            else:
                # rows are tuples on every decode path, so tuple() here
                # is a no-op identity check, not a copy (it only
                # materializes for hand-built list rows)
                blk.group_map = {tuple(row[:g]): list(row[g:])
                                 for row in self.rows}
        elif self.kind == KIND_AGGREGATION:
            blk.agg_intermediates = list(self.rows[0]) if self.rows \
                else None
        elif self.kind == KIND_SELECTION:
            if self.col_data is not None and self._rows is None:
                blk.selection_cols = list(self.col_data)
            else:
                blk.selection_rows = [r if type(r) is tuple else tuple(r)
                                      for r in self.rows]
            blk.selection_columns = list(self.columns)
            n = self.metadata.get("selectionDisplayCols")
            if n is not None:
                blk.selection_display_cols = int(n)
        return blk


def _stats_from_metadata(md: Dict[str, str]) -> ExecutionStats:
    def gi(k):
        return int(md.get(k, "0"))

    return ExecutionStats(
        num_docs_scanned=gi("numDocsScanned"),
        num_entries_scanned_in_filter=gi("numEntriesScannedInFilter"),
        num_entries_scanned_post_filter=gi("numEntriesScannedPostFilter"),
        num_segments_processed=gi("numSegmentsProcessed"),
        num_segments_matched=gi("numSegmentsMatched"),
        total_docs=gi("totalDocs"),
        num_groups_limit_reached=md.get("numGroupsLimitReached") == "true",
        num_consuming_segments_processed=gi("numConsumingSegmentsProcessed"),
        min_consuming_freshness_ms=gi("minConsumingFreshnessTimeMs"),
        time_used_ms=float(md.get("timeUsedMs", "0")))


# ---------------------------------------------------------------------------
# v2/v3 columnar payload
# ---------------------------------------------------------------------------

_I64_MIN, _I64_MAX = -(2 ** 63), 2 ** 63 - 1


def _is_i64(v) -> bool:
    if type(v) is int:                      # excludes bool
        return _I64_MIN <= v <= _I64_MAX
    return isinstance(v, np.integer)


def _is_f64(v) -> bool:
    return type(v) is float or isinstance(v, np.floating)


def _i64_dtype(version: int) -> str:
    return "<i8" if version == VERSION else ">i8"


def _f64_dtype(version: int) -> str:
    return "<f8" if version == VERSION else ">f8"


def _u32_dtype(version: int) -> str:
    return "<u4" if version == VERSION else ">u4"


def _write_columnar(out: bytearray, rows: List[tuple],
                    version: int) -> None:
    n_rows = len(rows)
    n_cols = len(rows[0]) if rows else 0
    out += _U32.pack(n_rows)
    out += _U32.pack(n_cols)
    if not n_rows or not n_cols:
        return
    for col in zip(*rows):
        _write_column(out, col, version)


def _write_columnar_cols(out: bytearray, cols: list, version: int) -> None:
    """Encode straight from column blocks (a columnar producer or a
    decoded-and-untouched table) — no row materialization at all."""
    n_rows = len(cols[0]) if cols else 0
    out += _U32.pack(n_rows)
    out += _U32.pack(len(cols))
    if not n_rows or not cols:
        return
    for col in cols:
        if isinstance(col, np.ndarray) and col.dtype.kind == "i":
            out += _COL_I64
            out += np.ascontiguousarray(
                col, dtype=_i64_dtype(version)).tobytes()
        elif isinstance(col, np.ndarray) and col.dtype.kind == "f":
            out += _COL_F64
            out += np.ascontiguousarray(
                col, dtype=_f64_dtype(version)).tobytes()
        else:
            _write_column(out, col, version)


def _write_column(out: bytearray, col, version: int) -> None:
    if all(_is_i64(v) for v in col):
        out += _COL_I64
        out += np.asarray(col, dtype=_i64_dtype(version)).tobytes()
    elif all(_is_f64(v) for v in col):
        out += _COL_F64
        out += np.asarray(col, dtype=_f64_dtype(version)).tobytes()
    elif all(type(v) is str for v in col):
        encoded = [v.encode("utf-8") for v in col]
        offsets = np.zeros(len(col) + 1, dtype=_u32_dtype(version))
        np.cumsum([len(e) for e in encoded], out=offsets[1:])
        blob = b"".join(encoded)
        out += _COL_STR
        out += _U32.pack(len(blob))
        out += offsets.tobytes()
        out += blob
    else:
        # heterogeneous / complex cells (pairs, sketches, None, bool,
        # bigint, bytes): one tagged object list for the whole column —
        # still no per-ROW tuple headers
        out += _COL_OBJ
        _w_obj(out, list(col))


def _read_columnar_v2(b, off: int):
    n_rows = _U32.unpack_from(b, off)[0]
    off += 4
    n_cols = _U32.unpack_from(b, off)[0]
    off += 4
    if not n_rows or not n_cols:
        return [() for _ in range(n_rows)], off
    cols = []
    for _ in range(n_cols):
        col, off = _read_column(b, off, n_rows, _V2_VERSION)
        cols.append(_col_to_list(col))
    return list(zip(*cols)), off


def _read_columnar_v3(b, off: int):
    """→ (col_data, off): per-column arrays/lists, NO row tuples."""
    n_rows = _U32.unpack_from(b, off)[0]
    off += 4
    n_cols = _U32.unpack_from(b, off)[0]
    off += 4
    if not n_cols:
        # zero-width rows cannot be represented columnar; degenerate
        # and rare, so hand back row tuples directly
        return None, [() for _ in range(n_rows)], off
    cols: list = []
    if not n_rows:
        return [[] for _ in range(n_cols)], None, off
    for _ in range(n_cols):
        col, off = _read_column(b, off, n_rows, VERSION)
        cols.append(col)
    return cols, None, off


def _aliasable(buf) -> bool:
    """May decoded arrays alias this buffer? Only when it is immutable
    AND the array will hold a reference that keeps it alive — i.e. a
    real `bytes` object (or a read-only view over one). A writable
    source (bytearray, mmap, shared memory arena) can be reused or
    unmapped under the decoded table, so its blocks must be copied."""
    if isinstance(buf, bytes):
        return True
    return isinstance(buf, memoryview) and buf.readonly and \
        isinstance(buf.obj, bytes)


def _read_numeric(b, off: int, n: int, dtype: str):
    arr = np.frombuffer(b, dtype=dtype, count=n, offset=off)
    if not _aliasable(b):
        arr = arr.copy()
    return arr, off + n * 8


def _read_column(b, off: int, n: int, version: int):
    tag = bytes(b[off:off + 1])
    off += 1
    if tag == _COL_I64:
        return _read_numeric(b, off, n, _i64_dtype(version))
    if tag == _COL_F64:
        return _read_numeric(b, off, n, _f64_dtype(version))
    if tag == _COL_STR:
        blob_len = _U32.unpack_from(b, off)[0]
        off += 4
        offsets = np.frombuffer(b, dtype=_u32_dtype(version), count=n + 1,
                                offset=off)
        off += (n + 1) * 4
        blob = bytes(b[off:off + blob_len])
        off += blob_len
        return [str(blob[offsets[i]:offsets[i + 1]], "utf-8")
                for i in range(n)], off
    if tag == _COL_OBJ:
        col, off = _r_obj(b, off)
        return col, off
    raise ValueError(f"bad DataTable column tag {tag!r} at {off - 1}")


def amend_metadata_bytes(b: bytes, updates: Dict[str, str]) -> bytes:
    """Rewrite ONLY the metadata map of a serialized DataTable.

    The server result-cache hit path stamps per-request keys
    (requestId, resultCacheHit) onto cached payloads; a full
    from_bytes/to_bytes round-trip there decodes and re-encodes every
    row — burning, on multi-MB selection results, exactly the CPU the
    cache exists to save under overload. The metadata map sits at a
    fixed offset right after the 9-byte header, so it can be spliced
    at memcpy cost without touching exceptions/schema/rows."""
    version = _U32.unpack_from(b, 0)[0]
    if version not in _ALL_VERSIONS:
        raise ValueError(f"unsupported DataTable version {version}")
    off = 9                   # version(4) + kind(1) + numGroupCols(4)
    metadata, end = _r_obj(b, off)
    md = dict(metadata)
    md.update(updates)
    out = bytearray(b[:off])
    _w_obj(out, md)
    out += b[end:]
    return bytes(out)


def _w_obj(out: bytearray, v) -> None:
    b = obj_to_bytes(v)
    out += _U32.pack(len(b))
    out += b


def _r_obj(b, off: int):
    n = _U32.unpack_from(b, off)[0]
    off += 4
    return obj_from_bytes(b[off:off + n]), off + n
