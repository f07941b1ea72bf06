"""Mutable (consuming) segment: append rows, query concurrently.

Parity: pinot-core/.../indexsegment/mutable/MutableSegmentImpl.java:64-198 —
per-column mutable dictionary (ARRIVAL order: ids must stay stable as values
arrive, so unlike immutable segments the dictionary is unsorted) + growable
fixed-width forward indexes; queries snapshot (num_docs, lanes[:n]) without
blocking the writer. Device serving: a PERIODIC SORTED SNAPSHOT freezes the
row prefix into a standard in-memory ImmutableSegment (sorted dictionaries,
remapped id lanes) so the TPU kernels serve the bulk of a consuming segment,
with only the post-freeze tail on the host executor (see device_view); on
commit RealtimeSegmentConverter re-sorts everything into a standard
immutable segment (RealtimeSegmentConverter.java:85-129).

The port's copy of pinot_tpu/realtime/mutable_segment.py. What differs:
the frozen prefix is the port's in-memory ImmutableSegment
(segment/loader.py), bound to the device the consuming segment was bound
to with `to` (QueryEngine binds it), so its lanes upload there on first
use, the upsert liveness lane among them; `freezes` and
`last_freeze_seconds` count the rebuilds and time the last one (host
work only: the uploads come with the first query that reads the lanes);
MV rows are padded into their id matrix with array ops (`_pad_mv`), not
row by row.
"""
from __future__ import annotations

import itertools
import threading
import time
from typing import Dict, List, Optional

import numpy as np

from pinot_tpu_torch.common.datatype import DataType
from pinot_tpu_torch.common.schema import FieldSpec, Schema
from pinot_tpu_torch.common.table_config import TableConfig
from pinot_tpu_torch.segment.metadata import ColumnMetadata, SegmentMetadata


def _pad_mv(rows, card: int, remap: Optional[np.ndarray] = None
            ) -> np.ndarray:
    """MV rows (lists of dictIds) as an int32 [len(rows), W] matrix padded
    with `card`, W the widest row (at least 1); `remap` maps every id
    first. The per-row Python loop it replaces took 85% of a consuming
    tail's host query time."""
    lens = np.fromiter(map(len, rows), np.int64, len(rows))
    width = max(int(lens.max()) if len(rows) else 1, 1)
    out = np.full((len(rows), width), card, dtype=np.int32)
    flat = np.fromiter(itertools.chain.from_iterable(rows), np.int32,
                       int(lens.sum()))
    out[np.arange(width)[None, :] < lens[:, None]] = \
        flat if remap is None else remap[flat]
    return out


class MutableDictionary:
    """Arrival-order dictionary: id = insertion rank (stable)."""

    is_sorted = False

    def __init__(self, data_type: DataType):
        self.data_type = data_type
        self._values: List = []
        self._index: Dict = {}  # tpulint: disable=cache-bound -- the dictionary IS the data: bounded by the segment-size seal threshold, frozen at commit
        self._np_cache: Optional[np.ndarray] = None

    @property
    def cardinality(self) -> int:
        return len(self._values)

    def __len__(self) -> int:
        return len(self._values)

    @property
    def values(self) -> np.ndarray:
        if self._np_cache is None or len(self._np_cache) != len(self._values):
            dtype = self.data_type.np_dtype if self.data_type.is_numeric \
                else object
            self._np_cache = np.array(self._values, dtype=dtype)
        return self._np_cache

    def index_of(self, value) -> int:
        v = self._coerce(value)
        return self._index.get(v, -1)

    def index_of_many(self, values) -> np.ndarray:
        return np.array([self.index_of(v) for v in values], dtype=np.int32)

    def index_of_or_add(self, value) -> int:
        v = self._coerce(value)
        i = self._index.get(v)
        if i is None:
            i = len(self._values)
            self._values.append(v)
            self._index[v] = i
        return i

    def add_many(self, values, coerced: bool = False) -> np.ndarray:
        """Batch index_of_or_add: one tight loop (no per-value method
        dispatch), int32 ids out — the consuming path's hot loop.
        `coerced=True` skips _coerce for values already normalized by
        FieldSpec.convert (idempotent with _coerce for every type)."""
        out = np.empty(len(values), np.int32)
        idx = self._index
        vals = self._values
        coerce = None if coerced else self._coerce
        for i, v in enumerate(values):
            if coerce is not None:
                v = coerce(v)
            j = idx.get(v)
            if j is None:
                j = len(vals)
                vals.append(v)
                idx[v] = j
            out[i] = j
        return out

    def get(self, dict_id: int):
        return self._values[dict_id]

    def decode(self, dict_ids: np.ndarray) -> np.ndarray:
        return self.values[dict_ids]

    def _coerce(self, value):
        if self.data_type.is_numeric:
            try:
                return int(str(value)) if \
                    self.data_type.np_dtype.kind in "iu" else float(value)
            except ValueError:
                return float(value)
        if self.data_type == DataType.BYTES:
            return value if isinstance(value, bytes) \
                else bytes.fromhex(str(value))
        return str(value)

    @property
    def min_value(self):
        return min(self._values) if self._values else None

    @property
    def max_value(self):
        return max(self._values) if self._values else None


class _GrowableArray:
    """Append-only numpy array with capacity doubling; reads of [:n] are
    stable because growth copies into a NEW buffer (readers keep slicing a
    consistent snapshot)."""

    def __init__(self, dtype, capacity: int = 4096):
        self._arr = np.zeros(capacity, dtype=dtype)
        self.n = 0

    def append(self, v) -> None:
        # direct scalar write: this is the HLC per-row ingest path, so
        # it must not pay extend()'s slice machinery per value — the
        # single-writer invariant is stated in the suppressions instead
        if self.n == len(self._arr):
            bigger = np.zeros(len(self._arr) * 2, dtype=self._arr.dtype)
            bigger[: self.n] = self._arr
            self._arr = bigger  # tpulint: disable=concurrency -- single consumer-thread writer (all call sites run under MutableSegmentImpl._lock); readers slice stable [:n] snapshots of the previous buffer
        self._arr[self.n] = v  # tpulint: disable=concurrency -- same single-writer invariant; the cell is beyond every published snapshot until n moves
        self.n += 1  # tpulint: disable=concurrency -- same single-writer invariant: n publishes AFTER the cell write, readers never observe unwritten rows

    def extend(self, arr) -> None:
        """Vectorized append of a whole batch (same reader contract:
        rows past the published n are never observed; growth copies
        into a new buffer)."""
        need = self.n + len(arr)
        if need > len(self._arr):
            cap = len(self._arr)
            while cap < need:
                cap *= 2
            bigger = np.zeros(cap, dtype=self._arr.dtype)
            bigger[: self.n] = self._arr[: self.n]
            self._arr = bigger  # tpulint: disable=concurrency -- same single-writer invariant as append(): growth publishes a fully-copied buffer
        self._arr[self.n: need] = arr  # tpulint: disable=concurrency -- same single-writer invariant; rows land beyond every published n
        self.n = need  # tpulint: disable=concurrency -- same single-writer invariant: n publishes after the batch write

    def snapshot(self, n: int) -> np.ndarray:
        return self._arr[:n]


class _GrowableMatrix:
    """Append-only [n, dim] float32 matrix with capacity doubling — the
    consuming-side vector forward block. Same reader contract as
    _GrowableArray: growth copies into a NEW buffer, rows land beyond
    every published n, so [:n] snapshots stay stable."""

    def __init__(self, dim: int, capacity: int = 4096):
        self._arr = np.zeros((capacity, dim), np.float32)
        self.n = 0

    def extend(self, rows: np.ndarray) -> None:
        need = self.n + len(rows)
        if need > len(self._arr):
            cap = len(self._arr)
            while cap < need:
                cap *= 2
            bigger = np.zeros((cap, self._arr.shape[1]), np.float32)
            bigger[: self.n] = self._arr[: self.n]
            self._arr = bigger  # tpulint: disable=concurrency -- single consumer-thread writer (same invariant as _GrowableArray): growth publishes a fully-copied buffer
        self._arr[self.n: need] = rows  # tpulint: disable=concurrency -- same single-writer invariant; rows land beyond every published n
        self.n = need  # tpulint: disable=concurrency -- same single-writer invariant: n publishes after the row writes

    def snapshot(self, n: int) -> np.ndarray:
        return self._arr[:n]


class _MutableDataSource:
    """DataSource-compatible column view over mutable storage."""

    def __init__(self, field: FieldSpec, has_dictionary: bool,
                 initial_capacity: int = 4096):
        self.field = field
        self.is_vector = field.data_type == DataType.VECTOR
        self.has_dictionary = has_dictionary and not self.is_vector
        self.dictionary = MutableDictionary(field.data_type) \
            if self.has_dictionary else None
        self.inverted_index = None
        self.bloom_filter = None
        self.sorted_ranges = None
        self._vec: Optional[_GrowableMatrix] = None
        if self.is_vector:
            self._vec = _GrowableMatrix(field.vector_dimension,
                                        capacity=initial_capacity)
            self._sv = None
            self._mv: Optional[List[List[int]]] = None
        elif field.single_value:
            dtype = np.int32 if self.has_dictionary \
                else field.data_type.np_dtype
            self._sv = _GrowableArray(dtype, capacity=initial_capacity)
            self._mv = None
        else:
            self._sv = None
            self._mv = []
        self._snapshot_n = 0
        self._mv_cache: Optional[np.ndarray] = None

    # -- write path --------------------------------------------------------
    def add(self, value) -> None:
        f = self.field
        if self.is_vector:
            self._vec.extend(f.convert(value)[None])
        elif f.single_value:
            v = f.convert(value)
            if self.has_dictionary:
                self._sv.append(self.dictionary.index_of_or_add(v))
            else:
                self._sv.append(v)
        else:
            vs = value if isinstance(value, (list, tuple)) else (
                [] if value is None else [value])
            converted = [f.convert(x) for x in vs] or [f.default_null_value]
            self._mv.append([self.dictionary.index_of_or_add(x)
                             for x in converted])

    def add_many(self, values: list) -> None:
        """Batch write path (one listcomp/array op per column instead of
        per-row python dispatch — the consume loop's 2x)."""
        f = self.field
        if self.is_vector:
            self._vec.extend(np.stack([f.convert(v) for v in values])
                             if values else
                             np.zeros((0, f.vector_dimension), np.float32))
            return
        if not f.single_value:
            for v in values:
                self.add(v)
            return
        if self.has_dictionary:
            conv = f.convert
            self._sv.extend(self.dictionary.add_many(
                [conv(v) for v in values], coerced=True))
        else:
            self._sv.extend(np.asarray(
                [f.convert(v) for v in values],
                dtype=f.data_type.np_dtype))

    # -- read path (snapshot at n docs) ------------------------------------
    def bind(self, n: int) -> "_MutableDataSource":
        self._snapshot_n = n
        return self

    @property
    def metadata(self) -> ColumnMetadata:
        card = self.dictionary.cardinality if self.has_dictionary else \
            self._snapshot_n
        return ColumnMetadata(
            name=self.field.name, data_type=self.field.data_type,
            cardinality=card,
            bits_per_element=max(1, int(np.ceil(np.log2(max(card, 2))))),
            single_value=self.field.single_value, sorted=False,
            has_dictionary=self.has_dictionary,
            min_value=self.dictionary.min_value if self.has_dictionary
            else None,
            max_value=self.dictionary.max_value if self.has_dictionary
            else None,
            total_number_of_entries=self._snapshot_n,
            vector_dimension=self.field.vector_dimension)

    @property
    def dict_ids(self) -> Optional[np.ndarray]:
        if self._sv is None or not self.has_dictionary:
            return None
        return self._sv.snapshot(self._snapshot_n)

    @property
    def raw_values(self) -> Optional[np.ndarray]:
        if self._sv is None or self.has_dictionary:
            return None
        return self._sv.snapshot(self._snapshot_n)

    @property
    def vec_values(self) -> Optional[np.ndarray]:
        if self._vec is None:
            return None
        return self._vec.snapshot(self._snapshot_n)

    @property
    def mv_dict_ids(self) -> Optional[np.ndarray]:
        if self._mv is None:
            return None
        n = self._snapshot_n
        if self._mv_cache is not None and len(self._mv_cache) == n:
            return self._mv_cache
        out = _pad_mv(self._mv[:n], self.dictionary.cardinality)
        self._mv_cache = out
        return out

    def raw_column(self, n: int):
        """Decoded values for the segment converter."""
        if self._vec is not None:
            # 2-D float32 block: the creator's VECTOR branch takes it
            return np.array(self._vec.snapshot(n), copy=True)
        if self._mv is not None:
            return [[self.dictionary.get(i) for i in r]
                    for r in self._mv[:n]]
        arr = self._sv.snapshot(n)
        if self.has_dictionary:
            return list(self.dictionary.decode(arr))
        return list(arr)


class _SnapshotDictionary:
    """Dictionary view pinned at a cardinality: values added after the
    snapshot are invisible (index_of returns -1 for them)."""

    is_sorted = False

    def __init__(self, inner: MutableDictionary, cardinality: int):
        self._inner = inner
        self.cardinality = cardinality
        self.data_type = inner.data_type

    def __len__(self) -> int:
        return self.cardinality

    @property
    def values(self) -> np.ndarray:
        return self._inner.values[: self.cardinality]

    def index_of(self, value) -> int:
        i = self._inner.index_of(value)
        return i if i < self.cardinality else -1

    def index_of_many(self, values) -> np.ndarray:
        return np.array([self.index_of(v) for v in values], dtype=np.int32)

    def get(self, dict_id: int):
        return self._inner.get(dict_id)

    def decode(self, dict_ids: np.ndarray) -> np.ndarray:
        return self.values[dict_ids]

    @property
    def min_value(self):
        vals = self._inner._values[: self.cardinality]
        return min(vals) if vals else None

    @property
    def max_value(self):
        vals = self._inner._values[: self.cardinality]
        return max(vals) if vals else None


class _SnapshotSource:
    """Point-in-time column view: doc count AND dictionary cardinality are
    pinned at snapshot creation, so every access within one query sees the
    same rows (the writer keeps appending concurrently). `start` slices a
    TAIL window [start, n) for the hybrid frozen+tail serving mode."""

    def __init__(self, ds: _MutableDataSource, n: int, start: int = 0):
        self._ds = ds
        self._n = n
        self._start = start
        self.field = ds.field
        self.has_dictionary = ds.has_dictionary
        self.dictionary = _SnapshotDictionary(
            ds.dictionary, ds.dictionary.cardinality) \
            if ds.has_dictionary else None
        self.inverted_index = None
        self.bloom_filter = None
        self.sorted_ranges = None
        self._mv_cache: Optional[np.ndarray] = None

    @property
    def metadata(self) -> ColumnMetadata:
        card = self.dictionary.cardinality if self.has_dictionary \
            else self._n - self._start
        return ColumnMetadata(
            name=self.field.name, data_type=self.field.data_type,
            cardinality=card,
            bits_per_element=max(1, int(np.ceil(np.log2(max(card, 2))))),
            single_value=self.field.single_value, sorted=False,
            has_dictionary=self.has_dictionary,
            min_value=self.dictionary.min_value if self.has_dictionary
            else None,
            max_value=self.dictionary.max_value if self.has_dictionary
            else None,
            total_number_of_entries=self._n - self._start,
            vector_dimension=self.field.vector_dimension)

    @property
    def dict_ids(self) -> Optional[np.ndarray]:
        if self._ds._sv is None or not self.has_dictionary:
            return None
        return self._ds._sv.snapshot(self._n)[self._start:]

    @property
    def raw_values(self) -> Optional[np.ndarray]:
        if self._ds._sv is None or self.has_dictionary:
            return None
        return self._ds._sv.snapshot(self._n)[self._start:]

    @property
    def vec_values(self) -> Optional[np.ndarray]:
        if self._ds._vec is None:
            return None
        return self._ds._vec.snapshot(self._n)[self._start:]

    @property
    def mv_dict_ids(self) -> Optional[np.ndarray]:
        if self._ds._mv is None:
            return None
        if self._mv_cache is None:
            self._mv_cache = _pad_mv(self._ds._mv[self._start: self._n],
                                     self.dictionary.cardinality)
        return self._mv_cache


class MutableSegmentView:
    """Frozen (num_docs, cardinalities) view of a consuming segment — what
    one query executes against. Parity: the reference snapshots the doc
    count once per query (MutableSegmentImpl readers index up to a captured
    numDocsIndexed); here the whole column view is pinned.

    `start` > 0 makes this a TAIL view (rows [start, num_docs)) — the
    un-snapshotted remainder served host-side next to a frozen device
    snapshot of rows [0, start)."""

    is_mutable = True

    def __init__(self, impl: "MutableSegmentImpl", start: int = 0):
        self._impl = impl
        self.segment_name = impl.segment_name if start == 0 else \
            f"{impl.segment_name}__tail"
        self.schema = impl.schema
        self.start = start
        self.num_docs = impl._num_docs - start
        self._sources: Dict[str, _SnapshotSource] = {}  # tpulint: disable=cache-bound -- bounded by the schema's column count; dies with the snapshot view
        # upsert validDocIds: PIN the liveness mask for this view's rows
        # at snapshot time, so the filter mask and every column lane
        # agree even while the upsert fold keeps invalidating docs
        vd = impl.valid_doc_ids
        self.valid_doc_mask = None if vd is None or not vd.num_invalid \
            else vd.valid_mask(start, start + self.num_docs)

    @property
    def padded_docs(self) -> int:
        from pinot_tpu_torch.segment.loader import padded_size
        return padded_size(max(self.num_docs, 1))

    @property
    def column_names(self) -> List[str]:
        return list(self._impl._sources.keys())

    def has_column(self, column: str) -> bool:
        return column in self._impl._sources

    def data_source(self, column: str) -> _SnapshotSource:
        src = self._sources.get(column)
        if src is None:
            src = _SnapshotSource(self._impl._sources[column],
                                  self.start + self.num_docs,
                                  start=self.start)
            self._sources[column] = src
        return src

    @property
    def metadata(self) -> SegmentMetadata:
        tc = self.schema.time_column
        return SegmentMetadata(
            segment_name=self.segment_name,
            table_name=self._impl.table_config.table_name,
            total_docs=self.num_docs,
            columns={name: self.data_source(name).metadata
                     for name in self.column_names},
            time_column=tc.name if tc else None,
            time_unit=tc.time_unit.name if tc else None,
            start_time=self._impl._start_time,
            end_time=self._impl._end_time,
            creation_time_ms=self._impl.creation_time_ms)


class MutableSegmentImpl:
    """The consuming segment: single writer, many reader snapshots."""

    is_mutable = True

    def __init__(self, schema: Schema, table_config: TableConfig,
                 segment_name: str, stats_hint: Optional[dict] = None):
        """stats_hint: RealtimeSegmentStatsHistory.estimate() output —
        sizes initial row-buffer allocations so steady-state consumption
        skips the growth-copy ladder (parity: the reference sizing
        MutableSegmentImpl allocations from RealtimeSegmentStatsHistory).
        """
        self.schema = schema
        self.table_config = table_config
        self.segment_name = segment_name
        no_dict = set(table_config.indexing_config.no_dictionary_columns)
        est_rows = int((stats_hint or {}).get("rows", 0))
        # next pow2 ≥ estimate, floor 4096, capped so a bad estimate
        # can't allocate unbounded memory up front
        cap = 4096
        while cap < est_rows and cap < (1 << 24):
            cap *= 2
        self._sources = {
            f.name: _MutableDataSource(f, f.name not in no_dict,
                                       initial_capacity=cap)
            for f in schema.fields}
        self._num_docs = 0
        self._lock = threading.Lock()
        self._start_time: Optional[int] = None
        self._end_time: Optional[int] = None
        self._frozen = None                  # sorted device snapshot
        self._freeze_lock = threading.Lock()
        self._device = None                  # the frozen prefix's device
        self.freezes = 0
        self.last_freeze_seconds = 0.0
        # primary-key upsert liveness bitmap (realtime/upsert.py):
        # attached by the realtime data manager when the table runs
        # upserts; shared with the frozen device snapshot and inherited
        # by the committed immutable segment (docIds survive conversion)
        self.valid_doc_ids = None
        self.creation_time_ms = int(time.time() * 1e3)
        # freshness: when the most recent row was indexed (parity: the
        # lastIndexedTimestamp feeding minConsumingFreshnessTimeMs)
        self.last_indexed_time_ms = self.creation_time_ms

    # -- write -------------------------------------------------------------
    def index_row(self, row: dict) -> bool:
        tc = self.schema.time_column
        with self._lock:
            for name, ds in self._sources.items():
                ds.add(row.get(name))
            if tc is not None:
                try:
                    t = int(row.get(tc.name))
                    self._start_time = t if self._start_time is None \
                        else min(self._start_time, t)
                    self._end_time = t if self._end_time is None \
                        else max(self._end_time, t)
                except (TypeError, ValueError):
                    pass
            self._num_docs += 1
            self.last_indexed_time_ms = int(time.time() * 1e3)
        return True

    def index_rows(self, rows: list) -> int:
        """Batch indexing: column-at-a-time over the whole fetch batch
        (parity outcome: BenchmarkRealtimeConsumptionSpeed-class rates —
        the per-row python dispatch was the consuming bottleneck)."""
        if not rows:
            return 0
        tc = self.schema.time_column
        with self._lock:
            for name, ds in self._sources.items():
                ds.add_many([r.get(name) for r in rows])
            if tc is not None:
                ts = []
                for r in rows:
                    try:
                        ts.append(int(r.get(tc.name)))
                    except (TypeError, ValueError):
                        pass
                if ts:
                    lo, hi = min(ts), max(ts)
                    self._start_time = lo if self._start_time is None \
                        else min(self._start_time, lo)
                    self._end_time = hi if self._end_time is None \
                        else max(self._end_time, hi)
            self._num_docs += len(rows)
            self.last_indexed_time_ms = int(time.time() * 1e3)
        return len(rows)

    def collect_stats(self) -> dict:
        """Completed-segment stats for RealtimeSegmentStatsHistory
        (parity: the stats the reference records at segment completion:
        rows indexed, per-column cardinality, avg MV count)."""
        with self._lock:
            cols = {}
            for name, ds in self._sources.items():
                st = {"cardinality": int(ds.dictionary.cardinality)
                      if ds.dictionary is not None else 0}
                if ds._mv is not None and self._num_docs:
                    st["avgMvCount"] = (sum(len(v) for v in ds._mv) /
                                        self._num_docs)
                cols[name] = st
            return {"numRowsIndexed": int(self._num_docs),
                    "columns": cols}

    # -- query interface (ImmutableSegment-compatible) ---------------------
    def snapshot_view(self, start: int = 0) -> MutableSegmentView:
        """Consistent point-in-time view for one query."""
        return MutableSegmentView(self, start=start)

    # -- device path: periodic sorted snapshot -----------------------------
    #
    # The TPU-first answer to "consuming segments are first-class query
    # targets" (reference: MutableSegmentImpl.java:64-198 serves queries
    # on the same engine): arrival-order dictionaries break the device
    # kernels' sorted-id preconditions, so a background-free PERIODIC
    # SNAPSHOT re-sorts each dictionary, remaps the frozen row prefix
    # into sorted-id space, and materializes a standard in-memory
    # ImmutableSegment — every device kernel (and its jit cache) applies
    # unchanged. Queries then run [frozen device part] + [host tail of
    # rows indexed since the freeze] as two segments and merge through
    # the ordinary combine path. Freeze points double (8192, 16384, ...)
    # so the jit shape set stays logarithmic in segment size and the
    # O(n + card log card) rebuild cost amortizes to O(1)/row.

    FREEZE_MIN_ROWS = 8192

    def to(self, device) -> "MutableSegmentImpl":
        """Bind the frozen prefix, now and after every rebuild, to
        `device` (its lanes move there on next use)."""
        from pinot_tpu_torch.common.device import resolve_device
        with self._freeze_lock:
            self._device = resolve_device(device)
            if self._frozen is not None:
                self._frozen.to(self._device)
        return self

    def device_view(self):
        """(frozen ImmutableSegment | None, tail MutableSegmentView).

        The tail view may be empty (num_docs == 0) when no rows arrived
        since the freeze; callers skip executing it then. Rebuild+swap
        is serialized by _freeze_lock (queries run on a worker pool);
        superseded snapshots are NOT destroyed eagerly — an in-flight
        query may still be executing against one, so their device
        arrays are released by GC when the last reference drops."""
        n = self._num_docs
        snap = self._frozen
        if n >= self.FREEZE_MIN_ROWS and \
                (snap is None or n >= 2 * snap.num_docs):
            with self._freeze_lock:
                snap = self._frozen        # another query may have won
                if snap is None or n >= 2 * snap.num_docs:
                    t0 = time.perf_counter()
                    snap = self._build_frozen(n)
                    self.last_freeze_seconds = time.perf_counter() - t0
                    self.freezes += 1
                    self._frozen = snap
        if snap is None:
            return None, self.snapshot_view()
        return snap, self.snapshot_view(start=snap.num_docs)

    def release_device_snapshot(self) -> None:
        """Graceful degradation under HBM pressure (the residency
        manager's pressure hook): drop the frozen device snapshot.
        In-flight queries keep their reference (GC releases the lanes
        when the last drops); new queries serve the full row range
        host-side until the executor's mutable gate re-admits a freeze."""
        with self._freeze_lock:
            self._frozen = None

    def _build_frozen(self, n: int):
        """Rows [0, n) as a sorted-dictionary in-memory ImmutableSegment."""
        from pinot_tpu_torch.segment.dictionary import Dictionary
        from pinot_tpu_torch.segment.loader import DataSource, ImmutableSegment

        tc = self.schema.time_column
        sources: Dict[str, DataSource] = {}
        col_meta: Dict[str, ColumnMetadata] = {}
        for name, ms in self._sources.items():
            f = ms.field
            if ms.is_vector:
                mat = np.array(ms._vec.snapshot(n), copy=True)
                cm = ColumnMetadata(
                    name=name, data_type=f.data_type, cardinality=n,
                    bits_per_element=32, single_value=True,
                    has_dictionary=False, total_number_of_entries=n,
                    vector_dimension=f.vector_dimension)
                ds = DataSource(cm, None)
                ds.vec_values = mat
                sources[name] = ds
                col_meta[name] = cm
                continue
            if not ms.has_dictionary:
                raw = np.array(ms._sv.snapshot(n), copy=True)
                cm = ColumnMetadata(
                    name=name, data_type=f.data_type, cardinality=n,
                    bits_per_element=32, single_value=True,
                    has_dictionary=False,
                    min_value=raw.min() if n else None,
                    max_value=raw.max() if n else None,
                    total_number_of_entries=n)
                ds = DataSource(cm, None)
                ds.raw_values = raw
                sources[name] = ds
                col_meta[name] = cm
                continue
            # pin the cardinality, sort values, invert the permutation
            card = ms.dictionary.cardinality
            dtype = f.data_type.np_dtype if f.data_type.is_numeric \
                else object
            # list slice under the GIL: a consistent copy even while the
            # consumer thread keeps appending new values
            vals = np.array(ms.dictionary._values[:card], dtype=dtype)
            order = np.argsort(vals, kind="stable")
            sorted_vals = vals[order]
            remap = np.empty(card + 1, np.int32)
            remap[order] = np.arange(card, dtype=np.int32)
            remap[card] = card          # MV padding sentinel
            if f.single_value:
                ids = remap[ms._sv.snapshot(n)]
                mv = None
                entries = n
            else:
                rows = ms._mv[:n]
                mv = _pad_mv(rows, card, remap)
                ids = None
                entries = int((mv < card).sum())
            cm = ColumnMetadata(
                name=name, data_type=f.data_type, cardinality=card,
                bits_per_element=max(
                    1, int(np.ceil(np.log2(max(card, 2))))),
                single_value=f.single_value, sorted=False,
                has_dictionary=True,
                min_value=sorted_vals[0] if card else None,
                max_value=sorted_vals[-1] if card else None,
                max_number_of_multi_values=(0 if mv is None
                                            else mv.shape[1]),
                total_number_of_entries=entries)
            ds = DataSource(cm, None)
            ds.dictionary = Dictionary(f.data_type, sorted_vals)
            ds.dict_ids = ids
            ds.mv_dict_ids = mv
            sources[name] = ds
            col_meta[name] = cm
        meta = SegmentMetadata(
            segment_name=f"{self.segment_name}__frozen",
            table_name=self.table_config.table_name,
            total_docs=n, columns=col_meta,
            time_column=tc.name if tc else None,
            time_unit=tc.time_unit.name if tc else None,
            start_time=self._start_time, end_time=self._end_time,
            creation_time_ms=self.creation_time_ms)
        seg = ImmutableSegment(meta, sources, self._device)
        # the frozen prefix shares the LIVE bitmap: rows [0, n) stay
        # maskable when a later (tail/committed) row supersedes them;
        # device lanes refresh via the bitmap version
        seg.valid_doc_ids = self.valid_doc_ids
        return seg

    @property
    def num_docs(self) -> int:
        return self._num_docs

    @property
    def padded_docs(self) -> int:
        from pinot_tpu_torch.segment.loader import padded_size
        return padded_size(max(self._num_docs, 1))

    @property
    def column_names(self) -> List[str]:
        return list(self._sources.keys())

    def has_column(self, column: str) -> bool:
        return column in self._sources

    def data_source(self, column: str) -> _MutableDataSource:
        ds = self._sources[column]
        return ds.bind(self._num_docs)

    @property
    def metadata(self) -> SegmentMetadata:
        tc = self.schema.time_column
        return SegmentMetadata(
            segment_name=self.segment_name,
            table_name=self.table_config.table_name,
            total_docs=self._num_docs,
            columns={name: ds.bind(self._num_docs).metadata
                     for name, ds in self._sources.items()},
            time_column=tc.name if tc else None,
            time_unit=tc.time_unit.name if tc else None,
            start_time=self._start_time, end_time=self._end_time,
            creation_time_ms=self.creation_time_ms)

    def columnar_snapshot(self) -> Dict[str, List]:
        """Decoded columns for RealtimeSegmentConverter → SegmentCreator."""
        n = self._num_docs
        return {name: ds.raw_column(n) for name, ds in self._sources.items()}

    def destroy(self) -> None:
        # _freeze_lock orders this against a concurrent device_view()
        # rebuild — without it destroy could null the reference while
        # _build_frozen publishes a fresh snapshot (leaked device arrays)
        with self._freeze_lock:
            if self._frozen is not None:
                self._frozen.destroy()
                self._frozen = None
        self._sources.clear()
