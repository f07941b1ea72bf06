"""Stacked multi-segment query execution: one launch per kernel over all
segments.

Counterpart of pinot_tpu/parallel/sharded.py. The JAX package stacks
homogeneous segments (same padded doc count) on a leading segment axis,
shards that axis over a device mesh, vmaps the segment kernel over each
device's shard and combines across segments with psum / pmin / pmax /
all_gather (`get_sharded_kernel`). Here the stack lives on one card as
[S, P] lanes, contiguous, so that the kernels read them as one [S * P]
row space: K1 masks each segment's rows past its doc count and counts
its matches, K2 writes one exact row of part sums per segment, K3 folds
every segment into one group table (int64 part sums), K6 keeps a top k
per segment, and K4 / K5 / K7 run over the flat rows unchanged. The
combine of `get_sharded_kernel` thus happens inside those launches
(ops/kernels.py:run_stacked_kernel), and the host finishes one block per
query with the single-segment finishers, where the sequential path
finishes and combines one block per segment.

Segments built independently have per-segment dictionaries; the stacker
builds a union dictionary per such column (the sorted merge of every
segment's values) and remaps each segment's id lanes into it at stack
time, once per (segment set, column), with the same monotone per-segment
id map as the JAX package: range predicates and sortedness survive, and
queries plan against a union view of segment 0 (`_UnionViewSegment`).
`NotShardable` remains for sets that cannot stack (differing padded
sizes or lane shapes, raw group-key ranges that differ) and for
fast-path plans (metadata, match-all and inverted-index COUNTs, empty
filters; a covering star-tree cube), which the sequential executor
serves per segment. `execute_stack` runs a query over a stack built
elsewhere, such as tools/datagen.py's SSB lanes synthesized on the card.

Vector selections stack too: the embedding blocks as [S, P, dim_pad], an
IVF index as its assignment lane [S, P], codebooks [S, C_pad, dim_pad]
and validity [S, C_pad] (K9 selects each segment's probe list in one
launch, K1 tests each row against its own segment's), and the host
merges the per-segment top k by score (`_finish_vector`). A stack whose
segments disagree on having an IVF index raises NotShardable (the
sequential path decides index or exact scan per segment).

Upsert tables: when any stacked segment has superseded rows, the plan
ANDs K1's vdoc leaf over the stack's [S, P] uint8 liveness lane
(`StackedSegments.vdoc_lane`, rows rebuilt only for segments whose
bitmap version moved), as the JAX stack does. A consuming segment in the
set stays NotShardable.

Stage 2 of a join plans on the stack like any query (a request carrying
its JoinContext as `_join_ctx`): for a dictionary fact key, on the union
view where the segments' dictionaries differ, so the K1 member table and
the K3 jcode table are built over the union dictionary (one values array
per stack, which JoinContext._translate caches by identity); for a raw
one, K1's join_raw leaf and K3's jraw key probe the stack's flat raw lane
with the query's one sorted dim side (pinot_tpu/parallel/sharded.py
plans joins the same way; tests/test_stages.py:211-252).

The mesh is one device in this port (`make_mesh`); stacking over several
cards (torch.distributed) is later work. Every stacked lane registers in
the residency ledger (obs/residency.py, kind "stack", or "vector" /
"hll" / "vdoc"), released when the stack is collected.
"""
from __future__ import annotations

import collections
import dataclasses
import threading
import time
import weakref
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from pinot_tpu_torch.common.device import resolve_device
from pinot_tpu_torch.common.request import BrokerRequest
from pinot_tpu_torch.obs import residency
from pinot_tpu_torch.ops import kernels
from pinot_tpu_torch.query import combine as combine_mod
from pinot_tpu_torch.query import execution
from pinot_tpu_torch.query.blocks import ExecutionStats, \
    IntermediateResultsBlock
from pinot_tpu_torch.common.request import VECTOR_RESULT_COLUMNS
from pinot_tpu_torch.query.plan import VALID_DOC_COLUMN, \
    InstancePlanMaker, SegmentPlan, drive_group_execution, \
    preprocess_request, set_group_kmax, upsert_mask_active, \
    with_valid_doc_mask
from pinot_tpu_torch.segment.dictionary import Dictionary
from pinot_tpu_torch.segment.loader import (ImmutableSegment,
                                            hll_tables_padded,
                                            int_part_info_for,
                                            int_part_table, min_id_dtype)


class NotShardable(Exception):
    """Segments are not homogeneous enough for id-domain device combine."""


def make_mesh(devices: Optional[Sequence] = None
              ) -> Tuple[torch.device, ...]:
    """The port's mesh: an ordered tuple of devices, the card when
    `devices` is None. One device only: stacking across several cards
    is not in the port yet."""
    devs = (resolve_device(None),) if devices is None else \
        tuple(resolve_device(d) for d in devices)
    if len(devs) != 1:
        raise NotImplementedError(
            f"a mesh of {len(devs)} devices: stacking across cards "
            "(torch.distributed) is not in the port yet")
    return devs


def _combine_kind(key: str) -> str:
    """How the JAX package combines an output across segments: "stack"
    keeps a segment axis, "sum" / "min" / "max" reduce over it."""
    if key.startswith("sel."):
        return "stack"          # per-segment; host merges selection rows
    if key.endswith((".parts", ".partsT", ".vsum", ".psums", ".csums")):
        return "stack"          # chunk partials: host combines in int64/f64
    if key.endswith((".rkeys", ".rcount", ".rpsums", ".rsum", ".rmin",
                     ".rmax")):
        return "stack"          # ranked group tables: per-segment ranks
    if key.endswith(".min"):
        return "min"
    if key.endswith((".max", ".hll")):
        return "max"            # HLL registers merge by elementwise max
    return "sum"                # counts, histograms, group tables


# ---------------------------------------------------------------------------
# Union dictionaries
# ---------------------------------------------------------------------------


class _UnionColumn:
    """Union-dictionary remap artifacts for one column.

    values = sorted merge of every segment's dictionary values;
    remaps[s] maps segment s's local dictId (plus the local padding
    sentinel, id == local cardinality) into the union id domain (pad →
    union cardinality). The map is monotonic per segment, so range
    predicates and sorted-layout guarantees survive the remap."""

    def __init__(self, col: str, srcs):
        self.col = col
        per_seg = [np.asarray(s.dictionary.values) for s in srcs]
        union = np.unique(np.concatenate(per_seg))
        self.values = union
        self.cardinality = len(union)
        self.remaps = []
        for v in per_seg:
            r = np.searchsorted(union, v).astype(np.int32)
            self.remaps.append(
                np.concatenate([r, np.int32([self.cardinality])]))
        cm0 = srcs[0].metadata
        self.metadata = dataclasses.replace(
            cm0, cardinality=self.cardinality,
            min_value=union[0] if len(union) else cm0.min_value,
            max_value=union[-1] if len(union) else cm0.max_value,
            sorted=all(s.metadata.sorted for s in srcs),
            has_inverted_index=False, has_bloom_filter=False)
        self.dictionary = Dictionary(cm0.data_type, union)
        # segment-independent artifacts, built once per union column
        self.part_info = int_part_info_for(union) \
            if cm0.data_type.np_dtype.kind in "iu" else None
        self.part_table = (int_part_table(union, *self.part_info)
                           if self.part_info is not None else None)
        self.f64_vals = np.concatenate(
            [np.asarray(union, dtype=np.float64), [0.0]]) \
            if cm0.data_type.is_numeric else None
        # HLL (idx, rank) tables in the union value domain, built lazily
        self.hll_tables = None


class _UnionDataSource:
    """Planning-time DataSource view in the union id domain: metadata,
    literal → id binding, part encodings and decode tables come from the
    union dictionary; the per-segment index structures (inverted, bloom,
    sorted ranges) are absent, so no plan takes a per-segment fast path."""

    def __init__(self, union: _UnionColumn):
        self.metadata = union.metadata
        self.dictionary = union.dictionary
        self.inverted_index = None
        self.bloom_filter = None
        self.sorted_ranges = None
        self._union = union

    def int_part_info(self) -> tuple:
        return self._union.part_info


class _UnionViewSegment:
    """Segment 0 with union-dictionary columns swapped in: the object
    queries plan against (and decode group and selection results with)
    when a stack spans per-segment dictionaries."""

    def __init__(self, stack: "StackedSegments"):
        self._stack = stack
        self._base = stack.segments[0]
        self._sources: Dict[str, object] = {}

    @property
    def metadata(self):
        return self._base.metadata

    @property
    def segment_name(self) -> str:
        return self._base.segment_name

    @property
    def num_docs(self) -> int:
        return self._base.num_docs

    @property
    def padded_docs(self) -> int:
        return self._base.padded_docs

    @property
    def column_names(self):
        return self._base.column_names

    @property
    def star_trees(self):
        # cubes are per-segment id-domain artifacts: the stacked path
        # never serves them (its fast path goes per segment)
        return []

    @property
    def valid_doc_ids(self):
        """A bitmap with superseded rows from any segment of the stack, or
        None: the union plan masks (and takes no fast path) when one
        segment does."""
        return next((s.valid_doc_ids for s in self._stack.segments
                     if upsert_mask_active(s)), None)

    def has_column(self, column: str) -> bool:
        return self._base.has_column(column)

    def data_source(self, column: str):
        ds = self._sources.get(column)
        if ds is None:
            base = self._base.data_source(column)
            union = self._stack.union_column(column) \
                if base.dictionary is not None else None
            ds = _UnionDataSource(union) if union is not None else base
            self._sources[column] = ds
        return ds


# ---------------------------------------------------------------------------
# Segment stacking
# ---------------------------------------------------------------------------

#: lane kinds held once for the stack (dictionary-scale), not per segment
_TABLE_KINDS = ("hllidx", "hllrank")
#: lane kinds that live in a column's id domain (remapped for a union)
_ID_KINDS = ("ids", "mv", "parts", "vlane") + _TABLE_KINDS


class StackedSegments:
    """Stacks homogeneous segments' lanes on one device and caches them.

    Row-scale lanes are [S, P, ...] (part lanes [n_parts, S, P]),
    contiguous, so that the kernels read each as one [S * P] row space;
    they are built on first use from the segments' host arrays (remapped
    into a union dictionary where the segments' dictionaries differ) and
    reused by every query on the same segment set."""

    def __init__(self, segments: Sequence[ImmutableSegment],
                 mesh: Sequence[torch.device]):
        self.segments = list(segments)
        self.device = tuple(mesh)[0]
        if not self.segments:
            raise NotShardable("no segments")
        if any(getattr(s, "is_mutable", False) for s in self.segments):
            raise NotShardable("mutable (consuming) segment in set")
        pads = {s.padded_docs for s in self.segments}
        if len(pads) != 1:
            raise NotShardable(f"padded doc counts differ: {sorted(pads)}")
        self.padded_docs = pads.pop()
        self.n_real = len(self.segments)
        self.num_docs = np.asarray([s.num_docs for s in self.segments],
                                   np.int32)
        self._dev_num_docs: Optional[torch.Tensor] = None
        self._lanes: Dict[Tuple[str, str], torch.Tensor] = {}
        # guards every cache publish on this stack; heavy builds happen
        # outside it (first writer wins)
        self._cache_lock = threading.Lock()
        # col -> None (dictionaries shared) | _UnionColumn (remap needed)
        self._union: Dict[str, Optional[_UnionColumn]] = {}
        self._plan_segment: Optional[_UnionViewSegment] = None
        # upsert liveness: (bitmap versions, [S, P] lane) and the host
        # rows it was built from
        self._vdoc: Optional[Tuple[tuple, torch.Tensor]] = None
        self._vdoc_host: Optional[np.ndarray] = None
        self.vdoc_uploads = 0
        self.vdoc_upload_bytes = 0
        # residency: one ledger prefix per stack. Eviction only drops the
        # executor's reference (in-flight queries keep the lanes alive),
        # so the entries leave the books when the stack is collected
        self._ledger_prefix = f"stack:{id(self)}:"
        weakref.finalize(self, residency.LEDGER.release_prefix,
                         self._ledger_prefix)

    #: lane kind -> residency ledger kind (the rest are stacked scan lanes)
    _LEDGER_KINDS = {"vec": "vector", "hllidx": "hll", "hllrank": "hll",
                     "ivfa": "vector", "ivfc": "vector", "ivfv": "vector",
                     "vdoc": "vdoc"}

    def _ledger(self, out: torch.Tensor, name: str, lane_kind: str
                ) -> torch.Tensor:
        """Register a lane of this stack (replacing its earlier upload)."""
        residency.LEDGER.register(
            self._ledger_prefix + name,
            table=self.segments[0].metadata.table_name or "",
            segment=f"stack[{self.n_real}]",
            kind=self._LEDGER_KINDS.get(lane_kind, "stack"),
            nbytes=out.untyped_storage().nbytes())
        return out

    def union_column(self, col: str) -> Optional[_UnionColumn]:
        """None when every segment shares the column's dictionary; else
        the union-dictionary remap artifacts (built once per column)."""
        with self._cache_lock:
            if col in self._union:
                return self._union[col]
        srcs = [s.data_source(col) for s in self.segments]
        d0 = srcs[0].dictionary
        if d0 is None:
            union = None                  # raw column: no id domain
        elif all(np.array_equal(s.dictionary.values, d0.values)
                 for s in srcs[1:]):
            union = None
        else:
            union = _UnionColumn(col, srcs)
        with self._cache_lock:
            return self._union.setdefault(col, union)

    def plan_segment(self) -> _UnionViewSegment:
        """Segment 0 with every differing-dictionary column replaced by
        its union view: literal → id binding, part encodings and group
        decode tables all live in the union id domain of the lanes."""
        with self._cache_lock:
            if self._plan_segment is None:
                self._plan_segment = _UnionViewSegment(self)
            return self._plan_segment

    def device_num_docs(self) -> torch.Tensor:
        """int32 [S] live rows per segment, on the stack's device."""
        with self._cache_lock:
            if self._dev_num_docs is None:
                self._dev_num_docs = self._ledger(torch.from_numpy(
                    self.num_docs.copy()).to(self.device), "num_docs",
                    "num_docs")
            return self._dev_num_docs

    def lane(self, col: str, kind: str) -> torch.Tensor:
        """The stacked device lane of one column: [S, P, ...] (part lanes
        [n_parts, S, P]), or one [card_pad] table for the HLL kinds."""
        key = (col, kind)
        with self._cache_lock:
            if key in self._lanes:
                return self._lanes[key]
        union = self.union_column(col) if kind in _ID_KINDS else None
        if union is not None:
            arrs = [self._union_operand(union, i, kind)
                    for i in range(self.n_real)]
            card = union.cardinality
        else:
            arrs = [s.data_source(col).host_operand(kind)
                    for s in self.segments]
            card = self.segments[0].data_source(col).metadata.cardinality
        if kind in _TABLE_KINDS:
            # dictionary-scale: the union's table, or the shared one
            out = torch.from_numpy(np.ascontiguousarray(arrs[0])).to(
                self.device)
            with self._cache_lock:
                if key not in self._lanes:
                    self._lanes[key] = self._ledger(out, f"{col}.{kind}",
                                                    kind)
                return self._lanes[key]
        if kind == "mv":
            w = max(a.shape[1] for a in arrs)
            arrs = [np.pad(a, ((0, 0), (0, w - a.shape[1])),
                           constant_values=card) for a in arrs]
        shapes = {(a.shape, a.dtype.str) for a in arrs}
        if len(shapes) != 1:
            raise NotShardable(f"column '{col}' lane shapes differ: "
                               f"{sorted(shapes)}")
        a0 = arrs[0]
        if kind == "parts":               # [n_parts, S, P]
            out = torch.empty((a0.shape[0], self.n_real) + a0.shape[1:],
                              dtype=torch.from_numpy(a0[:0]).dtype,
                              device=self.device)
            for i, a in enumerate(arrs):
                out[:, i].copy_(torch.from_numpy(np.ascontiguousarray(a)))
        else:                             # [S, P, ...]
            out = torch.empty((self.n_real,) + a0.shape,
                              dtype=torch.from_numpy(a0[:0]).dtype,
                              device=self.device)
            for i, a in enumerate(arrs):
                out[i].copy_(torch.from_numpy(np.ascontiguousarray(a)))
        with self._cache_lock:
            if key not in self._lanes:
                self._lanes[key] = self._ledger(out, f"{col}.{kind}", kind)
            return self._lanes[key]

    def _union_operand(self, union: _UnionColumn, i: int,
                       kind: str) -> np.ndarray:
        """Segment i's lane remapped into the union id domain, built on
        the host at stack time."""
        ds = self.segments[i].data_source(union.col)
        remap = union.remaps[i]
        if kind in _TABLE_KINDS:
            if union.hll_tables is None:
                union.hll_tables = hll_tables_padded(union.values)
            return union.hll_tables[0 if kind == "hllidx" else 1]
        if kind in ("ids", "mv"):
            local = ds.host_operand(kind)
            return remap[local.astype(np.int64)].astype(
                min_id_dtype(union.cardinality))
        ids = remap[ds.host_operand("ids").astype(np.int64)]
        if kind == "parts":
            # 7-bit part planes in the union encoding (offsets from the
            # union min), so every segment's parts add exactly
            return union.part_table[:, ids]
        if kind == "vlane":
            return union.f64_vals[ids]
        raise ValueError(kind)

    def vdoc_lane(self) -> torch.Tensor:
        """uint8 [S, P] upsert liveness of the stack (pinot_tpu/parallel/
        sharded.py:vdoc_lane): a segment without a bitmap is live on its
        rows, padding rows are 0. Keyed by every segment's bitmap version;
        only the rows of segments whose version moved are rebuilt, then
        the lane uploads whole (one new tensor, so a query that holds the
        old one keeps its version)."""
        versions = tuple(
            vd.version if (vd := getattr(s, "valid_doc_ids", None))
            is not None else -1 for s in self.segments)
        with self._cache_lock:
            cached = self._vdoc
            if cached is not None and cached[0] == versions:
                return cached[1]
            old = None if cached is None else cached[0]
            host = self._vdoc_host
            if host is None:
                host = np.zeros((self.n_real, self.padded_docs), np.uint8)
                old = None
            for i, s in enumerate(self.segments):
                if old is not None and old[i] == versions[i]:
                    continue
                vd = getattr(s, "valid_doc_ids", None)
                host[i] = 0
                host[i, : s.num_docs] = 1 if vd is None else \
                    vd.valid_mask(0, s.num_docs)
            lane = self._ledger(torch.from_numpy(host.copy()).to(
                self.device), "vdoc", "vdoc")
            self._vdoc_host = host
            self._vdoc = (versions, lane)
            self.vdoc_uploads += 1
            self.vdoc_upload_bytes += host.nbytes
            return lane

    def gather(self, needed_cols) -> Dict[str, torch.Tensor]:
        """{"<col>.<kind>": stacked lane}, the names the kernels read."""
        cols: Dict[str, torch.Tensor] = {}
        for col, kind in needed_cols:
            cols[f"{col}.{kind}"] = self.vdoc_lane() if kind == "vdoc" \
                else self.lane(col, kind)
        return cols

    def device_bytes(self) -> int:
        """Bytes the stack's lanes hold on its device now, the vdoc lane
        included."""
        with self._cache_lock:
            return sum(t.numel() * t.element_size()
                       for t in self._lanes.values()) + \
                (0 if self._vdoc is None else self._vdoc[1].numel())


# ---------------------------------------------------------------------------
# Stacked executor
# ---------------------------------------------------------------------------


class ShardedQueryExecutor:
    """Executes one BrokerRequest over all segments with one launch per
    kernel (ops/kernels.py:run_stacked_kernel).

    Plans once against segment 0, or its union view where dictionaries
    differ, and finishes results on the host with the single-segment
    finishers (the union view's decode tables serve the combined
    partials)."""

    def __init__(self, mesh: Optional[Sequence[torch.device]] = None,
                 plan_maker: Optional[InstancePlanMaker] = None,
                 max_stacks: int = 4):
        self.mesh = tuple(mesh) if mesh is not None else make_mesh()
        self.plan_maker = plan_maker or InstancePlanMaker()
        # Bounded LRU keyed on the canonical (sorted) name tuple: every
        # ordering of one segment set shares one stack, and the bound caps
        # the device memory that stacks of different subsets duplicate. A
        # hit also needs segment object identity, so a refreshed segment
        # (same name, new object) rebuilds instead of serving stale lanes.
        self.max_stacks = max_stacks
        self._stacks: "collections.OrderedDict[Tuple[str, ...], StackedSegments]" = \
            collections.OrderedDict()
        # the generation counter closes the build / evict race: a stack
        # built while an eviction ran is served but never cached
        self._lock = threading.Lock()
        self._evict_gen = 0

    def stack_for(self, segments: Sequence[ImmutableSegment]
                  ) -> StackedSegments:
        ordered = sorted(segments, key=lambda s: s.segment_name)
        key = tuple(s.segment_name for s in ordered)
        with self._lock:
            st = self._stacks.get(key)
            if st is not None and len(st.segments) == len(ordered) and \
                    all(a is b for a, b in zip(st.segments, ordered)):
                self._stacks.move_to_end(key)
                return st
            gen = self._evict_gen
        st = StackedSegments(ordered, self.mesh)
        with self._lock:
            if self._evict_gen == gen:
                self._stacks[key] = st
                self._stacks.move_to_end(key)
                while len(self._stacks) > self.max_stacks:
                    self._stacks.popitem(last=False)
        return st

    def evict_segment(self, segment_name: str) -> None:
        """Drop every cached stack containing `segment_name` (a refreshed
        or deleted segment's lanes go now, not at LRU pressure)."""
        with self._lock:
            self._evict_gen += 1
            for key in [k for k in self._stacks if segment_name in k]:
                del self._stacks[key]

    def evict_all(self) -> None:
        """Drop every cached stack (they rebuild from the segments' host
        arrays on the next query)."""
        with self._lock:
            self._evict_gen += 1
            self._stacks.clear()

    def execute(self, request: BrokerRequest,
                segments: Sequence[ImmutableSegment]
                ) -> IntermediateResultsBlock:
        t0 = time.perf_counter()
        # FASTHLL derived rewrite, on a copy (the caller's request stays)
        request = preprocess_request(segments, request)
        return self._execute_stack(request, self.stack_for(segments), t0)

    def execute_stack(self, request: BrokerRequest, stack
                      ) -> IntermediateResultsBlock:
        """Execute over a stack built elsewhere: an object with the
        StackedSegments surface the executor reads (segments, the ones
        plans build against; padded_docs; n_real; num_docs; gather;
        device_num_docs; union_column; plan_segment), such as the SSB
        lanes that tools/datagen.py:make_ssb_device_stack synthesizes on
        the card (tools/datagen.py:SynthStack)."""
        t0 = time.perf_counter()
        request = preprocess_request(stack.segments, request)
        return self._execute_stack(request, stack, t0)

    def _execute_stack(self, request: BrokerRequest, stack, t0: float
                       ) -> IntermediateResultsBlock:
        # fast paths (metadata, match-all and inverted-index COUNTs, empty
        # filters, star-tree cubes) are per-segment host work in each segment's own id
        # domain: probe segment 0 and leave them to the sequential
        # executor, which plans per segment
        plan0 = self.plan_maker.make_segment_plan(stack.segments[0],
                                                  request)
        if plan0.fast_path_result is not None:
            raise NotShardable("fast-path plan; no device work to stack")
        # plan against the union view when a referenced dictionary column
        # differs across segments; else plan0 is that plan already
        seg0 = stack.segments[0]
        needs_union = any(
            stack.union_column(col) is not None
            for col in request.referenced_columns()
            if seg0.has_column(col) and
            seg0.data_source(col).dictionary is not None)
        if needs_union:
            seg0 = stack.plan_segment()
        if request.is_group_by:
            # raw group keys bin by segment 0's min / max: every segment
            # must share that range or rows would clip into wrong bins
            for col in request.group_by.columns:
                if not seg0.has_column(col):
                    continue
                cm0 = seg0.data_source(col).metadata
                if cm0.has_dictionary:
                    continue
                for s in stack.segments[1:]:
                    cm = s.data_source(col).metadata
                    if (cm.min_value, cm.max_value) != (cm0.min_value,
                                                        cm0.max_value):
                        raise NotShardable(
                            f"raw group column '{col}' min/max differ "
                            "across segments")
        plan = self.plan_maker.make_segment_plan(seg0, request) \
            if needs_union else plan0
        if plan.fast_path_result is not None:
            raise NotShardable("fast-path plan; no device work to stack")
        # the one plan either probes every segment or none: a stack whose
        # segments disagree on having an IVF index would diverge from the
        # sequential path's per-segment choice, so it falls back
        vec = request.vector
        if vec is not None and int(getattr(vec, "nprobe", 0) or 0) > 0:
            presence = {s.data_source(vec.column).ivf_centroids is not None
                        for s in stack.segments}
            if len(presence) > 1:
                raise NotShardable(
                    "stacked segments disagree on IVF index presence")
        # upsert validDocIds: when ANY segment of the stack has superseded
        # rows the leaf covers the whole stack (segment 0's plan alone
        # would miss the others' masks); it takes no params
        if any(upsert_mask_active(s) for s in stack.segments):
            plan = dataclasses.replace(
                plan, filter_spec=with_valid_doc_mask(plan.filter_spec))
            if (VALID_DOC_COLUMN, "vdoc") not in plan.needed_cols:
                plan.needed_cols = plan.needed_cols + (
                    (VALID_DOC_COLUMN, "vdoc"),)

        cols = stack.gather(plan.needed_cols)
        total_docs = int(stack.num_docs.sum())

        def run(agg_specs, group_spec, extra_params=()):
            return execution.pull_group_outputs(kernels.run_stacked_kernel(
                stack.padded_docs, stack.n_real, plan.filter_spec,
                agg_specs, group_spec, plan.select_spec, cols,
                tuple(plan.params), stack.device_num_docs(),
                tuple(plan.group_params) + tuple(extra_params)
                if group_spec is not None else ()))

        blk = IntermediateResultsBlock()
        if plan.group_spec is not None:
            # the JAX stack's driver (sharded.py:701-712): the scouts
            # combine over the stack, kmax is per segment, sized from the
            # matches over all the stack's docs
            outs, spec_used = drive_group_execution(
                run, set_group_kmax(plan.group_spec, stack.padded_docs),
                stack.padded_docs, total_docs)
            execution.finish_group_outputs(plan, spec_used, outs, blk)
        else:
            outs = execution.pull(kernels.run_stacked_kernel(
                stack.padded_docs, stack.n_real, plan.filter_spec,
                plan.agg_specs, None, plan.select_spec, cols,
                tuple(plan.params), stack.device_num_docs()))
            if plan.agg_specs:
                execution._finish_aggregation(plan, outs, blk)
        matched = int(outs["stats.num_docs_matched"])
        if plan.select_spec is not None:
            self._finish_selection(request, plan, stack, outs, blk)

        n_leaves = execution._count_filter_leaves(plan.filter_spec)
        n_project = len({c for c, _ in plan.needed_cols})
        seg_matched = np.asarray(outs["stats.seg_matched"])
        blk.stats = ExecutionStats(
            num_docs_scanned=matched,
            num_entries_scanned_in_filter=n_leaves * total_docs,
            num_entries_scanned_post_filter=matched * max(
                n_project - n_leaves, 0),
            num_segments_processed=stack.n_real,
            num_segments_matched=int((seg_matched > 0).sum()),
            total_docs=total_docs,
            time_used_ms=(time.perf_counter() - t0) * 1e3)
        return blk

    def _finish_selection(self, request, plan, stack, outs, blk) -> None:
        """Per-segment selection finish, then the host top-k merge in
        stack order (segments sorted by name): each segment's rows come
        ordered and limited, the merge re-sorts and trims."""
        if plan.select_spec[0] == "vector":
            self._finish_vector(request, plan, stack, outs, blk)
            return
        rows_all: List[tuple] = []
        columns = None
        decode_seg = stack.plan_segment()   # union-domain decode tables
        for i in range(stack.n_real):
            sub = {k: v[i] for k, v in outs.items() if k.startswith("sel.")}
            seg_plan = SegmentPlan(
                segment=decode_seg, request=request,
                select_spec=plan.select_spec, needed_cols=plan.needed_cols,
                select_display=plan.select_display)
            seg_blk = IntermediateResultsBlock()
            execution._finish_selection(seg_plan, sub, seg_blk)
            columns = seg_blk.selection_columns
            if rows_all and seg_blk.selection_rows:
                rows_all = combine_mod.merge_selection_rows(
                    request, columns, rows_all, seg_blk.selection_rows)
            elif seg_blk.selection_rows:
                rows_all = seg_blk.selection_rows
        sel = request.selection
        blk.selection_rows = rows_all[: sel.offset + sel.size]
        blk.selection_columns = columns
        blk.selection_display_cols = plan.select_display

    def _finish_vector(self, request, plan, stack, outs, blk) -> None:
        """Each segment's own top k (K6's segment axis), merged on the
        host by score descending, then (segment name, docid): a row's
        identity comes from its real segment, its gathered columns decode
        through the union view (the stacked lanes' id domain)."""
        decode_seg = stack.plan_segment()
        columns = [c for c, _ in plan.select_spec[3]] + \
            list(VECTOR_RESULT_COLUMNS)
        rows_all: List[tuple] = []
        for i, seg in enumerate(stack.segments):
            sub = {k: v[i] for k, v in outs.items() if k.startswith("sel.")}
            name, base = execution.vector_segment_identity(seg)
            rows = execution.vector_result_rows(decode_seg, plan.select_spec,
                                                sub, name, base)
            if rows_all and rows:
                rows_all = combine_mod.merge_selection_rows(
                    request, columns, rows_all, rows)
            elif rows:
                rows_all = rows
        sel = request.selection
        blk.selection_rows = rows_all[: sel.offset + sel.size]
        blk.selection_columns = columns
        blk.selection_display_cols = None
