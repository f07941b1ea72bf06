"""Immutable segments: host arrays → device tensors.

Counterpart of pinot_tpu/segment/loader.py. Each column's dictId lanes,
bit-sliced part lanes and raw value lanes are pushed to the segment's
device once, on first use, padded to a multiple of the kernel row block
so every kernel sees the same static layout the JAX package uses:

- id lanes use the narrow dtype from `min_id_dtype`; padding rows hold
  id == cardinality;
- part lanes are int8 [n_parts, P] (7 bits of value - min per lane);
- MV lanes are narrow [P, W] dictIds (W = the column's most values per
  row); padding entries and padding rows hold id == cardinality;
- raw lanes keep the host dtype (int32 / int64 / float32 / float64);
- value lanes decode a float dictionary to float64 [P];
- HLL tables are int32 [card_pad] per-dictId register index and rank
  (`hll_tables_padded`), padded with (0, 0);
- the upsert liveness lane (`device_valid_lane`, where a ValidDocIds
  bitmap is attached) is uint8 [P], 1 for a live row, padding rows 0;
- VECTOR columns are float32 [P, dim_pad] embedding blocks (`vec`), dim
  padded to a power of two with zeros (an exact no-op in every tree
  sum), padding rows zero; with an IVF index, its assignment lane
  (`ivfa`, narrow ints, padding rows the never-probed sentinel
  numCentroids), its codebook (`ivfc`, f32 [C_pad, dim_pad]) and the
  centroids' liveness (`ivfv`, bool [C_pad]).

Segments come from disk (`ImmutableSegmentLoader.load`, the directories
segment/creator.py writes, or the JAX package's creator: the files are
the same) or are built in memory (tools/datagen.py:
make_segment_from_arrays). Star-tree cubes (`startree.<i>.*`, startree/
cube.py) load with the segment into `seg.star_trees`, host arrays only
(an unloadable cube is skipped, as the JAX loader skips it). Not read
yet: chunked no-dictionary STRING / BYTES columns, schema-evolution
default columns.

Residency (pinot_tpu/segment/loader.py:341, :528-590): every lane uploads
through the ledger (obs/residency.py:ledgered_asarray, owner
`ds:<id>:<lane>`, the vdoc lane `seg:<id>:vdoc`), and a finalizer
releases a DataSource's entries when it is collected. The residency
manager (server/residency_manager.py) moves a segment between three
tiers: `release_device_lanes` copies each resident lane to host memory
(pinned when the lanes lie on the card) and frees the device ones,
`warm_device` uploads them again from those copies (or the id / raw /
MV / vector lanes of a segment never warmed), `release_host_lanes` drops
the row payloads and host copies for the disk tier and
`rebind_host_lanes` takes them back from a fresh load of the artifact.
"""
from __future__ import annotations

import threading
import weakref
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from pinot_tpu_torch.common.datatype import DataType
from pinot_tpu_torch.common.device import resolve_device
from pinot_tpu_torch.ops.kernels import BLOCK as PAD_BLOCK
from pinot_tpu_torch.segment import format as fmt
from pinot_tpu_torch.segment.bloom import BloomFilter
from pinot_tpu_torch.segment.dictionary import Dictionary
from pinot_tpu_torch.segment.fwd import (mv_to_padded, read_mv_fwd,
                                         read_raw_fwd, read_sorted_fwd,
                                         read_sv_fwd, read_vec_fwd)
from pinot_tpu_torch.segment.inverted import InvertedIndexReader
from pinot_tpu_torch.segment.metadata import ColumnMetadata, SegmentMetadata
from pinot_tpu_torch.startree.cube import load_star_trees


def padded_size(n: int, block: int = PAD_BLOCK) -> int:
    return max(block, ((n + block - 1) // block) * block)


def min_id_dtype(max_value: int) -> np.dtype:
    """Smallest signed dtype holding ids in [0, max_value] — the single
    source of truth for id-lane narrowing. Kernels read each lane at its
    own width and promote to int32 where they compute."""
    return np.dtype(np.int8 if max_value <= 127 else
                    np.int16 if max_value <= 32767 else np.int32)


def vec_dim_pad(dim: int) -> int:
    """Power-of-two vector width: the tree sums halve the dim axis
    pairwise. Padding lanes are zero, an exact no-op in every sum."""
    from pinot_tpu_torch.ops.kernels import pow2_bucket
    return pow2_bucket(max(dim, 1), floor=1)


def int_part_info_for(values: np.ndarray) -> tuple:
    """(n_parts, min_value) for the 7-bit bit-sliced integer sum encoding
    of a sorted integer dictionary (value = min + sum_k part_k << 7k)."""
    vals = np.asarray(values, dtype=np.int64)
    min_v = int(vals[0]) if len(vals) else 0
    max_off = (int(vals[-1]) - min_v) if len(vals) else 0
    n_parts = -(-max(1, max_off.bit_length()) // 7)
    return (n_parts, min_v)


def hll_tables_padded(values: np.ndarray) -> tuple:
    """(idx, rank) int32 [card_pad] HLL tables for a dictionary, padded
    to the kernels' pow2 cardinality bucket with (0, 0) — rank 0 is the
    register-max identity, so padding ids can never perturb a sketch."""
    from pinot_tpu_torch.common.sketches import hll_tables
    from pinot_tpu_torch.ops.kernels import pow2_bucket
    idx, rank = hll_tables(np.asarray(values))
    card_pad = pow2_bucket(len(idx) + 1)
    out_i = np.zeros(card_pad, np.int32)
    out_r = np.zeros(card_pad, np.int32)
    out_i[: len(idx)] = idx
    out_r[: len(rank)] = rank
    return out_i, out_r


def int_part_table(values: np.ndarray, n_parts: int,
                   min_v: int) -> np.ndarray:
    """[n_parts, card + 1] int8 plane table (last column = all-zero pad
    sentinel for id == cardinality row padding)."""
    off = np.asarray(values, dtype=np.int64) - min_v
    table = np.stack([(off >> (7 * k)) & 0x7F
                      for k in range(n_parts)]).astype(np.int8)
    return np.concatenate([table, np.zeros((n_parts, 1), np.int8)], axis=1)


class DataSource:
    """Column access for the planner and the kernels: dictionary, host
    forward arrays, and the device lanes built from them."""

    def __init__(self, metadata: ColumnMetadata,
                 segment: Optional["ImmutableSegment"]):
        self.metadata = metadata
        self._segment = segment
        self._lane_lock = threading.RLock()   # _device → int_part_info
        self.dictionary: Optional[Dictionary] = None
        self.dict_ids: Optional[np.ndarray] = None        # [num_docs]
        self.raw_values: Optional[np.ndarray] = None      # no-dict columns
        self.mv_dict_ids: Optional[np.ndarray] = None     # int32 [docs, W]
        self.vec_values: Optional[np.ndarray] = None      # f32 [docs, dim]
        # IVF ANN index (VECTOR columns with a built index only)
        self.ivf_centroids: Optional[np.ndarray] = None   # f32 [C, dim]
        self.ivf_assignments: Optional[np.ndarray] = None  # i32 [docs]
        self.ivf_meta: Optional[dict] = None
        self.sorted_ranges: Optional[np.ndarray] = None   # [card, 2]
        self.inverted_index: Optional[InvertedIndexReader] = None
        self.bloom_filter: Optional[BloomFilter] = None
        self._dev: Dict[str, torch.Tensor] = {}
        self._dev_finalizer = None            # set on first device upload
        # host copies of the lanes a demotion released (pinned memory when
        # they came from the card): the next warm_device uploads them
        self._host_lanes: Dict[str, torch.Tensor] = {}
        self._part_info: Optional[tuple] = None
        self._hll_tables: Optional[tuple] = None

    # -- device access -----------------------------------------------------
    def device_dict_ids(self) -> torch.Tensor:
        """Padded narrow dictIds; padding = cardinality (never matches)."""
        return self._device("dict_ids", "ids")

    def device_mv_dict_ids(self) -> torch.Tensor:
        """Padded narrow MV dictIds [P, W]; padding entries and padding
        rows hold id == cardinality."""
        return self._device("mv_dict_ids", "mv")

    def device_raw_values(self) -> torch.Tensor:
        """Padded raw values [P] in the host dtype (int32, int64, float32
        or float64); padding rows hold 0."""
        return self._device("raw_values", "raw")

    def device_part_lanes(self) -> torch.Tensor:
        """Bit-sliced int8 part lanes [n_parts, P] for exact integer sums."""
        return self._device("part_lanes", "parts")

    def device_value_lane(self) -> torch.Tensor:
        """Decoded float64 dictionary-value lane [P] for float sums."""
        return self._device("value_lane", "vlane")

    def device_vec_values(self) -> torch.Tensor:
        """The float32 [P, dim_pad] embedding block; padding rows and
        padding dims are zeros."""
        return self._device("vec_values", "vec")

    def device_ivf_assign(self) -> torch.Tensor:
        """The narrow [P] coarse-cell lane (padding rows hold the
        never-probed sentinel numCentroids)."""
        return self._device("ivf_assign", "ivfa")

    def device_ivf_centroids(self) -> torch.Tensor:
        """The zero-padded codebook f32 [C_pad, dim_pad]."""
        return self._device("ivf_centroids", "ivfc")

    def device_ivf_valid(self) -> torch.Tensor:
        """Centroid liveness bool [C_pad] (the live count rides as a lane,
        not a param, so stacked plans stay shareable)."""
        return self._device("ivf_valid", "ivfv")

    def device_hll_idx(self) -> torch.Tensor:
        """Per-dictId HLL register-index table [card_pad] int32, built
        from the dictionary values with the host HyperLogLog's own hashing
        (sketches.hll_tables), so K7's registers equal the host sketch."""
        return self._device("hll_idx", "hllidx")

    def device_hll_rank(self) -> torch.Tensor:
        """Per-dictId HLL rank table [card_pad] int32 (padding rank 0, the
        register-max identity)."""
        return self._device("hll_rank", "hllrank")

    def int_part_info(self) -> tuple:
        """(n_parts, min_value): value = min_value + sum_k part_k << 7k."""
        if self._part_info is None:
            with self._lane_lock:
                if self._part_info is None:
                    self._part_info = int_part_info_for(
                        self.dictionary.values)
        return self._part_info

    def host_operand(self, kind: str) -> np.ndarray:
        """Padded host array for a lane kind ('ids'|'mv'|'raw'|'parts'|
        'vlane'|'hllidx'|'hllrank'|'vec'|'ivfa'|'ivfc'|'ivfv'), in exactly
        the layout of the device lane."""
        if kind == "ids":
            return self._pad_ids(self.dict_ids)
        if kind == "mv":
            arr = self.mv_dict_ids
            card = self.metadata.cardinality
            out = np.full((padded_size(arr.shape[0]), arr.shape[1]), card,
                          dtype=min_id_dtype(card))
            out[: arr.shape[0]] = arr
            return out
        if kind == "raw":
            arr = self.raw_values
            if arr.dtype.kind not in "iuf":
                raise TypeError(f"column {self.metadata.name}: a raw "
                                f"{arr.dtype} column has no device lane")
            out = np.zeros(padded_size(len(arr)), dtype=arr.dtype)
            out[: len(arr)] = arr
            return out
        if kind == "parts":
            n_parts, min_v = self.int_part_info()
            table = int_part_table(self.dictionary.values, n_parts, min_v)
            return table[:, self.host_operand("ids")]
        if kind == "vlane":
            vals = np.asarray(self.dictionary.values, dtype=np.float64)
            vals = np.concatenate([vals, [0.0]])
            return vals[self.host_operand("ids")]
        if kind == "vec":
            mat = self.vec_values
            out = np.zeros((padded_size(len(mat)),
                            vec_dim_pad(self.metadata.vector_dimension)),
                           dtype=np.float32)
            out[: len(mat), : mat.shape[1]] = mat
            return out
        if kind in ("ivfa", "ivfc", "ivfv"):
            from pinot_tpu_torch.index import ivf
            c = int(self.ivf_centroids.shape[0])
            if kind == "ivfa":
                return ivf.assignment_lane(
                    self.ivf_assignments, c,
                    padded_size(len(self.ivf_assignments)))
            if kind == "ivfc":
                return ivf.centroid_lane(self.ivf_centroids)
            return ivf.validity_lane(self.ivf_assignments, c)
        if kind in ("hllidx", "hllrank"):
            if self._hll_tables is None:
                with self._lane_lock:
                    if self._hll_tables is None:
                        self._hll_tables = hll_tables_padded(
                            self.dictionary.values)
            return self._hll_tables[0 if kind == "hllidx" else 1]
        raise ValueError(kind)

    def _pad_ids(self, ids: np.ndarray) -> np.ndarray:
        card = self.metadata.cardinality     # padding id == cardinality
        out = np.full(padded_size(len(ids)), card, dtype=min_id_dtype(card))
        out[: len(ids)] = ids
        return out

    #: _device key -> its lane kind (host_operand) and ledger kind
    _LANE_KINDS = {"dict_ids": "ids", "mv_dict_ids": "mv",
                   "raw_values": "raw", "part_lanes": "parts",
                   "value_lane": "vlane", "vec_values": "vec",
                   "ivf_assign": "ivfa", "ivf_centroids": "ivfc",
                   "ivf_valid": "ivfv", "hll_idx": "hllidx",
                   "hll_rank": "hllrank"}
    _LEDGER_KINDS = {"vec_values": "vector", "hll_idx": "hll",
                     "hll_rank": "hll", "ivf_assign": "vector",
                     "ivf_centroids": "vector", "ivf_valid": "vector"}

    def _device(self, key: str, kind: str) -> torch.Tensor:
        lane = self._dev.get(key)
        if lane is None:
            with self._lane_lock:
                lane = self._dev.get(key)
                if lane is None:
                    lane = self._upload(key, kind)
        return lane

    def _upload(self, key: str, kind: str) -> torch.Tensor:
        """One lane onto the segment's device through the ledger, from its
        host copy when a demotion left one (caller holds _lane_lock)."""
        from pinot_tpu_torch.obs import residency
        seg = self._segment
        if self._dev_finalizer is None:
            # a collected DataSource (a superseded frozen snapshot, a
            # dropped segment) leaves the books with its lanes
            self._dev_finalizer = weakref.finalize(
                self, residency.LEDGER.release_prefix, f"ds:{id(self)}:")
        where = dict(device=seg.device, owner=f"ds:{id(self)}:{key}",
                     table=seg.metadata.table_name or "",
                     segment=seg.segment_name,
                     kind=self._LEDGER_KINDS.get(key, "scan"))
        host = self._host_lanes.pop(key, None)
        if host is not None:
            lane = residency.ledgered_put(host, non_blocking=True, **where)
        else:
            lane = residency.ledgered_asarray(self.host_operand(kind),
                                              **where)
        self._dev[key] = lane
        return lane

    def release_device(self) -> None:
        """Drop every device lane, its host copy and its ledger entries
        (a rebind to another device, a drop); the next use uploads
        again from the host arrays."""
        from pinot_tpu_torch.obs import residency
        with self._lane_lock:
            self._dev.clear()
            self._host_lanes.clear()
            residency.LEDGER.release_prefix(f"ds:{id(self)}:")

    def demote_device(self) -> None:
        """The device → host step: each resident lane copied into host
        memory (pinned when it lies on the card, so the next warm_device
        is one asynchronous copy), then the device lanes and their ledger
        entries dropped."""
        from pinot_tpu_torch.obs import residency
        with self._lane_lock:
            for key, lane in self._dev.items():
                host = lane.cpu()         # the lane itself on the CPU
                self._host_lanes[key] = host.pin_memory() if lane.is_cuda \
                    else host
            self._dev.clear()
            residency.LEDGER.release_prefix(f"ds:{id(self)}:")

    def warm_device(self) -> None:
        """Upload the lanes a demotion left in host memory, or, for a
        column never demoted, its id / raw / MV / vector lane."""
        with self._lane_lock:
            keys = list(self._host_lanes) or self._base_lane_keys()
            for key in keys:
                if key not in self._dev:
                    self._upload(key, self._LANE_KINDS[key])

    def _base_lane_keys(self) -> list:
        if self.dict_ids is not None:
            return ["dict_ids"]
        if self.vec_values is not None:
            return ["vec_values"]
        if self.raw_values is not None and \
                self.raw_values.dtype.kind in "iuf":
            return ["raw_values"]
        if self.mv_dict_ids is not None:
            return ["mv_dict_ids"]
        return []

    def device_bytes_estimate(self) -> int:
        """Bytes warm_device would put on the device for this column,
        from shapes alone (nothing is uploaded): the host copies a
        demotion left, else the base lane (pinot_tpu/segment/loader.py:
        357, the residency manager's admission charge)."""
        if self._host_lanes:
            return sum(t.untyped_storage().nbytes()
                       for t in self._host_lanes.values())
        cm = self.metadata
        keys = self._base_lane_keys()
        if not keys:
            return 0
        if keys[0] == "dict_ids":
            return padded_size(len(self.dict_ids)) * \
                min_id_dtype(cm.cardinality).itemsize
        if keys[0] == "vec_values":
            return padded_size(len(self.vec_values)) * \
                vec_dim_pad(cm.vector_dimension) * 4
        if keys[0] == "raw_values":
            return padded_size(len(self.raw_values)) * \
                self.raw_values.dtype.itemsize
        mv = self.mv_dict_ids
        return padded_size(mv.shape[0]) * mv.shape[1] * \
            min_id_dtype(cm.cardinality).itemsize

    def release_host(self) -> None:
        """Drop the row payloads (forward ids, raw values, MV ids,
        embeddings, IVF assignments) and the lanes' host copies for the
        disk tier; dictionaries, inverted and bloom indexes and the IVF
        codebook stay (pinot_tpu/segment/loader.py:395)."""
        with self._lane_lock:
            self.dict_ids = None
            self.raw_values = None
            self.mv_dict_ids = None
            self.vec_values = None
            self.ivf_assignments = None
            self._hll_tables = None
            self._host_lanes.clear()

    def adopt_host(self, fresh: "DataSource") -> None:
        """Take the row payloads back from a fresh load of the same
        column (the disk tier's reload), keeping this object."""
        with self._lane_lock:
            self.dict_ids = fresh.dict_ids
            self.raw_values = fresh.raw_values
            self.mv_dict_ids = fresh.mv_dict_ids
            self.vec_values = fresh.vec_values
            self.ivf_assignments = fresh.ivf_assignments

    def device_bytes(self) -> int:
        """Bytes this column holds on its device now."""
        return sum(t.numel() * t.element_size() for t in self._dev.values())


class ImmutableSegment:
    """A queryable immutable segment whose lanes live on one device."""

    def __init__(self, metadata: SegmentMetadata,
                 data_sources: Dict[str, DataSource], device=None):
        self.metadata = metadata
        self._data_sources = data_sources
        for ds in data_sources.values():
            if ds._segment is None:
                ds._segment = self
        self._device: Optional[torch.device] = \
            None if device is None else resolve_device(device)
        self._bind_lock = threading.Lock()
        # pre-aggregated cubes (startree/cube.py), host arrays; the
        # loader fills them from the segment directory
        self.star_trees: list = []
        # primary-key upsert liveness (realtime/upsert.py:ValidDocIds),
        # attached by the upsert manager or a consuming segment's freeze;
        # its device lane is cached by the bitmap's version
        self.valid_doc_ids = None
        self._valid_dev: Optional[Tuple[int, torch.Tensor]] = None
        self._valid_finalizer = None         # set on first vdoc upload
        self.vdoc_uploads = 0          # vdoc lane uploads since load
        self.vdoc_upload_bytes = 0

    @property
    def device(self) -> torch.device:
        """The device the lanes live on; the card unless a caller moved
        the segment elsewhere with `to`."""
        if self._device is None:
            self._device = resolve_device(None)
        return self._device

    def to(self, device) -> "ImmutableSegment":
        """Bind the segment to `device`; lanes already uploaded to another
        device are dropped and re-uploaded on next use."""
        device = resolve_device(device)
        if self._device != device:
            with self._bind_lock:     # concurrent first queries bind once
                if self._device != device:
                    self.destroy()
                    self._device = device
        return self

    @property
    def segment_name(self) -> str:
        return self.metadata.segment_name

    @property
    def num_docs(self) -> int:
        return self.metadata.total_docs

    @property
    def padded_docs(self) -> int:
        return padded_size(self.metadata.total_docs)

    @property
    def column_names(self):
        return list(self._data_sources.keys())

    def data_source(self, column: str) -> DataSource:
        try:
            return self._data_sources[column]
        except KeyError:
            raise KeyError(f"column '{column}' not in segment "
                           f"'{self.segment_name}'") from None

    def has_column(self, column: str) -> bool:
        return column in self._data_sources

    def device_valid_lane(self) -> torch.Tensor:
        """uint8 [P] upsert liveness lane (1 = live) on the segment's
        device, uploaded again only when the bitmap's version moves.
        Padding rows are 0. The version is read before the mask is
        copied, so a bump in between leaves a lane at least as new as its
        key (the next query re-uploads; a stale mask is never served
        under a newer version). A query reads the lane once, so it sees
        one version even while the bitmap changes under it. The lane is
        ledgered as kind "vdoc" (owner `seg:<id>:vdoc`, replaced on each
        upload)."""
        from pinot_tpu_torch.obs import residency
        vd = self.valid_doc_ids
        ver = vd.version
        cached = self._valid_dev
        if cached is None or cached[0] != ver:
            host = np.zeros(self.padded_docs, dtype=np.uint8)
            host[: self.num_docs] = vd.valid_mask(0, self.num_docs)
            if self._valid_finalizer is None:
                self._valid_finalizer = weakref.finalize(
                    self, residency.LEDGER.release, f"seg:{id(self)}:vdoc")
            cached = (ver, residency.ledgered_asarray(
                host, device=self.device, owner=f"seg:{id(self)}:vdoc",
                table=self.metadata.table_name or "",
                segment=self.segment_name, kind="vdoc"))
            self._valid_dev = cached
            self.vdoc_uploads += 1
            self.vdoc_upload_bytes += host.nbytes
        return cached[1]

    def _drop_valid_lane(self) -> None:
        from pinot_tpu_torch.obs import residency
        self._valid_dev = None
        residency.LEDGER.release(f"seg:{id(self)}:vdoc")

    def destroy(self) -> None:
        """Drop every device lane (the vdoc lane too) and their host
        copies; host arrays stay, and the lanes upload again on next
        use."""
        self._drop_valid_lane()
        for ds in self._data_sources.values():
            ds.release_device()

    def device_bytes(self) -> int:
        """Bytes this segment holds on its device now, the vdoc lane
        included."""
        cached = self._valid_dev
        return sum(ds.device_bytes() for ds in self._data_sources.values()) \
            + (0 if cached is None else cached[1].numel())

    # -- residency tiers (server/residency_manager.py) ----------------------
    def warm_device(self, columns=None) -> None:
        """Upload the named columns' lanes (all by default): what a
        demotion left in host memory, else each column's base lane."""
        for name in (columns or self.column_names):
            self.data_source(name).warm_device()

    def device_bytes_estimate(self) -> int:
        """Bytes a full warm_device (plus the vdoc lane, where a bitmap is
        attached) would put on the device, from shapes alone: the
        residency manager's admission charge."""
        total = sum(ds.device_bytes_estimate()
                    for ds in self._data_sources.values())
        if self.valid_doc_ids is not None:
            total += self.padded_docs
        return total

    def release_device_lanes(self) -> None:
        """The device → host demotion: every lane copied to host memory
        (pinned from the card) and dropped from the device, with its
        ledger entry; the vdoc lane is dropped (it rebuilds from the
        bitmap). Host arrays stay; warm_device or the next use uploads
        again."""
        self._drop_valid_lane()
        for ds in self._data_sources.values():
            ds.demote_device()

    def release_host_lanes(self, columns) -> None:
        """Drop the named columns' row payloads and lane copies (the host
        → disk demotion); only columns the artifact restores are named."""
        for name in columns:
            ds = self._data_sources.get(name)
            if ds is not None:
                ds.release_host()

    def rebind_host_lanes(self, fresh: "ImmutableSegment") -> None:
        """Take the row payloads back from a fresh load of the same
        artifact (the disk tier's reload), keeping this object, which the
        data manager and the caches hold."""
        for name, ds in self._data_sources.items():
            src = fresh._data_sources.get(name)
            if src is not None:
                ds.adopt_host(src)


def segment_host_bytes(seg) -> int:
    """Host bytes of a segment's row payloads and dictionaries (object
    string arrays by their encoded payload), as
    pinot_tpu/segment/loader.py:segment_host_bytes counts them."""
    def _arr_bytes(arr) -> int:
        if arr is None or not hasattr(arr, "nbytes"):
            return 0
        if getattr(arr, "dtype", None) is not None and arr.dtype.kind == "O":
            return int(sum(len(str(v).encode("utf-8", "replace"))
                           for v in arr.ravel()))
        return int(arr.nbytes)

    total = 0
    for name in seg.column_names:
        ds = seg.data_source(name)
        for arr in (getattr(ds, "dict_ids", None),
                    getattr(ds, "raw_values", None),
                    getattr(ds, "mv_dict_ids", None),
                    getattr(ds, "vec_values", None)):
            total += _arr_bytes(arr)
        total += _arr_bytes(getattr(getattr(ds, "dictionary", None),
                                    "values", None))
    return total


class ImmutableSegmentLoader:
    """load(segment_dir) → ImmutableSegment.

    Counterpart of pinot_tpu/segment/loader.py:ImmutableSegmentLoader:
    read metadata, then per column its dictionary, forward index (SV
    bit-packed, sorted ranges, MV, raw, VECTOR block) and inverted /
    bloom / IVF indexes, then the star-tree cubes.
    Host arrays only: each device lane uploads on first use, to the
    device the segment is bound to (QueryEngine binds it).
    """

    @staticmethod
    def load(seg_dir: str, device=None) -> ImmutableSegment:
        seg_dir = fmt.open_dir(seg_dir)      # v1 dir or v3 columns.psf
        meta = SegmentMetadata.load(seg_dir)
        sources: Dict[str, DataSource] = {}
        for name, cm in meta.columns.items():
            ds = DataSource(cm, None)
            if cm.data_type == DataType.VECTOR:
                ds.vec_values = read_vec_fwd(seg_dir, name)
                from pinot_tpu_torch.index import ivf
                index = ivf.load_index(seg_dir, name)
                if index is not None:
                    ds.ivf_centroids = index.centroids
                    ds.ivf_assignments = index.assignments
                    ds.ivf_meta = index.meta
                sources[name] = ds
                continue
            if not cm.has_dictionary and not cm.data_type.is_numeric:
                raise NotImplementedError(
                    f"column {name}: no-dictionary {cm.data_type.name} "
                    "columns are not in the port yet")
            if not cm.has_dictionary:
                ds.raw_values = read_raw_fwd(seg_dir, name)
            else:
                ds.dictionary = Dictionary.load(seg_dir, name, cm.data_type)
                if cm.single_value:
                    ds.dict_ids = read_sv_fwd(seg_dir, name,
                                              cm.bits_per_element,
                                              meta.total_docs)
                    if cm.sorted:
                        ds.sorted_ranges = read_sorted_fwd(seg_dir, name)
                else:
                    flat, offs = read_mv_fwd(seg_dir, name)
                    ds.mv_dict_ids = mv_to_padded(flat, offs, cm.cardinality)
                if cm.has_inverted_index:
                    ds.inverted_index = InvertedIndexReader.load(
                        seg_dir, name, meta.total_docs)
                if cm.has_bloom_filter:
                    ds.bloom_filter = BloomFilter.load(seg_dir, name)
            sources[name] = ds
        seg = ImmutableSegment(meta, sources, device)
        seg.star_trees = load_star_trees(seg_dir)
        return seg
