"""Segment builder: rows → immutable columnar segment directory.

Counterpart of pinot_tpu/segment/creator.py. It writes the same files,
byte for byte, apart from the creation time in metadata.json, and, where
the table config asks for an IVF index on a VECTOR column, the
`{col}.ivf.*` files and the `ivf.*` custom keys: the codebook is trained
on the card (index/ivf.py over K10 / K11), whose sums run in another
order than XLA's. Star-tree cubes (the table config's
starTreeIndexConfigs) are built at seal from the ids and metric values the
build holds in memory, as the JAX creator builds them (startree/cube.py:
build_cube_from_arrays), into the same `startree.<i>.{npz,json}` files;
a rebuild into the same directory first removes the old ones. Not in the
port yet: derived HLL columns, column partition metadata, chunked
no-dictionary STRING / BYTES columns, fixed (table-wide) dictionaries and
the v3 single-file layout; a schema or table config that asks for one
raises.

Parity: pinot-core/.../segment/creator/impl/SegmentIndexCreationDriverImpl.java
(two-pass build: stats pass → dictionary creation → index pass → seal) and
SegmentColumnarIndexCreator.java:72-288 (per-column dictionary + forward +
inverted + bloom writers). Input is either an iterable of row dicts (the
GenericRow path) or a columnar dict of numpy arrays (the fast path the TPU
build prefers — ingestion is columnar end-to-end).
"""
from __future__ import annotations

import glob
import json
import os
import time
from typing import Dict, Iterable, Optional

import numpy as np

from pinot_tpu_torch.common.datatype import DataType
from pinot_tpu_torch.common.schema import Schema
from pinot_tpu_torch.common.table_config import TableConfig
from pinot_tpu_torch.segment import format as fmt
from pinot_tpu_torch.segment.bloom import BloomFilter
from pinot_tpu_torch.segment.dictionary import Dictionary
from pinot_tpu_torch.segment.fwd import (SVForwardIndexWriter,
                                         bits_required, write_mv_fwd,
                                         write_raw_fwd, write_sorted_fwd,
                                         write_vec_fwd)
from pinot_tpu_torch.segment.inverted import InvertedIndexWriter
from pinot_tpu_torch.segment.metadata import ColumnMetadata, SegmentMetadata
from pinot_tpu_torch.startree.cube import (StarTreeConfig,
                                           build_cube_from_arrays)


class DictionaryEncodedColumn:
    """Columnar ingestion fast path: a column arriving as (candidate
    value pool, per-row indices) — the Arrow/Parquet dictionary-encoded
    layout (parity: the reference ingests dictionary-encoded Parquet
    pages the same way). The built segment is byte-identical to one
    built from the decoded values: the per-segment dictionary still
    contains ONLY values present in this segment's rows, sorted, with
    the same ids — but the build is O(n + pool) LUT work instead of
    hashing n (possibly string) values."""

    def __init__(self, values: np.ndarray, indices: np.ndarray):
        self.values = np.asarray(values)
        self.indices = np.asarray(indices)

    def __len__(self) -> int:
        return len(self.indices)

    def decode(self) -> np.ndarray:
        return self.values[self.indices]

    def build_dictionary(self, data_type):
        """(per-segment Dictionary of present values, remapped ids)."""
        pool = len(self.values)
        presence = np.zeros(pool, bool)
        presence[self.indices] = True
        present = np.flatnonzero(presence)
        vals = self.values[present]
        if vals.dtype.kind != "O":
            vals = vals.astype(data_type.np_dtype)   # field dtype, like
            #                                          the decoded path
        order = np.argsort(vals, kind="stable")      # pool-scale: tiny
        lut = np.zeros(pool, np.int32)
        lut[present[order]] = np.arange(len(present), dtype=np.int32)
        dictionary = Dictionary(data_type, vals[order])
        return dictionary, lut[self.indices]


class SegmentCreator:
    """Builds one immutable segment from records."""

    def __init__(self, schema: Schema, table_config: Optional[TableConfig] = None,
                 segment_name: Optional[str] = None,
                 ivf_priors: Optional[Dict[str, object]] = None,
                 device=None):
        """`ivf_priors`: column → an IvfIndex whose codebook a rebuilt
        segment keeps (the compaction path: rows are reassigned, the
        trained baseline carried). `device`: where IVF codebooks train
        and assign (None: the card; the tests pass "cpu")."""
        self.schema = schema
        self.table_config = table_config or TableConfig(schema.schema_name)
        self.segment_name = segment_name
        self.ivf_priors = ivf_priors or {}
        self.device = device
        self.ivf_seconds = 0.0   # host wall time of IVF builds, all builds

    # -- input normalization ----------------------------------------------
    def _columnarize(self, rows: Iterable[dict]) -> Dict[str, list]:
        cols: Dict[str, list] = {f.name: [] for f in self.schema.fields}
        for row in rows:
            for f in self.schema.fields:
                v = row.get(f.name)
                if f.single_value:
                    cols[f.name].append(f.convert(v))
                else:
                    vs = v if isinstance(v, (list, tuple)) else (
                        [] if v is None else [v])
                    cols[f.name].append([f.convert(x) for x in vs] or
                                        [f.default_null_value])
        return cols

    # -- build -------------------------------------------------------------
    def build(self, records, out_dir: str) -> SegmentMetadata:
        """records: Iterable[dict] (row path) or Dict[str, np.ndarray]
        (columnar path)."""
        if isinstance(records, dict):
            columns = {k: v if isinstance(v, (np.ndarray,
                                              DictionaryEncodedColumn))
                       else list(v)
                       for k, v in records.items()}
        else:
            columns = self._columnarize(records)

        os.makedirs(out_dir, exist_ok=True)
        # a rebuild into the same dir must not serve a previous build's
        # pre-aggregations against the new rows
        for stale in glob.glob(os.path.join(out_dir, "startree.*")):
            os.remove(stale)
        idx_cfg = self.table_config.indexing_config
        _check_supported(self.schema, idx_cfg)
        num_docs = None
        col_meta: Dict[str, ColumnMetadata] = {}

        # columns the star-tree cubes need, kept in memory through the
        # build so sealing never re-reads the segment from disk
        st_configs = [StarTreeConfig.from_json(c) if isinstance(c, dict)
                      else c for c in idx_cfg.star_tree_configs or []]
        st_dims = {d for c in st_configs for d in c.dimensions}
        st_metrics = {m for c in st_configs for m in c.metrics}
        st_dim_lanes: Dict[str, tuple] = {}
        st_metric_vals: Dict[str, np.ndarray] = {}
        # IVF drift stats stamped into the metadata's custom map
        ivf_custom: Dict[str, str] = {}

        for field in self.schema.fields:
            name = field.name
            if name not in columns:
                raise ValueError(f"missing column {name}")
            raw = columns[name]
            if field.data_type == DataType.VECTOR:
                n = self._build_vector(field, raw, out_dir, ivf_custom,
                                       col_meta)
                if num_docs is None:
                    num_docs = n
                elif num_docs != n:
                    raise ValueError(
                        f"column {name} length {n} != {num_docs}")
                continue
            encoded = isinstance(raw, DictionaryEncodedColumn) and \
                field.single_value
            if encoded:
                arr = None                 # decoded lazily if ever needed
                n = len(raw)
            elif field.single_value:
                arr = np.asarray(raw, dtype=field.data_type.np_dtype)
                n = len(arr)
            else:
                lists = raw
                n = len(lists)
            if num_docs is None:
                num_docs = n
            elif num_docs != n:
                raise ValueError(f"column {name} length {n} != {num_docs}")

            no_dict = name in idx_cfg.no_dictionary_columns
            if no_dict and field.single_value:
                # raw forward index, no dictionary
                if encoded:
                    arr = np.asarray(raw.decode(),
                                     dtype=field.data_type.np_dtype)
                write_raw_fwd(out_dir, name, arr)
                if name in st_metrics:
                    st_metric_vals[name] = arr.astype(np.float64)
                col_meta[name] = ColumnMetadata(
                    name=name, data_type=field.data_type,
                    cardinality=int(len(np.unique(arr))),
                    bits_per_element=arr.dtype.itemsize * 8,
                    has_dictionary=False,
                    min_value=arr.min().item() if n else None,
                    max_value=arr.max().item() if n else None,
                    total_number_of_entries=n,
                    default_null_value=field.default_null_value)
                continue

            # -- stats pass + dictionary -----------------------------------
            if field.single_value:
                if encoded:
                    # dictionary-encoded columnar input: LUT remap, no
                    # value hashing (output identical to the decoded path)
                    dictionary, ids = raw.build_dictionary(field.data_type)
                else:
                    dictionary, ids = Dictionary.build_encoded(
                        field.data_type, arr)
                is_sorted = bool(np.all(ids[:-1] <= ids[1:])) if n > 1 else True
                total_entries = n
                max_mv = 0
            else:
                flat_vals = np.asarray(
                    [v for row in lists for v in row],
                    dtype=field.data_type.np_dtype)
                dictionary, flat_ids = Dictionary.build_encoded(
                    field.data_type, flat_vals)
                counts = np.array([len(row) for row in lists], dtype=np.int64)
                offsets = np.zeros(n + 1, dtype=np.int64)
                np.cumsum(counts, out=offsets[1:])
                is_sorted = False
                total_entries = int(counts.sum())
                max_mv = int(counts.max()) if n else 0

            dictionary.save(out_dir, name)
            card = dictionary.cardinality
            if field.single_value:
                if name in st_dims:
                    st_dim_lanes[name] = (ids, card)
                if name in st_metrics and field.data_type.is_numeric:
                    st_metric_vals[name] = np.asarray(
                        dictionary.values, dtype=np.float64)[ids]

            # -- forward index ---------------------------------------------
            if field.single_value:
                SVForwardIndexWriter.write(out_dir, name, ids, card)
                if is_sorted:
                    write_sorted_fwd(out_dir, name, ids, card)
            else:
                write_mv_fwd(out_dir, name, flat_ids, offsets)

            # -- inverted index --------------------------------------------
            has_inv = name in idx_cfg.inverted_index_columns
            if has_inv:
                if field.single_value:
                    InvertedIndexWriter.write(out_dir, name, ids, card)
                else:
                    # MV inverted index: posting of doc ids per value
                    doc_of_entry = np.repeat(np.arange(n), counts)
                    order = np.argsort(flat_ids, kind="stable")
                    docids = doc_of_entry[order].astype(np.int32)
                    offs = np.searchsorted(flat_ids[order],
                                           np.arange(card + 1)).astype(np.int64)
                    np.save(os.path.join(out_dir,
                                         fmt.INV_DOCIDS.format(col=name)),
                            docids)
                    np.save(os.path.join(out_dir,
                                         fmt.INV_OFFSETS.format(col=name)),
                            offs)

            # -- bloom filter ----------------------------------------------
            has_bloom = name in idx_cfg.bloom_filter_columns
            if has_bloom:
                bf = BloomFilter.with_capacity(card)
                for v in dictionary.values:
                    bf.add(v)
                bf.save(out_dir, name)

            col_meta[name] = ColumnMetadata(
                name=name, data_type=field.data_type, cardinality=card,
                bits_per_element=bits_required(card),
                single_value=field.single_value, sorted=is_sorted,
                has_dictionary=True, has_inverted_index=has_inv,
                has_bloom_filter=has_bloom,
                min_value=_plain(dictionary.min_value),
                max_value=_plain(dictionary.max_value),
                max_number_of_multi_values=max_mv,
                total_number_of_entries=total_entries,
                default_null_value=field.default_null_value)

        num_docs = num_docs or 0

        # -- time range ---------------------------------------------------
        tcol = self.schema.time_column
        start_t = end_t = None
        time_col_name = time_unit = None
        if tcol and tcol.name in col_meta:
            time_col_name = tcol.name
            time_unit = tcol.time_unit.name if tcol.time_unit else None
            start_t = col_meta[tcol.name].min_value
            end_t = col_meta[tcol.name].max_value

        seg_name = self.segment_name or _default_segment_name(
            self.schema.schema_name, start_t, end_t)
        meta = SegmentMetadata(
            segment_name=seg_name, table_name=self.schema.schema_name,
            total_docs=num_docs, columns=col_meta,
            time_column=time_col_name, time_unit=time_unit,
            start_time=start_t, end_time=end_t,
            creation_time_ms=int(time.time() * 1000),
            custom=ivf_custom)
        meta.save(out_dir)
        with open(os.path.join(out_dir, fmt.CREATION_META_FILE), "w") as f:
            json.dump({"creator": "pinot_tpu", "version": fmt.SEGMENT_VERSION},
                      f)
        n_cubes = 0
        for config in st_configs:
            cube = build_cube_from_arrays(config, st_dim_lanes,
                                          st_metric_vals)
            if cube is not None:
                cube.save(out_dir, n_cubes)
                n_cubes += 1
        # seal: stamp the artifact crc into metadata.json (parity:
        # CrcUtils at the end of SegmentIndexCreationDriverImpl.build)
        from pinot_tpu_torch.segment.integrity import stamp_crc
        meta.crc = stamp_crc(out_dir)
        return meta

    def _build_vector(self, field, raw, out_dir: str,
                      ivf_custom: Dict[str, str],
                      col_meta: Dict[str, ColumnMetadata]) -> int:
        """A VECTOR column: the packed float32 forward block (no
        dictionary, inverted or bloom index: embeddings are dense and all
        but all-distinct), and at seal the IVF index the table config asks
        for (tableIndexConfig.vectorIndexConfigs). Returns its rows."""
        name = field.name
        if isinstance(raw, np.ndarray) and raw.ndim == 2:
            mat = np.asarray(raw, dtype=np.float32)
            if mat.shape[1] != field.vector_dimension:
                raise ValueError(
                    f"column {name}: vector width {mat.shape[1]} "
                    f"!= schema dimension {field.vector_dimension}")
            # the columnar path bypasses field.convert: repeat its finite
            # guard, so NaN / Inf reach neither a score nor a codebook
            if mat.size and not np.isfinite(mat).all():
                raise ValueError(f"column {name}: NaN/Inf embedding values")
        else:
            mat = np.stack([field.convert(v) for v in raw]) if len(raw) \
                else np.zeros((0, field.vector_dimension), np.float32)
        n = len(mat)
        write_vec_fwd(out_dir, name, mat)
        from pinot_tpu_torch.index import ivf as ivf_mod
        ivf_cfg = ivf_mod.column_config(self.table_config, name)
        if ivf_cfg is not None and n:
            t0 = time.perf_counter()
            index = ivf_mod.build_for_column(
                mat, ivf_cfg, priors=self.ivf_priors.get(name),
                device=self.device)
            self.ivf_seconds += time.perf_counter() - t0
            ivf_mod.write_index(out_dir, name, index)
            ivf_mod.stamp_custom(ivf_custom, name, index.meta)
        col_meta[name] = ColumnMetadata(
            name=name, data_type=field.data_type, cardinality=n,
            bits_per_element=32, has_dictionary=False,
            total_number_of_entries=n,
            vector_dimension=field.vector_dimension)
        return n


def _check_supported(schema: Schema, idx_cfg) -> None:
    """Raise on what the JAX creator builds and this one does not yet."""
    missing = []
    if (idx_cfg.hll_config or {}).get("columnsToDerive"):
        missing.append("derived HLL columns")
    if idx_cfg.segment_partition_config:
        missing.append("column partition metadata")
    if idx_cfg.segment_version != "v1":
        missing.append("the v3 single-file layout")
    if any(not f.data_type.is_numeric for f in schema.fields
           if f.name in idx_cfg.no_dictionary_columns):
        missing.append("no-dictionary STRING / BYTES columns")
    if missing:
        raise NotImplementedError(
            "SegmentCreator of pinot_tpu_torch does not build "
            + ", ".join(missing) + " yet")


def _plain(v):
    if isinstance(v, np.generic):
        return v.item()
    return v


def _default_segment_name(table: str, start, end) -> str:
    if start is not None:
        return f"{table}_{start}_{end}_0"
    return f"{table}_{int(time.time())}_0"
