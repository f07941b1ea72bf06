"""Segment metadata model.

Parity: pinot-core/.../segment/index/SegmentMetadataImpl.java +
metadata.properties — total docs, time range, per-column cardinality /
bits-per-element / sorted flag / min-max / index presence / partitions.
Stored as JSON instead of java properties.
"""
from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Dict, List, Optional

from pinot_tpu_torch.common.datatype import DataType
from pinot_tpu_torch.segment import format as fmt


@dataclasses.dataclass
class ColumnMetadata:
    name: str
    data_type: DataType
    cardinality: int
    bits_per_element: int
    single_value: bool = True
    sorted: bool = False
    has_dictionary: bool = True
    has_inverted_index: bool = False
    has_bloom_filter: bool = False
    min_value: Optional[object] = None
    max_value: Optional[object] = None
    max_number_of_multi_values: int = 0
    total_number_of_entries: int = 0
    partition_function: Optional[str] = None
    num_partitions: int = 0
    partitions: List[int] = dataclasses.field(default_factory=list)
    default_null_value: Optional[object] = None
    # derived-metric columns (parity: MetricFieldSpec.DerivedMetricType —
    # e.g. an HLL column holding per-row serialized sketches of
    # `derived_from`, targeted by the FASTHLL broker-request rewrite)
    derived_metric_type: Optional[str] = None
    derived_from: Optional[str] = None
    # VECTOR columns: fixed embedding dimension of the packed [n, dim]
    # float32 forward block
    vector_dimension: int = 0

    def to_json(self) -> dict:
        d = dataclasses.asdict(self)
        d["data_type"] = self.data_type.value
        if isinstance(self.min_value, bytes):
            d["min_value"] = self.min_value.hex()
            d["max_value"] = self.max_value.hex()
        return d

    @classmethod
    def from_json(cls, d: dict) -> "ColumnMetadata":
        d = dict(d)
        d["data_type"] = DataType(d["data_type"])
        obj = cls(**d)
        if obj.data_type == DataType.BYTES and isinstance(obj.min_value, str):
            obj.min_value = bytes.fromhex(obj.min_value)
            obj.max_value = bytes.fromhex(obj.max_value)
        return obj


@dataclasses.dataclass
class SegmentMetadata:
    segment_name: str
    table_name: str
    total_docs: int
    columns: Dict[str, ColumnMetadata]
    time_column: Optional[str] = None
    time_unit: Optional[str] = None
    start_time: Optional[int] = None
    end_time: Optional[int] = None
    segment_version: str = fmt.SEGMENT_VERSION
    creation_time_ms: int = 0
    crc: Optional[str] = None
    custom: Dict[str, str] = dataclasses.field(default_factory=dict)

    def column(self, name: str) -> ColumnMetadata:
        return self.columns[name]

    def get_derived_column(self, origin: str,
                           metric_type: str = "HLL") -> Optional[str]:
        """Derived-column lookup (parity: SegmentMetadataImpl
        .getDerivedColumn — the FASTHLL rewrite's metadata source)."""
        for cm in self.columns.values():
            if cm.derived_from == origin and \
                    cm.derived_metric_type == metric_type:
                return cm.name
        return None

    def to_json(self) -> dict:
        return {
            "segmentName": self.segment_name,
            "tableName": self.table_name,
            "totalDocs": self.total_docs,
            "timeColumn": self.time_column,
            "timeUnit": self.time_unit,
            "startTime": self.start_time,
            "endTime": self.end_time,
            "segmentVersion": self.segment_version,
            "creationTimeMs": self.creation_time_ms,
            "crc": self.crc,
            "custom": self.custom,
            "columns": {k: v.to_json() for k, v in self.columns.items()},
        }

    def save(self, seg_dir: str) -> None:
        with open(os.path.join(seg_dir, fmt.METADATA_FILE), "w") as f:
            json.dump(self.to_json(), f, indent=1, default=str)

    @classmethod
    def load(cls, seg_dir) -> "SegmentMetadata":
        d = json.loads(fmt.open_dir(seg_dir).read_text(fmt.METADATA_FILE))
        return cls(
            segment_name=d["segmentName"],
            table_name=d["tableName"],
            total_docs=d["totalDocs"],
            time_column=d.get("timeColumn"),
            time_unit=d.get("timeUnit"),
            start_time=d.get("startTime"),
            end_time=d.get("endTime"),
            segment_version=d.get("segmentVersion", fmt.SEGMENT_VERSION),
            creation_time_ms=d.get("creationTimeMs", 0),
            crc=d.get("crc"),
            custom=d.get("custom", {}),
            columns={k: ColumnMetadata.from_json(v)
                     for k, v in d["columns"].items()},
        )
