"""Table configuration model.

Parity: pinot-common/src/main/java/org/apache/pinot/common/config/
{TableConfig,SegmentsValidationAndRetentionConfig,IndexingConfig,
TenantConfig,TableCustomConfig}.java — same JSON shape for the subset that
drives the engine: table type, retention, indexing (inverted/no-dictionary/
bloom/star-tree/sorted), stream configs and replication.
"""
from __future__ import annotations

import dataclasses
import enum
import json
from typing import Dict, List, Optional


class TableType(enum.Enum):
    OFFLINE = "OFFLINE"
    REALTIME = "REALTIME"


@dataclasses.dataclass
class IndexingConfig:
    inverted_index_columns: List[str] = dataclasses.field(default_factory=list)
    no_dictionary_columns: List[str] = dataclasses.field(default_factory=list)
    bloom_filter_columns: List[str] = dataclasses.field(default_factory=list)
    sorted_column: Optional[str] = None
    star_tree_configs: List[dict] = dataclasses.field(default_factory=list)
    load_mode: str = "MMAP"  # MMAP | HEAP (host) — device copy is explicit
    stream_configs: Dict[str, str] = dataclasses.field(default_factory=dict)
    aggregate_metrics: bool = False
    # column → {"functionName": ..., "numPartitions": N} (parity:
    # SegmentPartitionConfig); the segment creator records each built
    # segment's observed partition ids in its metadata
    segment_partition_config: Dict[str, dict] = dataclasses.field(
        default_factory=dict)
    # "v1" (file-per-index) | "v3" (single columns.psf container with
    # per-member DEFLATE — parity: SegmentVersion + ChunkCompressor)
    segment_version: str = "v1"
    # parity: startree/hll HllConfig — {"columnsToDerive": [...],
    # "log2m": N, "suffix": "_hll"}: the creator adds a derived column of
    # per-row serialized HLLs per origin, targeted by the FASTHLL rewrite
    hll_config: Optional[dict] = None
    # VECTOR column → IVF index config: {"type": "IVF", "numCentroids",
    # "trainIterations", "seed", "trainSampleSize"} (index/ivf.py
    # defaults apply). The creator trains a per-segment codebook at
    # seal; absent columns stay exact-scan.
    vector_index_configs: Dict[str, dict] = dataclasses.field(
        default_factory=dict)

    def to_json(self) -> dict:
        return {
            "invertedIndexColumns": self.inverted_index_columns,
            "noDictionaryColumns": self.no_dictionary_columns,
            "bloomFilterColumns": self.bloom_filter_columns,
            "sortedColumn": [self.sorted_column] if self.sorted_column else [],
            "starTreeConfigs": self.star_tree_configs,
            "loadMode": self.load_mode,
            "streamConfigs": self.stream_configs,
            "aggregateMetrics": self.aggregate_metrics,
            "segmentPartitionConfig": {
                "columnPartitionMap": self.segment_partition_config},
            "segmentFormatVersion": self.segment_version,
            "hllConfig": self.hll_config,
            "vectorIndexConfigs": self.vector_index_configs,
        }

    @classmethod
    def from_json(cls, d: dict) -> "IndexingConfig":
        sorted_cols = d.get("sortedColumn") or []
        return cls(
            inverted_index_columns=d.get("invertedIndexColumns") or [],
            no_dictionary_columns=d.get("noDictionaryColumns") or [],
            bloom_filter_columns=d.get("bloomFilterColumns") or [],
            sorted_column=sorted_cols[0] if sorted_cols else None,
            star_tree_configs=d.get("starTreeConfigs") or [],
            load_mode=d.get("loadMode", "MMAP"),
            stream_configs=d.get("streamConfigs") or {},
            aggregate_metrics=d.get("aggregateMetrics", False),
            segment_partition_config=(d.get("segmentPartitionConfig") or {}
                                      ).get("columnPartitionMap", {}),
            segment_version=d.get("segmentFormatVersion", "v1"),
            hll_config=d.get("hllConfig"),
            vector_index_configs=d.get("vectorIndexConfigs") or {},
        )


@dataclasses.dataclass
class SegmentsConfig:
    """Validation + retention config.

    Parity: SegmentsValidationAndRetentionConfig.
    """
    replication: int = 1
    retention_time_unit: Optional[str] = None   # e.g. "DAYS"
    retention_time_value: Optional[int] = None
    time_column_name: Optional[str] = None
    time_type: Optional[str] = None
    segment_push_type: str = "APPEND"           # APPEND | REFRESH
    segment_push_frequency: str = "DAILY"       # DAILY | HOURLY
    segment_assignment_strategy: str = "BalanceNumSegmentAssignmentStrategy"

    def to_json(self) -> dict:
        return {
            "replication": str(self.replication),
            "retentionTimeUnit": self.retention_time_unit,
            "retentionTimeValue": (str(self.retention_time_value)
                                   if self.retention_time_value else None),
            "timeColumnName": self.time_column_name,
            "timeType": self.time_type,
            "segmentPushType": self.segment_push_type,
            "segmentPushFrequency": self.segment_push_frequency,
            "segmentAssignmentStrategy": self.segment_assignment_strategy,
        }

    @classmethod
    def from_json(cls, d: dict) -> "SegmentsConfig":
        rv = d.get("retentionTimeValue")
        return cls(
            replication=int(d.get("replication", 1)),
            retention_time_unit=d.get("retentionTimeUnit"),
            retention_time_value=int(rv) if rv else None,
            time_column_name=d.get("timeColumnName"),
            time_type=d.get("timeType"),
            segment_push_type=d.get("segmentPushType", "APPEND"),
            segment_push_frequency=d.get("segmentPushFrequency", "DAILY"),
            segment_assignment_strategy=d.get(
                "segmentAssignmentStrategy",
                "BalanceNumSegmentAssignmentStrategy"),
        )


@dataclasses.dataclass
class UpsertConfig:
    """Primary-key upsert configuration.

    Parity: the reference's later-version UpsertConfig (mode FULL: the
    latest row per primary key wins; superseded rows are masked at query
    time via per-segment validDocIds). The primary key is one or more
    schema columns; the stream must partition rows by key so one
    partition owns each key's history (the standard Pinot deployment
    assumption — the key map is per-partition).
    """
    mode: str = "NONE"                   # NONE | FULL
    primary_key_columns: List[str] = dataclasses.field(default_factory=list)
    # snapshot the key map + validDocIds at every segment seal, so a
    # restarted server converges without replaying the topic from zero
    enable_snapshot: bool = True

    @property
    def enabled(self) -> bool:
        return self.mode.upper() == "FULL"

    def to_json(self) -> dict:
        return {"mode": self.mode.upper(),
                "primaryKeyColumns": list(self.primary_key_columns),
                "enableSnapshot": self.enable_snapshot}

    @classmethod
    def from_json(cls, d: dict) -> "UpsertConfig":
        return cls(mode=str(d.get("mode", "NONE")).upper(),
                   primary_key_columns=list(d.get("primaryKeyColumns") or []),
                   enable_snapshot=bool(d.get("enableSnapshot", True)))


@dataclasses.dataclass
class TenantConfig:
    broker: str = "DefaultTenant"
    server: str = "DefaultTenant"

    def to_json(self) -> dict:
        return {"broker": self.broker, "server": self.server}

    @classmethod
    def from_json(cls, d: dict) -> "TenantConfig":
        return cls(d.get("broker", "DefaultTenant"), d.get("server", "DefaultTenant"))


@dataclasses.dataclass
class QuotaConfig:
    storage: Optional[str] = None          # e.g. "100G"
    max_queries_per_second: Optional[float] = None

    def to_json(self) -> dict:
        return {"storage": self.storage,
                "maxQueriesPerSecond": self.max_queries_per_second}

    @classmethod
    def from_json(cls, d: dict) -> "QuotaConfig":
        q = d.get("maxQueriesPerSecond")
        return cls(d.get("storage"), float(q) if q is not None else None)


@dataclasses.dataclass
class RoutingConfig:
    """Broker routing-table builder selection (parity: RoutingConfig /
    routingTableBuilderName in the reference's table config)."""
    builder_name: Optional[str] = None   # balanced | replicagroup |
    #                                      largecluster (None = broker default)
    options: Dict[str, str] = dataclasses.field(default_factory=dict)

    def to_json(self) -> dict:
        d = {}
        if self.builder_name:
            d["routingTableBuilderName"] = self.builder_name
        if self.options:
            d["routingTableBuilderOptions"] = dict(self.options)
        return d

    @classmethod
    def from_json(cls, d: dict) -> "RoutingConfig":
        return cls(d.get("routingTableBuilderName"),
                   dict(d.get("routingTableBuilderOptions", {})))


@dataclasses.dataclass
class TableConfig:
    table_name: str                      # raw name, without type suffix
    table_type: TableType = TableType.OFFLINE
    segments_config: SegmentsConfig = dataclasses.field(default_factory=SegmentsConfig)
    indexing_config: IndexingConfig = dataclasses.field(default_factory=IndexingConfig)
    tenant_config: TenantConfig = dataclasses.field(default_factory=TenantConfig)
    quota_config: Optional[QuotaConfig] = None
    upsert_config: Optional[UpsertConfig] = None
    routing_config: RoutingConfig = dataclasses.field(
        default_factory=RoutingConfig)
    custom_config: Dict[str, str] = dataclasses.field(default_factory=dict)
    # task type → config map for the minion plane (parity: TableTaskConfig,
    # e.g. {"ConvertToRawIndexTask": {"columnsToConvert": "a,b"}})
    task_configs: Dict[str, Dict[str, str]] = dataclasses.field(
        default_factory=dict)

    @property
    def table_name_with_type(self) -> str:
        return f"{self.table_name}_{self.table_type.value}"

    def to_json(self) -> dict:
        d = {
            "tableName": self.table_name_with_type,
            "tableType": self.table_type.value,
            "segmentsConfig": self.segments_config.to_json(),
            "tableIndexConfig": self.indexing_config.to_json(),
            "tenants": self.tenant_config.to_json(),
            "metadata": {"customConfigs": self.custom_config},
        }
        if self.task_configs:
            d["task"] = {"taskTypeConfigsMap": self.task_configs}
        if self.quota_config:
            d["quota"] = self.quota_config.to_json()
        if self.upsert_config:
            d["upsertConfig"] = self.upsert_config.to_json()
        routing = self.routing_config.to_json()
        if routing:
            d["routing"] = routing
        return d

    def to_json_str(self) -> str:
        return json.dumps(self.to_json(), indent=2)

    @classmethod
    def from_json(cls, d: dict) -> "TableConfig":
        name = d["tableName"]
        ttype = TableType(d.get("tableType", "OFFLINE").upper())
        for suffix in ("_OFFLINE", "_REALTIME"):
            if name.endswith(suffix):
                name = name[: -len(suffix)]
        return cls(
            table_name=name,
            table_type=ttype,
            segments_config=SegmentsConfig.from_json(d.get("segmentsConfig", {})),
            indexing_config=IndexingConfig.from_json(d.get("tableIndexConfig", {})),
            tenant_config=TenantConfig.from_json(d.get("tenants", {})),
            quota_config=(QuotaConfig.from_json(d["quota"]) if d.get("quota")
                          else None),
            upsert_config=(UpsertConfig.from_json(d["upsertConfig"])
                           if d.get("upsertConfig") else None),
            custom_config=(d.get("metadata", {}) or {}).get("customConfigs", {}),
            routing_config=RoutingConfig.from_json(d.get("routing", {})
                                                   or {}),
            task_configs=(d.get("task", {}) or {}).get("taskTypeConfigsMap",
                                                       {}),
        )

    @classmethod
    def from_json_str(cls, s: str) -> "TableConfig":
        return cls.from_json(json.loads(s))


def raw_table_name(name: str) -> str:
    for suffix in ("_OFFLINE", "_REALTIME"):
        if name.endswith(suffix):
            return name[: -len(suffix)]
    return name
