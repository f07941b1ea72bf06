"""Metrics registry: meters, gauges, and phase timers.

Parity: pinot-common/.../metrics/AbstractMetrics.java (typed
addMeteredTableValue / setValueOfTableGauge / addPhaseTiming over a yammer
MetricsRegistry) and the per-component subclasses BrokerMetrics /
ServerMetrics / ControllerMetrics with their Meter/Gauge/Timer enums
(BrokerMeter.java, BrokerQueryPhase.java, ServerMeter.java,
ServerQueryPhase.java). We keep one thread-safe registry per component;
metric names are plain strings (optionally suffixed with a table name the
way the reference's table-level metrics are), and timers keep a bounded
reservoir for percentiles instead of an exponentially-decaying sample.
"""
from __future__ import annotations

import bisect
import threading
import time
from collections import deque
from contextlib import contextmanager
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np


class Meter:
    """Monotonic event counter with a lifetime rate."""

    def __init__(self) -> None:
        self._count = 0
        self._t0 = time.monotonic()
        self._lock = threading.Lock()

    def mark(self, n: int = 1) -> None:
        with self._lock:
            self._count += n

    @property
    def count(self) -> int:
        return self._count

    def rate(self) -> float:
        """Events per second since the meter was created."""
        dt = time.monotonic() - self._t0
        return self._count / dt if dt > 0 else 0.0


class Gauge:
    """Last-value (or callable-backed) instantaneous metric."""

    def __init__(self) -> None:
        self._value: float = 0.0
        self._fn: Optional[Callable[[], float]] = None

    def set(self, value: float) -> None:
        self._fn = None
        self._value = float(value)

    def set_callable(self, fn: Callable[[], float]) -> None:
        self._fn = fn

    @property
    def value(self) -> float:
        if self._fn is not None:
            return float(self._fn())
        return self._value


class Timer:
    """Duration metric: count, total, mean, reservoir percentiles, and
    bounded log-scale histogram buckets (Prometheus exposition)."""

    RESERVOIR = 1024
    # log-scale millisecond bucket upper bounds: 0.25ms … ~131s in ×2
    # steps (20 buckets + overflow). Bounded and fixed, so exposition
    # output size and update cost are O(1) regardless of traffic.
    BUCKET_BOUNDS_MS: Tuple[float, ...] = tuple(
        0.25 * 2 ** i for i in range(20))

    def __init__(self) -> None:
        self._count = 0
        self._total_ms = 0.0
        self._samples: deque = deque(maxlen=self.RESERVOIR)
        self._buckets = [0] * (len(self.BUCKET_BOUNDS_MS) + 1)
        # percentile memo per requested tuple: ps -> (count at compute
        # time, values); a snapshot with no new updates since the last
        # one never re-runs np.percentile, and the hedge path's p95
        # probe doesn't thrash the snapshot's (50, 95, 99) entry
        self._pct_cache: Dict[Tuple[float, ...],
                              Tuple[int, List[float]]] = {}
        self._lock = threading.Lock()

    def update(self, ms: float) -> None:
        idx = bisect.bisect_left(self.BUCKET_BOUNDS_MS, ms)
        with self._lock:
            self._count += 1
            self._total_ms += ms
            self._samples.append(ms)
            self._buckets[idx] += 1

    @contextmanager
    def time(self):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.update((time.perf_counter() - t0) * 1e3)

    @property
    def count(self) -> int:
        return self._count

    @property
    def total_ms(self) -> float:
        return self._total_ms

    @property
    def mean_ms(self) -> float:
        return self._total_ms / self._count if self._count else 0.0

    def percentile_ms(self, p: float) -> float:
        return self.percentiles_ms((p,))[0]

    def percentiles_ms(self, ps: Sequence[float]) -> List[float]:
        """All requested percentiles in ONE np.percentile batch,
        memoized on the sample count — repeated snapshot()/exposition
        reads between updates cost a dict lookup, not an array sort."""
        ps = tuple(ps)
        with self._lock:
            hit = self._pct_cache.get(ps)
            if hit is not None and hit[0] == self._count:
                return list(hit[1])
            if not self._samples:
                return [0.0] * len(ps)
            vals = [float(v) for v in
                    np.percentile(np.asarray(self._samples), ps)]
            if len(self._pct_cache) > 8:     # bounded: ps tuples are few
                self._pct_cache.clear()
            self._pct_cache[ps] = (self._count, vals)
            return list(vals)

    def bucket_counts(self) -> List[int]:
        """Per-bucket (non-cumulative) counts; the last entry is the
        overflow bucket (> BUCKET_BOUNDS_MS[-1])."""
        with self._lock:
            return list(self._buckets)


class MetricsRegistry:
    """One component's metric namespace (broker / server / controller)."""

    def __init__(self, component: str = ""):
        self.component = component
        self._meters: Dict[str, Meter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._timers: Dict[str, Timer] = {}
        self._lock = threading.Lock()

    def meter(self, name: str, table: Optional[str] = None) -> Meter:
        return self._get(self._meters, Meter, name, table)

    def gauge(self, name: str, table: Optional[str] = None) -> Gauge:
        return self._get(self._gauges, Gauge, name, table)

    def timer(self, name: str, table: Optional[str] = None) -> Timer:
        return self._get(self._timers, Timer, name, table)

    def peek_timer(self, name: str,
                   table: Optional[str] = None) -> Optional[Timer]:
        """Read-only lookup that never registers a series — for probes
        keyed on unvalidated strings (e.g. request table names), where
        get-or-create would grow the registry without bound."""
        key = f"{table}.{name}" if table else name
        with self._lock:
            return self._timers.get(key)

    def _get(self, store, cls, name: str, table: Optional[str]):
        key = f"{table}.{name}" if table else name
        with self._lock:
            m = store.get(key)
            if m is None:
                m = store[key] = cls()
            return m

    SNAPSHOT_PERCENTILES = (50.0, 95.0, 99.0)

    def metric_maps(self) -> Tuple[Dict[str, Meter], Dict[str, Gauge],
                                   Dict[str, Timer]]:
        """Consistent shallow copies of the three metric maps (the
        Prometheus exposition renderer iterates these)."""
        with self._lock:
            return dict(self._meters), dict(self._gauges), \
                dict(self._timers)

    def snapshot(self) -> dict:
        """Flat JSON-able view of every registered metric.

        Timer percentiles are computed in one memoized np.percentile
        batch per timer (keyed on the update count), and the bounded
        log-scale histogram rides along as [upperBoundMs, count] pairs
        (None bound = overflow bucket)."""
        meters, gauges, timers = self.metric_maps()
        out: Dict[str, object] = {}
        for k, m in meters.items():
            out[f"meter.{k}.count"] = m.count
        for k, g in gauges.items():
            out[f"gauge.{k}"] = g.value
        bounds = list(Timer.BUCKET_BOUNDS_MS) + [None]
        for k, t in timers.items():
            out[f"timer.{k}.count"] = t.count
            out[f"timer.{k}.totalMs"] = round(t.total_ms, 3)
            out[f"timer.{k}.meanMs"] = round(t.mean_ms, 3)
            p50, p95, p99 = t.percentiles_ms(self.SNAPSHOT_PERCENTILES)
            out[f"timer.{k}.p50Ms"] = round(p50, 3)
            out[f"timer.{k}.p95Ms"] = round(p95, 3)
            out[f"timer.{k}.p99Ms"] = round(p99, 3)
            out[f"timer.{k}.buckets"] = [
                [bound, n] for bound, n in zip(bounds, t.bucket_counts())
                if n]
        return out


# -- metric name constants (parity: the reference's metric enums) ------------

class CommonGauge:
    # process-wide HBM residency metering (obs/residency.py ledger);
    # exposed by EVERY component with the kind (and per-table) label
    # riding the table-suffix convention as "<table>|<kind>"
    DEVICE_BYTES_RESIDENT = "deviceBytesResident"


class BrokerMeter:
    QUERIES = "queries"
    REQUEST_COMPILATION_EXCEPTIONS = "requestCompilationExceptions"
    RESOURCE_MISSING_EXCEPTIONS = "resourceMissingExceptions"
    QUERY_QUOTA_EXCEEDED = "queryQuotaExceeded"
    NO_SERVER_FOUND_EXCEPTIONS = "noServerFoundExceptions"
    REQUEST_DROPPED_DUE_TO_ACCESS_ERROR = "requestDroppedDueToAccessError"
    BROKER_RESPONSES_WITH_PARTIAL_SERVERS = "brokerResponsesWithPartialServers"
    DOCUMENTS_SCANNED = "documentsScanned"
    # fault-tolerance layer (global and per-server via the table suffix)
    SERVER_ERRORS = "serverErrors"
    HEDGED_REQUESTS = "hedgedRequests"
    SEGMENT_RETRIES = "segmentRetries"
    # ingress control: queries rejected at the broker, per cause via the
    # table suffix ("tableQuota" | "tenantQuota" | "serverBusy")
    QUERIES_DROPPED = "queriesDropped"
    # per-dispatch server-busy replies observed (per shed cause via the
    # table suffix) — distinct from QUERIES_DROPPED, which counts whole
    # queries the client lost; a busy reply recovered by failover is
    # telemetry only
    SERVER_BUSY_RESPONSES = "serverBusyResponses"
    # broker-level result cache (hybrid tables, freshness-bounded)
    RESULT_CACHE_HITS = "resultCacheHits"
    RESULT_CACHE_MISSES = "resultCacheMisses"
    # per-hop serde accounting: bytes of server reply payloads decoded
    # at the broker (pairs with the serverResponseDeserialization timer
    # so PROFILE artifacts can attribute serde separately from
    # transport) and bytes of InstanceRequest payloads sent
    SERVER_RESPONSE_BYTES = "serverResponseBytes"
    INSTANCE_REQUEST_BYTES = "instanceRequestBytes"


class BrokerGauge:
    # per-server (table-suffixed) fault-tolerance observability
    SERVER_HEALTH = "serverHealth"          # EWMA success score in [0, 1]
    BREAKER_STATE = "breakerState"          # 0 closed / 1 half-open / 2 open
    # seconds since the handler booted (exposition liveness probe)
    UPTIME_SECONDS = "uptimeSeconds"


class BrokerTimer:
    # per-server (table-suffixed) request latency; drives the hedge
    # threshold (p95-based) in broker/fault_tolerance.py
    SERVER_LATENCY = "serverLatency"


class BrokerQueryPhase:
    REQUEST_COMPILATION = "requestCompilation"
    AUTHORIZATION = "authorization"
    QUERY_ROUTING = "queryRouting"
    SCATTER_GATHER = "scatterGather"
    # DataTable decode of one server reply (a slice of scatterGather:
    # the serde share of the gather, metered per dispatch)
    SERVER_RESPONSE_DESERIALIZATION = "serverResponseDeserialization"
    REDUCE = "reduce"
    QUERY_TOTAL = "queryTotal"


class ServerMeter:
    QUERIES = "queries"
    QUERY_EXECUTION_EXCEPTIONS = "queryExecutionExceptions"
    DELETED_SEGMENT_COUNT = "deletedSegmentCount"
    REALTIME_ROWS_CONSUMED = "realtimeRowsConsumed"
    # queries dropped (or truncated) because the broker-propagated
    # deadline had already expired — work nobody would read
    DEADLINE_EXPIRED_QUERIES = "deadlineExpiredQueries"
    # segment integrity / cold-start recovery
    SEGMENT_DOWNLOADS = "segmentDownloads"
    SEGMENT_LOCAL_RELOADS = "segmentLocalReloads"
    SEGMENT_CRC_MISMATCHES = "segmentCrcMismatches"
    # primary-key upsert: rows that superseded an existing key / docs
    # invalidated in validDocIds bitmaps
    UPSERTED_ROWS = "upsertedRows"
    MASKED_DOCS = "maskedDocs"
    # admission control: requests shed before execution (per cause via
    # the table suffix: "overload" | "hedge" | "tenantOverQuota" |
    # "deadline" | "capacity") and requests admitted in brownout mode
    # (degraded deadline → flagged-partial results)
    REQUESTS_SHED = "requestsShed"
    BROWNOUT_QUERIES = "brownoutQueries"
    # server-side CRC-exact result cache
    RESULT_CACHE_HITS = "resultCacheHits"
    RESULT_CACHE_MISSES = "resultCacheMisses"
    # per-hop serde accounting: request payload bytes deserialized and
    # reply payload bytes serialized (the responseSerialization /
    # requestDeserialization timers' byte-volume counterparts)
    REQUEST_BYTES = "requestBytes"
    RESPONSE_BYTES = "responseBytes"
    # upsert maintenance: committed segments whose compacted rewrite was
    # remapped into the key map at swap, and key-map entries dropped
    # when a retention-deleted segment's keys were garbage-collected
    UPSERT_SEGMENTS_REMAPPED = "upsertSegmentsRemapped"
    UPSERT_KEYS_GCED = "upsertKeysGced"
    # tiered residency (server/residency_manager.py): segments promoted
    # back to HBM, segments demoted under budget pressure (per target
    # tier via the table suffix: "host" | "disk"), and queries that hit
    # a disk-tier segment and paid the artifact reload
    RESIDENCY_PROMOTIONS = "residencyPromotions"
    RESIDENCY_DEMOTIONS = "residencyDemotions"
    RESIDENCY_COLD_HITS = "residencyColdHits"
    # cross-query dispatch coalescing: kernel executions that served
    # more than one query, and queries that skipped the batching window
    # (budget too tight to survive it)
    BATCHED_DISPATCHES = "batchedDispatches"
    BATCH_BYPASS = "batchBypass"
    # single-flight result-cache dedup: identical concurrent queries
    # that waited on the leader's execution instead of their own
    SINGLE_FLIGHT_WAITS = "singleFlightWaits"
    # IVF ANN vector search: queries that requested probing (nprobe>0).
    # The probe-vs-exact-fallback split per segment rides the obs
    # profiler's path counters ("ivfProbe" / "ivfExactFallback")
    IVF_NPROBE_QUERIES = "ivfNprobeQueries"


class ServerTimer:
    # queries served per sealed batch window (a Timer so the occupancy
    # DISTRIBUTION rides the existing histogram/percentile machinery;
    # the "ms" unit suffix in the exposition reads as "queries")
    BATCH_OCCUPANCY = "batchOccupancy"


class ControllerMeter:
    # integrity scrubber (SegmentIntegrityChecker)
    CORRUPT_SEGMENTS = "corruptSegmentArtifacts"
    ORPHAN_ARTIFACTS_DELETED = "orphanArtifactsDeleted"
    ERROR_REPLICAS_REPAIRED = "errorReplicasRepaired"
    # self-healing plane (ClusterHealthMonitor / SegmentRebalancer /
    # standby failover): replica moves applied by the rebalancer,
    # consuming partitions reassigned off dead servers, and leader-lease
    # takeovers from a different (dead or deposed) controller
    REBALANCE_MOVES = "rebalanceMoves"
    PARTITION_TAKEOVERS = "partitionTakeovers"
    LEADER_FAILOVERS = "leaderFailovers"
    # maintenance plane (SegmentSwapManager / RetentionManager /
    # SwapJanitor): crash-safe segment rewrites swapped in, expired
    # segments tombstoned by retention, interrupted swaps the janitor
    # resumed from their durable intent records, and delayed-delete
    # tombstones finally reclaimed after the grace window
    SEGMENTS_COMPACTED = "segmentsCompacted"
    SEGMENTS_MERGED = "segmentsMerged"
    RETENTION_SEGMENTS_DELETED = "retentionSegmentsDeleted"
    SWAPS_RESUMED = "swapsResumed"
    TOMBSTONES_DELETED = "tombstonesDeleted"


class MinionMeter:
    # task-queue hygiene: IN_PROGRESS claims whose lease expired (the
    # claiming minion died mid-task) requeued to GENERATED, and claims
    # that exhausted their attempt budget and went ERROR
    TASK_REQUEUES = "taskRequeues"
    TASK_ATTEMPTS_EXHAUSTED = "taskAttemptsExhausted"


class ControllerGauge:
    # Σ over segments of (replicas the config wants, capped at live
    # capacity) minus (ideal-state holders that are live) — 0 when the
    # cluster is fully repaired, >0 while self-healing is in progress
    CLUSTER_REPLICATION_DEFICIT = "clusterReplicationDeficit"
    # registered tables / schemas (cheap sanity series for dashboards)
    TABLE_COUNT = "tableCount"
    SCHEMA_COUNT = "schemaCount"


class ServerQueryPhase:
    REQUEST_DESERIALIZATION = "requestDeserialization"
    SCHEDULER_WAIT = "schedulerWait"
    SEGMENT_PRUNING = "segmentPruning"
    SEGMENT_EXECUTION = "segmentExecution"
    SHARDED_EXECUTION = "shardedExecute"
    BUILD_QUERY_PLAN = "buildQueryPlan"
    QUERY_PLAN_EXECUTION = "queryPlanExecution"
    QUERY_PROCESSING = "queryProcessing"
    RESPONSE_SERIALIZATION = "responseSerialization"


class ServerGauge:
    DOCUMENT_COUNT = "documentCount"
    SEGMENT_COUNT = "segmentCount"
    LLC_PARTITION_CONSUMING = "llcPartitionConsuming"
    UPSERT_KEY_MAP_SIZE = "upsertKeyMapSize"
    # admission control queue depth (submitted minus completed)
    ADMISSION_QUEUE_DEPTH = "admissionQueueDepth"
    # tiered residency: per-tier twins of deviceBytesResident (the
    # `|tier:<tier>` registry suffix renders as a `tier` label) plus
    # the count of segments hot enough for HBM but still waiting on a
    # promotion slot — the admission brownout watermark input
    RESIDENCY_TIER_BYTES = "residencyTierBytes"
    RESIDENCY_PROMOTION_BACKLOG = "residencyPromotionBacklog"
