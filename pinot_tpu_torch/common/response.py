"""Broker response model (the JSON the client receives).

Parity: pinot-common/.../response/broker/BrokerResponseNative.java — PQL
response shape: aggregationResults (plain or groupByResult), selectionResults,
exceptions, and the execution-stats fields
(ServerQueryExecutorV1Impl.java:190-197 metadata propagated through
BrokerReduceService).
"""
from __future__ import annotations

import dataclasses
import json
import math
from typing import Dict, List, Optional, Tuple

#: Exception-message prefix → (errorCode, machine cause). Every degraded
#: path in the system raises/appends strings with one of these prefixes;
#: `classify_exception` turns them into structured entries so that
#: "flagged vs unflagged" is a field check, never a message grep. An
#: exception whose prefix is NOT here gets no errorCode — the SLO
#: classifier (obs/slo.py) counts it as UNFLAGGED, which is exactly the
#: signal that a new degraded path forgot to register itself.
EXCEPTION_CLASSES: Dict[str, Tuple[int, str]] = {
    "PQLParsingError:": (150, "parse"),
    "AccessDeniedError:": (180, "accessDenied"),
    "TableDoesNotExistError:": (190, "unknownTable"),
    "RoutingError:": (190, "routing"),
    "QueryExecutionError:": (200, "execution"),
    "RequestDeserializationError:": (200, "deserialization"),
    "DeadlineExceededError:": (250, "deadline"),
    "QueryTimeoutError:": (250, "timeout"),
    "StageCompileError:": (422, "stageCompile"),
    "JoinCapacityError:": (422, "joinCapacity"),
    "SegmentMissingError:": (425, "segmentMissing"),
    "ServerQueryError:": (425, "serverFault"),
    "ExchangeStageError:": (425, "exchange"),
    "ExchangeMissError:": (425, "exchangeMiss"),
    "ServerNotRespondedError:": (427, "noServerResponded"),
    "QuotaExceededError:": (429, "quotaExceeded"),
    "ServerBusyError:": (503, "serverBusy"),
}


def classify_exception(message: str) -> Optional[Tuple[int, str]]:
    """(errorCode, cause) for a known exception-message prefix, else
    None (→ the entry stays unflagged and the SLO gate trips)."""
    prefix = message.split(" ", 1)[0] if message else ""
    return EXCEPTION_CLASSES.get(prefix)


def exception_entry(message: str, error_code: Optional[int] = None,
                    cause: Optional[str] = None) -> dict:
    """Build a structured exceptions[] entry: message plus errorCode +
    cause, classified from the message prefix unless given explicitly."""
    entry: dict = {"message": message}
    cls = classify_exception(message)
    if cls is not None:
        entry["errorCode"], entry["cause"] = cls
    if error_code is not None:
        entry["errorCode"] = error_code
    if cause is not None:
        entry["cause"] = cause
    return entry


@dataclasses.dataclass
class AggregationResult:
    function: str
    value: Optional[object] = None
    # group-by variant:
    group_by_columns: Optional[List[str]] = None
    group_by_result: Optional[List[dict]] = None   # [{"group": [...], "value": v}]

    def to_json(self) -> dict:
        if self.group_by_result is not None:
            return {"function": self.function,
                    "groupByColumns": self.group_by_columns,
                    "groupByResult": self.group_by_result}
        return {"function": self.function, "value": _fmt(self.value)}


@dataclasses.dataclass
class SelectionResults:
    columns: List[str]
    results: List[list]

    def to_json(self) -> dict:
        return {"columns": self.columns, "results": self.results}


@dataclasses.dataclass
class BrokerResponse:
    aggregation_results: Optional[List[AggregationResult]] = None
    selection_results: Optional[SelectionResults] = None
    exceptions: List[dict] = dataclasses.field(default_factory=list)
    num_docs_scanned: int = 0
    num_entries_scanned_in_filter: int = 0
    num_entries_scanned_post_filter: int = 0
    num_segments_processed: int = 0
    num_segments_matched: int = 0
    num_servers_queried: int = 0
    num_servers_responded: int = 0
    num_consuming_segments_queried: int = 0
    min_consuming_freshness_time_ms: int = 0
    num_groups_limit_reached: bool = False
    total_docs: int = 0
    time_used_ms: float = 0.0
    # honest-degradation flag: True whenever the result may be missing
    # data (a server never responded, a segment had no live replica, or
    # execution was truncated by the deadline) — clients must be able to
    # tell a partial answer from a full one without string-matching
    # exception messages
    partial_response: bool = False
    # trace=true responses: {"broker": [...spans], "<server>": [...spans]}
    # (flat per-participant span lists; spans carry spanId/parentId)
    trace_info: Optional[Dict[str, list]] = None
    # trace=true responses: ONE merged cross-process tree — broker
    # compile/route/scatter/reduce spans with each server's queue-wait/
    # plan/execute/serde subtree grafted under its dispatch span
    trace_tree: Optional[dict] = None

    def to_json(self) -> dict:
        d = {
            "exceptions": self.exceptions,
            "numDocsScanned": self.num_docs_scanned,
            "numEntriesScannedInFilter": self.num_entries_scanned_in_filter,
            "numEntriesScannedPostFilter":
                self.num_entries_scanned_post_filter,
            "numSegmentsProcessed": self.num_segments_processed,
            "numSegmentsMatched": self.num_segments_matched,
            "numServersQueried": self.num_servers_queried,
            "numServersResponded": self.num_servers_responded,
            "numGroupsLimitReached": self.num_groups_limit_reached,
            "partialResponse": self.partial_response,
            "totalDocs": self.total_docs,
            "timeUsedMs": round(self.time_used_ms, 3),
        }
        if self.num_consuming_segments_queried:
            # realtime queries only (parity: the reference emits the
            # freshness pair only when consuming segments were queried;
            # an unconditional 0 would read as epoch-stale data)
            d["numConsumingSegmentsQueried"] = \
                self.num_consuming_segments_queried
            d["minConsumingFreshnessTimeMs"] = \
                self.min_consuming_freshness_time_ms
        if self.aggregation_results is not None:
            d["aggregationResults"] = [a.to_json()
                                       for a in self.aggregation_results]
        if self.selection_results is not None:
            d["selectionResults"] = self.selection_results.to_json()
        if self.trace_info is not None:
            d["traceInfo"] = self.trace_info
        if self.trace_tree is not None:
            d["traceTree"] = self.trace_tree
        return d

    def to_json_str(self) -> str:
        return json.dumps(self.to_json())


def _fmt(v):
    """Format final aggregation values as strings (the reference renders
    numbers as strings in the JSON response); floats keep full precision."""
    if v is None:
        return "null"
    if isinstance(v, bool):
        return str(v).lower()
    if isinstance(v, int):
        return str(v)
    if isinstance(v, float):
        if math.isinf(v):
            return "Infinity" if v > 0 else "-Infinity"
        return str(int(v)) if v == int(v) and abs(v) < 1e15 else str(v)
    return str(v)
