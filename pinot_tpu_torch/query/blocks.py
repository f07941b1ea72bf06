"""Result blocks and execution statistics.

Parity: pinot-core/.../operator/blocks/IntermediateResultsBlock.java and
core/operator/ExecutionStatistics.java — the per-segment (and per-server,
after combine) result container carried up to the broker reduce.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple


@dataclasses.dataclass
class ExecutionStats:
    num_docs_scanned: int = 0
    num_entries_scanned_in_filter: int = 0
    num_entries_scanned_post_filter: int = 0
    num_segments_processed: int = 0
    num_segments_matched: int = 0
    num_segments_pruned: int = 0
    total_docs: int = 0
    num_groups_limit_reached: bool = False
    time_used_ms: float = 0.0
    # realtime freshness (parity: ServerQueryExecutorV1Impl's
    # minConsumingFreshnessTimeMs + numConsumingSegmentsProcessed);
    # BrokerResponse.to_json emits the pair only when consuming
    # segments were queried
    num_consuming_segments_processed: int = 0
    min_consuming_freshness_ms: int = 0

    def merge(self, other: "ExecutionStats") -> None:
        self.num_docs_scanned += other.num_docs_scanned
        self.num_entries_scanned_in_filter += other.num_entries_scanned_in_filter
        self.num_entries_scanned_post_filter += \
            other.num_entries_scanned_post_filter
        self.num_segments_processed += other.num_segments_processed
        self.num_segments_matched += other.num_segments_matched
        self.num_segments_pruned += other.num_segments_pruned
        self.total_docs += other.total_docs
        self.num_groups_limit_reached |= other.num_groups_limit_reached
        self.num_consuming_segments_processed += \
            other.num_consuming_segments_processed
        if other.min_consuming_freshness_ms:
            self.min_consuming_freshness_ms = \
                min(self.min_consuming_freshness_ms,
                    other.min_consuming_freshness_ms) \
                if self.min_consuming_freshness_ms else \
                other.min_consuming_freshness_ms

    def to_metadata(self) -> Dict[str, str]:
        return {
            "numDocsScanned": str(self.num_docs_scanned),
            "numEntriesScannedInFilter": str(self.num_entries_scanned_in_filter),
            "numEntriesScannedPostFilter":
                str(self.num_entries_scanned_post_filter),
            "numSegmentsProcessed": str(self.num_segments_processed),
            "numSegmentsMatched": str(self.num_segments_matched),
            "totalDocs": str(self.total_docs),
            "numGroupsLimitReached": str(self.num_groups_limit_reached).lower(),
            "numConsumingSegmentsProcessed":
                str(self.num_consuming_segments_processed),
            "minConsumingFreshnessTimeMs":
                str(self.min_consuming_freshness_ms),
        }


@dataclasses.dataclass
class IntermediateResultsBlock:
    """Intermediate (mergeable) results of one segment / one server.

    Exactly one of agg_intermediates / group_map / selection_rows is the
    payload, mirroring the reference's block contents.
    """
    # aggregation-only: one intermediate object per aggregation function
    agg_intermediates: Optional[List[object]] = None
    # group-by: group key values tuple → list of intermediates
    group_map: Optional[Dict[Tuple, List[object]]] = None
    # group-by, COLUMNAR form (zero-copy DataTable v3 decode): a
    # (key_cols, inter_cols) pair of per-column blocks — each a numpy
    # array (i64/f64) or list (str/object). Exactly one of group_map /
    # group_cols is set; combine materializes group_map lazily only
    # when a merge cannot run as a vectorized fold.
    group_cols: Optional[Tuple[List[object], List[object]]] = None
    # selection: row tuples (decoded values) + total matched count
    selection_rows: Optional[List[tuple]] = None
    # selection, COLUMNAR form: one block per column (numpy array or
    # list), same exactly-one-of contract vs selection_rows
    selection_cols: Optional[List[object]] = None
    selection_columns: Optional[List[str]] = None
    # rows may carry trailing ORDER-BY-only columns (needed to re-sort in
    # cross-segment merges); the reducer trims to the first N display cols
    selection_display_cols: Optional[int] = None
    stats: ExecutionStats = dataclasses.field(default_factory=ExecutionStats)
    exceptions: List[str] = dataclasses.field(default_factory=list)
    # which instance-level path served this block: "sharded" (mesh ICI
    # combine) or "sequential" (per-segment + host merge); None when the
    # block came from a layer that doesn't choose (e.g. per-segment)
    execution_path: Optional[str] = None
