"""Segment pruners: skip segments that cannot match a query.

Parity: pinot-core/.../query/pruner/ — ColumnValueSegmentPruner
(min/max range rejection on EQ/RANGE + bloom-filter rejection,
ColumnValueSegmentPruner.java:58-63), DataSchemaSegmentPruner,
ValidSegmentPruner; orchestrated by SegmentPrunerService.
"""
from __future__ import annotations

from typing import List, Optional

from pinot_tpu_torch.common.request import (BrokerRequest, FilterOperator,
                                      FilterQueryTree)
from pinot_tpu_torch.segment.loader import ImmutableSegment


class SegmentPrunerService:
    def __init__(self, pruners: Optional[List] = None):
        self.pruners = pruners if pruners is not None else [
            ValidSegmentPruner(), DataSchemaSegmentPruner(),
            ColumnValueSegmentPruner(), PartitionSegmentPruner()]

    def prune(self, segments: List[ImmutableSegment], request: BrokerRequest
              ) -> List[ImmutableSegment]:
        out = segments
        for p in self.pruners:
            out = [s for s in out if not p.prune(s, request)]
        return out


class ValidSegmentPruner:
    def prune(self, segment: ImmutableSegment, request: BrokerRequest) -> bool:
        return segment.num_docs == 0


class DataSchemaSegmentPruner:
    def prune(self, segment: ImmutableSegment, request: BrokerRequest) -> bool:
        for col in request.referenced_columns():
            if not segment.has_column(col):
                return True
        return False


def _bloom_key(cm, literal: str):
    """Coerce a query literal to the column's numpy dtype before hashing so
    it str()-normalizes identically to the values the builder added (e.g.
    '5' on a FLOAT column must hash as '5.0', not '5')."""
    dt = cm.data_type.np_dtype
    try:
        if dt.kind == "f":
            return dt.type(float(literal))
        if dt.kind in "iu":
            return dt.type(int(str(literal)))
    except (ValueError, OverflowError):
        pass
    return literal


class ColumnValueSegmentPruner:
    def prune(self, segment: ImmutableSegment, request: BrokerRequest) -> bool:
        return self._prune_node(segment, request.filter)

    def _prune_node(self, segment: ImmutableSegment,
                    node: Optional[FilterQueryTree]) -> bool:
        if node is None:
            return False
        if node.operator == FilterOperator.AND:
            return any(self._prune_node(segment, c) for c in node.children)
        if node.operator == FilterOperator.OR:
            return all(self._prune_node(segment, c) for c in node.children)
        if node.operator not in (FilterOperator.EQUALITY, FilterOperator.RANGE):
            return False
        from pinot_tpu_torch.common.expression import is_expression
        if is_expression(node.column):
            return False    # no min/max metadata for transformed values
        ds = segment.data_source(node.column)
        cm = ds.metadata
        if cm.min_value is None or cm.max_value is None or \
                not cm.data_type.is_numeric:
            if node.operator == FilterOperator.EQUALITY and \
                    ds.bloom_filter is not None:
                return not ds.bloom_filter.might_contain(
                    _bloom_key(cm, node.values[0]))
            return False
        mn, mx = float(cm.min_value), float(cm.max_value)
        if node.operator == FilterOperator.EQUALITY:
            try:
                v = float(node.values[0])
            except ValueError:
                return False
            if v < mn or v > mx:
                return True
            if ds.bloom_filter is not None:
                return not ds.bloom_filter.might_contain(
                    _bloom_key(cm, node.values[0]))
            return False
        # RANGE: prune when the query interval is disjoint from [min, max]
        if node.lower is not None:
            lo = float(node.lower)
            if lo > mx or (lo == mx and not node.lower_inclusive):
                return True
        if node.upper is not None:
            hi = float(node.upper)
            if hi < mn or (hi == mn and not node.upper_inclusive):
                return True
        return False


class PartitionSegmentPruner:
    """Prune segments whose partition-id set cannot contain an EQ literal.

    Parity: core/query/pruner/PartitionSegmentPruner — the segment's
    column metadata records the partition function + ids present; an
    equality predicate on a partitioned column maps the literal to its
    partition and skips segments that never stored that partition.
    """

    def prune(self, segment: ImmutableSegment,
              request: BrokerRequest) -> bool:
        return self._prune_node(segment, request.filter)

    def _prune_node(self, segment: ImmutableSegment,
                    node: Optional[FilterQueryTree]) -> bool:
        if node is None:
            return False
        if node.operator == FilterOperator.AND:
            return any(self._prune_node(segment, c) for c in node.children)
        if node.operator == FilterOperator.OR:
            return all(self._prune_node(segment, c) for c in node.children)
        if node.operator != FilterOperator.EQUALITY:
            return False
        from pinot_tpu_torch.common.expression import is_expression
        if is_expression(node.column) or not segment.has_column(node.column):
            return False
        cm = segment.data_source(node.column).metadata
        if not cm.partition_function or not cm.partitions:
            return False
        from pinot_tpu_torch.common.partition import partition_of_value
        try:
            p = partition_of_value(cm.partition_function,
                                   cm.num_partitions,
                                   cm.data_type.np_dtype, node.values[0])
        except Exception:  # noqa: BLE001 — unknown function/bad metadata:
            return False   # fail open (never wrongly drop a segment)
        return p not in set(cm.partitions)
