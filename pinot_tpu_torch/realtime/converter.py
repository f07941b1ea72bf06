"""Consuming → immutable segment conversion (the commit build).

Parity: pinot-core/.../realtime/converter/RealtimeSegmentConverter.java:85-129
— drain the mutable segment's rows and run the standard immutable build
(re-sorting dictionaries, re-packing forward indexes, rebuilding inverted/
bloom indexes per the table's indexing config). The TPU build's creator
takes the mutable segment's decoded columnar snapshot directly.
"""
from __future__ import annotations

from pinot_tpu_torch.realtime.mutable_segment import MutableSegmentImpl
from pinot_tpu_torch.segment.creator import SegmentCreator
from pinot_tpu_torch.segment.metadata import SegmentMetadata


def convert(mutable: MutableSegmentImpl, out_dir: str,
            segment_name: str) -> SegmentMetadata:
    """Build a standard immutable segment directory from a consuming
    segment's rows; returns the sealed metadata."""
    columns = mutable.columnar_snapshot()
    creator = SegmentCreator(mutable.schema, mutable.table_config,
                             segment_name=segment_name)
    return creator.build(columns, out_dir)
