"""Server-side query executor.

Counterpart of pinot_tpu/query/executor.py, sequential path only: plan →
execute per segment → combine → one result block with execution stats.
This slice has no pruner, star-tree, batching, thread pool or host
fallback: a plan the device path does not support raises.
"""
from __future__ import annotations

import time
from typing import List, Optional

from pinot_tpu_torch.common.request import BrokerRequest
from pinot_tpu_torch.query.blocks import IntermediateResultsBlock
from pinot_tpu_torch.query.combine import combine_blocks
from pinot_tpu_torch.query.plan import InstancePlanMaker
from pinot_tpu_torch.segment.loader import ImmutableSegment


class ServerQueryExecutor:
    def __init__(self, plan_maker: Optional[InstancePlanMaker] = None):
        self.plan_maker = plan_maker or InstancePlanMaker()

    def execute(self, request: BrokerRequest,
                segments: List[ImmutableSegment]) -> IntermediateResultsBlock:
        t0 = time.perf_counter()
        blocks = [self.plan_maker.make_segment_plan(seg, request).execute()
                  for seg in segments]
        if blocks:
            blk = combine_blocks(request, blocks)
        else:
            blk = IntermediateResultsBlock()
            if request.is_group_by:
                blk.group_map = {}
            else:
                blk.agg_intermediates = None
        blk.stats.time_used_ms = (time.perf_counter() - t0) * 1e3
        return blk
