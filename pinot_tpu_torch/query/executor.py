"""Server-side query executor.

Counterpart of pinot_tpu/query/executor.py, sequential path: prune → plan
per segment → execute on the device, or on the host twin when the planner
refuses the segment → combine → one result block with execution stats.
The host twin (query/host_exec.py) is taken only when make_segment_plan
raises UnsupportedOnDevice or GroupsLimitExceeded, the refusals the JAX
planner makes too, before any kernel launches. Nothing else is caught:
not the planner's NotPorted (a shape the JAX planner runs on its device
and the port has no kernel for yet), and nothing that plan.execute()
raises (a build, a launch, a kernel). No star-tree, batching or thread
pool yet.

`ServerQueryExecutor.path_counts` counts, per segment of each query since
the last `reset_path_counts()`, where it ended: "pruned" (the pruner
dropped it), "fast" (a fast-path plan: metadata, match-all or
inverted-index COUNT, or an empty filter), "scan" (the device kernels)
or "host" (the host twin).
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional

from pinot_tpu_torch.common.request import BrokerRequest, \
    VECTOR_RESULT_COLUMNS
from pinot_tpu_torch.query import host_exec
from pinot_tpu_torch.query.blocks import IntermediateResultsBlock
from pinot_tpu_torch.query.combine import combine_blocks
from pinot_tpu_torch.query.plan import GroupsLimitExceeded, \
    InstancePlanMaker, UnsupportedOnDevice, preprocess_request
from pinot_tpu_torch.query.pruner import SegmentPrunerService
from pinot_tpu_torch.segment.loader import ImmutableSegment

PATHS = ("pruned", "fast", "scan", "host")


class ServerQueryExecutor:
    def __init__(self, plan_maker: Optional[InstancePlanMaker] = None):
        self.plan_maker = plan_maker or InstancePlanMaker()
        self.pruner = SegmentPrunerService()
        self.path_counts: Dict[str, int] = dict.fromkeys(PATHS, 0)

    def reset_path_counts(self) -> None:
        self.path_counts = dict.fromkeys(PATHS, 0)

    def execute(self, request: BrokerRequest,
                segments: List[ImmutableSegment]) -> IntermediateResultsBlock:
        t0 = time.perf_counter()
        # FASTHLL derived rewrite, on a copy (the caller's request stays)
        request = preprocess_request(segments, request)
        selected = self.pruner.prune(segments, request)
        self.path_counts["pruned"] += len(segments) - len(selected)
        blocks = [self._execute_segment(seg, request) for seg in selected]
        if blocks:
            blk = combine_blocks(request, blocks)
        else:
            blk = IntermediateResultsBlock()
            if request.is_group_by:
                blk.group_map = {}
            elif request.is_aggregation:
                blk.agg_intermediates = None
            if request.is_selection:
                blk.selection_rows = []
                blk.selection_columns = list(request.selection.columns)
                if request.vector is not None:
                    blk.selection_columns += list(VECTOR_RESULT_COLUMNS)
        blk.stats.num_segments_pruned = len(segments) - len(selected)
        blk.stats.time_used_ms = (time.perf_counter() - t0) * 1e3
        return blk

    def _execute_segment(self, segment: ImmutableSegment,
                         request: BrokerRequest) -> IntermediateResultsBlock:
        try:
            plan = self.plan_maker.make_segment_plan(segment, request)
        except (GroupsLimitExceeded, UnsupportedOnDevice):
            self.path_counts["host"] += 1
            return host_exec.execute_host(segment, request)
        self.path_counts["fast" if plan.fast_path_result is not None
                         else "scan"] += 1
        return plan.execute()
