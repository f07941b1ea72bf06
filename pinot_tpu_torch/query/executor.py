"""Server-side query executor.

Counterpart of pinot_tpu/query/executor.py: prune → plan per segment →
execute on the device, or on the host twin when the planner refuses the
segment → combine → one result block with execution stats. The host twin
(query/host_exec.py) is taken only when make_segment_plan raises
UnsupportedOnDevice or GroupsLimitExceeded, the refusals the JAX planner
makes too, before any kernel launches. Nothing else is caught: not the
planner's NotPorted (a shape the JAX planner runs on its device and the
port has no kernel for yet), and nothing that plan.execute() raises (a
build, a launch, a kernel). No star-tree or thread pool yet.

`execute_batch` runs N requests of one shape (the coalescer's batch,
server/scheduler.py) over one segment set: per segment, the members whose
plans share a compiled signature (query/plan.py:batch_signature) run each
kernel once per chunk of up to 8 (query/execution.py:
execute_segment_plans_batched), and every other member takes the
sequential ladder.

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
from pinot_tpu_torch.query import execution, host_exec
from pinot_tpu_torch.query.blocks import IntermediateResultsBlock
from pinot_tpu_torch.query.combine import combine_blocks
from pinot_tpu_torch.query.plan import GroupsLimitExceeded, \
    InstancePlanMaker, SegmentPlan, UnsupportedOnDevice, batch_signature, \
    preprocess_request
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
        blk = _combine(request, [self._execute_segment(seg, request)
                                 for seg in selected])
        blk.stats.num_segments_pruned = len(segments) - len(selected)
        blk.stats.time_used_ms = (time.perf_counter() - t0) * 1e3
        return blk

    def _plan(self, segment: ImmutableSegment,
              request: BrokerRequest) -> Optional[SegmentPlan]:
        """The segment's plan, or None where the planner refuses it."""
        try:
            return self.plan_maker.make_segment_plan(segment, request)
        except (GroupsLimitExceeded, UnsupportedOnDevice):
            return None

    def _run_plan(self, plan: Optional[SegmentPlan], segment, request
                  ) -> IntermediateResultsBlock:
        """One member's sequential ladder on one segment: the host twin
        for a refused plan, else the plan (a fast path or the kernels)."""
        if plan is None:
            self.path_counts["host"] += 1
            return host_exec.execute_host(segment, request)
        self.path_counts["fast" if plan.fast_path_result is not None
                         else "scan"] += 1
        return plan.execute()

    def _execute_segment(self, segment: ImmutableSegment,
                         request: BrokerRequest) -> IntermediateResultsBlock:
        return self._run_plan(self._plan(segment, request), segment, request)

    # -- cross-query batched execution --------------------------------------
    def execute_batch(self, requests: List[BrokerRequest],
                      segments: List[ImmutableSegment],
                      deadline: Optional[float] = None
                      ) -> List[IntermediateResultsBlock]:
        """Execute N same-shape requests over one segment set, sharing the
        kernel launches wherever their per-segment plans compile to equal
        specs (pinot_tpu/query/executor.py:execute_batch). Pruning and
        planning are per member (literals steer pruning and can fold a
        plan to a fast path), and members are grouped by their compiled
        signature, so a shape-key collision costs batching, never an
        answer. Group-by, fast-path and refused members run the sequential
        ladder. `deadline`: a time.monotonic() instant; segments not begun
        by then are left out, and each member's block says so. Returns
        blocks aligned with `requests`."""
        # the trace and profile arguments wait for the port's obs layer
        t0 = time.perf_counter()
        members = []
        for req in requests:
            req = preprocess_request(segments, req)
            selected = self.pruner.prune(segments, req)
            self.path_counts["pruned"] += len(segments) - len(selected)
            members.append(_BatchMember(req, selected, len(segments)))
        # the multi-segment star-tree fast path waits for the port's
        # star-tree
        for seg in segments:
            if deadline is not None and time.monotonic() >= deadline:
                break
            takers = [m for m in members if id(seg) in m.selected_ids]
            if takers:
                self._batch_segment(seg, takers)
                for m in takers:
                    m.executed += 1
        return [m.finish(t0) for m in members]

    def _batch_segment(self, seg: ImmutableSegment,
                       takers: List["_BatchMember"]) -> None:
        """One segment, many members: the plans whose compiled signatures
        agree run batched; everything else runs the sequential ladder."""
        groups: Dict[tuple, list] = {}
        for m in takers:
            # the per-segment star-tree branch waits for the port's
            # star-tree
            plan = self._plan(seg, m.request)
            sig = None if plan is None else batch_signature(plan)
            if sig is None:
                m.blocks.append(self._run_plan(plan, seg, m.request))
            else:
                groups.setdefault(sig, []).append((m, plan))
        for group in groups.values():
            blocks = execution.execute_segment_plans_batched(
                [plan for _m, plan in group])
            self.path_counts["scan"] += len(group)
            for (m, _plan), blk in zip(group, blocks):
                m.blocks.append(blk)


class _BatchMember:
    """One request's blocks and segments in the batched execution loop."""
    __slots__ = ("request", "selected", "selected_ids", "num_pruned",
                 "blocks", "executed")

    def __init__(self, request: BrokerRequest, selected, num_total: int):
        self.request = request
        self.selected = selected
        self.selected_ids = {id(s) for s in selected}
        self.num_pruned = num_total - len(selected)
        self.blocks: List[IntermediateResultsBlock] = []
        self.executed = 0

    def finish(self, t0: float) -> IntermediateResultsBlock:
        """Combine and stats, as ServerQueryExecutor.execute ends, with
        the truncation the deadline caused."""
        blk = _combine(self.request, self.blocks)
        if self.executed < len(self.selected):
            blk.exceptions.append(
                "DeadlineExceededError: segment execution truncated at "
                f"{self.executed}/{len(self.selected)} segments (budget "
                "expired mid-query)")
        blk.stats.num_segments_pruned = self.num_pruned
        blk.stats.time_used_ms = (time.perf_counter() - t0) * 1e3
        return blk


def _combine(request: BrokerRequest,
             blocks: List[IntermediateResultsBlock]
             ) -> IntermediateResultsBlock:
    """The segments' blocks combined, or the empty block of the request's
    shape when no segment gave one."""
    if blocks:
        return combine_blocks(request, blocks)
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
    return blk
