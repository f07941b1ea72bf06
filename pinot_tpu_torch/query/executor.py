"""Server-side query executor.

Counterpart of pinot_tpu/query/executor.py: prune → plan per segment →
execute on the device, or on the host twin when the planner refuses the
segment → combine → one result block with execution stats. The host twin
(query/host_exec.py) is taken only when make_segment_plan raises
UnsupportedOnDevice or GroupsLimitExceeded, the refusals the JAX planner
makes too, before any kernel launches. Nothing else is caught: not the
planner's NotPorted, not a join's StageCompileError (the fact key fails
the integer-key contract), and nothing that plan.execute() raises (a
build, a launch, a kernel). No thread pool yet.

Star-tree cubes are taken where the JAX executor takes them: an
aggregation over several segments that all carry cubes, none masked by
upserts, first tries the multi-segment cube (startree/executor.py:
try_star_tree_execute_multi) before any scan; else each segment tries its
own covering cube before it plans (try_star_tree_execute), and
execute_batch does both per member.

Stage 2 of a join: the request carries its JoinContext as `_join_ctx`
(query/stages/join.py:build_context); preprocess_request's copy keeps
it, so every segment's plan and the host twin probe the same dim side.

A consuming segment (realtime/mutable_segment.py:MutableSegmentImpl) is
one logical segment of two parts (pinot_tpu/query/executor.py:147-185):
its frozen sorted prefix (an ImmutableSegment, rebuilt at doubling row
counts) runs on the card like any segment, and the rows indexed since the
freeze (a snapshot view) on the host twin. The two blocks count as one
processed segment, and the query reports the consuming segments it saw
and their freshness.

`execute_batch` runs N requests of one shape (the coalescer's batch,
server/scheduler.py) over one segment set: per segment, the members whose
plans share a compiled signature (query/plan.py:batch_signature) run each
kernel once per chunk of up to 8 (query/execution.py:
execute_segment_plans_batched), and every other member takes the
sequential ladder.

`ServerQueryExecutor.path_counts` counts, per segment of each query since
the last `reset_path_counts()`, where it ended: "pruned" (the pruner
dropped it), "cube" (a star-tree cube answered it, the JAX executor's
count_path("cube"); the key appears with the first such segment), "fast"
(a fast-path plan: metadata, match-all or
inverted-index COUNT, or an empty filter), "scan" (the device kernels)
or "host" (the host twin: a refused plan, a consuming segment's tail
among them, as the JAX planner refuses a mutable segment); `tail_docs`
and `tail_ms` add up the consuming tails' rows and host milliseconds.
"""
from __future__ import annotations

import time
from collections import Counter
from typing import Dict, List, Optional, Tuple

from pinot_tpu_torch.common.request import BrokerRequest, \
    VECTOR_RESULT_COLUMNS
from pinot_tpu_torch.query import execution, host_exec
from pinot_tpu_torch.query.blocks import IntermediateResultsBlock
from pinot_tpu_torch.query.combine import combine_blocks
from pinot_tpu_torch.query.plan import GroupsLimitExceeded, \
    InstancePlanMaker, SegmentPlan, UnsupportedOnDevice, batch_signature, \
    preprocess_request, upsert_mask_active
from pinot_tpu_torch.query.pruner import SegmentPrunerService
from pinot_tpu_torch.segment.loader import ImmutableSegment
from pinot_tpu_torch.startree.executor import try_star_tree_execute, \
    try_star_tree_execute_multi

PATHS = ("pruned", "fast", "scan", "host")


class ServerQueryExecutor:
    def __init__(self, plan_maker: Optional[InstancePlanMaker] = None):
        self.plan_maker = plan_maker or InstancePlanMaker()
        self.pruner = SegmentPrunerService()
        self.reset_path_counts()

    def reset_path_counts(self) -> None:
        # "cube" joins the PATHS keys when a star-tree cube first answers
        self.path_counts: Counter = Counter(dict.fromkeys(PATHS, 0))
        self.tail_docs = 0
        self.tail_ms = 0.0

    def execute(self, request: BrokerRequest,
                segments: List[ImmutableSegment]) -> IntermediateResultsBlock:
        t0 = time.perf_counter()
        # FASTHLL derived rewrite, on a copy (the caller's request stays)
        request = preprocess_request(segments, request)
        selected = self.pruner.prune(segments, request)
        self.path_counts["pruned"] += len(segments) - len(selected)
        blk = self._try_star_tree_multi(request, selected)
        if blk is not None:
            blk.stats.num_segments_pruned = len(segments) - len(selected)
            blk.stats.time_used_ms = (time.perf_counter() - t0) * 1e3
            return blk
        blocks: List[IntermediateResultsBlock] = []
        extra_parts = extra_matched = 0
        for seg in selected:
            seg_blocks, parts, matched = self._segment_work(seg, request)
            blocks.extend(seg_blocks)
            extra_parts += parts
            extra_matched += matched
        blk = _combine(request, blocks)
        _finish_stats(blk, selected, extra_parts, extra_matched)
        blk.stats.num_segments_pruned = len(segments) - len(selected)
        blk.stats.time_used_ms = (time.perf_counter() - t0) * 1e3
        return blk

    def _segment_work(self, seg, request: BrokerRequest
                      ) -> Tuple[List[IntermediateResultsBlock], int, int]:
        """ONE logical segment: (blocks, extra parts, extra matched). A
        consuming segment gives its frozen prefix's block (the card) and
        its tail's (the host twin); the pair counts as one segment,
        matched when both halves matched."""
        if not getattr(seg, "is_mutable", False):
            return [self._execute_segment(seg, request)], 0, 0
        frozen, tail = seg.device_view()
        blocks: List[IntermediateResultsBlock] = []
        fb = tb = None
        if frozen is not None:
            fb = self._execute_segment(frozen, request)
            blocks.append(fb)
        if tail.num_docs > 0 or frozen is None:
            t0 = time.perf_counter()
            tb = self._execute_segment(tail, request)   # the host twin
            self.tail_ms += (time.perf_counter() - t0) * 1e3
            self.tail_docs += tail.num_docs
            blocks.append(tb)
        if fb is not None and tb is not None:
            return blocks, 1, int(bool(fb.stats.num_segments_matched and
                                       tb.stats.num_segments_matched))
        return blocks, 0, 0

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
        blk = self._try_star_tree(segment, request)
        if blk is not None:
            return blk
        return self._run_plan(self._plan(segment, request), segment, request)

    def _try_star_tree(self, segment, request: BrokerRequest
                       ) -> Optional[IntermediateResultsBlock]:
        """One segment's covering cube answer, or None
        (pinot_tpu/query/executor.py:415-421)."""
        if request.is_aggregation and not request.is_selection and \
                not upsert_mask_active(segment) and \
                getattr(segment, "star_trees", None):
            blk = try_star_tree_execute(segment, request)
            if blk is not None:
                self.path_counts["cube"] += 1
                return blk
        return None

    def _try_star_tree_multi(self, request: BrokerRequest, selected
                             ) -> Optional[IntermediateResultsBlock]:
        """The multi-segment cube answer over every selected segment, or
        None (pinot_tpu/query/executor.py:86-98): more than one segment,
        each with cubes, none masked."""
        if request.is_aggregation and not request.is_selection and \
                len(selected) > 1 and \
                not any(upsert_mask_active(s) for s in selected) and \
                all(getattr(s, "star_trees", None) for s in selected):
            blk = try_star_tree_execute_multi(selected, request)
            if blk is not None:
                self.path_counts["cube"] += len(selected)
                return blk
        return None

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
        ladder, and so does a member whose filter holds a raw-key join's
        join_raw leaf (the batched K1 does not take it), with the same
        answer. `deadline`: a time.monotonic() instant; segments not begun
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
        # the multi-segment star-tree fast path per member (as execute
        # takes it); a member it answers never reaches the segment loop
        for m in members:
            m.final = self._try_star_tree_multi(m.request, m.selected)
        pending = [m for m in members if m.final is None]
        for seg in segments:
            if deadline is not None and time.monotonic() >= deadline:
                break
            takers = [m for m in pending if id(seg) in m.selected_ids]
            if takers:
                self._batch_segment(seg, takers)
                for m in takers:
                    m.executed += 1
        return [m.finish(t0) if m.final is None else m.final
                for m in members]

    def _batch_segment(self, seg: ImmutableSegment,
                       takers: List["_BatchMember"]) -> None:
        """One segment, many members: the plans whose compiled signatures
        agree run batched; everything else runs the sequential ladder. A
        consuming segment's frozen prefix and tail run per member
        (pinot_tpu/query/executor.py:370-376)."""
        if getattr(seg, "is_mutable", False):
            for m in takers:
                m.add(*self._segment_work(seg, m.request))
            return
        groups: Dict[tuple, list] = {}
        for m in takers:
            blk = self._try_star_tree(seg, m.request)
            if blk is not None:
                m.add([blk], 0, 0)
                continue
            plan = self._plan(seg, m.request)
            sig = None if plan is None else batch_signature(plan)
            if sig is None:
                m.add([self._run_plan(plan, seg, m.request)], 0, 0)
            else:
                groups.setdefault(sig, []).append((m, plan))
        for group in groups.values():
            blocks = execution.execute_segment_plans_batched(
                [plan for _m, plan in group])
            self.path_counts["scan"] += len(group)
            for (m, _plan), blk in zip(group, blocks):
                m.add([blk], 0, 0)


class _BatchMember:
    """One request's blocks and segments in the batched execution loop."""
    __slots__ = ("request", "selected", "selected_ids", "num_pruned",
                 "blocks", "extra_parts", "extra_matched", "executed",
                 "final")

    def __init__(self, request: BrokerRequest, selected, num_total: int):
        self.request = request
        self.selected = selected
        self.selected_ids = {id(s) for s in selected}
        self.num_pruned = num_total - len(selected)
        self.blocks: List[IntermediateResultsBlock] = []
        self.extra_parts = 0
        self.extra_matched = 0
        self.executed = 0
        # the multi-segment cube's whole answer, when it gave one
        self.final: Optional[IntermediateResultsBlock] = None

    def add(self, blocks: List[IntermediateResultsBlock], parts: int,
            matched: int) -> None:
        self.blocks.extend(blocks)
        self.extra_parts += parts
        self.extra_matched += matched

    def finish(self, t0: float) -> IntermediateResultsBlock:
        """Combine and stats, as ServerQueryExecutor.execute ends, with
        the truncation the deadline caused."""
        blk = _combine(self.request, self.blocks)
        _finish_stats(blk, self.selected, self.extra_parts,
                      self.extra_matched)
        if self.executed < len(self.selected):
            blk.exceptions.append(
                "DeadlineExceededError: segment execution truncated at "
                f"{self.executed}/{len(self.selected)} segments (budget "
                "expired mid-query)")
        blk.stats.num_segments_pruned = self.num_pruned
        blk.stats.time_used_ms = (time.perf_counter() - t0) * 1e3
        return blk


def _finish_stats(blk: IntermediateResultsBlock, selected, extra_parts: int,
                  extra_matched: int) -> None:
    """Frozen + tail pairs count as one processed segment, matched when
    both halves matched; the consuming segments' count and the oldest of
    their last-indexed times (minConsumingFreshnessTimeMs)."""
    blk.stats.num_segments_processed -= extra_parts
    blk.stats.num_segments_matched -= extra_matched
    consuming_ts = [int(s.last_indexed_time_ms) for s in selected
                    if getattr(s, "is_mutable", False)]
    blk.stats.num_consuming_segments_processed = len(consuming_ts)
    if consuming_ts:
        blk.stats.min_consuming_freshness_ms = min(consuming_ts)


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
