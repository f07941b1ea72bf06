"""Server-side query executor.

Counterpart of pinot_tpu/query/executor.py: prune → plan per segment →
execute on the device, or on the host twin when the planner refuses the
segment → combine → one result block with execution stats. The host twin
(query/host_exec.py) is taken when make_segment_plan raises
UnsupportedOnDevice or GroupsLimitExceeded, the refusals the JAX planner
makes too, before any kernel launches; when the executor runs with
`use_device=False`; and for a segment the residency manager's
`device_gate` keeps off the card (its host or disk tier,
server/residency_manager.py). Nothing else is caught: not the planner's
NotPorted, not a join's StageCompileError (the fact key fails the
integer-key contract), and nothing that plan.execute() raises (a build, a
launch, a kernel).

With a `segment_executor` (the scheduler's worker pool,
server/scheduler.py:segment_pool) the segments of a query run as tasks on
it while the calling thread gathers, as the JAX executor fans them out
(CombineOperator parity): the card serializes the kernels, and the
workers overlap one segment's host work (planning, pulls, finishing)
with another's launches. Without one they run in a loop. `deadline` (a
time.monotonic() instant) truncates either: segments not begun by then
are left out, and the block says so.

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
and their freshness. Where the `mutable_gate` refuses a new device
snapshot (HBM pressure), the whole consuming segment runs on the host
twin over a snapshot view.

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
The ambient query profile (obs/profiler.py:count_path), which the server
instance reports per query, counts them as the JAX executor does.
"""
from __future__ import annotations

import concurrent.futures
import threading
import time
from collections import Counter
from typing import Dict, List, Optional, Tuple

from pinot_tpu_torch.common.metrics import ServerQueryPhase
from pinot_tpu_torch.common.request import BrokerRequest, \
    VECTOR_RESULT_COLUMNS
from pinot_tpu_torch.obs import profiler as obs_profiler
from pinot_tpu_torch.obs.profiler import QueryProfile, obs_span
from pinot_tpu_torch.obs.tracing import TraceContext, make_trace_context
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
    def __init__(self, plan_maker: Optional[InstancePlanMaker] = None,
                 pruner: Optional[SegmentPrunerService] = None,
                 use_device: bool = True,
                 segment_executor: Optional[
                     concurrent.futures.Executor] = None):
        self.plan_maker = plan_maker or InstancePlanMaker()
        self.pruner = pruner or SegmentPrunerService()
        self.use_device = use_device
        # the scheduler's query-worker pool; None runs segments in a loop
        self.segment_executor = segment_executor
        # residency gates (server/residency_manager.py): device_gate(seg)
        # False sends the segment to the host twin (its host / disk tier);
        # mutable_gate(seg) False keeps a consuming segment off the card.
        # None (the default) keeps the ungated device-first behaviour.
        self.device_gate = None
        self.mutable_gate = None
        self._count_lock = threading.Lock()
        self.reset_path_counts()

    def reset_path_counts(self) -> None:
        # "cube" joins the PATHS keys when a star-tree cube first answers
        with self._count_lock:
            self.path_counts: Counter = Counter(dict.fromkeys(PATHS, 0))
            self.tail_docs = 0
            self.tail_ms = 0.0

    def _count(self, path: str, n: int = 1) -> None:
        """One more segment (n more) ended on `path`; the ambient query
        profile counts it as the JAX executor does (a fast path as
        "scan", the pruned segments from the block's stats)."""
        with self._count_lock:
            self.path_counts[path] += n
        if path != "pruned":
            obs_profiler.count_path("scan" if path == "fast" else path, n)

    def execute(self, request: BrokerRequest,
                segments: List[ImmutableSegment],
                trace: Optional[TraceContext] = None,
                deadline: Optional[float] = None
                ) -> IntermediateResultsBlock:
        """`deadline`: absolute time.monotonic() instant; segments not
        begun by then are left out, with an exception in the block saying
        how many ran (pinot_tpu/query/executor.py:54-71)."""
        trace = trace if trace is not None else make_trace_context(False)
        # keep the ambient profile the instance layer activated; direct
        # callers (engine, tests) get a private one
        ambient = obs_profiler.current()
        profile = ambient[0] if ambient is not None else \
            QueryProfile(request.table_name)
        with obs_profiler.active(profile, trace):
            return self._execute(request, segments, trace, deadline)

    def _execute(self, request: BrokerRequest,
                 segments: List[ImmutableSegment], trace: TraceContext,
                 deadline: Optional[float]) -> IntermediateResultsBlock:
        t0 = time.perf_counter()
        # FASTHLL derived rewrite, on a copy (the caller's request stays)
        request = preprocess_request(segments, request)
        with trace.span(ServerQueryPhase.SEGMENT_PRUNING):
            selected = self.pruner.prune(segments, request)
        self._count("pruned", len(segments) - len(selected))
        blk = self._try_star_tree_multi(request, selected)
        if blk is not None:
            blk.stats.num_segments_pruned = len(segments) - len(selected)
            blk.stats.time_used_ms = (time.perf_counter() - t0) * 1e3
            return blk
        with trace.span(ServerQueryPhase.SEGMENT_EXECUTION):
            if self.segment_executor is not None and len(selected) > 1:
                results = self._run_parallel(selected, request, deadline,
                                             trace)
            else:
                results = self._run_sequential(selected, request, deadline)
        blocks: List[IntermediateResultsBlock] = []
        extra_parts = extra_matched = 0
        for seg_blocks, parts, matched in results:
            blocks.extend(seg_blocks)
            extra_parts += parts
            extra_matched += matched
        blk = _combine(request, blocks)
        _finish_stats(blk, selected, extra_parts, extra_matched)
        _note_truncation(blk, len(results), len(selected))
        blk.stats.num_segments_pruned = len(segments) - len(selected)
        blk.stats.time_used_ms = (time.perf_counter() - t0) * 1e3
        return blk

    def _run_sequential(self, selected, request: BrokerRequest,
                        deadline: Optional[float]) -> List[tuple]:
        out = []
        for seg in selected:
            if deadline is not None and time.monotonic() >= deadline:
                break
            out.append(self._segment_work(seg, request))
        return out

    def _run_parallel(self, selected, request: BrokerRequest,
                      deadline: Optional[float],
                      trace: Optional[TraceContext] = None) -> List[tuple]:
        """Each segment a task on the worker pool while this thread
        gathers (pinot_tpu/query/executor.py:205-270). Tasks not started
        when the budget expires return unexecuted, and the gather
        abandons stragglers instead of waiting past the deadline;
        whatever finished still counts. The workers re-enter the query's
        profile and trace span."""
        ambient = obs_profiler.current()
        parent_id = trace.current_span_id() if trace is not None else None

        def work(seg):
            if deadline is not None and time.monotonic() >= deadline:
                return None                 # budget gone before start
            with obs_profiler.reactivate(ambient):
                if trace is not None and trace.enabled:
                    with trace.attach(parent_id):
                        return self._segment_work(seg, request)
                return self._segment_work(seg, request)

        futures = [self.segment_executor.submit(work, seg)
                   for seg in selected]
        results: List[Optional[tuple]] = [None] * len(selected)
        abandoned = False
        for i, fut in enumerate(futures):
            if abandoned:
                fut.cancel()
                continue
            budget = None if deadline is None else \
                deadline - time.monotonic()
            try:
                results[i] = fut.result(
                    timeout=None if budget is None else max(budget, 0.0))
            except concurrent.futures.TimeoutError:
                abandoned = True
                fut.cancel()
        if abandoned:
            for i, fut in enumerate(futures):
                if results[i] is None and fut.done() and \
                        not fut.cancelled():
                    try:
                        results[i] = fut.result(timeout=0)
                    except (concurrent.futures.TimeoutError,
                            concurrent.futures.CancelledError):
                        pass
        return [r for r in results if r is not None]

    def _segment_work(self, seg, request: BrokerRequest
                      ) -> Tuple[List[IntermediateResultsBlock], int, int]:
        with obs_span("segment",
                      segment=getattr(seg, "segment_name", "?")):
            return self._segment_work_inner(seg, request)

    def _segment_work_inner(self, seg, request: BrokerRequest
                            ) -> Tuple[List[IntermediateResultsBlock],
                                       int, int]:
        """ONE logical segment: (blocks, extra parts, extra matched). A
        consuming segment gives its frozen prefix's block (the card) and
        its tail's (the host twin); the pair counts as one segment,
        matched when both halves matched."""
        if not getattr(seg, "is_mutable", False):
            return [self._execute_segment(seg, request)], 0, 0
        if not self.use_device or \
                (self.mutable_gate is not None and not self.mutable_gate(seg)):
            # no device snapshot: the whole consuming segment on the host
            # twin, its (num_docs, cardinalities) frozen for the query
            return [self._execute_segment(seg.snapshot_view(),
                                          request)], 0, 0
        frozen, tail = seg.device_view()
        blocks: List[IntermediateResultsBlock] = []
        fb = tb = None
        if frozen is not None:
            fb = self._execute_segment(frozen, request)
            blocks.append(fb)
        if tail.num_docs > 0 or frozen is None:
            t0 = time.perf_counter()
            tb = self._execute_segment(tail, request)   # the host twin
            with self._count_lock:
                self.tail_ms += (time.perf_counter() - t0) * 1e3
                self.tail_docs += tail.num_docs
            blocks.append(tb)
        if fb is not None and tb is not None:
            return blocks, 1, int(bool(fb.stats.num_segments_matched and
                                       tb.stats.num_segments_matched))
        return blocks, 0, 0

    def _on_device(self, segment) -> bool:
        return self.use_device and \
            (self.device_gate is None or self.device_gate(segment))

    def _plan(self, segment: ImmutableSegment,
              request: BrokerRequest) -> Optional[SegmentPlan]:
        """The segment's plan, or None where the planner refuses it or
        the segment stays off the card."""
        if not self._on_device(segment):
            return None
        try:
            with obs_span(ServerQueryPhase.BUILD_QUERY_PLAN):
                return self.plan_maker.make_segment_plan(segment, request)
        except (GroupsLimitExceeded, UnsupportedOnDevice):
            return None

    def _run_plan(self, plan: Optional[SegmentPlan], segment, request
                  ) -> IntermediateResultsBlock:
        """One member's sequential ladder on one segment: the host twin
        for a refused plan, else the plan (a fast path or the kernels)."""
        if plan is None:
            self._count("host")
            return host_exec.execute_host(segment, request)
        self._count("fast" if plan.fast_path_result is not None
                    else "scan")
        with obs_span(ServerQueryPhase.QUERY_PLAN_EXECUTION):
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
                self._count("cube")
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
                self._count("cube", len(selected))
                return blk
        return None

    # -- cross-query batched execution --------------------------------------
    def execute_batch(self, requests: List[BrokerRequest],
                      segments: List[ImmutableSegment],
                      trace: Optional[TraceContext] = None,
                      deadline: Optional[float] = None
                      ) -> List[IntermediateResultsBlock]:
        """Execute N same-shape requests over one segment set, sharing the
        kernel launches wherever their per-segment plans compile to equal
        specs (pinot_tpu/query/executor.py:execute_batch). Pruning and
        planning are per member (literals steer pruning and can fold a
        plan to a fast path), and members are grouped by their compiled
        signature, so a shape-key collision costs batching, never an
        answer. Group-by, fast-path and refused members, and segments off
        the card or consuming, run the sequential ladder, with the same
        answer; a raw-key join's members batch like any other (K1's
        batched join_raw leaf). `deadline`: a time.monotonic() instant;
        segments not begun by then are left out, and each member's block
        says so. Returns blocks aligned with `requests`."""
        trace = trace if trace is not None else make_trace_context(False)
        ambient = obs_profiler.current()
        profile = ambient[0] if ambient is not None else \
            QueryProfile(requests[0].table_name if requests else "?")
        with obs_profiler.active(profile, trace):
            return self._execute_batch(requests, segments, deadline)

    def _execute_batch(self, requests, segments, deadline):
        t0 = time.perf_counter()
        members = []
        for req in requests:
            req = preprocess_request(segments, req)
            selected = self.pruner.prune(segments, req)
            self._count("pruned", len(segments) - len(selected))
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
        consuming segment, and a segment kept off the card, run per
        member (pinot_tpu/query/executor.py:370-376)."""
        if getattr(seg, "is_mutable", False) or not self._on_device(seg):
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
            with obs_span(ServerQueryPhase.QUERY_PLAN_EXECUTION):
                blocks = execution.execute_segment_plans_batched(
                    [plan for _m, plan in group])
            self._count("scan", len(group))
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
        _note_truncation(blk, self.executed, len(self.selected))
        blk.stats.num_segments_pruned = self.num_pruned
        blk.stats.time_used_ms = (time.perf_counter() - t0) * 1e3
        return blk


def _note_truncation(blk: IntermediateResultsBlock, executed: int,
                     selected: int) -> None:
    if executed < selected:
        blk.exceptions.append(
            "DeadlineExceededError: segment execution truncated at "
            f"{executed}/{selected} segments (budget expired mid-query)")


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
