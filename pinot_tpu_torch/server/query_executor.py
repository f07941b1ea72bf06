"""Server query executor: acquire → prune → execute → DataTable.

Counterpart of pinot_tpu/server/query_executor.py:27-366
(`InstanceQueryExecutor`): refcounted segment acquisition from the
instance's data manager, the port's ServerQueryExecutor per segment (or
the stacked ShardedQueryExecutor when a mesh is given, falling back to
the per-segment path on NotShardable, GroupsLimitExceeded or
UnsupportedOnDevice, as the JAX executor does), timeout and deadline
accounting, execution stats and the query profile on the DataTable.
Join stage 2 attaches the JoinContext built from the exchanged dim
blocks; window stage 2 runs execute_window_stage over the exchanged
scans. Each query is bracketed by the residency manager's begin_query /
end_query: heat, disk reloads, promotions, and the pins that keep a
demotion from releasing a lane the query reads.

The segments are bound to the executor's device as they are acquired
(ImmutableSegment.to: a no-op when they already are), so the instance's
device decides where the lanes live: the card unless "cpu" is passed.
"""
from __future__ import annotations

import json
import time
from typing import List, Optional

from pinot_tpu_torch.common.datatable import (DataTable, MISSING_SEGMENTS_KEY,
                                              SEGMENT_MISSING_EXC_PREFIX)
from pinot_tpu_torch.common.device import resolve_device
from pinot_tpu_torch.common.metrics import (MetricsRegistry, ServerMeter,
                                            ServerQueryPhase)
from pinot_tpu_torch.common.request import InstanceRequest
from pinot_tpu_torch.obs import profiler as obs_profiler
from pinot_tpu_torch.obs.profiler import QueryProfile
from pinot_tpu_torch.obs.tracing import TraceContext, make_trace_context
from pinot_tpu_torch.query.blocks import IntermediateResultsBlock
from pinot_tpu_torch.query.executor import ServerQueryExecutor
from pinot_tpu_torch.query.plan import preprocess_request
from pinot_tpu_torch.server.data_manager import InstanceDataManager
from pinot_tpu_torch.server.result_cache import segment_cache_states


class InstanceQueryExecutor:
    """Executes InstanceRequests against this server's tables."""

    def __init__(self, data_manager: InstanceDataManager,
                 mesh=None, use_device: bool = True,
                 default_timeout_ms: float = 15_000.0,
                 metrics: Optional[MetricsRegistry] = None,
                 segment_executor=None, residency=None, device=None):
        """`device`: where the segments' lanes live and the kernels run
        (None: the card, which raises without one). `mesh`
        (parallel.make_mesh() on that device): multi-segment queries run
        stacked. `segment_executor`: the scheduler's worker pool, on
        which the per-segment path fans out. `residency`: the instance's
        ResidencyManager (default: the process-wide one)."""
        self.data_manager = data_manager
        self.device = resolve_device(device)
        self.executor = ServerQueryExecutor(
            use_device=use_device, segment_executor=segment_executor)
        from pinot_tpu_torch.server import residency_manager
        self.residency = residency if residency is not None \
            else residency_manager.MANAGER
        self.executor.device_gate = self.residency.device_allowed
        self.executor.mutable_gate = self.residency.mutable_device_allowed
        self.sharded = None
        if mesh is not None:
            from pinot_tpu_torch.parallel.sharded import ShardedQueryExecutor
            if tuple(mesh) != (self.device,):
                raise ValueError(f"mesh {tuple(mesh)} is not the "
                                 f"executor's device {self.device}")
            self.sharded = ShardedQueryExecutor(mesh=mesh)
            data_manager.add_removal_listener(self.sharded.evict_segment)
        self.default_timeout_ms = default_timeout_ms
        self.metrics = metrics or MetricsRegistry("server")

    def _acquire(self, tdm, names):
        """(acquired managers, missing names, segments bound to the
        device)."""
        acquired, missing = tdm.acquire_segments(names)
        return acquired, missing, [s.segment.to(self.device)
                                   for s in acquired]

    @staticmethod
    def _failed(request: InstanceRequest, message: str) -> DataTable:
        dt = DataTable()
        dt.metadata["requestId"] = str(request.request_id)
        dt.exceptions.append(message)
        return dt

    def execute(self, request: InstanceRequest,
                scheduler_wait_ms: float = 0.0,
                deadline: Optional[float] = None,
                deser_ms: float = 0.0) -> DataTable:
        """`deadline`: absolute time.monotonic() instant from the
        broker-propagated budget; expired work is dropped or truncated."""
        t_start = time.perf_counter()
        self.metrics.meter(ServerMeter.QUERIES).mark()
        vec = request.query.vector
        if vec is not None and int(getattr(vec, "nprobe", 0) or 0) > 0:
            self.metrics.meter(ServerMeter.IVF_NPROBE_QUERIES).mark()
        self.metrics.timer(ServerQueryPhase.SCHEDULER_WAIT).update(
            scheduler_wait_ms)
        if deadline is not None and time.monotonic() >= deadline:
            self.metrics.meter(ServerMeter.DEADLINE_EXPIRED_QUERIES).mark()
            return self._failed(
                request, "DeadlineExceededError: query budget expired "
                "before execution started; dropped without executing")
        trace = make_trace_context(request.enable_trace,
                                   trace_id=request.trace_id,
                                   parent_span_id=request.parent_span_id,
                                   root_name="server")
        if deser_ms:
            trace.record(ServerQueryPhase.REQUEST_DESERIALIZATION,
                         deser_ms)
        trace.record(ServerQueryPhase.SCHEDULER_WAIT, scheduler_wait_ms)
        query = request.query
        if query.windows and request.exchange_sources is not None:
            # window stage 2 (coordinator): all data arrives through the
            # exchange, no local segment acquisition at all
            return self._execute_window_stage(request, deadline)
        timeout_ms = query.query_options.timeout_ms or self.default_timeout_ms
        if request.deadline_budget_ms is not None:
            timeout_ms = min(timeout_ms, request.deadline_budget_ms)
        tdm = self.data_manager.table(query.table_name)
        if tdm is None:
            dt = DataTable()
            dt.exceptions.append(
                f"TableDoesNotExistError: {query.table_name}")
            return dt

        profile = QueryProfile(query.table_name)
        acquired, missing, segments = self._acquire(
            tdm, request.search_segments)
        residency_token = self.residency.begin_query(segments)
        try:
            # the result cache keys on the states captured BEFORE
            # execution (an upsert bump mid-query must not key
            # pre-invalidation rows under the post-bump version)
            pre_states = None if missing else segment_cache_states(segments)
            # FASTHLL rewrite once, before the fan-out: the DataTable
            # columns carry the rewritten names
            query = preprocess_request(segments, query)
            if query.join is not None:
                from pinot_tpu_torch.query.stages.errors import (
                    StageCompileError, stage_error_datatable)
                try:
                    query = self._attach_join_context(request, query,
                                                      segments, deadline)
                    with obs_profiler.active(profile, trace):
                        block = self._execute_segments(
                            query, segments, trace, deadline=deadline)
                except StageCompileError as e:
                    return stage_error_datatable(
                        request.request_id, "joinCompile", str(e))
            else:
                with obs_profiler.active(profile, trace):
                    block = self._execute_segments(query, segments, trace,
                                                   deadline=deadline)
            if missing:
                block.exceptions.append(
                    f"{SEGMENT_MISSING_EXC_PREFIX} {sorted(missing)}")
            elapsed_ms = (time.perf_counter() - t_start) * 1e3
            if elapsed_ms > timeout_ms:
                block.exceptions.append(
                    f"QueryTimeoutError: {elapsed_ms:.0f}ms > "
                    f"{timeout_ms:.0f}ms")
            block.stats.time_used_ms = elapsed_ms
            self.metrics.timer(ServerQueryPhase.QUERY_PROCESSING).update(
                elapsed_ms)
            # per-table twin: the admission controller's service-time
            # estimate reads it
            self.metrics.timer(ServerQueryPhase.QUERY_PROCESSING,
                               table=query.table_name).update(elapsed_ms)
            trace.record(ServerQueryPhase.QUERY_PROCESSING, elapsed_ms)
            dt = DataTable.from_block(query, block)
            dt.metadata["requestId"] = str(request.request_id)
            dt.cache_states = pre_states
            profile.finish_from_stats(block.stats)
            dt.metadata["profileInfo"] = profile.to_json_str()
            if missing:
                dt.metadata[MISSING_SEGMENTS_KEY] = json.dumps(
                    sorted(missing))
            if request.enable_trace:
                dt.metadata["traceInfo"] = trace.to_json_str()
            return dt
        finally:
            self.residency.end_query(residency_token)
            for sdm in acquired:
                tdm.release_segment(sdm)

    def execute_batch(self, requests: List[InstanceRequest],
                      scheduler_wait_ms: List[float],
                      deadline: Optional[float]) -> List[DataTable]:
        """One sealed coalescer batch: N same-shape requests over one
        table and segment list (the coalescer's key), no trace, not
        staged, sharing the kernel launches. Returns DataTables aligned
        with `requests`."""
        t_start = time.perf_counter()
        n = len(requests)
        for wait_ms in scheduler_wait_ms:
            self.metrics.meter(ServerMeter.QUERIES).mark()
            self.metrics.timer(ServerQueryPhase.SCHEDULER_WAIT).update(
                wait_ms)
        if deadline is not None and time.monotonic() >= deadline:
            for _ in requests:
                self.metrics.meter(
                    ServerMeter.DEADLINE_EXPIRED_QUERIES).mark()
            return [self._failed(
                r, "DeadlineExceededError: query budget expired before "
                "execution started; dropped without executing")
                for r in requests]
        table = requests[0].query.table_name
        tdm = self.data_manager.table(table)
        if tdm is None:
            return [self._failed(r, f"TableDoesNotExistError: {table}")
                    for r in requests]

        trace = make_trace_context(False)
        profile = QueryProfile(table)
        acquired, missing, segments = self._acquire(
            tdm, requests[0].search_segments)
        residency_token = self.residency.begin_query(segments)
        try:
            pre_states = None if missing else \
                segment_cache_states(segments)
            queries = [preprocess_request(segments, r.query)
                       for r in requests]
            with obs_profiler.active(profile, trace):
                blocks = self.executor.execute_batch(
                    queries, segments, trace=trace, deadline=deadline)
            elapsed_ms = (time.perf_counter() - t_start) * 1e3
            out = []
            for request, query, block in zip(requests, queries, blocks):
                if missing:
                    block.exceptions.append(
                        f"{SEGMENT_MISSING_EXC_PREFIX} {sorted(missing)}")
                timeout_ms = query.query_options.timeout_ms or \
                    self.default_timeout_ms
                if request.deadline_budget_ms is not None:
                    timeout_ms = min(timeout_ms,
                                     request.deadline_budget_ms)
                if elapsed_ms > timeout_ms:
                    block.exceptions.append(
                        f"QueryTimeoutError: {elapsed_ms:.0f}ms > "
                        f"{timeout_ms:.0f}ms")
                block.stats.time_used_ms = elapsed_ms
                # every member pays (and reports) the batch's wall time
                self.metrics.timer(
                    ServerQueryPhase.QUERY_PROCESSING).update(elapsed_ms)
                self.metrics.timer(ServerQueryPhase.QUERY_PROCESSING,
                                   table=table).update(elapsed_ms)
                dt = DataTable.from_block(query, block)
                dt.metadata["requestId"] = str(request.request_id)
                dt.cache_states = pre_states
                # per member: its own result stats, the batch's dispatch
                # and path numbers (each member rode every shared launch)
                mp = QueryProfile(table)
                mp.dispatches = profile.dispatches
                mp.transfer_bytes = profile.transfer_bytes
                mp.kernel_ms = profile.kernel_ms
                mp.paths = dict(profile.paths)
                mp.batch_size = n
                mp.finish_from_stats(block.stats)
                dt.metadata["profileInfo"] = mp.to_json_str()
                if missing:
                    dt.metadata[MISSING_SEGMENTS_KEY] = json.dumps(
                        sorted(missing))
                out.append(dt)
            return out
        finally:
            self.residency.end_query(residency_token)
            for sdm in acquired:
                tdm.release_segment(sdm)

    def _attach_join_context(self, request: InstanceRequest, query,
                             segments: List, deadline: Optional[float]):
        """Build the JoinContext from the exchanged dim blocks and attach
        it to a server-local request copy (stages/join.py:attach checks
        the fact key's contract up front)."""
        from pinot_tpu_torch.query.stages import join as stages_join
        from pinot_tpu_torch.query.stages.errors import StageCompileError
        if request.exchange_sources is None:
            raise StageCompileError(
                "join query dispatched without exchange sources (stage-1 "
                "dim scan missing)")
        fact_parts = stages_join.fact_partition_info(
            segments, query.join.fact_key)
        ctx = stages_join.build_context(query.join,
                                        request.exchange_sources,
                                        fact_parts, deadline_s=deadline)
        return stages_join.attach(query, ctx, segments)

    def _execute_window_stage(self, request: InstanceRequest,
                              deadline: Optional[float]) -> DataTable:
        from pinot_tpu_torch.query.stages.errors import (
            StageCompileError, stage_error_datatable)
        from pinot_tpu_torch.query.stages.window import execute_window_stage
        try:
            blk = execute_window_stage(
                request.query, request.exchange_sources,
                deadline_s=deadline, use_device=self.executor.use_device,
                device=self.device)
        except StageCompileError as e:
            return stage_error_datatable(request.request_id,
                                         "windowCompile", str(e))
        dt = DataTable.from_block(request.query, blk)
        dt.metadata["requestId"] = str(request.request_id)
        return dt

    def _execute_segments(self, query, segments: List, trace: TraceContext,
                          deadline: Optional[float] = None
                          ) -> IntermediateResultsBlock:
        # the stacked path holds every segment's lanes on the card: only
        # when all of them are device-tier (a demoted segment must not be
        # uploaded again through a stack)
        if self.sharded is not None and len(segments) > 1 and \
                all(self.residency.device_allowed(s) for s in segments):
            from pinot_tpu_torch.parallel.sharded import NotShardable
            from pinot_tpu_torch.query.plan import (GroupsLimitExceeded,
                                                    UnsupportedOnDevice)
            try:
                with trace.span(ServerQueryPhase.SHARDED_EXECUTION):
                    blk = self.sharded.execute(query, segments)
                blk.execution_path = "sharded"
                obs_profiler.count_path("sharded", len(segments))
                return blk
            except (NotShardable, GroupsLimitExceeded, UnsupportedOnDevice):
                pass
        blk = self.executor.execute(query, segments, trace=trace,
                                    deadline=deadline)
        blk.execution_path = "sequential"
        return blk
