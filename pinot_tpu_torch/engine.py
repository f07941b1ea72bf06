"""In-process query engine facade: PQL in, BrokerResponse out.

Counterpart of pinot_tpu/engine.py: compile → optimize → prune →
per-segment execute on the device (or on the host twin where the planner
refuses a segment as the JAX planner does) → broker reduce, all in one
process; or, with a mesh, one stacked execution over every segment
(parallel/sharded.py), falling back to the per-segment path where the
JAX engine does. VECTOR_SIMILARITY queries (exact or IVF-probed) take the
same paths. A consuming segment (realtime/mutable_segment.py) may be one
of the segments: its frozen prefix runs on the engine's device and its
tail on the host twin; with a mesh, a set that holds one goes the
per-segment way (NotShardable). Segments of an upsert table carry their
ValidDocIds and are masked on every path.

Join and window queries are multi-stage, and this engine has no stage
plane, as the JAX QueryEngine has none: it raises the typed
StageCompileError the JAX server raises for a join dispatched without
exchange sources. They run through the stage entry points: stage 1 with
query/stages/broker.py's dim_scan_request / window_scan_request through
ServerQueryExecutor, each DataTable published with
stages/exchange.py:ExchangeManager.put; stage 2 with
stages/join.py:build_context attached as request._join_ctx to a
ServerQueryExecutor or ShardedQueryExecutor run, or with
stages/window.py:execute_window_stage.
"""
from __future__ import annotations

import collections
import time
from typing import Optional, Sequence

from pinot_tpu_torch.common.device import resolve_device
from pinot_tpu_torch.common.response import BrokerResponse
from pinot_tpu_torch.pql.optimizer import BrokerRequestOptimizer
from pinot_tpu_torch.pql.parser import compile_pql
from pinot_tpu_torch.query.executor import ServerQueryExecutor
from pinot_tpu_torch.query.plan import GroupsLimitExceeded, \
    UnsupportedOnDevice, preprocess_request
from pinot_tpu_torch.query.reduce import BrokerReduceService
from pinot_tpu_torch.segment.loader import ImmutableSegmentLoader


class QueryEngine:
    def __init__(self, segments: Sequence, device=None, mesh=None):
        """`device`: where the segments' lanes live and the kernels run;
        None means the card ("cuda"), which raises when there is none.
        Pass device="cpu" to run the kernels' plain versions on the CPU.

        `mesh` (parallel.make_mesh(), on the engine's device): multi-segment
        queries run stacked, one launch per kernel over every segment,
        and fall back to the per-segment path on NotShardable,
        GroupsLimitExceeded or UnsupportedOnDevice, as the JAX engine
        does. `route_counts` counts where queries went since construction:
        "stacked", "sequential" (no mesh, or one segment) or the name of
        the exception that sent a query back; `last_route` is the last
        query's (route, reason)."""
        self.device = resolve_device(device)
        self.segments = [seg.to(self.device) for seg in segments]
        self.executor = ServerQueryExecutor()
        self.sharded = None
        if mesh is not None:
            from pinot_tpu_torch.parallel.sharded import ShardedQueryExecutor
            if tuple(mesh) != (self.device,):
                raise ValueError(f"mesh {tuple(mesh)} is not the engine's "
                                 f"device {self.device}")
            self.sharded = ShardedQueryExecutor(mesh=mesh)
        self.optimizer = BrokerRequestOptimizer()
        self.reducer = BrokerReduceService()
        self.route_counts: collections.Counter = collections.Counter()
        self.last_route: Optional[tuple] = None

    @classmethod
    def from_dirs(cls, segment_dirs: Sequence[str], device=None,
                  mesh=None) -> "QueryEngine":
        """Load each segment directory (ImmutableSegmentLoader.load) and
        serve them; `device` and `mesh` as for the constructor."""
        return cls([ImmutableSegmentLoader.load(d) for d in segment_dirs],
                   device=device, mesh=mesh)

    def query(self, pql: str) -> BrokerResponse:
        t0 = time.perf_counter()
        request = self.optimizer.optimize(compile_pql(pql))
        if request.join is not None or request.windows:
            from pinot_tpu_torch.query.stages.errors import StageCompileError
            what = "join" if request.join is not None else "window"
            raise StageCompileError(
                f"{what} query dispatched without exchange sources (stage-1 "
                f"{'dim' if what == 'join' else 'window'} scan missing): run "
                "it through query/stages (build_context or "
                "execute_window_stage), not QueryEngine")
        # FASTHLL → its derived column, once, so that the reduce names
        # the result after the rewritten column, as the JAX engine does
        request = preprocess_request(self.segments, request)
        block = self._execute(request)
        resp = self.reducer.reduce(request, [block])
        resp.time_used_ms = (time.perf_counter() - t0) * 1e3
        return resp

    def _execute(self, request):
        route = ("sequential", None)
        if self.sharded is not None and len(self.segments) > 1:
            from pinot_tpu_torch.parallel.sharded import NotShardable
            try:
                block = self.sharded.execute(request, self.segments)
                self._note(("stacked", None))
                return block
            except (NotShardable, GroupsLimitExceeded,
                    UnsupportedOnDevice) as e:
                route = (type(e).__name__, str(e))
        self._note(route)
        return self.executor.execute(request, self.segments)

    def _note(self, route: tuple) -> None:
        self.route_counts[route[0]] += 1
        self.last_route = route
