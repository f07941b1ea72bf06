"""In-process query engine facade: PQL in, BrokerResponse out.

Counterpart of pinot_tpu/engine.py: compile → optimize → prune →
per-segment execute on the device (or on the host twin where the planner
refuses a segment as the JAX planner does) → broker reduce, all in one
process. Vector, join and window requests raise NotPorted here, before
the executor: the port has no path for them yet, on the device or on the
host.
"""
from __future__ import annotations

import time
from typing import Sequence

from pinot_tpu_torch.common.device import resolve_device
from pinot_tpu_torch.common.response import BrokerResponse
from pinot_tpu_torch.pql.optimizer import BrokerRequestOptimizer
from pinot_tpu_torch.pql.parser import compile_pql
from pinot_tpu_torch.query.executor import ServerQueryExecutor
from pinot_tpu_torch.query.plan import NotPorted
from pinot_tpu_torch.query.reduce import BrokerReduceService
from pinot_tpu_torch.segment.loader import ImmutableSegment, \
    ImmutableSegmentLoader


class QueryEngine:
    def __init__(self, segments: Sequence[ImmutableSegment], device=None):
        """`device`: where the segments' lanes live and the kernels run;
        None means the card ("cuda"), which raises when there is none.
        Pass device="cpu" to run the kernels' plain versions on the CPU."""
        self.device = resolve_device(device)
        self.segments = [seg.to(self.device) for seg in segments]
        self.executor = ServerQueryExecutor()
        self.optimizer = BrokerRequestOptimizer()
        self.reducer = BrokerReduceService()

    @classmethod
    def from_dirs(cls, segment_dirs: Sequence[str],
                  device=None) -> "QueryEngine":
        """Load each segment directory (ImmutableSegmentLoader.load) and
        serve them; `device` as for the constructor."""
        return cls([ImmutableSegmentLoader.load(d) for d in segment_dirs],
                   device=device)

    def query(self, pql: str) -> BrokerResponse:
        t0 = time.perf_counter()
        request = self.optimizer.optimize(compile_pql(pql))
        if request.vector is not None or request.join is not None or \
                request.windows:
            raise NotPorted("vector / join / window queries are "
                                      "not in the port yet")
        block = self.executor.execute(request, self.segments)
        resp = self.reducer.reduce(request, [block])
        resp.time_used_ms = (time.perf_counter() - t0) * 1e3
        return resp
