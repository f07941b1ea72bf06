"""Server admission control: watermarks, deadline-aware shedding, brownout.

Copy of pinot_tpu/server/admission.py (JAX-free), its imports rebased
onto pinot_tpu_torch; its controller also takes the promotion-backlog
watermark as an argument (ServerInstance passes it through).

PROFILE_r06.json names the failure mode: past the ~100-QPS knee,
queueing dominates (58.8ms of a 77.6ms scatter-gather) and every
tenant's p99 collapses together. Admission control turns that cliff
into a policy:

- **Deadline-aware shedding** (always on): a query whose remaining
  broker budget is below the table's rolling service-time estimate
  (the per-table ``queryProcessing`` timer the obs/ profiler already
  feeds) cannot produce an answer its broker will still be listening
  for — drop it at the door instead of letting it burn a worker.
- **Bounded-queue watermarks** with a DETERMINISTIC shed order as
  depth (submitted minus completed queries) climbs:

  1. ``low``  → hedged duplicates are shed first (the primary is in
     flight somewhere; dropping the duplicate loses nothing),
  2. ``mid``  → tenants above their fair share of the queue are shed
     (``tenantOverQuota``) so one tenant's flood degrades only its own
     p99,
  3. ``high`` → surviving admissions run in **brownout**: their
     effective deadline is tightened to a small multiple of the
     service-time estimate, so the executor truncates the per-segment
     loop and returns a *flagged-partial* result instead of queueing
     without bound,
  4. ``max_pending`` → everything new is shed (``capacity``).

Shed replies are typed: DataTable metadata ``serverBusy`` = cause +
``retryAfterMs`` = a drain estimate, and a ``ServerBusyError:``
exception the router treats as non-retriable on the SAME server
(failover to a replica only). Result-cache hits never reach admission
— the cache is the graceful-degradation valve under overload.
"""
from __future__ import annotations

import threading
import time
from typing import Callable, Dict, Optional

from pinot_tpu_torch.common.datatable import (DataTable, RETRY_AFTER_MS_KEY,
                                        SERVER_BUSY_EXC_PREFIX,
                                        SERVER_BUSY_KEY)
from pinot_tpu_torch.common.metrics import (MetricsRegistry, ServerGauge,
                                      ServerMeter, ServerQueryPhase)


class ServiceTimeEstimator:
    """Rolling per-table service-time estimate read from the metrics
    the executor already records: `query_executor.py` updates the
    per-table ``queryProcessing`` timer after every execution, and this
    estimator only READS it — there is no separate write path."""

    MIN_SAMPLES = 8
    PCT = 75.0

    def __init__(self, metrics: MetricsRegistry):
        self.metrics = metrics

    def estimate_ms(self, table: str) -> Optional[float]:
        # peek, never create: admission runs before any table-existence
        # check, so a get-or-create here would let a flood of requests
        # naming random tables grow the registry (and its Prometheus
        # exposition) without bound
        timer = self.metrics.peek_timer(ServerQueryPhase.QUERY_PROCESSING,
                                        table=table)
        if timer is None or timer.count < self.MIN_SAMPLES:
            return None
        return timer.percentiles_ms((self.PCT,))[0]


class AdmissionDecision:
    __slots__ = ("admitted", "cause", "retry_after_ms", "brownout",
                 "deadline_s")

    def __init__(self, admitted: bool, cause: Optional[str] = None,
                 retry_after_ms: float = 0.0, brownout: bool = False,
                 deadline_s: Optional[float] = None):
        self.admitted = admitted
        self.cause = cause
        self.retry_after_ms = retry_after_ms
        self.brownout = brownout
        # tightened ABSOLUTE deadline (clock() instant) under brownout
        self.deadline_s = deadline_s

    def __bool__(self) -> bool:
        return self.admitted


class AdmissionController:
    """Admit/shed gate in front of the scheduler; depth is queries
    admitted and not yet completed (queue wait + execution)."""

    DEADLINE_MARGIN = 1.0     # shed when budget < estimate × margin
    BROWNOUT_FACTOR = 2.0     # brownout deadline = estimate × factor
    BROWNOUT_FLOOR_MS = 25.0  # ...never tighter than this floor
    MIN_TENANT_SHARE = 2      # fair-share floor per tenant (queries)
    # residency promotion backlog (hot segments stuck off-device) at or
    # above this → brownout regardless of queue depth: a reload storm
    # means queries are already paying cold/host penalties, so tighten
    # deadlines early instead of timing out late
    PROMOTION_BACKLOG_WATERMARK = 4

    def __init__(self, metrics: Optional[MetricsRegistry] = None,
                 estimator: Optional[ServiceTimeEstimator] = None,
                 max_pending: int = 64,
                 low_pct: float = 0.4, mid_pct: float = 0.7,
                 high_pct: float = 0.9,
                 num_workers: int = 4,
                 clock: Callable[[], float] = time.monotonic,
                 backlog_fn: Optional[Callable[[], int]] = None,
                 promotion_backlog_watermark: Optional[int] = None):
        """`promotion_backlog_watermark`: this controller's brownout
        watermark on the residency promotion backlog (None: the class's
        PROMOTION_BACKLOG_WATERMARK). A deployment whose device budget
        keeps more hot segments off the card than the default sets it
        above their count, or every query browns out."""
        self.metrics = metrics or MetricsRegistry("server")
        self.estimator = estimator or ServiceTimeEstimator(self.metrics)
        self.max_pending = int(max_pending)
        self.low = max(1, int(max_pending * low_pct))
        self.mid = max(2, int(max_pending * mid_pct))
        self.high = max(3, int(max_pending * high_pct))
        self.num_workers = max(1, num_workers)
        self._clock = clock
        # reads the residency manager's promotionBacklog gauge value
        self._backlog_fn = backlog_fn
        if promotion_backlog_watermark is not None:
            self.PROMOTION_BACKLOG_WATERMARK = int(
                promotion_backlog_watermark)
        self._depth = 0
        self._by_tenant: Dict[str, int] = {}
        self._lock = threading.Lock()
        self.metrics.gauge(ServerGauge.ADMISSION_QUEUE_DEPTH).set_callable(
            lambda: self._depth)
        self.metrics.meter(ServerMeter.REQUESTS_SHED)  # exists from boot

    # -- depth accounting ---------------------------------------------------
    def release(self, tenant: str) -> None:
        """The admitted query completed (any outcome)."""
        with self._lock:
            self._depth -= 1
            n = self._by_tenant.get(tenant, 0) - 1
            if n <= 0:
                self._by_tenant.pop(tenant, None)
            else:
                self._by_tenant[tenant] = n

    def depth(self) -> int:
        return self._depth

    # -- the gate -----------------------------------------------------------
    def _shed(self, cause: str, retry_after_ms: float) -> AdmissionDecision:
        self.metrics.meter(ServerMeter.REQUESTS_SHED).mark()
        self.metrics.meter(ServerMeter.REQUESTS_SHED, table=cause).mark()
        return AdmissionDecision(False, cause, retry_after_ms)

    def _drain_estimate_ms(self, depth: int, est_ms: Optional[float]
                           ) -> float:
        """How long until the current backlog has drained (Retry-After)."""
        per_query = est_ms if est_ms is not None else 10.0
        return max(1.0, depth * per_query / self.num_workers)

    def admit(self, table: str, tenant: str,
              budget_ms: Optional[float] = None,
              hedge: bool = False,
              batch_join: bool = False) -> AdmissionDecision:
        """``batch_join``: this server already holds an open batch
        window for the request's plan shape — a hedged duplicate that
        would normally be shed at the low watermark instead rides the
        primary's dispatch for (almost) free, so shedding it wastes a
        slot for zero information."""
        # the estimator read happens OUTSIDE self._lock (it takes the
        # timer's own lock; no nesting); same for the residency
        # promotion backlog (it takes the manager's lock)
        est = self.estimator.estimate_ms(table)
        backlogged = self._backlog_fn is not None and \
            self._backlog_fn() >= self.PROMOTION_BACKLOG_WATERMARK
        now = self._clock()
        with self._lock:
            depth = self._depth
            # 1. deadline-aware — but only under load (low watermark,
            # same tier that drops hedges). The estimate is the TABLE's
            # rolling p75: on a mixed workload (heavy group-bys next to
            # point lookups) a cheap query class with a tight timeout
            # sits below it permanently, and since deadline sheds are
            # terminal at the router, shedding here regardless of depth
            # would hard-fail that class cluster-wide on an IDLE
            # cluster. Below the watermark capacity is not contested:
            # admit, and the executor's deadline truncation cuts any
            # genuinely doomed query off mid-flight for pennies.
            if depth >= self.low and budget_ms is not None and \
                    est is not None and \
                    budget_ms < est * self.DEADLINE_MARGIN:
                return self._shed("deadline", 0.0)
            if depth >= self.max_pending:
                return self._shed(
                    "capacity", self._drain_estimate_ms(depth, est))
            if hedge and depth >= self.low and not batch_join:
                return self._shed("hedge", 0.0)
            if depth >= self.mid and len(self._by_tenant) >= 2:
                # the fair-share gate protects OTHER tenants: with one
                # (or zero) active it would shed EVERYTHING at the mid
                # watermark — fair == depth == the tenant's own count —
                # and the brownout/capacity tiers could never engage
                active = len(self._by_tenant)
                fair = max(self.MIN_TENANT_SHARE, depth // active)
                if self._by_tenant.get(tenant, 0) >= fair:
                    return self._shed(
                        "tenantOverQuota",
                        self._drain_estimate_ms(
                            self._by_tenant.get(tenant, 0), est))
            brownout = depth >= self.high or backlogged
            self._depth = depth + 1
            self._by_tenant[tenant] = self._by_tenant.get(tenant, 0) + 1
        deadline_s = None
        if brownout:
            cap_ms = max(est if est is not None else 0.0,
                         self.BROWNOUT_FLOOR_MS) * self.BROWNOUT_FACTOR
            if budget_ms is not None:
                cap_ms = min(cap_ms, budget_ms)
            deadline_s = now + cap_ms / 1e3
            self.metrics.meter(ServerMeter.BROWNOUT_QUERIES).mark()
        return AdmissionDecision(True, brownout=brownout,
                                 deadline_s=deadline_s)


def busy_datatable(request_id: int, cause: str,
                   retry_after_ms: float) -> DataTable:
    """The typed server-busy reply for a shed request."""
    dt = DataTable()
    dt.metadata["requestId"] = str(request_id)
    dt.metadata[SERVER_BUSY_KEY] = cause
    dt.metadata[RETRY_AFTER_MS_KEY] = f"{retry_after_ms:.0f}"
    dt.exceptions.append(
        f"{SERVER_BUSY_EXC_PREFIX} request shed ({cause}); "
        f"retry elsewhere or after {retry_after_ms:.0f}ms")
    return dt
