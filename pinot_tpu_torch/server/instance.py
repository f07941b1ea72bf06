"""Server process wiring: data manager + scheduler + executor + transport.

Counterpart of pinot_tpu/server/instance.py:58-816 (`ServerInstance`):
InstanceRequest bytes in over TCP (transport/tcp.py:QueryServer, one
coroutine per in-flight frame on its event-loop thread), the result
cache and single flight in front, admission control, then the scheduler
(FCFS by default, 4 workers) and, for plain single-stage queries, the
dispatch coalescer: same-shape queries that overlap within the batch
window (2 ms) run as one `execute_batch` in chunks of MAX_BATCH_CHUNK
= 8, the port's kernels.MAX_BATCH, so every kernel launches once per
segment for a chunk. Join and window stages take the exchange plane: a
stage-1 request with `publish_exchange` publishes its DataTable
(`_maybe_publish`) and a peer fetches it with an XCHG frame over the same
port. Segments sit on an HBM / host / disk ladder under the residency
manager's byte budget.

The instance runs on the card unless `device="cpu"` is passed: the
segments its data manager holds are bound to that device as queries
acquire them. Device work (launches, synchronizing pulls) happens on the
scheduler's workers, never on the event-loop thread, which only parses
frames, probes the cache and awaits futures.

Parity: pinot-server — ServerInstance/ServerBuilder (ServerInstance.java:43:
InstanceDataManager + QueryExecutor + QueryScheduler + NettyServer) and
ScheduledRequestHandler.java:40-66 (bytes → deserialize → schedule →
execute → DataTable bytes).
"""
from __future__ import annotations

import asyncio
import json
import os
import threading
import time
from concurrent.futures import Future
from typing import List, Optional, Tuple

from pinot_tpu_torch.common.datatable import (DataTable, RESULT_CACHE_HIT_KEY,
                                        amend_metadata_bytes)
from pinot_tpu_torch.common.metrics import (MetricsRegistry, ServerGauge,
                                      ServerMeter, ServerQueryPhase,
                                      ServerTimer)
from pinot_tpu_torch.common.request import InstanceRequest
from pinot_tpu_torch.common.serde import instance_request_from_bytes
from pinot_tpu_torch.ops.kernels import MAX_BATCH
from pinot_tpu_torch.server.admission import (AdmissionController,
                                        ServiceTimeEstimator,
                                        busy_datatable)
from pinot_tpu_torch.server.data_manager import InstanceDataManager
from pinot_tpu_torch.server.query_executor import InstanceQueryExecutor
from pinot_tpu_torch.server.result_cache import (ServerResultCache, SingleFlight,
                                           segment_cache_states)
from pinot_tpu_torch.server.scheduler import (BatchGroup, DispatchCoalescer,
                                        QueryScheduler,
                                        SchedulerOutOfCapacityError,
                                        make_scheduler)
from pinot_tpu_torch.transport.tcp import EventLoopThread, QueryServer

#: batching admission window (ms) when neither the constructor nor
#: PINOT_TPU_BATCH_WINDOW_MS says otherwise; 0 disables coalescing
#: entirely (bit-exact pre-coalescer behavior)
DEFAULT_BATCH_WINDOW_MS = 2.0


class _BatchTicket:
    """One coalescer member: the request plus the future its caller is
    already awaiting; resolved by the group runner (or the abandon
    callback) exactly once."""

    __slots__ = ("request", "deser_ms", "future", "t_arrive")

    def __init__(self, request: InstanceRequest, deser_ms: float):
        self.request = request
        self.deser_ms = deser_ms
        self.future: Future = Future()
        self.t_arrive = time.perf_counter()


class ServerInstance:
    """One query server: hosts segments, answers InstanceRequests."""

    def __init__(self, instance_id: str = "server_0",
                 scheduler: str = "fcfs", num_workers: int = 4,
                 mesh=None, use_device: bool = True,
                 max_pending: Optional[int] = None,
                 result_cache_entries: int = 256,
                 device_bytes_budget: Optional[int] = None,
                 batch_window_ms: Optional[float] = None,
                 device=None,
                 promotion_backlog_watermark: Optional[int] = None):
        """The JAX constructor's arguments, `device`: where the lanes
        live and the kernels run (None: the card; "cpu": the kernels'
        plain versions), and `promotion_backlog_watermark`, admission's
        brownout watermark (AdmissionController; None: its default).
        `mesh` (parallel.make_mesh() on that device) stacks
        multi-segment queries."""
        self.instance_id = instance_id
        self.metrics = MetricsRegistry("server")
        from pinot_tpu_torch.obs import residency
        residency.bind_registry(self.metrics)
        self.data_manager = InstanceDataManager()
        # tiered residency: this instance's segments demote HBM → host
        # → disk under the device byte budget (config `deviceBytesBudget`
        # or env PINOT_TPU_DEVICE_BYTES_BUDGET; unset = unbounded, the
        # pre-manager behavior). Per-instance manager: its entries and
        # hooks die with the instance, while admission reads the
        # PROCESS-global ledger so colocated instances see real pressure.
        from pinot_tpu_torch.server.residency_manager import (
            ResidencyManager, budget_from_env, host_budget_from_env)
        self.residency = ResidencyManager(
            device_bytes_budget if device_bytes_budget is not None
            else budget_from_env(), host_budget_from_env())
        self.residency.bind_metrics(self.metrics)
        self.data_manager.add_removal_listener(self.residency.untrack)
        self.scheduler: QueryScheduler = make_scheduler(scheduler,
                                                        num_workers)
        self.executor = InstanceQueryExecutor(
            self.data_manager, mesh=mesh, use_device=use_device,
            metrics=self.metrics,
            segment_executor=self.scheduler.segment_pool,
            residency=self.residency, device=device)
        if self.executor.sharded is not None:
            # a demoted segment's stacked twin must drop with it, and
            # the (rebuildable) stack caches are the cheapest HBM to
            # reclaim under pressure
            self.residency.add_release_hook(
                self.executor.sharded.evict_segment)
            self.residency.add_pressure_hook(
                self.executor.sharded.evict_all)
        self.residency.add_pressure_hook(self._release_mutable_snapshots)
        # admission control + CRC-exact result cache (hits bypass the
        # admission queue — the degradation valve under overload)
        self.estimator = ServiceTimeEstimator(self.metrics)
        self.admission = AdmissionController(
            metrics=self.metrics, estimator=self.estimator,
            max_pending=max_pending if max_pending is not None
            else max(16, 16 * num_workers),
            num_workers=num_workers,
            backlog_fn=self.residency.promotion_backlog,
            promotion_backlog_watermark=promotion_backlog_watermark)
        self.result_cache = ServerResultCache(
            max_entries=result_cache_entries)
        # cold-cache dedup for IDENTICAL concurrent queries: the first
        # executes, the rest await its cache entry (bounded) — the
        # degenerate batch the coalescer never needs to see
        self.single_flight = SingleFlight()
        # cross-query dispatch coalescing: same-plan-shape queries that
        # overlap in flight share one (batched) kernel execution after
        # a short admission window (config `batchWindowMs` /
        # PINOT_TPU_BATCH_WINDOW_MS; <= 0 disables, restoring the
        # strictly per-query dispatch path)
        if batch_window_ms is None:
            batch_window_ms = float(os.environ.get(
                "PINOT_TPU_BATCH_WINDOW_MS", DEFAULT_BATCH_WINDOW_MS))
        self.batch_window_ms = float(batch_window_ms)
        self.coalescer: Optional[DispatchCoalescer] = None
        if self.batch_window_ms > 0:
            self.coalescer = DispatchCoalescer(
                self.batch_window_ms / 1e3,
                on_dispatch=self._on_batch_dispatch,
                on_bypass=self._on_batch_bypass)
        # exist at 0 from boot so dashboards see the series immediately
        self.metrics.meter(ServerMeter.BATCHED_DISPATCHES)
        self.metrics.meter(ServerMeter.BATCH_BYPASS)
        self.metrics.meter(ServerMeter.SINGLE_FLIGHT_WAITS)
        self.metrics.timer(ServerTimer.BATCH_OCCUPANCY)
        # exchange plane (multi-stage queries): published stage-1 blocks
        # served to peer servers over XCHG data-plane frames
        from pinot_tpu_torch.query.stages.exchange import ExchangeManager
        self.exchange = ExchangeManager()
        # accepted workload tags (scheduler groups + fair-share keys
        # derive from them) — bounded, because the tag is CLIENT-chosen
        self._tenant_tags: set = set()
        # a replaced/removed segment can change results WITHOUT a CRC
        # change (segment reload re-processes the same artifact against
        # an evolved schema) — any swap clears the cache; swaps are
        # rare (reload, rebalance) so the coarse clear is cheap
        self.data_manager.add_removal_listener(
            lambda _name: self.result_cache.clear())
        self.metrics.gauge(ServerGauge.SEGMENT_COUNT).set_callable(
            self.data_manager.num_segments)
        self.metrics.meter(ServerMeter.QUERIES)   # exists at 0 from boot
        self._loop: Optional[EventLoopThread] = None
        self._server: Optional[QueryServer] = None
        self.port: Optional[int] = None
        # guards the start/stop lifecycle fields (_loop/_server/port):
        # an admin-triggered stop can race a late start on another thread
        self._lifecycle_lock = threading.Lock()

    def _release_mutable_snapshots(self) -> None:
        """Residency pressure hook: drop consuming segments' frozen
        device snapshots (rebuildable caches — in-flight queries keep
        their references; GC releases the lanes)."""
        for table in self.data_manager.table_names():
            tdm = self.data_manager.table(table)
            if tdm is None:
                continue
            sdms, _ = tdm.acquire_segments()
            try:
                for sdm in sdms:
                    release = getattr(sdm.segment,
                                      "release_device_snapshot", None)
                    if release is not None:
                        release()
            finally:
                for sdm in sdms:
                    tdm.release_segment(sdm)

    # -- request path ------------------------------------------------------
    def _deserialize(self, payload: bytes
                     ) -> Tuple[Optional[InstanceRequest], Optional[bytes],
                                float]:
        """(request, None, ms) on success, (None, error reply bytes, ms)
        on a malformed wire payload. The measured milliseconds become
        the query's requestDeserialization span."""
        t0 = time.perf_counter()
        try:
            request = instance_request_from_bytes(payload)
            err = None
        except Exception as e:  # noqa: BLE001 — malformed wire payload
            dt = DataTable()
            dt.exceptions.append(f"RequestDeserializationError: {e}")
            request, err = None, dt.to_bytes()
        ms = (time.perf_counter() - t0) * 1e3
        self.metrics.timer(
            ServerQueryPhase.REQUEST_DESERIALIZATION).update(ms)
        self.metrics.meter(ServerMeter.REQUEST_BYTES).mark(len(payload))
        return request, err, ms

    # scheduler groups and admission fair-share counters are permanent
    # once created, and the workload tag that keys them is CLIENT-chosen
    # — past this many distinct tags, new ones fall back to the
    # (config-bounded) per-table group instead of growing the maps and
    # the scheduler's per-pick scan without bound
    MAX_TENANT_TAGS = 256

    def _tenant(self, request: InstanceRequest) -> str:
        """Scheduler group / fair-share key: the broker-stamped tenant
        tag, or the table for untagged traffic (per-table isolation is
        the old behavior and the sensible default). Tags are namespaced
        (``w:``) so OPTION(workload=<table name>) can never join the
        untagged traffic's per-table group.

        Lookup only: a fresh tag's permanent slot is committed by
        ``_register_tenant`` once the request is actually ADMITTED —
        a flood of unique tags that all get shed must not burn the
        tag budget and lock later tenants out of isolation."""
        tag = request.workload
        if not tag:
            return request.query.table_name
        if tag not in self._tenant_tags and \
                len(self._tenant_tags) >= self.MAX_TENANT_TAGS:
            return request.query.table_name
        return f"w:{tag}"

    def _register_tenant(self, tenant: str) -> None:
        """Commit an admitted request's tag slot (no-op for the
        per-table fallback). set.add is atomic under the GIL; a racing
        duplicate add is idempotent and a transient cap overshoot in
        the admit window is harmless."""
        if tenant.startswith("w:"):
            self._tenant_tags.add(tenant[2:])

    # -- result cache -------------------------------------------------------
    def _cache_lookup(self, request: InstanceRequest):
        """→ (fingerprint, cached reply bytes or None, generation,
        full cache key or None). A hit is served WITHOUT touching the
        admission queue or the scheduler. The generation is captured
        BEFORE execution so a segment swap's clear() while the query
        runs invalidates its eventual store instead of racing it. The
        key comes back even on a miss — including the cold (empty)
        cache — because it doubles as the single-flight dedup key; a
        None key means the request is uncacheable (traced, mutable /
        CRC-less segments, missing segments)."""
        gen = self.result_cache.generation
        if request.enable_trace:
            return None, None, gen, None  # traced queries want real spans
        tdm = self.data_manager.table(request.query.table_name)
        if tdm is None:
            return None, None, gen, None
        acquired, missing = tdm.acquire_segments(request.search_segments)
        try:
            if missing:
                return None, None, gen, None
            states = segment_cache_states([s.segment for s in acquired])
        finally:
            for sdm in acquired:
                tdm.release_segment(sdm)
        if states is None:
            # mutable / CRC-less segment in the set
            return None, None, gen, None
        from pinot_tpu_torch.query.fingerprint import query_fingerprint
        fp = query_fingerprint(request.query)
        key = ServerResultCache.key(request.query.table_name, fp, states)
        if len(self.result_cache) == 0:
            # empty-cache fast path: skip the entry probe (the states /
            # fingerprint above still feed the single-flight key)
            self.metrics.meter(ServerMeter.RESULT_CACHE_MISSES).mark()
            return fp, None, gen, key
        payload = self.result_cache.get(key)
        if payload is None:
            self.metrics.meter(ServerMeter.RESULT_CACHE_MISSES).mark()
            return fp, None, gen, key
        self.metrics.meter(ServerMeter.RESULT_CACHE_HITS).mark()
        # splice ONLY the metadata map (fresh bytes per hit, rows
        # byte-identical to the original run): a full serde round-trip
        # just to stamp two keys would burn the CPU the cache exists
        # to save under overload
        reply = amend_metadata_bytes(payload, {
            "requestId": str(request.request_id),
            RESULT_CACHE_HIT_KEY: "1"})
        return fp, reply, gen, key

    def _single_flight_follow(self, request: InstanceRequest,
                              ckey: tuple, ev) -> Optional[bytes]:
        """A leader is executing this exact query: wait (bounded) on
        its event, then re-probe the cache. None → fall through to own
        execution (leader failed / skipped the store / wait expired) —
        correctness never depends on the leader."""
        self.metrics.meter(ServerMeter.SINGLE_FLIGHT_WAITS).mark()
        timeout_s = 1.0
        if request.deadline_budget_ms is not None:
            # never burn more than half the remaining budget waiting
            timeout_s = min(timeout_s,
                            max(0.0, request.deadline_budget_ms / 2e3))
        ev.wait(timeout_s)
        payload = self.result_cache.get(ckey)
        if payload is None:
            return None
        self.metrics.meter(ServerMeter.RESULT_CACHE_HITS).mark()
        return amend_metadata_bytes(payload, {
            "requestId": str(request.request_id),
            RESULT_CACHE_HIT_KEY: "1"})

    def _maybe_cache_store(self, request: InstanceRequest,
                           dt: DataTable, payload: bytes,
                           fingerprint: Optional[str],
                           gen: Optional[int] = None) -> None:
        """Store a fully-successful answer keyed on the EXECUTION-time
        segment states (probe-time states could race a segment swap)."""
        if request.enable_trace or dt.exceptions:
            return
        states = getattr(dt, "cache_states", None)
        if not states:
            return
        if fingerprint is None:
            # the probe was skipped (empty-cache fast path); the
            # execution-time states above already proved cacheability
            from pinot_tpu_torch.query.fingerprint import query_fingerprint
            fingerprint = query_fingerprint(request.query)
        self.result_cache.put(
            ServerResultCache.key(request.query.table_name, fingerprint,
                                  states), payload, gen=gen)

    # -- admission ----------------------------------------------------------
    def _admit(self, request: InstanceRequest):
        """→ (decision, busy reply bytes or None, tenant key). The key
        is computed ONCE here and threaded through scheduling and
        release so the depth accounting debits and credits the same
        counter by construction."""
        tenant = self._tenant(request)
        # a hedged duplicate whose plan shape already has an OPEN batch
        # window here rides the primary's dispatch for (almost) free —
        # shedding it at the low watermark would waste a slot for zero
        # information (hedges are rare, so the extra key hash is cheap)
        batch_join = False
        if request.hedge and self.coalescer is not None and \
                self._batchable(request):
            batch_join = self.coalescer.joinable(self._batch_key(request))
        decision = self.admission.admit(
            request.query.table_name, tenant,
            budget_ms=request.deadline_budget_ms, hedge=request.hedge,
            batch_join=batch_join)
        if not decision:
            return decision, busy_datatable(
                request.request_id, decision.cause,
                decision.retry_after_ms).to_bytes(), tenant
        self._register_tenant(tenant)
        return decision, None, tenant

    # -- dispatch coalescing ------------------------------------------------
    def _batchable(self, request: InstanceRequest) -> bool:
        """Coalescer eligibility: plain single-stage queries only —
        staged requests (join/window/exchange) have per-request side
        channels, and traced queries want their own real spans."""
        return self.coalescer is not None and \
            not request.enable_trace and not self._stage_request(request)

    def _batch_key(self, request: InstanceRequest) -> tuple:
        """Queries coalesce iff they agree on table, plan shape, and
        the segment set the broker routed here."""
        from pinot_tpu_torch.query.fingerprint import plan_shape_key
        shape, _lits = plan_shape_key(request.query)
        return (request.query.table_name, shape,
                tuple(sorted(request.search_segments or ())))

    def _on_batch_dispatch(self, occupancy: int) -> None:
        # every sealed window lands in the occupancy distribution;
        # batchedDispatches counts only executions that served >1 query
        self.metrics.timer(ServerTimer.BATCH_OCCUPANCY).update(
            float(occupancy))
        if occupancy > 1:
            self.metrics.meter(ServerMeter.BATCHED_DISPATCHES).mark()

    def _on_batch_bypass(self) -> None:
        self.metrics.meter(ServerMeter.BATCH_BYPASS).mark()

    @staticmethod
    def _resolve_ticket(ticket: _BatchTicket, dt: Optional[DataTable],
                        exc: Optional[BaseException]) -> None:
        try:
            if exc is not None:
                ticket.future.set_exception(exc)
            else:
                ticket.future.set_result(dt)
        except Exception:  # noqa: BLE001 — already cancelled/resolved
            pass

    #: per-dispatch member cap: groups past this run as consecutive
    #: chunks of at most the batched kernels' member count
    #: (ops/kernels.py:MAX_BATCH), so a larger group is split here and
    #: never reaches a launch whole
    MAX_BATCH_CHUNK = MAX_BATCH

    def _run_batch(self, members: List[_BatchTicket],
                   deadline_s: Optional[float]) -> None:
        """Execute a sealed group and fan results back to every
        member's future (one-member groups take the ordinary execute
        path — same code the solo/bypass states run)."""
        for i in range(0, len(members), self.MAX_BATCH_CHUNK):
            self._run_batch_chunk(members[i:i + self.MAX_BATCH_CHUNK],
                                  deadline_s)

    def _run_batch_chunk(self, members: List[_BatchTicket],
                         deadline_s: Optional[float]) -> None:
        waits = [(time.perf_counter() - m.t_arrive) * 1e3
                 for m in members]
        try:
            if len(members) == 1:
                m = members[0]
                dt = self.executor.execute(
                    m.request, scheduler_wait_ms=waits[0],
                    deadline=deadline_s, deser_ms=m.deser_ms)
                dts = [dt]
            else:
                dts = self.executor.execute_batch(
                    [m.request for m in members], waits, deadline_s)
            for m, dt in zip(members, dts):
                self._resolve_ticket(m, dt, None)
        except BaseException as e:  # noqa: BLE001 — fan the failure out
            for m in members:
                self._resolve_ticket(m, None, e)

    def _abandon_group(self, gfut: Future, group: BatchGroup) -> None:
        """Done-callback on the group runner's scheduler future: if the
        runner never got to seal (queue rejection, deadline trim,
        shutdown), fail every member future so no caller hangs. After a
        NORMAL run the group is already sealed and this is a no-op."""
        if self.coalescer is None:
            return
        members = self.coalescer.seal(group)
        if not members:
            return
        try:
            exc: Optional[BaseException] = None
            try:
                exc = gfut.exception()
            except BaseException as e:  # noqa: BLE001 — cancelled
                exc = e
            if exc is None:
                exc = RuntimeError(
                    "batch group abandoned without executing")
            for m in members:
                self._resolve_ticket(m, None, exc)
        finally:
            self.coalescer.leave(group.key)

    def _coalesced_submit(self, request: InstanceRequest, deser_ms: float,
                          deadline: Optional[float],
                          budget_s: Optional[float],
                          tenant: str) -> Future:
        """Route an eligible query through the dispatch coalescer;
        returns the future its caller awaits (a scheduler future for
        solo/bypass, the member ticket's future for joined/lead)."""
        key = self._batch_key(request)
        ticket = _BatchTicket(request, deser_ms)
        state, group = self.coalescer.arrive(key, ticket, deadline)
        if state in ("solo", "bypass"):
            t_submit = time.perf_counter()

            def run():
                wait_ms = (time.perf_counter() - t_submit) * 1e3
                return self.executor.execute(
                    request, scheduler_wait_ms=wait_ms,
                    deadline=deadline, deser_ms=deser_ms)

            fut = self.scheduler.submit(tenant, run, deadline_s=budget_s)
            fut.add_done_callback(
                lambda _f, k=key: self.coalescer.leave(k))
            return fut
        if state == "joined":
            return ticket.future

        # lead: schedule the window runner under the leader's tenant.
        # It sleeps out the window, seals, and executes the batch under
        # the group deadline (the TIGHTEST member deadline at seal).
        def run_group():
            delay = self.coalescer.remaining_window_s(group)
            if delay > 0:
                time.sleep(delay)
            members = self.coalescer.seal(group)
            if not members:      # abandon callback won the seal race
                return None
            try:
                self._run_batch(members, group.deadline_s)
            finally:
                self.coalescer.leave(key)
            return None

        gfut = self.scheduler.submit(tenant, run_group,
                                     deadline_s=budget_s)
        gfut.add_done_callback(
            lambda f, g=group: self._abandon_group(f, g))
        return ticket.future

    def _schedule(self, request: InstanceRequest, deser_ms: float = 0.0,
                  admission_deadline_s: Optional[float] = None,
                  release_admission: bool = False,
                  tenant: Optional[str] = None):
        """Submit to the scheduler; returns the result Future.

        Broker deadline propagation: the budget is fixed to an absolute
        instant NOW (deserialization time), so queue wait counts against
        it and expired work is dropped, not computed. Under brownout the
        admission controller hands down a TIGHTER absolute deadline so
        execution truncates to a flagged-partial result.
        """
        deadline = None
        budget_s = None
        if request.deadline_budget_ms is not None:
            budget_s = request.deadline_budget_ms / 1e3
            deadline = time.monotonic() + budget_s
        if admission_deadline_s is not None:
            deadline = admission_deadline_s if deadline is None \
                else min(deadline, admission_deadline_s)
            budget_s = max(0.0, deadline - time.monotonic())
        # per-TENANT scheduler group: the token hierarchy isolates CPU
        # between tenants instead of pooling everything per table
        if tenant is None:
            tenant = self._tenant(request)
        if self._batchable(request):
            fut = self._coalesced_submit(request, deser_ms, deadline,
                                         budget_s, tenant)
        else:
            t_submit = time.perf_counter()

            def run():
                wait_ms = (time.perf_counter() - t_submit) * 1e3
                return self.executor.execute(request,
                                             scheduler_wait_ms=wait_ms,
                                             deadline=deadline,
                                             deser_ms=deser_ms)

            fut = self.scheduler.submit(tenant, run, deadline_s=budget_s)
        if release_admission:
            # pairs with the admit() in the request path; a failed
            # future (e.g. OutOfCapacity) completes immediately, so the
            # depth can never leak. Each batch member carries its OWN
            # future, so every member credits its own tenant here.
            fut.add_done_callback(
                lambda _f, t=tenant: self.admission.release(t))
        return fut

    def _serialize(self, request: InstanceRequest, dt: DataTable) -> bytes:
        with self.metrics.timer(
                ServerQueryPhase.RESPONSE_SERIALIZATION).time():
            t0 = time.perf_counter()
            payload = dt.to_bytes()
            ser_ms = (time.perf_counter() - t0) * 1e3
        self.metrics.meter(ServerMeter.RESPONSE_BYTES).mark(len(payload))
        if request.enable_trace and "traceInfo" in dt.metadata:
            # the serde span cannot ride inside the bytes it measures:
            # amend the trace and re-serialize (trace=true only — the
            # untraced path pays a single to_bytes)
            try:
                info = json.loads(dt.metadata["traceInfo"])
            except ValueError:
                return payload
            root = info.get("rootSpanId") if isinstance(info, dict) else None
            if root is not None:
                info["spans"].append({
                    "name": ServerQueryPhase.RESPONSE_SERIALIZATION,
                    "ms": round(ser_ms, 3), "spanId": f"{root}.serde",
                    "parentId": root})
                dt.metadata["traceInfo"] = json.dumps(info)
                payload = dt.to_bytes()
        return payload

    def _capacity_reply(self, request: InstanceRequest) -> bytes:
        """The scheduler's bounded queue rejected the query: same typed
        server-busy surface as an admission shed."""
        self.metrics.meter(ServerMeter.REQUESTS_SHED).mark()
        self.metrics.meter(ServerMeter.REQUESTS_SHED,
                           table="capacity").mark()
        return busy_datatable(request.request_id, "capacity",
                              0.0).to_bytes()

    def _error_reply(self, request: InstanceRequest, e: Exception) -> bytes:
        self.metrics.meter(ServerMeter.QUERY_EXECUTION_EXCEPTIONS).mark()
        dt = DataTable()
        dt.metadata["requestId"] = str(request.request_id)
        dt.exceptions.append(f"QueryExecutionError: {e}")
        return dt.to_bytes()

    # -- multi-stage plumbing ----------------------------------------------
    @staticmethod
    def _stage_request(request: InstanceRequest) -> bool:
        """Multi-stage requests bypass the result cache both ways: the
        fingerprint keys on ONE table's segment states, but a join/
        window answer also depends on the dim/exchanged side (satellite:
        a join result cached under the fact table would survive
        dim-table changes)."""
        return (request.publish_exchange is not None or
                request.exchange_sources is not None or
                request.query.join is not None or
                bool(request.query.windows))

    def _maybe_publish(self, request: InstanceRequest, dt: DataTable,
                       payload: bytes) -> bytes:
        """Stage-1 producer epilogue: store the full serialized result
        in the exchange, answer with a small ack (or a typed stage
        error when the scan was truncated by the selection cap)."""
        from pinot_tpu_torch.query.stages.errors import (ExchangeError,
                                                   stage_error_datatable)
        info = request.publish_exchange
        xid = str(info.get("id", ""))
        if dt.exceptions:
            return payload          # surface the scan failure verbatim
        rows = dt.num_rows()
        matched = int(dt.metadata.get("numDocsScanned", "0"))
        if matched > rows:
            return stage_error_datatable(
                request.request_id, "exchangeCapacity",
                f"stage-1 scan matched {matched} rows but the exchange "
                f"window holds {rows} — narrow the stage's filter"
            ).to_bytes()
        try:
            # lifetime tracks the query: the block only matters until
            # stage 2's deadline passes (+slack for clock skew/retries)
            ttl = None
            if request.deadline_budget_ms is not None:
                ttl = request.deadline_budget_ms / 1e3 + 15.0
            self.exchange.put(xid, payload, ttl_s=ttl)
        except ExchangeError as e:
            return stage_error_datatable(
                request.request_id, "exchangeCapacity",
                str(e)).to_bytes()
        ack = DataTable()
        ack.metadata["requestId"] = str(request.request_id)
        ack.metadata["exchangeId"] = xid
        ack.metadata["exchangeKey"] = self.exchange.xkey
        ack.metadata["exchangeRows"] = str(rows)
        ack.metadata["numDocsScanned"] = dt.metadata.get(
            "numDocsScanned", "0")
        key_col = info.get("keyColumn")
        if key_col:
            tags = self._partition_tags(request, str(key_col))
            if tags is not None:
                fn, n, pids = tags
                import json as _json
                ack.metadata["partitionFunction"] = fn
                ack.metadata["numPartitions"] = str(n)
                ack.metadata["exchangePartitions"] = _json.dumps(
                    sorted(pids))
        return ack.to_bytes()

    def _partition_tags(self, request: InstanceRequest, key_col: str):
        """Partition metadata of the published block's key column across
        the scanned segments (None unless consistently tagged) — the
        co-partitioned dispatch contract (stages/join.py)."""
        from pinot_tpu_torch.query.stages.join import fact_partition_info
        tdm = self.data_manager.table(request.query.table_name)
        if tdm is None:
            return None
        acquired, missing = tdm.acquire_segments(request.search_segments)
        try:
            if missing:
                return None
            return fact_partition_info(
                [s.segment for s in acquired], key_col)
        finally:
            for sdm in acquired:
                tdm.release_segment(sdm)

    # -- in-process path (used by tests and the embedded broker) -----------
    def handle_request_bytes(self, payload: bytes) -> bytes:
        from pinot_tpu_torch.query.stages import exchange as _exchange
        if _exchange.is_exchange_frame(payload):
            # peer-server exchange fetch: a memory lookup, answered
            # inline (never scheduled — stage-2 executors are blocked
            # on it, and admission would deadlock colocated stages)
            return self.exchange.handle_frame(payload)
        request, err, deser_ms = self._deserialize(payload)
        if err is not None:
            return err
        staged = self._stage_request(request)
        if staged:
            fingerprint, cached, gen, ckey = None, None, None, None
        else:
            fingerprint, cached, gen, ckey = self._cache_lookup(request)
        if cached is not None:
            return cached          # bypasses admission AND scheduling
        leader_key = None
        if ckey is not None:
            # single-flight: identical concurrent queries on a cold
            # entry — the first becomes leader, the rest await its
            # store (bounded) and re-probe, falling through on failure
            is_leader, ev = self.single_flight.begin(ckey)
            if is_leader:
                leader_key = ckey
            else:
                reply = self._single_flight_follow(request, ckey, ev)
                if reply is not None:
                    return reply
        try:
            decision, busy, tenant = self._admit(request)
            if busy is not None:
                return busy
            try:
                dt = self._schedule(
                    request, deser_ms,
                    admission_deadline_s=decision.deadline_s,
                    release_admission=True,
                    tenant=tenant).result()
                reply = self._serialize(request, dt)
                if request.publish_exchange is not None:
                    return self._maybe_publish(request, dt, reply)
                if not staged:
                    self._maybe_cache_store(request, dt, reply,
                                            fingerprint, gen)
                return reply
            except SchedulerOutOfCapacityError:
                return self._capacity_reply(request)
            except Exception as e:  # noqa: BLE001 — execution/serde error
                return self._error_reply(request, e)
        finally:
            if leader_key is not None:
                self.single_flight.done(leader_key)

    # -- network path (one coroutine per in-flight frame) ------------------
    async def handle_request_async(self, payload: bytes) -> bytes:
        """The multiplexed QueryServer's handler: dispatches to the
        scheduler and awaits the result WITHOUT pinning a thread per
        in-flight request — only scheduler workers compute; serde runs
        on the executor so the event loop keeps draining frames."""
        loop = asyncio.get_running_loop()
        from pinot_tpu_torch.query.stages import exchange as _exchange
        if _exchange.is_exchange_frame(payload):
            # peer-server exchange fetch: a memory lookup, answered
            # inline off the read loop's dispatch task
            return self.exchange.handle_frame(payload)
        request, err, deser_ms = self._deserialize(payload)
        if err is not None:
            return err
        staged = self._stage_request(request)
        # the cache probe touches segment refcounts and hashes the
        # request — off-loop, like the serde it replaces on a hit. But
        # when the probe is a guaranteed no-op (traced query or stage
        # request) the cheap guards run inline: no per-query threadpool
        # hop just to bounce off _cache_lookup's early returns
        if staged:
            fingerprint, cached, gen, ckey = None, None, None, None
        elif request.enable_trace:
            fingerprint, cached, gen, ckey = self._cache_lookup(request)
        else:
            fingerprint, cached, gen, ckey = await loop.run_in_executor(
                None, self._cache_lookup, request)
        if cached is not None:
            return cached          # bypasses admission AND scheduling
        leader_key = None
        if ckey is not None:
            is_leader, ev = self.single_flight.begin(ckey)
            if is_leader:
                leader_key = ckey
            else:
                # the bounded wait blocks — off-loop like the probe
                reply = await loop.run_in_executor(
                    None, self._single_flight_follow, request, ckey, ev)
                if reply is not None:
                    return reply
        try:
            decision, busy, tenant = self._admit(request)
            if busy is not None:
                return busy
            try:
                dt = await asyncio.wrap_future(self._schedule(
                    request, deser_ms,
                    admission_deadline_s=decision.deadline_s,
                    release_admission=True, tenant=tenant))
                if dt.num_rows() <= 128:
                    # small replies (aggregations, trimmed group-bys)
                    # serialize faster than an executor hop costs
                    reply = self._serialize(request, dt)
                else:
                    reply = await loop.run_in_executor(
                        None, self._serialize, request, dt)
                if request.publish_exchange is not None:
                    return self._maybe_publish(request, dt, reply)
                if not staged:
                    self._maybe_cache_store(request, dt, reply,
                                            fingerprint, gen)
                return reply
            except asyncio.CancelledError:
                raise
            except SchedulerOutOfCapacityError:
                return self._capacity_reply(request)
            except Exception as e:  # noqa: BLE001 — execution/serde error
                return self._error_reply(request, e)
        finally:
            if leader_key is not None:
                self.single_flight.done(leader_key)

    # -- network service ---------------------------------------------------
    def start(self, host: str = "127.0.0.1", port: int = 0) -> int:
        """Start the TCP query service; returns the bound port."""
        with self._lifecycle_lock:
            self._loop = EventLoopThread()
            self._server = QueryServer(
                host, port, self.handle_request_bytes,
                async_handler=self.handle_request_async)
            self._loop.run(self._server.start())
            self.port = self._server.port
            return self.port

    def stop(self) -> None:
        with self._lifecycle_lock:
            if self._server is not None and self._loop is not None:
                self._loop.run(self._server.stop())
            if self._loop is not None:
                self._loop.stop()
                self._loop = None
        self.scheduler.shutdown()
        self.data_manager.shutdown()
        self.exchange.close()
        self.residency.shutdown()
