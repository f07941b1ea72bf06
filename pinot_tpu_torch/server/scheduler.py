"""Query schedulers: FCFS, bounded FCFS, and token-bucket priority.

Parity: pinot-core/.../core/query/scheduler/ — QuerySchedulerFactory
(algorithms "fcfs" | "bounded_fcfs" | "tokenbucket",
QuerySchedulerFactory.java:40-68). The token path is the full hierarchy:

- TokenSchedulerGroup (tokenbucket/TokenSchedulerGroup.java:31-56): per-group
  CPU-ms token accounting. Tokens drain at (elapsed_ms x threads_in_use); a
  new batch is allotted every token lifetime quantum with LINEAR DECAY
  (alpha = 0.80) so heavy users of the previous quantum start the next one
  penalized, giving sparse/low-qps groups a fair chance.
- MultiLevelPriorityQueue (MultiLevelPriorityQueue.java:38): per-group
  waitlists; the winner is the group with the most tokens (ties: earliest
  waiting query), moderated by the resource manager's soft thread limit —
  a higher-priority group already past the soft limit loses to one under
  it. Per-group capacity check on put() (OutOfCapacity), expired-query
  trimming against the query deadline.
- PriorityScheduler (PriorityScheduler.java): a dedicated scheduler thread
  gated by a running-queries semaphore takes the winner and hands it to a
  BoundedAccountingExecutor-style wrapper that reserves the group's worker
  allotment, increments threads-in-use around execution (the accounting
  the token drain reads), and releases the reservation when the query
  finishes (resources/BoundedAccountingExecutor.java:30-118).

Execution happens on a thread pool; the device serializes kernels anyway,
so scheduling decides ORDER and fairness, exactly the role it plays in the
reference.

Copy of pinot_tpu/server/scheduler.py (JAX-free): the schedulers with
their `segment_pool`, `make_scheduler`, and the dispatch coalescer
(`BatchGroup`, `DispatchCoalescer`) whose sealed batches
ServerQueryExecutor.execute_batch runs with one launch per kernel. The
port's server instance (server/instance.py) drives them.
"""
from __future__ import annotations

import heapq
import threading
import time
from collections import deque
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Callable, Dict, List, Optional


class QueryScheduler:
    """submit(group, fn) -> Future; subclasses order execution.

    `deadline_s` is the query's remaining budget (broker deadline
    propagation): schedulers that queue work drop entries whose budget
    expired before a worker picked them up — computing an answer nobody
    will read only steals tokens from live queries.

    Two pools, reference parity: query RUNNERS (`_pool`, one thread per
    admitted query — pqr threads) and query WORKERS (`segment_pool`,
    the per-segment plan executor CombineOperator fans out on — pqw
    threads). They must be distinct: a runner blocks on its segment
    futures, so per-segment work scheduled back onto the runner pool
    would deadlock once every runner waits on work none can start.
    """

    def __init__(self, num_workers: int = 4,
                 num_segment_workers: Optional[int] = None):
        self._pool = ThreadPoolExecutor(max_workers=num_workers,
                                        thread_name_prefix="query-runner")
        self.num_workers = num_workers
        self.num_segment_workers = num_segment_workers or num_workers
        self.segment_pool = ThreadPoolExecutor(
            max_workers=self.num_segment_workers,
            thread_name_prefix="query-worker")

    def submit(self, group: str, fn: Callable[[], object],
               deadline_s: Optional[float] = None) -> Future:
        raise NotImplementedError

    def shutdown(self) -> None:
        self._pool.shutdown(wait=False)
        self.segment_pool.shutdown(wait=False)


class FCFSQueryScheduler(QueryScheduler):
    """First-come-first-served (the reference default); unqueued, so
    deadline enforcement happens in the executor itself."""

    def submit(self, group: str, fn: Callable[[], object],
               deadline_s: Optional[float] = None) -> Future:
        return self._pool.submit(fn)


class SchedulerOutOfCapacityError(Exception):
    """Parity: OutOfCapacityException — bounded queue rejected the query."""


class SchedulerDeadlineError(Exception):
    """Query expired in the scheduler queue (trimExpired)."""


class ResourceLimitPolicy:
    """Per-group thread/queue bounds.

    Parity: core/query/scheduler/resources/ResourceLimitPolicy — soft and
    hard per-group thread limits as fractions of total workers, plus a
    pending-queue bound.
    """

    def __init__(self, num_workers: int,
                 max_threads_per_group_pct: float = 0.5,
                 soft_threads_per_group_pct: float = 0.3,
                 max_pending_per_group: int = 64):
        self.table_threads_hard_limit = max(
            1, int(num_workers * max_threads_per_group_pct))
        self.table_threads_soft_limit = max(
            1, int(num_workers * soft_threads_per_group_pct))
        self.max_pending_per_group = max_pending_per_group


class TokenSchedulerGroup:
    """Per-group token accounting with linear decay.

    Parity: tokenbucket/TokenSchedulerGroup.java:31-56. One token = 1ms of
    one thread's wall clock. Every group is over-provisioned with
    num_tokens_per_ms == total workers (work-stealing: an idle cluster
    always has schedulable tokens). Token replenishment happens lazily in
    consume_tokens(): drain by elapsed*threads within the current quantum,
    then per elapsed quantum apply

        tokens = ALPHA * lifetime * per_ms + (1-ALPHA) * (tokens - lifetime * threads)

    — the linear decay that remembers last-quantum utilization and
    penalizes heavy users so sparse groups win the next comparisons.
    """

    ALPHA = 0.80

    def __init__(self, name: str, num_tokens_per_ms: int,
                 token_lifetime_ms: int = 100,
                 clock: Callable[[], float] = time.monotonic):
        self.name = name
        self.num_tokens_per_ms = num_tokens_per_ms
        self.token_lifetime_ms = token_lifetime_ms
        self._clock = clock
        now = self._now_ms()
        self.available_tokens = float(num_tokens_per_ms * token_lifetime_ms)
        self._last_update_ms = now
        self._last_token_ms = now
        self.threads_in_use = 0
        self.reserved_threads = 0
        self.pending: deque = deque()   # SchedulerQueryContext entries
        self._lock = threading.Lock()

    def _now_ms(self) -> float:
        return self._clock() * 1e3

    def consume_tokens(self) -> float:
        """Lazy drain + quantum replay with linear decay."""
        with self._lock:
            now = self._now_ms()
            diff = now - self._last_update_ms
            if diff <= 0:
                return self.available_tokens
            threads = self.threads_in_use
            next_token = self._last_token_ms + self.token_lifetime_ms
            if next_token > now:
                self.available_tokens -= diff * threads
            else:
                self.available_tokens -= \
                    (next_token - self._last_update_ms) * threads
                # quantum catch-up in closed form: the per-quantum update
                # t' = A + B*(t - C) with A = ALPHA*L*N, B = 1-ALPHA,
                # C = L*threads is affine, so k quanta give
                # t_k = B^k * t0 + (A - B*C) * (1 - B^k) / (1 - B)
                # — O(1) however long the group idled (a naive replay
                # loop runs 864k iterations for a day-idle group, inside
                # the priority-queue lock). NOTE: the first replayed
                # quantum subtracts the full C even though its partial
                # in-quantum usage was already drained above — that IS
                # the reference's exact arithmetic
                # (TokenSchedulerGroup.consumeTokens: the decay loop
                # runs after the boundary drain and subtracts
                # tokenLifetimeMs*threads every iteration), kept for
                # behavioral parity
                k = int((now - next_token) // self.token_lifetime_ms) + 1
                a = self.ALPHA * self.token_lifetime_ms * \
                    self.num_tokens_per_ms
                b = 1 - self.ALPHA
                c = self.token_lifetime_ms * threads
                bk = b ** min(k, 1024)      # b^1024 == 0.0 in float64
                self.available_tokens = (
                    bk * self.available_tokens +
                    (a - b * c) * (1 - bk) / (1 - b))
                self._last_token_ms = next_token + \
                    (k - 1) * self.token_lifetime_ms
                self.available_tokens -= (now - self._last_token_ms) * threads
            self._last_update_ms = now
            return self.available_tokens

    # -- thread accounting (BoundedAccountingExecutor hooks) ---------------
    def increment_threads(self) -> None:
        self.consume_tokens()
        with self._lock:
            self.threads_in_use += 1

    def decrement_threads(self) -> None:
        self.consume_tokens()
        with self._lock:
            self.threads_in_use -= 1

    def add_reserved(self, n: int) -> None:
        with self._lock:
            self.reserved_threads += n

    def release_reserved(self, n: int) -> None:
        with self._lock:
            self.reserved_threads -= n

    def total_reserved_threads(self) -> int:
        return self.reserved_threads

    def compare_key(self):
        """Sort key: more tokens wins; ties go FCFS by arrival."""
        arrival = self.pending[0].arrival_ms if self.pending else float("inf")
        return (-self.consume_tokens(), arrival)

    def stats(self) -> dict:
        return {"name": self.name,
                "availableTokens": round(self.consume_tokens(), 1),
                "numPending": len(self.pending),
                "threadsInUse": self.threads_in_use,
                "reservedThreads": self.reserved_threads}


class SchedulerQueryContext:
    """One queued query (parity: SchedulerQueryContext.java)."""

    __slots__ = ("group", "fn", "future", "arrival_ms", "seq",
                 "deadline_ms")

    def __init__(self, group: str, fn: Callable[[], object], seq: int,
                 arrival_ms: float,
                 deadline_ms: Optional[float] = None):
        self.group = group
        self.fn = fn
        self.future: Future = Future()
        self.arrival_ms = arrival_ms
        self.seq = seq
        # absolute clock instant (ms) after which the query's broker
        # stops listening; None = only the scheduler-wide deadline
        self.deadline_ms = deadline_ms


class MultiLevelPriorityQueue:
    """Token-priority queue over per-group waitlists.

    Parity: MultiLevelPriorityQueue.java:38 — put() enforces per-group
    capacity; take_next() trims expired queries, then picks the group with
    the highest token priority subject to the soft-limit moderation:
    a winner past the soft thread limit yields to a contender under it.
    """

    def __init__(self, policy: ResourceLimitPolicy, num_workers: int,
                 token_lifetime_ms: int = 100,
                 query_deadline_s: float = 30.0,
                 clock: Callable[[], float] = time.monotonic):
        self.policy = policy
        self.num_workers = num_workers
        self.token_lifetime_ms = token_lifetime_ms
        self.query_deadline_s = query_deadline_s
        self._clock = clock
        self._groups: Dict[str, TokenSchedulerGroup] = {}  # tpulint: disable=cache-bound -- one group per table: bounded by tables hosted on this server
        self._lock = threading.Lock()
        self._not_empty = threading.Condition(self._lock)
        self._seq = 0

    def group(self, name: str) -> TokenSchedulerGroup:
        """Get-or-create a group (takes the lock; tpulint concurrency
        found the scheduler thread calling the unlocked variant —
        two threads racing the same name could each build and account
        against their own TokenSchedulerGroup)."""
        with self._lock:
            return self._group_locked(name)

    def _group_locked(self, name: str) -> TokenSchedulerGroup:
        g = self._groups.get(name)
        if g is None:
            g = TokenSchedulerGroup(name, self.num_workers,
                                    self.token_lifetime_ms, self._clock)
            self._groups[name] = g  # tpulint: disable=concurrency -- every caller holds self._lock (enforced by the public group())
        return g

    def put(self, group_name: str, fn: Callable[[], object],
            deadline_s: Optional[float] = None) -> SchedulerQueryContext:
        with self._lock:
            g = self._group_locked(group_name)
            if len(g.pending) >= self.policy.max_pending_per_group and \
                    g.total_reserved_threads() >= \
                    self.policy.table_threads_hard_limit:
                raise SchedulerOutOfCapacityError(
                    f"group {group_name} out of capacity: "
                    f"{len(g.pending)} pending >= "
                    f"{self.policy.max_pending_per_group}, "
                    f"{g.total_reserved_threads()} reserved >= "
                    f"{self.policy.table_threads_hard_limit}")
            now_ms = self._clock() * 1e3
            ctx = SchedulerQueryContext(
                group_name, fn, self._seq, now_ms,
                None if deadline_s is None else now_ms + deadline_s * 1e3)
            self._seq += 1
            g.pending.append(ctx)
            self._not_empty.notify()
            return ctx

    def remove(self, ctx: SchedulerQueryContext) -> bool:
        """Un-queue a context (closes the submit/shutdown race)."""
        with self._lock:
            g = self._groups.get(ctx.group)
            if g is not None and ctx in g.pending:
                g.pending.remove(ctx)
                return True
        return False

    def _trim_expired(self, g: TokenSchedulerGroup) -> None:
        now_ms = self._clock() * 1e3
        oldest_ok = now_ms - self.query_deadline_s * 1e3
        # scheduler-wide deadline: FIFO order makes the front oldest
        while g.pending and g.pending[0].arrival_ms < oldest_ok:
            ctx = g.pending.popleft()
            ctx.future.set_exception(SchedulerDeadlineError(
                f"query for group {g.name} expired after "
                f"{self.query_deadline_s}s in scheduler queue"))
        # per-query propagated deadlines are NOT monotone in arrival
        # order (budgets differ per query) — scan the whole waitlist
        expired = [ctx for ctx in g.pending
                   if ctx.deadline_ms is not None and
                   ctx.deadline_ms <= now_ms]
        for ctx in expired:
            g.pending.remove(ctx)
            ctx.future.set_exception(SchedulerDeadlineError(
                f"query for group {g.name} missed its propagated "
                "deadline in the scheduler queue"))

    def take_next(self, timeout: float = 0.02
                  ) -> Optional[SchedulerQueryContext]:
        """Winner group's oldest query, or None after `timeout`.

        put() and wake() notify the condition, so dispatch latency does
        not depend on the timeout — it only bounds how often the idle
        scheduler thread re-scans (the reference busy-polls at 1ms,
        QUEUE_WAKEUP_MICROS; 20ms here cuts idle scanning ~20x with the
        same responsiveness because our put() signals)."""
        with self._lock:
            winner = self._take_internal()
            if winner is None:
                self._not_empty.wait(timeout)
                winner = self._take_internal()
            return winner

    def wake(self) -> None:
        """Re-evaluate schedulability (called when reserved threads are
        released — a hard-limited group may have become eligible — and on
        shutdown so the scheduler thread exits promptly)."""
        with self._lock:
            self._not_empty.notify_all()

    def _take_internal(self) -> Optional[SchedulerQueryContext]:
        soft = self.policy.table_threads_soft_limit
        hard = self.policy.table_threads_hard_limit
        winner: Optional[TokenSchedulerGroup] = None
        wkey = None
        for g in self._groups.values():
            self._trim_expired(g)
            if not g.pending or g.total_reserved_threads() >= hard:
                continue          # canSchedule == False
            if winner is None:
                winner, wkey = g, g.compare_key()
                continue
            key = g.compare_key()
            if key > wkey:        # lower priority than current winner
                # ...unless the winner is past the soft limit and this
                # group is under it (soft-limit moderation)
                if winner.total_reserved_threads() > soft and \
                        g.total_reserved_threads() < soft:
                    winner, wkey = g, key
                continue
            # higher (or equal) priority: take it if it is under the soft
            # limit or leaner than the current winner
            if g.total_reserved_threads() < soft or \
                    g.total_reserved_threads() < \
                    winner.total_reserved_threads():
                winner, wkey = g, key
        if winner is None:
            return None
        return winner.pending.popleft()

    def drain(self) -> List[SchedulerQueryContext]:
        out: List[SchedulerQueryContext] = []
        with self._lock:
            for g in self._groups.values():
                while g.pending:
                    out.append(g.pending.popleft())
        return out

    def stats(self) -> List[dict]:
        with self._lock:
            return [g.stats() for g in self._groups.values()]


class TokenBucketScheduler(QueryScheduler):
    """Priority scheduling by hierarchical per-group token accounting.

    Parity: tokenbucket/TokenPriorityScheduler + PriorityScheduler.java —
    a dedicated scheduler thread gated by a running-queries semaphore pulls
    the token-priority winner from the MultiLevelPriorityQueue and runs it
    under BoundedAccountingExecutor-style accounting: the group's worker
    allotment is reserved up front, threads-in-use is incremented around
    execution (driving the token drain), and both are released at the end.
    """

    TOKEN_LIFETIME_MS = 100

    def __init__(self, num_workers: int = 4,
                 policy: Optional[ResourceLimitPolicy] = None,
                 query_deadline_s: float = 30.0,
                 clock: Callable[[], float] = time.monotonic):
        super().__init__(num_workers)
        self.policy = policy or ResourceLimitPolicy(
            num_workers, max_pending_per_group=1024)
        self.queue = MultiLevelPriorityQueue(
            self.policy, num_workers, self.TOKEN_LIFETIME_MS,
            query_deadline_s, clock)
        self._sem = threading.Semaphore(num_workers)
        self._running = True
        self._thread = threading.Thread(target=self._scheduler_loop,
                                        name="scheduler", daemon=True)
        self._thread.start()

    def submit(self, group: str, fn: Callable[[], object],
               deadline_s: Optional[float] = None) -> Future:
        if not self._running:
            f: Future = Future()
            f.set_exception(RuntimeError("scheduler is shut down"))
            return f
        try:
            ctx = self.queue.put(group, fn, deadline_s=deadline_s)
        except SchedulerOutOfCapacityError as e:
            f = Future()
            f.set_exception(e)
            return f
        if not self._running and self.queue.remove(ctx):
            # shutdown raced the put() in: the drain already ran, so fail
            # the context here rather than leave its future unresolved
            ctx.future.set_exception(RuntimeError("scheduler is shut down"))
        return ctx.future

    def _scheduler_loop(self) -> None:
        while self._running:
            self._sem.acquire()
            ctx = None
            g = None
            reserved = 0
            try:
                while self._running and ctx is None:
                    ctx = self.queue.take_next()
                if ctx is None:      # shutting down
                    self._sem.release()
                    break
                g = self.queue.group(ctx.group)
                # BoundedAccountingExecutor: reserve the group's worker
                # allotment before execution (1 runner per query here —
                # the per-segment fan-out runs inside the device kernel)
                g.add_reserved(1)
                reserved = 1
                g.consume_tokens()   # startQuery accounting point
                self._pool.submit(self._run, ctx, g, reserved)
            except Exception as e:  # noqa: BLE001 — scheduler must survive
                # a dequeued query must never hang its caller: fail the
                # future and undo the reservation before moving on
                if reserved and g is not None:
                    g.release_reserved(reserved)
                if ctx is not None and not ctx.future.done():
                    ctx.future.set_exception(e)
                self._sem.release()

    def _run(self, ctx: SchedulerQueryContext, g: TokenSchedulerGroup,
             bounds: int) -> None:
        try:
            if not ctx.future.set_running_or_notify_cancel():
                return
            g.increment_threads()
            try:
                ctx.future.set_result(ctx.fn())
            except BaseException as e:  # noqa: BLE001 — future carries it
                ctx.future.set_exception(e)
            finally:
                g.decrement_threads()
        finally:
            g.release_reserved(bounds)
            g.consume_tokens()       # endQuery accounting point
            self._sem.release()
            self.queue.wake()        # a hard-limited group may be eligible

    def group_stats(self) -> List[dict]:
        return self.queue.stats()

    def shutdown(self) -> None:
        self._running = False  # tpulint: disable=concurrency -- single irreversible flip of a GIL-atomic bool; readers poll it, no compound invariant
        self.queue.wake()
        for ctx in self.queue.drain():
            ctx.future.set_exception(RuntimeError("scheduler is shut down"))
        super().shutdown()


def make_scheduler(algorithm: str = "fcfs", num_workers: int = 4
                   ) -> QueryScheduler:
    """Parity: QuerySchedulerFactory.create (falls back to FCFS)."""
    if algorithm == "tokenbucket":
        return TokenBucketScheduler(num_workers)
    if algorithm == "bounded_fcfs":
        return BoundedFCFSScheduler(num_workers)
    return FCFSQueryScheduler(num_workers)


class BoundedFCFSScheduler(QueryScheduler):
    """Per-group FCFS with bounded per-group resources.

    Parity: fcfs/BoundedFCFSScheduler + PolicyBasedResourceManager — FCFS
    order across groups (oldest pending first), but a group already at
    its thread limit is skipped, and a group with a full pending queue
    rejects new queries instead of growing without bound.
    """

    def __init__(self, num_workers: int = 4,
                 policy: Optional[ResourceLimitPolicy] = None):
        super().__init__(num_workers)
        self.policy = policy or ResourceLimitPolicy(num_workers)
        self._pending: Dict[str, list] = {}  # tpulint: disable=cache-bound -- one queue per table (bounded by hosted tables); each queue is capped at max_pending_per_group with a typed reject
        self._running: Dict[str, int] = {}  # tpulint: disable=cache-bound -- per-table running counters: bounded by hosted tables
        self._order: list = []            # (seq, group) FCFS across groups
        self._seq = 0
        self._lock = threading.Lock()

    def submit(self, group: str, fn: Callable[[], object],
               deadline_s: Optional[float] = None) -> Future:
        future: Future = Future()
        with self._lock:
            q = self._pending.setdefault(group, [])
            if len(q) >= self.policy.max_pending_per_group:
                future.set_exception(SchedulerOutOfCapacityError(
                    f"group {group}: {len(q)} pending >= "
                    f"{self.policy.max_pending_per_group}"))
                return future
            q.append((fn, future))
            heapq.heappush(self._order, (self._seq, group))
            self._seq += 1
        self._pool.submit(self._drain)
        return future

    def _next(self):
        """Oldest pending entry whose group is under its thread limit."""
        skipped = []
        try:
            while self._order:
                seq, group = heapq.heappop(self._order)
                if not self._pending.get(group):
                    continue            # stale order entry
                if self._running.get(group, 0) >= \
                        self.policy.table_threads_hard_limit:
                    skipped.append((seq, group))
                    continue
                fn, future = self._pending[group].pop(0)
                self._running[group] = self._running.get(group, 0) + 1  # tpulint: disable=concurrency -- only caller is _drain, which holds self._lock
                return group, fn, future
            return None
        finally:
            for item in skipped:
                heapq.heappush(self._order, item)

    def _drain(self) -> None:
        with self._lock:
            item = self._next()
        if item is None:
            return
        group, fn, future = item
        try:
            if future.set_running_or_notify_cancel():
                try:
                    future.set_result(fn())
                except BaseException as e:  # noqa: BLE001
                    future.set_exception(e)
        finally:
            with self._lock:
                self._running[group] -= 1
                more = any(self._pending.values())
            if more:
                self._pool.submit(self._drain)


# ---------------------------------------------------------------------------
# Cross-query dispatch coalescing
# ---------------------------------------------------------------------------


class BatchGroup:
    """An open admission window for one plan-shape key.

    Members accumulate until seal(); the group's deadline is the
    TIGHTEST member deadline (a batch must not let a late joiner relax
    an early member's budget — the whole batch answers by the earliest
    promise). All mutation happens under the owning coalescer's lock.
    """

    __slots__ = ("key", "created_s", "deadline_s", "members", "sealed")

    def __init__(self, key, created_s: float,
                 deadline_s: Optional[float], member):
        self.key = key
        self.created_s = created_s
        self.deadline_s = deadline_s
        self.members: List = [member]
        self.sealed = False


class DispatchCoalescer:
    """Same-plan-shape queries share one kernel execution.

    State machine per key (the instance layer supplies the key — table
    + plan-shape + segment set — and opaque members):

    - ``solo``:   nothing with this key is in flight → execute
                  immediately; the window costs an idle query NOTHING.
    - ``bypass``: same-key work is in flight but this member's budget
                  cannot survive the window → execute immediately.
    - ``lead``:   same-key work is in flight → open a window; the
                  caller schedules a runner that sleeps out
                  remaining_window_s() then seal()s and executes the
                  batch.
    - ``joined``: an open unsealed window exists → appended to it.

    solo/bypass/sealed-group executions each count as one in-flight
    dispatch for their key until the caller's ``leave(key)``; seal() is
    idempotent (runner and failure callback may race) and returns the
    members exactly once, so a member future is resolved by exactly one
    path.
    """

    def __init__(self, window_s: float,
                 clock: Callable[[], float] = time.monotonic,
                 on_dispatch: Optional[Callable[[int], None]] = None,
                 on_bypass: Optional[Callable[[], None]] = None):
        self.window_s = float(window_s)
        # a member bypasses when its remaining budget is under this
        # multiple of the window: surviving the sleep is not enough, it
        # still has to execute afterwards
        self.min_slack_windows = 2.0
        self._clock = clock
        self._on_dispatch = on_dispatch
        self._on_bypass = on_bypass
        self._lock = threading.Lock()
        self._inflight: Dict[object, int] = {}
        self._open: Dict[object, BatchGroup] = {}

    def arrive(self, key, member, deadline_s: Optional[float]):
        """Returns (state, group): state in {"solo", "bypass", "joined",
        "lead"}; group is set for joined/lead."""
        bypass = False
        with self._lock:
            g = self._open.get(key)
            if g is not None and not g.sealed:
                g.members.append(member)
                if deadline_s is not None:
                    g.deadline_s = deadline_s if g.deadline_s is None \
                        else min(g.deadline_s, deadline_s)
                return "joined", g
            inflight = self._inflight.get(key, 0)
            now = self._clock()
            if inflight == 0:
                self._inflight[key] = 1
                return "solo", None
            if deadline_s is not None and \
                    deadline_s - now < self.min_slack_windows * \
                    self.window_s:
                self._inflight[key] = inflight + 1
                bypass = True
            else:
                g = BatchGroup(key, now, deadline_s, member)
                self._open[key] = g
                return "lead", g
        if bypass and self._on_bypass is not None:
            self._on_bypass()
        return "bypass", None

    def joinable(self, key) -> bool:
        """An open, unsealed window exists for this key (the hedge-join
        admission carve-out reads this)."""
        with self._lock:
            g = self._open.get(key)
            return g is not None and not g.sealed

    def remaining_window_s(self, group: BatchGroup) -> float:
        return max(0.0, group.created_s + self.window_s - self._clock())

    def seal(self, group: BatchGroup) -> List:
        """Close the window and take its members; [] if already sealed.
        The sealed group counts as one in-flight dispatch until the
        caller's leave(key)."""
        with self._lock:
            if group.sealed:
                return []
            group.sealed = True
            if self._open.get(group.key) is group:
                del self._open[group.key]
            self._inflight[group.key] = \
                self._inflight.get(group.key, 0) + 1
            members = list(group.members)
        if self._on_dispatch is not None:
            self._on_dispatch(len(members))
        return members

    def leave(self, key) -> None:
        """A solo/bypass/sealed-group execution for this key finished."""
        with self._lock:
            n = self._inflight.get(key, 0) - 1
            if n <= 0:
                self._inflight.pop(key, None)
            else:
                self._inflight[key] = n
