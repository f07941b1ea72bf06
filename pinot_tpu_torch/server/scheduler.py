"""Cross-query dispatch coalescing: the batch admission window.

A copy of `BatchGroup` and `DispatchCoalescer` of
pinot_tpu/server/scheduler.py (:595-718, JAX-free): the state machine
that gathers concurrent same-shape queries (query/fingerprint.py:
plan_shape_key) into one batch, which ServerQueryExecutor.execute_batch
then runs with one launch per kernel. The schedulers and the server
instance that drive it stay in the JAX package until the port's server
layer.
"""
from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional


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
