"""Deterministic fault injection for broker↔server transports.

Chaos-engineering support (Basiri et al., "Chaos Engineering", IEEE
Software 2016): the only way to trust a fault-tolerance layer is to
inject the faults it claims to handle, deterministically, in CI.
`FaultInjectingTransport` wraps any object with the `ServerTransport`
shape (``async query(server, payload, timeout) -> bytes`` plus
``async close()``) and injects seeded, per-server faults:

- ``latency``  — await an injected sleep before forwarding (the sleep
  coroutine is injectable, so tier-1 tests use virtual delays)
- ``hang``     — never respond; the caller's deadline/hedge must save it
- ``drop``     — raise ConnectionError (dropped connection)
- ``error``    — raise an arbitrary injected exception
- ``corrupt``  — forward, then mangle the response bytes
- ``missing_segments`` — forward a request stripped of the victim
  segments and stamp the response with the server's honest
  missing-segment report (exactly what a server that unloaded the
  segment would return)

Faults are armed per server with an optional activation budget
(`times`) and probability (driven by one seeded RNG, so a run is fully
reproducible). The transport counts every activation in `.injected`
for test assertions.

This module deliberately avoids importing the broker package: it
duck-types the transport so common/ stays a leaf layer.
"""
from __future__ import annotations

import asyncio
import dataclasses
import json
import random
import threading
from typing import Awaitable, Callable, Dict, List, Optional

from pinot_tpu_torch.common.datatable import (DataTable, MISSING_SEGMENTS_KEY,
                                        SEGMENT_MISSING_EXC_PREFIX)
from pinot_tpu_torch.common.serde import (instance_request_from_bytes,
                                    instance_request_to_bytes)

class InjectedCrash(RuntimeError):
    """Raised at an armed crash point: simulates the process dying at
    exactly this instruction. Crash-recovery tests arm a point, drive
    the component until the crash fires, abandon the component (its
    in-memory state is 'lost'), and restart a fresh one over the same
    durable state — the WAL/snapshot/deep-store files written up to the
    crash instant."""


class CrashPoints:
    """Seeded, deterministic crash-point registry.

    Production code calls ``crash_points.hit("name")`` at instrumented
    instructions (WAL append, commit metadata flip, artifact download).
    Unarmed points are free; an armed point raises InjectedCrash on its
    Nth hit (``skip`` earlier hits pass through), then disarms — a
    restarted component runs past the same point cleanly, exactly like
    a real crash-once scenario.
    """

    def __init__(self):
        self._armed: Dict[str, int] = {}          # name -> remaining skips
        self.fired: Dict[str, int] = {}
        self._lock = threading.Lock()

    def arm(self, name: str, skip: int = 0) -> None:
        """Fire on the (skip+1)-th hit of `name`."""
        with self._lock:
            self._armed[name] = skip

    def clear(self, name: Optional[str] = None) -> None:
        with self._lock:
            if name is None:
                self._armed.clear()
            else:
                self._armed.pop(name, None)

    def consume(self, name: str) -> bool:
        """True exactly when the armed point fires (and disarms it)."""
        with self._lock:
            skips = self._armed.get(name)
            if skips is None:
                return False
            if skips > 0:
                self._armed[name] = skips - 1
                return False
            del self._armed[name]
            self.fired[name] = self.fired.get(name, 0) + 1
            return True

    def hit(self, name: str) -> None:
        if self.consume(name):
            raise InjectedCrash(name)


#: process-wide registry — components hit it, tests arm/clear it
crash_points = CrashPoints()


LATENCY = "latency"
HANG = "hang"
DROP = "drop"
ERROR = "error"
CORRUPT = "corrupt"
MISSING_SEGMENTS = "missing_segments"

_KINDS = (LATENCY, HANG, DROP, ERROR, CORRUPT, MISSING_SEGMENTS)


@dataclasses.dataclass
class FaultSpec:
    """One armed fault. Immutable; activation bookkeeping lives in the
    transport so a spec can be shared/re-armed freely."""
    kind: str
    latency_s: float = 0.0                    # LATENCY only
    error: Optional[BaseException] = None     # ERROR only
    segments: tuple = ()                      # MISSING_SEGMENTS only
    probability: float = 1.0                  # per-call activation chance
    times: Optional[int] = None               # max activations; None = ∞

    def __post_init__(self):
        if self.kind not in _KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"known: {_KINDS}")


class _Armed:
    __slots__ = ("spec", "remaining")

    def __init__(self, spec: FaultSpec):
        self.spec = spec
        self.remaining = spec.times


def corrupt_bytes(raw) -> bytes:
    """Deterministically mangle a response frame so DataTable.from_bytes
    must fail (the version header is inverted, never silently valid)."""
    raw = bytes(raw)       # the mux hands replies as frame memoryviews
    head = bytes(b ^ 0xFF for b in raw[:8])
    return head + raw[8:]


class FaultInjectingTransport:
    """Wraps a ServerTransport-shaped object, injecting armed faults.

    `sleep` is the coroutine used for LATENCY faults — inject a virtual
    clock's sleep (or an instant recorder) to keep tier-1 tests free of
    wall-clock waits. `seed` drives the probability RNG.
    """

    def __init__(self, inner, seed: int = 0,
                 sleep: Callable[[float], Awaitable[None]] = asyncio.sleep):
        self.inner = inner
        self._sleep = sleep
        self._rng = random.Random(seed)
        self._faults: Dict[str, List[_Armed]] = {}
        # (server, kind) -> activation count, for test assertions
        self.injected: Dict[tuple, int] = {}
        self._lock = threading.Lock()

    @property
    def endpoints(self):
        """Endpoint transparency: the multi-stage planner addresses
        exchange peers via ``transport.endpoints`` — a fault wrapper
        must not hide the inner TCP transport's map (faults perturb
        dispatch, never addressing)."""
        return getattr(self.inner, "endpoints", {})

    def set_endpoint(self, server: str, host: str, port: int) -> None:
        self.inner.set_endpoint(server, host, port)

    # -- arming ------------------------------------------------------------
    def inject(self, server: str, spec: FaultSpec) -> FaultSpec:
        with self._lock:
            self._faults.setdefault(server, []).append(_Armed(spec))
        return spec

    def clear(self, server: Optional[str] = None) -> None:
        with self._lock:
            if server is None:
                self._faults.clear()
            else:
                self._faults.pop(server, None)

    def injected_count(self, server: str, kind: str) -> int:
        with self._lock:
            return self.injected.get((server, kind), 0)

    def _activate(self, server: str) -> List[FaultSpec]:
        """Decide (seeded) which armed faults fire for this call."""
        fired: List[FaultSpec] = []
        with self._lock:
            for armed in self._faults.get(server, []):
                if armed.remaining is not None and armed.remaining <= 0:
                    continue
                if armed.spec.probability < 1.0 and \
                        self._rng.random() >= armed.spec.probability:
                    continue
                if armed.remaining is not None:
                    armed.remaining -= 1
                key = (server, armed.spec.kind)
                self.injected[key] = self.injected.get(key, 0) + 1
                fired.append(armed.spec)
        return fired

    # -- transport shape ---------------------------------------------------
    async def query(self, server: str, payload: bytes,
                    timeout: float) -> bytes:
        fired = self._activate(server)
        strip_segments: set = set()
        corrupt = False
        for spec in fired:
            if spec.kind == LATENCY:
                await self._sleep(spec.latency_s)
            elif spec.kind == HANG:
                # wait forever; only the caller's cancellation (deadline
                # or a winning hedge) ends this — no wall-clock involved
                await asyncio.Event().wait()
            elif spec.kind == DROP:
                raise ConnectionError(
                    f"injected connection drop to {server}")
            elif spec.kind == ERROR:
                raise spec.error if spec.error is not None else \
                    RuntimeError(f"injected server error on {server}")
            elif spec.kind == CORRUPT:
                corrupt = True
            elif spec.kind == MISSING_SEGMENTS:
                strip_segments.update(spec.segments)

        if strip_segments:
            payload, stripped = _strip_segments(payload, strip_segments)
        else:
            stripped = []

        raw = await self.inner.query(server, payload, timeout)

        if stripped:
            raw = _stamp_missing(raw, stripped)
        if corrupt:
            raw = corrupt_bytes(raw)
        return raw

    async def close(self) -> None:
        await self.inner.close()


def _strip_segments(payload: bytes, victims: set):
    """Remove victim segments from the request so the server neither
    computes nor returns their rows (matching a server that unloaded
    them); returns (new_payload, actually_stripped)."""
    request = instance_request_from_bytes(payload)
    if request.search_segments is None:
        return payload, []
    stripped = [s for s in request.search_segments if s in victims]
    if not stripped:
        return payload, []
    request.search_segments = [s for s in request.search_segments
                               if s not in victims]
    return instance_request_to_bytes(request), stripped


def _stamp_missing(raw: bytes, stripped: List[str]) -> bytes:
    """Merge the injected missing segments into the response's honest
    missing-segment report (metadata + human-facing exception)."""
    dt = DataTable.from_bytes(raw)
    prior = []
    prior_raw = dt.metadata.get(MISSING_SEGMENTS_KEY)
    if prior_raw:
        try:
            prior = json.loads(prior_raw)
        except ValueError:
            prior = []
    missing = sorted(set(prior) | set(stripped))
    dt.metadata[MISSING_SEGMENTS_KEY] = json.dumps(missing)
    dt.exceptions = [e for e in dt.exceptions
                     if not str(e).startswith(SEGMENT_MISSING_EXC_PREFIX)]
    dt.exceptions.append(f"{SEGMENT_MISSING_EXC_PREFIX} {missing}")
    return dt.to_bytes()
