"""Exchange plane: stage-1 result blocks shipped to stage-2 consumers.

Copy of pinot_tpu/query/stages/exchange.py. A stage-1 producer executes
a normal scan and PUBLISHES the serialized DataTable into its
ExchangeManager under a broker-assigned exchange id; stage-2 consumers
fetch it. Same-process peers resolve through an in-process registry
keyed by each manager's unique ``xkey``, and that is the only fetch the
port has: a source outside the registry needs the TCP data plane
(transport/tcp.py), which is not in the port yet, and raises NotPorted.

Lifetime: entries are TTL-bounded (an abandoned query must not leak
blocks) and the manager is byte-budgeted: an oversized publish fails
loudly at stage 1 instead of silently truncating a join.

Wire format of a fetch (what `handle_frame` answers): ``XCHG`` magic +
UTF-8 JSON ``{"op": "fetch", "id": <exchange id>}``. The reply is the
published DataTable bytes verbatim, or a DataTable whose exceptions
carry ``ExchangeMissError`` when the id is unknown or expired.
"""
from __future__ import annotations

import json
import threading
import time
import uuid
from typing import Dict, List, Optional, Tuple

from pinot_tpu_torch.common.datatable import DataTable
from pinot_tpu_torch.query.stages.errors import ExchangeError

XCHG_MAGIC = b"XCHG"

DEFAULT_TTL_S = 120.0
DEFAULT_MAX_BYTES = 256 << 20

#: process-global registry: xkey -> ExchangeManager. Keys are per-manager
#: UUIDs (never instance names), so a local fetch can only ever hit the
#: exact manager the source descriptor named.
_REGISTRY: Dict[str, "ExchangeManager"] = {}
_REGISTRY_LOCK = threading.Lock()


class ExchangeManager:
    """Per-server store of published stage-1 blocks."""

    def __init__(self, ttl_s: float = DEFAULT_TTL_S,
                 max_bytes: int = DEFAULT_MAX_BYTES,
                 clock=time.monotonic):
        self.xkey = uuid.uuid4().hex
        self.ttl_s = ttl_s
        self.max_bytes = max_bytes
        self._clock = clock
        self._lock = threading.Lock()
        self._store: Dict[str, Tuple[bytes, float]] = {}
        self._bytes = 0
        with _REGISTRY_LOCK:
            _REGISTRY[self.xkey] = self
        # the residency ledger's sweeper registration waits for the
        # port's obs layer

    def close(self) -> None:
        with _REGISTRY_LOCK:
            _REGISTRY.pop(self.xkey, None)
        with self._lock:
            self._store.clear()
            self._bytes = 0

    # -- store -------------------------------------------------------------
    def put(self, xid: str, payload: bytes,
            ttl_s: Optional[float] = None) -> None:
        """`ttl_s` caps this entry's lifetime below the manager default
        (publishers pass the query's remaining deadline budget)."""
        now = self._clock()
        ttl = self.ttl_s if ttl_s is None else min(self.ttl_s, ttl_s)
        with self._lock:
            self._sweep(now)
            # a republish of xid is judged against the budget it will
            # actually occupy, and a rejected put leaves the books as
            # they were
            old = self._store.get(xid)
            held = self._bytes - (len(old[0]) if old is not None else 0)
            if held + len(payload) > self.max_bytes:
                raise ExchangeError(
                    f"exchange buffer full ({held} bytes held, "
                    f"{len(payload)} offered, cap {self.max_bytes})")
            self._store[xid] = (payload, now + max(ttl, 1.0))
            self._bytes = held + len(payload)
            # the residency ledger's register waits for the obs layer

    def get(self, xid: str) -> Optional[bytes]:
        now = self._clock()
        with self._lock:
            self._sweep(now)
            entry = self._store.get(xid)
            return entry[0] if entry is not None else None

    def sweep_expired(self) -> int:
        """Drop every expired entry now; returns the bytes released."""
        with self._lock:
            before = self._bytes
            self._sweep(self._clock())
            return before - self._bytes

    def held_bytes(self) -> int:
        with self._lock:
            return self._bytes

    def _sweep(self, now: float) -> None:
        # caller holds the lock
        dead = [k for k, (_p, exp) in self._store.items() if exp <= now]
        for k in dead:
            payload, _exp = self._store.pop(k)
            self._bytes -= len(payload)
            # the residency ledger's release waits for the obs layer

    def __len__(self) -> int:
        with self._lock:
            return len(self._store)

    # -- data-plane frames -------------------------------------------------
    def handle_frame(self, payload) -> bytes:
        """One XCHG frame -> reply bytes (the published block, or a typed
        miss DataTable)."""
        try:
            msg = json.loads(bytes(payload[4:]).decode("utf-8"))
            op = msg.get("op")
            xid = msg.get("id")
        except (ValueError, UnicodeDecodeError):
            return _miss_reply("malformed exchange frame")
        if op != "fetch" or not isinstance(xid, str):
            return _miss_reply(f"unknown exchange op {op!r}")
        block = self.get(xid)
        if block is None:
            return _miss_reply(f"exchange id {xid!r} unknown or expired")
        return block


def fetch_frame(xid: str) -> bytes:
    return XCHG_MAGIC + json.dumps({"op": "fetch", "id": xid},
                                   separators=(",", ":")).encode("utf-8")


def _miss_reply(message: str) -> bytes:
    dt = DataTable()
    dt.exceptions.append(f"ExchangeMissError: {message}")
    return dt.to_bytes()


# ---------------------------------------------------------------------------
# Fetch client (stage-2 consumers)
# ---------------------------------------------------------------------------


def _check_block(dt: DataTable) -> DataTable:
    for exc in dt.exceptions:
        if str(exc).startswith("ExchangeMissError"):
            raise ExchangeError(str(exc))
    return dt


def _fetch_local(source: dict) -> Optional[DataTable]:
    """Registry short-circuit: the decoded block, or None when the
    source is not a same-process manager."""
    mgr = _REGISTRY.get(source.get("xkey") or "")
    if mgr is None:
        return None
    payload = mgr.get(source["id"])
    if payload is None:
        raise ExchangeError(
            f"exchange id {source['id']!r} missing on local manager "
            f"{source.get('server')}")
    return _check_block(DataTable.from_bytes(payload))


def fetch_blocks(sources: List[dict], deadline_s: Optional[float]
                 ) -> List[DataTable]:
    """Fetch every source, in the CALLER's order (callers sort for
    determinism). A source outside this process raises NotPorted: its
    fetch needs the TCP data plane (transport/tcp.py), not in the port
    yet. Registry fetches do not wait, so `deadline_s` bounds nothing."""
    out: List[DataTable] = []
    for src in sources:
        local = _fetch_local(src)
        if local is None:
            from pinot_tpu_torch.query.plan import NotPorted
            raise NotPorted(
                f"exchange source {src.get('server')!r} is not in this "
                "process: the TCP data plane is not in the port yet")
        out.append(local)
    return out
