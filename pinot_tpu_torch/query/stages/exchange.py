"""Exchange plane: stage-1 result blocks shipped server↔server.

Copy of pinot_tpu/query/stages/exchange.py, its imports rebased onto
pinot_tpu_torch: a source in this process resolves through the registry,
any other over the port's TCP data plane (transport/tcp.py), and held
blocks are ledgered (obs/residency.py, kind "exchange").

A stage-1 producer executes a normal scan and PUBLISHES the serialized
DataTable into its ExchangeManager under a broker-assigned exchange id
(the reply to the broker is a small ack). Stage-2 consumers fetch peer
blocks over the SAME requestId-multiplexed TCP data plane the broker
uses (transport/tcp.py) — an ``XCHG``-tagged frame addressed to the
peer's QueryServer, its reply inline on the connection (the port has
no shared-memory reply path) — and same-process peers (embedded
clusters) short-circuit through an in-process registry keyed by each
manager's unique ``xkey``.

Lifetime: entries are TTL-bounded (a crashed broker or abandoned query
must not leak blocks) and the manager is byte-budgeted — an oversized
publish fails loudly at stage 1 instead of silently truncating a join.

Wire format (frame payload after the 8-byte correlation id):
``XCHG`` magic + UTF-8 JSON ``{"op": "fetch", "id": <exchange id>}``.
The reply is the published DataTable bytes verbatim, or a DataTable
whose exceptions carry ``ExchangeMissError`` when the id is unknown/
expired.
"""
from __future__ import annotations

import json
import threading
import time
import uuid
from typing import Dict, List, Optional, Tuple

from pinot_tpu_torch.common.datatable import DataTable
from pinot_tpu_torch.obs import residency
from pinot_tpu_torch.query.stages.errors import ExchangeError

XCHG_MAGIC = b"XCHG"

DEFAULT_TTL_S = 120.0
DEFAULT_MAX_BYTES = 256 << 20

#: process-global registry: xkey → ExchangeManager. Keys are per-manager
#: UUIDs (never instance names — several embedded clusters in one test
#: process may all run a "Server_0"), so a local fetch can only ever hit
#: the exact manager the broker's source descriptor named.
_REGISTRY: Dict[str, "ExchangeManager"] = {}
_REGISTRY_LOCK = threading.Lock()


def is_exchange_frame(payload) -> bool:
    return bytes(payload[:4]) == XCHG_MAGIC


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
        # residency: held blocks are device-adjacent memory a stage-2
        # join will upload; the ledger sweeps us on scrape so expired
        # entries leave the books at quiescence, not on the next put/get
        residency.LEDGER.add_sweeper(self.sweep_expired)

    def close(self) -> None:
        with _REGISTRY_LOCK:
            _REGISTRY.pop(self.xkey, None)
        residency.LEDGER.remove_sweeper(self.sweep_expired)
        with self._lock:
            self._store.clear()
            self._bytes = 0
        residency.LEDGER.release_prefix(f"xchg:{self.xkey}:")

    # -- store -------------------------------------------------------------
    def put(self, xid: str, payload: bytes,
            ttl_s: Optional[float] = None) -> None:
        """`ttl_s` caps this entry's lifetime below the manager default:
        publishers pass the query's remaining deadline budget (+slack),
        so steady-state held bytes track in-flight queries instead of
        draining only at the 120s default — sustained join traffic
        would otherwise hard-cap on TTL drain, not real concurrency."""
        now = self._clock()
        ttl = self.ttl_s if ttl_s is None else min(self.ttl_s, ttl_s)
        with self._lock:
            self._sweep(now)
            # credit a to-be-replaced entry BEFORE the overflow compare:
            # a republish of xid must be judged against the budget it
            # will actually occupy, and the typed-422 reject path must
            # leave the books exactly as they were (debit/credit pairs
            # balance — the model checker's bytes-conservation invariant)
            old = self._store.get(xid)
            held = self._bytes - (len(old[0]) if old is not None else 0)
            if held + len(payload) > self.max_bytes:
                raise ExchangeError(
                    f"exchange buffer full ({held} bytes held, "
                    f"{len(payload)} offered, cap {self.max_bytes})")
            self._store[xid] = (payload, now + max(ttl, 1.0))
            self._bytes = held + len(payload)
            residency.LEDGER.register(
                f"xchg:{self.xkey}:{xid}", table="", segment="",
                kind="exchange", nbytes=len(payload))

    def get(self, xid: str) -> Optional[bytes]:
        now = self._clock()
        with self._lock:
            self._sweep(now)
            entry = self._store.get(xid)
            return entry[0] if entry is not None else None

    def sweep_expired(self) -> int:
        """Drop every expired entry NOW; returns the bytes released.
        Without this the sweep only ran inside put/get, so a quiescent
        manager held expired blocks (and their budget) indefinitely —
        exactly the leak the exchange protocol model flags when the
        `standalone_sweep` shape is missing."""
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
            residency.LEDGER.release(f"xchg:{self.xkey}:{k}")

    def __len__(self) -> int:
        with self._lock:
            return len(self._store)

    # -- data-plane frames -------------------------------------------------
    def handle_frame(self, payload) -> bytes:
        """One XCHG frame → reply bytes (the published block, or a typed
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
# Fetch client (stage-2 consumers; called from scheduler worker threads)
# ---------------------------------------------------------------------------

_CLIENT_LOCK = threading.Lock()
_CLIENT_LOOP = None
_CLIENT_CONNS: Dict[Tuple[str, int], object] = {}  # one connection per (host, port) peer: bounded by cluster membership


def _client_loop():
    global _CLIENT_LOOP
    with _CLIENT_LOCK:
        if _CLIENT_LOOP is None:
            from pinot_tpu_torch.transport.tcp import EventLoopThread
            _CLIENT_LOOP = EventLoopThread()
        return _CLIENT_LOOP


def _connection(host: str, port: int):
    key = (host, port)
    with _CLIENT_LOCK:
        conn = _CLIENT_CONNS.get(key)
        if conn is None:
            from pinot_tpu_torch.transport.tcp import ServerConnection
            conn = _CLIENT_CONNS[key] = ServerConnection(host, port)
        return conn


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


def fetch_block(source: dict, timeout_s: float) -> DataTable:
    """Fetch one published stage-1 block.

    `source`: the broker's descriptor — {"server", "xkey", "id", and
    ("host", "port") when the peer is reachable over TCP}. Same-process
    peers resolve through the registry (zero-copy local bytes); remote
    peers go over the multiplexed data plane. Raises ExchangeError on miss/transport failure.
    """
    local = _fetch_local(source)
    if local is not None:
        return local
    host, port = source.get("host"), source.get("port")
    if not host or not port:
        raise ExchangeError(
            f"exchange source {source.get('server')!r} is neither "
            "local nor TCP-addressable")
    loop = _client_loop()
    conn = _connection(host, int(port))
    import asyncio
    xid = source["id"]
    try:
        raw = loop.run(
            asyncio.wait_for(conn.request(fetch_frame(xid), timeout_s),
                             timeout_s),
            timeout=timeout_s + 5.0)
    except Exception as e:  # noqa: BLE001 — transport-class failure
        raise ExchangeError(
            f"exchange fetch from {source.get('server')} "
            f"({host}:{port}) failed: {type(e).__name__}: {e}") from e
    return _check_block(DataTable.from_bytes(raw))


def fetch_blocks(sources: List[dict], deadline_s: Optional[float],
                 clock=time.monotonic) -> List[DataTable]:
    """Fetch every source, in the CALLER's order (callers sort for
    determinism). Local-registry sources resolve inline; remote TCP
    fetches run CONCURRENTLY on the shared client loop — the stage-2
    critical path pays the slowest peer, not the sum of RTTs."""
    budget = 10.0 if deadline_s is None else \
        max(deadline_s - clock(), 0.05)
    out: List[Optional[DataTable]] = [None] * len(sources)
    remote: List[int] = []
    for i, src in enumerate(sources):
        local = _fetch_local(src)
        if local is not None:
            out[i] = local
        else:
            remote.append(i)
    if remote:
        import asyncio
        loop = _client_loop()
        conns = []
        for i in remote:
            src = sources[i]
            host, port = src.get("host"), src.get("port")
            if not host or not port:
                raise ExchangeError(
                    f"exchange source {src.get('server')!r} is neither "
                    "local nor TCP-addressable")
            conns.append(_connection(host, int(port)))

        async def _gather():
            return await asyncio.gather(
                *(asyncio.wait_for(
                    conn.request(fetch_frame(sources[i]["id"]), budget),
                    budget)
                  for i, conn in zip(remote, conns)),
                return_exceptions=True)

        raws = loop.run(_gather(), timeout=budget + 5.0)
        first_err: Optional[ExchangeError] = None
        for i, raw in zip(remote, raws):
            if isinstance(raw, BaseException):
                if first_err is None:
                    first_err = ExchangeError(
                        f"exchange fetch from "
                        f"{sources[i].get('server')} failed: "
                        f"{type(raw).__name__}: {raw}")
                    first_err.__cause__ = raw
                continue
            try:
                out[i] = _check_block(DataTable.from_bytes(raw))
            except ExchangeError as e:
                if first_err is None:
                    first_err = e
        if first_err is not None:
            raise first_err
    return out
