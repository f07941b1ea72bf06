"""Data-plane transport: length-framed, requestId-multiplexed TCP
between broker and servers.

Copy of pinot_tpu/transport/tcp.py (JAX-free), without its
shared-memory reply path (transport/shm.py there): every reply goes
inline on the connection.

Parity: the reference's Netty data plane — core/transport/ServerChannels.java
(one channel per server, LengthFieldBasedFrameDecoder framing, responses
correlated back to their requests by requestId so MANY queries share one
channel) and pinot-transport NettyServer — rebuilt on asyncio.

Wire format (query plane): [4-byte big-endian length][8-byte big-endian
correlation id][payload]. The correlation id is transport-level (distinct
from the InstanceRequest requestId, which identifies the query to the
engine): the broker assigns it per in-flight frame, the server echoes it
on the reply, and the broker completes the matching pending future —
responses may arrive in ANY order. A per-request timeout abandons only
its own future; the stream stays healthy because late replies are matched
(and discarded) by id instead of being misread as the next query's reply.

`read_frame`/`write_frame` stay the raw length-framing primitives (the
realtime stream and property-store protocols use them unmuxed).
"""
from __future__ import annotations

import asyncio
import itertools
import struct
import threading
from typing import Awaitable, Callable, Dict, Optional

_LEN = struct.Struct(">I")
_CORR = struct.Struct(">Q")
MAX_FRAME = 1 << 30


async def read_frame(reader: asyncio.StreamReader) -> bytes:
    header = await reader.readexactly(4)
    n = _LEN.unpack(header)[0]
    if n > MAX_FRAME:
        raise ValueError(f"frame too large: {n}")
    return await reader.readexactly(n)


def write_frame(writer: asyncio.StreamWriter, payload: bytes) -> None:
    writer.write(_LEN.pack(len(payload)) + payload)


def write_frame2(writer: asyncio.StreamWriter, head: bytes,
                 payload) -> None:
    """Two-part frame write: the 8-byte correlation header and the
    payload go to the transport buffer as-is — no `head + payload`
    concatenation copying a multi-MB reply just to prepend 8 bytes."""
    writer.write(_LEN.pack(len(head) + len(payload)))
    writer.write(head)
    writer.write(payload)


class QueryServer:
    """Accepts multiplexed framed requests, hands payloads to a handler,
    writes correlated replies as they finish.

    Each frame becomes its own task, so a slow query never blocks the
    connection's read loop — the next frame is dispatched immediately and
    replies are written in COMPLETION order, interleaved safely by a
    per-connection write lock (parity: Netty worker threads handing off
    to the QueryScheduler, responses flushed per-channel as they finish).

    handler: bytes -> bytes, run on the loop's default executor.
    async_handler: bytes -> awaitable bytes; preferred when given — the
    server instance awaits its scheduler future directly instead of
    pinning an executor thread per in-flight request.
    """

    def __init__(self, host: str, port: int,
                 handler: Callable[[bytes], bytes],
                 async_handler: Optional[
                     Callable[[bytes], Awaitable[bytes]]] = None):
        self.host = host
        self.port = port
        self.handler = handler
        self.async_handler = async_handler
        self._server: Optional[asyncio.AbstractServer] = None
        self._connections: set = set()

    async def start(self) -> None:
        self._server = await asyncio.start_server(
            self._serve_connection, self.host, self.port)
        if self.port == 0:
            self.port = self._server.sockets[0].getsockname()[1]

    async def stop(self) -> None:
        if self._server is not None:
            self._server.close()
            # force-close persistent client connections so wait_closed()
            # doesn't wait for brokers that keep their channels open
            for writer in list(self._connections):
                writer.close()
            await self._server.wait_closed()
            self._server = None

    async def _serve_connection(self, reader: asyncio.StreamReader,
                                writer: asyncio.StreamWriter) -> None:
        self._connections.add(writer)
        write_lock = asyncio.Lock()
        tasks: set = set()
        try:
            while True:
                frame = await read_frame(reader)
                corr, payload = frame[:8], frame[8:]
                # dispatch without blocking the read loop: the next
                # frame is picked up while this one executes
                t = asyncio.ensure_future(
                    self._handle_one(corr, payload, writer, write_lock))
                tasks.add(t)
                t.add_done_callback(tasks.discard)
        except (asyncio.IncompleteReadError, ConnectionResetError,
                ConnectionAbortedError):
            pass
        finally:
            for t in list(tasks):
                t.cancel()
            self._connections.discard(writer)
            writer.close()

    async def _handle_one(self, corr: bytes, payload: bytes,
                          writer: asyncio.StreamWriter,
                          write_lock: asyncio.Lock) -> None:
        try:
            if self.async_handler is not None:
                reply = await self.async_handler(payload)
            else:
                loop = asyncio.get_running_loop()
                reply = await loop.run_in_executor(None, self.handler,
                                                   payload)
        except asyncio.CancelledError:
            raise
        except Exception:  # noqa: BLE001 — handler broke its bytes-out
            # contract; close the channel so the broker fails fast and
            # fails over, instead of letting one request hang forever
            writer.close()
            return
        try:
            # the write lock keeps frames atomic when replies from many
            # tasks interleave on one connection
            async with write_lock:
                write_frame2(writer, corr, reply)
                await writer.drain()
        except (ConnectionError, OSError):
            pass        # client went away; its broker timed out already


class ServerConnection:
    """One persistent multiplexed connection to a server (broker side).

    Many requests may be in flight at once: each send registers a future
    in the pending map keyed by a fresh correlation id, and a single
    reader task completes futures as replies arrive — out of order is
    fine. A timeout or cancellation abandons ONE future (the late reply
    is discarded by id); only a transport error tears the connection
    down, failing every pending request so callers can fail over.
    """

    def __init__(self, host: str, port: int):
        self.host = host
        self.port = port
        self._reader: Optional[asyncio.StreamReader] = None
        self._writer: Optional[asyncio.StreamWriter] = None
        self._reader_task: Optional[asyncio.Task] = None
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._pending: Dict[int, asyncio.Future] = {}
        self._corr = itertools.count(1)     # never reset: ids stay unique
        self._conn_lock = asyncio.Lock()    # guards connect/teardown
        self._write_lock = asyncio.Lock()   # keeps request frames atomic

    @property
    def num_pending(self) -> int:
        return len(self._pending)

    async def _ensure(self) -> None:
        async with self._conn_lock:
            self._loop = asyncio.get_running_loop()
            if self._writer is None or self._writer.is_closing():
                self._reader, self._writer = await asyncio.open_connection(
                    self.host, self.port)
                self._reader_task = asyncio.ensure_future(
                    self._read_loop(self._reader, self._writer))

    async def _read_loop(self, reader: asyncio.StreamReader,
                         writer: asyncio.StreamWriter) -> None:
        try:
            while True:
                frame = await read_frame(reader)
                corr = _CORR.unpack_from(frame, 0)[0]
                fut = self._pending.pop(corr, None)
                # the payload rides as a memoryview over the (immutable
                # bytes) frame — handed straight to the zero-copy
                # DataTable decoder, which aliases it safely
                payload = memoryview(frame)[8:]
                if fut is not None and not fut.done():
                    fut.set_result(payload)
                # unknown/done id: a reply that outlived its timeout —
                # dropped here, which is what keeps the stream in sync
        except asyncio.CancelledError:
            raise
        except Exception as e:  # noqa: BLE001 — conn reset/EOF/bad frame
            self._fail_pending(ConnectionError(
                f"connection to {self.host}:{self.port} lost: {e}"))
        finally:
            if self._writer is writer:
                self._writer = None
                self._reader = None
            writer.close()

    def _fail_pending(self, exc: BaseException) -> None:
        pending, self._pending = dict(self._pending), {}
        for fut in pending.values():
            if not fut.done():
                fut.set_exception(exc)

    async def request(self, payload: bytes,
                      timeout: Optional[float] = None) -> bytes:
        await self._ensure()
        corr = next(self._corr)
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        self._pending[corr] = fut
        writer = None
        try:
            async with self._write_lock:
                writer = self._writer
                if writer is None or writer.is_closing():
                    raise ConnectionError(
                        f"connection to {self.host}:{self.port} closed")
                # write_frame buffers the WHOLE frame synchronously, so
                # no cancellation point can tear a frame mid-stream: a
                # cancel lands either before any byte (lock wait) or
                # after the full frame is buffered (drain)
                write_frame(writer, _CORR.pack(corr) + payload)
                await writer.drain()
        except asyncio.CancelledError:
            # caller timeout / hedge-loser cancel: abandon only THIS
            # request — the shared channel and its other in-flight
            # requests are untouched (the stream is frame-whole)
            self._pending.pop(corr, None)
            if fut.done() and not fut.cancelled():
                fut.exception()     # consume: nobody will await this fut
            raise
        except BaseException:
            # a real transport error: the connection is broken — drop
            # it so the next request reconnects; pending peers fail over
            self._pending.pop(corr, None)
            if fut.done() and not fut.cancelled():
                fut.exception()     # consume: nobody will await this fut
            await self._teardown(writer)
            raise
        try:
            return await asyncio.wait_for(fut, timeout)
        finally:
            # timeout/cancel abandons only THIS request; the connection
            # and every other in-flight request stay live
            self._pending.pop(corr, None)

    async def _teardown(self, failed_writer=None) -> None:
        """Drop the connection. `failed_writer` scopes the teardown to
        the connection the caller actually failed on: if a concurrent
        request already reconnected (self._writer moved on), tearing
        down the CURRENT connection would fail its fresh in-flight
        requests for no reason — skip instead. None = unconditional
        (explicit close)."""
        async with self._conn_lock:
            if failed_writer is not None and \
                    self._writer is not failed_writer:
                return
            writer, self._writer, self._reader = self._writer, None, None
            if self._reader_task is not None:
                self._reader_task.cancel()
                self._reader_task = None
            if writer is not None:
                writer.close()
            self._fail_pending(ConnectionError(
                f"connection to {self.host}:{self.port} reset"))

    async def close(self) -> None:
        await self._teardown()

    def close_threadsafe(self) -> Optional["asyncio.Future"]:
        """Schedule close() from any thread (no running loop needed);
        returns the scheduling future, or None if never connected."""
        loop = self._loop
        if loop is None or loop.is_closed():
            return None
        import concurrent.futures
        try:
            return asyncio.run_coroutine_threadsafe(self.close(), loop)
        except (RuntimeError, concurrent.futures.CancelledError):
            return None


class EventLoopThread:
    """A dedicated asyncio loop on a daemon thread (for sync call sites)."""

    def __init__(self):
        self.loop = asyncio.new_event_loop()
        self._thread = threading.Thread(target=self.loop.run_forever,
                                        daemon=True)
        self._thread.start()

    def run(self, coro, timeout: Optional[float] = None):
        fut = asyncio.run_coroutine_threadsafe(coro, self.loop)
        return fut.result(timeout)

    def stop(self) -> None:
        self.loop.call_soon_threadsafe(self.loop.stop)
        self._thread.join(timeout=5)
        if not self.loop.is_running() and not self.loop.is_closed():
            self.loop.close()
