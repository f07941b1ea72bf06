"""Concurrent clients through the port's dispatch coalescer.

Sixteen client threads, each with its own ServerConnection, send
same-shape InstanceRequests (distinct literals) to a port ServerInstance
over TCP at once. The coalescer gathers them into execute_batch chunks
of at most 8 (run_segment_kernel_batched launches each kernel once per
segment for a chunk). Every reply must equal the same request answered
alone by a port instance without the coalescer and by the JAX instance
(tests/test_torch_server.py:assert_same_table; a batched reply carries no
executionPath, as in the JAX instance), and batchedDispatches
must be positive. Also: a group past 8 members splits into chunks of 8,
and the executor's path counts stay exact under many threads switching
often.
"""
from __future__ import annotations

import sys
import threading

import numpy as np
import pytest

from fixtures import make_columns, make_schema, make_table_config

from pinot_tpu.segment.creator import SegmentCreator as JaxCreator
from pinot_tpu.segment.loader import ImmutableSegmentLoader as JaxLoader
from pinot_tpu.server import ServerInstance as JaxServerInstance
from pinot_tpu_torch.common.datatable import DataTable
from pinot_tpu_torch.common.metrics import ServerMeter, ServerTimer
from pinot_tpu_torch.ops import kernels as tk
from pinot_tpu_torch.segment.loader import ImmutableSegmentLoader
from pinot_tpu_torch.server import ServerInstance
from pinot_tpu_torch.server import instance as instance_mod
from pinot_tpu_torch.transport.tcp import EventLoopThread, ServerConnection
from test_torch_server import assert_same_table, port_bytes

TABLE = "baseballStats"
CLIENTS = 16

#: families of same-shape queries, one per client (distinct literals)
FAMILIES = {
    "aggregation": [f"SELECT COUNT(*), SUM(runs), MAX(hits) FROM "
                    f"baseballStats WHERE yearID >= {1985 + i} AND "
                    f"runs > {i}" for i in range(CLIENTS)],
    "selection": [f"SELECT playerName, runs, hits FROM baseballStats "
                  f"WHERE hits > {20 + 3 * i} ORDER BY runs DESC, "
                  f"playerName LIMIT {5 + i}" for i in range(CLIENTS)],
    "mixed": [f"SELECT SUM(salary) FROM baseballStats WHERE "
              f"yearID < {2015 - i} GROUP BY league TOP 10"
              if i % 2 else
              f"SELECT COUNT(*) FROM baseballStats WHERE league = 'AL' "
              f"AND runs >= {i}" for i in range(CLIENTS)],
}


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    out = []
    for i in range(3):
        d = str(tmp_path_factory.mktemp(f"coal{i}"))
        JaxCreator(make_schema(), make_table_config(),
                   segment_name=f"coal_{i}").build(
            make_columns(3000, seed=120 + i), d)
        out.append(d)
    return out


def _port(dirs, **kw) -> ServerInstance:
    srv = ServerInstance(device="cpu", **kw)
    tdm = srv.data_manager.table(TABLE, create=True)
    for d in dirs:
        tdm.add_segment(ImmutableSegmentLoader.load(d))
    return srv


@pytest.fixture(scope="module")
def references(dirs):
    """(port instance without the coalescer, JAX instance)."""
    seq = _port(dirs, batch_window_ms=0)
    jax = JaxServerInstance(batch_window_ms=0)
    tdm = jax.data_manager.table(TABLE, create=True)
    for d in dirs:
        tdm.add_segment(JaxLoader.load(d))
    yield seq, jax
    seq.stop()
    jax.stop()


@pytest.fixture
def batched_calls(monkeypatch):
    """Members of each run_segment_kernel_batched call."""
    calls = []
    real = tk.run_segment_kernel_batched

    def spy(*args, **kw):
        calls.append(len(args[5]))
        return real(*args, **kw)

    monkeypatch.setattr(tk, "run_segment_kernel_batched", spy)
    return calls


def _concurrent(port: int, payloads):
    """Each payload from its own thread and connection, all released at
    once; the replies in payload order."""
    loop = EventLoopThread()
    conns = [ServerConnection("127.0.0.1", port) for _ in payloads]
    replies = [None] * len(payloads)
    errors = []
    start = threading.Barrier(len(payloads))

    def client(i):
        try:
            start.wait(10)
            replies[i] = loop.run(conns[i].request(payloads[i], timeout=60),
                                  timeout=90)
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(e)

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(len(payloads))]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
        assert not any(t.is_alive() for t in threads)
        assert not errors, errors
    finally:
        for c in conns:
            loop.run(c.close())
        loop.stop()
    return replies


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_concurrent_clients_coalesce_and_match(dirs, references,
                                               batched_calls, family):
    seq, jax = references
    srv = _port(dirs, batch_window_ms=200, num_workers=4)
    try:
        port = srv.start(port=0)
        payloads = [port_bytes(pql, 1000 + i)
                    for i, pql in enumerate(FAMILIES[family])]
        replies = _concurrent(port, payloads)
        for raw, payload in zip(replies, payloads):
            got = DataTable.from_bytes(raw)
            assert not got.exceptions, got.exceptions
            for ref in (seq, jax):
                assert_same_table(got, ref.handle_request_bytes(payload),
                                  ignore=("executionPath",))
        assert srv.metrics.meter(ServerMeter.BATCHED_DISPATCHES).count > 0
        assert srv.metrics.timer(ServerTimer.BATCH_OCCUPANCY).count > 0
        # batched launches served several members, never more than 8
        assert batched_calls and max(batched_calls) > 1
        assert max(batched_calls) <= tk.MAX_BATCH
    finally:
        srv.stop()


def test_groups_past_eight_split_into_chunks(dirs, monkeypatch):
    """A sealed group of 11 members runs as chunks of 8 and 3; each
    member's reply equals its own execution."""
    srv = _port(dirs, batch_window_ms=5)
    chunks = []
    real = srv.executor.execute_batch

    def spy(requests, waits, deadline):
        chunks.append(len(requests))
        return real(requests, waits, deadline)

    monkeypatch.setattr(srv.executor, "execute_batch", spy)
    try:
        from pinot_tpu_torch.common.serde import instance_request_from_bytes
        tickets = [instance_mod._BatchTicket(instance_request_from_bytes(
            port_bytes(FAMILIES["aggregation"][i], 50 + i)), 0.0)
            for i in range(11)]
        srv._run_batch(tickets, None)
        assert chunks == [tk.MAX_BATCH, 3]
        for t in tickets:
            alone = srv.executor.execute(t.request)
            got = t.future.result(timeout=5)
            assert got.rows == alone.rows
    finally:
        srv.stop()


def test_path_counts_exact_under_concurrent_queries(dirs):
    """32 threads (more than the cores), each running its queries through
    one ServerQueryExecutor with the interpreter switching threads every
    microsecond: no update of the path counts is lost."""
    srv = _port(dirs, batch_window_ms=0)
    ex = srv.executor.executor
    ex.reset_path_counts()
    segs = [sdm.segment.to("cpu") for sdm in
            srv.data_manager.table(TABLE).acquire_segments(None)[0]]
    from pinot_tpu_torch.pql.parser import compile_pql
    reqs = [compile_pql(p) for p in FAMILIES["aggregation"][:4]]
    errors = []

    def worker():
        try:
            for r in reqs:
                ex.execute(r, segs)
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker) for _ in range(32)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
        srv.stop()
    assert not errors, errors
    counts = dict(ex.path_counts)
    assert sum(counts.values()) == 32 * len(reqs) * len(segs), counts
    assert np.all(np.asarray(list(counts.values())) >= 0)
