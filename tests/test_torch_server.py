"""The port's query server against the JAX one (tests/test_server.py:
118-300): schedulers, the request path (bytes in, DataTable bytes out),
over TCP, and the instance executor's stacked path with its fallback.

Both instances serve the same segment directories (built by the JAX
creator, loaded by each package's own loader) and get the same
InstanceRequest bytes; their decoded DataTables must be equal: the kind,
columns, exceptions and metadata (timings and the profile aside), integers
exactly and floats to rtol 1e-9 (x64 on the JAX side). The port's
instance runs with device="cpu" (the kernels' plain versions).
"""
from __future__ import annotations

import threading

import numpy as np
import pytest
import torch

from fixtures import build_segment, make_schema, make_table_config
from oracle import Oracle

from pinot_tpu.common.serde import instance_request_to_bytes as jax_to_bytes
from pinot_tpu.common.request import InstanceRequest as JaxInstanceRequest
from pinot_tpu.parallel import make_mesh as jax_make_mesh
from pinot_tpu.pql.parser import compile_pql as jax_compile
from pinot_tpu.realtime.mutable_segment import \
    MutableSegmentImpl as JaxMutableSegment
from pinot_tpu.server import ServerInstance as JaxServerInstance
from pinot_tpu.server.data_manager import \
    InstanceDataManager as JaxDataManager
from pinot_tpu.server.query_executor import \
    InstanceQueryExecutor as JaxInstanceExecutor
from pinot_tpu_torch.common.datatable import DataTable
from pinot_tpu_torch.common.request import InstanceRequest
from pinot_tpu_torch.common.schema import Schema
from pinot_tpu_torch.common.serde import instance_request_to_bytes
from pinot_tpu_torch.common.table_config import TableConfig
from pinot_tpu_torch.parallel import make_mesh
from pinot_tpu_torch.pql.parser import compile_pql
from pinot_tpu_torch.query.reduce import BrokerReduceService
from pinot_tpu_torch.realtime.mutable_segment import MutableSegmentImpl
from pinot_tpu_torch.segment.loader import ImmutableSegmentLoader
from pinot_tpu_torch.server import ServerInstance, make_scheduler
from pinot_tpu_torch.server.data_manager import InstanceDataManager
from pinot_tpu_torch.server.query_executor import InstanceQueryExecutor
from pinot_tpu_torch.transport.tcp import EventLoopThread, ServerConnection

TABLE = "baseballStats"
#: metadata that differs between two runs of one query
VOLATILE = ("timeUsedMs", "profileInfo", "traceInfo")
#: a query timeout (ms) that no CPU run reaches: the two instances time
#: their queries apart, so under a loaded machine a 15 s default could
#: flag one side alone with QueryTimeoutError
NO_TIMEOUT_MS = 600_000.0


def same_value(a, b) -> bool:
    """Integers (and strings) exactly, floats to rtol 1e-9, recursively
    through the tuples and sets of intermediate results."""
    if isinstance(a, (tuple, list)) and isinstance(b, (tuple, list)):
        return len(a) == len(b) and all(map(same_value, a, b))
    if isinstance(a, dict) and isinstance(b, dict):
        return a.keys() == b.keys() and all(same_value(a[k], b[k])
                                            for k in a)
    if isinstance(a, (float, np.floating)) or \
            isinstance(b, (float, np.floating)):
        return bool(np.isclose(float(a), float(b), rtol=1e-9, atol=0.0) or
                    (np.isnan(float(a)) and np.isnan(float(b))))
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return np.array_equal(np.asarray(a), np.asarray(b))
    return a == b


def assert_same_table(port: DataTable, jax_bytes: bytes,
                      ignore=()) -> None:
    """The port's DataTable equals the JAX instance's reply (metadata
    keys in `ignore` aside too)."""
    want = DataTable.from_bytes(jax_bytes)
    assert port.kind == want.kind
    assert port.columns == want.columns
    assert port.exceptions == want.exceptions
    strip = lambda m: {k: v for k, v in m.items()     # noqa: E731
                       if k not in VOLATILE + tuple(ignore)}
    assert strip(port.metadata) == strip(want.metadata)
    assert len(port.rows) == len(want.rows)
    got = sorted(port.rows, key=repr) if port.kind == 2 else port.rows
    exp = sorted(want.rows, key=repr) if want.kind == 2 else want.rows
    for g, w in zip(got, exp):
        assert same_value(tuple(g), tuple(w)), (g, w)


def port_bytes(pql: str, request_id: int = 1, segments=None) -> bytes:
    """InstanceRequest bytes as the JAX broker writes them (the port's
    serde is a copy: the port reads them, and its own bytes are equal)."""
    raw = jax_to_bytes(JaxInstanceRequest(
        request_id=request_id, query=jax_compile(pql),
        search_segments=segments))
    assert raw == instance_request_to_bytes(InstanceRequest(
        request_id=request_id, query=compile_pql(pql),
        search_segments=segments))
    return raw


# -- schedulers (tests/test_server.py:118-147) ------------------------------

@pytest.mark.parametrize("algo", ["fcfs", "bounded_fcfs", "tokenbucket"])
def test_scheduler_runs_every_query_and_raises_errors(algo):
    sched = make_scheduler(algo, num_workers=2)
    try:
        futures = [sched.submit("t", lambda i=i: i * i) for i in range(8)]
        assert sorted(f.result(timeout=5) for f in futures) == \
            [i * i for i in range(8)]
        err = sched.submit("t", lambda: 1 / 0)
        with pytest.raises(ZeroDivisionError):
            err.result(timeout=5)
    finally:
        sched.shutdown()


def test_fcfs_runs_in_arrival_order_on_one_worker():
    sched = make_scheduler("fcfs", num_workers=1)
    release = threading.Event()
    order = []
    try:
        blocked = sched.submit("t", lambda: release.wait(5))
        futs = [sched.submit(g, lambda i=i: order.append(i))
                for i, g in enumerate(["a", "b", "a", "c"])]
        release.set()
        for f in futs + [blocked]:
            f.result(timeout=5)
    finally:
        sched.shutdown()
    assert order == [0, 1, 2, 3]


def test_tokenbucket_prefers_higher_token_group():
    sched = make_scheduler("tokenbucket", num_workers=1)
    release = threading.Event()
    try:
        blocked = sched.submit("warm", lambda: release.wait(5))
        sched.queue.group("hog").available_tokens = -1e6
        sched.queue.group("idle").available_tokens = 100.0
        order = []
        f_hog = sched.submit("hog", lambda: order.append("hog"))
        f_idle = sched.submit("idle", lambda: order.append("idle"))
        release.set()
        f_hog.result(timeout=5)
        f_idle.result(timeout=5)
        blocked.result(timeout=5)
    finally:
        sched.shutdown()
    assert order == ["idle", "hog"]


# -- the request path, both instances ----------------------------------------

@pytest.fixture(scope="module")
def servers(tmp_path_factory):
    """(port instance, JAX instance, oracle) over three segments."""
    base = tmp_path_factory.mktemp("srv")
    dirs, all_cols = [], []
    for i in range(3):
        d = str(base / f"seg{i}")
        _seg, cols = build_segment(d, n=2000, seed=50 + i, name=f"bs_{i}")
        dirs.append(d)
        all_cols.append(cols)
    merged = {k: (np.concatenate([c[k] for c in all_cols])
                  if isinstance(all_cols[0][k], np.ndarray)
                  else sum((c[k] for c in all_cols), []))
              for k in all_cols[0]}
    from pinot_tpu.segment.loader import ImmutableSegmentLoader as JaxLoader
    port = ServerInstance("server_0", device="cpu")
    jax = JaxServerInstance("server_0")
    port.executor.default_timeout_ms = NO_TIMEOUT_MS
    jax.executor.default_timeout_ms = NO_TIMEOUT_MS
    for d in dirs:
        port.data_manager.table(TABLE, create=True).add_segment(
            ImmutableSegmentLoader.load(d))
        jax.data_manager.table(TABLE, create=True).add_segment(
            JaxLoader.load(d))
    yield port, jax, Oracle(merged)
    port.stop()
    jax.stop()


#: (pql, search segments) the two instances answer alike
CASES = {
    "aggregation": ("SELECT COUNT(*), SUM(runs) FROM baseballStats "
                    "WHERE yearID >= 2005", None),
    "search_segments": ("SELECT COUNT(*) FROM baseballStats",
                        ["bs_0", "bs_2"]),
    "missing_segments": ("SELECT COUNT(*) FROM baseballStats",
                         ["bs_0", "gone_1"]),
    "unknown_table": ("SELECT COUNT(*) FROM nope", None),
    "group_by": ("SELECT AVG(hits), MAX(salary) FROM baseballStats WHERE "
                 "league = 'AL' GROUP BY teamID TOP 500", None),
    "selection": ("SELECT playerName, runs FROM baseballStats WHERE "
                  "runs > 50 ORDER BY runs DESC, playerName LIMIT 20", None),
    "host_twin": ("SELECT DISTINCTCOUNT(playerName) FROM baseballStats "
                  "GROUP BY league TOP 10", None),
    "mv": ("SELECT COUNT(*) FROM baseballStats WHERE position = 'P'",
           None),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_request_bytes_equal_jax_instance(servers, name):
    port, jax, _oracle = servers
    pql, segs = CASES[name]
    raw = port_bytes(pql, 11, segs)
    assert_same_table(DataTable.from_bytes(port.handle_request_bytes(raw)),
                      jax.handle_request_bytes(raw))


def test_aggregation_matches_oracle(servers):
    port, _jax, oracle = servers
    m = oracle.mask(lambda r: r["yearID"] >= 2005)
    dt = DataTable.from_bytes(port.handle_request_bytes(
        port_bytes(CASES["aggregation"][0], 1)))
    blk = dt.to_block()
    assert blk.agg_intermediates[0] == oracle.count(m)
    assert blk.agg_intermediates[1] == pytest.approx(oracle.sum("runs", m))
    assert blk.stats.num_segments_processed == 3
    assert dt.metadata["requestId"] == "1"


def test_search_and_missing_segments(servers):
    port, _jax, _oracle = servers
    pql = "SELECT COUNT(*) FROM baseballStats"
    dt = DataTable.from_bytes(port.handle_request_bytes(
        port_bytes(pql, 2, ["bs_0", "bs_2"])))
    assert dt.to_block().agg_intermediates[0] == 4000
    dt = DataTable.from_bytes(port.handle_request_bytes(
        port_bytes(pql, 3, ["bs_0", "gone_1"])))
    assert any("SegmentMissingError" in e for e in dt.exceptions)
    assert dt.to_block().agg_intermediates[0] == 2000
    dt = DataTable.from_bytes(port.handle_request_bytes(
        port_bytes("SELECT COUNT(*) FROM nope", 4)))
    assert any("TableDoesNotExistError" in e for e in dt.exceptions)


def test_over_tcp_equals_jax_and_oracle(servers):
    """The port's QueryServer answers over a ServerConnection what the
    JAX instance answers in process; the reduced group-by meets the
    oracle."""
    port, jax, oracle = servers
    tcp_port = port.start(port=0)
    loop = EventLoopThread()
    conn = ServerConnection("127.0.0.1", tcp_port)
    try:
        for i, name in enumerate(sorted(CASES)):
            pql, segs = CASES[name]
            raw = port_bytes(pql, 100 + i, segs)
            got = DataTable.from_bytes(
                loop.run(conn.request(raw, timeout=30)))
            assert_same_table(got, jax.handle_request_bytes(raw))
        pql = CASES["group_by"][0]
        got = DataTable.from_bytes(loop.run(conn.request(
            port_bytes(pql, 7), timeout=30)))
        resp = BrokerReduceService().reduce(compile_pql(pql),
                                            [got.to_block()])
        m = oracle.mask(lambda r: r["league"] == "AL")
        expected = oracle.group_by(["teamID"], m, ("avg", "hits"))
        values = {tuple(g["group"]): float(g["value"])
                  for g in resp.aggregation_results[0].group_by_result}
        for k, v in expected.items():
            assert values[k] == pytest.approx(v), k
    finally:
        loop.run(conn.close())
        loop.stop()


# -- the stacked path and its fallback (tests/test_server.py:251-300) --------

def test_instance_executor_records_sharded_and_fallback_paths(tmp_path):
    """With a mesh, three independently built segments run stacked; a
    consuming segment in the set sends the query down the per-segment
    path. Both answers equal the JAX executor's on the same set."""
    dm, jdm = InstanceDataManager(), JaxDataManager()
    tdm, jtdm = dm.table(TABLE, create=True), jdm.table(TABLE, create=True)
    for i in range(3):
        d = str(tmp_path / f"p{i}")
        jseg, _cols = build_segment(d, n=2048, seed=70 + i, name=f"path_{i}")
        tdm.add_segment(ImmutableSegmentLoader.load(d))
        jtdm.add_segment(jseg)
    ex = InstanceQueryExecutor(dm, mesh=make_mesh(["cpu"]), device="cpu",
                               default_timeout_ms=NO_TIMEOUT_MS)
    jex = JaxInstanceExecutor(jdm, mesh=jax_make_mesh(),
                              default_timeout_ms=NO_TIMEOUT_MS)
    pql = ("SELECT COUNT(*), SUM(runs) FROM baseballStats "
           "WHERE yearID >= 1990")

    def ask():
        got = ex.execute(InstanceRequest(request_id=9,
                                         query=compile_pql(pql)))
        want = jex.execute(JaxInstanceRequest(request_id=9,
                                              query=jax_compile(pql)))
        assert_same_table(got, want.to_bytes())
        return got

    first = ask()
    assert first.metadata["executionPath"] == "sharded"
    row = {"teamID": "BOS", "league": "AL", "playerName": "x",
           "position": ["P"], "runs": 7, "hits": 3, "average": 0.3,
           "salary": 1.0, "yearID": 1999}
    mseg = MutableSegmentImpl(
        Schema.from_json_str(make_schema().to_json_str()),
        TableConfig.from_json_str(make_table_config().to_json_str()),
        "cons_path")
    jmseg = JaxMutableSegment(make_schema(), make_table_config(),
                              "cons_path")
    mseg.index_row(row)
    jmseg.index_row(row)
    # each segment stamps its wall clock's millisecond at index_row, and
    # the replies carry it as minConsumingFreshnessTimeMs: give both the
    # same instant, or a millisecond boundary between the two calls (a
    # few percent of runs, more on a loaded machine) parts them
    mseg.last_indexed_time_ms = jmseg.last_indexed_time_ms
    tdm.add_segment(mseg)
    jtdm.add_segment(jmseg)
    dt = ask()
    assert dt.metadata["executionPath"] == "sequential"
    assert dt.to_block().agg_intermediates[0] == \
        first.to_block().agg_intermediates[0] + 1


def test_instance_binds_segments_to_its_device(servers):
    port, _jax, _oracle = servers
    tdm = port.data_manager.table(TABLE)
    acquired, _ = tdm.acquire_segments(None)
    try:
        assert {s.segment.device for s in acquired} == \
            {torch.device("cpu")}
    finally:
        for sdm in acquired:
            tdm.release_segment(sdm)
