"""The host twin, the pruner and the executor's routing, against the JAX
package.

Segments are written by the JAX SegmentCreator (tests/fixtures.py) and
loaded by both packages. The port's host_exec.execute_host gives the
blocks the JAX one gives (aggregation intermediates, group maps with
DISTINCTCOUNT sets and MV keys, selection rows) on the same requests; the
port's SegmentPrunerService keeps the segments the JAX one keeps, on
segments with disjoint yearID ranges and on segments partitioned by
each of the four partition functions (whose hashes equal the JAX
package's value for value); and the executor takes the host twin only
where the planner refuses a segment as the JAX planner does
(UnsupportedOnDevice, GroupsLimitExceeded), never for a shape the JAX
planner runs on its device (MV, valuein and expression group keys, HLL,
expression and MV aggregations all plan for the device and answer as the
JAX engine does), and never when a kernel raises. An expression filter
over a dictionary column runs on the device path, as in the JAX
planner.
"""
from __future__ import annotations

import numpy as np
import pytest

from fixtures import TEAMS, make_columns, make_schema, make_table_config
from pinot_tpu.common import partition as jax_partition
from pinot_tpu.engine import QueryEngine as JaxQueryEngine
from pinot_tpu.pql.optimizer import BrokerRequestOptimizer as JaxOptimizer
from pinot_tpu.pql.parser import compile_pql as jax_compile
from pinot_tpu.query import host_exec as jax_host
from pinot_tpu.query.pruner import SegmentPrunerService as JaxPruner
from pinot_tpu.segment.creator import SegmentCreator
from pinot_tpu.segment.loader import ImmutableSegmentLoader as JaxLoader
from pinot_tpu_torch.common import partition
from pinot_tpu_torch.engine import QueryEngine
from pinot_tpu_torch.ops import kernels as tk
from pinot_tpu_torch.pql.optimizer import BrokerRequestOptimizer
from pinot_tpu_torch.pql.parser import compile_pql
from pinot_tpu_torch.query import host_exec
from pinot_tpu_torch.query.executor import ServerQueryExecutor
from pinot_tpu_torch.query.plan import InstancePlanMaker, \
    UnsupportedOnDevice
from pinot_tpu_torch.query.execution import execute_segment_plan
from pinot_tpu_torch.query.pruner import SegmentPrunerService
from pinot_tpu_torch.segment.loader import ImmutableSegmentLoader

#: segment i holds yearID in [1990 + 10 i, 2000 + 10 i)
YEAR_BANDS = ((1990, 2000), (2000, 2010), (2010, 2020))


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    out = []
    for i, (lo, hi) in enumerate(YEAR_BANDS):
        cols = make_columns(2000, seed=30 + i)
        cols["yearID"] = np.random.default_rng(i).integers(
            lo, hi, 2000).astype(np.int32)
        d = str(tmp_path_factory.mktemp(f"band{i}"))
        SegmentCreator(make_schema(), make_table_config(),
                       segment_name=f"band_{i}").build(cols, d)
        out.append(d)
    return out


@pytest.fixture(scope="module")
def engines(dirs):
    return JaxQueryEngine.from_dirs(dirs), \
        QueryEngine.from_dirs(dirs, device="cpu")


def _requests(pql):
    return (JaxOptimizer().optimize(jax_compile(pql)),
            BrokerRequestOptimizer().optimize(compile_pql(pql)))


HOST_PQLS = {
    "aggregation": "SELECT COUNT(*), SUM(runs), MIN(salary), MAX(average), "
                   "DISTINCTCOUNT(teamID), PERCENTILE90(hits), AVG(hits), "
                   "MINMAXRANGE(runs) FROM baseballStats WHERE yearID >= "
                   "2005 AND position = 'P'",
    "group_distinctcount": "SELECT DISTINCTCOUNT(playerName), SUM(salary), "
                           "COUNT(*) FROM baseballStats WHERE runs > 50 "
                           "GROUP BY teamID, league TOP 100",
    "group_mv_key": "SELECT COUNT(*), MAX(hits) FROM baseballStats WHERE "
                    "league = 'NL' GROUP BY position TOP 100",
    # keys and DISTINCTCOUNT coded by dictIds (string and int
    # dictionaries), by values (a float dictionary, an expression), and
    # no matched rows
    "group_int_keys": "SELECT DISTINCTCOUNT(yearID), DISTINCTCOUNT(teamID), "
                      "MINMAXRANGE(runs) FROM baseballStats GROUP BY "
                      "league, yearID TOP 1000",
    "group_float_key": "SELECT COUNT(*), DISTINCTCOUNT(average) FROM "
                       "baseballStats WHERE runs > 100 GROUP BY average "
                       "TOP 5000",
    "group_expression_key": "SELECT DISTINCTCOUNT(playerName) FROM "
                            "baseballStats GROUP BY div(yearID, 10) TOP 100",
    "group_no_rows": "SELECT DISTINCTCOUNT(teamID), COUNT(*) FROM "
                     "baseballStats WHERE yearID > 2030 GROUP BY teamID "
                     "TOP 100",
    "selection_order": "SELECT teamID, salary, position FROM baseballStats "
                       "WHERE league = 'AL' ORDER BY salary DESC, "
                       "playerName LIMIT 30",
    "selection_limit": "SELECT * FROM baseballStats WHERE runs < 3 "
                       "LIMIT 10",
    "regexp_raw": "SELECT COUNT(*), SUM(hits) FROM baseballStats WHERE "
                  "REGEXP_LIKE(playerName, 'player_1.*') OR salary > "
                  "900000.5",
}


@pytest.mark.parametrize("name", sorted(HOST_PQLS))
def test_execute_host_matches_jax(dirs, name):
    jreq, treq = _requests(HOST_PQLS[name])
    for d in dirs:
        want = jax_host.execute_host(JaxLoader.load(d), jreq)
        got = host_exec.execute_host(ImmutableSegmentLoader.load(d), treq)
        assert got.agg_intermediates == want.agg_intermediates
        assert got.group_map == want.group_map
        assert got.selection_rows == want.selection_rows
        assert got.selection_columns == want.selection_columns
        assert got.selection_display_cols == want.selection_display_cols
        assert got.stats.num_docs_scanned == want.stats.num_docs_scanned
        assert got.stats.num_entries_scanned_in_filter == \
            want.stats.num_entries_scanned_in_filter


PRUNE_PQLS = [
    "SELECT COUNT(*) FROM baseballStats WHERE yearID < 1995",
    "SELECT COUNT(*) FROM baseballStats WHERE yearID BETWEEN 2003 AND 2004",
    "SELECT COUNT(*) FROM baseballStats WHERE yearID = 2015 OR yearID = 1991",
    "SELECT COUNT(*) FROM baseballStats WHERE yearID > 2030",
    "SELECT COUNT(*) FROM baseballStats WHERE yearID >= 2010 AND runs > 5",
    "SELECT COUNT(*) FROM baseballStats WHERE teamID = 'ZZZ'",
    "SELECT COUNT(*) FROM baseballStats WHERE runs > 10",
    "SELECT runs FROM baseballStats WHERE yearID <= 2000 LIMIT 5",
]


@pytest.mark.parametrize("pql", PRUNE_PQLS)
def test_pruner_matches_jax(dirs, pql):
    jreq, treq = _requests(pql)
    jsegs = [JaxLoader.load(d) for d in dirs]
    tsegs = [ImmutableSegmentLoader.load(d, device="cpu") for d in dirs]
    want = [s.segment_name for s in JaxPruner().prune(jsegs, jreq)]
    got = [s.segment_name for s in SegmentPrunerService().prune(tsegs, treq)]
    assert got == want
    blk = ServerQueryExecutor().execute(treq, tsegs)
    assert blk.stats.num_segments_pruned == len(dirs) - len(got)


def test_pruned_queries_answer_like_jax(engines):
    jax_engine, port = engines
    for pql in PRUNE_PQLS:
        got, want = port.query(pql), jax_engine.query(pql)
        if want.selection_results is not None:
            assert got.selection_results.results == \
                want.selection_results.results, pql
        else:
            assert [a.value for a in got.aggregation_results] == \
                [a.value for a in want.aggregation_results], pql


def test_executor_routes_refusals_to_host(engines):
    jax_engine, port = engines
    cases = {
        # (pql, where each of the three segments ended)
        "scan": ("SELECT SUM(runs) FROM baseballStats WHERE runs > 70",
                 (0, 0, 3, 0)),
        # the inverted index answers COUNT(*) over one teamID IN leaf
        "inverted": ("SELECT COUNT(*) FROM baseballStats WHERE teamID IN "
                     "('BOS', 'NYA', 'TOR')", (0, 3, 0, 0)),
        "host": ("SELECT DISTINCTCOUNT(playerName) FROM baseballStats "
                 "GROUP BY league TOP 10", (0, 0, 0, 3)),
        # segment 0 holds only years before 2000: pruned
        "selection": ("SELECT playerName, runs FROM baseballStats WHERE "
                      "yearID >= 2000 ORDER BY runs DESC LIMIT 7",
                      (1, 0, 2, 0)),
    }
    for name, (pql, paths) in cases.items():
        port.executor.reset_path_counts()
        got = port.query(pql)
        assert port.executor.path_counts == dict(zip(
            ("pruned", "fast", "scan", "host"), paths)), name
        want = jax_engine.query(pql)
        if want.selection_results is not None:
            assert got.selection_results.results == \
                want.selection_results.results, name
        else:
            assert [(a.value, a.group_by_result) for a in
                    got.aggregation_results] == \
                [(a.value, a.group_by_result) for a in
                 want.aggregation_results], name


def test_groups_limit_goes_to_host(engines, dirs):
    jax_engine, port = engines
    pql = "SELECT COUNT(*), SUM(hits) FROM baseballStats WHERE runs < 20 " \
        "GROUP BY playerName, teamID TOP 5000"
    small = ServerQueryExecutor(InstancePlanMaker(num_groups_limit=100))
    _jreq, treq = _requests(pql)
    blk = small.execute(treq, port.segments)
    assert small.path_counts == {"pruned": 0, "fast": 0, "scan": 0,
                                 "host": 3}
    port.executor.reset_path_counts()
    assert blk.group_map == port.executor.execute(treq, port.segments) \
        .group_map
    assert port.executor.path_counts["scan"] == 3
    resp = port.query(pql)
    want = jax_engine.query(pql)
    assert resp.aggregation_results[0].group_by_result == \
        want.aggregation_results[0].group_by_result


def test_kernel_failure_is_not_caught(engines, monkeypatch):
    _jax, port = engines

    def broken(*_args, **_kw):
        raise RuntimeError("masked_select: kernel launch failed")

    monkeypatch.setattr(tk, "masked_select", broken)
    port.executor.reset_path_counts()
    with pytest.raises(RuntimeError, match="kernel launch failed"):
        port.query("SELECT runs FROM baseballStats ORDER BY runs LIMIT 3")
    assert port.executor.path_counts["host"] == 0


def test_engine_refuses_vector_join_window(engines, monkeypatch):
    _jax, port = engines
    called = []
    monkeypatch.setattr(host_exec, "execute_host",
                        lambda *a: called.append(a))
    # a window is multi-stage: QueryEngine has no stage plane (nor does
    # the JAX one) and raises the typed stage error, before the executor
    from pinot_tpu_torch.query.stages.errors import StageCompileError
    with pytest.raises(StageCompileError):
        port.query("SELECT teamID, ROW_NUMBER() OVER (PARTITION BY teamID "
                   "ORDER BY runs) FROM baseballStats LIMIT 5")
    assert not called


#: shapes the JAX planner runs on its device, which were port gaps
#: (NotPorted) before K3's MV / rawoff keys, K4's entry histogram and K7:
#: they plan for the device and never reach the host twin
PORT_GAPS = {
    "mv_group_key": "SELECT COUNT(*) FROM baseballStats GROUP BY position "
                    "TOP 10",
    "valuein_group_key": "SELECT SUM(runs) FROM baseballStats GROUP BY "
                         "valuein(position, 'P', 'C') TOP 10",
    "expression_group_key": "SELECT SUM(runs) FROM baseballStats GROUP BY "
                            "datetime_convert(yearID,'1:DAYS:EPOCH',"
                            "'1:DAYS:EPOCH','5:DAYS') TOP 50",
    "hll": "SELECT DISTINCTCOUNTHLL(teamID) FROM baseballStats",
    "expression_aggregation": "SELECT SUM(mult(runs,2)) FROM "
                              "baseballStats WHERE league = 'AL'",
    "mv_aggregation": "SELECT COUNTMV(position) FROM baseballStats WHERE "
                      "runs > 5",
}

#: JAX refusals, most of them on segments that also meet a port gap: the
#: refusal wins, as in the JAX planner, and the host twin answers
HOST_REFUSALS = {
    "multi_column_expression": "SELECT SUM(add(runs,hits)) FROM "
                               "baseballStats WHERE league = 'AL'",
    "mv_key_distinctcount": "SELECT DISTINCTCOUNT(playerName) FROM "
                            "baseballStats GROUP BY position TOP 10",
    "hll_in_group": "SELECT DISTINCTCOUNTHLL(playerName) FROM "
                    "baseballStats GROUP BY league TOP 10",
    "float_raw_group_key": "SELECT COUNT(*) FROM baseballStats GROUP BY "
                           "salary TOP 10",
    "expression_metric_in_group": "SELECT SUM(add(runs,hits)) FROM "
                                  "baseballStats GROUP BY league TOP 10",
}


def _answers(resp):
    if resp.selection_results is not None:
        return resp.selection_results.results
    return [(a.value, a.group_by_result) for a in resp.aggregation_results]


@pytest.mark.parametrize("name", sorted(PORT_GAPS))
def test_port_gaps_raise_without_host(engines, monkeypatch, name):
    """The former gaps: planned for the device (no NotPorted, no host
    twin) and answered as the JAX engine answers them."""
    jax_engine, port = engines
    pql = PORT_GAPS[name]
    _jreq, treq = _requests(pql)
    plan = InstancePlanMaker().make_segment_plan(port.segments[0], treq)
    assert plan.fast_path_result is None
    execute_segment_plan(plan)
    called = []
    monkeypatch.setattr(host_exec, "execute_host",
                        lambda *a: called.append(a))
    port.executor.reset_path_counts()
    got = port.query(pql)
    assert not called and port.executor.path_counts["host"] == 0
    assert port.executor.path_counts["scan"] == len(YEAR_BANDS)
    assert _answers(got) == _answers(jax_engine.query(pql))


@pytest.mark.parametrize("name", sorted(HOST_REFUSALS))
def test_jax_refusals_go_to_host(engines, name):
    jax_engine, port = engines
    pql = HOST_REFUSALS[name]
    _jreq, treq = _requests(pql)
    with pytest.raises(UnsupportedOnDevice):
        InstancePlanMaker().make_segment_plan(port.segments[0], treq)
    port.executor.reset_path_counts()
    got = port.query(pql)
    assert port.executor.path_counts["host"] == len(YEAR_BANDS)
    assert _answers(got) == _answers(jax_engine.query(pql))


EXPR_FILTER_PQLS = [
    "SELECT COUNT(*), SUM(runs) FROM baseballStats WHERE "
    "time_convert(yearID,'DAYS','HOURS') >= 48000 AND "
    "time_convert(yearID,'DAYS','HOURS') < 48240",
    "SELECT MAX(hits) FROM baseballStats WHERE add(runs,1) IN (5, 17, 90)",
    "SELECT playerName, runs FROM baseballStats WHERE mult(runs,2) > 250 "
    "ORDER BY runs DESC, playerName LIMIT 12",
    # a predicate no dictionary value meets: the empty fast path
    "SELECT COUNT(*) FROM baseballStats WHERE add(runs,1000) < 0",
]


@pytest.mark.parametrize("pql", EXPR_FILTER_PQLS)
def test_expression_filter_on_device_matches_jax(engines, pql):
    jax_engine, port = engines
    port.executor.reset_path_counts()
    got = port.query(pql)
    assert port.executor.path_counts["host"] == 0
    assert _answers(got) == _answers(jax_engine.query(pql))


# ---------------------------------------------------------------------------
# Partitioned segments
# ---------------------------------------------------------------------------

#: column → partition function; each segment holds few values of each
PARTITIONING = {"teamID": ("Murmur", 4), "playerName": ("HashCode", 8),
                "league": ("ByteArray", 2), "runs": ("Modulo", 5)}


@pytest.mark.parametrize("fname", sorted({"Murmur", "HashCode",
                                          "ByteArray", "Modulo"}))
def test_partition_functions_match_jax(fname):
    rng = np.random.default_rng(9)
    strs = TEAMS + ["", "x", "player_007", "é", "a" * 37]
    ints = [0, 1, -1, 7, 2**31 - 1, -2**31, 2**40 + 3] + \
        [int(v) for v in rng.integers(-10**6, 10**6, 40)]
    cases = [(np.dtype(object), v) for v in strs] + \
        [(np.dtype(np.int32), v) for v in ints if -2**31 <= v < 2**31] + \
        [(np.dtype(np.int64), v) for v in ints] + \
        [(np.dtype(np.int32), str(v)) for v in ints[:5]]
    if fname == "Modulo":
        cases = [c for c in cases if c[0] != object]
    for n in (1, 3, 4, 16):
        for dt, v in cases:
            assert partition.partition_of_value(fname, n, dt, v) == \
                jax_partition.partition_of_value(fname, n, dt, v), (dt, v)


@pytest.fixture(scope="module")
def partitioned_dirs(tmp_path_factory):
    cfg = make_table_config()
    cfg.indexing_config.segment_partition_config = {
        c: {"functionName": f, "numPartitions": n}
        for c, (f, n) in PARTITIONING.items()}
    out = []
    for i in range(4):
        rng = np.random.default_rng(50 + i)
        cols = make_columns(1500, seed=40 + i)
        cols["teamID"] = np.array(rng.choice(TEAMS[3 * i:3 * i + 2], 1500),
                                  dtype=object)
        cols["league"] = np.array(["AL", "NL"][i % 2:i % 2 + 1] * 1500,
                                  dtype=object)
        cols["playerName"] = np.array(
            [f"player_{v:03d}" for v in rng.integers(10 * i, 10 * i + 3,
                                                     1500)], dtype=object)
        cols["runs"] = rng.choice([i, i + 5, 2 * i + 11], 1500) \
            .astype(np.int32)
        d = str(tmp_path_factory.mktemp(f"part{i}"))
        SegmentCreator(make_schema(), cfg,
                       segment_name=f"part_{i}").build(cols, d)
        out.append(d)
    return out


PARTITION_PQLS = (
    [f"SELECT COUNT(*), SUM(hits) FROM baseballStats WHERE teamID = '{t}'"
     for t in TEAMS[:12]] +
    [f"SELECT COUNT(*) FROM baseballStats WHERE league = '{lg}'"
     for lg in ("AL", "NL")] +
    [f"SELECT MAX(hits) FROM baseballStats WHERE playerName = "
     f"'player_{v:03d}'" for v in (0, 2, 11, 21, 32, 5)] +
    [f"SELECT COUNT(*) FROM baseballStats WHERE runs = {v}"
     for v in (0, 1, 6, 13, 17, 4)] +
    ["SELECT teamID, runs FROM baseballStats WHERE teamID = 'BOS' AND "
     "runs = 11 ORDER BY runs LIMIT 5",
     "SELECT COUNT(*) FROM baseballStats WHERE teamID = 'ANA' OR "
     "league = 'NL'"])


def test_partition_pruner_matches_jax(partitioned_dirs):
    jsegs = [JaxLoader.load(d) for d in partitioned_dirs]
    tsegs = [ImmutableSegmentLoader.load(d, device="cpu")
             for d in partitioned_dirs]
    for js, ts in zip(jsegs, tsegs):
        for col in PARTITIONING:
            jm = js.data_source(col).metadata
            tm = ts.data_source(col).metadata
            assert (tm.partition_function, tm.num_partitions,
                    tm.partitions) == (jm.partition_function,
                                       jm.num_partitions, jm.partitions)
    jax_engine = JaxQueryEngine(jsegs)
    port = QueryEngine(tsegs, device="cpu")
    pruned_any = 0
    for pql in PARTITION_PQLS:
        jreq, treq = _requests(pql)
        want = [s.segment_name for s in JaxPruner().prune(jsegs, jreq)]
        got = [s.segment_name for s in
               SegmentPrunerService().prune(tsegs, treq)]
        assert got == want, pql
        pruned_any += len(tsegs) - len(got)
        assert _answers(port.query(pql)) == _answers(jax_engine.query(pql)),\
            pql
    assert pruned_any > 0
