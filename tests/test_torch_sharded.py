"""The port's stacked multi-segment path against the JAX sharded path.

(a) Kernels: ops/kernels.py:run_stacked_kernel (plain versions, on the
CPU) against the JAX package's get_sharded_kernel on the 8 virtual CPU
devices of conftest.py, key by key, on stacks of 8 and of 5 segments of
8,192 rows made from a seed (the JAX stack of 5 is padded to 8 with empty
segments, so only its first 5 rows of each "stack" output count). Integer
outputs and min / max are equal; float64 sums (csums, vsum) agree to
rtol 1e-12 (both sum in float64, in different orders); the port folds
gagg{i}.psums exactly into int64, which must equal the JAX per-segment
tables summed over the segment axis in int64. (b) The same for the lanes
StackedSegments builds from independently written segments (union
dictionaries) and the plans made against each package's union view.
(c) Engines: the port's QueryEngine(..., mesh=make_mesh(["cpu"])), the
JAX QueryEngine(..., mesh=make_mesh()) and the port's sequential engine
answer the same queries over segments that one creator (the JAX
package's) wrote to disk and each package's loader loaded: equal rows,
float values within rel 1e-12, equal numDocsScanned and
numSegmentsMatched; the stacked executor raises NotShardable on exactly
the requests where the JAX one does. (d) The stack LRU and eviction, and
one SSB query of each flight against the numpy oracle.
"""
from __future__ import annotations

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fixtures import build_segment, build_shared_segments, \
    make_columns, make_schema, make_table_config
from pinot_tpu.engine import QueryEngine as JaxQueryEngine
from pinot_tpu.parallel import make_mesh as jax_make_mesh
from pinot_tpu.parallel.sharded import NotShardable as JaxNotShardable
from pinot_tpu.parallel.sharded import \
    ShardedQueryExecutor as JaxShardedExecutor
from pinot_tpu.parallel.sharded import get_sharded_kernel
from pinot_tpu.pql.optimizer import BrokerRequestOptimizer as JaxOptimizer
from pinot_tpu.pql.parser import compile_pql as jax_compile_pql
from pinot_tpu.segment.creator import SegmentCreator as JaxSegmentCreator
from pinot_tpu.segment.loader import ImmutableSegmentLoader as JaxLoader
from pinot_tpu_torch.engine import QueryEngine
from pinot_tpu_torch.ops import kernels as tk
from pinot_tpu_torch.parallel import NotShardable, ShardedQueryExecutor, \
    make_mesh
from pinot_tpu_torch.pql.optimizer import BrokerRequestOptimizer
from pinot_tpu_torch.pql.parser import compile_pql
from pinot_tpu_torch.segment.loader import ImmutableSegmentLoader, \
    hll_tables_padded, int_part_table, min_id_dtype

P = 8192
FLOAT_RTOL = 1e-12
CARDS = {"a": 50, "b": 1000, "g2": 2, "g7": 7}
MV_CARD, MV_W = 10, 3
REV_VALUES = np.unique(np.random.default_rng(5).integers(100, 10_000, 600)
                       * 100).astype(np.int64)
N_PARTS = -(-int(REV_VALUES[-1] - REV_VALUES[0]).bit_length() // 7)


def _segment_lanes(rng, num_docs):
    """One segment's host lanes in the loader's layout (padding rows hold
    id == card, parts and raw values 0)."""
    lanes = {}
    for c, card in CARDS.items():
        ids = np.full(P, card, dtype=min_id_dtype(card))
        ids[:num_docs] = rng.integers(0, card, num_docs)
        lanes[f"{c}.ids"] = ids
    card = len(REV_VALUES)
    ids = np.full(P, card, dtype=np.int32)
    ids[:num_docs] = rng.integers(0, card, num_docs)
    table = int_part_table(REV_VALUES, N_PARTS, int(REV_VALUES[0]))
    lanes["r1.parts"] = np.ascontiguousarray(table[:, ids])
    for c, dt, make in (
            ("x", np.float64, lambda n: (rng.random(n) * 1e5).round(2)),
            ("rf32", np.float32,
             lambda n: (rng.random(n) * 1e3).astype(np.float32)),
            ("ri64", np.int64, lambda n: rng.integers(-2**40, 2**40, n))):
        lane = np.zeros(P, dtype=dt)
        lane[:num_docs] = make(num_docs)
        lanes[f"{c}.raw"] = lane
    lanes["x.vlane"] = lanes["x.raw"]
    mv = np.full((P, MV_W), MV_CARD, dtype=np.int8)
    mv[:num_docs] = rng.integers(0, MV_CARD, (num_docs, MV_W))
    width = rng.integers(1, MV_W + 1, num_docs)
    mv[:num_docs][np.arange(MV_W)[None, :] >= width[:, None]] = MV_CARD
    lanes["m3.mv"] = mv
    return lanes


def _dummy_lanes(lanes):
    """An empty segment's lanes, as the JAX stack pads with them."""
    out = {}
    for k, v in lanes.items():
        fill = CARDS.get(k.split(".")[0], MV_CARD) if k.endswith(
            (".ids", ".mv")) else 0
        out[k] = np.full_like(v, fill)
    return out


def _stack(n_segs, seed):
    """(port cols, JAX cols, num_docs [S], JAX num_docs [8])."""
    rng = np.random.default_rng(seed)
    docs = [P - 700 * s for s in range(n_segs)]
    segs = [_segment_lanes(rng, n) for n in docs]
    jsegs = segs + [_dummy_lanes(segs[0])] * (-n_segs % 8)
    port = {}
    for k in segs[0]:
        st = np.stack([s[k] for s in segs])
        if k.endswith(".parts"):                   # [n_parts, S, P]
            st = np.ascontiguousarray(st.transpose(1, 0, 2))
        port[k] = torch.from_numpy(st)
    jax_cols = {k: jnp.asarray(np.stack([s[k] for s in jsegs]))
                for k in segs[0]}
    idx, rank = hll_tables_padded(np.arange(CARDS["a"]) * 7)
    for k, v in (("a.hllidx", idx), ("a.hllrank", rank)):
        port[k] = torch.from_numpy(v)
        jax_cols[k] = jnp.asarray(v)
    jdocs = np.zeros(len(jsegs), np.int32)
    jdocs[:n_segs] = docs
    return port, jax_cols, np.asarray(docs, np.int32), jdocs


_MEMBER = np.zeros(16, bool)
_MEMBER[[1, 4, 7, 9]] = True
FILTERS = {
    "mixed": (("and", (("pred", "range_ids", "a", "sv", None),
                       ("or", (("pred", "in_ids", "b", "sv", 4),
                               ("pred", "range_raw", "x", "raw",
                                (True, False)))),
                       ("pred", "member", "m3", "mv", 16))),
              [np.int32(5), np.int32(40),
               np.array([3, 77, 500, -1], np.int32),
               np.float64(2e4), np.float64(8e4), _MEMBER]),
    "all": (("match_all",), []),
}
AGGS = (("count", "*", "none", None),
        ("sum", "r1", "sv", ("parts", 1024)),
        ("avg", "r1", "sv", ("parts", 1024)),
        ("distinctcount", "a", "sv", ("hist", 64)),
        ("percentile", "b", "sv", ("hist", 1024)),
        ("min", "a", "sv", ("ids", 64)),
        ("minmaxrange", "b", "sv", ("ids", 1024)),
        ("sum", "rf32", "raw", None),
        ("minmaxrange", "ri64", "raw", None),
        ("avg", "x", "raw", None),
        ("sum", "x", "sv", ("vlane", 1024)),
        ("hll", "a", "sv", ("hll", 64, 4096)),
        ("countmv", "m3", "mv", (16, MV_CARD)),
        ("min", "m3", "mv", (16, MV_CARD)))
GROUPS = {
    "ids": ((("g2", "ids", 0, 2), ("g7", "ids", 0, 7)), (7, 1), 16,
            (("count", "*", "none", None),
             ("sum", "r1", "sv", ("psums", 1024)),
             ("avg", "x", "raw", ("csums",)),
             ("min", "a", "sv", ("ids", 64)),
             ("max", "rf32", "raw", None)), 0),
    "mv": ((("m3", "mvids", 0, MV_CARD), ("g2", "ids", 0, 2)), (2, 1), 32,
           (("count", "*", "none", None),
            ("avg", "r1", "sv", ("psums", 1024))), 0),
}
SELECTS = {
    "limit": ("limit", 16, (), (("a", "sv"), ("x", "raw"), ("m3", "mv"))),
    "order": ("order", 16, (("b", False, 1001, "sv"),),
              (("b", "sv"), ("rf32", "raw"))),
    "ordertk": ("ordertk", 16, (("rf32", True, 0, "raw"),), (("a", "sv"),)),
    "ordermk": ("ordermk", 16, (("g7", True, 8, "sv"),
                                ("ri64", False, 0, "raw")),
                (("ri64", "raw"),)),
}
CASES = [("aggs", "mixed", AGGS, None, None),
         ("aggs_all", "all", AGGS, None, None),
         ("group_ids", "mixed", (), GROUPS["ids"], None),
         ("group_mv", "all", (), GROUPS["mv"], None)] + \
    [(f"select_{k}", "mixed", (), None, v) for k, v in SELECTS.items()]


def _jax_sharded(filt, params, aggs, group, select, jax_cols, jdocs):
    fn = get_sharded_kernel(jax_make_mesh(), P, filt, aggs, group, select,
                            tuple(sorted(jax_cols)))
    outs = fn(jax_cols, tuple(jnp.asarray(x) for x in params),
              jnp.asarray(jdocs))
    return {k: np.asarray(v) for k, v in outs.items()}


def assert_stacked_equal(got, want, n_segs):
    """The port's stacked outputs against the JAX sharded ones, key by
    key, as the module docstring states."""
    assert set(got) == set(want)
    for k, w in want.items():
        g = got[k].numpy()
        if k.endswith(".psums"):
            np.testing.assert_array_equal(
                g, w[:n_segs].astype(np.int64).sum(axis=0), err_msg=k)
        elif k.endswith(".csums"):
            np.testing.assert_allclose(g, w.sum(axis=0), rtol=FLOAT_RTOL,
                                       atol=0, err_msg=k)
        elif tk_kind(k) == "stack" or k == "stats.seg_matched":
            if k.endswith(".vsum"):
                np.testing.assert_allclose(g, w[:n_segs], rtol=FLOAT_RTOL,
                                           atol=0, err_msg=k)
            else:
                np.testing.assert_array_equal(g, w[:n_segs], err_msg=k)
        else:
            # raw min / max in the JAX dtype too; the JAX MV id min / max
            # keep the lane's int8, K5 gives int32 (equal values)
            if k.endswith((".min", ".max")) and w.dtype.kind == "f":
                assert g.dtype == w.dtype, k
            np.testing.assert_array_equal(g, w, err_msg=k)


def tk_kind(key):
    from pinot_tpu_torch.parallel.sharded import _combine_kind
    return _combine_kind(key)


@pytest.mark.parametrize("n_segs", [8, 5])
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_stacked_kernel_plain_matches_jax_sharded(n_segs, case):
    _name, fname, aggs, group, select = case
    filt, params = FILTERS[fname]
    port, jax_cols, docs, jdocs = _stack(n_segs, seed=n_segs + len(_name))
    if not aggs:             # JAX's MV group expansion takes row lanes only
        for k in ("a.hllidx", "a.hllrank"):
            del port[k], jax_cols[k]
    want = _jax_sharded(filt, params, aggs, group, select, jax_cols, jdocs)
    got = tk.run_stacked_kernel(P, n_segs, filt, aggs, group, select, port,
                                params, torch.from_numpy(docs))
    assert_stacked_equal(got, want, n_segs)
    assert int(got["stats.num_docs_matched"]) == \
        int(got["stats.seg_matched"].sum())


def test_stacked_part_sums_stay_exact_per_segment():
    # each segment's row is exact in int32; the stack's sums pass int32
    # only once the rows are added on the host, in int64
    n_segs, rows = 3, 1 << 14
    mask = torch.ones(n_segs * rows, dtype=torch.uint8)
    parts = torch.full((2, n_segs * rows), 127, dtype=torch.int8)
    out = tk.masked_part_sums(mask, [parts], seg_rows=rows)
    assert out.shape == (n_segs, 3)
    assert (out[:, :2] == 127 * rows).all() and (out[:, 2] == rows).all()
    # 16,909,824 rows: 127 * rows passes 2^31 as one segment, not as two;
    # one segment that long splits into exact row ranges (here its halves)
    half = 33027 * 256
    mask = torch.ones(2 * half, dtype=torch.uint8)
    parts = torch.full((1, 2 * half), 127, dtype=torch.int8)
    out = tk.masked_part_sums(mask, [parts])
    assert out.tolist() == [[127 * half, half]] * 2
    out = tk.masked_part_sums(mask, [parts], seg_rows=half)
    assert out.tolist() == [[127 * half, half]] * 2


# ---------------------------------------------------------------------------
# Segments written once, loaded by both packages
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def hetero(tmp_path_factory):
    """4 independently built segments: per-segment dictionaries."""
    base = str(tmp_path_factory.mktemp("hetero"))
    dirs, cols = [], []
    for i in range(4):
        d = os.path.join(base, f"seg{i}")
        os.makedirs(d)
        _seg, c = build_segment(d, n=1024, seed=i, name=f"h{i}")
        dirs.append(d)
        cols.append(c)
    return dirs, cols


@pytest.fixture(scope="module")
def shared(tmp_path_factory):
    """8 segments with identical dictionaries (the JAX tests' stack)."""
    base = str(tmp_path_factory.mktemp("shared"))
    build_shared_segments(base, n_segs=8, n=2048)
    return [os.path.join(base, f"seg{i}") for i in range(8)]


def _engines(dirs):
    """(port stacked, JAX stacked, port sequential) over the same dirs."""
    port = QueryEngine.from_dirs(dirs, device="cpu",
                                 mesh=make_mesh(["cpu"]))
    jax_engine = JaxQueryEngine([JaxLoader.load(d) for d in dirs],
                                mesh=jax_make_mesh())
    seq = QueryEngine.from_dirs(dirs, device="cpu")
    return port, jax_engine, seq


@pytest.fixture(scope="module")
def hetero_engines(hetero):
    return _engines(hetero[0])


@pytest.fixture(scope="module")
def shared_engines(shared):
    return _engines(shared)


def _values(resp_json):
    """Aggregation rows as {(function, group): value} and selection rows."""
    out = {}
    for agg in resp_json.get("aggregationResults") or []:
        if "groupByResult" in agg:
            for g in agg["groupByResult"]:
                out[(agg["function"], tuple(g["group"]))] = g["value"]
        else:
            out[(agg["function"], ())] = agg["value"]
    return out, resp_json.get("selectionResults")


def _num(v):
    try:
        return float(v)
    except (TypeError, ValueError):
        return v


def assert_same_answer(a, b, what):
    va, sa = _values(a)
    vb, sb = _values(b)
    assert va.keys() == vb.keys(), what
    for k in va:
        x, y = _num(va[k]), _num(vb[k])
        if isinstance(x, float) and isinstance(y, float):
            assert y == pytest.approx(x, rel=FLOAT_RTOL, nan_ok=True), \
                (what, k)
        else:
            assert x == y, (what, k)
    assert sa == sb, what
    for key in ("numDocsScanned", "numSegmentsMatched", "totalDocs"):
        assert a[key] == b[key], (what, key)


ENGINE_PQLS = {
    "count_sum_avg": "SELECT COUNT(*), SUM(runs), AVG(hits) FROM "
                     "baseballStats WHERE yearID >= 2000",
    "min_max_range": "SELECT MIN(runs), MAX(runs), MINMAXRANGE(hits) FROM "
                     "baseballStats WHERE teamID = 'BOS'",
    "raw_columns": "SELECT SUM(salary), MIN(salary), MAX(salary) FROM "
                   "baseballStats WHERE league = 'NL' AND salary > 250000",
    "distinct_percentile": "SELECT DISTINCTCOUNT(playerName), "
                           "PERCENTILE90(runs) FROM baseballStats WHERE "
                           "yearID < 2005",
    "hll": "SELECT DISTINCTCOUNTHLL(playerName) FROM baseballStats WHERE "
           "runs > 30",
    "float_dict_sum": "SELECT SUM(average), AVG(average) FROM baseballStats "
                      "WHERE runs < 20",
    "group_by": "SELECT SUM(hits) FROM baseballStats WHERE runs > 50 GROUP "
                "BY teamID, league TOP 1000",
    "group_min_max_avg": "SELECT MIN(runs), MAX(salary), AVG(average), "
                         "COUNT(*) FROM baseballStats GROUP BY league",
    "group_expression": "SELECT COUNT(*), SUM(runs) FROM baseballStats "
                        "GROUP BY div(yearID, 10) TOP 100",
    "mv_aggregation": "SELECT COUNTMV(position), DISTINCTCOUNTMV(position) "
                      "FROM baseballStats WHERE yearID > 1995",
    "mv_filter": "SELECT COUNT(*), SUM(runs) FROM baseballStats WHERE "
                 "position IN ('P', 'SS') AND league = 'AL'",
    "mv_group_by": "SELECT COUNT(*), SUM(hits) FROM baseballStats GROUP BY "
                   "position TOP 100",
    "selection_limit": "SELECT teamID, salary, position FROM baseballStats "
                       "WHERE league = 'AL' LIMIT 10",
    "selection_order": "SELECT playerName, runs FROM baseballStats WHERE "
                       "league = 'AL' ORDER BY runs DESC, playerName LIMIT "
                       "15",
    "selection_ordermk": "SELECT teamID, yearID, salary FROM baseballStats "
                         "ORDER BY teamID, salary LIMIT 20",
    "selection_ordertk": "SELECT playerName, salary FROM baseballStats "
                         "WHERE yearID >= 2010 ORDER BY salary DESC LIMIT 12",
    "segments_matched": "SELECT COUNT(*) FROM baseballStats WHERE runs = "
                        "142 AND yearID = 1999",
    "nothing_matches": "SELECT SUM(runs), MIN(hits) FROM baseballStats "
                       "WHERE teamID = 'BOS' AND teamID = 'NYA'",
}


@pytest.mark.parametrize("table", ["hetero", "shared"])
@pytest.mark.parametrize("name", sorted(ENGINE_PQLS))
def test_stacked_engine_matches_jax_and_sequential(request, table, name):
    port, jax_engine, seq = request.getfixturevalue(f"{table}_engines")
    pql = ENGINE_PQLS[name]
    got = port.query(pql)
    assert port.last_route == ("stacked", None), name
    assert not got.exceptions
    a = got.to_json()
    assert_same_answer(a, jax_engine.query(pql).to_json(), (table, name))
    assert_same_answer(a, seq.query(pql).to_json(), (table, name))


def test_folded_predicate_on_heterogeneous_dicts(hetero, hetero_engines):
    """A value only some segments hold folds against the union
    dictionary, which is valid for every segment."""
    dirs, cols = hetero
    port, jax_engine, seq = hetero_engines
    only1 = sorted(set(cols[1]["playerName"]) - set(cols[0]["playerName"]))[0]
    names = np.concatenate([c["playerName"] for c in cols])
    runs = np.concatenate([c["runs"] for c in cols])
    pql = (f"SELECT SUM(runs) FROM baseballStats WHERE playerName <> "
           f"'{only1}'")
    a = port.query(pql)
    assert port.last_route == ("stacked", None)
    assert float(a.aggregation_results[0].value) == \
        float(runs[names != only1].sum())
    assert_same_answer(a.to_json(), jax_engine.query(pql).to_json(), pql)
    assert_same_answer(a.to_json(), seq.query(pql).to_json(), pql)


def _route(executor, segs, pql, optimizer, compile_fn, not_shardable):
    request = optimizer().optimize(compile_fn(pql))
    try:
        executor.execute(request, segs)
    except not_shardable:
        return "NotShardable"
    except Exception as e:                     # the planner's refusals
        return type(e).__name__
    return "stacked"


def _odd_dirs(base):
    """Two segments whose padded sizes differ (1,000 and 9,000 rows), and
    two whose raw-key ranges differ (runs without a dictionary, shifted by
    1,000 in the second)."""
    dirs = {}
    for name, n, seed, no_dict, shift in (
            ("small", 1000, 1, ["salary"], 0),
            ("big", 9000, 2, ["salary"], 0),
            ("raw0", 1500, 3, ["salary", "runs"], 0),
            ("raw1", 1500, 4, ["salary", "runs"], 1000)):
        d = os.path.join(base, name)
        os.makedirs(d)
        cols = make_columns(n, seed)
        cols["runs"] = cols["runs"] + np.int32(shift)
        JaxSegmentCreator(make_schema(), make_table_config(no_dict=no_dict),
                          segment_name=name).build(cols, d)
        dirs[name] = d
    return dirs


ROUTE_PQLS = [
    "SELECT SUM(runs) FROM baseballStats",
    "SELECT COUNT(*) FROM baseballStats",
    "SELECT COUNT(*) FROM baseballStats WHERE teamID = 'BOS'",
    "SELECT MAX(runs) FROM baseballStats",
    "SELECT COUNT(*) FROM baseballStats WHERE yearID > 2050",
    "SELECT COUNT(*), SUM(hits) FROM baseballStats GROUP BY runs TOP 500",
    "SELECT DISTINCTCOUNT(teamID) FROM baseballStats GROUP BY league",
    "SELECT playerName FROM baseballStats ORDER BY position LIMIT 5",
    "SELECT SUM(hits) FROM baseballStats WHERE league = 'NL' GROUP BY "
    "teamID TOP 100",
]


def test_not_shardable_on_exactly_the_jax_requests(tmp_path, hetero):
    dirs = _odd_dirs(str(tmp_path))
    sets = {"hetero": hetero[0], "padded": [dirs["small"], dirs["big"]],
            "raw_range": [dirs["raw0"], dirs["raw1"]]}
    routes = {}
    for set_name, ds in sets.items():
        port_segs = [ImmutableSegmentLoader.load(d).to("cpu") for d in ds]
        jax_segs = [JaxLoader.load(d) for d in ds]
        port_ex = ShardedQueryExecutor(mesh=make_mesh(["cpu"]))
        jax_ex = JaxShardedExecutor(mesh=jax_make_mesh())
        for pql in ROUTE_PQLS:
            got = _route(port_ex, port_segs, pql, BrokerRequestOptimizer,
                         compile_pql, NotShardable)
            want = _route(jax_ex, jax_segs, pql, JaxOptimizer,
                          jax_compile_pql, JaxNotShardable)
            assert got == want, (set_name, pql)
            routes[(set_name, pql)] = got
    assert routes[("padded", ROUTE_PQLS[0])] == "NotShardable"
    assert routes[("raw_range", ROUTE_PQLS[5])] == "NotShardable"
    assert routes[("hetero", ROUTE_PQLS[2])] == "NotShardable"   # fast path
    assert routes[("hetero", ROUTE_PQLS[6])] == "UnsupportedOnDevice"
    assert routes[("hetero", ROUTE_PQLS[8])] == "stacked"


def test_engine_falls_back_and_counts_routes(tmp_path):
    dirs = _odd_dirs(str(tmp_path))
    ds = [dirs["small"], dirs["big"]]
    port = QueryEngine.from_dirs(ds, device="cpu", mesh=make_mesh(["cpu"]))
    seq = QueryEngine.from_dirs(ds, device="cpu")
    pql = "SELECT SUM(runs), COUNT(*) FROM baseballStats WHERE yearID > 2000"
    assert_same_answer(port.query(pql).to_json(), seq.query(pql).to_json(),
                       pql)
    assert port.last_route[0] == "NotShardable"
    assert "padded doc counts differ" in port.last_route[1]
    port.query("SELECT DISTINCTCOUNT(teamID) FROM baseballStats GROUP BY "
               "league")
    assert port.route_counts == {"NotShardable": 2}
    assert seq.route_counts == {"sequential": 1}


def test_make_mesh_and_engine_device():
    assert make_mesh(["cpu"]) == (torch.device("cpu"),)
    with pytest.raises(NotImplementedError):
        make_mesh(["cpu", "cpu"])
    with pytest.raises(ValueError, match="mesh"):
        QueryEngine([], device="cpu", mesh=(torch.device("meta"),))


def test_stacked_lanes_and_plans_match_jax(hetero):
    """Union-dictionary lanes: the port's stack and plan against its union
    view, run by run_stacked_kernel, give the JAX stack's outputs under
    the JAX plan (its stack pads to 8 segments)."""
    from pinot_tpu.query.plan import InstancePlanMaker as JaxPlanMaker
    from pinot_tpu_torch.query.plan import InstancePlanMaker
    dirs, _cols = hetero
    port_ex = ShardedQueryExecutor(mesh=make_mesh(["cpu"]))
    jax_ex = JaxShardedExecutor(mesh=jax_make_mesh())
    pst = port_ex.stack_for([ImmutableSegmentLoader.load(d).to("cpu")
                             for d in dirs])
    jst = jax_ex.stack_for([JaxLoader.load(d) for d in dirs])
    for pql in ("SELECT SUM(runs), MIN(playerName), DISTINCTCOUNT(teamID), "
                "DISTINCTCOUNTHLL(playerName) FROM baseballStats WHERE "
                "playerName > 'player_300' AND position = 'C'",
                "SELECT SUM(hits), MAX(runs), AVG(average) FROM "
                "baseballStats WHERE yearID BETWEEN 1995 AND 2009 GROUP BY "
                "teamID, league TOP 100",
                "SELECT playerName, runs, position FROM baseballStats WHERE "
                "teamID IN ('BOS', 'NYA') ORDER BY playerName DESC LIMIT 8"):
        plan = InstancePlanMaker(allow_group_compaction=False
                                 ).make_segment_plan(
            pst.plan_segment(), BrokerRequestOptimizer().optimize(
                compile_pql(pql)))
        jplan = JaxPlanMaker().make_segment_plan(
            jst.plan_segment(), JaxOptimizer().optimize(
                jax_compile_pql(pql)))
        # the same filter, aggregations and selection; the JAX planner
        # picks its compacted group strategy, so both kernels take the
        # port's dense group spec (its planner's compaction off, kmax = 0;
        # test_torch_compact.py holds the compacted stacked kernels)
        assert (plan.filter_spec, plan.agg_specs, plan.select_spec,
                plan.needed_cols) == (jplan.filter_spec,
                                      tuple(jplan.agg_specs),
                                      jplan.select_spec, jplan.needed_cols)
        assert len(plan.params) == len(jplan.params)
        for a, b in zip(plan.params, jplan.params):
            np.testing.assert_array_equal(a, b)
        jcols = jst.gather(plan.needed_cols)
        fn = get_sharded_kernel(jax_make_mesh(), jst.padded_docs,
                                plan.filter_spec, tuple(plan.agg_specs),
                                plan.group_spec, plan.select_spec,
                                tuple(sorted(jcols)))
        want = {k: np.asarray(v) for k, v in fn(
            jcols, tuple(jplan.params), jst.device_num_docs()).items()}
        got = tk.run_stacked_kernel(
            pst.padded_docs, pst.n_real, plan.filter_spec, plan.agg_specs,
            plan.group_spec, plan.select_spec, pst.gather(plan.needed_cols),
            tuple(plan.params), pst.device_num_docs(), plan.group_params)
        assert_stacked_equal(got, want, pst.n_real)


def test_stack_cache_canonical_key_lru_and_evict(shared):
    segs = [ImmutableSegmentLoader.load(d).to("cpu") for d in shared]
    sharded = ShardedQueryExecutor(mesh=make_mesh(["cpu"]), max_stacks=2)
    request = compile_pql("SELECT SUM(runs) FROM baseballStats WHERE "
                          "yearID >= 1980")
    sharded.execute(request, segs)
    sharded.execute(request, list(reversed(segs)))
    assert len(sharded._stacks) == 1          # one stack for any order
    st_full = next(iter(sharded._stacks.values()))
    sharded.execute(request, segs[:4])
    sharded.execute(request, segs[4:])
    assert len(sharded._stacks) == 2          # the full set fell out (LRU)
    assert st_full not in sharded._stacks.values()
    sharded.evict_segment(segs[4].segment_name)
    assert all(segs[4].segment_name not in k for k in sharded._stacks)
    assert len(sharded._stacks) == 1
    # a refreshed segment (same name, new object) rebuilds the stack
    st0 = sharded.stack_for(segs[:4])
    refreshed = segs[:3] + [ImmutableSegmentLoader.load(shared[3]).to("cpu")]
    assert sharded.stack_for(refreshed) is not st0
    sharded.evict_all()
    assert not sharded._stacks


@pytest.fixture(scope="module")
def ssb_engines():
    from pinot_tpu.tools.datagen import make_ssb_segments
    from pinot_tpu_torch.tools.ssb import make_cpu_queries
    from test_torch_ssb import carry_across
    table = make_ssb_segments(120_000, 4, seed=5)
    port = QueryEngine([carry_across(s) for s in table.segments],
                       device="cpu", mesh=make_mesh(["cpu"]))
    oracle = make_cpu_queries(table.pools, table.ids, table.supplycost)
    return JaxQueryEngine(table.segments, mesh=jax_make_mesh()), port, oracle


@pytest.mark.parametrize("q", ["q1.1", "q2.1", "q3.2", "q4.3"])
def test_ssb_flight_stacked_matches_jax_and_oracle(ssb_engines, q):
    from pinot_tpu_torch.tools.ssb import SSB_PQLS, canon_response, check
    jax_engine, port, oracle = ssb_engines
    resp = port.query(SSB_PQLS[q])
    assert port.last_route == ("stacked", None)
    got = canon_response(q, resp)
    want = canon_response(q, jax_engine.query(SSB_PQLS[q]))
    if q.startswith("q1"):
        assert got == want
    else:
        assert set(got) == set(want)
        for k, w in want.items():
            assert got[k][0] == w[0], (q, k)
    check(q, got, oracle[q]())


@pytest.mark.parametrize("q", ["q2.1", "q2.2", "q2.3", "q3.1", "q3.2",
                               "q3.3", "q3.4", "q4.1", "q4.2", "q4.3"])
def test_ssb_group_by_stacked_takes_the_jax_route(ssb_engines, monkeypatch,
                                                  q):
    """Compaction on: the stack's final kernel spec equals the JAX
    stack's (scouts over the stack, kmax per segment), the rows the JAX
    engine's and the oracle's; compaction off gives the same rows."""
    from pinot_tpu_torch.query.plan import InstancePlanMaker
    from pinot_tpu_torch.tools.ssb import SSB_PQLS, canon_response, check
    from test_torch_compact import _recorder
    from test_torch_ssb import _rows_match
    jax_engine, port, oracle = ssb_engines
    rec = _recorder(monkeypatch)
    want = canon_response(q, jax_engine.query(SSB_PQLS[q]))
    got = canon_response(q, port.query(SSB_PQLS[q]))
    monkeypatch.undo()
    assert port.last_route == ("stacked", None)
    assert rec["port"] == rec["jax"] and len(rec["port"]) == 1
    _rows_match(got, want, 1e-6)
    check(q, got, oracle[q]())
    off = QueryEngine(port.segments, device="cpu", mesh=make_mesh(["cpu"]))
    off.sharded.plan_maker = InstancePlanMaker(allow_group_compaction=False)
    _rows_match(canon_response(q, off.query(SSB_PQLS[q])), got, 1e-12)


# ---------------------------------------------------------------------------
# On the card: the stacked launches against their plain versions
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _assert_cuda_equal(got, want):
    assert set(got) == set(want)
    for k, w in want.items():
        g = got[k].cpu()
        assert g.dtype == w.dtype and g.shape == w.shape, k
        if k.endswith((".csums", ".vsum")):
            # float64 atomics and block sums add in another order
            torch.testing.assert_close(g, w, rtol=1e-9, atol=0)
        else:
            assert torch.equal(g, w), k


@pytest.mark.cuda
@pytest.mark.parametrize("n_segs", [8, 5, 1])
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_stacked_kernel_cuda_matches_plain(cuda_device, n_segs, case):
    from pinot_tpu_torch.ops import kernels as K
    _name, fname, aggs, group, select = case
    filt, params = FILTERS[fname]
    port, _jax_cols, docs, _jdocs = _stack(n_segs, seed=n_segs)
    want = tk.run_stacked_kernel(P, n_segs, filt, aggs, group, select, port,
                                 params, torch.from_numpy(docs))
    card = {k: v.to(cuda_device) for k, v in port.items()}
    one = {k: v if k.endswith((".hllidx", ".hllrank")) else
           v[:, :1].contiguous() if k.endswith(".parts") else v[:1]
           for k, v in card.items()}
    K.reset_launch_counts()
    tk.run_stacked_kernel(P, 1, filt, aggs, group, select, one, params,
                          torch.from_numpy(docs[:1]).to(cuda_device))
    per_plan = K.launch_counts()
    K.reset_launch_counts()
    got = tk.run_stacked_kernel(P, n_segs, filt, aggs, group, select, card,
                                params, torch.from_numpy(docs).to(cuda_device))
    # the launches of one segment's plan, whatever the number of segments
    assert K.launch_counts() == per_plan
    _assert_cuda_equal(got, want)


@pytest.mark.cuda
def test_stacked_k3_wide_psums_cuda_past_int32(cuda_device):
    # 2 segments of 2^24 rows, every part byte 127 in one group: each
    # segment's sum fits int32, the stack's (2^32 * 127 / 2^8) does not
    from pinot_tpu_torch.ops import kernels as K
    rows = 2 << 24
    mask = torch.ones(rows, dtype=torch.uint8, device=cuda_device)
    key = torch.zeros(rows, dtype=torch.int8, device=cuda_device)
    parts = torch.full((1, rows), 127, dtype=torch.int8, device=cuda_device)
    for slots in (0, K.K3_SMEM_SLOTS):
        count, psums, _c, matched, _t = K.dense_group_aggregate(
            mask, [key], [1], 8, [parts], smem_slots=slots,
            psums_wide=True)
        assert psums.dtype == torch.int64
        assert int(psums[0, 0]) == 127 * rows and int(count[0]) == rows
        assert int(matched) == rows


@pytest.mark.cuda
def test_stacked_engine_cuda_matches_cpu(cuda_device, hetero):
    dirs, _cols = hetero
    card = QueryEngine.from_dirs(dirs, mesh=make_mesh())
    cpu = QueryEngine.from_dirs(dirs, device="cpu", mesh=make_mesh(["cpu"]))
    for name, pql in sorted(ENGINE_PQLS.items()):
        a = card.query(pql)
        assert card.last_route == ("stacked", None), name
        assert_same_answer(a.to_json(), cpu.query(pql).to_json(), name)
