"""Star-tree cubes in the port, against the JAX engine.

A twin of tests/test_startree.py (StarTreeClusterIntegrationTest's
contract): cubes are built by the port's SegmentCreator as the JAX
creator builds them, load with the segment, and every query answers as
the port's own scan path and the JAX engine answer it. Cubes are taken
where the JAX executor takes them, with equal "cube" path counts (the
port's `path_counts["cube"]`, the JAX profile's `paths["cube"]`): per
segment, over several segments (the multi-segment cube), on the stacked
engine (`mesh=make_mesh(["cpu"])`, whose fast path goes per segment) and
through `execute_batch`. The JAX tests of the cluster upload and of
writing the v3 container have no counterpart (the port has neither
plane): their twins load the JAX creator's v1 and v3 directories with
cubes in the port.
"""
from __future__ import annotations

import os

import numpy as np
import pytest

from fixtures import make_columns
from fixtures import make_schema as jax_schema
from fixtures import make_table_config as jax_table_config
from pinot_tpu.engine import QueryEngine as JaxQueryEngine
from pinot_tpu.obs import profiler as jax_profiler
from pinot_tpu.parallel import make_mesh as jax_make_mesh
from pinot_tpu.pql.parser import compile_pql as jax_compile_pql
from pinot_tpu.segment.creator import SegmentCreator as JaxSegmentCreator
from pinot_tpu.segment.loader import ImmutableSegmentLoader as JaxLoader
from pinot_tpu.tools import datagen as jax_datagen
from pinot_tpu_torch.engine import QueryEngine
from pinot_tpu_torch.parallel import make_mesh
from pinot_tpu_torch.pql.optimizer import BrokerRequestOptimizer
from pinot_tpu_torch.pql.parser import compile_pql
from pinot_tpu_torch.segment.creator import SegmentCreator
from pinot_tpu_torch.segment.loader import ImmutableSegmentLoader
from pinot_tpu_torch.startree.cube import StarTreeConfig
from pinot_tpu_torch.tools import baseball, datagen
from pinot_tpu_torch.tools.ssb import (SSB_PQLS, canon_response, check,
                                       make_cpu_queries)

ST_CONFIG = {
    "dimensionsSplitOrder": ["teamID", "league", "yearID"],
    "functionColumnPairs": ["SUM__runs", "SUM__hits", "MAX__average"],
    "maxSize": 1 << 20,
}

QUERIES = [
    "SELECT COUNT(*) FROM baseballStats",
    "SELECT SUM(runs), COUNT(*) FROM baseballStats WHERE teamID = 'BOS'",
    "SELECT SUM(runs) FROM baseballStats WHERE yearID >= 2000 AND "
    "league = 'AL'",
    "SELECT MIN(average), MAX(average), AVG(hits) FROM baseballStats "
    "WHERE teamID IN ('BOS', 'NYA', 'SEA')",
    "SELECT MINMAXRANGE(runs) FROM baseballStats WHERE yearID <> 1995",
    "SELECT SUM(runs) FROM baseballStats GROUP BY teamID TOP 100",
    "SELECT SUM(hits), COUNT(*) FROM baseballStats "
    "WHERE league = 'NL' GROUP BY teamID, yearID TOP 1000",
    "SELECT AVG(runs) FROM baseballStats GROUP BY league "
    "HAVING AVG(runs) > 0 TOP 10",
    # expression filter whose source column is a cube dimension
    "SELECT SUM(runs) FROM baseballStats "
    "WHERE time_convert(yearID,'DAYS','HOURS') >= 48000",
]

MULTI_QUERIES = [
    "SELECT COUNT(*), MIN(runs), MAX(runs) FROM baseballStats "
    "WHERE teamID = 'BOS'",
    "SELECT MIN(average), MAX(average), AVG(hits) "
    "FROM baseballStats WHERE league = 'AL'",
    "SELECT MINMAXRANGE(runs), MIN(runs) FROM baseballStats "
    "GROUP BY league TOP 10",
]


def _port_config(star_tree=True):
    cfg = baseball.make_table_config()
    if star_tree:
        cfg.indexing_config.star_tree_configs = [dict(ST_CONFIG)]
    return cfg


def _jax_config(star_tree=True, **kw):
    cfg = jax_table_config(**kw)
    if star_tree:
        cfg.indexing_config.star_tree_configs = [dict(ST_CONFIG)]
    return cfg


def _build_port(d, cols, name, star_tree=True):
    SegmentCreator(baseball.make_schema(), _port_config(star_tree),
                   name).build(dict(cols), d)
    return ImmutableSegmentLoader.load(d, device="cpu")


def _build_jax(d, cols, name, star_tree=True):
    JaxSegmentCreator(jax_schema(), _jax_config(star_tree),
                      name).build(dict(cols), d)
    return JaxLoader.load(d)


def _result_key(resp):
    out = []
    if resp.aggregation_results is None:
        return sorted(map(tuple, resp.selection_results.results))
    for a in resp.aggregation_results:
        if a.group_by_result is not None:
            out.append(sorted((tuple(g["group"]), g["value"])
                              for g in a.group_by_result))
        else:
            out.append(a.value)
    return out


def _jax_query(engine, pql):
    """(response, cube path count) of the JAX engine."""
    prof = jax_profiler.QueryProfile("baseballStats")
    with jax_profiler.active(prof):
        resp = engine.query(pql)
    return resp, prof.paths.get("cube", 0)


def _port_query(engine, pql):
    before = engine.executor.path_counts["cube"]
    resp = engine.query(pql)
    return resp, engine.executor.path_counts["cube"] - before


@pytest.fixture(scope="module")
def segments(tmp_path_factory):
    base = str(tmp_path_factory.mktemp("st"))
    cols = make_columns(20_000, seed=23)
    return (_build_port(os.path.join(base, "st"), cols, "st_seg"),
            _build_port(os.path.join(base, "plain"), cols, "plain_seg",
                        star_tree=False),
            _build_jax(os.path.join(base, "jax_st"), cols, "st_seg"),
            cols)


def test_cubes_built_and_loaded(segments):
    seg_st, seg_plain, jax_st, _ = segments
    assert len(seg_st.star_trees) == 1
    cube = seg_st.star_trees[0]
    assert cube.dimensions == ["teamID", "league", "yearID"]
    assert set(cube.metrics) == {"runs", "hits", "average"}
    assert 0 < cube.n_groups < seg_st.num_docs
    assert int(cube.counts.sum()) == seg_st.num_docs
    assert seg_plain.star_trees == []
    # the JAX creator's cube from the same rows, lane for lane
    jcube = jax_st.star_trees[0]
    assert jcube.n_groups == cube.n_groups
    np.testing.assert_array_equal(cube.counts, jcube.counts)
    for d in cube.dimensions:
        np.testing.assert_array_equal(cube.dim_ids[d], jcube.dim_ids[d])
    for m in cube.metrics:
        for k in ("sum", "min", "max"):
            np.testing.assert_array_equal(cube.metric_stats[m][k],
                                          jcube.metric_stats[m][k])


def test_star_tree_same_answers_as_plain_path(segments):
    """The StarTreeClusterIntegrationTest contract, and the JAX engine's
    answers and cube counts."""
    seg_st, seg_plain, jax_st, _ = segments
    eng_st = QueryEngine([seg_st], device="cpu")
    eng_plain = QueryEngine([seg_plain], device="cpu")
    jax_eng = JaxQueryEngine([jax_st])
    cubes = 0
    for q in QUERIES:
        resp, n = _port_query(eng_st, q)
        jresp, jn = _jax_query(jax_eng, q)
        r_st = _result_key(resp)
        assert r_st == _result_key(eng_plain.query(q)), q
        assert r_st == _result_key(jresp), q
        assert n == jn, q
        assert resp.num_docs_scanned == jresp.num_docs_scanned, q
        cubes += n
    assert cubes >= len(QUERIES) - 2     # the cube answers nearly all


def test_star_tree_disable_option(segments):
    seg_st, _, _, _ = segments
    eng = QueryEngine([seg_st], device="cpu")
    q = "SELECT SUM(runs) FROM baseballStats WHERE teamID = 'BOS'"
    on, n_on = _port_query(eng, q)
    off, n_off = _port_query(eng, q + " OPTION(useStarTree=false)")
    assert on.aggregation_results[0].value == \
        off.aggregation_results[0].value
    assert (n_on, n_off) == (1, 0)
    # the cube path scans groups, not docs
    assert on.num_docs_scanned < off.num_docs_scanned


def test_star_tree_ineligible_falls_back(segments):
    seg_st, seg_plain, jax_st, _ = segments
    eng_st = QueryEngine([seg_st], device="cpu")
    eng_plain = QueryEngine([seg_plain], device="cpu")
    jax_eng = JaxQueryEngine([jax_st])
    # uncovered metric (salary), uncovered dim (playerName), percentile,
    # selection — all must silently take the normal path
    for q in [
        "SELECT SUM(salary) FROM baseballStats WHERE teamID = 'BOS'",
        "SELECT SUM(runs) FROM baseballStats WHERE playerName = "
        "'player_001'",
        "SELECT PERCENTILE50(runs) FROM baseballStats",
        "SELECT DISTINCTCOUNT(runs) FROM baseballStats "
        "WHERE teamID = 'BOS'",
        "SELECT teamID, runs FROM baseballStats LIMIT 5",
    ]:
        resp, n = _port_query(eng_st, q)
        jresp, jn = _jax_query(jax_eng, q)
        assert (n, jn) == (0, 0), q
        r_st = _result_key(resp)
        assert r_st == _result_key(eng_plain.query(q)), q
        if jresp.aggregation_results is not None:
            assert r_st == _result_key(jresp), q


def test_star_tree_group_by_vs_numpy(segments):
    seg_st, _, _, cols = segments
    eng = QueryEngine([seg_st], device="cpu")
    resp = eng.query("SELECT SUM(runs) FROM baseballStats "
                     "WHERE league = 'AL' GROUP BY teamID TOP 100")
    m = cols["league"] == "AL"
    runs = cols["runs"].astype(np.float64)
    expected = {}
    for t in np.unique(cols["teamID"][m]):
        expected[str(t)] = float(runs[m & (cols["teamID"] == t)].sum())
    got = {g["group"][0]: float(g["value"])
           for g in resp.aggregation_results[0].group_by_result}
    assert got == expected
    assert eng.executor.path_counts["cube"] == 1


@pytest.mark.parametrize("version", ["v1", "v3"])
def test_jax_cube_directory_loads_in_the_port(tmp_path, version):
    """The JAX creator's directory with cubes (v1, and the v3 container
    the port reads but does not write) loads in the port with the same
    cubes, and the port answers from them as the JAX engine does."""
    cols = make_columns(8_000, seed=55)
    cfg = _jax_config()
    cfg.indexing_config.segment_version = version
    d = str(tmp_path / version)
    JaxSegmentCreator(jax_schema(), cfg, "v_st").build(dict(cols), d)
    seg = ImmutableSegmentLoader.load(d, device="cpu")
    jseg = JaxLoader.load(d)
    assert len(seg.star_trees) == len(jseg.star_trees) == 1
    np.testing.assert_array_equal(seg.star_trees[0].counts,
                                  jseg.star_trees[0].counts)
    q = ("SELECT SUM(runs) FROM baseballStats WHERE teamID = 'BOS' "
         "GROUP BY yearID TOP 100")
    resp, n = _port_query(QueryEngine([seg], device="cpu"), q)
    jresp, jn = _jax_query(JaxQueryEngine([jseg]), q)
    assert _result_key(resp) == _result_key(jresp)
    assert n == jn == 1
    assert resp.num_entries_scanned_in_filter < seg.num_docs / 4


def test_rebuild_removes_stale_cubes(tmp_path):
    d = str(tmp_path / "seg")
    cols1 = make_columns(2000, seed=31)
    assert len(_build_port(d, cols1, "reb").star_trees) == 1
    # rebuild same dir WITHOUT star-tree config: stale cubes must vanish
    cols2 = make_columns(2000, seed=32)
    seg = _build_port(d, cols2, "reb", star_tree=False)
    assert seg.star_trees == []
    assert not [n for n in os.listdir(d) if n.startswith("startree.")]
    eng = QueryEngine([seg], device="cpu")
    resp = eng.query("SELECT SUM(runs) FROM baseballStats "
                     "WHERE teamID = 'BOS'")
    exp = float(cols2["runs"][cols2["teamID"] == "BOS"].sum())
    assert float(resp.aggregation_results[0].value) == exp


def test_broken_cube_files_do_not_brick_segment(tmp_path):
    d = str(tmp_path / "seg")
    _build_port(d, make_columns(2000, seed=33), "brk")
    os.remove(os.path.join(d, "startree.0.npz"))    # crash-torn save
    seg = ImmutableSegmentLoader.load(d, device="cpu")   # must not raise
    assert seg.star_trees == []


def test_max_leaf_records_does_not_disable_cube():
    c = StarTreeConfig.from_json({
        "dimensionsSplitOrder": ["teamID"],
        "functionColumnPairs": ["SUM__runs"],
        "maxLeafRecords": 10000})
    assert c.max_groups > 10000     # Pinot's split threshold is not a cap


@pytest.fixture(scope="module")
def multi(tmp_path_factory):
    base = str(tmp_path_factory.mktemp("multi"))
    segs, plain, jsegs = [], [], []
    for i in range(3):
        cols = make_columns(5_000, seed=40 + i)
        segs.append(_build_port(os.path.join(base, f"st{i}"), cols,
                                f"st{i}"))
        plain.append(_build_port(os.path.join(base, f"pl{i}"), cols,
                                 f"pl{i}", star_tree=False))
        jsegs.append(_build_jax(os.path.join(base, f"jst{i}"), cols,
                                f"st{i}"))
    return segs, plain, jsegs


def test_multi_segment_repeated_column_aggs(multi):
    """MIN(x), MAX(x) (two functions, one column) over the multi-segment
    cube path, as the JAX regression test holds it; every segment counted
    under "cube", as the JAX executor counts them."""
    segs, plain, jsegs = multi
    eng_st = QueryEngine(segs, device="cpu")
    eng_plain = QueryEngine(plain, device="cpu")
    jax_eng = JaxQueryEngine(jsegs)
    counts = []
    for q in MULTI_QUERIES:
        resp, n = _port_query(eng_st, q)
        jresp, jn = _jax_query(jax_eng, q)
        assert _result_key(resp) == _result_key(eng_plain.query(q)), q
        assert _result_key(resp) == _result_key(jresp), q
        assert n == jn, q
        counts.append(n)
    # a league filter, or none, leaves the cube as tall as its rows: the
    # scan path
    assert counts == [3, 0, 0]


def test_stacked_engine_answers_from_the_cubes(multi):
    """The stacked engine's plan of segment 0 takes the cube as a fast
    path (query/plan.py's hook), so the query goes per segment
    (NotShardable) and the multi-segment cube answers it, as on the JAX
    mesh engine."""
    segs, plain, jsegs = multi
    eng = QueryEngine(segs, device="cpu", mesh=make_mesh(["cpu"]))
    eng_plain = QueryEngine(plain, device="cpu", mesh=make_mesh(["cpu"]))
    jax_eng = JaxQueryEngine(jsegs, mesh=jax_make_mesh())
    for q in (MULTI_QUERIES[0], QUERIES[1], QUERIES[3]):
        resp, n = _port_query(eng, q)
        jresp, jn = _jax_query(jax_eng, q)
        assert eng.last_route[0] == "NotShardable", q
        assert _result_key(resp) == _result_key(jresp), q
        assert _result_key(resp) == _result_key(eng_plain.query(q)), q
        assert n == jn == 3, q
    # a selection never takes a cube: it stacks
    eng.query("SELECT teamID, runs FROM baseballStats LIMIT 5")
    assert eng.last_route[0] == "stacked"


def test_execute_batch_takes_the_cubes(multi):
    """execute_batch: the multi-segment cube per member, and the
    per-segment cube where one segment is pruned away from the others."""
    segs, _plain, jsegs = multi
    eng = QueryEngine(segs, device="cpu")
    jax_eng = JaxQueryEngine(jsegs)
    pqls = [f"SELECT SUM(runs), COUNT(*) FROM baseballStats WHERE "
            f"teamID = '{t}'" for t in ("BOS", "NYA", "SEA", "TEX")] + \
        ["SELECT SUM(salary) FROM baseballStats WHERE teamID = 'BOS'"]
    reqs = [eng.optimizer.optimize(compile_pql(p)) for p in pqls]
    eng.executor.reset_path_counts()
    blocks = eng.executor.execute_batch(reqs, eng.segments)
    cubes = eng.executor.path_counts["cube"]
    jreqs = [jax_eng.optimizer.optimize(jax_compile_pql(p)) for p in pqls]
    prof = jax_profiler.QueryProfile("baseballStats")
    with jax_profiler.active(prof):
        jblocks = jax_eng.executor.execute_batch(jreqs, jax_eng.segments)
    for pql, req, blk, jreq, jblk in zip(pqls, reqs, blocks, jreqs,
                                         jblocks):
        got = _result_key(eng.reducer.reduce(req, [blk]))
        assert got == _result_key(eng.query(pql)), pql
        assert got == _result_key(jax_eng.reducer.reduce(jreq, [jblk])), pql
    assert cubes == prof.paths.get("cube", 0) == 4 * len(segs)


def test_execute_batch_per_segment_cube(multi):
    """One member whose pruned set is one segment takes that segment's
    own cube inside the batch loop (the per-segment branch)."""
    segs, _plain, jsegs = multi
    eng = QueryEngine(segs[:1], device="cpu")
    jax_eng = JaxQueryEngine(jsegs[:1])
    pql = "SELECT SUM(runs) FROM baseballStats WHERE teamID = 'BOS'"
    req = eng.optimizer.optimize(compile_pql(pql))
    eng.executor.reset_path_counts()
    blocks = eng.executor.execute_batch([req, req], eng.segments)
    assert eng.executor.path_counts["cube"] == 2
    for blk in blocks:
        assert _result_key(eng.reducer.reduce(req, [blk])) == \
            _result_key(jax_eng.query(pql))


def test_prefix_descent_narrows_and_matches(tmp_path):
    """Sorted-prefix cube descent (binary-search blocks) must agree with
    the plain path AND examine far fewer rows than the full cube."""
    from pinot_tpu_torch.query.aggregation import make_functions
    from pinot_tpu_torch.startree.executor import (_cube_select,
                                                   _eligible_cube)

    cfg = baseball.make_table_config()
    cfg.indexing_config.star_tree_configs = [{
        "dimensionsSplitOrder": ["teamID", "league", "yearID"],
        "functionColumnPairs": ["SUM__runs", "SUM__hits", "MAX__average"],
    }]
    cols = make_columns(30_000, seed=51)
    SegmentCreator(baseball.make_schema(), cfg, "st").build(
        dict(cols), str(tmp_path / "st"))
    seg = ImmutableSegmentLoader.load(str(tmp_path / "st"), device="cpu")
    seg_pl = _build_port(str(tmp_path / "pl"), cols, "pl", star_tree=False)
    cube = seg.star_trees[0]

    # cube rows must be sorted by split order (the descent's invariant)
    key = np.zeros(cube.n_groups, np.int64)
    for dim in cube.dimensions:
        card = seg.data_source(dim).metadata.cardinality
        key = key * card + cube.dim_ids[dim]
    assert (np.diff(key) > 0).all()

    eng_st = QueryEngine([seg], device="cpu")
    eng_pl = QueryEngine([seg_pl], device="cpu")
    prefix_qs = [
        "SELECT SUM(runs) FROM baseballStats WHERE teamID = 'BOS'",
        "SELECT SUM(runs), COUNT(*) FROM baseballStats WHERE teamID IN "
        "('BOS', 'SEA') AND league = 'AL' GROUP BY yearID TOP 100",
        "SELECT MAX(average) FROM baseballStats WHERE teamID = 'NYA' AND "
        "league = 'NL' AND yearID >= 2000",
        # RANGE on the first dim: one interval block, residual on yearID
        "SELECT SUM(hits) FROM baseballStats WHERE teamID >= 'NYA' AND "
        "yearID < 2005 GROUP BY league TOP 10",
    ]
    for q in prefix_qs:
        assert _result_key(eng_st.query(q)) == _result_key(eng_pl.query(q)), q

    # and the descent really narrows: examined rows << full cube
    req = BrokerRequestOptimizer().optimize(compile_pql(prefix_qs[1]))
    fns = make_functions(req.aggregations)
    assert _eligible_cube(seg, req, fns) is cube
    sel, examined = _cube_select(seg, cube, req.filter)
    assert examined < cube.n_groups / 4
    assert len(sel) <= examined


# ---------------------------------------------------------------------------
# The JAX bench's stage 1: SSB segments with the nine cubes
# ---------------------------------------------------------------------------

SSB_ROWS, SSB_SEGMENTS, SSB_SEED = 120_000, 2, 3


@pytest.fixture(scope="module")
def ssb_cubes(tmp_path_factory):
    base = str(tmp_path_factory.mktemp("ssb_st"))
    dirs, ids, cost = datagen.build_ssb_segment_dirs(
        base, SSB_ROWS, SSB_SEGMENTS, SSB_SEED, star_tree=True)
    port = QueryEngine.from_dirs(dirs, device="cpu")
    stacked = QueryEngine(port.segments, device="cpu",
                          mesh=make_mesh(["cpu"]))
    jax_eng = JaxQueryEngine.from_dirs(dirs)
    oracle = make_cpu_queries(jax_datagen.ssb_pools(SSB_SEED), ids, cost)
    return port, stacked, jax_eng, oracle


@pytest.mark.parametrize("q", sorted(SSB_PQLS))
def test_ssb_with_cubes_matches_jax_and_oracle(ssb_cubes, q):
    port, stacked, jax_eng, oracle = ssb_cubes
    resp, n = _port_query(port, SSB_PQLS[q])
    sresp, sn = _port_query(stacked, SSB_PQLS[q])
    jresp, jn = _jax_query(jax_eng, SSB_PQLS[q])
    assert n == sn == jn, q
    got = canon_response(q, resp)
    expected = oracle[q]()
    check(q, got, expected)
    check(q, canon_response(q, sresp), expected)
    check(q, canon_response(q, jresp), expected)
    assert resp.num_docs_scanned == jresp.num_docs_scanned
