"""Primary-key upsert on the port against the JAX package.

Twins of tests/test_upsert.py, each run through the port and the JAX
package on the same seeded inputs:

1. Bitmap semantics: ValidDocIds default-valid, versioned, windowed.
2. Masked query parity: segments of one directory (the JAX creator's)
   with the same rows superseded in both packages answer equal through
   the port per segment (K1's vdoc leaf, plain versions on the CPU), the
   port's host twin, the port's stacked engine ([S, P] liveness lane) and
   the JAX engine, and COUNT(*) equals the live rows exactly; a masked
   segment takes no whole-segment fast path, a bitmap without
   invalidations keeps them; a consuming segment's frozen prefix and
   tail count every row once and mask a straddling set of superseded
   rows once, also while a writer appends; cross-query batches
   (execute_batch, the twin of tests/test_batching.py:206) share one
   liveness lane and equal each member's own query.
3. Durability: snapshot + journal restore, torn and unterminated journal
   tails, key extraction, a lost snapshot forcing the fold, the fold of a
   committed segment, the stats history's torn file; and a journal and
   snapshot written by the JAX module restore in the port (the formats
   are the same).

Integer answers are equal; float sums agree to FLOAT_RTOL (float64 in
other orders). `cuda` tests hold K1's vdoc node, per segment, stacked and
batched, bit-equal to its plain version, and skip where there is no card.
"""
from __future__ import annotations

import json
import os
import threading

import numpy as np
import pytest
import torch

from fixtures import make_columns, make_schema, make_table_config
from pinot_tpu.common.faults import crash_points as jax_crash_points
from pinot_tpu.common.table_config import UpsertConfig as JaxUpsertConfig
from pinot_tpu.engine import QueryEngine as JaxQueryEngine
from pinot_tpu.parallel.sharded import make_mesh as jax_make_mesh
from pinot_tpu.pql.parser import compile_pql as jax_compile
from pinot_tpu.query import host_exec as jax_host
from pinot_tpu.query.combine import combine_blocks as jax_combine
from pinot_tpu.query.executor import ServerQueryExecutor as JaxExecutor
from pinot_tpu.query.reduce import BrokerReduceService as JaxReduce
from pinot_tpu.realtime import mutable_segment as jax_ms
from pinot_tpu.realtime import stats_history as jax_sh
from pinot_tpu.realtime import upsert as jax_up
from pinot_tpu.segment.creator import SegmentCreator
from pinot_tpu.segment.loader import ImmutableSegmentLoader as JaxLoader
from pinot_tpu_torch.common.faults import crash_points
from pinot_tpu_torch.common.schema import Schema
from pinot_tpu_torch.common.table_config import TableConfig, UpsertConfig
from pinot_tpu_torch.engine import QueryEngine
from pinot_tpu_torch.ops import kernels as tk
from pinot_tpu_torch.parallel import make_mesh
from pinot_tpu_torch.pql.parser import compile_pql
from pinot_tpu_torch.query import host_exec
from pinot_tpu_torch.query.combine import combine_blocks
from pinot_tpu_torch.query.executor import ServerQueryExecutor
from pinot_tpu_torch.query.plan import InstancePlanMaker, VALID_DOC_PRED
from pinot_tpu_torch.query.reduce import BrokerReduceService
from pinot_tpu_torch.realtime import mutable_segment as port_ms
from pinot_tpu_torch.realtime import stats_history as port_sh
from pinot_tpu_torch.realtime import upsert as port_up
from pinot_tpu_torch.segment.loader import ImmutableSegmentLoader
from test_torch_kernels import _in_list
from test_torch_sharded import ENGINE_PQLS, assert_same_answer

RT_TABLE = "baseballStats_REALTIME"
PACKAGES = {"jax": jax_up, "port": port_up}


def port_schema() -> Schema:
    return Schema.from_json_str(make_schema().to_json_str())


def port_table_config() -> TableConfig:
    return TableConfig.from_json_str(make_table_config().to_json_str())


@pytest.fixture(autouse=True)
def _clean_crash_points():
    crash_points.clear()
    jax_crash_points.clear()
    yield
    crash_points.clear()
    jax_crash_points.clear()


# ---------------------------------------------------------------------------
# 1. bitmap semantics
# ---------------------------------------------------------------------------


def test_upsert_config_json_roundtrip():
    """The port's TableConfig reads the JAX package's upsert table config
    and writes the same JSON; an absent upsertConfig stays None."""
    from test_upsert import upsert_rt_config
    jax_cfg = upsert_rt_config("f", "t")
    cfg = TableConfig.from_json_str(jax_cfg.to_json_str())
    assert cfg.upsert_config is not None and cfg.upsert_config.enabled
    assert cfg.upsert_config.primary_key_columns == ["playerName"]
    assert cfg.to_json() == jax_cfg.to_json()
    again = TableConfig.from_json_str(cfg.to_json_str())
    assert again.upsert_config.to_json() == cfg.upsert_config.to_json()
    assert port_table_config().upsert_config is None


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_valid_doc_ids_default_valid_and_versioned(pkg):
    vd = PACKAGES[pkg].ValidDocIds()
    assert vd.num_invalid == 0
    assert vd.valid_mask(0, 10).all()
    assert vd.invalidate(3)
    assert not vd.invalidate(3)          # idempotent
    v1 = vd.version
    assert vd.invalidate(40_000)         # growth
    assert vd.version > v1
    m = vd.valid_mask(0, 40_001)
    assert not m[3] and not m[40_000] and m.sum() == 40_001 - 2
    assert list(vd.valid_mask(2, 6)) == [True, False, True, True]
    assert list(vd.invalid_ids(50_000)) == [3, 40_000]


# ---------------------------------------------------------------------------
# 2. masked query parity
# ---------------------------------------------------------------------------


def _dead_docs(n, seed, kill):
    return np.random.default_rng(seed).choice(n, kill, replace=False)


@pytest.fixture(scope="module")
def masked(tmp_path_factory):
    """Two segment directories (the JAX creator's), each loaded by both
    packages with the same rows superseded; and the live mask."""
    dirs, alive = [], []
    for i in range(2):
        n, seed = 3000, 11 + i
        d = str(tmp_path_factory.mktemp(f"mseg{i}"))
        SegmentCreator(make_schema(), make_table_config(),
                       segment_name=f"mseg{i}").build(make_columns(n, seed),
                                                      d)
        dead = _dead_docs(n, seed, 300 + 57 * i)
        a = np.ones(n, bool)
        a[dead] = False
        dirs.append((d, dead))
        alive.append(a)
    return dirs, alive


def _load_masked(dirs, pkg):
    segs = []
    for d, dead in dirs:
        if pkg == "jax":
            seg, vd = JaxLoader.load(d), jax_up.ValidDocIds()
        else:
            seg, vd = ImmutableSegmentLoader.load(d), port_up.ValidDocIds()
        vd.invalidate_many(dead)
        seg.valid_doc_ids = vd
        segs.append(seg)
    return segs


@pytest.fixture(scope="module")
def masked_engines(masked):
    dirs, _ = masked
    port_segs = _load_masked(dirs, "port")
    return (QueryEngine(port_segs, device="cpu"),
            QueryEngine(port_segs, device="cpu", mesh=make_mesh(["cpu"])),
            JaxQueryEngine(_load_masked(dirs, "jax")),
            JaxQueryEngine(_load_masked(dirs, "jax"), mesh=jax_make_mesh()))


@pytest.mark.parametrize("name", sorted(ENGINE_PQLS))
def test_masked_results_port_paths_match_jax(masked_engines, name):
    """Per segment, host twin and stacked: the port's answers equal the
    JAX engine's over the same masked rows (the stacked port's the JAX
    stacked engine's: the two JAX routes differ on an empty SUM)."""
    seq, stacked, jax_seq, jax_stacked = masked_engines
    pql = ENGINE_PQLS[name]
    want = jax_seq.query(pql).to_json()
    assert_same_answer(want, seq.query(pql).to_json(), pql)
    assert_same_answer(jax_stacked.query(pql).to_json(),
                       stacked.query(pql).to_json(), pql)
    # the host twins, segment by segment, combined and reduced alike
    req = seq.optimizer.optimize(compile_pql(pql))
    blk = combine_blocks(req, [host_exec.execute_host(s, req)
                               for s in seq.segments])
    jreq = jax_seq.optimizer.optimize(jax_compile(pql))
    jblk = jax_combine(jreq, [jax_host.execute_host(s, jreq)
                              for s in jax_seq.segments])
    assert_same_answer(JaxReduce().reduce(jreq, [jblk]).to_json(),
                       seq.reducer.reduce(req, [blk]).to_json(), pql)


def test_masked_count_is_exact_and_stacked_route_masks(masked,
                                                       masked_engines):
    _dirs, alive = masked
    seq, stacked, _jax_seq, _jax_stacked = masked_engines
    total = sum(int(a.sum()) for a in alive)
    for engine in (seq, stacked):
        resp = engine.query("SELECT COUNT(*) FROM baseballStats")
        assert int(resp.aggregation_results[0].value) == total
    assert stacked.last_route == ("stacked", None)
    # the stack's liveness lane is [S, P] uint8, live rows 1, padding 0
    stack = stacked.sharded.stack_for(stacked.segments)
    lane = stack.vdoc_lane()
    assert lane.dtype == torch.uint8 and lane.shape == (2, stack.padded_docs)
    for i, a in enumerate(alive):
        np.testing.assert_array_equal(lane[i, : len(a)].numpy(), a)
        assert not lane[i, len(a):].any()
    # cached by the versions: no upload until a bitmap changes
    uploads = stack.vdoc_uploads
    assert stack.vdoc_lane() is lane and stack.vdoc_uploads == uploads


def test_vdoc_lane_follows_the_bitmap_version(tmp_path):
    """A new invalidation re-uploads the segment's lane (a stale mask is
    a wrong answer); an unchanged version reuses it."""
    d = str(tmp_path / "s")
    SegmentCreator(make_schema(), make_table_config(),
                   segment_name="vs").build(make_columns(1000, 4), d)
    seg = ImmutableSegmentLoader.load(d, device="cpu")
    seg.valid_doc_ids = port_up.ValidDocIds()
    seg.valid_doc_ids.invalidate(5)
    engine = QueryEngine([seg], device="cpu")
    q = "SELECT COUNT(*) FROM baseballStats"
    assert int(engine.query(q).aggregation_results[0].value) == 999
    lane = seg.device_valid_lane()
    assert seg.vdoc_uploads == 1 and seg.vdoc_upload_bytes == \
        seg.padded_docs
    assert int(engine.query(q).aggregation_results[0].value) == 999
    assert seg.vdoc_uploads == 1 and seg.device_valid_lane() is lane
    seg.valid_doc_ids.invalidate(6)
    assert int(engine.query(q).aggregation_results[0].value) == 998
    assert seg.vdoc_uploads == 2
    lane = seg.device_valid_lane()
    assert int(lane.sum()) == 998 and not lane[1000:].any()
    assert seg.device_bytes() >= seg.padded_docs
    seg.to("cpu")              # the same device: the lane stays
    assert seg.device_valid_lane() is lane and seg.vdoc_uploads == 2


def test_mask_disables_whole_segment_fast_paths(masked):
    dirs, alive = masked
    (d, dead), a = dirs[0], alive[0]
    cols = make_columns(3000, 11)
    seg = _load_masked([(d, dead)], "port")[0].to("cpu")
    maker = InstancePlanMaker()
    plan = maker.make_segment_plan(
        seg, compile_pql("SELECT COUNT(*) FROM baseballStats"))
    assert plan.fast_path_result is None
    assert plan.filter_spec == VALID_DOC_PRED
    assert plan.execute().agg_intermediates[0] == int(a.sum())
    plan = maker.make_segment_plan(
        seg, compile_pql(
            "SELECT COUNT(*) FROM baseballStats WHERE teamID = 'BOS'"))
    assert plan.fast_path_result is None
    assert plan.execute().agg_intermediates[0] == \
        int((a & (cols["teamID"] == "BOS")).sum())
    # selections and vector-free aggregations carry the leaf too
    plan = maker.make_segment_plan(seg, compile_pql(
        "SELECT playerName FROM baseballStats ORDER BY runs LIMIT 5"))
    assert plan.filter_spec == VALID_DOC_PRED
    # a bitmap with no invalidation keeps the fast paths
    seg.valid_doc_ids = port_up.ValidDocIds()
    plan = maker.make_segment_plan(
        seg, compile_pql("SELECT COUNT(*) FROM baseballStats"))
    assert plan.fast_path_result is not None


def _upsert_rows(n):
    return [{"teamID": "BOS", "league": "AL", "playerName": f"p{i}",
             "position": ["P"], "runs": 1, "hits": 1, "average": 0.5,
             "salary": 1.0, "yearID": 2000} for i in range(n)]


def test_mutable_frozen_tail_boundary_with_straddling_mask():
    """A tail view taken while the writer appends never double-counts or
    drops rows at the `start` boundary, and a mask straddling the
    boundary masks exactly once; the JAX executor agrees on the same
    rows."""
    seg = port_ms.MutableSegmentImpl(port_schema(), port_table_config(),
                                     "cons_upsert").to("cpu")
    jseg = jax_ms.MutableSegmentImpl(make_schema(), make_table_config(),
                                     "cons_upsert")
    seg.valid_doc_ids = port_up.ValidDocIds()
    jseg.valid_doc_ids = jax_up.ValidDocIds()
    rows = _upsert_rows(12_000)
    for r in rows[:9_000]:
        seg.index_row(r)
        jseg.index_row(r)
    frozen, _tail = seg.device_view()
    assert frozen is not None and frozen.num_docs == 9_000
    assert jseg.device_view()[0].num_docs == 9_000
    boundary = frozen.num_docs
    for r in rows[9_000:11_000]:
        seg.index_row(r)
        jseg.index_row(r)
    dead = [boundary - 3, boundary - 1, boundary, boundary + 2]
    for d in dead:
        seg.valid_doc_ids.invalidate(d)
        jseg.valid_doc_ids.invalidate(d)

    ex, red = ServerQueryExecutor(), BrokerReduceService()
    pql = "SELECT COUNT(*), SUM(runs) FROM baseballStats"

    def ask():
        req = compile_pql(pql)
        resp = red.reduce(req, [ex.execute(req, [seg])])
        assert resp.num_segments_processed == 1     # one LOGICAL segment
        assert resp.num_consuming_segments_queried == 1
        return (int(resp.aggregation_results[0].value),
                float(resp.aggregation_results[1].value))

    cnt, s = ask()
    assert cnt == 11_000 - len(dead) and s == cnt
    # the frozen prefix ran the kernels, the 2,000-row tail the host twin
    assert ex.path_counts["scan"] == 1 and ex.path_counts["host"] == 1
    assert ex.tail_docs == 2_000
    jreq = jax_compile(pql)
    jresp = JaxReduce().reduce(jreq, [JaxExecutor().execute(jreq, [jseg])])
    assert (int(jresp.aggregation_results[0].value),
            float(jresp.aggregation_results[1].value)) == (cnt, s)

    stop = threading.Event()

    def writer():
        for r in rows[11_000:]:
            seg.index_row(r)
            if stop.is_set():
                return

    t = threading.Thread(target=writer)
    t.start()
    try:
        for _ in range(20):
            cnt, s = ask()
            assert s == cnt, (s, cnt)
            assert 11_000 - len(dead) <= cnt <= 12_000 - len(dead)
    except BaseException:
        stop.set()          # a failed query stops the writer early
        raise
    finally:
        # the writer indexes every row before the final count: stopping
        # it when the queries end raced its last rows
        t.join(timeout=60)
    assert not t.is_alive()
    cnt, s = ask()
    assert cnt == 12_000 - len(dead) and s == cnt


def test_consuming_segment_on_the_engine_falls_back_from_the_mesh(masked):
    """A consuming segment among committed ones: the stacked engine sends
    the set the per-segment way (NotShardable), as the JAX engine does."""
    dirs, alive = masked
    segs = _load_masked(dirs, "port")
    cons = port_ms.MutableSegmentImpl(port_schema(), port_table_config(),
                                      "cons_engine")
    for r in _upsert_rows(9_000):
        cons.index_row(r)
    engine = QueryEngine(segs + [cons], device="cpu",
                         mesh=make_mesh(["cpu"]))
    resp = engine.query("SELECT COUNT(*) FROM baseballStats")
    assert int(resp.aggregation_results[0].value) == \
        sum(int(a.sum()) for a in alive) + 9_000
    assert engine.last_route[0] == "NotShardable"
    assert resp.num_segments_processed == 3
    assert resp.num_consuming_segments_queried == 1


BATCH_PQLS = ["SELECT COUNT(*), SUM(hits) FROM baseballStats "
              "WHERE runs > '%d'" % lit for lit in (10, 40, 75, 110, 130)]


def test_batched_equals_sequential_with_vdoc_mask(tmp_path):
    """The liveness lane is the segment's, shared by every member of a
    batch: each member equals its own query and the JAX package's."""
    port_segs, jax_segs = [], []
    for i in range(2):
        d = str(tmp_path / f"bt_{i}")
        SegmentCreator(make_schema(), make_table_config(),
                       segment_name=f"bt_{i}").build(
            make_columns(700, 70 + i), d)
        for segs, loader, up in ((port_segs, ImmutableSegmentLoader, port_up),
                                 (jax_segs, JaxLoader, jax_up)):
            seg = loader.load(d)
            seg.valid_doc_ids = up.ValidDocIds()
            for doc in range(0, 700, 7):       # mask 100 rows
                seg.valid_doc_ids.invalidate(doc)
            segs.append(seg)
    engine = QueryEngine(port_segs, device="cpu")
    jax_engine = JaxQueryEngine(jax_segs)
    reqs = [engine.optimizer.optimize(compile_pql(p)) for p in BATCH_PQLS]
    engine.executor.reset_path_counts()
    blocks = engine.executor.execute_batch(reqs, engine.segments)
    assert engine.executor.path_counts["scan"] == 2 * len(BATCH_PQLS)
    for pql, req, blk in zip(BATCH_PQLS, reqs, blocks):
        got = engine.reducer.reduce(req, [blk]).to_json()
        assert_same_answer(engine.query(pql).to_json(), got, pql)
        assert_same_answer(jax_engine.query(pql).to_json(), got, pql)
        live = sum(1 for doc in range(700) if doc % 7)
        assert int(got["numDocsScanned"]) <= 2 * live


# ---------------------------------------------------------------------------
# 3. durability units
# ---------------------------------------------------------------------------


def _kd(keys_docs):
    return [((k,), d) for k, d in keys_docs]


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_partition_metadata_snapshot_journal_restore(tmp_path, pkg):
    up = PACKAGES[pkg]
    p = up.PartitionUpsertMetadata(str(tmp_path), RT_TABLE, 0)
    p.apply_batch(0, _kd([("a", 0), ("b", 1), ("a", 2)]), 3)
    assert p.key_map_size() == 2 and p.upserted_rows == 1
    p.seal(0, 3, 3)
    p.apply_batch(1, _kd([("b", 0), ("c", 1)]), 5)
    p.close()
    r = up.PartitionUpsertMetadata(str(tmp_path), RT_TABLE, 0)
    assert r.key_map_size() == 3
    assert r._map[("a",)] == (0, 2)
    assert r._map[("b",)] == (1, 0)
    assert r._map[("c",)] == (1, 1)
    assert list(r.register_consuming(0).invalid_ids(3)) == [0, 1]
    assert r.snapshot_offset == 3 and r.replayed_offset == 5
    r.close()


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_partition_metadata_torn_journal_tail(tmp_path, pkg):
    up = PACKAGES[pkg]
    p = up.PartitionUpsertMetadata(str(tmp_path), RT_TABLE, 0)
    p.apply_batch(0, _kd([("a", 0), ("b", 1)]), 2)
    p.close()
    with open(os.path.join(str(tmp_path), "journal.jsonl"), "a") as fh:
        fh.write('{"seq": 0, "off": 9, "d": [[["c"')     # torn record
    r = up.PartitionUpsertMetadata(str(tmp_path), RT_TABLE, 0)
    assert r.key_map_size() == 2
    r.apply_batch(0, _kd([("c", 2)]), 3)
    r.close()
    r2 = up.PartitionUpsertMetadata(str(tmp_path), RT_TABLE, 0)
    assert r2.key_map_size() == 3
    r2.close()


def test_key_of_missing_or_unconvertible_values_returns_none(tmp_path):
    got = {}
    for pkg, up, cfg, schema in (
            ("jax", jax_up, JaxUpsertConfig, make_schema()),
            ("port", port_up, UpsertConfig, port_schema())):
        mgr = up.TableUpsertMetadataManager(
            RT_TABLE, cfg(mode="FULL", primary_key_columns=["runs"]),
            schema, str(tmp_path / pkg))
        got[pkg] = [mgr.key_of(r) for r in ({"runs": 5}, {"runs": "7"}, {},
                                            {"runs": None},
                                            {"runs": "xyz"})]
        mgr.close()
    assert got["port"] == got["jax"] == [(5,), (7,), None, None, None]


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_unterminated_final_journal_line_is_repaired(tmp_path, pkg):
    up = PACKAGES[pkg]
    p = up.PartitionUpsertMetadata(str(tmp_path), RT_TABLE, 0)
    p.apply_batch(0, _kd([("a", 0), ("b", 1)]), 2)
    p.close()
    with open(os.path.join(str(tmp_path), "journal.jsonl"), "rb+") as fh:
        fh.seek(0, 2)
        fh.truncate(fh.tell() - 1)           # chop the trailing \n
    r = up.PartitionUpsertMetadata(str(tmp_path), RT_TABLE, 0)
    assert r.key_map_size() == 2
    r.apply_batch(0, _kd([("c", 2)]), 3)
    r.close()
    r2 = up.PartitionUpsertMetadata(str(tmp_path), RT_TABLE, 0)
    assert r2.key_map_size() == 3
    r2.close()


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_lost_snapshot_forces_fold_despite_sidecars(tmp_path, pkg):
    up = PACKAGES[pkg]
    p = up.PartitionUpsertMetadata(str(tmp_path), RT_TABLE, 0)
    p.apply_batch(0, _kd([("a", 0), ("b", 1), ("a", 2)]), 3)
    p.seal(0, 3, 3)
    p.close()
    snap = [f for f in os.listdir(str(tmp_path))
            if f.startswith("keymap-") and f.endswith(".json")][0]
    with open(os.path.join(str(tmp_path), snap), "w") as fh:
        fh.write("{ corrupt")
    r = up.PartitionUpsertMetadata(str(tmp_path), RT_TABLE, 0)
    folds = []

    class _Seg:
        num_docs = 3

    vd = r.attach_or_fold(0, _Seg(), lambda: folds.append(1) or
                          [("a",), ("b",), ("a",)])
    assert folds and r.key_map_size() == 2
    assert r._map[("a",)] == (0, 2)
    assert list(vd.invalid_ids(3)) == [0]
    r.close()


def test_committed_segment_fold_when_durable_state_lost(tmp_path):
    """The loser-download path: a committed segment with no durable
    coverage folds its primary-key column into the exact mask, in the
    port as in the JAX package."""
    cols = make_columns(1000, seed=5)
    d = str(tmp_path / "seg")
    SegmentCreator(make_schema(), make_table_config(),
                   segment_name="baseballStats__0__0").build(cols, d)
    last = {}
    for i, name in enumerate(cols["playerName"]):
        last[str(name)] = i
    alive = np.zeros(1000, bool)
    alive[list(last.values())] = True
    masks = {}
    for pkg, up, cfg, schema, seg in (
            ("jax", jax_up, JaxUpsertConfig, make_schema(), JaxLoader.load(d)),
            ("port", port_up, UpsertConfig, port_schema(),
             ImmutableSegmentLoader.load(d))):
        mgr = up.TableUpsertMetadataManager(
            RT_TABLE, cfg(mode="FULL", primary_key_columns=["playerName"]),
            schema, str(tmp_path / f"upsert_{pkg}"))
        mgr.on_committed_segment("baseballStats__0__0", seg)
        assert (seg.valid_doc_ids.valid_mask(0, 1000) == alive).all()
        assert mgr.key_map_size() == len(last)
        key = (str(cols["playerName"][0]),)
        mgr.partition(0).apply_batch(1, [(key, 0)], 1)
        masks[pkg] = seg.valid_doc_ids.valid_mask(0, 1000)
        assert not masks[pkg][last[key[0]]]
        mgr.close()
    np.testing.assert_array_equal(masks["port"], masks["jax"])


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_stats_history_tolerates_torn_file(tmp_path, pkg):
    sh = {"jax": jax_sh, "port": port_sh}[pkg]
    path = str(tmp_path / "stats_history.json")
    with open(path, "w") as fh:
        fh.write('{"baseballStats_REALTIME": [{"numRo')      # torn
    with open(path + ".tmp", "w") as fh:
        fh.write("{ half a snapshot")
    h = sh.RealtimeSegmentStatsHistory(path)
    assert h.entries(RT_TABLE) == []
    h.add_segment_stats(RT_TABLE, {"numRowsIndexed": 5000, "columns": {}})
    r = sh.RealtimeSegmentStatsHistory(path)
    assert r.entries(RT_TABLE)[0]["numRowsIndexed"] == 5000
    assert r.estimate(RT_TABLE) == {"rows": 5000}


def _durable_ops(up, d):
    """Journal appends, two seals (snapshots and sidecars), a fold and a
    GC snapshot, the same in either package."""
    p = up.PartitionUpsertMetadata(d, RT_TABLE, 0)
    rng = np.random.default_rng(23)
    keys = [(f"k{i}", int(y)) for i, y in
            enumerate(rng.integers(1990, 2000, 40))]
    docs = rng.integers(0, 40, 300)
    p.apply_batch(0, [(keys[int(j)], i) for i, j in enumerate(docs[:150])],
                  150)
    p.seal(0, 150, 150)
    p.apply_batch(1, [(keys[int(j)], i) for i, j in
                      enumerate(docs[150:])], 300)
    p.seal(1, 300, 150)

    class _Seg:
        num_docs = 20

    p.attach_or_fold(2, _Seg(), lambda: [keys[i % 7] for i in range(20)])
    p.gc_segment(0)
    p.apply_batch(3, [(keys[int(j)], i) for i, j in enumerate(docs[:60])],
                  360)
    p.close()


def test_durable_files_are_byte_identical(tmp_path):
    """The port writes the JAX module's journal, snapshot and sidecar
    files byte for byte."""
    for pkg, up in PACKAGES.items():
        _durable_ops(up, str(tmp_path / pkg))
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "port"))
    assert any(n.startswith("validdocids-") for n in names)
    assert (tmp_path / "port" / "journal.jsonl").stat().st_size > 0
    for name in names:
        assert (tmp_path / "port" / name).read_bytes() == \
            (tmp_path / "jax" / name).read_bytes(), name


@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
def test_durable_state_restores_across_packages(tmp_path, writer, reader):
    """A partition directory written by one package (snapshot, sidecars,
    journal) restores in the other to the same map and bitmaps."""
    w = PACKAGES[writer].PartitionUpsertMetadata(str(tmp_path), RT_TABLE, 0)
    rng = np.random.default_rng(17)
    keys = [(f"k{i}", int(y)) for i, y in
            enumerate(rng.integers(1990, 2000, 60))]
    batch = [(keys[int(j)], doc) for doc, j in
             enumerate(rng.integers(0, 60, 200))]
    w.apply_batch(0, batch[:120], 120)
    w.seal(0, 120, 120)
    w.apply_batch(1, [(k, doc - 120) for k, doc in batch[120:]], 200)
    want_map = dict(w._map)
    want_bits = {s: list(w.register_consuming(s).invalid_ids(200))
                 for s in (0, 1)}
    w.close()
    r = PACKAGES[reader].PartitionUpsertMetadata(str(tmp_path), RT_TABLE, 0)
    assert {tuple(k): v for k, v in r._map.items()} == want_map
    assert {s: list(r.register_consuming(s).invalid_ids(200))
            for s in (0, 1)} == want_bits
    assert r.snapshot_offset == 120 and r.replayed_offset == 200
    r.close()
    with open(os.path.join(str(tmp_path), "keymap-0.json")) as fh:
        assert len(json.load(fh)["entries"]) > 0


# ---------------------------------------------------------------------------
# 4. the vdoc node on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _vdoc_lanes(P, num_docs, seed, device, n_segs=1):
    rng = np.random.default_rng(seed)
    ids = np.full((n_segs, P), 50, np.int8)
    ids[:, :num_docs] = rng.integers(0, 50, (n_segs, num_docs))
    live = (rng.random((n_segs, P)) < 0.7).astype(np.uint8)
    live[:, num_docs:] = 0
    return {"a.ids": torch.from_numpy(ids.reshape(-1)).to(device),
            f"{VALID_DOC_PRED[2]}.vdoc":
                torch.from_numpy(live.reshape(-1)).to(device)}


VDOC_SPECS = {
    "alone": (VALID_DOC_PRED, []),
    "and_eq": (("and", (VALID_DOC_PRED,
                        ("pred", "eq_id", "a", "sv", None))),
               [np.int32(7)]),
    "and_in": (("and", (VALID_DOC_PRED,
                        ("pred", "in_ids", "a", "sv", 4))),
               [_in_list([1, 9, 49], 4)]),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(VDOC_SPECS))
def test_vdoc_node_cuda_matches_plain(cuda_device, name):
    P = 16384
    spec, params = VDOC_SPECS[name]
    cols = _vdoc_lanes(P, P - 777, 3, cuda_device)
    tk.reset_launch_counts()
    got = tk.filter_mask(P, spec, cols, params, P - 777, cuda_device)
    assert tk.launch_counts()["filter_mask"] == 1
    want = tk.filter_mask_plain(P, spec, cols, params, P - 777,
                                cuda_device)
    assert torch.equal(got, want)
    # both instantiations take the node
    keys = tk.filter_lane_keys(spec)
    wide = tk._launch_filter(spec, cols, params, keys, cuda_device, P, P,
                             None, P - 777, None, general=True)
    assert torch.equal(wide, want)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(VDOC_SPECS))
def test_vdoc_node_stacked_cuda_matches_plain(cuda_device, name):
    P, S = 16384, 3
    spec, params = VDOC_SPECS[name]
    cols = _vdoc_lanes(P, P - 777, 5, cuda_device, n_segs=S)
    docs = torch.tensor([P - 777, P - 9000, P], dtype=torch.int32,
                        device=cuda_device)
    got = tk.filter_mask_stacked(P, S, spec, cols, params, docs)
    want = tk.filter_mask_stacked_plain(P, S, spec, cols, params, docs)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.cuda
@pytest.mark.parametrize("n", (2, 8))
def test_vdoc_node_batched_cuda_matches_plain(cuda_device, n):
    P = 16384
    spec = VDOC_SPECS["and_eq"][0]
    cols = _vdoc_lanes(P, P - 777, 7, cuda_device)
    members = [[np.int32(b * 5)] for b in range(n)]
    tk.reset_launch_counts()
    got = tk.filter_mask_batched(P, spec, cols, members, P - 777)
    assert tk.launch_counts()["filter_mask_batched"] == 1
    want = tk.filter_mask_batched_plain(P, spec, cols, members, P - 777)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.cuda
def test_masked_engine_cuda_matches_cpu(masked):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    dirs, _ = masked
    for mesh in (None, make_mesh()):
        card = QueryEngine(_load_masked(dirs, "port"), mesh=mesh)
        cpu = QueryEngine(_load_masked(dirs, "port"), device="cpu",
                          mesh=None if mesh is None else make_mesh(["cpu"]))
        tk.reset_launch_counts()
        for pql in ENGINE_PQLS.values():
            assert_same_answer(cpu.query(pql).to_json(),
                               card.query(pql).to_json(), pql)
        assert tk.launch_counts()["filter_mask"] > 0
