"""Multi-stage joins on the port against the JAX package.

Twins of the in-process join tests of tests/test_stages.py, run through
both packages on the same inputs:

1. Join parity: segments of one directory set (the JAX creator's,
   tools/datagen.py:build_join_table_dirs) loaded by both loaders, and a
   JoinContext per package built from the same numpy dim arrays. The
   port's per-segment plan (K1's member or join_raw leaf, K3's jcode /
   jraw keys; plain versions on the CPU), its stacked plan (CPU mesh) and
   its host twin equal the JAX device answer group by group (compared as
   dicts: top-N tie order may differ) and join_oracle exactly: the
   dictionary-keyed shape with a dim and a fact filter, a raw fact key,
   an empty dim side, dim keys unrepresentable in the fact dtype, and an
   upsert ValidDocIds whose killed rows never join.
2. Typed errors: StageCompileError for duplicate or non-integer dim
   keys, an unshipped dim column, a missing, multi-value or float fact
   key, and QueryEngine handed a join or a window.
3. Exchange: put / get / TTL / capacity, a local fetch round trip
   byte-identical, a source outside the process fetched over TCP (a
   typed ExchangeError where nothing listens), filter_sources,
   build_context over published stage-1 blocks (stage 1 through the
   port's executor) equal to a context built from the arrays, and two
   port ServerInstances exchanging J2.1's dim block over TCP.
4. Kernels: K1's join_raw leaf (plain) against the JAX `_eval_pred`
   kind join_raw on the same padded keys, int32 and int64 lanes; K3's
   jcode and jraw key terms against `_group_key`; the join's dim-side
   sort (K12 as radix_sort_join) against numpy.

`cuda` tests hold K1's join_raw leaf (single segment, stacked and
batched: B members with their own dim sides in one launch, also against
B single launches) and K3's jcode / jraw keys to their plain versions
and the card's join answers to the CPU's; they skip where there is no
card.
"""
from __future__ import annotations

import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pinot_tpu.common.table_config import IndexingConfig as JaxIndexing
from pinot_tpu.common.table_config import TableConfig as JaxTableConfig
from pinot_tpu.ops import kernels as jk
from pinot_tpu.pql.parser import compile_pql as jax_compile
from pinot_tpu.query.executor import ServerQueryExecutor as JaxExecutor
from pinot_tpu.query.reduce import BrokerReduceService as JaxReduce
from pinot_tpu.query.stages import join as jax_join
from pinot_tpu.realtime import upsert as jax_up
from pinot_tpu.segment.creator import SegmentCreator as JaxCreator
from pinot_tpu.segment.loader import ImmutableSegmentLoader as JaxLoader
from pinot_tpu.tools import datagen as jax_datagen
from pinot_tpu_torch.common.datatable import DataTable
from pinot_tpu_torch.engine import QueryEngine
from pinot_tpu_torch.ops import kernels as tk
from pinot_tpu_torch.parallel import make_mesh
from pinot_tpu_torch.parallel.sharded import NotShardable, \
    ShardedQueryExecutor
from pinot_tpu_torch.pql.parser import compile_pql
from pinot_tpu_torch.query import host_exec
from pinot_tpu_torch.query.combine import combine_blocks
from pinot_tpu_torch.query.executor import ServerQueryExecutor
from pinot_tpu_torch.query.plan import EMPTY, InstancePlanMaker, \
    _resolve_join_pred
from pinot_tpu_torch.query.reduce import BrokerReduceService
from pinot_tpu_torch.query.stages import broker as stages_broker
from pinot_tpu_torch.query.stages import exchange as xmod
from pinot_tpu_torch.query.stages import join as jmod
from pinot_tpu_torch.query.stages.errors import StageCompileError
from pinot_tpu_torch.realtime import upsert as port_up
from pinot_tpu_torch.segment.loader import ImmutableSegmentLoader
from pinot_tpu_torch.tools import datagen

J21 = ("SELECT SUM(lineorderj.lo_revenue), COUNT(*) FROM lineorderj "
       "JOIN part ON lineorderj.lo_partkey = part.p_partkey "
       "WHERE part.p_mfgr = 'MFGR#2' AND lineorderj.lo_quantity < 30 "
       "GROUP BY part.p_brand1, lineorderj.d_year TOP 5000")
JOIN_PQLS = {
    "j21_dim_and_fact_filter": (J21, lambda d: d["p_mfgr"] == "MFGR#2",
                                lambda f: f["lo_quantity"] < 30,
                                ["part.p_brand1", "lineorderj.d_year"]),
    "category_group": (
        "SELECT SUM(lineorderj.lo_revenue), COUNT(*) FROM lineorderj "
        "JOIN part ON lineorderj.lo_partkey = part.p_partkey "
        "GROUP BY part.p_category TOP 100", None, None, ["part.p_category"]),
    "no_group_fact_filter": (
        "SELECT SUM(lineorderj.lo_revenue), COUNT(*) FROM lineorderj "
        "JOIN part ON lineorderj.lo_partkey = part.p_partkey "
        "WHERE part.p_category = 'MFGR#12' AND lineorderj.lo_quantity < 25",
        lambda d: d["p_category"] == "MFGR#12",
        lambda f: f["lo_quantity"] < 25, []),
}


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


def _sub(cols, mask):
    return {k: v[mask] for k, v in cols.items()}


def _contexts(request, jrequest, dim, dim_filter):
    """The port's and the JAX JoinContext over the same dim arrays."""
    d = dim if dim_filter is None else _sub(dim, np.asarray(dim_filter(dim)))
    keys = d[request.join.dim_key].astype(np.int64)
    cols = {c: d[c] for c in request.join.dim_columns}
    return (jmod.JoinContext(request.join, keys, cols),
            jax_join.JoinContext(jrequest.join, keys, cols))


def _attach(request, ctx):
    out = copy.copy(request)
    out._join_ctx = ctx
    return out


def _as_dict(resp, fi):
    agg = resp["aggregationResults"][fi]
    if agg.get("groupByResult") is None:
        return {(): float(agg["value"])}
    return {tuple(g["group"]): float(g["value"])
            for g in agg["groupByResult"]}


def _oracle_dict(dim, fact, dim_filter, fact_filter, group_cols):
    f = fact if fact_filter is None else \
        _sub(fact, np.asarray(fact_filter(fact)))
    o = datagen.join_oracle(dim, f, dim_filter=dim_filter,
                            group_cols=group_cols)
    if not group_cols:
        return [{(): float(o["sum_revenue"])}, {(): float(o["count"])}]
    return [{tuple(str(x) for x in k): float(v[i])
             for k, v in o["groups"].items()} for i in range(2)]


def _port_answers(pql, ctx, segs):
    """{path: response JSON}: per segment, stacked, host twin."""
    req = compile_pql(pql)
    r = _attach(req, ctx)
    red = BrokerReduceService()
    out = {"per_segment": red.reduce(
        req, [ServerQueryExecutor().execute(r, segs)]).to_json(),
        "host": red.reduce(req, [combine_blocks(
            r, [host_exec.execute_host(s, r) for s in segs])]).to_json()}
    if len(segs) > 1:
        out["stacked"] = red.reduce(req, [_stacked(r, segs, ["cpu"])]
                                    ).to_json()
    return out


def _stacked(r, segs, devices):
    """The stacked executor. It refuses the fast-path plan of a join
    whose match is empty, and that set runs per segment, as QueryEngine
    runs it; any other refusal fails the test."""
    try:
        return ShardedQueryExecutor(mesh=make_mesh(devices)).execute(r, segs)
    except NotShardable:
        if _resolve_join_pred(r._join_ctx, segs[0])[0] != EMPTY:
            raise
        return ServerQueryExecutor().execute(r, segs)


def _jax_answer(pql, ctx, segs):
    req = jax_compile(pql)
    return JaxReduce().reduce(req, [JaxExecutor(use_device=True).execute(
        _attach(req, ctx), segs)]).to_json()


def _check_all(pql, port_ctx, jax_ctx, segs, jsegs, want=None):
    jax_resp = _jax_answer(pql, jax_ctx, jsegs)
    n_aggs = len(jax_resp["aggregationResults"])
    for path, resp in _port_answers(pql, port_ctx, segs).items():
        for fi in range(n_aggs):
            assert _as_dict(resp, fi) == _as_dict(jax_resp, fi), (path, fi)
            if want is not None:
                got = {tuple(str(x) for x in k): v
                       for k, v in _as_dict(resp, fi).items()}
                assert got == want[fi], (path, fi)
    return jax_resp


# ---------------------------------------------------------------------------
# 1. join parity
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def join_fixture(tmp_path_factory):
    """The JAX creator's join tables, loaded by both packages."""
    base = str(tmp_path_factory.mktemp("join"))
    fact_dirs, _dim_dirs, dim, fact = jax_datagen.build_join_table_dirs(
        base, fact_rows=12000, num_fact_segments=3, dim_rows=400, seed=5)
    return ([ImmutableSegmentLoader.load(d, device="cpu")
             for d in fact_dirs], [JaxLoader.load(d) for d in fact_dirs],
            dim, fact)


@pytest.mark.parametrize("name", sorted(JOIN_PQLS))
def test_join_parity_per_segment_stacked_host_jax_oracle(join_fixture,
                                                         name):
    segs, jsegs, dim, fact = join_fixture
    pql, dim_filter, fact_filter, group_cols = JOIN_PQLS[name]
    ctx, jctx = _contexts(compile_pql(pql), jax_compile(pql), dim,
                          dim_filter)
    _check_all(pql, ctx, jctx, segs, jsegs,
               _oracle_dict(dim, fact, dim_filter, fact_filter, group_cols))


def test_join_plans_member_leaf_and_jcode_key(join_fixture):
    """A dictionary fact key: the join match is K1's member leaf, ANDed
    in first, and the dim group key is K3's jcode over the dictionary;
    no whole-segment fast path is taken."""
    segs, _jsegs, dim, _fact = join_fixture
    pql = JOIN_PQLS["j21_dim_and_fact_filter"][0]
    ctx, _ = _contexts(compile_pql(pql), jax_compile(pql), dim,
                       JOIN_PQLS["j21_dim_and_fact_filter"][1])
    plan = InstancePlanMaker().make_segment_plan(
        segs[0], _attach(compile_pql(pql), ctx))
    assert plan.fast_path_result is None
    assert plan.filter_spec[0] == "and"
    assert plan.filter_spec[1][0][:3] == ("pred", "member", "lo_partkey")
    gcols = plan.group_spec[0]
    assert gcols[0][:2] == ("lo_partkey", "jcode")
    assert plan.group_params[0].dtype == np.int32
    # COUNT(*) with no filter still scans: metadata counts unjoined rows
    plan = InstancePlanMaker().make_segment_plan(
        segs[0], _attach(compile_pql(
            "SELECT COUNT(*) FROM lineorderj JOIN part ON "
            "lineorderj.lo_partkey = part.p_partkey"), ctx))
    assert plan.fast_path_result is None


@pytest.fixture(scope="module")
def raw_key_fixture(tmp_path_factory):
    """The JAX config of tests/test_stages.py:255-283, lo_partkey without
    a dictionary, over three segments of consecutive rows (so the stacked
    path runs join_raw and jraw over the stack's raw lane), loaded by both
    packages."""
    dim, fact = jax_datagen.make_join_rows(6000, dim_rows=250, seed=9)
    cfg = JaxTableConfig("lineorderj", indexing_config=JaxIndexing(
        no_dictionary_columns=["lo_partkey"]))
    base = tmp_path_factory.mktemp("rawk")
    dirs = []
    for i in range(3):
        d = str(base / f"seg{i}")
        JaxCreator(jax_datagen.fact_join_schema(), cfg,
                   segment_name=f"rawk_{i}").build(
            {k: v[i * 2000:(i + 1) * 2000] for k, v in fact.items()}, d)
        dirs.append(d)
    return ([ImmutableSegmentLoader.load(d, device="cpu") for d in dirs],
            [JaxLoader.load(d) for d in dirs], dim, fact)


@pytest.mark.parametrize("name", sorted(JOIN_PQLS))
def test_raw_key_join_parity(raw_key_fixture, name):
    """A raw fact key: K1's join_raw leaf and K3's jraw key over the dim
    keys sorted by K12's plain version, against JAX and the oracle."""
    segs, jsegs, dim, fact = raw_key_fixture
    pql, dim_filter, fact_filter, group_cols = JOIN_PQLS[name]
    ctx, jctx = _contexts(compile_pql(pql), jax_compile(pql), dim,
                          dim_filter)
    plan = InstancePlanMaker().make_segment_plan(
        segs[0], _attach(compile_pql(pql), ctx))
    join_leaf = plan.filter_spec[1][0] if plan.filter_spec[0] == "and" \
        else plan.filter_spec
    assert join_leaf[1] == "join_raw"
    assert isinstance(plan.params[0], tk.SortedKeys)
    if group_cols and group_cols[0].startswith("part."):
        assert plan.group_spec[0][0][1] == "jraw"
    _check_all(pql, ctx, jctx, segs, jsegs,
               _oracle_dict(dim, fact, dim_filter, fact_filter, group_cols))


def test_raw_key_join_runs_stacked_over_the_raw_lane(raw_key_fixture,
                                                    monkeypatch):
    """The stacked executor takes a raw-key join whole: one stacked plan
    whose K1 program holds the join_raw leaf and whose group key (K14's,
    up the kmax ladder, a dispatch a rung) is jraw, both over the stack's
    raw lane [S, P], equal to join_oracle."""
    segs, _jsegs, dim, fact = raw_key_fixture
    pql, dim_filter, fact_filter, group_cols = JOIN_PQLS["category_group"]
    ctx, _ = _contexts(compile_pql(pql), jax_compile(pql), dim, dim_filter)
    seen = []
    real = tk.run_stacked_kernel

    def spy(padded, n_segs, filter_spec, agg_specs, group_spec, *rest):
        seen.append((padded, n_segs, filter_spec, group_spec,
                     tuple(rest[1]["lo_partkey.raw"].shape)))
        return real(padded, n_segs, filter_spec, agg_specs, group_spec,
                    *rest)

    monkeypatch.setattr(tk, "run_stacked_kernel", spy)
    req = compile_pql(pql)
    blk = ShardedQueryExecutor(mesh=make_mesh(["cpu"])).execute(
        _attach(req, ctx), segs)
    assert seen and seen[0][3][4] > 0        # compacted, from rung one
    for padded, n_segs, fspec, gspec, lane_shape in seen:
        assert n_segs == len(segs) == 3 and lane_shape == (n_segs, padded)
        assert fspec[:3] == ("pred", "join_raw", "lo_partkey")
        assert gspec[0][0][:2] == ("lo_partkey", "jraw")
    got = BrokerReduceService().reduce(req, [blk]).to_json()
    want = _oracle_dict(dim, fact, dim_filter, fact_filter, group_cols)
    for fi in range(2):
        assert {tuple(str(x) for x in k): v for k, v in
                _as_dict(got, fi).items()} == want[fi]


def test_raw_key_join_sorts_dim_side_once_per_query(raw_key_fixture):
    """The JoinContext caches its sorted probe: two plans of one query
    share one SortedKeys, and its sort runs once per device."""
    segs, _jsegs, dim, _fact = raw_key_fixture
    pql = JOIN_PQLS["category_group"][0]
    ctx, _ = _contexts(compile_pql(pql), jax_compile(pql), dim, None)
    req = _attach(compile_pql(pql), ctx)
    a = InstancePlanMaker().make_segment_plan(segs[0], req)
    b = InstancePlanMaker().make_segment_plan(segs[0], req)
    assert a.params[0] is b.params[0]
    assert a.group_params[0] is b.group_params[0]
    sk, codes = a.group_params[0].on("cpu")
    assert a.group_params[0].on("cpu")[0] is sk
    assert torch.equal(sk, torch.sort(sk).values)
    # the codes ride with their keys
    keys, kcodes = ctx.padded_key_codes("p_category", np.int32)
    order = np.argsort(keys, kind="stable")
    np.testing.assert_array_equal(sk.numpy(), keys[order])
    np.testing.assert_array_equal(codes.numpy(), kcodes[order])


def test_join_empty_dim_side(join_fixture):
    segs, jsegs, _dim, _fact = join_fixture
    pql = ("SELECT COUNT(*) FROM lineorderj JOIN part "
           "ON lineorderj.lo_partkey = part.p_partkey")
    ctx = jmod.JoinContext(compile_pql(pql).join, np.zeros(0, np.int64), {})
    jctx = jax_join.JoinContext(jax_compile(pql).join,
                                np.zeros(0, np.int64), {})
    jax_resp = _check_all(pql, ctx, jctx, segs, jsegs)
    assert float(jax_resp["aggregationResults"][0]["value"]) == 0


def test_raw_key_join_with_unrepresentable_dim_keys_is_empty(
        raw_key_fixture):
    segs, jsegs, _dim, _fact = raw_key_fixture
    pql = ("SELECT COUNT(*) FROM lineorderj JOIN part "
           "ON lineorderj.lo_partkey = part.p_partkey")
    huge = np.array([2 ** 40, 2 ** 41], dtype=np.int64)   # > int32
    ctx = jmod.JoinContext(compile_pql(pql).join, huge, {})
    jctx = jax_join.JoinContext(jax_compile(pql).join, huge, {})
    assert ctx.sorted_keys(np.int32) is None
    jax_resp = _check_all(pql, ctx, jctx, segs, jsegs)
    assert float(jax_resp["aggregationResults"][0]["value"]) == 0


@pytest.mark.parametrize("fixture", ["join_fixture", "raw_key_fixture"])
def test_join_upsert_mask_never_leaks(request, fixture):
    """Killed (upsert-superseded) fact rows never join: the port's
    device and host paths equal JAX's with the same rows killed, and the
    COUNT is exactly the live joined rows."""
    segs, jsegs, dim, fact = request.getfixturevalue(fixture)
    seg, jseg = segs[0], jsegs[0]
    pql = ("SELECT SUM(lineorderj.lo_revenue), COUNT(*) FROM lineorderj "
           "JOIN part ON lineorderj.lo_partkey = part.p_partkey "
           "GROUP BY part.p_mfgr TOP 100")
    ctx, jctx = _contexts(compile_pql(pql), jax_compile(pql), dim, None)
    base = _port_answers(pql, ctx, [seg])["per_segment"]
    killed = [0, 5, 17, 100, 1999]
    vd, jvd = port_up.ValidDocIds(), jax_up.ValidDocIds()
    for d in killed:
        vd.invalidate(d)
        jvd.invalidate(d)
    seg.valid_doc_ids, jseg.valid_doc_ids = vd, jvd
    try:
        _check_all(pql, ctx, jctx, [seg], [jseg])
        got = _port_answers(pql, ctx, [seg])["per_segment"]
        assert got["aggregationResults"] != base["aggregationResults"]
        n = seg.num_docs
        keys = np.sort(dim["p_partkey"].astype(np.int64))
        fk = fact["lo_partkey"][:n].astype(np.int64)
        pos = np.clip(np.searchsorted(keys, fk), 0, len(keys) - 1)
        alive = keys[pos] == fk
        alive[killed] = False
        assert sum(_as_dict(got, 1).values()) == int(alive.sum())
    finally:
        seg.valid_doc_ids = jseg.valid_doc_ids = None


def test_join_batch_members_run_alone_with_a_join_raw_leaf(
        raw_key_fixture, join_fixture, monkeypatch):
    """execute_batch: raw-key join members (join_raw leaf) now share one
    batched K1 per segment, as the JAX executor batches them (its
    batch_signature lets them); dictionary-key join members batch through
    the member leaf. Members carry different dim sides (two dim filters),
    so the batched leaf probes each member's own keys. Every member
    equals its own execution and the JAX execute_batch's answer on the
    same requests; on the CPU the batched K1's plain version runs, so the
    launches are counted at its wrapper: one call a segment, with every
    member, for the raw key."""
    seen = []
    real = tk.filter_mask_batched

    def spy(padded, spec, cols, params_list, *rest, **kw):
        seen.append((tk._has_leaf(spec, "join_raw"), len(params_list)))
        return real(padded, spec, cols, params_list, *rest, **kw)

    monkeypatch.setattr(tk, "filter_mask_batched", spy)
    dim_filters = (None, lambda d: d["p_category"] != "MFGR#13")
    for raw, (segs, jsegs, dim) in (
            (True, (raw_key_fixture[0], raw_key_fixture[1],
                    raw_key_fixture[2])),
            (False, (join_fixture[0], join_fixture[1], join_fixture[2]))):
        pqls = [("SELECT SUM(lineorderj.lo_revenue), COUNT(*) FROM "
                 "lineorderj JOIN part ON lineorderj.lo_partkey = "
                 f"part.p_partkey WHERE lineorderj.lo_quantity < {q}")
                for q in (10, 25, 40)]
        reqs, jreqs = [], []
        for i, pql in enumerate(pqls):
            ctx, jctx = _contexts(compile_pql(pql), jax_compile(pql), dim,
                                  dim_filters[i % 2])
            reqs.append(_attach(compile_pql(pql), ctx))
            jreqs.append(_attach(jax_compile(pql), jctx))
        seen.clear()
        blocks = ServerQueryExecutor().execute_batch(reqs, segs)
        if raw:
            assert seen == [(True, len(pqls))] * len(segs), seen
        jblocks = JaxExecutor(use_device=True).execute_batch(jreqs, jsegs)
        red = BrokerReduceService()
        for pql, req, blk, jblk in zip(pqls, reqs, blocks, jblocks):
            got = red.reduce(req, [blk]).to_json()
            assert got["aggregationResults"] == red.reduce(
                req, [ServerQueryExecutor().execute(req, segs)]
            ).to_json()["aggregationResults"]
            want = JaxReduce().reduce(jax_compile(pql), [jblk]).to_json()
            for fi in range(2):
                assert _as_dict(got, fi) == _as_dict(want, fi), (raw, pql)


@pytest.mark.parametrize("group_cols", [
    [], ["lineorderj.d_year"], ["part.p_mfgr"],
    ["part.p_brand1", "lineorderj.d_year"]])
def test_join_oracle_matches_jax_oracle(group_cols):
    """The port's join_oracle (grouped with array ops) gives the JAX
    oracle's dict, keys and value types alike."""
    dim, fact = jax_datagen.make_join_rows(50_000, dim_rows=700, seed=4)
    dim_filter = lambda d: d["p_category"] != "MFGR#13"  # noqa: E731
    assert datagen.join_oracle(dim, fact, dim_filter, group_cols) == \
        jax_datagen.join_oracle(dim, fact, dim_filter, group_cols)
    port_dim, port_fact = datagen.make_join_rows(50_000, dim_rows=700,
                                                 seed=4)
    for a, b in ((port_dim, dim), (port_fact, fact)):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])


# ---------------------------------------------------------------------------
# 2. typed errors
# ---------------------------------------------------------------------------


def test_join_context_typed_errors():
    spec = compile_pql("SELECT COUNT(*) FROM f JOIN part ON f.k = "
                       "part.pk").join
    with pytest.raises(StageCompileError):          # duplicate dim keys
        jmod.JoinContext(spec, np.array([1, 2, 2], np.int64), {})
    with pytest.raises(StageCompileError):          # non-integer keys
        jmod.JoinContext(spec, np.array(["a", "b"], dtype=object), {})
    ctx = jmod.JoinContext(spec, np.array([3, 1, 7], np.int64), {})
    with pytest.raises(StageCompileError):          # unshipped dim column
        ctx.dim_values("missing")
    hit, dimrow = ctx.probe_values(np.array([1, 2, 7]))
    assert hit.tolist() == [True, False, True]
    assert dimrow[hit].tolist() == [1, 2]


@pytest.mark.parametrize("fact_key", ["nosuch", "lo_revenue_f", "tags"])
def test_fact_key_contract_is_typed(tmp_path, fact_key):
    """A missing, float or multi-value fact key raises StageCompileError
    when the context attaches (join.attach checks the first segment, as
    the JAX server does), and an existing one from the planner and the
    host twin too."""
    from pinot_tpu_torch.common.datatype import DataType
    from pinot_tpu_torch.common.schema import Schema, dimension, metric
    from pinot_tpu_torch.segment.creator import SegmentCreator
    schema = Schema("lineorderj", [
        dimension("lo_partkey", DataType.INT),
        metric("lo_revenue_f", DataType.DOUBLE),
        dimension("tags", DataType.INT, single_value=False)])
    rng = np.random.default_rng(1)
    rows = {"lo_partkey": rng.integers(0, 50, 300).astype(np.int32),
            "lo_revenue_f": rng.random(300),
            "tags": [list(rng.integers(0, 9, 2)) for _ in range(300)]}
    d = str(tmp_path / "s")
    SegmentCreator(schema, None, segment_name="s").build(rows, d)
    seg = ImmutableSegmentLoader.load(d, device="cpu")
    pql = (f"SELECT COUNT(*) FROM lineorderj JOIN part ON "
           f"lineorderj.{fact_key} = part.p_partkey")
    req = compile_pql(pql)
    ctx = jmod.JoinContext(req.join, np.arange(5, dtype=np.int64), {})
    with pytest.raises(StageCompileError):
        jmod.attach(req, ctx, [seg])
    if fact_key == "nosuch":
        return                  # the pruner drops a segment without it
    r = _attach(req, ctx)
    with pytest.raises(StageCompileError):
        ServerQueryExecutor().execute(r, [seg])
    with pytest.raises(StageCompileError):
        host_exec.execute_host(seg, r)


@pytest.mark.parametrize("pql", [
    JOIN_PQLS["category_group"][0],
    "SELECT d_year, ROW_NUMBER() OVER (PARTITION BY d_year ORDER BY "
    "lo_revenue DESC) FROM lineorderj LIMIT 10"])
def test_query_engine_refuses_join_and_window_typed(join_fixture, pql):
    """QueryEngine has no stage plane (nor does the JAX one): a join or a
    window raises the typed StageCompileError the JAX server raises for
    a join without exchange sources, never NotPorted."""
    segs = join_fixture[0]
    engine = QueryEngine(segs, device="cpu")
    with pytest.raises(StageCompileError, match="without exchange sources"):
        engine.query(pql)


# ---------------------------------------------------------------------------
# 3. exchange
# ---------------------------------------------------------------------------


def test_exchange_manager_put_get_ttl_and_capacity():
    clock = [0.0]
    m = xmod.ExchangeManager(ttl_s=10.0, max_bytes=100,
                             clock=lambda: clock[0])
    try:
        m.put("a", b"x" * 60)
        assert m.get("a") == b"x" * 60 and m.held_bytes() == 60
        with pytest.raises(Exception):              # over the byte budget
            m.put("b", b"y" * 60)
        assert m.held_bytes() == 60                 # the books unchanged
        m.put("a", b"z" * 90)                       # a republish replaces
        assert m.held_bytes() == 90
        clock[0] = 11.0                             # TTL expiry frees space
        assert m.get("a") is None and m.held_bytes() == 0
        m.put("b", b"y" * 60, ttl_s=5.0)
        clock[0] = 17.0
        assert m.sweep_expired() == 60 and len(m) == 0
    finally:
        m.close()


def test_exchange_frame_local_fetch_and_not_ported_remote():
    m = xmod.ExchangeManager()
    try:
        dt = DataTable()
        dt.metadata["k"] = "v"
        payload = dt.to_bytes()
        m.put("x1.0", payload)
        assert m.handle_frame(xmod.fetch_frame("x1.0")) == payload
        miss = DataTable.from_bytes(m.handle_frame(xmod.fetch_frame("no")))
        assert any("ExchangeMissError" in e for e in miss.exceptions)
        src = {"server": "s", "xkey": m.xkey, "id": "x1.0"}
        got = xmod.fetch_blocks([src, src], None)
        assert [g.to_bytes() for g in got] == [payload, payload]
        assert got[0].metadata["k"] == "v"
        with pytest.raises(xmod.ExchangeError):
            xmod.fetch_blocks([{"server": "s", "xkey": m.xkey,
                                "id": "gone"}], None)
        # a source outside the process goes over TCP: nothing listens on
        # port 1, so the fetch fails typed (the TCP fetch itself:
        # test_exchange_fetch_over_tcp_between_two_instances)
        remote = {"server": "peer", "xkey": "elsewhere", "id": "x1.0",
                  "host": "127.0.0.1", "port": 1}
        with pytest.raises(xmod.ExchangeError):
            xmod.fetch_blocks([remote], 2.0)
    finally:
        m.close()
    # a closed manager leaves the registry: neither local nor addressable
    with pytest.raises(xmod.ExchangeError, match="neither local"):
        xmod.fetch_blocks([src], None)


def test_filter_sources_copartitioned():
    sources = [
        {"server": "a", "id": "x1", "partitions": [0],
         "partitionFunction": "Modulo", "numPartitions": 2},
        {"server": "b", "id": "x2", "partitions": [1],
         "partitionFunction": "Modulo", "numPartitions": 2},
        {"server": "c", "id": "x3"},
        {"server": "d", "id": "x4", "partitions": [1],
         "partitionFunction": "Murmur", "numPartitions": 2},
    ]
    for mod in (jmod, jax_join):
        kept, skipped = mod.filter_sources(sources, ("Modulo", 2, {0}))
        assert [s["server"] for s in kept] == ["a", "c", "d"]
        assert skipped == 1
        kept, skipped = mod.filter_sources(sources, None)
        assert len(kept) == 4 and skipped == 0


def test_stage1_publish_and_build_context(join_fixture, tmp_path):
    """Stage 1 as the broker and server run it: the dim scan request
    (dim_scan_request) through the port's executor over the part table,
    its DataTable published in two managers; stage 2's build_context
    over both sources equals a JoinContext built from the arrays, and
    the joined answer equals the oracle."""
    segs, _jsegs, dim, fact = join_fixture
    dim_dirs = []
    for i, rows in enumerate((slice(0, 200), slice(200, 400))):
        d = str(tmp_path / f"partd_{i}")
        from pinot_tpu_torch.segment.creator import SegmentCreator
        SegmentCreator(datagen.part_dim_schema(),
                       datagen.join_table_configs()[1],
                       segment_name=f"partd_{i}").build(
            {k: v[rows] for k, v in dim.items()}, d)
        dim_dirs.append(d)
    dim_segs = [ImmutableSegmentLoader.load(d, device="cpu")
                for d in dim_dirs]
    pql = JOIN_PQLS["j21_dim_and_fact_filter"][0]
    req = compile_pql(pql)
    scan = stages_broker.dim_scan_request(req)
    assert scan.table_name == "part" and scan.limit == jmod.DIM_CAP
    sources, managers = [], []
    for i, seg in enumerate(dim_segs):
        blk = ServerQueryExecutor().execute(scan, [seg])
        dt = DataTable.from_block(scan, blk)
        assert int(dt.metadata["numDocsScanned"]) == dt.num_rows()
        m = xmod.ExchangeManager()
        m.put(f"x9.{i}", dt.to_bytes())
        managers.append(m)
        sources.append({"server": f"Server_{i}", "xkey": m.xkey,
                        "id": f"x9.{i}", "rows": dt.num_rows()})
    try:
        ctx = jmod.build_context(req.join, sources[::-1], None)
        dm = np.asarray(dim["p_mfgr"] == "MFGR#2")
        assert sorted(ctx.keys.tolist()) == \
            sorted(dim["p_partkey"][dm].astype(np.int64).tolist())
        assert ctx.sources_skipped == 0
        want = _oracle_dict(dim, fact, JOIN_PQLS[
            "j21_dim_and_fact_filter"][1], JOIN_PQLS[
            "j21_dim_and_fact_filter"][2], ["part.p_brand1",
                                            "lineorderj.d_year"])
        got = _port_answers(pql, ctx, segs)
        for resp in got.values():
            for fi in range(2):
                assert {tuple(str(x) for x in k): v for k, v in
                        _as_dict(resp, fi).items()} == want[fi]
    finally:
        for m in managers:
            m.close()


def test_exchange_fetch_over_tcp_between_two_instances(join_fixture,
                                                       tmp_path):
    """Two port ServerInstances in one process, as two servers: A holds
    the part table and publishes J2.1's stage-1 dim scan (an
    InstanceRequest with publish_exchange, answered with an ack); B holds
    the fact segments and runs stage 2 with A as its exchange source. A
    source without A's registry key makes B fetch A's block over TCP (an
    XCHG frame to A's QueryServer); with the key, in process. Both
    answers equal each other, the JAX executor's and join_oracle."""
    from pinot_tpu_torch.common.request import InstanceRequest
    from pinot_tpu_torch.common.serde import instance_request_to_bytes
    from pinot_tpu_torch.server import ServerInstance
    segs, jsegs, dim, fact = join_fixture
    d = str(tmp_path / "part_x")
    from pinot_tpu_torch.segment.creator import SegmentCreator
    SegmentCreator(datagen.part_dim_schema(),
                   datagen.join_table_configs()[1],
                   segment_name="part_x").build(dim, d)
    a = ServerInstance("server_a", device="cpu")
    b = ServerInstance("server_b", device="cpu")
    try:
        a.data_manager.table("part", create=True).add_segment(
            ImmutableSegmentLoader.load(d))
        for seg in segs:
            b.data_manager.table("lineorderj", create=True).add_segment(seg)
        port = a.start(port=0)
        name = "j21_dim_and_fact_filter"
        pql, dim_filter, fact_filter, group_cols = JOIN_PQLS[name]
        req = compile_pql(pql)
        ack = DataTable.from_bytes(a.handle_request_bytes(
            instance_request_to_bytes(InstanceRequest(
                request_id=1, query=stages_broker.dim_scan_request(req),
                publish_exchange={"id": "x7.0"}))))
        assert not ack.exceptions and ack.num_rows() == 0
        assert ack.metadata["exchangeId"] == "x7.0"
        assert int(ack.metadata["exchangeRows"]) == \
            int((dim["p_mfgr"] == "MFGR#2").sum())
        tcp = {"server": "server_a", "id": "x7.0", "host": "127.0.0.1",
               "port": port}
        local = dict(tcp, xkey=ack.metadata["exchangeKey"])
        answers = []
        for src in (tcp, local):
            dt = DataTable.from_bytes(b.handle_request_bytes(
                instance_request_to_bytes(InstanceRequest(
                    request_id=2, query=compile_pql(pql),
                    exchange_sources=[src]))))
            assert not dt.exceptions, dt.exceptions
            answers.append(BrokerReduceService().reduce(
                req, [dt.to_block()]).to_json())
        _, jctx = _contexts(req, jax_compile(pql), dim, dim_filter)
        want = _jax_answer(pql, jctx, jsegs)
        oracle = _oracle_dict(dim, fact, dim_filter, fact_filter,
                              group_cols)
        for got in answers:
            for fi in range(2):
                assert _as_dict(got, fi) == _as_dict(want, fi)
                assert {tuple(str(x) for x in k): v for k, v in
                        _as_dict(got, fi).items()} == oracle[fi]
    finally:
        a.stop()
        b.stop()


def test_window_scan_request_ships_display_and_window_columns():
    req = compile_pql(
        "SELECT d_year, lo_quantity, ROW_NUMBER() OVER (PARTITION BY "
        "d_year ORDER BY lo_revenue DESC), SUM(lo_quantity) OVER "
        "(PARTITION BY d_year ORDER BY lo_revenue DESC) FROM lineorderj "
        "WHERE lo_quantity < 9 LIMIT 100")
    from pinot_tpu.query.stages import broker as jax_broker
    scan = stages_broker.window_scan_request(req, req)
    jscan = jax_broker.window_scan_request(jax_compile(req_pql := (
        "SELECT d_year, lo_quantity, ROW_NUMBER() OVER (PARTITION BY "
        "d_year ORDER BY lo_revenue DESC), SUM(lo_quantity) OVER "
        "(PARTITION BY d_year ORDER BY lo_revenue DESC) FROM lineorderj "
        "WHERE lo_quantity < 9 LIMIT 100")), jax_compile(req_pql))
    assert scan.windows == [] and req.windows          # the copy only
    assert scan.selection.columns == jscan.selection.columns == \
        ["d_year", "lo_quantity", "lo_revenue"]
    assert scan.limit == jscan.limit == 1 << 16


# ---------------------------------------------------------------------------
# 4. kernels: plain versions against the JAX functions
# ---------------------------------------------------------------------------


def _join_lane(P, num_docs, dtype, seed):
    """A raw key lane (hits and misses, padding 0) and padded dim keys in
    its dtype, as JoinContext.padded_keys builds them."""
    rng = np.random.default_rng(seed)
    big = 2 ** 40 if dtype == np.int64 else 2 ** 30
    dim = np.unique(rng.integers(-big, big, 300)).astype(dtype)
    ctx_keys = jmod.JoinContext(
        compile_pql("SELECT COUNT(*) FROM f JOIN d ON f.k = d.k").join,
        dim.astype(np.int64), {})
    lane = np.zeros(P, dtype)
    pick = rng.integers(0, len(dim), num_docs)
    lane[:num_docs] = np.where(rng.random(num_docs) < 0.6, dim[pick],
                               rng.integers(-big, big, num_docs))
    return lane, ctx_keys.padded_keys(dtype), ctx_keys


@pytest.mark.parametrize("dtype", [np.int32, np.int64])
@pytest.mark.parametrize("P", [8192, 16384])
def test_k1_join_raw_leaf_plain_matches_jax(dtype, P):
    num_docs = P - 1234
    lane, keys, _ctx = _join_lane(P, num_docs, dtype, 3)
    spec = ("pred", "join_raw", "k", "raw", len(keys))
    want = np.asarray(jk._eval_pred("join_raw", "raw", len(keys),
                                    jnp.asarray(lane), [jnp.asarray(keys)]))
    want = want & (np.arange(P) < num_docs)
    cols = {"k.raw": torch.from_numpy(lane)}
    probe = tk.SortedKeys(keys)
    got = tk.filter_mask(P, spec, cols, [probe], num_docs, "cpu")
    np.testing.assert_array_equal(got.numpy().astype(bool), want)
    # under an AND with an ordinary leaf, params in depth-first order
    both = ("and", (spec, ("pred", "range_raw", "k", "raw", (True, True))))
    lo, hi = dtype(-2 ** 29), dtype(2 ** 29)
    got = tk.filter_mask(P, both, cols, [probe, lo, hi], num_docs, "cpu")
    np.testing.assert_array_equal(got.numpy().astype(bool),
                                  want & (lane >= lo) & (lane <= hi))
    # the program K1 runs: one node, its parameter word the lane index of
    # the sorted keys appended to the lane table
    probes = []
    buf, n_nodes = tk.compile_filter(spec, [probe], cols, probes)
    assert n_nodes == 1 and len(probes) == 1
    assert buf[:6].tolist() == [17, 0, 0, len(keys), tk._ELEM[
        torch.from_numpy(lane).dtype], 1]
    assert buf[6] == 1
    assert torch.equal(probes[0], torch.sort(torch.from_numpy(keys)).values)


#: the join_raw leaf's edge cases: (dim keys as offsets from a base, the
#: base per dtype) drawn by _bitmap_case; the route each must take
BITMAP_CASES = {
    "one_key": "bitmap",         # a dim side of one key (padded by it)
    "narrow": "bitmap",          # J2.1's shape: 32,240 of 800,000 keys
    "negative": "bitmap",        # keys on both sides of 0
    "staged_edge": "bitmap",     # the largest bitmap staged in shared memory
    "past_staged": "bitmap",     # one word past it: read from L2
    "max_span": "bitmap",        # exactly JOIN_BITMAP_MAX_SPAN values
    "past_max_span": "probe",    # one value more
    "extremes": "probe",         # the dtype's smallest and largest keys
}


def _bitmap_case(case: str, dtype, P: int, seed: int):
    """(key lane [P] in dtype, dim keys padded as JoinContext pads them:
    the largest repeated to a power of two) for a BITMAP_CASES case. The
    lane holds every key, each key +- 1, the keys just outside [min,
    max], the dtype's extremes, and random values around the range; an
    int64 case sits past 2^31 (its base 2^40 + 7, or negative)."""
    rng = np.random.default_rng([seed, list(BITMAP_CASES).index(case)])
    info = np.iinfo(dtype)
    staged_span = tk.JOIN_BITMAP_SMEM_BYTES * 8
    span = {"one_key": 1, "narrow": 800_000, "negative": 10_001,
            "staged_edge": staged_span, "past_staged": staged_span + 32,
            "max_span": tk.JOIN_BITMAP_MAX_SPAN,
            "past_max_span": tk.JOIN_BITMAP_MAX_SPAN + 1}.get(case)
    if case == "extremes":
        keys = np.concatenate([[info.min, info.min + 1, info.max - 1,
                                info.max], rng.integers(-1000, 1000, 60)])
    else:
        base = -5_000 if case == "negative" else (
            2 ** 40 + 7 if dtype == np.int64 else 11)
        n = 1 if span == 1 else min(32_240, span)
        offs = rng.choice(span, n, replace=False) if span > 2 else \
            np.arange(n)
        offs[:2 if span > 1 else 1] = [0, span - 1][:2 if span > 1 else 1]
        keys = base + offs.astype(np.int64)
    keys = np.unique(keys).astype(dtype)
    lo, hi = int(keys.min()), int(keys.max())
    near = np.concatenate([keys, keys.astype(np.int64) - 1,
                           keys.astype(np.int64) + 1,
                           [lo - 1, hi + 1, info.min, info.max],
                           rng.integers(max(lo - 2, info.min),
                                        min(hi + 3, info.max), P)])
    near = np.clip(near, info.min, info.max).astype(dtype)
    lane = rng.permutation(near)[:P]
    d_pad = 1 << max(3, (len(keys) - 1).bit_length())
    padded = np.full(d_pad, keys.max(), dtype)
    padded[:len(keys)] = rng.permutation(keys)
    return lane, padded


@pytest.mark.parametrize("dtype", [np.int32, np.int64])
@pytest.mark.parametrize("case", list(BITMAP_CASES))
def test_k1_join_bitmap_route_plain_matches_jax(case, dtype):
    """The join_raw leaf's plain bitmap route (the CPU's: filter_mask on a
    host lane) against the JAX branch (_eval_pred kind join_raw, a sort
    and searchsorted) at each edge: one key, the smallest and largest
    keys, the values just outside the range, negative keys, int64 keys
    past 2^31, the padding's repeats of the largest key, the largest
    staged bitmap and one word past it, exactly JOIN_BITMAP_MAX_SPAN
    values; past it (and at the dtype's extremes) the probe route. The
    program K1 runs holds the route's node, and the bitmap's host-built
    words hold exactly the keys' bits, its coarse level (at most
    JOIN_BITMAP_SMEM_BYTES: the bitmap itself up to the staged edge, a
    bit for each 2^shift keys past it) the bits of their offsets >>
    shift."""
    P, num_docs = 1 << 16, (1 << 16) - 999
    lane, keys = _bitmap_case(case, dtype, P, 7)
    want = np.asarray(jk._eval_pred("join_raw", "raw", len(keys),
                                    jnp.asarray(lane), [jnp.asarray(keys)]))
    want = want & (np.arange(P) < num_docs)
    spec = ("pred", "join_raw", "k", "raw", len(keys))
    cols = {"k.raw": torch.from_numpy(lane)}
    probe = tk.SortedKeys(keys)
    got = tk.filter_mask(P, spec, cols, [probe], num_docs, "cpu")
    np.testing.assert_array_equal(got.numpy().astype(bool), want)
    yardstick = tk.filter_mask_plain(P, spec, cols, [probe], num_docs,
                                     "cpu")
    assert torch.equal(got, yardstick)
    route = BITMAP_CASES[case]
    assert (probe.bitmap_span() is not None) == (route == "bitmap")
    probes = []
    buf, n_nodes = tk.compile_filter(spec, [probe], cols, probes)
    assert n_nodes == 1
    if route == "bitmap":
        base, span = probe.bitmap_span()
        assert buf[0] == 19 and buf[3] == span
        assert base == int(keys.min()) and span == int(keys.max()) - base + 1
        shift = int(buf[8])
        assert shift == {"staged_edge": 0, "past_staged": 1,
                         "max_span": 7}.get(case, shift)
        assert buf[6:8].tolist() == [1, 2] and len(probes) == 2
        off = np.unique(keys.astype(np.int64) - base)
        for words, o, n in ((probes[0], off, span),
                            (probes[1], np.unique(off >> shift),
                             ((span - 1) >> shift) + 1)):
            bits = np.unpackbits(words.numpy().view(np.uint8),
                                 bitorder="little")
            assert len(bits) % 128 == 0 and len(bits) >= n
            want_bits = np.zeros(len(bits), np.uint8)
            want_bits[o] = 1
            np.testing.assert_array_equal(bits, want_bits)
        assert probes[1].numel() * 4 <= tk.JOIN_BITMAP_SMEM_BYTES
        # the least shift: one less would not fit
        assert shift == 0 or -(-(((span - 1) >> (shift - 1)) + 1) // 128) \
            * 16 > tk.JOIN_BITMAP_SMEM_BYTES
        hit = tk.join_bitmap_plain(probe, cols["k.raw"], base, span)
        np.testing.assert_array_equal(hit.numpy(), np.isin(lane, keys))
    else:
        assert buf[0] == 17 and buf[3] == len(keys)


def _batched_join_members(P, dtype, n, seed):
    """A raw key lane and n members of one join_raw spec, each with its
    own dim side (all padded to one Dp, as one signature's members are),
    ANDed with a range leaf of per-member bounds."""
    rng = np.random.default_rng(seed)
    lane, keys0, _ctx = _join_lane(P, P - 777, dtype, seed)
    members, probes = [], []
    for b in range(n):
        # a member's dim side: a random half of keys0's distinct keys
        uniq = np.unique(keys0)
        keep = np.sort(rng.choice(uniq, len(uniq) // 2 + b, replace=False))
        ctx = jmod.JoinContext(
            compile_pql("SELECT COUNT(*) FROM f JOIN d ON f.k = d.k").join,
            keep.astype(np.int64), {})
        keys = ctx.padded_keys(dtype)
        probes.append(keys)
        lo = dtype(-2 ** 28 - b * 1000)
        members.append([tk.SortedKeys(keys), lo, dtype(2 ** 28)])
    dps = {len(k) for k in probes}
    assert len(dps) == 1, dps
    spec = ("and", (("pred", "join_raw", "k", "raw", dps.pop()),
                    ("pred", "range_raw", "k", "raw", (True, False))))
    return lane, spec, members, probes


@pytest.mark.parametrize("span", [40, tk.JOIN_MAP_MAX_SPAN + 1])
def test_sorted_keys_batch_lane_cached_per_batch(span):
    """The batched K1's join lane is made once per batch of members and
    device and reused: their member map where the members' keys span at
    most JOIN_MAP_MAX_SPAN values, else their sorted keys stacked [B, Dp].
    Another batch, or members that died and whose ids came back, make it
    anew; the cache holds no member."""
    import gc
    import weakref
    rng = np.random.default_rng(7)
    probes = [tk.SortedKeys(np.sort(rng.integers(-5, span - 5, 16))
                            .astype(np.int64)) for _ in range(3)]
    probes[0].keys[[0, -1]] = -5, span - 6     # the batch spans `span`
    fact = torch.zeros(4, dtype=torch.int64)
    lane = probes[0].batch_lane(probes, fact)
    if span <= tk.JOIN_MAP_MAX_SPAN:
        assert isinstance(lane, tk.JoinMemberMap)
        assert lane.base == min(int(p.keys.min()) for p in probes)
        assert tuple(lane.map.shape) == (span,)
    else:
        assert torch.equal(lane, torch.stack([p.on("cpu")[0]
                                              for p in probes]))
    assert probes[0].batch_lane(list(probes), fact) is lane
    other = probes[0].batch_lane(probes[:2], fact)
    assert other is not lane
    dead = weakref.ref(probes[2])
    probes.pop()
    gc.collect()
    assert dead() is None
    # the new members stay alive, so no two batches share a member's id
    members = [tk.SortedKeys(np.arange(16))
               for _ in range(tk.MAX_STACKED_BATCHES + 1)]
    for p in members:
        probes[0].batch_lane([probes[0], p], fact)
    assert len(probes[0]._stacks) == tk.MAX_STACKED_BATCHES


def test_join_leaf_bench_needs_a_card(monkeypatch, capsys):
    """The batched join_raw leaf's timing tool refuses to run without a
    CUDA card (exit 2), before it builds or times anything."""
    from pinot_tpu_torch.tools import join_leaf_bench
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert join_leaf_bench.main([]) == 2
    assert "needs a CUDA card" in capsys.readouterr().err


@pytest.mark.parametrize("dtype", [np.int32, np.int64])
def test_compile_filter_batched_join_bits_node(dtype):
    """Members whose keys span a narrow range compile to a join_bits node
    (op 18): its arg the range's span, its parameter block the member
    map's lane index and the range's base in the lane's dtype, the same
    for every member; the lane table ends with the uint8 [span] map."""
    keys = [np.arange(-40 + b, 60, 3, dtype=dtype)[:16] for b in range(3)]
    members = [[tk.SortedKeys(k)] for k in keys]
    cols = {"k.raw": torch.zeros(64, dtype=torch.from_numpy(keys[0]).dtype)}
    lanes = []
    buf, n_nodes, words = tk.compile_filter_batched(
        ("pred", "join_raw", "k", "raw", 16), members, cols, lanes)
    base_words = tk._raw_words([-40], cols["k.raw"].dtype)
    assert n_nodes == 1 and len(lanes) == 1
    mm = tk.join_member_map([m[0] for m in members], cols["k.raw"])
    assert torch.equal(lanes[0], mm.map)
    span = int(max(k.max() for k in keys)) + 40 + 1
    assert list(buf[:6]) == [18, 0, 0, span,
                             tk._ELEM[cols["k.raw"].dtype], 1]
    assert words == 1 + len(base_words)
    for b in range(3):
        assert list(buf[6 + b * words: 6 + (b + 1) * words]) == \
            [1] + base_words


@pytest.mark.parametrize("dtype", [np.int32, np.int64])
def test_join_member_map_holds_each_members_keys(dtype):
    """Bit b of byte i of the member map is set iff base + i is among
    member b's keys (8 members, negative keys and duplicates included); a
    key lane of another dtype and a ninth member are refused, and a range
    past JOIN_MAP_MAX_SPAN takes the search route (None)."""
    rng = np.random.default_rng(11)
    keys = [np.sort(rng.integers(-300, 700, 64)).astype(dtype)
            for _ in range(8)]
    probes = [tk.SortedKeys(k) for k in keys]
    fact = torch.zeros(2, dtype=torch.from_numpy(keys[0]).dtype)
    mm = tk.join_member_map(probes, fact)
    base = min(int(k.min()) for k in keys)
    assert mm.base == base and mm.map.dtype == torch.uint8
    got = mm.map.numpy()
    for b, k in enumerate(keys):
        want = np.zeros(got.shape[0], dtype=bool)
        want[k.astype(np.int64) - base] = True
        np.testing.assert_array_equal((got >> b) & 1 == 1, want)
    other = torch.int32 if dtype == np.int64 else torch.int64
    with pytest.raises(ValueError, match="do not match"):
        tk.join_member_map(probes, torch.zeros(2, dtype=other))
    with pytest.raises(ValueError, match="members past"):
        tk.join_member_map(probes + probes[:1], fact)
    wide = [tk.SortedKeys(np.array([0, tk.JOIN_MAP_MAX_SPAN], dtype))]
    assert tk.join_member_map(wide, fact) is None


@pytest.mark.parametrize("dtype", [np.int32, np.int64])
@pytest.mark.parametrize("n", [2, 5, 8])
def test_k1_batched_join_raw_leaf_plain_matches_jax(dtype, n):
    """The batched K1 takes the join_raw leaf: each member's mask (its
    own dim side, its own range) equals the JAX `_eval_pred` kind
    join_raw ANDed with the range, and its own single plain K1; the
    batched program shares the nodes, and its join lane is [B, Dp] with
    row b member b's keys sorted."""
    P, num_docs = 16384, 16384 - 777
    lane, spec, members, probes = _batched_join_members(P, dtype, n, 40)
    cols = {"k.raw": torch.from_numpy(lane)}
    masks, matched = tk.filter_mask_batched(P, spec, cols, members,
                                            num_docs, "cpu")
    valid = np.arange(P) < num_docs
    for b, (params, keys) in enumerate(zip(members, probes)):
        want = np.asarray(jk._eval_pred("join_raw", "raw", len(keys),
                                        jnp.asarray(lane),
                                        [jnp.asarray(keys)]))
        want = want & (lane >= params[1]) & (lane < params[2]) & valid
        np.testing.assert_array_equal(masks[b].numpy().astype(bool), want)
        assert int(matched[b]) == int(want.sum())
        assert torch.equal(masks[b], tk.filter_mask(
            P, spec, cols, params, num_docs, "cpu"))
    lanes = []
    buf, n_nodes, words = tk.compile_filter_batched(spec, members, cols,
                                                    lanes)
    assert n_nodes == 3 and len(lanes) == 1
    assert tuple(lanes[0].shape) == (n, len(probes[0]))
    for b, keys in enumerate(probes):
        assert torch.equal(lanes[0][b],
                           torch.sort(torch.from_numpy(keys)).values)
    # member b's parameter block: the join lane's index (the same for
    # every member), then its range constants
    node_words = 6 * n_nodes
    for b in range(n):
        block = buf[node_words + b * words: node_words + (b + 1) * words]
        assert block[0] == 1


def _group_cols(P, num_docs, seed):
    rng = np.random.default_rng(seed)
    card = 700
    ids = np.full(P, card, np.int16)
    ids[:num_docs] = rng.integers(0, card, num_docs)
    g7 = np.full(P, 7, np.int8)
    g7[:num_docs] = rng.integers(0, 7, num_docs)
    return ids, g7, card


def test_k3_jcode_key_plain_matches_jax_group_key():
    P, num_docs = 8192, 7000
    ids, g7, card = _group_cols(P, num_docs, 4)
    rng = np.random.default_rng(6)
    card_pad = tk.pow2_bucket(card + 1)
    code = np.zeros(card_pad, np.int32)
    code[:card] = rng.integers(0, 40, card)
    gcols = (("k", "jcode", 0, 40), ("y", "ids", 0, 7))
    strides, g_pad = (7, 1), tk.pow2_bucket(40 * 7)
    want = np.asarray(jk._group_key(
        gcols, strides, g_pad, {"k.ids": jnp.asarray(ids),
                                "y.ids": jnp.asarray(g7)},
        [jnp.asarray(code)]))
    mask = torch.from_numpy((np.arange(P) < num_docs).astype(np.uint8))
    cols = {"k.ids": torch.from_numpy(ids), "y.ids": torch.from_numpy(g7)}
    params = [code]
    keys = [tk.spec_group_key(g, cols, params, "cpu") for g in gcols]
    assert not params and keys[0].kind == "jcode"
    rows, key = tk.group_keys_plain(mask, keys, strides, g_pad)
    np.testing.assert_array_equal(key.numpy(), want[rows.numpy()])
    count = tk.dense_group_aggregate(mask, keys, strides, g_pad)[0]
    np.testing.assert_array_equal(
        count.numpy(), np.bincount(want[:num_docs], minlength=g_pad))


@pytest.mark.parametrize("dtype", [np.int32, np.int64])
def test_k3_jraw_key_plain_matches_jax_group_key(dtype):
    P, num_docs = 8192, 7777
    lane, _keys, ctx = _join_lane(P, num_docs, dtype, 8)
    rng = np.random.default_rng(10)
    ctx._columns["cat"] = np.asarray(
        [f"c{i}" for i in rng.integers(0, 25, len(ctx.keys))], dtype=object)
    keys_p, codes_p = ctx.padded_key_codes("cat", dtype)
    _ids, g7, _card = _group_cols(P, num_docs, 11)
    n = len(ctx.group_coding("cat")[1])
    gcols = (("k", "jraw", 0, n), ("y", "ids", 0, 7))
    strides, g_pad = (7, 1), tk.pow2_bucket(n * 7)
    want = np.asarray(jk._group_key(
        gcols, strides, g_pad, {"k.raw": jnp.asarray(lane),
                                "y.ids": jnp.asarray(g7)},
        [jnp.asarray(keys_p), jnp.asarray(codes_p)]))
    hit = np.asarray(jk._eval_pred("join_raw", "raw", len(keys_p),
                                   jnp.asarray(lane),
                                   [jnp.asarray(keys_p)]))
    mask = torch.from_numpy(((np.arange(P) < num_docs) & hit)
                            .astype(np.uint8))
    cols = {"k.raw": torch.from_numpy(lane), "y.ids": torch.from_numpy(g7)}
    params = [ctx.sorted_keys(dtype, "cat")]
    keys = [tk.spec_group_key(g, cols, params, "cpu") for g in gcols]
    assert keys[0].kind == "jraw" and keys[0].table.dtype == \
        torch.from_numpy(lane).dtype
    rows, key = tk.group_keys_plain(mask, keys, strides, g_pad)
    np.testing.assert_array_equal(key.numpy(), want[rows.numpy()])


@pytest.mark.parametrize("dtype", [np.int32, np.int64])
def test_join_dim_side_sort_plain_matches_numpy(dtype):
    """K12 as the join build (radix_sort_join): the padded keys with
    their codes, sorted; the padding run (largest key, its code) stays
    whole."""
    _lane, _keys, ctx = _join_lane(64, 10, dtype, 12)
    ctx._columns["g"] = np.arange(len(ctx.keys)) % 9
    keys_p, codes_p = ctx.padded_key_codes("g", dtype)
    sk, sc = tk.SortedKeys(keys_p, codes_p).on("cpu")
    order = np.argsort(keys_p, kind="stable")
    np.testing.assert_array_equal(sk.numpy(), keys_p[order])
    np.testing.assert_array_equal(sc.numpy(), codes_p[order])
    assert sk.dtype == torch.from_numpy(keys_p).dtype


# ---------------------------------------------------------------------------
# 5. on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.int32, np.int64])
def test_k1_join_raw_leaf_cuda_matches_plain(cuda_device, dtype):
    P = 16384
    lane, keys, _ctx = _join_lane(P, P - 999, dtype, 21)
    spec = ("pred", "join_raw", "k", "raw", len(keys))
    cols = {"k.raw": torch.from_numpy(lane).to(cuda_device)}
    probe = tk.SortedKeys(keys)
    tk.reset_launch_counts()
    got = tk.filter_mask(P, spec, cols, [probe], P - 999)
    counts = tk.launch_counts()
    assert counts["filter_mask"] == 1 and counts["filter_mask[join_raw]"] == 1
    assert counts["radix_sort_join"] == 1
    want = tk.filter_mask_plain(P, spec, {"k.raw": cols["k.raw"].cpu()},
                                [probe], P - 999, "cpu")
    assert torch.equal(got.cpu(), want)
    # stacked: three segments of P rows, one sorted dim side
    S = 3
    flat = np.concatenate([_join_lane(P, P - 999, dtype, 22 + s)[0]
                           for s in range(S)])
    cols = {"k.raw": torch.from_numpy(flat).to(cuda_device)}
    docs = torch.tensor([P - 999, P - 5000, P], dtype=torch.int32,
                        device=cuda_device)
    got = tk.filter_mask_stacked(P, S, spec, cols, [probe], docs)
    want = tk.filter_mask_stacked_plain(
        P, S, spec, {"k.raw": cols["k.raw"].cpu()}, [probe], docs.cpu())
    assert torch.equal(got[0].cpu(), want[0])
    assert torch.equal(got[1].cpu(), want[1])


#: launches of each K1 join_raw route case on the card: a race or a lost
#: row of a thread's four shows only as a wrong byte now and then
K1_JOIN_REPEATS = 20


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.int32, np.int64])
@pytest.mark.parametrize("case", list(BITMAP_CASES))
def test_k1_join_raw_routes_cuda_match_plain(cuda_device, case, dtype):
    """Both routes of the single join_raw leaf on the card at each edge
    case of BITMAP_CASES: K1_JOIN_REPEATS launches of the lone leaf (on
    the bitmap route the four-rows-a-thread kernel, its coarse level in
    shared memory: the bitmap itself up to the staged edge, a bit for
    each 2^shift keys past it) and of the leaf under an AND (the
    program's interpreter), each bit-equal to the plain version's
    searchsorted and counted on the case's route, and the stacked form
    over three segments the same way."""
    P, num_docs = 1 << 20, (1 << 20) - 999
    lane, keys = _bitmap_case(case, dtype, P, 8)
    route = BITMAP_CASES[case]
    other = "probe" if route == "bitmap" else "bitmap"
    info = np.iinfo(dtype)
    spec = ("pred", "join_raw", "k", "raw", len(keys))
    both = ("and", (spec, ("pred", "range_raw", "k", "raw", (True, True))))
    probe = tk.SortedKeys(keys)
    cols = {"k.raw": torch.from_numpy(lane).to(cuda_device)}
    for sp, ps in ((spec, [probe]),
                   (both, [probe, dtype(info.min), dtype(info.max - 1)])):
        want = tk.filter_mask_plain(P, sp, cols, ps, num_docs)
        tk.reset_launch_counts()
        for _ in range(K1_JOIN_REPEATS):
            assert torch.equal(tk.filter_mask(P, sp, cols, ps, num_docs),
                               want)
        counts = tk.launch_counts()
        assert counts["filter_mask"] == K1_JOIN_REPEATS
        assert counts[f"filter_mask[{route}]"] == K1_JOIN_REPEATS
        assert counts[f"filter_mask[{other}]"] == 0
    S = 3
    flat = np.concatenate([lane] + [_bitmap_case(case, dtype, P, 9 + s)[0]
                                    for s in range(S - 1)])
    cols = {"k.raw": torch.from_numpy(flat).to(cuda_device)}
    docs = torch.tensor([num_docs, P - 5000, P], dtype=torch.int32,
                        device=cuda_device)
    want = tk.filter_mask_stacked_plain(P, S, spec, cols, [probe], docs)
    tk.reset_launch_counts()
    for _ in range(K1_JOIN_REPEATS):
        got = tk.filter_mask_stacked(P, S, spec, cols, [probe], docs)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert tk.launch_counts()[f"filter_mask[{route}]"] == K1_JOIN_REPEATS


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["bits", "search"])
@pytest.mark.parametrize("dp", [1, 37, 1000])
def test_k1_batched_join_raw_leaf_cuda_any_dp(cuda_device, dp, route):
    """Both routes of the batched leaf on the card, at a Dp that is not a
    power of two (and Dp = 1), int64 keys with negatives and duplicates:
    a member map where the members' keys span a narrow range, the sorted
    keys' probe where they span 2^41. Masks and counts bit-equal to the
    plain version and to single K1 launches."""
    P, num_docs = 8192, 8192 - 333
    rng = np.random.default_rng(dp)
    lo, hi = (-1000, 3 * dp + 5) if route == "bits" else (-2 ** 40, 2 ** 40)
    keys = [np.sort(rng.integers(lo, hi, dp)) for _ in range(8)]
    members = [[tk.SortedKeys(k)] for k in keys]
    lane = np.where(rng.random(P) < 0.5,
                    np.concatenate(keys)[rng.integers(0, 8 * dp, P)],
                    rng.integers(lo, hi, P)).astype(np.int64)
    spec = ("pred", "join_raw", "k", "raw", dp)
    host = {"k.raw": torch.from_numpy(lane)}
    cols = {"k.raw": host["k.raw"].to(cuda_device)}
    mm = tk.join_member_map([m[0] for m in members], cols["k.raw"])
    assert (mm is not None) is (route == "bits")
    masks, matched = tk.filter_mask_batched(P, spec, cols, members,
                                            num_docs)
    want, want_matched = tk.filter_mask_batched_plain(
        P, spec, host, members, num_docs, "cpu")
    assert torch.equal(masks.cpu(), want)
    assert torch.equal(matched.cpu(), want_matched)
    assert int(want_matched.sum()) > 0
    for b, params in enumerate(members):
        assert torch.equal(masks[b], tk.filter_mask(P, spec, cols, params,
                                                    num_docs)), b


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.int32, np.int64])
@pytest.mark.parametrize("n", [2, 4, 8])
def test_k1_batched_join_raw_leaf_cuda(cuda_device, dtype, n):
    """The batched K1 with the join_raw leaf on the card: one launch for
    the n members (counted with the node), masks and counts bit-equal to
    its plain version and to n single K1 launches."""
    P, num_docs = 16384, 16384 - 777
    lane, spec, members, _probes = _batched_join_members(P, dtype, n, 50)
    host = {"k.raw": torch.from_numpy(lane)}
    cols = {"k.raw": host["k.raw"].to(cuda_device)}
    for params in members:
        params[0].on(cuda_device)            # K12's sorts, before counting
    tk.reset_launch_counts()
    masks, matched = tk.filter_mask_batched(P, spec, cols, members,
                                            num_docs)
    torch.cuda.synchronize()
    counts = tk.launch_counts()
    assert counts["filter_mask_batched"] == 1
    assert counts["filter_mask_batched[join_raw]"] == 1
    assert counts["filter_mask"] == 0
    want, want_matched = tk.filter_mask_batched_plain(
        P, spec, host, members, num_docs, "cpu")
    assert torch.equal(masks.cpu(), want)
    assert torch.equal(matched.cpu(), want_matched)
    for b, params in enumerate(members):
        one = tk.filter_mask(P, spec, cols, params, num_docs)
        assert torch.equal(masks[b], one), b


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["jcode", "jraw32", "jraw64"])
def test_k3_join_keys_cuda_match_plain(cuda_device, kind):
    P, num_docs = 16384, 15000
    ids, g7, card = _group_cols(P, num_docs, 31)
    if kind == "jcode":
        code = np.random.default_rng(2).integers(0, 40, tk.pow2_bucket(
            card + 1)).astype(np.int32)
        key_col, lane, params, n = "k.ids", ids, [code], 40
    else:
        dtype = np.int32 if kind == "jraw32" else np.int64
        lane, _keys, ctx = _join_lane(P, num_docs, dtype, 32)
        ctx._columns["g"] = np.arange(len(ctx.keys)) % 40
        key_col, params, n = "k.raw", [ctx.sorted_keys(dtype, "g")], 40
    gcols = (("k", "jcode" if kind == "jcode" else "jraw", 0, n),
             ("y", "ids", 0, 7))
    strides, g_pad = (7, 1), tk.pow2_bucket(n * 7)
    mask = np.zeros(P, np.uint8)
    mask[:num_docs] = np.random.default_rng(3).random(num_docs) < 0.7
    parts = np.random.default_rng(4).integers(0, 127, (2, P)).astype(np.int8)
    outs = {}
    for dev in ("cpu", cuda_device):
        cols = {key_col: torch.from_numpy(lane).to(dev),
                "y.ids": torch.from_numpy(g7).to(dev)}
        p = list(params)
        keys = [tk.spec_group_key(g, cols, p, dev) for g in gcols]
        outs[str(dev)] = tk.dense_group_aggregate(
            torch.from_numpy(mask).to(dev), keys, strides, g_pad,
            [torch.from_numpy(parts).to(dev)])
    cpu, card_out = outs["cpu"], outs[str(cuda_device)]
    for a, b in zip(cpu[:4], card_out[:4]):
        assert torch.equal(a, b.cpu())


@pytest.mark.cuda
def test_join_engines_cuda_match_cpu(join_fixture, raw_key_fixture):
    """The card's per-segment and stacked join answers equal the CPU's
    (the plain versions), and the join kernels launched."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    for segs, dim in ((join_fixture[0], join_fixture[2]),
                      (raw_key_fixture[0], raw_key_fixture[2])):
        for name, (pql, dim_filter, _ff, _g) in sorted(JOIN_PQLS.items()):
            ctx, _ = _contexts(compile_pql(pql), jax_compile(pql), dim,
                               dim_filter)
            want = _port_answers(pql, ctx, segs)
            try:
                for seg in segs:
                    seg.to("cuda")
                tk.reset_launch_counts()
                req = compile_pql(pql)
                red = BrokerReduceService()
                got = {"per_segment": red.reduce(req, [
                    ServerQueryExecutor().execute(_attach(req, ctx), segs)
                ]).to_json()}
                if len(segs) > 1:
                    got["stacked"] = red.reduce(req, [_stacked(
                        _attach(req, ctx), segs, None)]).to_json()
                counts = tk.launch_counts()
            finally:
                for seg in segs:
                    seg.to("cpu")
            assert counts["filter_mask"] > 0, name
            for path, resp in got.items():
                for fi in range(2):
                    assert _as_dict(resp, fi) == _as_dict(want[path], fi), \
                        (name, path)
