"""MV, valuein and raw group keys (K3), MV entry histograms (K4) and MV
entry min / max (K5) against the JAX package, and the port's planner's
specs against the JAX planner's.

The plain versions run through run_segment_kernel and are held to the
jitted JAX build_segment_kernel (kmax = 0, so `_group_outputs` takes
`_expand_mv_group` and the dense paths) on the same lanes, made from a
numpy seed: group counts, int32 part sums, id min / max, raw min / max,
histograms and COUNTMV equal; float64 group sums within rtol 1e-12 (both
sides add in float64, in different orders). The planner test loads one
segment written by the JAX SegmentCreator into both packages and
compares the group spec, aggregation specs, params (the valuein member
tables), value tables and refusals on the same requests, with both
planners' group compaction off and on (kmax equal either way).
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from fixtures import build_segment
from pinot_tpu.pql.optimizer import BrokerRequestOptimizer as JaxOptimizer
from pinot_tpu.pql.parser import compile_pql as jax_compile
from pinot_tpu.query import plan as jax_plan
from pinot_tpu.segment.loader import ImmutableSegmentLoader as JaxLoader
from pinot_tpu_torch.ops import kernels as tk
from pinot_tpu_torch.pql.optimizer import BrokerRequestOptimizer
from pinot_tpu_torch.pql.parser import compile_pql
from pinot_tpu_torch.query import plan as port_plan
from pinot_tpu_torch.segment.loader import ImmutableSegmentLoader
from test_torch_kernels import (FILTERS, KEY_CASES, MV_AGGS, SHAPES,
                                _jax_outs, _key_lanes, _torch_cols,
                                key_case)

CSUMS_RTOL = 1e-12


def _assert_outs_equal(got, want):
    assert set(got) == set(want)
    for k in want:
        g = got[k].numpy()
        if k.endswith(".csums"):
            np.testing.assert_allclose(g, want[k], rtol=CSUMS_RTOL, atol=0,
                                       err_msg=k)
        else:
            np.testing.assert_array_equal(g, want[k], err_msg=k)


@pytest.mark.parametrize("P", SHAPES)
@pytest.mark.parametrize("filt", ["nested", "full_match", "empty_match"])
@pytest.mark.parametrize("case", sorted(KEY_CASES))
def test_group_key_kinds_plain_match_jax(P, filt, case):
    spec, params = FILTERS[filt]
    num_docs = P - 777
    cols = _key_lanes(P, num_docs, seed=P + len(case))
    group, members = key_case(case, seed=len(case))
    # the JAX kernel pops the member tables after the filter's params
    want = _jax_outs(P, spec, list(params) + members, (), group, cols,
                     num_docs)
    got = tk.run_segment_kernel(P, spec, (), group, None, _torch_cols(cols),
                                params, num_docs, "cpu", members)
    _assert_outs_equal(got, want)
    # the matched count counts docs, once each, whatever the expansion
    assert int(got["stats.num_docs_matched"]) == \
        int(want["stats.num_docs_matched"])


def test_same_column_as_two_keys_is_a_full_cross_product():
    P, num_docs = SHAPES[0], SHAPES[0] - 777
    spec, params = FILTERS["full_match"]
    cols = _key_lanes(P, num_docs, seed=3)
    group, members = key_case("mv_twice", seed=5)
    got = tk.run_segment_kernel(P, spec, (), group, None, _torch_cols(cols),
                                params, num_docs, "cpu", members)
    mv = cols["m3.mv"][:num_docs].astype(np.int64)
    member = members[0]
    # numpy: every (entry, allowed entry) pair of every doc
    valid = mv < 10
    allowed = valid & member[np.minimum(mv, len(member) - 1)]
    want = np.zeros(group[2], np.int64)
    for e1 in range(mv.shape[1]):
        for e2 in range(mv.shape[1]):
            ok = valid[:, e1] & allowed[:, e2]
            np.add.at(want, mv[ok, e1] * 10 + mv[ok, e2], 1)
    np.testing.assert_array_equal(got["group.count"].numpy(), want)
    assert (want.reshape(-1)[[i * 10 + i for i in range(10)]].sum() <
            want.sum())        # off-diagonal pairs are there


def test_psums_bound_counts_the_expansion():
    """Past 127 * P * W_total >= 2^31 one launch's int32 part sums could
    overflow: K3 runs on row slices of k3_rows_per_launch(W_total) rows and
    adds their tables in int64, equal to numpy's int64 sums."""
    P = SHAPES[0]
    cols = _torch_cols(_key_lanes(P, P, seed=1))
    mask = tk.filter_mask(P, ("match_all",), cols, [], P, "cpu")
    # each doc's first entry, repeated: a valid doc adds w_big times
    w_big = 2**31 // (127 * P) + 1
    wide = tk.GroupKey("mvids", cols["m16.mv"][:, :1].repeat(1, w_big)
                       .contiguous(), card=1000)
    step = tk.k3_rows_per_launch(w_big)
    assert 127 * P * w_big >= 2**31 > 127 * step * w_big
    count, psums, _cs, matched, _t = tk.dense_group_aggregate(
        mask, [wide], [1], 1024, [cols["r1.parts"]])
    ids = cols["m16.mv"][:, 0].numpy().astype(np.int64)
    ok = ids < 1000
    want_count = np.bincount(ids[ok], minlength=1024) * w_big
    parts = cols["r1.parts"].numpy().astype(np.int64)
    want_psums = np.stack([np.bincount(ids[ok], weights=p[ok],
                                       minlength=1024).astype(np.int64)
                           for p in parts]) * w_big
    assert count.dtype == psums.dtype == torch.int64
    np.testing.assert_array_equal(count.numpy(), want_count)
    np.testing.assert_array_equal(psums.numpy(), want_psums)
    assert int(matched) == P


@pytest.mark.parametrize("case", ["mv_sv", "mvin_sv", "two_mv", "rawoff32"])
def test_k3_row_slices_match_jax(monkeypatch, case):
    """K3 on row slices (a small DENSE_ROWS_LIMIT forces several per
    segment) gives JAX's tables: the slices' counts, part sums, float sums
    and min / max tables combine exactly (float sums within rtol 1e-12)."""
    P, num_docs = SHAPES[0], SHAPES[0] - 777
    spec, params = FILTERS["nested"]
    cols = _key_lanes(P, num_docs, seed=41)
    group, members = key_case(case, seed=3)
    want = _jax_outs(P, spec, list(params) + members, (), group, cols,
                     num_docs)
    monkeypatch.setattr(tk, "DENSE_ROWS_LIMIT", 1 << 11)
    w_total = tk.group_combos([tk.spec_group_key(g, _torch_cols(cols),
                                                 list(members), "cpu")
                               for g in group[0]])
    assert P // tk.k3_rows_per_launch(w_total) >= 4
    got = tk.run_segment_kernel(P, spec, (), group, None, _torch_cols(cols),
                                params, num_docs, "cpu", members)
    _assert_outs_equal(got, want)


#: three MV key columns of 13 values each: a doc holds 12 or 13 of them,
#: so W_total = 13^3 = 2197 and 127 * 8192 * 2197 > 2^31
WIDE_VALUES = [f"v{i:02d}" for i in range(13)]


def test_mv_group_by_past_the_psums_bound_on_the_engine(tmp_path):
    """GROUP BY a, b, c over three 13-wide MV columns with SUM(v): the
    planner keeps the dense psums spec, K3 runs on row slices, and the
    engine's answer equals numpy's (each group counts the docs holding
    all three values)."""
    from pinot_tpu_torch.common.datatype import DataType
    from pinot_tpu_torch.common.schema import Schema, dimension, metric
    from pinot_tpu_torch.engine import QueryEngine
    from pinot_tpu_torch.segment.creator import SegmentCreator

    n = 5000
    rng = np.random.default_rng(23)
    pool = np.array(WIDE_VALUES, dtype=object)
    member = {}
    cols = {}
    for name in "abc":
        drop = rng.integers(0, 14, n)           # 13: keep all 13 values
        held = np.ones((n, 13), bool)
        held[np.arange(n)[drop < 13], drop[drop < 13]] = False
        member[name] = held
        cols[name] = [list(pool[row]) for row in held]
    v = rng.integers(0, 1000, n).astype(np.int32)
    cols["v"] = v
    schema = Schema("wide", [dimension(c, DataType.STRING,
                                       single_value=False) for c in "abc"]
                    + [metric("v", DataType.INT)])
    d = str(tmp_path / "wide")
    SegmentCreator(schema, None, segment_name="wide0").build(cols, d)
    engine = QueryEngine.from_dirs([d], device="cpu")
    seg = engine.segments[0]
    w_total = int(np.prod([seg.data_source(c).metadata.max_number_of_multi_values
                           for c in "abc"]))
    assert 127 * seg.padded_docs * w_total >= 2**31
    engine.executor.reset_path_counts()
    resp = engine.query("SELECT COUNT(*), SUM(v) FROM wide GROUP BY a, b, c "
                        "TOP 3000")
    assert not resp.exceptions, resp.exceptions
    assert engine.executor.path_counts["scan"] == 1
    A, B, C = (member[c].astype(np.int64) for c in "abc")
    want_count = np.einsum("rx,ry,rz->xyz", A, B, C)
    want_sum = np.einsum("r,rx,ry,rz->xyz", v.astype(np.int64), A, B, C)
    got_count = {tuple(g["group"]): int(float(g["value"]))
                 for g in resp.aggregation_results[0].group_by_result}
    got_sum = {tuple(g["group"]): float(g["value"])
               for g in resp.aggregation_results[1].group_by_result}
    assert len(got_count) == 13 ** 3
    for (x, y, z), cnt in got_count.items():
        i, j, k = (WIDE_VALUES.index(t) for t in (x, y, z))
        assert cnt == want_count[i, j, k]
        assert got_sum[(x, y, z)] == float(want_sum[i, j, k])


@pytest.mark.parametrize("P", SHAPES)
@pytest.mark.parametrize("filt", ["nested", "empty_match", "full_match",
                                  "mixed_nested"])
def test_mv_aggregations_plain_match_jax(P, filt):
    spec, params = FILTERS[filt]
    num_docs = P - 777
    cols = _key_lanes(P, num_docs, seed=31 + P)
    want = _jax_outs(P, spec, params, MV_AGGS, None, cols, num_docs)
    got = tk.run_segment_kernel(P, spec, MV_AGGS, None, None,
                                _torch_cols(cols), params, num_docs, "cpu")
    # JAX keeps an MV lane's narrow dtype for its min / max sentinels; the
    # port returns int32, as for single-value ids: the values are equal
    _assert_outs_equal(got, want)
    if filt == "empty_match":
        assert int(got["agg1"]) == 0 and int(got["agg6.min"]) == 16
        assert int(got["agg7.max"]) == -1


# ---------------------------------------------------------------------------
# The planner: the port's specs are the JAX planner's
# ---------------------------------------------------------------------------

#: every device shape of this slice, and the refusals next to them
PLANNED = {
    "mv_key": "SELECT COUNT(*), SUM(hits) FROM baseballStats GROUP BY "
              "position TOP 100",
    "mv_sv_keys": "SELECT COUNT(*), MIN(runs), AVG(salary) FROM "
                  "baseballStats WHERE yearID > 2000 GROUP BY position, "
                  "league TOP 100",
    "valuein_key": "SELECT COUNT(*), SUM(runs) FROM baseballStats WHERE "
                   "league = 'AL' GROUP BY valuein(position, 'P', 'C', 'X'), "
                   "teamID TOP 100",
    "mv_and_valuein": "SELECT COUNT(*) FROM baseballStats GROUP BY "
                      "position, valuein(position, 'SS') TOP 100",
    "expression_key": "SELECT COUNT(*), SUM(runs) FROM baseballStats "
                      "GROUP BY div(yearID,10) TOP 100",
    "colliding_key": "SELECT MAX(hits) FROM baseballStats GROUP BY "
                     "datetime_convert(yearID,'1:DAYS:EPOCH',"
                     "'1:DAYS:EPOCH','5:DAYS'), league TOP 100",
    "expression_aggs": "SELECT SUM(mult(runs,2)), MIN(add(mult(runs,2),1)), "
                       "PERCENTILE50(div(hits,3)) FROM baseballStats WHERE "
                       "teamID = 'BOS'",
    "mv_aggs": "SELECT COUNTMV(position), DISTINCTCOUNTMV(position), "
               "MINMV(position) FROM baseballStats WHERE runs > 10",
    "hll": "SELECT DISTINCTCOUNTHLL(playerName), DISTINCTCOUNTRAWHLL(teamID), "
           "FASTHLL(league) FROM baseballStats WHERE yearID >= 2000",
}
REFUSED = {
    "countmv_valuein": "SELECT COUNTMV(valuein(position, 'P')) FROM "
                       "baseballStats",
    "mv_metric_in_group": "SELECT SUMMV(position) FROM baseballStats "
                          "GROUP BY league TOP 10",
    "distinctcount_in_group": "SELECT DISTINCTCOUNT(teamID) FROM "
                              "baseballStats GROUP BY position TOP 10",
    "valuein_over_sv": "SELECT COUNT(*) FROM baseballStats GROUP BY "
                       "valuein(teamID, 'BOS') TOP 10",
    "float_raw_key": "SELECT COUNT(*) FROM baseballStats GROUP BY salary "
                     "TOP 10",
}


@pytest.fixture(scope="module")
def segments(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("plan"))
    build_segment(d, n=3000, seed=21)
    return JaxLoader.load(d), ImmutableSegmentLoader.load(d, device="cpu")


def _plans(segments, pql, compact=False):
    jseg, tseg = segments
    jreq = JaxOptimizer().optimize(jax_compile(pql))
    treq = BrokerRequestOptimizer().optimize(compile_pql(pql))
    jplan = jax_plan.InstancePlanMaker(allow_group_compaction=compact) \
        .make_segment_plan(jseg, jreq)
    return jplan, port_plan.InstancePlanMaker(
        allow_group_compaction=compact).make_segment_plan(tseg, treq)


def _same_params(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


@pytest.mark.parametrize("compact", [False, True])
@pytest.mark.parametrize("name", sorted(PLANNED))
def test_planner_specs_match_jax(segments, name, compact):
    jplan, tplan = _plans(segments, PLANNED[name], compact)
    assert tplan.fast_path_result is None
    assert tplan.filter_spec == jplan.filter_spec
    assert tplan.agg_specs == jplan.agg_specs
    assert tplan.group_spec == jplan.group_spec
    # the JAX planner appends the valuein member tables to the filter's
    # params; the port keeps them in group_params
    _same_params(list(tplan.params) + list(tplan.group_params),
                 jplan.params)
    assert set(tplan.needed_cols) == set(jplan.needed_cols)
    if tplan.group_spec is not None:
        jt = jplan.group_value_tables
        tt = tplan.group_value_tables
        assert len(jt) == len(tt)
        for a, b in zip(jt, tt):
            assert (a is None) == (b is None)
            if a is not None:
                np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", sorted(REFUSED))
def test_planner_refuses_as_jax(segments, name):
    with pytest.raises(jax_plan.UnsupportedOnDevice):
        _plans(segments, REFUSED[name])
    _jseg, tseg = segments
    treq = BrokerRequestOptimizer().optimize(compile_pql(REFUSED[name]))
    with pytest.raises(port_plan.UnsupportedOnDevice):
        port_plan.InstancePlanMaker().make_segment_plan(tseg, treq)
