"""The QueryGenerator mix over baseballStats: the port against the JAX
engine and both oracles.

Two segments from tests/fixtures.build_segment (seeds 11 and 12, 2,500
rows each, their own dictionaries, as test_query_generator.py builds
them) are loaded by both engines, the port's with
QueryEngine.from_dirs(device="cpu"). The aggregation, group-by and HAVING
families are drawn with the reference seeds by the port's copy of the
generator (pinot_tpu_torch/tools/baseball.py), plus the fixed queries that
reach the strategies the draws may miss. Every answer must equal the JAX
engine's (counts, integer sums, MIN / MAX / MINMAXRANGE, PERCENTILE and
DISTINCTCOUNT exactly; float sums and averages within rtol 1e-6, as in
the port's SSB tests: the JAX compacted group path carries float lanes in
float32) and meet the row-at-a-time tests/oracle.Oracle at the reference
harness's tolerances. Group-by draws with DISTINCTCOUNT have no device
path: the planner raises UnsupportedOnDevice and the port's host twin
answers them, held to the same checks. A second test holds the port's
vectorised oracle to tests/oracle.Oracle on the same table and draws.
"""
from __future__ import annotations

import random

import numpy as np
import pytest

from fixtures import build_segment
from oracle import Oracle as RowOracle
from test_query_generator import SEED, Gen, _check_agg
from pinot_tpu.engine import QueryEngine as JaxQueryEngine
from pinot_tpu_torch.engine import QueryEngine
from pinot_tpu_torch.tools import baseball

N_PER_SEG = 2_500
FLOAT_RTOL = 1e-6
EXACT = ("count", "distinctcount", "min", "max", "minmaxrange",
         "percentile")


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    dirs, parts = [], []
    for seed in (11, 12):
        d = str(tmp_path_factory.mktemp(f"seg{seed}"))
        _seg, cols = build_segment(d, n=N_PER_SEG, seed=seed)
        dirs.append(d)
        parts.append(cols)
    cols = {k: (parts[0][k] + parts[1][k]) if isinstance(parts[0][k], list)
            else np.concatenate([parts[0][k], parts[1][k]])
            for k in parts[0]}
    jax_engine = JaxQueryEngine.from_dirs(dirs)
    port = QueryEngine.from_dirs(dirs, device="cpu")
    vec = baseball.Oracle(baseball.from_fixture_columns(cols))
    return jax_engine, port, RowOracle(cols), vec


def _exact(name, col):
    return name in EXACT or (name == "sum" and col in ("runs", "hits"))


def _same(got, want, exact, what):
    g, w = float(got), float(want)
    if exact:
        assert g == w, what
    else:
        assert g == pytest.approx(w, rel=FLOAT_RTOL), what


def _groups(res):
    return {tuple(str(k) for k in g["group"]): g["value"]
            for g in res.group_by_result}


def _assert_like_jax(resp, jax_resp, draw):
    assert not resp.exceptions and not jax_resp.exceptions, draw.pql
    for i, (_fn, name, col, _tol) in enumerate(draw.aggs):
        got, want = resp.aggregation_results[i], \
            jax_resp.aggregation_results[i]
        exact = _exact(name, col)
        if draw.family == "aggregation":
            _same(got.value, want.value, exact, (draw.pql, i))
            continue
        g, w = _groups(got), _groups(want)
        assert set(g) == set(w), (draw.pql, i)
        for key in w:
            _same(g[key], w[key], exact, (draw.pql, i, key))


def _assert_like_row_oracle(resp, row, draw):
    """The reference harness's checks (test_query_generator.py)."""
    m = draw.mask
    for i, (_fn, name, col, tol) in enumerate(draw.aggs):
        mode = "exact" if tol == "exact" else "approx"
        if draw.family == "aggregation":
            _check_agg(resp, i, row, name, col, mode, m, draw.pql, "port")
            continue
        want = row.group_by(list(draw.dims), m, (name, col)
                            if name != "count" else ("count", None))
        want = {tuple(str(k) for k in key): v for key, v in want.items()}
        if draw.having is not None:
            op, thresh = draw.having
            want = {k: v for k, v in want.items()
                    if (v > thresh if op == ">" else v <= thresh)}
        got = _groups(resp.aggregation_results[i])
        assert set(got) == set(want), (draw.pql, i)
        for key, v in want.items():
            if name == "count":
                assert int(float(got[key])) == int(v), (draw.pql, key)
            elif mode == "exact":
                assert float(got[key]) == pytest.approx(v, rel=1e-9)
            else:
                assert float(got[key]) == pytest.approx(
                    v, rel=1e-3, abs=1e-6), (draw.pql, key)


@pytest.mark.parametrize("family", ["aggregation", "group_by", "having",
                                    "fixed"])
def test_querygen_family_matches_jax_and_oracles(setup, family):
    jax_engine, port, row, vec = setup
    draws = {"aggregation": baseball.aggregation_draws,
             "group_by": baseball.group_by_draws,
             "having": baseball.having_draws,
             "fixed": baseball.fixed_draws}[family](vec)
    answered = on_host = 0
    for draw in draws:
        port.executor.reset_path_counts()
        resp = port.query(draw.pql)
        host = port.executor.path_counts["host"]
        # the host twin answers exactly the draws the planner refuses
        assert host == (2 if draw.host_answered else 0), draw.pql
        on_host += bool(host)
        _assert_like_jax(resp, jax_engine.query(draw.pql), draw)
        if family != "fixed":
            _assert_like_row_oracle(resp, row, draw)
        baseball.check(resp, vec, draw)
        answered += 1
    assert answered == {"aggregation": 14, "group_by": 12, "having": 6,
                        "fixed": 7}[family]
    if family == "group_by":
        assert on_host > 0


@pytest.mark.parametrize("family", ["aggregation", "group_by", "having"])
def test_vectorised_oracle_matches_row_oracle(setup, family):
    _jax, _port, row, vec = setup
    seed = {"aggregation": SEED, "group_by": SEED + 1,
            "having": SEED + 3}[family]
    ref = Gen(random.Random(seed), row)
    draws = list({"aggregation": baseball.aggregation_draws,
                  "group_by": baseball.group_by_draws,
                  "having": baseball.having_draws}[family](vec))
    for draw in draws:
        # the reference generator, draw for draw: same PQL, same rows
        where, m = ref.where()
        if family == "having":
            dims = ref.rng.sample(["teamID", "league"], 1)
            thresh = ref.rng.randint(5, 200)
            op = ref.rng.choice([">", "<="])
            assert draw.pql == ("SELECT COUNT(*) FROM baseballStats" +
                                where + " GROUP BY " + dims[0] +
                                f" HAVING COUNT(*) {op} {thresh} TOP 2000")
            aggs = [("COUNT(*)", "count", None, "exact")]
        else:
            aggs = ref.aggs()
            assert [a[0] for a in aggs] == [a[0] for a in draw.aggs]
            if family == "group_by":
                dims = ref.rng.sample(["teamID", "league", "yearID"],
                                      ref.rng.randint(1, 2))
                assert list(draw.dims) == dims
        assert where in draw.pql
        np.testing.assert_array_equal(draw.mask, m, err_msg=draw.pql)
        for (_fn, name, col, _tol), want in zip(
                aggs, baseball.expected(vec, draw)):
            if family == "aggregation":
                ref_v = row.count(m) if name == "count" else \
                    getattr(row, name)(col, m)
                _same(want, ref_v, name != "sum" or col != "salary",
                      (draw.pql, name))
                continue
            ref_g = row.group_by(list(draw.dims), m, (name, col)
                                 if name != "count" else ("count", None))
            ref_g = {tuple(str(k) for k in key): v
                     for key, v in ref_g.items()}
            if draw.having is not None:
                op, thresh = draw.having
                ref_g = {k: v for k, v in ref_g.items()
                         if (v > thresh if op == ">" else v <= thresh)}
            assert set(want) == set(ref_g), draw.pql
            for key, v in ref_g.items():
                assert float(want[key]) == pytest.approx(float(v),
                                                         rel=1e-12), key


# ---------------------------------------------------------------------------
# MV group-by family, the planner's device shapes, the raw-key table
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("family", ["mv_group_by", "shapes"])
def test_mv_and_shape_families_match_jax_and_oracle(setup, family):
    """The MV group-by family (8 draws, seed SEED + 7) and one query per
    device shape (HLL, MV aggregations, expression aggregations and keys,
    MV and valuein keys): equal to the JAX engine and the vectorised
    oracle; only COUNTMV(valuein(...)), an MV expression aggregation the
    JAX planner refuses too, reaches the host twin."""
    jax_engine, port, _row, vec = setup
    draws = {"mv_group_by": baseball.mv_group_by_draws,
             "shapes": baseball.shape_draws}[family](vec)
    answered = on_host = 0
    for draw in draws:
        port.executor.reset_path_counts()
        resp = port.query(draw.pql)
        host = port.executor.path_counts["host"]
        assert host == (2 if draw.host_answered else 0), draw.pql
        on_host += bool(host)
        _assert_like_jax(resp, jax_engine.query(draw.pql), draw)
        baseball.check(resp, vec, draw)
        answered += 1
    assert (answered, on_host) == {"mv_group_by": (8, 0),
                                   "shapes": (8, 1)}[family]


def test_mv_group_by_oracle_matches_reference_expansion(setup):
    """The port's MV family, draw for draw the reference's (same PQL, same
    rows), and its vectorised oracle equal to the reference's
    row-at-a-time entry expansion (aggregateGroupByMV semantics)."""
    _jax, _port, row, vec = setup
    ref = Gen(random.Random(SEED + 7), row)
    all_pos = sorted({v for lst in row.cols["position"] for v in lst})
    for draw in baseball.mv_group_by_draws(vec):
        where, m = ref.where()
        allowed = None
        if ref.rng.random() < 0.5:
            picks = ref.rng.sample(all_pos, ref.rng.randint(2, 5))
            mvkey = "valuein(position, %s)" % \
                ", ".join("'%s'" % p for p in picks)
            allowed = set(picks)
        else:
            mvkey = "position"
        extra_sv = ref.rng.choice([None, "league"])
        dims = [mvkey] + ([extra_sv] if extra_sv else [])
        assert draw.pql == ("SELECT COUNT(*), SUM(hits) FROM baseballStats"
                            + where + " GROUP BY " + ", ".join(dims) +
                            " TOP 5000")
        np.testing.assert_array_equal(draw.mask, m, err_msg=draw.pql)
        exp = {}
        for i, lst in enumerate(row.cols["position"]):
            if not m[i]:
                continue
            for v in lst:
                if allowed is not None and v not in allowed:
                    continue
                key = (v,) + ((str(row.cols["league"][i]),)
                              if extra_sv else ())
                e2 = exp.setdefault(key, [0, 0.0])
                e2[0] += 1
                e2[1] += float(row.cols["hits"][i])
        want_cnt, want_sum = baseball.expected(vec, draw)
        assert want_cnt == {k: v[0] for k, v in exp.items()}, draw.pql
        assert want_sum == pytest.approx({k: v[1] for k, v in exp.items()},
                                         rel=1e-12)


@pytest.fixture(scope="module")
def raw_setup(tmp_path_factory):
    d, cols = baseball.build_raw_key_dir(
        str(tmp_path_factory.mktemp("rawkeys")), 4_000, seed=17)
    return (JaxQueryEngine.from_dirs([d]),
            QueryEngine.from_dirs([d], device="cpu"), baseball.Oracle(cols))


def test_raw_key_group_bys_match_jax_and_oracle(raw_setup):
    """GROUP BY runs, hits x league and runs with MIN(hits) over the
    raw-key table (runs, hits, salary without a dictionary): "rawoff"
    keys on the device path, equal to the JAX engine and the oracle."""
    jax_engine, port, vec = raw_setup
    n = 0
    for draw in baseball.raw_key_draws(vec):
        port.executor.reset_path_counts()
        resp = port.query(draw.pql)
        assert port.executor.path_counts == {"pruned": 0, "fast": 0,
                                             "scan": 1, "host": 0}
        _assert_like_jax(resp, jax_engine.query(draw.pql), draw)
        baseball.check(resp, vec, draw)
        n += 1
    assert n == 3
    plan_keys = port.segments[0].data_source("runs").metadata
    assert not plan_keys.has_dictionary


@pytest.fixture(scope="module")
def mv_metric_setup(tmp_path_factory):
    dirs, parts = [], []
    for i, seed in enumerate((31, 32)):
        d, cols = baseball.build_mv_metric_dir(
            str(tmp_path_factory.mktemp(f"mvmetric{i}")), 3_000, seed=seed)
        dirs.append(d)
        parts.append(cols)
    return (JaxQueryEngine.from_dirs(dirs),
            QueryEngine.from_dirs(dirs, device="cpu"),
            baseball.Oracle(baseball.concat_columns(parts)))


def test_mv_metric_aggregations_match_jax_and_oracle(mv_metric_setup):
    """MINMV, MAXMV, MINMAXRANGEMV, SUMMV, AVGMV, PERCENTILE50MV, COUNTMV
    and DISTINCTCOUNTMV over a numeric MV column, and GROUP BY that
    column, over two segments with their own dictionaries: on the device
    path, equal to the JAX engine and the oracle."""
    jax_engine, port, vec = mv_metric_setup
    n = 0
    for draw in baseball.mv_metric_draws(vec):
        port.executor.reset_path_counts()
        resp = port.query(draw.pql)
        assert port.executor.path_counts == {"pruned": 0, "fast": 0,
                                             "scan": 2, "host": 0}
        _assert_like_jax(resp, jax_engine.query(draw.pql), draw)
        baseball.check(resp, vec, draw)
        n += 1
    assert n == 3
