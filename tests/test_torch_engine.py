"""Planner and engine paths beyond SSB, against the JAX engine.

One table built from the same numpy arrays in both packages: integer,
string and float dictionary columns and a raw float64 column. Queries
cover the filter kinds SSB does not use (NOT IN, <>, member bitsets from
long IN lists and REGEXP_LIKE, OR), the match-all and metadata fast
paths, AVG and COUNT in group-by, float sums (csums) over a float
dictionary and a raw column, raw-column filters, MIN / MAX / MINMAXRANGE
with and without group-by, DISTINCTCOUNT and PERCENTILE, and a group-by
DISTINCTCOUNT that the planner refuses and the host twin answers.
Integer results equal the JAX engine's;
float sums are held to a float64 numpy oracle within rtol 1e-12 and to
the JAX engine within rtol 1e-6 (its compacted group path carries float
lanes in float32).
"""
from __future__ import annotations

import numpy as np
import pytest

from pinot_tpu.common.datatype import DataType as JDataType
from pinot_tpu.engine import QueryEngine as JaxQueryEngine
from pinot_tpu.tools.datagen import make_segment_from_arrays as jax_make
from pinot_tpu_torch.common.datatype import DataType
from pinot_tpu_torch.engine import QueryEngine
from pinot_tpu_torch.pql.optimizer import BrokerRequestOptimizer
from pinot_tpu_torch.pql.parser import compile_pql
from pinot_tpu_torch.query.plan import InstancePlanMaker, \
    UnsupportedOnDevice
from pinot_tpu_torch.tools.datagen import make_segment_from_arrays

N = 6000


def _arrays(seed):
    rng = np.random.default_rng(seed)
    k2_vals = np.array(sorted(f"x{i:02d}" for i in range(30)), dtype=object)
    v_vals = np.unique(rng.integers(0, 1_000_000, 600))[:500]
    f_vals = np.unique((rng.random(200) * 1e4).round(3))[:100]
    dict_cols = {
        "k1": ("INT", np.arange(7), rng.integers(0, 7, N)),
        "k2": ("STRING", k2_vals, rng.integers(0, 30, N)),
        "v": ("LONG", v_vals, rng.integers(0, len(v_vals), N)),
        "f": ("DOUBLE", f_vals, rng.integers(0, len(f_vals), N)),
    }
    raw_cols = {"r": ("DOUBLE", (rng.random(N) * 1e5).round(2))}
    return dict_cols, raw_cols


def _segments(make, dtype):
    segs = []
    for i in range(2):
        dict_cols, raw_cols = _arrays(seed=40 + i)
        segs.append(make(
            f"t_{i}", "t",
            {c: (dtype[t], vals, ids) for c, (t, vals, ids)
             in dict_cols.items()},
            {c: (dtype[t], vals) for c, (t, vals) in raw_cols.items()}))
    return segs


@pytest.fixture(scope="module")
def engines():
    port = QueryEngine(_segments(make_segment_from_arrays, DataType),
                       device="cpu")
    jax_engine = JaxQueryEngine(_segments(jax_make, JDataType))
    return port, jax_engine


def _rows(resp):
    out = {}
    for ai, agg in enumerate(resp.aggregation_results):
        if agg.group_by_result is None:
            out.setdefault((), []).append(float(agg.value))
            continue
        for g in agg.group_by_result:
            out.setdefault(tuple(g["group"]), [None] * len(
                resp.aggregation_results))[ai] = float(g["value"])
    return out


LONG_IN = ", ".join(f"'x{i:02d}'" for i in range(0, 30, 2))  # 15 values
QUERIES = {
    "member_in_group": "SELECT COUNT(*), SUM(v), AVG(v) FROM t WHERE k2 IN "
                       f"({LONG_IN}, 'x29', 'x27') GROUP BY k1 TOP 100",
    "notin_neq_csums": "SELECT SUM(f), AVG(r), SUM(v) FROM t WHERE k2 NOT "
                       "IN ('x01', 'x02') AND k1 <> 3 GROUP BY k1, k2 "
                       "TOP 1000",
    "regexp_or": "SELECT COUNT(*), SUM(v) FROM t WHERE "
                 "REGEXP_LIKE(k2, 'x1.') OR k1 = 2",
    "match_all_sum": "SELECT SUM(v), AVG(v) FROM t",
    "match_all_group": "SELECT COUNT(*), SUM(r) FROM t GROUP BY k1 TOP 100",
    "metadata_count": "SELECT COUNT(*) FROM t",
    "empty": "SELECT SUM(v) FROM t WHERE k2 = 'nope'",
    # the strategies of this slice: id / raw min-max, histograms,
    # raw-column filters and group min / max
    "minmax_hist": "SELECT MIN(v), MAX(f), MINMAXRANGE(r), DISTINCTCOUNT(k2), "
                   "PERCENTILE50(v), SUM(f) FROM t WHERE k1 IN (1, 2, 5)",
    "raw_filter": "SELECT COUNT(*), SUM(r), MAX(r) FROM t WHERE r > 50000.5 "
                  "AND r NOT IN (1.5) OR k2 = 'x03'",
    "group_minmax": "SELECT MIN(v), MAX(r), MINMAXRANGE(f) FROM t WHERE "
                    "r <= 70000 GROUP BY k1 TOP 100",
}
FLOAT_AGGS = {"notin_neq_csums": (0, 1), "match_all_group": (1,),
              "raw_filter": (1,)}


@pytest.mark.parametrize("name", sorted(QUERIES))
def test_engine_matches_jax(engines, name):
    port, jax_engine = engines
    got = _rows(port.query(QUERIES[name]))
    want = _rows(jax_engine.query(QUERIES[name]))
    assert set(got) == set(want)
    floats = FLOAT_AGGS.get(name, ())
    for k, w in want.items():
        for ai, (g, e) in enumerate(zip(got[k], w)):
            if ai in floats:
                assert g == pytest.approx(e, rel=1e-6), (k, ai)
            else:
                assert g == e, (k, ai)


def test_float_group_sums_match_numpy(engines):
    port, _ = engines
    got = _rows(port.query(QUERIES["notin_neq_csums"]))
    sums = {}
    for i in range(2):
        dict_cols, raw_cols = _arrays(seed=40 + i)
        k1 = dict_cols["k1"][1][dict_cols["k1"][2]]
        k2 = dict_cols["k2"][1][dict_cols["k2"][2]]
        f = dict_cols["f"][1][dict_cols["f"][2]]
        r = raw_cols["r"][1]
        keep = ~np.isin(k2, ["x01", "x02"]) & (k1 != 3)
        for a, b, fv, rv in zip(k1[keep], k2[keep], f[keep], r[keep]):
            e = sums.setdefault((int(a), b), [0.0, 0.0, 0])
            e[0] += fv
            e[1] += rv
            e[2] += 1
    assert set(got) == set(sums)
    for k, (fs, rs, n) in sums.items():
        assert got[k][0] == pytest.approx(fs, rel=1e-12)
        assert got[k][1] == pytest.approx(rs / n, rel=1e-12)


def test_unsupported_shape_raises(engines):
    port, jax_engine = engines
    # DISTINCTCOUNT inside a group-by has no device path: the planner
    # raises (the JAX planner's UnsupportedOnDevice too), and the engine
    # answers it on the host twin, as the JAX engine does
    pql = "SELECT DISTINCTCOUNT(v) FROM t WHERE k1 = 1 GROUP BY k2 TOP 10"
    request = BrokerRequestOptimizer().optimize(compile_pql(pql))
    with pytest.raises(UnsupportedOnDevice):
        InstancePlanMaker().make_segment_plan(port.segments[0], request)
    port.executor.reset_path_counts()
    got = _rows(port.query(pql))
    assert port.executor.path_counts == {"pruned": 0, "fast": 0, "scan": 0,
                                         "host": 2}
    assert got == _rows(jax_engine.query(pql))
