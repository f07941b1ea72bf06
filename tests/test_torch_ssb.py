"""SSB Q1.1-Q4.3 through the port's QueryEngine against the JAX engine.

A small SSB table (200,000 rows in 2 segments) is made by the JAX
package's generator; each segment's numpy arrays (sorted dictionaries,
dictIds, raw values) are carried across with the port's
make_segment_from_arrays. Every query must give the same rows on both
engines (same group keys, revenue exactly equal) and both must meet the
numpy oracle. Supplycost: the port sums float64 and is held to the
float64 oracle within rtol 1e-12; the JAX planner's compacted group path
carries float lanes in float32 (pinot_tpu/ops/kernels.py:_block_compact),
so port and JAX agree within rtol 1e-6 (5e-8 measured at this size).
"""
from __future__ import annotations

import pytest

from pinot_tpu.engine import QueryEngine as JaxQueryEngine
from pinot_tpu.tools.datagen import make_ssb_segments
from pinot_tpu_torch.common.datatype import DataType
from pinot_tpu_torch.engine import QueryEngine
from pinot_tpu_torch.tools.datagen import make_segment_from_arrays
from pinot_tpu_torch.tools.ssb import (SSB_PQLS, canon_response, check,
                                       make_cpu_queries)

ROWS, SEGMENTS, SEED = 200_000, 2, 3


def carry_across(seg):
    """A JAX segment's host arrays → the port's segment."""
    dict_cols, raw_cols = {}, {}
    for col in seg.column_names:
        ds = seg.data_source(col)
        dt = DataType(ds.metadata.data_type.value)
        if ds.metadata.has_dictionary:
            dict_cols[col] = (dt, ds.dictionary.values, ds.dict_ids)
        else:
            raw_cols[col] = (dt, ds.raw_values)
    return make_segment_from_arrays(seg.segment_name,
                                    seg.metadata.table_name, dict_cols,
                                    raw_cols)


@pytest.fixture(scope="module")
def engines():
    table = make_ssb_segments(ROWS, SEGMENTS, seed=SEED)
    port = QueryEngine([carry_across(s) for s in table.segments],
                       device="cpu")
    oracle = make_cpu_queries(table.pools, table.ids, table.supplycost)
    return JaxQueryEngine(table.segments), port, oracle


@pytest.mark.parametrize("q", sorted(SSB_PQLS))
def test_ssb_query_matches_jax_and_oracle(engines, q):
    jax_engine, port, oracle = engines
    jax_resp = jax_engine.query(SSB_PQLS[q])
    want = canon_response(q, jax_resp)
    resp = port.query(SSB_PQLS[q])
    assert not resp.exceptions
    got = canon_response(q, resp)
    if q.startswith("q1"):
        assert got == want
    else:
        assert set(got) == set(want)
        for k, w in want.items():
            assert got[k][0] == w[0], (q, k)
            if len(w) > 1:
                assert got[k][1] == pytest.approx(w[1], rel=1e-6), (q, k)
    expected = oracle[q]()
    if not q.startswith("q1"):
        for k, e in expected.items():
            if len(e) > 1:
                assert got[k][1] == pytest.approx(e[1], rel=1e-12), (q, k)
    check(q, got, expected)
    check(q, want, expected)
    assert resp.num_docs_scanned == jax_resp.num_docs_scanned


GROUP_QUERIES = [q for q in sorted(SSB_PQLS) if not q.startswith("q1")]


def _rows_match(got, want, rel):
    assert set(got) == set(want)
    for k, w in want.items():
        assert got[k][0] == w[0], k
        if len(w) > 1:
            assert got[k][1] == pytest.approx(w[1], rel=rel), k


@pytest.mark.parametrize("q", GROUP_QUERIES)
def test_ssb_group_by_takes_the_jax_route_per_segment(engines, monkeypatch,
                                                      q):
    """Compaction on (the planner's default): each segment's final kernel
    spec (key kinds and cardinalities, g_pad, kmax) equals the JAX
    engine's; with InstancePlanMaker(allow_group_compaction=False) K3's
    dense table alone gives the same rows."""
    from pinot_tpu_torch.ops import kernels as tk
    from pinot_tpu_torch.query.executor import ServerQueryExecutor
    from pinot_tpu_torch.query.plan import InstancePlanMaker
    from test_torch_compact import _recorder
    jax_engine, port, oracle = engines
    rec = _recorder(monkeypatch)
    want = canon_response(q, jax_engine.query(SSB_PQLS[q]))
    got = canon_response(q, port.query(SSB_PQLS[q]))
    monkeypatch.undo()
    assert rec["port"] == rec["jax"] and len(rec["port"]) == SEGMENTS
    _rows_match(got, want, 1e-6)
    off = QueryEngine(port.segments, device="cpu")
    off.executor = ServerQueryExecutor(
        InstancePlanMaker(allow_group_compaction=False))
    tk.reset_launch_counts()
    dense = canon_response(q, off.query(SSB_PQLS[q]))
    assert not tk.group_route_counts            # no scout, no compaction
    _rows_match(dense, got, 1e-12)
    check(q, dense, oracle[q]())
