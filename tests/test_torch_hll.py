"""Device HLL (the fused K4: the histogram and the registers of the ids
present, in one launch) against the JAX package and the host sketch.

The loader's per-dictId (register index, rank) tables equal the JAX
loader's; the fused K4's plain version, run through run_segment_kernel
on the same lanes, gives registers bit-equal to the JAX `_agg_outputs` "hll" branch;
a segment's registers equal HyperLogLog.from_values over the values its
matched rows hold, and registers merged across segments (the combine's
register max) equal one sketch of the union; DISTINCTCOUNTHLL and
DISTINCTCOUNTRAWHLL through QueryEngine on the CPU equal the JAX
engine's answers.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from fixtures import build_segment
from pinot_tpu.engine import QueryEngine as JaxQueryEngine
from pinot_tpu.segment.loader import hll_tables_padded as jax_hll_tables
from pinot_tpu_torch.common.sketches import DEFAULT_LOG2M, HyperLogLog
from pinot_tpu_torch.engine import QueryEngine
from pinot_tpu_torch.ops import kernels as tk
from pinot_tpu_torch.segment.loader import hll_tables_padded
from test_torch_kernels import (FILTERS, SHAPES, _jax_outs, _lanes,
                                _torch_cols, hll_lanes)

M = 1 << DEFAULT_LOG2M
#: dictionaries of each value kind the hashing distinguishes
DICTS = {
    "strings": np.array([f"player_{i:03d}" for i in range(997)]),
    "ints": np.arange(-500, 500, 3, dtype=np.int64),
    "floats": np.round(np.linspace(0.0, 1.0, 600), 3),
}


@pytest.mark.parametrize("kind", sorted(DICTS))
def test_hll_tables_match_jax_loader(kind):
    idx, rank = hll_tables_padded(DICTS[kind])
    j_idx, j_rank = jax_hll_tables(DICTS[kind])
    assert idx.dtype == np.int32 and rank.dtype == np.int32
    np.testing.assert_array_equal(idx, j_idx)
    np.testing.assert_array_equal(rank, j_rank)
    assert rank[len(DICTS[kind]):].max() == 0    # padding: the identity


def _hll_cols(P, num_docs, seed):
    # "b" has 1000 ids in an int16 lane; its dictionary: 1000 strings
    cols = _lanes(P, num_docs, seed)
    return hll_lanes(cols, "b", [f"v{i:04d}" for i in range(1000)])


@pytest.mark.parametrize("P", SHAPES)
@pytest.mark.parametrize("filt", ["nested", "empty_match", "full_match"])
def test_hll_registers_plain_match_jax(P, filt):
    spec, params = FILTERS[filt]
    num_docs = P - 777
    cols = _hll_cols(P, num_docs, seed=P + 2)
    aggs = (("count", "*", "none", None),
            ("hll", "b", "sv", ("hll", 1024, M)),
            ("distinctcount", "b", "sv", ("hist", 1024)))
    want = _jax_outs(P, spec, params, aggs, None, cols, num_docs)
    got = tk.run_segment_kernel(P, spec, aggs, None, None, _torch_cols(cols),
                                params, num_docs, "cpu")
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    assert got["agg1.hll"].dtype.itemsize == 4
    if filt == "empty_match":
        assert not got["agg1.hll"].any()


def test_hll_registers_equal_the_host_sketch():
    P, num_docs = SHAPES[0], SHAPES[0] - 777
    values = np.array([f"v{i:04d}" for i in range(1000)])
    cols = _torch_cols(_hll_cols(P, num_docs, seed=4))
    spec, params = FILTERS["nested"]
    mask = tk.filter_mask(P, spec, cols, params, num_docs, "cpu")
    hist, regs = tk.masked_histogram_hll(mask, cols["b.ids"], 1024,
                                         cols["b.hllidx"], cols["b.hllrank"],
                                         M)
    assert torch.equal(hist, tk.masked_histogram(mask, cols["b.ids"], 1024))
    ids = cols["b.ids"].numpy()[mask.numpy().astype(bool)]
    want = HyperLogLog.from_values(values[np.unique(ids)])
    np.testing.assert_array_equal(regs.numpy().astype(np.uint8),
                                  want.registers)


@pytest.fixture(scope="module")
def engines(tmp_path_factory):
    dirs, parts = [], []
    for seed in (41, 42):
        d = str(tmp_path_factory.mktemp(f"hll{seed}"))
        _seg, cols = build_segment(d, n=3000, seed=seed)
        dirs.append(d)
        parts.append(cols)
    return (JaxQueryEngine.from_dirs(dirs),
            QueryEngine.from_dirs(dirs, device="cpu"), parts)


def test_segment_registers_merge_to_the_union_sketch(engines):
    """Each segment's fused-K4 registers are its matched values' sketch; the
    executor's combine (register max) gives the sketch of the union."""
    _jax, port, parts = engines
    from pinot_tpu_torch.pql.optimizer import BrokerRequestOptimizer
    from pinot_tpu_torch.pql.parser import compile_pql
    pql = "SELECT DISTINCTCOUNTHLL(playerName) FROM baseballStats WHERE " \
        "league = 'NL'"
    req = BrokerRequestOptimizer().optimize(compile_pql(pql))
    port.executor.reset_path_counts()
    per_seg = []
    for seg, cols in zip(port.segments, parts):
        blk = port.executor.execute(req, [seg])
        m = np.asarray(cols["league"]) == "NL"
        want = HyperLogLog.from_values(np.unique(
            np.asarray(cols["playerName"])[m]))
        np.testing.assert_array_equal(blk.agg_intermediates[0].registers,
                                      want.registers)
        per_seg.append(want)
    union = np.unique(np.concatenate([
        np.asarray(c["playerName"])[np.asarray(c["league"]) == "NL"]
        for c in parts]))
    merged = port.executor.execute(req, port.segments).agg_intermediates[0]
    np.testing.assert_array_equal(merged.registers,
                                  HyperLogLog.from_values(union).registers)
    np.testing.assert_array_equal(
        merged.registers, per_seg[0].merge(per_seg[1]).registers)
    assert port.executor.path_counts["scan"] == 4
    assert port.executor.path_counts["host"] == 0


@pytest.mark.parametrize("pql", [
    "SELECT DISTINCTCOUNTHLL(playerName), DISTINCTCOUNTHLL(teamID) FROM "
    "baseballStats WHERE yearID >= 2000",
    "SELECT DISTINCTCOUNTRAWHLL(teamID), FASTHLL(playerName) FROM "
    "baseballStats WHERE runs > 20",
    "SELECT DISTINCTCOUNTHLL(runs), DISTINCTCOUNTHLL(average) FROM "
    "baseballStats",
])
def test_hll_answers_match_jax_engine(engines, pql):
    jax_engine, port, _parts = engines
    port.executor.reset_path_counts()
    got = port.query(pql)
    want = jax_engine.query(pql)
    assert not got.exceptions
    assert [a.value for a in got.aggregation_results] == \
        [a.value for a in want.aggregation_results]
    assert port.executor.path_counts["host"] == 0
