"""Three queries the JAX engine answers and the port got wrong or refused.

1. FASTHLL over a column with a derived HLL column: the port now rewrites
   FASTHLL(col) to the derived serialized-sketch column the segments'
   metadata records (query/plan.py:preprocess_request), as the JAX engine
   does, and raises when the segments disagree on it. Segments: the JAX
   creator's, with the hll_config of tests/test_sketches.py:219.
2. SUM over an integer dictionary on one segment whose 127 * rows pass
   2^31 (17,000,000 rows, padded to 17,006,592): K2 splits the rows into
   exact int32 ranges and the host folds them in int64
   (ops/kernels.py:part_sum_range), as the JAX `_part_sums` returns block
   partials; the sum equals numpy's and the JAX engine's.
3. GROUP BY three MV columns 41 entries wide: 68,921 entry combinations
   per doc, past the 65,536 one K3 thread walks; the walk now splits over
   several threads (dense_group_aggregate.cu). The answer equals the JAX
   engine's host executor (the JAX device path would expand [P * 68,921]
   rows, 564M at P = 8,192).

Each runs on the CPU (the plain versions) and, marked `cuda`, on the card.
"""
from __future__ import annotations

import os

import numpy as np
import pytest
import torch

from fixtures import make_schema, make_table_config
from pinot_tpu.common.datatype import DataType as JaxDataType
from pinot_tpu.common.schema import Schema as JaxSchema
from pinot_tpu.common.schema import dimension as jax_dimension
from pinot_tpu.common.schema import metric as jax_metric
from pinot_tpu.engine import QueryEngine as JaxQueryEngine
from pinot_tpu.segment.creator import SegmentCreator as JaxSegmentCreator
from pinot_tpu.segment.loader import ImmutableSegmentLoader as JaxLoader
from pinot_tpu.tools import datagen as jax_datagen
from pinot_tpu_torch.common.datatype import DataType
from pinot_tpu_torch.engine import QueryEngine
from pinot_tpu_torch.ops import kernels as tk
from pinot_tpu_torch.parallel import make_mesh
from pinot_tpu_torch.pql.parser import compile_pql
from pinot_tpu_torch.query.plan import preprocess_request
from pinot_tpu_torch.segment.loader import ImmutableSegmentLoader
from pinot_tpu_torch.tools.datagen import make_segment_from_arrays


def _engines(dirs, device):
    mesh = make_mesh([device]) if str(device) == "cpu" else make_mesh()
    return (QueryEngine.from_dirs(dirs, device=device),
            QueryEngine.from_dirs(dirs, device=device, mesh=mesh))


# ---------------------------------------------------------------------------
# 1. FASTHLL → the derived HLL column
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def hll_dirs(tmp_path_factory):
    """tests/test_sketches.py:219's segments: playerName gets a derived
    playerName_hll column of per-row serialized sketches (log2m 11)."""
    base = str(tmp_path_factory.mktemp("hll"))
    cfg = make_table_config()
    cfg.indexing_config.hll_config = {
        "columnsToDerive": ["playerName"], "log2m": 11, "suffix": "_hll"}
    dirs = []
    for i in range(2):
        n = 3000
        rng = np.random.default_rng(300 + i)
        names = np.array([f"p{i}_{j % 900}" for j in
                          rng.integers(0, 900, n)], dtype=object)
        cols = {
            "teamID": np.array(rng.choice(["BOS", "NYA"], n), dtype=object),
            "league": np.array(["AL"] * n, dtype=object),
            "playerName": names,
            "position": [["P"]] * n,
            "runs": rng.integers(0, 100, n).astype(np.int32),
            "hits": rng.integers(0, 250, n).astype(np.int64),
            "average": np.round(rng.random(n), 3),
            "salary": (rng.random(n).astype(np.float32) * 1e6).round(2),
            "yearID": rng.integers(1990, 2020, n).astype(np.int32),
        }
        d = os.path.join(base, f"seg{i}")
        os.makedirs(d)
        JaxSegmentCreator(make_schema(), cfg, f"hllder_{i}").build(cols, d)
        dirs.append(d)
    return dirs


FASTHLL = "SELECT FASTHLL(playerName) FROM baseballStats"
FASTHLL_BY_TEAM = FASTHLL + " GROUP BY teamID TOP 10"


def _fasthll_answers(engine):
    resp = engine.query(FASTHLL)
    assert not resp.exceptions, resp.exceptions
    agg = resp.aggregation_results[0]
    grouped = engine.query(FASTHLL_BY_TEAM).aggregation_results[0]
    groups = {g["group"][0]: int(g["value"])
              for g in grouped.group_by_result}
    return agg.function, int(agg.value), groups


def _check_fasthll(dirs, device):
    jax_engine = JaxQueryEngine([JaxLoader.load(d) for d in dirs])
    want = _fasthll_answers(jax_engine)
    assert want[1:] == (1723, {"NYA": 1456, "BOS": 1434})
    assert "playerName_hll" in want[0]
    for engine in _engines(dirs, device):
        assert _fasthll_answers(engine) == want


def test_fasthll_uses_the_derived_column(hll_dirs):
    _check_fasthll(hll_dirs, "cpu")


def test_fasthll_derived_column_must_agree(tmp_path, hll_dirs):
    """One segment with the derived column, one without: the rewrite
    raises, as the JAX engine's does."""
    d = str(tmp_path / "plain")
    from fixtures import make_columns
    JaxSegmentCreator(make_schema(), make_table_config(), "plain").build(
        make_columns(500, seed=1), d)
    segs = [ImmutableSegmentLoader.load(hll_dirs[0]),
            ImmutableSegmentLoader.load(d)]
    with pytest.raises(RuntimeError, match="inconsistency HLL derived"):
        preprocess_request(segs, compile_pql(FASTHLL))
    with pytest.raises(RuntimeError, match="inconsistency HLL derived"):
        QueryEngine(segs, device="cpu").query(FASTHLL)
    # no FASTHLL, or no derived column anywhere: the request passes as is
    req = compile_pql("SELECT COUNT(*) FROM baseballStats")
    assert preprocess_request(segs, req) is req
    req = compile_pql(FASTHLL)
    assert preprocess_request(segs[1:], req) is req


# ---------------------------------------------------------------------------
# 2. SUM over one segment of 17,000,000 rows
# ---------------------------------------------------------------------------

BIG_ROWS = 17_000_000
SUM_K1 = "SELECT SUM(v) FROM t WHERE k = 1"


def _big_arrays():
    rng = np.random.default_rng(17)
    k_ids = rng.integers(0, 4, BIG_ROWS).astype(np.int32)
    v_vals = np.arange(0, 4000, 2, dtype=np.int64) * 1000 + 7
    v_ids = rng.integers(0, len(v_vals), BIG_ROWS).astype(np.int32)
    want = int(v_vals[v_ids[k_ids == 1]].sum())
    return k_ids, v_vals, v_ids, want


def _big_segment(make, dtype, arrays):
    k_ids, v_vals, v_ids, _want = arrays
    return make("big", "t", {
        "k": (dtype.INT, np.arange(4, dtype=np.int32), k_ids),
        "v": (dtype.LONG, v_vals, v_ids)})


def test_sum_past_int32_part_range():
    arrays = _big_arrays()
    want = arrays[3]
    assert 127 * 17_006_592 >= 2**31 and want > 2**31
    seg = _big_segment(make_segment_from_arrays, DataType, arrays)
    assert seg.padded_docs == 17_006_592
    assert tk.part_sum_range(seg.padded_docs) * 2 == seg.padded_docs
    got = QueryEngine([seg], device="cpu").query(SUM_K1)
    assert int(float(got.aggregation_results[0].value)) == want
    jax_seg = _big_segment(jax_datagen.make_segment_from_arrays,
                           JaxDataType, arrays)
    jax_got = JaxQueryEngine([jax_seg]).query(SUM_K1)
    assert got.aggregation_results[0].value == \
        jax_got.aggregation_results[0].value


def test_part_sum_range_splits_exactly():
    # a row count whose blocks do not halve: the ranges are the largest
    # block multiple below the int32 bound that divides the rows
    for blocks in (2076, 2069, 4128, 100):
        rows = blocks * tk.BLOCK
        per = tk.part_sum_range(rows)
        assert rows % per == 0 and per % tk.BLOCK == 0
        assert 127 * per < 2**31
        # no larger block multiple below the bound divides the rows
        assert all(rows % (m * tk.BLOCK) for m in range(
            per // tk.BLOCK + 1, (2**31 // 127) // tk.BLOCK + 1))
    mask = torch.ones(2069 * tk.BLOCK, dtype=torch.uint8)
    parts = torch.full((1, 2069 * tk.BLOCK), 127, dtype=torch.int8)
    out = tk.masked_part_sums(mask, [parts])
    assert out.shape == (2069, 2)
    assert int(out[:, 0].long().sum()) == 127 * 2069 * tk.BLOCK


# ---------------------------------------------------------------------------
# 3. GROUP BY three MV keys 41 entries wide
# ---------------------------------------------------------------------------

MV_DOCS, MV_WIDTH, MV_CARD = 150, 41, 41
MV_GROUP = ("SELECT COUNT(*), SUM(m) FROM mvt GROUP BY a, b, c "
            "TOP 100000")


@pytest.fixture(scope="module")
def mv_dirs(tmp_path_factory):
    base = str(tmp_path_factory.mktemp("mv"))
    schema = JaxSchema("mvt", [
        jax_dimension("a", JaxDataType.INT, single_value=False),
        jax_dimension("b", JaxDataType.INT, single_value=False),
        jax_dimension("c", JaxDataType.INT, single_value=False),
        jax_metric("m", JaxDataType.INT)])
    rng = np.random.default_rng(41)
    dirs = []
    for s in range(2):
        cols = {name: [list(rng.integers(0, MV_CARD, MV_WIDTH))
                       for _ in range(MV_DOCS)] for name in "abc"}
        cols["a"][0] = list(range(MV_WIDTH))   # every value occurs
        cols["m"] = rng.integers(0, 1000, MV_DOCS).astype(np.int32)
        d = os.path.join(base, f"mv{s}")
        JaxSegmentCreator(schema, segment_name=f"mv{s}").build(cols, d)
        dirs.append(d)
    return dirs


def _groups(resp):
    assert not resp.exceptions, resp.exceptions
    return [{tuple(g["group"]): float(g["value"])
             for g in agg.group_by_result}
            for agg in resp.aggregation_results]


def _check_mv_group(dirs, device):
    seg = ImmutableSegmentLoader.load(dirs[0])
    keys = [tk.GroupKey("mvids", torch.from_numpy(
        seg.data_source(c).host_operand("mv")), card=MV_CARD) for c in "abc"]
    assert tk.group_combos(keys) == 68_921 > tk.MAX_GROUP_COMBOS
    want = _groups(JaxQueryEngine([JaxLoader.load(d) for d in dirs],
                                  use_device=False).query(MV_GROUP))
    assert sum(want[0].values()) > 2 * MV_DOCS * 60_000
    for engine in _engines(dirs, device):
        assert _groups(engine.query(MV_GROUP)) == want


def test_group_by_wide_mv_cross_product(mv_dirs):
    _check_mv_group(mv_dirs, "cpu")


# ---------------------------------------------------------------------------
# the same on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_fasthll_uses_the_derived_column_cuda(cuda_device, hll_dirs):
    _check_fasthll(hll_dirs, cuda_device)


@pytest.mark.cuda
def test_sum_past_int32_part_range_cuda(cuda_device):
    arrays = _big_arrays()
    seg = _big_segment(make_segment_from_arrays, DataType, arrays)
    got = QueryEngine([seg], device=cuda_device).query(SUM_K1)
    assert int(float(got.aggregation_results[0].value)) == arrays[3]


@pytest.mark.cuda
def test_group_by_wide_mv_cross_product_cuda(cuda_device, mv_dirs):
    _check_mv_group(mv_dirs, cuda_device)
