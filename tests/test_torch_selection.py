"""K6 masked_select and the selection path, against the JAX package.

The plain version of K6 (what the wrapper runs for a CPU tensor) is held
to the JAX `_selection_outputs` through each package's
run_segment_kernel, on identical operands made from a seed with numpy,
exactly: docids, match count and every gathered column (values and
dtype). The cases cross each select kind with its key lanes (dictIds
int8 / int16 / int32; raw int32, int64, float32, float64), ASC and DESC,
k in {1, 16, 2048} and four masks (all rows, none, about 1% of them, and
the rows of the two commonest key values, so ties decide). Edge cases:
int32 keys at INT32_MAX / INT32_MAX - 1 (which the JAX clamp ties) and
INT32_MIN, +-0.0, NaNs of both signs and infinities, int64 extremes, and
k above the match count. The port's QueryEngine on the CPU answers the
generator's selection and two-key ORDER BY families and the fixed
selections with row lists equal to the JAX engine's, and both meet the
vectorised oracle and the reference harness's checks against
tests/oracle.py. Tests marked `cuda` hold the CUDA kernel to the plain
version on the card, k = 65,536 included, and skip where there is none.
"""
from __future__ import annotations

import ctypes

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fixtures import build_segment
from oracle import Oracle as RowOracle
from pinot_tpu.engine import QueryEngine as JaxQueryEngine
from pinot_tpu.ops import kernels as jk
from pinot_tpu_torch.engine import QueryEngine
from pinot_tpu_torch.ops import kernels as tk
from pinot_tpu_torch.tools import baseball

P = 8192
NUM_DOCS = P - 333
I32_MAX, I32_MIN = 2**31 - 1, -2**31

#: key lanes: name → (dtype, pool of values)
_RNG = np.random.default_rng(21)
KEY_POOLS = {
    "i8": (np.int8, np.arange(50)),
    "i16": (np.int16, np.arange(3000)),
    "i32": (np.int32, np.arange(40000)),
    "ri32": (np.int32, np.unique(_RNG.integers(-5000, 5000, 64))),
    "ri64": (np.int64, np.unique(_RNG.integers(-2**40, 2**40, 64))),
    "rf32": (np.float32, np.unique((_RNG.random(64) * 1e6 - 5e5)
                                   .astype(np.float32))),
    "rf64": (np.float64, np.unique(_RNG.random(64) * 1e5 - 5e4)),
}
CARD_PAD = {"i8": 51, "i16": 3001, "i32": 40001}     # cardinality + 1


def _host_lanes(seed: int = 7):
    """Lanes in the segment layout: ids padded with card, raw with 0, an
    MV lane [P, 3], and the `flag` lane whose value 1 marks a row the
    case's mask keeps (so all masks share one compiled JAX kernel)."""
    rng = np.random.default_rng(seed)
    lanes = {}
    for name, (dt, pool) in KEY_POOLS.items():
        src = "ids" if name in CARD_PAD else "raw"
        lane = np.full(P, CARD_PAD.get(name, 1) - 1 if src == "ids" else 0,
                       dtype=dt)
        lane[:NUM_DOCS] = rng.choice(pool, NUM_DOCS)
        lanes[f"{name}.{src}"] = lane
    mv = np.full((P, 3), 10, dtype=np.int8)
    mv[:NUM_DOCS] = rng.integers(0, 10, (NUM_DOCS, 3))
    mv[:NUM_DOCS][rng.random((NUM_DOCS, 3)) < 0.3] = 10
    lanes["mv.mv"] = mv
    return lanes


GATHER = (("i8", "sv"), ("rf32", "raw"), ("ri64", "raw"), ("mv", "mv"))
FILTER = ("pred", "eq_id", "flag", "sv", None)


def _masks(lanes, first_key):
    rng = np.random.default_rng(3)
    valid = np.arange(P) < NUM_DOCS
    key = lanes[first_key]
    vals, counts = np.unique(key[:NUM_DOCS], return_counts=True)
    common = vals[np.argsort(-counts, kind="stable")[:2]]
    return {"all": valid, "none": np.zeros(P, bool),
            "sparse": valid & (rng.random(P) < 0.01),
            "ties": valid & np.isin(key, common)}


def _run_both(lanes, mask, spec):
    """(JAX outputs, port outputs) as numpy, for one select spec."""
    cols = dict(lanes, **{"flag.ids": mask.astype(np.int8)})
    jout = jk.run_segment_kernel(P, FILTER, (), None, spec,
                                 {k: jnp.asarray(v) for k, v in cols.items()},
                                 (np.int32(1),), NUM_DOCS)
    tout = tk.run_segment_kernel(P, FILTER, (), None, spec,
                                 {k: torch.from_numpy(v)
                                  for k, v in cols.items()},
                                 (np.int32(1),), NUM_DOCS, "cpu")
    names = ["sel.docids", "sel.count"] + [f"sel.{c}" for c, _ in spec[3]]
    return ({n: np.asarray(jout[n]) for n in names},
            {n: tout[n].numpy() for n in names})


def _assert_equal(jout, tout):
    for name, want in jout.items():
        got = tout[name]
        assert got.dtype == want.dtype, (name, got.dtype, want.dtype)
        assert got.shape == want.shape, name
        # bit patterns, so that NaN payloads and -0.0 compare too
        assert got.tobytes() == want.tobytes(), name


def _order(kind, key, asc):
    if kind == "order":
        return tuple((k, asc, CARD_PAD[k], "sv") for k in key)
    return tuple((k, asc, 0, "sv" if k in CARD_PAD else "raw") for k in key)


#: (kind, order key columns); "order" packs its dictId keys
CASES = [("limit", ())] + \
    [("order", (c,)) for c in ("i8", "i16", "i32")] + \
    [("order", ("i8", "i16"))] + \
    [("ordertk", (c,)) for c in ("ri32", "rf32")] + \
    [("ordermk", (c,)) for c in ("i8", "i16", "i32", "ri32", "ri64", "rf32",
                                 "rf64")] + \
    [("ordermk", ("i8", "rf64"))]


def _case_ids():
    out = []
    for kind, key in CASES:
        for asc in ((True,) if kind == "limit" else (True, False)):
            out.append((kind, key, asc))
    return out


@pytest.fixture(scope="module")
def lanes():
    return _host_lanes()


@pytest.mark.parametrize("mask_name", ["all", "none", "sparse", "ties"])
@pytest.mark.parametrize("k", [1, 16, 2048])
@pytest.mark.parametrize("kind,key,asc", _case_ids(),
                         ids=lambda v: "-".join(v) if isinstance(v, tuple)
                         else str(v))
def test_selection_plain_matches_jax(lanes, kind, key, asc, k, mask_name):
    first = f"{key[0]}.{'ids' if key[0] in CARD_PAD else 'raw'}" if key \
        else "i8.ids"
    mask = _masks(lanes, first)[mask_name]
    spec = (kind, k, _order(kind, key, asc), GATHER)
    jout, tout = _run_both(lanes, mask, spec)
    _assert_equal(jout, tout)
    assert int(tout["sel.count"]) == int(mask.sum())


def _edge_lanes():
    """Raw lanes of extreme values: int32 at both ends, floats with signed
    zeros, NaNs of both signs (two payloads) and infinities, int64 ends."""
    rng = np.random.default_rng(11)
    i32 = np.array([I32_MAX, I32_MAX - 1, I32_MIN, I32_MIN + 1, 0, -1, 7],
                   np.int32)
    nan_neg = np.array([0xFFC00000], np.uint32).view(np.float32)[0]
    nan_pay = np.array([0x7FC00001], np.uint32).view(np.float32)[0]
    f32 = np.array([0.0, -0.0, np.nan, nan_neg, nan_pay, np.inf, -np.inf,
                    1.5, -1.5], np.float32)
    f64 = np.array([0.0, -0.0, np.nan, -np.nan,
                    np.array([0x7FF8000000000001], np.uint64)
                    .view(np.float64)[0], np.inf, -np.inf, 2.5], np.float64)
    i64 = np.array([2**63 - 1, -2**63, 0, -1, 2**32, 2**32 - 1, -2**32],
                   np.int64)
    lanes = _host_lanes(seed=5)
    for name, pool in (("ri32", i32), ("rf32", f32), ("rf64", f64),
                       ("ri64", i64)):
        lane = np.zeros(P, pool.dtype)
        lane[:NUM_DOCS] = rng.choice(pool, NUM_DOCS)
        lanes[f"{name}.raw"] = lane
    return lanes


EDGE_CASES = [("ordertk", ("ri32",)), ("ordertk", ("rf32",)),
              ("ordermk", ("rf32",)), ("ordermk", ("rf64",)),
              ("ordermk", ("ri64",)), ("ordermk", ("ri32", "rf64"))]


@pytest.mark.parametrize("asc", [True, False])
@pytest.mark.parametrize("kind,key", EDGE_CASES,
                         ids=lambda v: "-".join(v) if isinstance(v, tuple)
                         else str(v))
def test_selection_edge_values_match_jax(kind, key, asc):
    lanes = _edge_lanes()
    valid = np.arange(P) < NUM_DOCS
    # every row (k = 2048 of 7,859), then a sparse mask under k = 2048
    # (k above the match count: -1 padding)
    sparse = valid & (np.random.default_rng(2).random(P) < 0.05)
    for mask in (valid, sparse):
        spec = (kind, 2048, _order(kind, key, asc), GATHER)
        jout, tout = _run_both(lanes, mask, spec)
        _assert_equal(jout, tout)
    assert (tout["sel.docids"] == -1).any()


def test_monotone_keys_match_jax():
    lanes = _edge_lanes()
    for name in ("ri32", "rf32", "rf64", "ri64", "i8", "i16"):
        lane = lanes[f"{name}.{'ids' if name in CARD_PAD else 'raw'}"]
        for asc in (True, False):
            want = jk._monotone_int32_keys(jnp.asarray(lane), asc)
            got = tk.monotone_keys_plain(torch.from_numpy(lane), asc)
            assert len(got) == len(want)
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_masked_select_rejects_bad_operands(lanes):
    cols = {k: torch.from_numpy(v) for k, v in lanes.items()}
    mask = torch.ones(P, dtype=torch.uint8)
    with pytest.raises(ValueError, match="select k"):
        tk.masked_select(("limit", P + 1, (), ()), cols, mask)
    with pytest.raises(ValueError, match="not a K6"):
        tk.masked_select(("top", 4, (), ()), cols, mask)
    with pytest.raises(ValueError, match="query vector"):
        tk.masked_select(("vector", 4, (), ()), cols, mask)
    with pytest.raises(ValueError, match="ordertk"):
        tk.masked_select(("ordertk", 4, (("ri64", True, 0, "raw"),), ()),
                         cols, mask)
    with pytest.raises(TypeError):
        tk.masked_select(("order", 4, (("rf32", True, 8, "sv"),), ()),
                         dict(cols, **{"rf32.ids": cols["rf32.raw"]}), mask)


@pytest.mark.parametrize("kind,key,asc", _case_ids(),
                         ids=lambda v: "-".join(v) if isinstance(v, tuple)
                         else str(v))
def test_kernel_terms_match_plain_key_words(lanes, kind, key, asc):
    # the CUDA kernel builds as many key words per row as the plain
    # version (its tile and scratch sizes follow from the count)
    cols = {k: torch.from_numpy(v) for k, v in lanes.items()}
    spec = (kind, 16, _order(kind, key, asc), GATHER)
    terms = tk._select_terms(spec, cols)
    assert sum(t[4] for t in terms) == len(tk.select_key_words(spec, cols))


# ---------------------------------------------------------------------------
# Through QueryEngine: the port on the CPU against the JAX engine
# ---------------------------------------------------------------------------

N_PER_SEG = 2_500


@pytest.fixture(scope="module")
def engines(tmp_path_factory):
    dirs, parts = [], []
    for seed in (11, 12):
        d = str(tmp_path_factory.mktemp(f"sel{seed}"))
        _seg, cols = build_segment(d, n=N_PER_SEG, seed=seed)
        dirs.append(d)
        parts.append(cols)
    cols = {k: (parts[0][k] + parts[1][k]) if isinstance(parts[0][k], list)
            else np.concatenate([parts[0][k], parts[1][k]])
            for k in parts[0]}
    return (JaxQueryEngine.from_dirs(dirs),
            QueryEngine.from_dirs(dirs, device="cpu"), RowOracle(cols),
            baseball.Oracle(baseball.from_fixture_columns(cols)))


def _row_oracle_checks(resp, row, draw):
    """tests/test_query_generator.py's selection checks, row at a time."""
    rows = resp.selection_results.results
    cols = list(draw.columns)
    m = draw.mask
    assert len(rows) == min(draw.limit, int(m.sum())), draw.pql
    rowset = {}
    for i in np.nonzero(m)[0]:
        key = tuple(str(row.cols[c][i]) for c in cols)
        rowset[key] = rowset.get(key, 0) + 1
    seen = {}
    for r in rows:
        key = tuple(str(v) for v in r)
        seen[key] = seen.get(key, 0) + 1
        assert key in rowset, (draw.pql, r)
    assert all(n <= rowset[key] for key, n in seen.items()), draw.pql
    if draw.order and rows:
        idx = np.nonzero(m)[0]
        keys = sorted(
            (tuple(float(row.cols[c][i]) for c, _d in draw.order)
             for i in idx),
            key=lambda t: tuple(-v if d else v
                                for v, (_c, d) in zip(t, draw.order)))
        got = [tuple(float(r[cols.index(c)]) for c, _d in draw.order)
               for r in rows]
        assert got == keys[:draw.limit], draw.pql


@pytest.mark.parametrize("family", ["selection", "order_by",
                                    "fixed_selection"])
def test_selection_family_matches_jax_and_oracles(engines, family):
    jax_engine, port, row, vec = engines
    draws = {"selection": baseball.selection_draws,
             "order_by": baseball.order_by_draws,
             "fixed_selection": baseball.fixed_selection_draws}[family](vec)
    n = 0
    for draw in draws:
        port.executor.reset_path_counts()
        resp = port.query(draw.pql)
        assert port.executor.path_counts["host"] == 0, draw.pql
        want = jax_engine.query(draw.pql)
        assert not resp.exceptions and not want.exceptions, draw.pql
        assert resp.selection_results.columns == \
            want.selection_results.columns, draw.pql
        assert resp.selection_results.results == \
            want.selection_results.results, draw.pql
        baseball.check(resp, vec, draw)
        if family != "fixed_selection":
            _row_oracle_checks(resp, row, draw)
        n += 1
    assert n == {"selection": 12, "order_by": 8, "fixed_selection": 4}[family]


MERGE_PQLS = [
    # ORDER BY columns outside the display list ride along in each
    # segment's rows for the merge, and the reducer trims them
    "SELECT playerName FROM baseballStats WHERE runs > 140 ORDER BY "
    "salary DESC, runs LIMIT 10",
    "SELECT teamID, runs FROM baseballStats ORDER BY hits DESC, yearID "
    "LIMIT 25",
    # LIMIT offset, size: k covers offset + size, the reducer cuts
    "SELECT runs, hits FROM baseballStats WHERE league = 'AL' ORDER BY "
    "runs, hits DESC LIMIT 30, 10",
    "SELECT yearID, salary FROM baseballStats WHERE position = 'C' "
    "LIMIT 7, 5",
]


@pytest.mark.parametrize("pql", MERGE_PQLS)
def test_selection_merge_and_trim_match_jax(engines, pql):
    jax_engine, port, _row, _vec = engines
    got, want = port.query(pql), jax_engine.query(pql)
    assert not got.exceptions and not want.exceptions
    assert got.selection_results.columns == want.selection_results.columns
    assert got.selection_results.results == want.selection_results.results
    n_cols = len(pql.split(" FROM ")[0].split(","))
    assert len(got.selection_results.columns) == n_cols
    assert all(len(r) == n_cols for r in got.selection_results.results)
    assert got.selection_results.results


def test_fixed_selections_cover_every_kind(engines):
    _jax, port, _row, _vec = engines
    from pinot_tpu_torch.pql.optimizer import BrokerRequestOptimizer
    from pinot_tpu_torch.pql.parser import compile_pql
    from pinot_tpu_torch.query.plan import InstancePlanMaker
    kinds = {}
    for name, pql in baseball.FIXED_SELECTIONS.items():
        request = BrokerRequestOptimizer().optimize(compile_pql(pql))
        plan = InstancePlanMaker().make_segment_plan(port.segments[0],
                                                     request)
        kinds[name] = plan.select_spec[0], plan.select_spec[1]
    assert kinds == {"ordertk_salary": ("ordertk", 128),
                     "ordermk_team_salary": ("ordermk", 64),
                     "limit_star": ("limit", 32),
                     "order_runs_hits_player": ("order", 2048)}


def test_selection_plan_refusals(engines):
    _jax, port, _row, _vec = engines
    from pinot_tpu_torch.pql.optimizer import BrokerRequestOptimizer
    from pinot_tpu_torch.pql.parser import compile_pql
    from pinot_tpu_torch.query.plan import InstancePlanMaker, \
        UnsupportedOnDevice
    seg = port.segments[0]
    mv_order = "SELECT runs FROM baseballStats ORDER BY position LIMIT 5"
    wide = "SELECT runs, teamID FROM baseballStats WHERE runs > 100 " \
        "LIMIT 70000"
    for pql in (mv_order, wide):
        request = BrokerRequestOptimizer().optimize(compile_pql(pql))
        with pytest.raises(UnsupportedOnDevice):
            InstancePlanMaker().make_segment_plan(seg, request)
    # the host twin answers k > 65,536 as the JAX engine does, and refuses
    # an MV order key as the JAX host twin does
    port.executor.reset_path_counts()
    resp = port.query(wide)
    assert port.executor.path_counts == {"pruned": 0, "fast": 0, "scan": 0,
                                         "host": 2}
    assert resp.selection_results.results == \
        _jax.query(wide).selection_results.results
    with pytest.raises(ValueError, match="MV"):
        port.query(mv_order)
    with pytest.raises(ValueError, match="MV"):
        _jax.query(mv_order)


# ---------------------------------------------------------------------------
# On the card: the CUDA kernel against its plain version
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _cuda_check(lanes, mask, spec, device):
    cols = {k: torch.from_numpy(v).to(device) for k, v in lanes.items()}
    m = torch.from_numpy(mask.astype(np.uint8)).to(device)
    got = tk.masked_select(spec, cols, m)
    want = tk.selection_outputs_plain(spec, cols, m)
    assert set(got) == set(want)
    for name, w in want.items():
        assert got[name].dtype == w.dtype, name
        assert torch.equal(got[name].cpu().reshape(-1).view(torch.uint8),
                           w.cpu().reshape(-1).view(torch.uint8)), \
            (spec[:2], name)


@pytest.mark.cuda
@pytest.mark.parametrize("kind,key,asc", _case_ids(),
                         ids=lambda v: "-".join(v) if isinstance(v, tuple)
                         else str(v))
def test_masked_select_cuda_matches_plain(cuda_device, lanes, kind, key,
                                          asc):
    first = f"{key[0]}.{'ids' if key[0] in CARD_PAD else 'raw'}" if key \
        else "i8.ids"
    for mask in _masks(lanes, first).values():
        for k in (1, 16, 2048, P):
            _cuda_check(lanes, mask, (kind, k, _order(kind, key, asc),
                                      GATHER), cuda_device)


@pytest.mark.cuda
@pytest.mark.parametrize("kind,key", EDGE_CASES,
                         ids=lambda v: "-".join(v) if isinstance(v, tuple)
                         else str(v))
def test_masked_select_cuda_edge_values(cuda_device, kind, key):
    lanes = _edge_lanes()
    for asc in (True, False):
        _cuda_check(lanes, np.arange(P) < NUM_DOCS,
                    (kind, 2048, _order(kind, key, asc), GATHER),
                    cuda_device)


@pytest.mark.cuda
def test_select_scratch_covers_every_pass(cuda_device):
    # the merge passes of an odd list count write more entries than the
    # tile pass: the scratch K6 asks for holds two sets of the largest;
    # a tile's entries fit 64 KB of shared memory
    from pinot_tpu_torch.ops import build
    lib = build.load("masked_select.cu")
    lib.pinot_masked_select_tile_rows.restype = ctypes.c_int
    for n_words in range(tk._MAX_SELECT_WORDS + 1):
        tile = lib.pinot_masked_select_tile_rows(n_words)
        assert tile & (tile - 1) == 0 and 1024 <= tile <= 4096
        assert tile * 4 * (n_words + 1) <= 64 << 10 or tile == 1024
        assert tile == 4096 or (2 * tile) * 4 * (n_words + 1) > 64 << 10
        for padded, k in ((3 * 4096, 4096), (5 * 8192, 65536),
                          (2_506_752, 65536), (8192, 16), (4096, 1)):
            n, length = -(-padded // tile), min(k, tile)
            passes = [n * length]
            while n > 1:
                length, n = min(k, 2 * length), (n + 1) // 2
                passes.append(n * length)
            assert tk.select_scratch_words(padded, k, n_words) == \
                2 * (n_words + 1) * max(passes)


@pytest.mark.cuda
def test_masked_select_cuda_k65536(cuda_device):
    # 9 tiles of 8192 rows padded to 73,728: an odd list count at every
    # merge, k = 65,536 kept through all of them
    rng = np.random.default_rng(4)
    big = 9 * 8192
    lanes = {"a.ids": rng.integers(0, 50, big).astype(np.int8),
             "r.raw": rng.random(big),
             "f.raw": rng.random(big).astype(np.float32)}
    for mask in (np.ones(big, bool), rng.random(big) < 0.5,
                 np.zeros(big, bool)):
        for spec in (("limit", 65536, (), (("a", "sv"),)),
                     ("order", 65536, (("a", False, 51, "sv"),),
                      (("r", "raw"),)),
                     ("ordertk", 65536, (("f", True, 0, "raw"),),
                      (("a", "sv"),)),
                     ("ordermk", 65536, (("a", True, 0, "sv"),
                                         ("r", False, 0, "raw")),
                      (("f", "raw"),))):
            _cuda_check(lanes, mask, spec, cuda_device)
