"""The port's kernels against the JAX package's device functions.

Each kernel's plain PyTorch version (what the wrapper runs for a CPU
tensor) is held to the JAX function on identical operands made from a
seed with numpy: K1 filter_mask against kernels._eval_filter & valid
(dictId kinds over SV and MV lanes, raw kinds over int32 / int64 /
float32 / float64 lanes, the upsert `vdoc` liveness leaf over a bool
lane in JAX and the same lane as uint8 in the port), and K2 masked_part_sums, K3
dense_group_aggregate, K4 masked_histogram and K5 masked_reduce through
run_segment_kernel against the jitted build_segment_kernel with kmax = 0.
Integer outputs and min / max must be equal (min / max in the JAX dtype
too); float64 sums agree to rtol 1e-12 (both sides sum in float64, in
different orders). K1's host-built program is also run through a numpy
interpreter of the CUDA kernel's evaluation loop. Tests marked `cuda`
hold each CUDA kernel to its plain version and skip where there is no
card: K1-K5 as above, K3 over every group key kind (MV, valuein, raw),
K4 and K5 over MV entries and K7's HLL registers. The lanes and cases of
the last three are shared with test_torch_groupby_mv.py and
test_torch_hll.py, which hold the plain versions to JAX.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pinot_tpu.ops import kernels as jk
from pinot_tpu_torch.ops import kernels as tk
from pinot_tpu_torch.segment.loader import int_part_table, min_id_dtype

SHAPES = jk.CONTRACT_SHAPE_BUCKETS          # (8192, 16384)
# column → cardinality; the id dtype follows min_id_dtype (int8/16/32)
CARDS = {"a": 50, "b": 1000, "c": 40000, "g2": 2, "g3": 3, "g7": 7,
         "big": 32768, "h15": 15}
REV_VALUES = np.unique(np.random.default_rng(5).integers(100, 10_000, 600)
                       * 100).astype(np.int64)
# raw lanes draw from small pools, so that equality and IN find rows
_POOL_RNG = np.random.default_rng(9)
RAW_POOLS = {
    "ri32": np.unique(_POOL_RNG.integers(-5000, 5000, 64)).astype(np.int32),
    "ri64": np.unique(_POOL_RNG.integers(-2**40, 2**40, 64)).astype(
        np.int64),
    "rf32": np.unique((_POOL_RNG.random(64) * 1e6).astype(np.float32)
                      .round(2)),
    "rf64": np.unique((_POOL_RNG.random(64) * 1e5).round(3)),
}
MV_CARDS = {"m1": (5, 1), "m3": (10, 3)}      # column → (card, W)


def _lanes(P: int, num_docs: int, seed: int):
    """Host lanes in the segment layout: narrow ids, padding id == card,
    int8 part lanes [n_parts, P] for two integer metrics, one f64 raw."""
    rng = np.random.default_rng(seed)
    cols = {}
    for c, card in CARDS.items():
        ids = np.full(P, card, dtype=min_id_dtype(card))
        ids[:num_docs] = rng.integers(0, card, num_docs)
        cols[f"{c}.ids"] = ids
    for r in ("r1", "r2"):
        card = len(REV_VALUES)
        ids = np.full(P, card, dtype=min_id_dtype(card))
        ids[:num_docs] = rng.integers(0, card, num_docs)
        n_parts = -(-int(REV_VALUES[-1] - REV_VALUES[0]).bit_length() // 7)
        table = int_part_table(REV_VALUES, n_parts, int(REV_VALUES[0]))
        cols[f"{r}.parts"] = np.ascontiguousarray(table[:, ids])
    raw = np.zeros(P)
    raw[:num_docs] = (rng.random(num_docs) * 1e5).round(2)
    cols["x.raw"] = raw
    for c, pool in RAW_POOLS.items():
        lane = np.zeros(P, dtype=pool.dtype)
        lane[:num_docs] = rng.choice(pool, num_docs)
        cols[f"{c}.raw"] = lane
    for c, (card, w) in MV_CARDS.items():
        # 1..W entries per row, padding entries and padding rows == card
        mv = np.full((P, w), card, dtype=min_id_dtype(card))
        mv[:num_docs] = rng.integers(0, card, (num_docs, w))
        width = rng.integers(1, w + 1, num_docs)
        mv[:num_docs][np.arange(w)[None, :] >= width[:, None]] = card
        cols[f"{c}.mv"] = mv
    # upsert liveness (bool, as the JAX lane; uint8 in the port): 20% of
    # the rows superseded, padding rows not live
    live = np.random.default_rng(seed + 1).random(P) < 0.8
    live[num_docs:] = False
    cols[f"{VDOC[2]}.vdoc"] = live
    return cols


def _member(card: int, seed: int) -> np.ndarray:
    m = np.zeros(jk.pow2_bucket(card + 1), dtype=bool)
    m[:card] = np.random.default_rng(seed).random(card) < 0.3
    return m


#: the planner's validDocIds leaf (pinot_tpu/query/plan.py VALID_DOC_PRED)
VDOC = ("pred", "vdoc", "$validDocIds", "vdoc", None)


def _pred(kind, col, extra=None):
    return ("pred", kind, col, "sv", extra)


def _in_list(ids, k):
    arr = np.full(k, -1, np.int32)
    arr[: len(ids)] = ids
    return arr


def _raw(kind, col, extra=None):
    return ("pred", kind, col, "raw", extra)


def _mv(kind, col, extra=None):
    return ("pred", kind, col, "mv", extra)


def _near(col, i, step=0):
    """Pool value i of a raw column, moved `step` representable values
    up (+) or down (-) in the column's dtype."""
    v = RAW_POOLS[col][i]
    for _ in range(abs(step)):
        v = np.nextafter(v, v.dtype.type(np.inf if step > 0 else -np.inf))
    return v


def _raw_list(col, idx, k):
    pool = RAW_POOLS[col]
    arr = np.full(k, pool[idx[0]], dtype=pool.dtype)
    arr[: len(idx)] = pool[list(idx)]
    return arr


# name → (filter spec, params)
FILTERS = {
    "eq_int8": (_pred("eq_id", "a"), [np.int32(7)]),
    "neq_int16": (_pred("neq_id", "b"), [np.int32(500)]),
    "range_int32": (_pred("range_ids", "c"), [np.int32(100),
                                              np.int32(30000)]),
    "in_int8": (_pred("in_ids", "a", 4), [_in_list([1, 9, 49], 4)]),
    "notin_int16": (_pred("notin_ids", "b", 2), [_in_list([3, 999], 2)]),
    "member_int16": (_pred("member", "b", 1024), [_member(1000, 1)]),
    "member_int32": (_pred("member", "c", 65536), [_member(40000, 2)]),
    "nested": (("and", (("or", (_pred("eq_id", "a"),
                                _pred("member", "b", 1024))),
                        _pred("notin_ids", "c", 1),
                        _pred("range_ids", "a"))),
               [np.int32(3), _member(1000, 3), _in_list([5], 1),
                np.int32(0), np.int32(40)]),
    "empty_match": (_pred("eq_id", "a"), [np.int32(50)]),   # id == card
    "full_match": (_pred("range_ids", "a"), [np.int32(0), np.int32(50)]),
    "match_all": (("match_all",), []),
    "empty": (("empty",), []),
    # raw kinds: constants in the lane's dtype, at and beside pool values
    "eq_raw_i32": (_raw("eq_raw", "ri32"), [RAW_POOLS["ri32"][5]]),
    "neq_raw_i64": (_raw("neq_raw", "ri64"), [RAW_POOLS["ri64"][7]]),
    "eq_raw_f32_next": (_raw("eq_raw", "rf32"), [_near("rf32", 3, 1)]),
    "eq_raw_f64": (_raw("eq_raw", "rf64"), [RAW_POOLS["rf64"][11]]),
    "range_raw_f32_incl": (_raw("range_raw", "rf32", (True, True)),
                           [_near("rf32", 10), _near("rf32", 40)]),
    "range_raw_f32_excl": (_raw("range_raw", "rf32", (False, False)),
                           [_near("rf32", 10), _near("rf32", 40)]),
    "range_raw_f32_beside": (_raw("range_raw", "rf32", (True, False)),
                             [_near("rf32", 10, 1), _near("rf32", 40, -1)]),
    "range_raw_f64": (_raw("range_raw", "rf64", (False, True)),
                      [_near("rf64", 3), _near("rf64", 50)]),
    "range_raw_i32": (_raw("range_raw", "ri32", (True, False)),
                      [_near("ri32", 0), _near("ri32", 20)]),
    "range_raw_i64": (_raw("range_raw", "ri64", (False, True)),
                      [_near("ri64", 30), _near("ri64", 63)]),
    "in_raw_f32_k1": (_raw("in_raw", "rf32", 1), [_raw_list("rf32", [8],
                                                             1)]),
    "in_raw_i32_k4": (_raw("in_raw", "ri32", 4),
                      [_raw_list("ri32", [1, 2, 40], 4)]),
    "notin_raw_f64_k4": (_raw("notin_raw", "rf64", 4),
                         [_raw_list("rf64", [0, 5, 9, 33], 4)]),
    "notin_raw_i64_k1": (_raw("notin_raw", "ri64", 1),
                         [_raw_list("ri64", [12], 1)]),
    # MV kinds: any entry, padding entries (id == card) included
    "eq_mv_w3": (_mv("eq_id", "m3"), [np.int32(4)]),
    "neq_mv_w3": (_mv("neq_id", "m3"), [np.int32(4)]),
    "range_mv_w3": (_mv("range_ids", "m3"), [np.int32(2), np.int32(5)]),
    "in_mv_w1": (_mv("in_ids", "m1", 4), [_in_list([0, 3], 4)]),
    "notin_mv_w3": (_mv("notin_ids", "m3", 1), [_in_list([7], 1)]),
    "member_mv_w3": (_mv("member", "m3", 16), [_member(10, 4)]),
    "mixed_nested": (("or", (("and", (_pred("eq_id", "a"),
                                       _mv("eq_id", "m3"))),
                              ("and", (_raw("range_raw", "rf32",
                                            (True, False)),
                                       _mv("notin_ids", "m1", 2))),
                              _raw("in_raw", "ri64", 2))),
                     [np.int32(3), np.int32(1), _near("rf32", 20),
                      _near("rf32", 30), _in_list([2, 4], 2),
                      _raw_list("ri64", [6, 7], 2)]),
    # the upsert validDocIds leaf: alone, ANDed first into a dictId
    # filter (the planner's with_valid_doc_mask) and into a mixed one
    "vdoc": (VDOC, []),
    "vdoc_and_eq": (("and", (VDOC, _pred("eq_id", "a"))), [np.int32(7)]),
    "vdoc_mixed": (("and", (VDOC, ("or", (_raw("range_raw", "rf32",
                                                (True, False)),
                                           _mv("eq_id", "m3"))))),
                   [_near("rf32", 10), _near("rf32", 40), np.int32(4)]),
}
NUM_DOCS = {"full": lambda P: P, "padded": lambda P: P - 777}


def _jax_cols(cols):
    return {k: jnp.asarray(v) for k, v in cols.items()}


def _torch_cols(cols, device="cpu"):
    """The port's lanes; the bool liveness lane as uint8."""
    return {k: torch.from_numpy(np.ascontiguousarray(
        v.astype(np.uint8) if k.endswith(".vdoc") else v)).to(device)
        for k, v in cols.items()}


def _jax_filter(P, spec, cols, params, num_docs):
    fn = jax.jit(lambda c, p, n: jk._eval_filter(
        spec, c, list(p), jnp.arange(P) < n) & (jnp.arange(P) < n))
    return np.asarray(fn(_jax_cols(cols), tuple(jnp.asarray(x)
                                                for x in params),
                         jnp.int32(num_docs)))


def _interpret_program(P, spec, cols, params, num_docs) -> np.ndarray:
    """numpy mirror of filter_mask.cu's per-row loop over the program."""
    tcols = _torch_cols(cols)
    buf, n_nodes = tk.compile_filter(spec, params, tcols)
    lane_keys = tk.filter_lane_keys(spec)
    w = tk._NODE_WORDS
    nodes = buf[: w * n_nodes].reshape(n_nodes, w)
    prm = buf[w * n_nodes:]
    elem_np = {code: tk._np_of(dt) for dt, code in tk._ELEM.items()}
    ops = tk._LEAF_OPS
    stack = np.zeros(P, dtype=np.uint64)
    for op, lane, off, arg, elem, width in nodes.tolist():
        if op in (tk._OP_AND, tk._OP_OR):
            m = np.uint64((1 << arg) - 1)
            kids = stack & m
            stack >>= np.uint64(arg)
            bit = (kids == m) if op == tk._OP_AND else (kids != 0)
        elif op == tk._OP_TRUE:
            bit = np.ones(P, bool)
        elif op == tk._OP_FALSE:
            bit = np.zeros(P, bool)
        elif op == ops["vdoc"]:
            bit = cols[lane_keys[lane]] != 0
        elif op >= ops["eq_raw"]:
            dt = elem_np[elem]
            v = cols[lane_keys[lane]]
            assert v.dtype == dt and width == 1
            nw = dt.itemsize // 4

            def const(i, off=off, nw=nw, dt=dt):
                return np.ascontiguousarray(
                    prm[off + i * nw: off + (i + 1) * nw]).view(dt)[0]

            if op == ops["eq_raw"]:
                bit = v == const(0)
            elif op == ops["neq_raw"]:
                bit = v != const(0)
            elif op == ops["range_raw"]:
                lo, hi = const(0), const(1)
                bit = ((v >= lo) if arg & 1 else (v > lo)) & \
                    ((v <= hi) if arg & 2 else (v < hi))
            else:
                bit = np.isin(v, [const(i) for i in range(arg)])
                if op == ops["notin_raw"]:
                    bit = ~bit
        else:
            v = cols[lane_keys[lane]].astype(np.int64).reshape(P, width)
            if op == ops["eq_id"]:
                bit = v == prm[off]
            elif op == ops["neq_id"]:
                bit = v != prm[off]
            elif op == ops["range_ids"]:
                bit = (v >= prm[off]) & (v < prm[off + 1])
            elif op in (ops["in_ids"], ops["notin_ids"]):
                bit = np.isin(v, prm[off:off + arg])
                if op == ops["notin_ids"]:
                    bit = ~bit
            else:
                idx = np.clip(v, 0, arg - 1)
                words = prm[off + (idx >> 5)].astype(np.uint32)
                bit = ((words >> (idx & 31).astype(np.uint32)) & 1) == 1
            bit = bit.any(axis=1)
        stack = (stack << np.uint64(1)) | bit.astype(np.uint64)
    out = (stack & np.uint64(1)).astype(np.uint8)
    out[num_docs:] = 0
    return out


@pytest.mark.parametrize("P", SHAPES)
@pytest.mark.parametrize("docs", sorted(NUM_DOCS))
@pytest.mark.parametrize("name", sorted(FILTERS))
def test_filter_mask_plain_matches_jax(P, docs, name):
    spec, params = FILTERS[name]
    num_docs = NUM_DOCS[docs](P)
    cols = _lanes(P, num_docs, seed=P + len(name))
    want = _jax_filter(P, spec, cols, params, num_docs)
    got = tk.filter_mask(P, spec, _torch_cols(cols), params, num_docs, "cpu")
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy().astype(bool), want)
    if name == "empty_match":
        assert not want.any()
    if name == "full_match":
        assert want.sum() == num_docs
    # the host-built K1 program evaluates to the same mask
    np.testing.assert_array_equal(
        _interpret_program(P, spec, cols, params, num_docs).astype(bool),
        want)


def test_compile_filter_limits():
    cols = _torch_cols(_lanes(8192, 8192, seed=0))
    deep = ("and", tuple(_pred("eq_id", "a") for _ in range(32)))
    with pytest.raises(ValueError):
        tk.compile_filter(deep, [np.int32(1)] * 32, cols)
    with pytest.raises(ValueError):
        tk.compile_filter(("pred", "eq_raw", "a", "sv", None), [1], cols)
    # the vdoc leaf compiles to one parameter-free node over its lane;
    # a kind K1 does not know still raises
    buf, n_nodes = tk.compile_filter(VDOC, [], cols)
    assert n_nodes == 1 and buf.shape == (tk._NODE_WORDS,)
    assert buf[0] == tk._LEAF_OPS["vdoc"]
    assert tk.filter_param_count(VDOC) == 0
    with pytest.raises(ValueError):
        tk.compile_filter(("pred", "vdoc_id", "x", "sv", None), [1], cols)


AGG_SPECS = (("count", "*", "none", None),
             ("sum", "r1", "sv", ("parts", 1024)),
             ("avg", "r2", "sv", ("parts", 1024)))


def _jax_outs(P, filt, params, aggs, group, cols, num_docs):
    fn = jax.jit(jk.build_segment_kernel(P, filt, aggs, group, None))
    outs = fn(_jax_cols(cols), tuple(jnp.asarray(x) for x in params),
              jnp.int32(num_docs))
    return {k: np.asarray(v) for k, v in outs.items()}


@pytest.mark.parametrize("P", SHAPES)
@pytest.mark.parametrize("name", ["nested", "empty_match", "full_match"])
def test_masked_part_sums_plain_matches_jax(P, name):
    spec, params = FILTERS[name]
    num_docs = P - 777
    cols = _lanes(P, num_docs, seed=11 + P)
    want = _jax_outs(P, spec, params, AGG_SPECS, None, cols, num_docs)
    got = tk.run_segment_kernel(P, spec, AGG_SPECS, None, None,
                                _torch_cols(cols), params, num_docs, "cpu")
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)


# g_pad → key columns (cardinality product buckets to exactly g_pad);
# 65536 is above DENSE_G_LIMIT: JAX takes its scatter branch there
GROUPS = {8: ("g2", "g3"), 8192: ("g7", "b"), 65536: ("g2", "big")}
GROUP_AGGS = {
    "count": (("count", "*", "none", None),),
    "sums": (("count", "*", "none", None),
             ("sum", "r1", "sv", ("psums", 1024)),
             ("avg", "x", "raw", ("csums",)),
             ("sum", "r2", "sv", ("psums", 1024))),
    # per-group min / max over ids (int32, card_pad / -1 sentinels) and
    # raw lanes of every dtype (float64, ±inf sentinels)
    "extremes": (("count", "*", "none", None),
                 ("min", "a", "sv", ("ids", 64)),
                 ("max", "b", "sv", ("ids", 1024)),
                 ("minmaxrange", "c", "sv", ("ids", 65536)),
                 ("minmaxrange", "rf32", "raw", None),
                 ("min", "ri64", "raw", None),
                 ("max", "ri32", "raw", None),
                 ("minmaxrange", "rf64", "raw", None)),
}


def _group_spec(g_pad, aggs):
    from pinot_tpu.query.plan import mixed_radix_strides
    keys = GROUPS[g_pad]
    cards = [CARDS[c] for c in keys]
    assert jk.pow2_bucket(int(np.prod(cards))) == g_pad
    gcols = tuple((c, "ids", 0, CARDS[c]) for c in keys)
    return (gcols, mixed_radix_strides(cards), g_pad, aggs, 0)


@pytest.mark.parametrize("P", SHAPES)
@pytest.mark.parametrize("g_pad", sorted(GROUPS))
@pytest.mark.parametrize("aggs", sorted(GROUP_AGGS))
def test_dense_group_aggregate_plain_matches_jax(P, g_pad, aggs):
    spec, params = FILTERS["full_match"] if aggs == "count" else \
        FILTERS["nested"]
    num_docs = P - 777
    cols = _lanes(P, num_docs, seed=g_pad + P)
    group = _group_spec(g_pad, GROUP_AGGS[aggs])
    want = _jax_outs(P, spec, params, (), group, cols, num_docs)
    got = tk.run_segment_kernel(P, spec, (), group, None,
                                _torch_cols(cols), params, num_docs, "cpu")
    assert set(got) == set(want)
    for k in want:
        if k.endswith(".csums"):
            np.testing.assert_allclose(got[k].numpy(), want[k], rtol=1e-12,
                                       atol=0, err_msg=k)
        else:
            np.testing.assert_array_equal(got[k].numpy(), want[k],
                                          err_msg=k)
    assert int(got["group.count"].sum()) == int(want["stats.num_docs_matched"])


# no-group aggregations of K4 (histograms) and K5 (min / max and block
# sums): id lanes int8 (a, h15), int16 (b), int32 (c); raw lanes of every
# dtype; the float64 value lane x takes the vlane strategy
REDUCE_AGGS = (("count", "*", "none", None),
               ("distinctcount", "h15", "sv", ("hist", 16)),
               ("percentile", "b", "sv", ("hist", 1024)),
               ("sum", "c", "sv", ("hist", 65536)),
               ("min", "a", "sv", ("ids", 64)),
               ("minmaxrange", "b", "sv", ("ids", 1024)),
               ("max", "c", "sv", ("ids", 65536)),
               ("sum", "rf32", "raw", None),
               ("minmaxrange", "rf32", "raw", None),
               ("avg", "rf64", "raw", None),
               ("min", "rf64", "raw", None),
               ("max", "ri32", "raw", None),
               ("minmaxrange", "ri64", "raw", None),
               ("avg", "ri64", "raw", None),
               ("sum", "x", "sv", ("vlane", 1024)))


@pytest.mark.parametrize("P", SHAPES)
@pytest.mark.parametrize("name", ["nested", "empty_match", "full_match",
                                  "mixed_nested"])
def test_histogram_and_reduce_plain_match_jax(P, name):
    spec, params = FILTERS[name]
    num_docs = P - 777
    cols = _lanes(P, num_docs, seed=23 + P)
    cols["x.vlane"] = cols["x.raw"]
    want = _jax_outs(P, spec, params, REDUCE_AGGS, None, cols, num_docs)
    got = tk.run_segment_kernel(P, spec, REDUCE_AGGS, None, None,
                                _torch_cols(cols), params, num_docs, "cpu")
    assert set(got) == set(want)
    for k in want:
        g = got[k].numpy()
        if k.endswith(".vsum"):
            np.testing.assert_allclose(g, want[k], rtol=1e-12, atol=0,
                                       err_msg=k)
        else:
            # min / max also in the JAX dtype; JAX sums a small histogram
            # up to int64 under x64, the port keeps int32 counts
            if k.endswith((".min", ".max")):
                assert g.dtype == want[k].dtype, k
            np.testing.assert_array_equal(g, want[k], err_msg=k)
    if name == "empty_match":
        assert int(got["agg4.min"]) == 64 and int(got["agg6.max"]) == -1
        assert float(got["agg8.min"]) == np.inf


def test_wrappers_reject_bad_operands():
    P = 8192
    cols = _torch_cols(_lanes(P, P, seed=0))
    with pytest.raises(ValueError):
        tk.filter_mask(P, ("match_all",), cols, [], P)
    mask = tk.filter_mask(P, ("match_all",), cols, [], P, "cpu")
    with pytest.raises(TypeError):
        tk.masked_part_sums(mask.bool(), [cols["r1.parts"]])
    with pytest.raises(ValueError):
        tk.dense_group_aggregate(mask, [cols["a.ids"][:100]], [1], 64)
    # a compacted spec's idoff key without its runtime offset
    with pytest.raises(ValueError):
        tk.run_segment_kernel(P, ("match_all",), (), (
            (("a", "idoff", 0, 50),), (1,), 64, (), 16), None, cols, (), P,
            "cpu")


# ---------------------------------------------------------------------------
# On the card: each CUDA kernel against its plain version
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(FILTERS))
def test_filter_mask_cuda_matches_plain(cuda_device, name):
    P = SHAPES[-1]
    spec, params = FILTERS[name]
    cols = _torch_cols(_lanes(P, P - 777, seed=3), cuda_device)
    got = tk.filter_mask(P, spec, cols, params, P - 777, cuda_device)
    want = tk.filter_mask_plain(P, spec, cols, params, P - 777, cuda_device)
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("g_pad", sorted(GROUPS))
def test_sums_cuda_match_plain(cuda_device, g_pad):
    P = SHAPES[-1]
    spec, params = FILTERS["nested"]
    cols = _torch_cols(_lanes(P, P - 777, seed=4), cuda_device)
    mask = tk.filter_mask(P, spec, cols, params, P - 777, cuda_device)
    parts = [cols["r1.parts"], cols["r2.parts"]]
    assert torch.equal(tk.masked_part_sums(mask, parts),
                       tk.masked_part_sums_plain(mask, parts))
    gcols, strides, _, _, _ = _group_spec(g_pad, ())
    keys = [cols[f"{c}.ids"] for c, *_ in gcols]
    ext = (("ids", cols["a.ids"], "min", 64), ("ids", cols["c.ids"], "max",
                                                 65536),
           ("raw", cols["rf32.raw"], "min", 0),
           ("raw", cols["ri64.raw"], "max", 0))
    want = tk.dense_group_aggregate_plain(mask, keys, strides, g_pad, parts,
                                          [cols["x.raw"]], ext)
    # shared-memory tables never, as the wrapper chooses, and wherever
    # they fit
    for smem_slots in (0, tk.K3_SMEM_SLOTS, tk.INT32_MAX):
        got = tk.dense_group_aggregate(mask, keys, strides, g_pad, parts,
                                       [cols["x.raw"]], ext,
                                       smem_slots=smem_slots)
        for a, b in ((got[0], want[0]), (got[1], want[1]),
                     (got[3], want[3]), *zip(got[4], want[4])):
            assert torch.equal(a, b), smem_slots
        torch.testing.assert_close(got[2], want[2], rtol=1e-12, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["nested", "empty_match", "full_match"])
def test_histogram_and_reduce_cuda_match_plain(cuda_device, name):
    P = SHAPES[-1]
    spec, params = FILTERS[name]
    cols = _torch_cols(_lanes(P, P - 777, seed=5), cuda_device)
    mask = tk.filter_mask(P, spec, cols, params, P - 777, cuda_device)
    # shared-memory tables up to 16384 bins (64 KB, opted in above 48
    # KB), device-memory atomics above; ids >= card_pad count nowhere
    for col, card_pad in (("h15", 16), ("b", 1024), ("c", 16384),
                          ("c", 65536)):
        assert torch.equal(
            tk.masked_histogram(mask, cols[f"{col}.ids"], card_pad),
            tk.masked_histogram_plain(mask, cols[f"{col}.ids"], card_pad))
    for kind, key, card_pad in (("ids", "a.ids", 64), ("ids", "b.ids", 1024),
                                ("raw", "rf32.raw", 0),
                                ("raw", "rf64.raw", 0),
                                ("raw", "ri32.raw", 0),
                                ("raw", "ri64.raw", 0)):
        got = tk.masked_reduce(mask, cols[key], kind, card_pad, True)
        want = tk.masked_reduce_plain(mask, cols[key], kind, card_pad, True)
        for k in ("min", "max", "count"):
            assert got[k].dtype == want[k].dtype
            assert torch.equal(got[k], want[k]), (key, k)
        torch.testing.assert_close(got["sums"], want["sums"], rtol=1e-12,
                                   atol=0)


# ---------------------------------------------------------------------------
# Group key kinds (K3), MV entry histograms (K4) and min / max (K5), HLL
# registers (K7): the lanes and cases test_torch_groupby_mv.py and
# test_torch_hll.py hold against JAX, and the card tests below against the
# plain versions
# ---------------------------------------------------------------------------

#: raw key lanes: int32 values in [-70, 80), int64 in [10^12, 10^12 + 300)
RAW_KEYS = {"rk32": (np.int32, -70, 150), "rk64": (np.int64, 10**12, 300)}


def _key_lanes(P: int, num_docs: int, seed: int):
    """_lanes plus the raw key lanes and an int16 MV lane (card 1000,
    W = 4)."""
    cols = _lanes(P, num_docs, seed)
    rng = np.random.default_rng(seed + 1)
    for c, (dt, lo, span) in RAW_KEYS.items():
        lane = np.zeros(P, dt)
        lane[:num_docs] = lo + rng.integers(0, span, num_docs)
        cols[f"{c}.raw"] = lane
    mv = np.full((P, 4), 1000, np.int16)
    mv[:num_docs] = rng.integers(0, 1000, (num_docs, 4))
    width = rng.integers(0, 5, num_docs)          # rows with no entry too
    mv[:num_docs][np.arange(4)[None, :] >= width[:, None]] = 1000
    cols["m16.mv"] = mv
    return cols


#: group key columns of each K3 case: MV alone, MV x SV, valuein x SV, the
#: same MV column as two keys (a full cross product), two MV columns, raw
#: keys of both widths, and a raw x MV mix
KEY_CASES = {
    "mv": (("m3", "mvids", 0, 10),),
    "mv_sv": (("m3", "mvids", 0, 10), ("g7", "ids", 0, 7)),
    "mvin_sv": (("m3", "mvin", 0, 10), ("a", "ids", 0, 50)),
    "mv_twice": (("m3", "mvids", 0, 10), ("m3", "mvin", 0, 10)),
    "two_mv": (("m1", "mvids", 0, 5), ("m16", "mvids", 0, 1000)),
    "rawoff32": (("rk32", "rawoff", -70, 150),),
    "rawoff64_sv": (("rk64", "rawoff", 10**12, 300), ("g3", "ids", 0, 3)),
    "rawoff_mv": (("rk32", "rawoff", -70, 150), ("m1", "mvids", 0, 5)),
}
KEY_AGGS = (("count", "*", "none", None),
            ("sum", "r1", "sv", ("psums", 1024)),
            ("avg", "x", "raw", ("csums",)),
            ("min", "a", "sv", ("ids", 64)),
            ("max", "rf64", "raw", None),
            ("minmaxrange", "ri64", "raw", None))


def key_case(name: str, seed: int = 0):
    """(group spec, the member tables its mvin keys take, in key order)."""
    from pinot_tpu.query.plan import mixed_radix_strides
    gcols = KEY_CASES[name]
    cards = [g[3] for g in gcols]
    members = [_member(g[3], seed + i) for i, g in enumerate(gcols)
               if g[1] == "mvin"]
    return (gcols, mixed_radix_strides(cards),
            jk.pow2_bucket(int(np.prod(cards))), KEY_AGGS, 0), members


#: MV aggregations: the entry histogram (countmv, distinctcount, sum,
#: percentile) and the entry min / max, over int8 (m1, m3) and int16 (m16)
#: MV lanes
MV_AGGS = (("count", "*", "none", None),
           ("countmv", "m3", "mv", (16, 10)),
           ("distinctcount", "m3", "mv", (16, 10)),
           ("sum", "m1", "mv", (8, 5)),
           ("percentile", "m16", "mv", (1024, 1000)),
           ("countmv", "m16", "mv", (1024, 1000)),
           ("min", "m3", "mv", (16, 10)),
           ("max", "m1", "mv", (8, 5)),
           ("minmaxrange", "m16", "mv", (1024, 1000)))


def hll_lanes(cols, col: str, values):
    """cols plus {col}.hllidx / {col}.hllrank for a dictionary of
    `values` (the loader's tables)."""
    from pinot_tpu_torch.segment.loader import hll_tables_padded
    idx, rank = hll_tables_padded(np.asarray(values))
    return {**cols, f"{col}.hllidx": idx, f"{col}.hllrank": rank}


def _group_keys(spec, cols, members, device):
    params = list(members)
    return [tk.spec_group_key(g, cols, params, device) for g in spec[0]]


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(KEY_CASES))
def test_group_key_kinds_cuda_match_plain(cuda_device, case):
    P = SHAPES[-1]
    spec, params = FILTERS["nested"]
    cols = _torch_cols(_key_lanes(P, P - 777, seed=6), cuda_device)
    mask = tk.filter_mask(P, spec, cols, params, P - 777, cuda_device)
    group, members = key_case(case, seed=7)
    keys = _group_keys(group, cols, members, cuda_device)
    parts = [cols["r1.parts"]]
    ext = (("ids", cols["a.ids"], "min", 64),
           ("raw", cols["rf64.raw"], "max", 0))
    want = tk.dense_group_aggregate_plain(mask, keys, group[1], group[2],
                                          parts, [cols["x.raw"]], ext)
    for smem_slots in (0, tk.INT32_MAX):
        got = tk.dense_group_aggregate(mask, keys, group[1], group[2],
                                       parts, [cols["x.raw"]], ext,
                                       smem_slots=smem_slots)
        for a, b in ((got[0], want[0]), (got[1], want[1]),
                     (got[3], want[3]), *zip(got[4], want[4])):
            assert torch.equal(a, b), (case, smem_slots)
        torch.testing.assert_close(got[2], want[2], rtol=1e-12, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["mv_sv", "mvin_sv", "rawoff32"])
def test_k3_row_slices_cuda_match_plain(cuda_device, monkeypatch, case):
    """K3 launched on row slices (a small DENSE_ROWS_LIMIT forces several)
    equals its plain version in one pass: counts and part sums (int64
    then), min / max tables exactly, float sums within rtol 1e-12."""
    P = SHAPES[-1]
    spec, params = FILTERS["nested"]
    cols = _torch_cols(_key_lanes(P, P - 777, seed=9), cuda_device)
    mask = tk.filter_mask(P, spec, cols, params, P - 777, cuda_device)
    group, members = key_case(case, seed=4)
    keys = _group_keys(group, cols, members, cuda_device)
    parts = [cols["r1.parts"]]
    ext = (("ids", cols["a.ids"], "min", 64),
           ("raw", cols["rf64.raw"], "max", 0))
    want = tk.dense_group_aggregate_plain(mask, keys, group[1], group[2],
                                          parts, [cols["x.raw"]], ext)
    monkeypatch.setattr(tk, "DENSE_ROWS_LIMIT", 1 << 12)
    assert P // tk.k3_rows_per_launch(tk.group_combos(keys)) >= 4
    before = tk.launch_counts()["dense_group_aggregate"]
    got = tk.dense_group_aggregate(mask, keys, group[1], group[2], parts,
                                   [cols["x.raw"]], ext)
    assert tk.launch_counts()["dense_group_aggregate"] - before >= 4
    for a, b in ((got[0], want[0]), (got[1], want[1]), (got[3], want[3])):
        assert torch.equal(a.to(torch.int64), b.to(torch.int64)), case
    for a, b in zip(got[4], want[4]):
        assert torch.equal(a, b), case
    torch.testing.assert_close(got[2], want[2], rtol=1e-12, atol=0)


@pytest.mark.cuda
def test_k3_past_the_psums_bound_cuda(cuda_device):
    """Past 127 * P * W_total >= 2^31 on the card: K3 runs on row slices
    and its int64 counts and part sums equal numpy's."""
    P = SHAPES[0]
    lanes = _key_lanes(P, P, seed=1)
    cols = _torch_cols(lanes, cuda_device)
    mask = tk.filter_mask(P, ("match_all",), cols, [], P, cuda_device)
    w_big = 2**31 // (127 * P) + 1      # each doc's first entry, repeated
    wide = tk.GroupKey("mvids", cols["m16.mv"][:, :1].repeat(1, w_big)
                       .contiguous(), card=1000)
    before = tk.launch_counts()["dense_group_aggregate"]
    count, psums, _cs, matched, _t = tk.dense_group_aggregate(
        mask, [wide], [1], 1024, [cols["r1.parts"]])
    assert tk.launch_counts()["dense_group_aggregate"] - before == \
        -(-P // tk.k3_rows_per_launch(w_big))
    ids = lanes["m16.mv"][:, 0].astype(np.int64)
    ok = ids < 1000
    parts = lanes["r1.parts"].astype(np.int64)
    np.testing.assert_array_equal(
        count.cpu().numpy(), np.bincount(ids[ok], minlength=1024) * w_big)
    np.testing.assert_array_equal(psums.cpu().numpy(), np.stack([
        np.bincount(ids[ok], weights=p[ok], minlength=1024).astype(np.int64)
        for p in parts]) * w_big)
    assert int(matched) == P


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["nested", "empty_match", "full_match"])
def test_mv_histogram_reduce_and_hll_cuda_match_plain(cuda_device, name):
    P = SHAPES[-1]
    spec, params = FILTERS[name]
    cols = _key_lanes(P, P - 777, seed=8)
    cols = hll_lanes(cols, "b", [f"v{i:04d}" for i in range(1000)])
    cols = _torch_cols(cols, cuda_device)
    mask = tk.filter_mask(P, spec, cols, params, P - 777, cuda_device)
    for col, card_pad, card in (("m1", 8, 5), ("m3", 16, 10),
                                ("m16", 1024, 1000)):
        lane = cols[f"{col}.mv"]
        got = tk.masked_entry_histogram(mask, lane, card_pad, card)
        want = tk.masked_entry_histogram_plain(mask, lane, card_pad, card)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        got = tk.masked_reduce(mask, lane, "ids", card_pad, card=card)
        want = tk.masked_reduce_plain(mask, lane, "ids", card_pad,
                                      card=card)
        for k in ("min", "max", "count"):
            assert got[k].dtype == want[k].dtype
            assert torch.equal(got[k], want[k]), (col, k)
    hist = tk.masked_histogram(mask, cols["b.ids"], 1024)
    got = tk.hll_registers(hist, cols["b.hllidx"], cols["b.hllrank"], 4096)
    want = tk.hll_registers_plain(hist, cols["b.hllidx"], cols["b.hllrank"],
                                  4096)
    assert torch.equal(got, want)
