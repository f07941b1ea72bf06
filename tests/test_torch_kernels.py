"""The port's kernels against the JAX package's device functions.

Each kernel's plain PyTorch version (what the wrapper runs for a CPU
tensor) is held to the JAX function on identical operands made from a
seed with numpy: K1 filter_mask against kernels._eval_filter & valid,
K2 masked_part_sums and K3 dense_group_aggregate against the jitted
build_segment_kernel with kmax = 0. Integer outputs must be equal; float64
group sums agree to rtol 1e-12 (both sides sum in float64, in different
orders). K1's host-built program is also run through a numpy interpreter
of the CUDA kernel's evaluation loop. Tests marked `cuda` hold each CUDA
kernel to its plain version and skip where there is no card.
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
         "big": 32768}
REV_VALUES = np.unique(np.random.default_rng(5).integers(100, 10_000, 600)
                       * 100).astype(np.int64)


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
    return cols


def _member(card: int, seed: int) -> np.ndarray:
    m = np.zeros(jk.pow2_bucket(card + 1), dtype=bool)
    m[:card] = np.random.default_rng(seed).random(card) < 0.3
    return m


def _pred(kind, col, extra=None):
    return ("pred", kind, col, "sv", extra)


def _in_list(ids, k):
    arr = np.full(k, -1, np.int32)
    arr[: len(ids)] = ids
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
}
NUM_DOCS = {"full": lambda P: P, "padded": lambda P: P - 777}


def _jax_cols(cols):
    return {k: jnp.asarray(v) for k, v in cols.items()}


def _torch_cols(cols, device="cpu"):
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in cols.items()}


def _jax_filter(P, spec, cols, params, num_docs):
    fn = jax.jit(lambda c, p, n: jk._eval_filter(
        spec, c, list(p), jnp.arange(P) < n) & (jnp.arange(P) < n))
    return np.asarray(fn(_jax_cols(cols), tuple(jnp.asarray(x)
                                                for x in params),
                         jnp.int32(num_docs)))


def _interpret_program(P, spec, cols, params, num_docs) -> np.ndarray:
    """numpy mirror of filter_mask.cu's per-row loop over the program."""
    buf, n_nodes = tk.compile_filter(spec, params)
    lane_keys = tk.filter_lane_keys(spec)
    nodes = buf[: 4 * n_nodes].reshape(n_nodes, 4)
    prm = buf[4 * n_nodes:]
    lanes = [cols[k].astype(np.int64) for k in lane_keys]
    stack = np.zeros(P, dtype=np.uint64)
    for op, lane, off, arg in nodes.tolist():
        if op in (tk._OP_AND, tk._OP_OR):
            m = np.uint64((1 << arg) - 1)
            kids = stack & m
            stack >>= np.uint64(arg)
            bit = (kids == m) if op == tk._OP_AND else (kids != 0)
        elif op == tk._OP_TRUE:
            bit = np.ones(P, bool)
        elif op == tk._OP_FALSE:
            bit = np.zeros(P, bool)
        else:
            v = lanes[lane]
            if op == tk._LEAF_OPS["eq_id"]:
                bit = v == prm[off]
            elif op == tk._LEAF_OPS["neq_id"]:
                bit = v != prm[off]
            elif op == tk._LEAF_OPS["range_ids"]:
                bit = (v >= prm[off]) & (v < prm[off + 1])
            elif op in (tk._LEAF_OPS["in_ids"], tk._LEAF_OPS["notin_ids"]):
                bit = np.isin(v, prm[off:off + arg])
                if op == tk._LEAF_OPS["notin_ids"]:
                    bit = ~bit
            else:
                idx = np.clip(v, 0, arg - 1)
                words = prm[off + (idx >> 5)].astype(np.uint32)
                bit = ((words >> (idx & 31).astype(np.uint32)) & 1) == 1
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
    deep = ("and", tuple(_pred("eq_id", "a") for _ in range(32)))
    with pytest.raises(ValueError):
        tk.compile_filter(deep, [np.int32(1)] * 32)
    with pytest.raises(ValueError):
        tk.compile_filter(("pred", "eq_raw", "x", "raw", None), [1.0])


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
    spec, params = FILTERS["nested"] if aggs == "sums" else \
        FILTERS["full_match"]
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
    with pytest.raises(ValueError):
        tk.run_segment_kernel(P, ("match_all",), (), (
            (("a", "ids", 0, 50),), (1,), 64, (), 16), None, cols, (), P,
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
    got = tk.dense_group_aggregate(mask, keys, strides, g_pad, parts,
                                   [cols["x.raw"]])
    want = tk.dense_group_aggregate_plain(mask, keys, strides, g_pad, parts,
                                          [cols["x.raw"]])
    for a, b in ((got[0], want[0]), (got[1], want[1]), (got[3], want[3])):
        assert torch.equal(a, b)
    torch.testing.assert_close(got[2], want[2], rtol=1e-12, atol=0)
