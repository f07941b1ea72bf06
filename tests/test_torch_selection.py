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
import zlib

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
# A numpy model of K6's select route against the JAX _selection_outputs
# ---------------------------------------------------------------------------

#: masked_select.cu's select route: rows a thread and a tile take, and the
#: (shift, bits) of the threshold's three digit passes
SEL_ITEMS, SEL_TILE = 16, 4096
SEL_DIGITS = ((21, 11), (10, 11), (0, 10))


def select_model(words, hits, k, seed=0):
    """K6's select route for one segment as masked_select.cu computes it.
    words: the one key word a row in unsigned order (uint32 [P], None for
    "limit"); hits: bool [P]. The threshold by digit passes (the bucket of
    the k-th row, `below`, the early ends), the count pass's per-tile ties
    and their exclusive prefix, the write pass (rows below lt_bound in an
    arbitrary order drawn from `seed`, tied rows at below + their rank by
    docid: tile prefix, thread prefix, then the thread's own order), and
    the sort of the candidates by (word, docid). Returns (docids int32
    [k], the match count, the threshold's path: "limit", "all" matched
    rows, a "bucket" the k-th row closes, or a "tie" at T)."""
    P = hits.shape[0]
    m = int(hits.sum())
    t_eq = below = 0
    if words is None:
        lt_bound, need_eq, path = 0, min(k, m), "limit"
    elif m <= k:
        lt_bound, need_eq, below, path = 1 << 32, 0, m, "all"
    else:
        want, prefix = k, 0
        for shift, bits in SEL_DIGITS:
            inb = hits.copy()
            if shift + bits < 32:
                inb &= (words >> np.uint32(shift + bits)) == prefix
            d = (words[inb] >> np.uint32(shift)) & np.uint32((1 << bits) - 1)
            h = np.bincount(d.astype(np.int64), minlength=1 << bits)
            cum = np.cumsum(h)
            assert cum[-1] >= want
            b = int(np.searchsorted(cum, want))    # cum[b - 1] < want
            before = int(cum[b] - h[b])
            below, want = below + before, want - before
            bucket = (prefix << bits) | b
            if h[b] == want:                       # the k-th row closes it
                lt_bound, need_eq, below = (bucket + 1) << shift, 0, k
                path = "bucket"
                break
            if shift == 0:                         # T: ties at the k-th
                lt_bound, t_eq, need_eq, path = bucket, bucket, want, "tie"
                break
            prefix = bucket
    w = np.zeros(P, np.uint64) if words is None else words.astype(np.uint64)
    lt = hits & (w < lt_bound)
    eq = hits & ~lt & (w == t_eq) if need_eq else np.zeros(P, bool)
    assert int(lt.sum()) == below
    # the count pass and the write pass
    doc = np.arange(P)
    tiles = -(-P // SEL_TILE)
    tile_eq = np.bincount(doc[eq] // SEL_TILE, minlength=tiles)
    tile_pre = np.cumsum(tile_eq) - tile_eq
    thread = doc // SEL_ITEMS
    thread_eq = np.bincount(thread[eq], minlength=thread.max() + 1)
    thread_in_tile = np.cumsum(thread_eq) - thread_eq
    first_thread = (np.arange(thread.max() + 1) * SEL_ITEMS // SEL_TILE) * \
        (SEL_TILE // SEL_ITEMS)
    thread_pre = thread_in_tile - thread_in_tile[first_thread]
    own = np.cumsum(eq) - eq - np.concatenate([[0], np.cumsum(eq)])[
        thread * SEL_ITEMS]                        # earlier rows of a thread
    rank = tile_pre[doc // SEL_TILE] + thread_pre[thread] + own
    c = min(k, m)
    cand_w = np.full(c, -1, np.int64)
    cand_d = np.full(c, -1, np.int64)
    lt_rows = np.random.default_rng(seed).permutation(doc[lt])
    cand_w[:below], cand_d[:below] = w[lt_rows], lt_rows
    take = eq & (rank < need_eq)
    cand_w[below + rank[take]], cand_d[below + rank[take]] = w[take], doc[take]
    assert (cand_d >= 0).all()
    if words is not None:                          # the sort launch
        order = np.lexsort((cand_d, cand_w))
        cand_d = cand_d[order]
    docids = np.full(k, -1, np.int32)
    docids[:c] = cand_d
    return docids, m, path


def _words_u32(word: torch.Tensor) -> np.ndarray:
    return word.numpy().view(np.uint32) ^ np.uint32(1 << 31)


def _jax_select(spec, cols, mask, params=None):
    out = jk._selection_outputs(
        spec, {n: jnp.asarray(v) for n, v in cols.items()}, jnp.asarray(mask),
        None if params is None else [jnp.asarray(p) for p in params])
    return np.asarray(out["sel.docids"]), int(out.get(
        "sel.count", np.asarray(mask).sum()))


SEL_P = 5 * SEL_TILE + 123
SEL_BIG_P = (1 << 16) + 3 * SEL_TILE + 5


def _select_case(name):
    """(spec, cols, masks, k values, P) of one model case: the key lanes
    made from a seed, the masks that decide the threshold's path."""
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    big = name.startswith("k=65536")
    P = SEL_BIG_P if big else SEL_P
    everyone = np.ones(P, bool)
    half = rng.random(P) < 0.5
    few = np.zeros(P, bool)
    few[rng.choice(P, 40, replace=False)] = True
    none = np.zeros(P, bool)
    ks = (1, 16, 2048)
    if name == "order, every row tied":
        cols = {"a.ids": np.full(P, 3, np.int16)}
        spec = ("order", 0, (("a", True, 9, "sv"),), ())
        masks = (everyone, half)
    elif name == "order, ties straddle the k-th row":
        cols = {"a.ids": rng.integers(0, 4, P).astype(np.int8),
                "b.ids": rng.integers(0, 3, P).astype(np.int8)}
        spec = ("order", 0, (("a", False, 5, "sv"), ("b", True, 3, "sv")),
                ())
        masks = (everyone, half, few)
        ks = (1, 16, 2048, 5000)
    elif name in ("ordertk, NaN and +-0.0", "ordertk desc, NaN and +-0.0"):
        nan_neg = np.array([0xFFC00000], np.uint32).view(np.float32)[0]
        pool = np.array([0.0, -0.0, np.nan, nan_neg, np.inf, -np.inf, 1.5,
                         -1.5, 1e-30], np.float32)
        lane = rng.choice(pool, P).astype(np.float32)
        normal = rng.random(P) < 0.5
        lane[normal] = rng.standard_normal(int(normal.sum()))
        cols = {"f.raw": lane}
        spec = ("ordertk", 0, (("f", "desc" not in name, 0, "raw"),), ())
        masks = (everyone, half, few)
    elif name in ("ordertk, clamped at INT32_MAX - 1",
                  "ordertk desc, clamped at INT32_MAX - 1"):
        pool = np.array([I32_MAX, I32_MAX - 1, I32_MAX - 2, I32_MIN,
                         I32_MIN + 1, 0], np.int32)
        cols = {"r.raw": rng.choice(pool, P).astype(np.int32)}
        spec = ("ordertk", 0, (("r", "desc" not in name, 0, "raw"),), ())
        masks = (everyone, half, few)
    elif name == "ordertk, matches < k, no match":
        cols = {"r.raw": rng.integers(-2**31, 2**31 - 1, P).astype(np.int32)}
        spec = ("ordertk", 0, (("r", True, 0, "raw"),), ())
        masks = (few, none)
        ks = (1, 2048)
    elif name == "limit":
        cols = {}
        spec = ("limit", 0, (), ())
        masks = (everyone, half, few, none)
    elif name == "k=65536 order":
        cols = {"a.ids": rng.integers(0, 40, P).astype(np.int8)}
        spec = ("order", 0, (("a", True, 41, "sv"),), ())
        masks = (everyone, half, few)
        ks = (1 << 16,)
    elif name == "k=65536 ordertk":
        cols = {"f.raw": rng.standard_normal(P).astype(np.float32)}
        spec = ("ordertk", 0, (("f", False, 0, "raw"),), ())
        masks = (everyone, half)
        ks = (1 << 16,)
    elif name == "k=65536 limit":
        cols, spec = {}, ("limit", 0, (), ())
        masks = (everyone, half, few)
        ks = (1 << 16,)
    else:
        raise KeyError(name)
    return spec, cols, masks, ks


SELECT_MODEL_CASES = (
    "order, every row tied", "order, ties straddle the k-th row",
    "ordertk, NaN and +-0.0", "ordertk desc, NaN and +-0.0",
    "ordertk, clamped at INT32_MAX - 1",
    "ordertk desc, clamped at INT32_MAX - 1",
    "ordertk, matches < k, no match", "limit", "k=65536 order",
    "k=65536 ordertk", "k=65536 limit")


@pytest.mark.parametrize("name", SELECT_MODEL_CASES)
def test_select_model_equals_jax(name):
    """The select route's threshold, tie compaction and candidate sort
    give the JAX _selection_outputs' docids and count, for "order",
    "ordertk" and "limit" over every mask and k of the case."""
    spec, cols, masks, ks = _select_case(name)
    tcols = {n: torch.from_numpy(v) for n, v in cols.items()}
    paths = set()
    for mask in masks:
        for k in ks:
            sk = (spec[0], k) + spec[2:]
            words = tk.select_key_words(sk, tcols)
            assert len(words) <= tk.SELECT_ROUTE_MAX_WORDS
            got = select_model(_words_u32(words[0]) if words else None,
                               mask, k, seed=k)
            want = _jax_select(sk, cols, mask)
            np.testing.assert_array_equal(got[0], want[0],
                                          err_msg=f"{name} k={k}")
            assert got[1] == int(mask.sum())
            paths.add(got[2])
    # each case takes the threshold path it is there for
    want_path = {"order, every row tied": "tie",
                 "order, ties straddle the k-th row": "tie",
                 "ordertk, matches < k, no match": "all", "limit": "limit",
                 "k=65536 limit": "limit"}.get(name)
    assert want_path is None or want_path in paths, paths


def _vec_case(metric, seed):
    """Vectors of 16 floats: random rows, all +0.0 and all -0.0 rows (DOT
    scores of +-0.0, COSINE -inf), rows holding a NaN, and duplicated rows
    (tied scores)."""
    rng = np.random.default_rng(seed)
    mat = rng.standard_normal((SEL_P, 16)).astype(np.float32)
    mat[rng.random(SEL_P) < 0.05] = 0.0
    mat[rng.random(SEL_P) < 0.05] = -0.0
    mat[rng.random(SEL_P) < 0.02, 3] = np.nan
    dup = rng.random(SEL_P) < 0.2
    mat[dup] = mat[0]
    q = np.abs(rng.standard_normal(16)).astype(np.float32)
    q_norm = np.float32(np.sqrt(np.sum(q.astype(np.float64) ** 2)))
    return mat, q, q_norm


@pytest.mark.parametrize("metric", ["cosine", "dot"])
def test_select_model_equals_jax_vector_kind(metric):
    """The vector kind: K6's word is ~monotone(score) clamped, over the
    JAX scores; the model's top k equals the JAX vector branch's, with
    +-0.0, -inf, NaN and tied scores."""
    mat, q, q_norm = _vec_case(metric, seed=len(metric))
    scores = np.array(jk._vector_scores(jnp.asarray(mat), jnp.asarray(q),
                                          jnp.asarray(q_norm), metric))
    spec_words = tk._score_spec(16, ())
    rng = np.random.default_rng(5)
    for mask in (np.ones(SEL_P, bool), rng.random(SEL_P) < 0.3,
                 np.zeros(SEL_P, bool)):
        for k in (1, 16, 2048):
            words = tk.select_key_words(
                (spec_words[0], k) + spec_words[2:],
                {"$score.raw": torch.from_numpy(scores)})
            got = select_model(_words_u32(words[0]), mask, k, seed=k)
            want, _n = _jax_select(("vector", k, (("emb", metric, 16),), ()),
                                   {"emb.vec": mat}, mask, [q, q_norm])
            np.testing.assert_array_equal(got[0], want, err_msg=f"k={k}")


def test_select_model_stacked_segments_with_different_counts():
    """Three segments back to back with 0, 40 and ~10,000 matches: the
    model per segment equals the JAX function per segment and the port's
    stacked plain version (tied dictId keys, k = 16 and 2048)."""
    rng = np.random.default_rng(9)
    S = 3
    ids = rng.integers(0, 6, S * SEL_P).astype(np.int8)
    mask = np.zeros(S * SEL_P, bool)
    mask[SEL_P + rng.choice(SEL_P, 40, replace=False)] = True
    mask[2 * SEL_P:] = rng.random(SEL_P) < 0.5
    for k in (16, 2048):
        spec = ("order", k, (("a", False, 7, "sv"),), ())
        stacked = tk.selection_outputs_plain(
            spec, {"a.ids": torch.from_numpy(ids)},
            torch.from_numpy(mask.astype(np.uint8)), n_segs=S)
        for s in range(S):
            seg = slice(s * SEL_P, (s + 1) * SEL_P)
            words = tk.select_key_words(spec, {"a.ids": torch.from_numpy(
                np.ascontiguousarray(ids[seg]))})
            got = select_model(_words_u32(words[0]), mask[seg], k, seed=s)
            want = _jax_select(spec, {"a.ids": ids[seg]}, mask[seg])
            np.testing.assert_array_equal(got[0], want[0])
            np.testing.assert_array_equal(
                got[0], stacked["sel.docids"][s].numpy())
            assert got[1] == int(stacked["sel.count"][s])


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
    # the tile route: the merge passes of an odd list count write more
    # entries than the tile pass, so the scratch K6 asks for holds two
    # sets of the largest; a tile's entries fit 64 KB of shared memory.
    # The select route: each segment's state and 2,048-bin histogram, a
    # tie count a 4,096-row tile, and k candidates' words and docids.
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
            assert tk.select_scratch_words(padded, k, n_words,
                                           route="tile") == \
                2 * (n_words + 1) * max(passes)
            for segs in (1, 3):
                assert tk.select_scratch_words(padded, k, n_words, segs,
                                               route="select") == \
                    segs * (16 + 2048 + -(-padded // 4096) + 2 * k)
            assert tk.select_scratch_words(padded, k, n_words) == \
                tk.select_scratch_words(padded, k, n_words,
                                        route=tk.select_route(n_words))


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


SELECT_CUDA_REPEATS = 20   # a race between blocks shows only as a wrong row


def _cuda_outputs_equal(got, want):
    return set(got) == set(want) and all(
        got[n].dtype == w.dtype and torch.equal(
            got[n].cpu().reshape(-1).view(torch.uint8),
            w.cpu().reshape(-1).view(torch.uint8)) for n, w in want.items())


@pytest.mark.cuda
@pytest.mark.parametrize("name", SELECT_MODEL_CASES)
def test_masked_select_cuda_select_route(cuda_device, name):
    """The select route on the model's cases (every row tied, ties
    straddling the k-th row, NaN / +-0.0, the INT32_MAX - 1 clamp,
    matches < k, no match, k = 1 to 65,536) equal to the plain version
    in each of 20 repeats, counted under masked_select[select]."""
    spec, cols, masks, ks = _select_case(name)
    gather = tuple((n.split(".")[0], "sv" if n.endswith(".ids") else "raw")
                   for n in cols)
    tcols = {n: torch.from_numpy(v).to(cuda_device) for n, v in cols.items()}
    for mask in masks:
        m = torch.from_numpy(mask.astype(np.uint8)).to(cuda_device)
        for k in ks:
            sk = (spec[0], k, spec[2], gather)
            want = tk.selection_outputs_plain(sk, tcols, m)
            for _ in range(SELECT_CUDA_REPEATS):
                tk.reset_launch_counts()
                got = tk.masked_select(sk, tcols, m)
                assert tk.launch_counts()["masked_select[select]"] == 1
                assert _cuda_outputs_equal(got, want), (name, k)


@pytest.mark.cuda
def test_masked_select_cuda_routes_by_word_count(cuda_device, lanes):
    """One key word or none takes the select route, two or more the
    tile route, and both equal the plain version."""
    for kind, key, asc in _case_ids():
        cols = {k: torch.from_numpy(v).to(cuda_device)
                for k, v in lanes.items()}
        spec = (kind, 16, _order(kind, key, asc), GATHER)
        route = tk.select_route(len(tk.select_key_words(spec, cols)))
        m = torch.from_numpy(_masks(lanes, "i8.ids")["sparse"].astype(
            np.uint8)).to(cuda_device)
        tk.reset_launch_counts()
        got = tk.masked_select(spec, cols, m)
        counts = tk.launch_counts()
        assert counts[f"masked_select[{route}]"] == 1 and \
            counts["masked_select"] == 1, (kind, key)
        assert _cuda_outputs_equal(got, tk.selection_outputs_plain(
            spec, cols, m)), (kind, key)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["limit", "order", "ordertk", "vector"])
def test_masked_select_cuda_stacked_and_batched(cuda_device, kind):
    """Stacked segments with different match counts (0, 40, about half)
    and batched members (B = 1 to 8, each its own mask; the vector kind
    with its own scores) equal to the plain stacked / batched versions in
    each of 20 repeats, on the select route."""
    rng = np.random.default_rng(len(kind))
    P, S = SEL_P, 3
    ids = torch.from_numpy(rng.integers(0, 6, S * P).astype(np.int8)).to(
        cuda_device)
    raw = torch.from_numpy(rng.standard_normal(S * P).astype(np.float32)).to(
        cuda_device)
    mask = np.zeros(S * P, bool)
    mask[P + rng.choice(P, 40, replace=False)] = True
    mask[2 * P:] = rng.random(P) < 0.5
    smask = torch.from_numpy(mask.astype(np.uint8)).to(cuda_device)
    order = {"limit": (), "order": (("a", False, 7, "sv"),),
             "ordertk": (("f", True, 0, "raw"),)}
    gather = (("a", "sv"), ("f", "raw"))
    cols = {"a.ids": ids, "f.raw": raw}
    for k in (16, 2048):
        if kind == "vector":
            stacked = lambda: tk.vector_topk(raw, smask, k, cols, gather,
                                             n_segs=S)    # noqa: E731
            plain = tk.vector_topk_plain(raw, smask, k, cols, gather, S)
            counter = "masked_select_vector"
        else:
            spec = (kind, k, order[kind], gather)
            stacked = lambda: tk.masked_select(spec, cols, smask,
                                               S)         # noqa: E731
            plain = tk.selection_outputs_plain(spec, cols, smask, S)
            counter = "masked_select"
        for _ in range(SELECT_CUDA_REPEATS):
            tk.reset_launch_counts()
            assert _cuda_outputs_equal(stacked(), plain), (kind, k)
            assert tk.launch_counts()[f"{counter}[select]"] == 1
        one = {n: t[:P] for n, t in cols.items()}
        for B in range(1, 9):
            bm = torch.from_numpy((rng.random((B, P)) < (0.5, 0.001, 0.0, 1.0)
                                   [B % 4]).astype(np.uint8)).to(cuda_device)
            if kind == "vector":
                sc = torch.from_numpy(rng.standard_normal((B, P)).astype(
                    np.float32)).to(cuda_device)
                batched = lambda: tk.vector_topk_batched(
                    sc, bm, k, one, gather)               # noqa: E731
                plain = tk.vector_topk_batched_plain(sc, bm, k, one, gather)
            else:
                spec = (kind, k, order[kind], gather)
                batched = lambda: tk.masked_select_batched(
                    spec, one, bm)                        # noqa: E731
                plain = tk.selection_outputs_batched_plain(spec, one, bm)
            for _ in range(SELECT_CUDA_REPEATS):
                tk.reset_launch_counts()
                assert _cuda_outputs_equal(batched(), plain), (kind, k, B)
                assert tk.launch_counts()[f"{counter}_batched[select]"] == 1


@pytest.mark.cuda
def test_masked_select_cuda_no_host_sync(cuda_device, lanes):
    """K6 on both routes, single, stacked and batched, waits for nothing
    under torch.cuda.set_sync_debug_mode("error")."""
    cols = {k: torch.from_numpy(v).to(cuda_device) for k, v in lanes.items()}
    m = torch.from_numpy(_masks(lanes, "i8.ids")["ties"].astype(
        np.uint8)).to(cuda_device)
    flat = {k: torch.cat([v, v]) for k, v in cols.items()}
    bm = torch.stack([m, m.flip(0)])
    scores = cols["rf32.raw"]
    specs = [("order", 16, _order("order", ("i8",), False), GATHER),
             ("limit", 2048, (), GATHER),
             ("ordermk", 16, _order("ordermk", ("i8", "rf64"), True),
              GATHER)]
    calls = []
    for spec in specs:
        calls += [lambda spec=spec: tk.masked_select(spec, cols, m),
                  lambda spec=spec: tk.masked_select(spec, flat, m.repeat(2),
                                                     2),
                  lambda spec=spec: tk.masked_select_batched(spec, cols, bm)]
    calls += [lambda: tk.vector_topk(scores, m, 16),
              lambda: tk.vector_topk_batched(scores.repeat(2).reshape(2, P),
                                             bm, 16)]
    for call in calls:
        want = call()
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            got = call()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        assert _cuda_outputs_equal(got, want)
