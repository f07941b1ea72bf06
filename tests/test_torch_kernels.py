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
K4 and K5 over MV entries and the fused K4's HLL registers. The lanes
and cases of the last three are shared with test_torch_groupby_mv.py and
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


def _program(spec, cols, params):
    """K1's host-built program: (nodes [n, 6] as lists, parameter words,
    lane keys)."""
    buf, n_nodes = tk.compile_filter(spec, params, _torch_cols(cols))
    w = tk._NODE_WORDS
    return (buf[: w * n_nodes].reshape(n_nodes, w).tolist(),
            buf[w * n_nodes:], tk.filter_lane_keys(spec))


def _leaf_rows(node, prm, lane_keys, cols, rows) -> np.ndarray:
    """bool [rows]: one leaf node over each row, as filter_mask.cu's
    evaluators (eval_id / eval_raw / the vdoc byte) compute it."""
    op, lane, off, arg, elem, width = node
    elem_np = {code: tk._np_of(dt) for dt, code in tk._ELEM.items()}
    ops = tk._LEAF_OPS
    if op == tk._OP_TRUE:
        return np.ones(rows, bool)
    if op == tk._OP_FALSE:
        return np.zeros(rows, bool)
    if op == ops["vdoc"]:
        return cols[lane_keys[lane]] != 0
    if op >= ops["eq_raw"]:
        dt = elem_np[elem]
        v = cols[lane_keys[lane]]
        assert v.dtype == dt and width == 1
        nw = dt.itemsize // 4

        def const(i):
            return np.ascontiguousarray(
                prm[off + i * nw: off + (i + 1) * nw]).view(dt)[0]

        if op == ops["eq_raw"]:
            return v == const(0)
        if op == ops["neq_raw"]:
            return v != const(0)
        if op == ops["range_raw"]:
            lo, hi = const(0), const(1)
            return ((v >= lo) if arg & 1 else (v > lo)) & \
                ((v <= hi) if arg & 2 else (v < hi))
        bit = np.isin(v, [const(i) for i in range(arg)])
        return ~bit if op == ops["notin_raw"] else bit
    v = cols[lane_keys[lane]].astype(np.int64).reshape(rows, width)
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
    return bit.any(axis=1)


def _pop_push(stack, node):
    """An AND / OR node on per-row bit stacks: pop arg bits, push one."""
    op, arg = node[0], node[3]
    m = np.uint64((1 << arg) - 1)
    kids = stack & m
    stack = stack >> np.uint64(arg)
    bit = (kids == m) if op == tk._OP_AND else (kids != 0)
    return (stack << np.uint64(1)) | bit.astype(np.uint64)


def _interpret_program(P, spec, cols, params, num_docs) -> np.ndarray:
    """numpy mirror of filter_mask.cu's per-row loop over the program."""
    nodes, prm, lane_keys = _program(spec, cols, params)
    stack = np.zeros(P, dtype=np.uint64)
    for node in nodes:
        if node[0] in (tk._OP_AND, tk._OP_OR):
            stack = _pop_push(stack, node)
            continue
        bit = _leaf_rows(node, prm, lane_keys, cols, P)
        stack = (stack << np.uint64(1)) | bit.astype(np.uint64)
    out = (stack & np.uint64(1)).astype(np.uint8)
    out[num_docs:] = 0
    return out


_HIGH = np.uint64(0x80808080)          # bit 7 of each byte of a word
_LOW7 = np.uint64(0x7F7F7F7F)
_WORD = np.uint64(0xFFFFFFFF)


def _level_bit(r):
    """Row r of a wide run's 32 at bit 8 (r % 4) + r / 4 of a level."""
    return 8 * (r & 3) + (r >> 2)


def _nonzero_bytes(w):
    """filter_mask.cu:nonzero_bytes on uint64-held 32-bit words."""
    return (((w & _LOW7) + _LOW7) | w) & _HIGH


def _pack_flags(f):
    """[runs, 8] words of byte flags (bit 7) → [runs] levels: word k's
    flags shifted right by 7 - k."""
    return np.bitwise_or.reduce(
        f >> (np.uint64(7) - np.arange(8, dtype=np.uint64)), axis=1)


def _i8_level(node, prm, lane):
    """filter_mask.cu:i8_level on [runs, 8] words of an int8 lane."""
    op, _lane, off, arg = node[:4]
    ops = tk._LEAF_OPS
    w = lane.view("<u4").astype(np.uint64).reshape(-1, 8)
    if op == ops["range_ids"]:
        lo, hi = max(int(prm[off]), -128), min(int(prm[off + 1]), 128)
        if lo >= hi or hi - lo == 256:
            return _pack_flags(np.full_like(w, 0 if lo >= hi else _HIGH))
        l4 = np.uint64((lo + 128) * 0x01010101)
        e4 = np.uint64((256 - (hi - lo)) * 0x01010101)
        u = w ^ _HIGH
        d = (((u | _HIGH) - (l4 & _LOW7)) & _WORD) ^ \
            ((u ^ (~l4 & _WORD)) & _HIGH)
        sm = (d & _LOW7) + (e4 & _LOW7)
        ge = ((d & e4) | ((d | e4) & sm)) & _HIGH
        return _pack_flags(ge ^ _HIGH)
    f = np.zeros_like(w)
    for c in prm[off:off + (1 if op in (ops["eq_id"], ops["neq_id"])
                            else arg)].tolist():
        if -128 <= c <= 127:
            f |= _nonzero_bytes(w ^ np.uint64((c & 0xFF) * 0x01010101)) ^ \
                _HIGH
    if op in (ops["neq_id"], ops["notin_ids"]):
        f ^= _HIGH
    return _pack_flags(f)


def _interpret_wide(rows, spec, cols, params, seg_rows, seg_docs,
                    program=None):
    """numpy mirror of filter_mask.cu:filter_wide_kernel: runs of 32 rows
    (a thread's: two halves of 16 rows, 4,096 rows apart, of an 8,192-row
    block step), each leaf's runs as 32-bit levels, row r at bit
    8 (r % 4) + r / 4 (int8 dictId leaves but member and the vdoc byte
    through the kernel's byte-parallel arithmetic, the others row by
    row); the stack as levels in slots, a leaf writing slot sp, an AND /
    OR of k children folding slots sp - k .. sp - 1; the result level
    masked by the run's live rows (a run never straddles two segments),
    word w of its mask (level >> w) & 0x01010101, popcounted into
    seg_matched. `program` (nodes, parameter words, lane keys) stands in
    for compile_filter's (a batched member's nodes and its own block).
    Returns (uint8 mask [rows], int32 matched per segment)."""
    nodes, prm, lane_keys = program or _program(spec, cols, params)
    # a block step of 8,192 rows: thread t's rows 0-15 are the step's rows
    # 16 t .. 16 t + 15, its rows 16-31 the same of the step's second half
    tile = 32 * 256
    assert rows % tile == 0
    half = np.arange(16)
    own = np.concatenate([np.concatenate([16 * t + half, tile // 2 + 16 * t
                                          + half]) for t in range(256)])
    order = (np.arange(rows // tile)[:, None] * tile + own).reshape(-1)
    cols = {k: np.ascontiguousarray(cols[k][order]) for k in lane_keys}
    runs = rows // tk.WIDE_ROWS
    bit = np.array([_level_bit(r) for r in range(tk.WIDE_ROWS)],
                   dtype=np.uint64)
    slots = np.zeros((runs, tk.WIDE_DEPTH), dtype=np.uint64)
    sp = 0
    for node in nodes:
        op, lane, arg, elem, width = node[0], node[1], node[3], node[4], \
            node[5]
        if op in (tk._OP_AND, tk._OP_OR):
            sp -= arg
            fold = np.bitwise_and if op == tk._OP_AND else np.bitwise_or
            v = fold.reduce(slots[:, sp:sp + arg], axis=1)
        elif op == tk._LEAF_OPS["vdoc"]:
            v = _pack_flags(_nonzero_bytes(cols[lane_keys[lane]].astype(
                np.uint8).view("<u4").astype(np.uint64).reshape(-1, 8)))
        elif op in tk._LEAF_OPS.values() and op < tk._LEAF_OPS["eq_raw"] \
                and op != tk._LEAF_OPS["member"] and width == 1 and \
                elem == tk._ELEM[torch.int8]:
            v = _i8_level(node, prm, cols[lane_keys[lane]])
        else:
            b = _leaf_rows(node, prm, lane_keys, cols, rows)
            v = np.bitwise_or.reduce(b.reshape(runs, tk.WIDE_ROWS).astype(
                np.uint64) << bit, axis=1)
        slots[:, sp] = v & _WORD
        sp += 1
    res = slots[:, 0]
    row = order.reshape(runs, tk.WIDE_ROWS)       # each run's rows
    seg = row[:, 0] // seg_rows
    live = row < (seg * seg_rows + np.asarray(seg_docs, np.int64)[seg]
                  )[:, None]
    res &= np.bitwise_or.reduce(live.astype(np.uint64) << bit, axis=1)
    words = (res[:, None] >> np.arange(8, dtype=np.uint64)) & \
        np.uint64(0x01010101)
    out = np.empty(rows, np.uint8)
    out[order] = words.astype("<u4").view(np.uint8).reshape(rows)
    matched = np.bincount(seg, weights=[bin(int(x)).count("1") for x in res],
                          minlength=rows // seg_rows).astype(np.int32)
    return out, matched


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


#: K1's wide route (32 rows a thread): id lanes int8 / int16 / int32,
#: in-lists, member bitsets, nesting, the vdoc byte, an MV lane and a raw
#: float64 lane (the general instantiation's per-row evaluators)
WIDE_FILTERS = ("eq_int8", "neq_int16", "range_int32", "in_int8",
                "notin_int16", "member_int32", "nested", "vdoc_and_eq",
                "eq_mv_w3", "range_raw_f64")
#: live rows around the wide route's run edges (32 rows): none, one, half
#: a run and one more, a run and one more, one short of the segment, all
WIDE_TAILS = ("0", "1", "15", "16", "17", "31", "32", "33", "P-1", "P")


def _tail(P: int, tail: str) -> int:
    return {"P-1": P - 1, "P": P}.get(tail) if tail.startswith("P") \
        else int(tail)


@pytest.mark.parametrize("tail", WIDE_TAILS)
@pytest.mark.parametrize("name", WIDE_FILTERS)
def test_wide_route_mirror_matches_jax(name, tail):
    P = SHAPES[0]
    spec, params = FILTERS[name]
    num_docs = _tail(P, tail)
    cols = _lanes(P, num_docs, seed=P + len(name) + num_docs)
    want = _jax_filter(P, spec, cols, params, num_docs)
    got, matched = _interpret_wide(P, spec, cols, params, P, [num_docs])
    np.testing.assert_array_equal(got.astype(bool), want)
    assert matched.tolist() == [int(want.sum())]
    lanes = [torch.from_numpy(np.ascontiguousarray(cols[k])).clone()
             for k in tk.filter_lane_keys(spec)]
    buf, n_nodes = tk.compile_filter(spec, params, _torch_cols(cols))
    assert tk.filter_route(lanes, P, buf, n_nodes) == "wide"


@pytest.mark.parametrize("name", ["nested", "eq_int8", "vdoc_and_eq",
                                  "eq_mv_w3"])
def test_wide_route_mirror_stacked_matches_jax(name):
    """Four segments stacked; the second and third end mid-run (5,003
    and 17 live rows), the last holds none: each segment's mask and
    match count against JAX over that segment alone."""
    P = SHAPES[0]
    spec, params = FILTERS[name]
    docs = [P, 5003, 17, 0]
    segs = [_lanes(P, d, seed=40 + i) for i, d in enumerate(docs)]
    keys = tk.filter_lane_keys(spec)
    flat = {k: np.concatenate([c[k] for c in segs]) for k in keys}
    got, matched = _interpret_wide(len(docs) * P, spec, flat, params, P,
                                   docs)
    for i, d in enumerate(docs):
        want = _jax_filter(P, spec, segs[i], params, d)
        np.testing.assert_array_equal(got[i * P:(i + 1) * P].astype(bool),
                                      want)
        assert int(matched[i]) == int(want.sum())


#: int8 programs at the edges of the wide route's byte arithmetic, over a
#: lane of every int8 value: constants outside int8, empty, inverted and
#: full ranges, negative ids
I8_EDGES = {
    "range_all": [np.int32(-200), np.int32(300)],
    "range_int8": [np.int32(-128), np.int32(128)],
    "range_empty": [np.int32(5), np.int32(5)],
    "range_inverted": [np.int32(10), np.int32(3)],
    "range_negative": [np.int32(-5), np.int32(7)],
    "range_top": [np.int32(127), np.int32(1000)],
    "range_bottom": [np.int32(-1000), np.int32(-127)],
    "eq_outside": [np.int32(200)],
    "eq_min": [np.int32(-128)],
    "neq_outside": [np.int32(-129)],
    "in_outside": [np.array([-129, 5, 300, -128], np.int32)],
    "notin_ends": [np.array([127, -1], np.int32)],
}


def _i8_edge(name):
    kind = {"range": "range_ids", "eq": "eq_id", "neq": "neq_id",
            "in": "in_ids", "notin": "notin_ids"}[name.split("_")[0]]
    params = I8_EDGES[name]
    extra = len(params[0]) if kind in ("in_ids", "notin_ids") else None
    cols = {"e.ids": np.random.default_rng(77).integers(
        -128, 128, SHAPES[0]).astype(np.int8)}
    return _pred(kind, "e", extra), params, cols


@pytest.mark.parametrize("name", sorted(I8_EDGES))
def test_wide_int8_arithmetic_matches_jax(name):
    P = SHAPES[0]
    spec, params, cols = _i8_edge(name)
    want = _jax_filter(P, spec, cols, params, P - 5)
    got, matched = _interpret_wide(P, spec, cols, params, P, [P - 5])
    np.testing.assert_array_equal(got.astype(bool), want)
    assert int(matched[0]) == int(want.sum())


def test_filter_route_picks_wide_by_lanes():
    P = 8192
    cols = {k: torch.from_numpy(np.ascontiguousarray(v)).clone()
            for k, v in _lanes(P, P, seed=0).items()}
    eq = tk.compile_filter(_pred("eq_id", "a"), [np.int32(1)], cols)
    ssb = [cols["a.ids"], cols["h15.ids"], cols["b.ids"]]  # 4 bytes a row
    assert all(t.data_ptr() % 16 == 0 for t in ssb)
    assert tk.filter_route(ssb, P, *eq) == "wide"
    assert tk.filter_route([], P, *tk.compile_filter(("match_all",), [],
                                                     cols)) == "wide"
    # an unaligned view of the same rows
    unaligned = torch.zeros(P + 16, dtype=torch.int8)[1:P + 1]
    assert tk.filter_route([unaligned] + ssb[1:], P, *eq) == "rows"
    # the budget: 8 bytes a row take the route, 9 do not
    assert tk.filter_route([cols["ri64.raw"]], P, *eq) == "wide"
    assert tk.filter_route([cols["ri64.raw"], cols["a.ids"]], P, *eq) == \
        "rows"
    # an MV lane counts its width: int8 x 3
    mixed = [cols["m3.mv"], cols["rf32.raw"], cols["a.ids"]]
    assert tk.filter_route(mixed, P, *eq) == "wide"
    assert tk.filter_route(mixed + [cols["b.ids"]], P, *eq) == "rows"
    # rows past a multiple of 16
    assert tk.filter_route([t[:P - 16] for t in ssb], P - 16, *eq) == "wide"
    assert tk.filter_route([t[:P - 8] for t in ssb], P - 8, *eq) == "rows"
    # a stack of 8 levels takes the route, of 9 it does not
    leaf = _pred("eq_id", "a")
    for n_or, depth in ((4, 8), (5, 9)):
        deep = ("and", ((("or", (leaf, leaf)),) * n_or +
                        (("and", (leaf,) * 4),)))
        buf, n_nodes = tk.compile_filter(
            deep, [np.int32(1)] * (2 * n_or + 4), cols)
        assert tk.program_depth(buf, n_nodes) == depth
        assert tk.filter_route(ssb, P, buf, n_nodes) == \
            ("wide" if depth <= tk.WIDE_DEPTH else "rows")
    # a program past shared memory: an in-list of 12,288 ids
    big = np.arange(tk._MAX_STAGED_WORDS, dtype=np.int32)
    assert tk.filter_route(ssb, P, *tk.compile_filter(
        _pred("in_ids", "c", big.size), [big], cols)) == "rows"
    # a join_raw probe stays on the row route
    dim = np.array([1, 5, 9, 13], np.int32)
    buf, n_nodes = tk.compile_filter(
        ("pred", "join_raw", "ri32", "raw", 4), [tk.SortedKeys(dim)], cols,
        probe_lanes=[], join=lambda *_: torch.from_numpy(dim))
    assert buf[0] == tk._LEAF_OPS["join_raw"]
    assert tk.filter_route([cols["ri32.raw"]], P, buf, n_nodes) == "rows"


def ssb_q1_family(rows: int = 20_000):
    """(spec, leaf lanes, the 8 members' params, P, num_docs) of the SSB
    Q1.1 family (tools/ssb.py:q1_batches) over a one-segment SSB table,
    planned as the engine plans it: the batch phase's batched K1 program."""
    from pinot_tpu_torch.pql.optimizer import BrokerRequestOptimizer
    from pinot_tpu_torch.pql.parser import compile_pql
    from pinot_tpu_torch.query.execution import gather_operands
    from pinot_tpu_torch.query.plan import InstancePlanMaker
    from pinot_tpu_torch.tools.datagen import make_ssb_segments
    from pinot_tpu_torch.tools.ssb import Q1_TEMPLATES, q1_batches
    seg = make_ssb_segments(rows, 1, seed=0).segments[0].to("cpu")
    opt, maker = BrokerRequestOptimizer(), InstancePlanMaker()
    plans = [maker.make_segment_plan(seg, opt.optimize(compile_pql(
        Q1_TEMPLATES["q1.1"].format(**lits)))) for lits in
        q1_batches()["q1.1"]]
    spec = plans[0].filter_spec
    assert all(p.filter_spec == spec for p in plans)
    cols = gather_operands(plans[0])
    return (spec, {k: cols[k] for k in tk.filter_lane_keys(spec)},
            [list(p.params) for p in plans], seg.padded_docs, seg.num_docs)


@pytest.fixture(scope="module")
def ssb_family():
    return ssb_q1_family()


def _shifted(t: torch.Tensor) -> torch.Tensor:
    """The same rows one byte past a 16-byte boundary."""
    buf = torch.zeros(t.numel() * t.element_size() + 16, dtype=torch.uint8)
    out = buf[1:1 + t.numel() * t.element_size()].view(t.dtype)
    out.copy_(t)
    return out


#: the batched K1's route for each program (filter_batched_route) and
#: whether a forced "wide" may run it (batched_wide_takes): the SSB Q1.1
#: family and it ANDed with the vdoc node take "wide"; a raw and an MV leaf
#: (row by row on the wide route, once a member) "rows", forcible; members'
#: join keys (a member map or their sorted keys), a stack of 9 levels, 9
#: bytes a row, lanes off a 16-byte boundary and rows not a multiple of 16
#: "rows", not forcible
BATCHED_ROUTE_CASES = {"ssb_q1.1": ("wide", True),
                       "ssb_q1.1_vdoc": ("wide", True),
                       "raw_mv": ("rows", True),
                       "join_bits": ("rows", False),
                       "join_raw": ("rows", False),
                       "depth_9": ("rows", False), "bytes_9": ("rows", False),
                       "misaligned": ("rows", False),
                       "rows_not_16": ("rows", False)}


def _batched_route_case(name, ssb):
    """(rows, spec, cols, members) of a BATCHED_ROUTE_CASES program."""
    spec, cols, members, P, _n = ssb
    if name == "ssb_q1.1":
        return P, spec, cols, members
    if name == "ssb_q1.1_vdoc":
        from pinot_tpu_torch.query.plan import VALID_DOC_COLUMN, \
            with_valid_doc_mask
        live = torch.from_numpy((np.random.default_rng(2).random(P) < 0.8)
                                .astype(np.uint8))
        return P, with_valid_doc_mask(spec), dict(
            cols, **{f"{VALID_DOC_COLUMN}.vdoc": live}), members
    if name == "misaligned":
        return P, spec, {k: _shifted(v) for k, v in cols.items()}, members
    if name == "rows_not_16":
        return P - 8, spec, {k: v[:P - 8].clone() for k, v in cols.items()}, \
            members
    R = 8192
    lanes = {k: torch.from_numpy(np.ascontiguousarray(v)).clone()
             for k, v in _lanes(R, R, seed=0).items()}
    if name in ("join_bits", "join_raw"):
        pool = RAW_POOLS["ri32"]
        wide = np.array([-2**30, 0, 1, 2**30], np.int32)   # past 2^23
        keys = [tk.SortedKeys(np.sort(np.asarray(
            [pool[b], pool[b + 9], pool[b + 20], pool[40]] if
            name == "join_bits" else wide + b, np.int32))) for b in range(8)]
        return R, ("pred", "join_raw", "ri32", "raw", 4), lanes, \
            [[k] for k in keys]
    if name == "raw_mv":
        return R, ("and", (_raw("range_raw", "rf32", (True, False)),
                           _mv("eq_id", "m3"))), lanes, \
            [[_near("rf32", b), _near("rf32", 30 + b), np.int32(b % 10)]
             for b in range(8)]
    if name == "depth_9":
        leaf = _pred("eq_id", "a")
        deep = ("and", ((("or", (leaf, leaf)),) * 5 + (("and", (leaf,) * 4),)))
        return R, deep, lanes, [[np.int32(b + i) for i in range(14)]
                                for b in range(8)]
    # bytes_9: an int64 raw lane and an int8 id lane
    return R, ("and", (_raw("eq_raw", "ri64"), _pred("eq_id", "a"))), lanes, \
        [[RAW_POOLS["ri64"][b], np.int32(b)] for b in range(8)]


@pytest.mark.parametrize("name", sorted(BATCHED_ROUTE_CASES))
def test_filter_batched_route(ssb_family, name):
    """filter_batched_route and batched_wide_takes over
    compile_filter_batched's buffer at 8 members, and route="wide" on the
    CPU: checked, then the plain version (equal to
    filter_mask_batched_plain), or ValueError where the wide route does
    not take the program."""
    rows, spec, cols, members = _batched_route_case(name, ssb_family)
    probes = []
    buf, n_nodes, words = tk.compile_filter_batched(spec, members, cols,
                                                    probes)
    assert buf.shape[0] == tk._NODE_WORDS * n_nodes + 8 * words
    if name.startswith("join"):
        assert buf[0] == {"join_bits": tk._OP_JOIN_BITS,
                          "join_raw": tk._LEAF_OPS["join_raw"]}[name]
    keys = tk.filter_lane_keys(spec)
    want, forcible = BATCHED_ROUTE_CASES[name]
    lanes = [cols[k] for k in keys]
    assert tk.filter_batched_route(lanes, rows, buf, n_nodes,
                                   tk._general(keys)) == want
    assert tk.batched_wide_takes(lanes, rows, buf, n_nodes) == forcible
    if forcible:
        got = tk.filter_mask_batched(rows, spec, cols, members, rows - 77,
                                     route="wide")
        plain = tk.filter_mask_batched_plain(rows, spec, cols, members,
                                             rows - 77)
        assert all(torch.equal(g, p) for g, p in zip(got, plain))
    else:
        with pytest.raises(ValueError, match="wide route"):
            tk.filter_mask_batched(rows, spec, cols, members, rows,
                                   route="wide")
    with pytest.raises(ValueError, match="route"):
        tk.filter_mask_batched(rows, spec, cols, members, rows,
                               route="lanes")


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


#: launches a case takes on each route: a race shows only as a wrong bit
ROUTE_REPEATS = 20


def _filter_routes_case(cuda_device, P, spec, cols, params, num_docs,
                        route):
    """K1 forced onto `route` ROUTE_REPEATS times, each launch bit-equal
    to the plain version and counted on that route; a program the wide
    route does not take raises there."""
    keys = tk.filter_lane_keys(spec)
    if route == "wide" and tk.filter_route(
            [cols[k] for k in keys], P, *tk.compile_filter(
                spec, params, cols, [])) != "wide":
        with pytest.raises(ValueError):
            tk.filter_mask(P, spec, cols, params, num_docs, cuda_device,
                           route=route)
        return
    want = tk.filter_mask_plain(P, spec, cols, params, num_docs, cuda_device)
    tk.reset_launch_counts()
    for _ in range(ROUTE_REPEATS):
        got = tk.filter_mask(P, spec, cols, params, num_docs, cuda_device,
                             route=route)
        torch.cuda.synchronize()
        assert torch.equal(got, want)
    counts = tk.launch_counts()
    assert counts[f"filter_mask[{route}]"] == ROUTE_REPEATS == \
        counts["filter_mask"]


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["wide", "rows"])
@pytest.mark.parametrize("name", sorted(FILTERS))
def test_filter_mask_cuda_routes_match_plain(cuda_device, name, route):
    P = SHAPES[-1]
    spec, params = FILTERS[name]
    cols = _torch_cols(_lanes(P, P - 777, seed=3), cuda_device)
    _filter_routes_case(cuda_device, P, spec, cols, params, P - 777, route)


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["wide", "rows"])
@pytest.mark.parametrize("name", sorted(I8_EDGES))
def test_filter_mask_cuda_int8_edges_match_plain(cuda_device, name, route):
    P = SHAPES[0]
    spec, params, cols = _i8_edge(name)
    _filter_routes_case(cuda_device, P, spec, _torch_cols(cols, cuda_device),
                        params, P - 5, route)


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["wide", "rows"])
@pytest.mark.parametrize("tail", WIDE_TAILS)
@pytest.mark.parametrize("name", WIDE_FILTERS)
def test_filter_mask_cuda_tails_match_plain(cuda_device, name, tail, route):
    P = SHAPES[0]
    spec, params = FILTERS[name]
    num_docs = _tail(P, tail)
    cols = _torch_cols(_lanes(P, num_docs, seed=num_docs), cuda_device)
    _filter_routes_case(cuda_device, P, spec, cols, params, num_docs, route)


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["wide", "rows"])
@pytest.mark.parametrize("name", WIDE_FILTERS)
def test_filter_mask_stacked_cuda_routes_match_single(cuda_device, name,
                                                      route):
    """The stacked K1 on each route against its plain version and against
    S single launches on the same route: masks and seg_matched equal,
    segments ending mid-run among them."""
    P = SHAPES[-1]
    spec, params = FILTERS[name]
    docs = [P, 5003, 17, 0, P - 777]
    segs = [_lanes(P, d, seed=50 + i) for i, d in enumerate(docs)]
    keys = tk.filter_lane_keys(spec)
    flat = _torch_cols({k: np.concatenate([c[k] for c in segs])
                        for k in keys}, cuda_device)
    per = [_torch_cols({k: c[k] for k in keys}, cuda_device) for c in segs]
    seg_docs = torch.tensor(docs, dtype=torch.int32, device=cuda_device)
    S = len(docs)
    want, want_m = tk.filter_mask_stacked_plain(P, S, spec, flat, params,
                                                seg_docs)
    tk.reset_launch_counts()
    for _ in range(ROUTE_REPEATS):
        mask, matched = tk.filter_mask_stacked(P, S, spec, flat, params,
                                               seg_docs, route=route)
        torch.cuda.synchronize()
        assert torch.equal(mask, want) and torch.equal(matched, want_m)
    assert tk.launch_counts()[f"filter_mask[{route}]"] == ROUTE_REPEATS
    single = torch.cat([tk.filter_mask(P, spec, c, params, d, cuda_device,
                                       route=route)
                        for c, d in zip(per, docs)])
    assert torch.equal(single, want)


#: K3 / K15 launches a case takes on each route: a race in a fold shows
#: only as a wrong bit
FOLD_REPEATS = 20


def _fold_routes(t_slots, parts, floats, ext, device, wide=False, w_total=1,
                 chunks=1):
    """The fold routes that take a table of these lanes on `device`
    (fold_route's forced choice)."""
    n_raw = sum(e[0] == "raw" for e in ext)
    caps = tk.fold_caps("dense_group_aggregate", device)
    out = []
    for route in tk.FOLD_ROUTES:
        try:
            tk.fold_route(t_slots, len(tk._part_rows(parts)), len(floats),
                          len(ext) - n_raw, n_raw, caps, wide, w_total,
                          chunks, route=route)
        except ValueError:
            continue
        out.append(route)
    return out


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
    # the route the wrapper picks, and every route forced that takes the
    # table, FOLD_REPEATS launches each
    for route in (None, *_fold_routes(g_pad, parts, [cols["x.raw"]], ext,
                                      cuda_device)):
        for _ in range(FOLD_REPEATS):
            got = tk.dense_group_aggregate(mask, keys, strides, g_pad, parts,
                                           [cols["x.raw"]], ext, route=route)
            torch.cuda.synchronize()
            for a, b in ((got[0], want[0]), (got[1], want[1]),
                         (got[3], want[3]), *zip(got[4], want[4])):
                assert torch.equal(a, b), route
            torch.testing.assert_close(got[2], want[2], rtol=1e-12, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["nested", "empty_match", "full_match"])
def test_histogram_and_reduce_cuda_match_plain(cuda_device, name):
    P = SHAPES[-1]
    spec, params = FILTERS[name]
    cols = _torch_cols(_lanes(P, P - 777, seed=5), cuda_device)
    mask = tk.filter_mask(P, spec, cols, params, P - 777, cuda_device)
    # the table route hist_table picks (shared memory or the device
    # table, by card_pad against the rows); ids >= card_pad count nowhere
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
# registers (the fused K4): the lanes and cases test_torch_groupby_mv.py and
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


#: K3's table sizes around the fold's routes (one block's shared table
#: past the old 256-slot limit, the device's); a g_pad below
#: the keys' range clips them into the last slot, a hot slot
FOLD_G_PADS = (32, 256, 512, 8192)
#: key columns of each kind K3 takes; the remaps and the join code carry
#: their runtime operand (fold_key_case)
FOLD_KEY_CASES = dict(
    KEY_CASES, ids=(("g7", "ids", 0, 7), ("b", "ids", 0, 1000)),
    idoff=(("b", "idoff", 0, 1000),), idrank=(("a", "idrank", 0, 50),),
    jcode=(("b", "jcode", 0, 1000), ("g3", "ids", 0, 3)))


def fold_key_case(name: str, g_pad: int, seed: int = 0):
    """(group spec at `g_pad`, its runtime operands in key order)."""
    from pinot_tpu.query.plan import mixed_radix_strides
    gcols = FOLD_KEY_CASES[name]
    rng = np.random.default_rng(seed)
    params = []
    for i, (_c, kind, _off, card) in enumerate(gcols):
        if kind == "mvin":
            params.append(_member(card, seed + i))
        elif kind == "idoff":
            params.append(np.int32(100))
        elif kind in ("idrank", "jcode"):
            params.append(rng.integers(0, 300, jk.pow2_bucket(card))
                          .astype(np.int32))
    return (gcols, mixed_radix_strides([g[3] for g in gcols]), g_pad,
            KEY_AGGS, 0), params


@pytest.mark.parametrize("g_pad", FOLD_G_PADS)
@pytest.mark.parametrize("case", sorted(FOLD_KEY_CASES))
def test_k3_plain_matches_jax_by_table_size(case, g_pad):
    """K3's plain version against JAX's dense group tables at every table
    size the fold's routes cover, every key kind: counts, part sums and
    extremes equal, float sums within rtol 1e-12."""
    P, num_docs = SHAPES[0], SHAPES[0] - 777
    spec, params = FILTERS["nested"]
    cols = _key_lanes(P, num_docs, seed=g_pad + len(case))
    group, extra = fold_key_case(case, g_pad, seed=len(case))
    want = _jax_outs(P, spec, list(params) + extra, (), group, cols,
                     num_docs)
    got = tk.run_segment_kernel(P, spec, (), group, None, _torch_cols(cols),
                                params, num_docs, "cpu", list(extra))
    assert set(got) == set(want)
    for k in want:
        if k.endswith(".csums"):
            np.testing.assert_allclose(got[k].numpy(), want[k], rtol=1e-12,
                                       atol=0, err_msg=k)
        else:
            np.testing.assert_array_equal(got[k].numpy(), want[k],
                                          err_msg=k)


#: fold_caps of an H100 (227 KB a block less the kernel's static shared
#: memory, 132 SMs)
H100_CAPS = (232_448 - 10_752, 132)


@pytest.mark.parametrize("t_slots,lanes,caps,kw,want", [
    # Q2.1's table (3 part lanes): one block's shared memory
    (8192, (3, 0, 0, 0), H100_CAPS, {}, "smem"),
    # K15's 512 slots with sums and extremes
    (512, (2, 1, 1, 1), H100_CAPS, {}, "smem"),
    # past one block's shared memory: the device tables
    (16384, (3, 1, 0, 0), H100_CAPS, {}, "global"),
    (65536, (3, 1, 0, 0), H100_CAPS, {}, "global"),
    (131072, (3, 0, 0, 0), H100_CAPS, {}, "global"),
    # a card whose blocks take 48 KB: Q2.1's 128 KB table does not fit
    (8192, (3, 0, 0, 0), (48 * 1024, 132), {}, "global"),
    # Q3.2's 524,288 slots, Q4.3's 2M
    (524288, (3, 0, 0, 0), H100_CAPS, {}, "global"),
    (2097152, (3, 1, 0, 0), H100_CAPS, {}, "global"),
    # several int32 part-sum chunks, or a wide launch whose pass of 512
    # docs x W_total could pass the int32 bound of a block's shared sums
    (512, (2, 0, 0, 0), H100_CAPS, {"chunks": 2}, "global"),
    (512, (2, 0, 0, 0), H100_CAPS, {"wide": True, "w_total": 8}, "smem"),
    (512, (2, 0, 0, 0), H100_CAPS, {"wide": True, "w_total": 1 << 15},
     "global"),
    (512, (0, 1, 0, 0), H100_CAPS, {"wide": True, "w_total": 1 << 15},
     "smem"),
    # too few items read for a wave of blocks of a table's worth each:
    # zeroing and merging would outweigh the fold
    (8192, (3, 0, 0, 0), H100_CAPS, {"items": 7_503_872}, "smem"),
    (8192, (3, 0, 0, 0), H100_CAPS, {"items": 8192 * 131}, "global"),
    (8192, (3, 0, 0, 0), H100_CAPS, {"items": 8192 * 8}, "global"),
    (19584, (2, 1, 1, 1), H100_CAPS, {"items": 19584}, "global"),
    (8192, (3, 0, 0, 0), H100_CAPS, {"items": 8192 * 132}, "smem"),
    # forced routes take the table whatever the items
    (512, (2, 0, 0, 0), H100_CAPS, {"route": "smem", "items": 1}, "smem"),
    (512, (2, 0, 0, 0), H100_CAPS, {"route": "cluster"}, ValueError),
    (512, (2, 0, 0, 0), H100_CAPS, {"route": "global"}, "global"),
    (512, (2, 0, 0, 0), H100_CAPS, {"route": "legacy"}, ValueError),
    (65536, (3, 1, 0, 0), H100_CAPS, {"route": "smem"}, ValueError),
    (524288, (3, 0, 0, 0), H100_CAPS, {"route": "global"}, "global"),
    (512, (2, 0, 0, 0), H100_CAPS, {"route": "smem", "chunks": 3},
     ValueError),
])
def test_fold_route_picks_by_fit(t_slots, lanes, caps, kw, want):
    if want is ValueError:
        with pytest.raises(ValueError):
            tk.fold_route(t_slots, *lanes, caps, **kw)
        return
    assert tk.fold_route(t_slots, *lanes, caps, **kw) == want


def test_fold_slice_bytes_is_the_kernels_layout():
    # float64 sums and raw extremes, int32 count / parts / id extremes;
    # slots rounded up to 32
    assert tk.fold_slice_bytes(512, 3, 0, 0, 0) == 512 * 16
    assert tk.fold_slice_bytes(100, 2, 1, 1, 1) == 128 * (16 + 16)
    assert tk.fold_slice_bytes(1, 0, 0, 0, 0) == 32 * 4


@pytest.mark.parametrize("wide", [False, True])
@pytest.mark.parametrize("with_list", [False, True])
def test_fold_tables_are_views_of_one_buffer(wide, with_list):
    T, L, J = 1000, 3, 2
    kinds = ["ids", "raw", "ids"]
    psums_shape = (L, T) if wide else (2, L, T)
    layout = tk.fold_layout(T, psums_shape, wide, J, kinds,
                            4097 if with_list else None)
    scratch = ["matched", "list"] if with_list else []
    names = [r[0] for r in layout]
    assert names == ["count", "psums", "csums", "ext0", "ext1", "ext2",
                     *scratch, "end"]
    t = tk._fold_tables("cpu", layout)
    want = {"count": (torch.int32, (T,)),
            "psums": (torch.int64 if wide else torch.int32, psums_shape),
            "csums": (torch.float64, (J, T)),
            "ext0": (torch.int32, (T,)), "ext1": (torch.float64, (T,)),
            "ext2": (torch.int32, (T,))}
    if with_list:
        want.update(matched=(torch.int32, ()), list=(torch.int32, (4097,)))
    assert {k: (v.dtype, tuple(v.shape)) for k, v in t.items()} == want
    # one storage, every view on an 8-byte word, no two overlapping
    storage = {v.untyped_storage().data_ptr() for v in t.values()}
    assert len(storage) == 1
    spans = sorted((v.data_ptr(), v.data_ptr() + v.numel() *
                    v.element_size()) for v in t.values())
    assert all(a % 8 == 0 for a, _ in spans)
    assert all(b <= c for (_, b), (c, _) in zip(spans, spans[1:]))
    for i, v in enumerate(t.values()):
        v.fill_(i + 1)
    for i, v in enumerate(t.values()):
        assert bool((v == i + 1).all())


def test_fold_wrappers_reject_bad_routes():
    P = 8192
    cols = _torch_cols(_lanes(P, P, seed=0))
    mask = tk.filter_mask(P, ("match_all",), cols, [], P, "cpu")
    with pytest.raises(ValueError):
        tk.dense_group_aggregate(mask, [cols["a.ids"]], [1], 64,
                                 route="shared")
    gslot = torch.zeros(64, dtype=torch.int32)
    parts = torch.zeros(1, 64, dtype=torch.int8)
    sums = torch.zeros(0, 64, dtype=torch.float64)
    with pytest.raises(ValueError):
        tk.slot_tables(gslot, 8, 64, parts, sums, route="smem_slots")
    # the routes a forced K3 / K15 takes count apart from K3's key kinds
    for name in ("dense_group_aggregate", "slot_tables"):
        nodes = tk.KERNELS[name].node_launches
        assert set(tk.FOLD_ROUTES) <= set(nodes)
    assert not set(tk.FOLD_ROUTES) & set(tk._KEY_KINDS)


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
    for route in (None, *_fold_routes(group[2], parts, [cols["x.raw"]],
                                      ext, cuda_device)):
        for _ in range(FOLD_REPEATS):
            got = tk.dense_group_aggregate(mask, keys, group[1], group[2],
                                           parts, [cols["x.raw"]], ext,
                                           route=route)
            torch.cuda.synchronize()
            for a, b in ((got[0], want[0]), (got[1], want[1]),
                         (got[3], want[3]), *zip(got[4], want[4])):
                assert torch.equal(a, b), (case, route)
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


def _k3_fold_case(name: str, device):
    """(K3 arguments, psums_wide) of the fold cases: one hot key (every
    row in one group, a NaN among the raw values), a table past one
    block's shared memory (the device route), MV keys past kWalkCombos
    (one doc's walk split over units) and the stacked int64 part sums."""
    rng = np.random.default_rng(len(name))
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
    if name == "walk_split":
        P, W = 256, tk.MAX_GROUP_COMBOS + 64
        mv = rng.integers(0, 101, (P, W)).astype(np.int8)   # 100: padding
        mask = t((rng.random(P) < 0.5).astype(np.uint8))
        key = tk.GroupKey("mvids", t(mv), card=100)
        parts = t(rng.integers(0, 128, (1, P)).astype(np.int8))
        return (mask, [key], [1], 128, [parts], [], ()), False
    P = 1 << 16
    mask = t((rng.random(P) < 0.7).astype(np.uint8))
    parts = t(rng.integers(0, 128, (2, P)).astype(np.int8))
    vals = rng.random(P) * 1e6
    ids = t(rng.integers(0, 50, P).astype(np.int8))
    raw = rng.integers(-10**9, 10**9, P).astype(np.float64)
    if name == "hot":
        raw[rng.integers(0, P, 3)] = np.nan
        key, g_pad = np.zeros(P, np.int32), 64
    elif name == "past_one_block":
        key, g_pad = rng.integers(0, 40000, P).astype(np.int32), 32768
    else:                                           # wide_stack
        key, g_pad = rng.integers(0, 300, P).astype(np.int32), 512
    ext = (("ids", ids, "min", 64), ("ids", ids, "max", 64),
           ("raw", t(raw), "max", 0), ("raw", t(raw), "min", 0))
    return (mask, [t(key)], [1], g_pad, [parts], [t(vals)], ext), \
        name == "wide_stack"


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["hot", "past_one_block", "walk_split",
                                  "wide_stack"])
def test_k3_fold_routes_cuda_match_plain(cuda_device, name):
    """Every route that takes the table, FOLD_REPEATS launches each, against
    the plain version: counts, part sums and extremes bit for bit (a NaN
    wins its group's min and max), float sums within rtol 1e-12."""
    args, wide = _k3_fold_case(name, cuda_device)
    want = tk.dense_group_aggregate_plain(*args, psums_wide=wide)
    # the slots a matched NaN lands in (one id key, stride 1)
    nan = []
    for kind, lane, _w, _c in args[6]:
        if kind == "ids":
            nan.append(None)
            continue
        hit = args[0].bool() & torch.isnan(lane)
        n = torch.zeros(args[3], dtype=torch.bool, device=cuda_device)
        n[args[1][0][hit].long().clamp(0, args[3] - 1)] = True
        nan.append(n)
    if name == "hot":
        assert all(bool(n.any()) for n in nan if n is not None)
    routes = _fold_routes(args[3], args[4], args[5], args[6], cuda_device,
                          wide, tk.group_combos(args[1]))
    if name == "past_one_block":
        assert routes == ["global"]
    tk.reset_launch_counts()
    for route in (None, *routes):
        for _ in range(FOLD_REPEATS):
            got = tk.dense_group_aggregate(*args, route=route,
                                           psums_wide=wide)
            torch.cuda.synchronize()
            for a, b in ((got[0], want[0]), (got[1], want[1]),
                         (got[3], want[3])):
                assert torch.equal(a.long(), b.long()), route
            for a, b, n in zip(got[4], want[4], nan):
                if n is None:
                    assert torch.equal(a, b), route
                else:
                    assert torch.equal(torch.isnan(a), n), route
                    assert torch.equal(a[~n], b[~n]), route
            torch.testing.assert_close(got[2], want[2], rtol=1e-12, atol=0)
    counts = tk.launch_counts()
    for route in routes:
        assert counts[f"dense_group_aggregate[{route}]"] >= FOLD_REPEATS


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
    args = (cols["b.ids"], 1024, cols["b.hllidx"], cols["b.hllrank"], 4096)
    got = tk.masked_histogram_hll(mask, *args)
    want = tk.masked_histogram_hll_plain(mask, *args)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
