"""K4 masked_histogram, and its fused HLL form, against the JAX package.

The plain versions (what the wrappers run for a CPU tensor) are held to
the JAX device functions on operands made from a seed with numpy, under
masks whose matched bytes are not 1 (2, 127, 255: any nonzero byte is a
match, and the JAX side takes the same mask as bool), for empty, full
and random matches: the single-value histogram against `_histogram`
(its one-hot matrix products up to DENSE_CARD_LIMIT and its scatter-add
above) over int8, int16 and int32 lanes; the MV entry histogram and its
total against the `_agg_outputs` MV branch; the batched form member by
member and the stacked form (flat rows) as the sum of the segments'
histograms; the fused form's histogram and registers against the
`_agg_outputs` "hll" branch, bit for bit. `_agg_outputs` with
DISTINCTCOUNT and DISTINCTCOUNTHLL on one column makes one fused call
and equals JAX's outputs. Counts are equal in value (JAX returns int64
counts for card_pad <= 128 under x64, the port int32). The route choices
(word_route on misaligned views, hist_table by fit) are tested
here too. Tests marked `cuda` hold every word route and table route of
every form to the plain versions bit for bit, 20 launches a case, and
skip where there is no card.
"""
from __future__ import annotations

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pinot_tpu.ops import kernels as jk
from pinot_tpu_torch.ops import kernels as tk
from pinot_tpu_torch.segment.loader import hll_tables_padded

WEIGHTS = (2, 127, 255)
MATCHES = ("random", "empty", "full")
#: id lanes (dtype, cardinality, card_pad): card_pad on both sides of
#: DENSE_CARD_LIMIT (32,768)
ID_LANES = {"i8": (np.int8, 50, 64), "i16": (np.int16, 1000, 1024),
            "i32": (np.int32, 40000, 65536),
            "i32d": (np.int32, 20000, jk.DENSE_CARD_LIMIT)}
#: MV id lanes (dtype, cardinality, card_pad, width)
MV_LANES = {"m8": (np.int8, 10, 16, 3), "m16": (np.int16, 700, 1024, 1),
            "m32": (np.int32, 50, 64, 4)}
#: HyperLogLog registers of the fused form's cases
M = 4096
ROUTE_REPEATS = 20


def _mask(P: int, match: str, weight, seed: int) -> np.ndarray:
    """uint8 [P]: matched rows hold `weight` (or 2-255 by row for weight
    None), the others 0."""
    rng = np.random.default_rng(seed)
    hit = {"random": rng.random(P) < 0.3, "empty": np.zeros(P, bool),
           "full": np.ones(P, bool)}[match]
    w = np.full(P, weight, np.uint8) if weight else \
        (np.arange(P) % 254 + 2).astype(np.uint8)
    return np.where(hit, w, 0).astype(np.uint8)


@functools.lru_cache(maxsize=None)
def _lanes(P: int, seed: int) -> dict:
    """Id lanes (a few ids hot, as dimension columns are), MV lanes with
    padding entries, and the HLL tables of each id lane's dictionary."""
    rng = np.random.default_rng(seed)
    cols = {}
    for c, (dt, card, card_pad) in ID_LANES.items():
        ids = rng.integers(0, card, P)
        hot = rng.random(P) < 0.5
        ids[hot] = rng.integers(0, min(card, 8), int(hot.sum()))
        cols[f"{c}.ids"] = ids.astype(dt)
        idx, rank = hll_tables_padded(
            np.array([f"{c}_{i:05d}" for i in range(card)]))
        assert idx.shape == (card_pad,)
        cols[f"{c}.hllidx"], cols[f"{c}.hllrank"] = idx, rank
    for c, (dt, card, _cp, w) in MV_LANES.items():
        mv = rng.integers(0, card, (P, w)).astype(dt)
        width = rng.integers(1, w + 1, P)
        mv[np.arange(w)[None, :] >= width[:, None]] = card   # padding
        cols[f"{c}.mv"] = mv
    return cols


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


def _jax_hist(cols: dict, col: str, card_pad: int, mask: np.ndarray):
    return np.asarray(jk._histogram({f"{col}.ids": jnp.asarray(
        cols[f"{col}.ids"])}, col, card_pad, jnp.asarray(mask != 0)))


@pytest.mark.parametrize("col", sorted(ID_LANES))
@pytest.mark.parametrize("match", MATCHES)
@pytest.mark.parametrize("weight", WEIGHTS)
def test_histogram_plain_matches_jax(col, match, weight):
    P = 8192
    cols = _lanes(P, seed=3)
    mask = _mask(P, match, weight, seed=weight)
    card_pad = ID_LANES[col][2]
    want = _jax_hist(cols, col, card_pad, mask)
    got = tk.masked_histogram(_t(mask), _t(cols[f"{col}.ids"]), card_pad)
    assert got.dtype == torch.int32 and got.shape == (card_pad,)
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(got, tk.masked_histogram_plain(
        _t(mask), _t(cols[f"{col}.ids"]), card_pad))


@pytest.mark.parametrize("col", sorted(MV_LANES))
@pytest.mark.parametrize("match", MATCHES)
@pytest.mark.parametrize("weight", WEIGHTS)
def test_entry_histogram_plain_matches_jax(col, match, weight):
    P = 8192
    cols = _lanes(P, seed=4)
    mask = _mask(P, match, weight, seed=weight + 1)
    _dt, card, card_pad, _w = MV_LANES[col]
    specs = (("distinctcount", col, "mv", (card_pad, card)),
             ("countmv", col, "mv", (card_pad, card)))
    want = jk._agg_outputs(specs, {f"{col}.mv": jnp.asarray(
        cols[f"{col}.mv"])}, jnp.asarray(mask != 0), P)
    hist, total = tk.masked_entry_histogram(_t(mask), _t(cols[f"{col}.mv"]),
                                            card_pad, card)
    np.testing.assert_array_equal(hist.numpy(), np.asarray(want["agg0"]))
    assert total.dim() == 0 and int(total) == int(want["agg1"])


@pytest.mark.parametrize("match", MATCHES)
@pytest.mark.parametrize("B", (1, 3, 8))
def test_batched_plain_matches_jax_member_by_member(match, B):
    P = 8192
    cols = _lanes(P, seed=5)
    masks = np.stack([_mask(P, match, None, seed=b) for b in range(B)])
    for col in ("i8", "i32"):
        card_pad = ID_LANES[col][2]
        got = tk.masked_histogram_batched(_t(masks), _t(cols[f"{col}.ids"]),
                                          card_pad)
        assert got.shape == (B, card_pad)
        for b in range(B):
            np.testing.assert_array_equal(
                got[b].numpy(), _jax_hist(cols, col, card_pad, masks[b]))
    _dt, card, card_pad, _w = MV_LANES["m8"]
    hist, total = tk.masked_entry_histogram_batched(
        _t(masks), _t(cols["m8.mv"]), card_pad, card)
    for b in range(B):
        want = tk.masked_entry_histogram(_t(masks[b]), _t(cols["m8.mv"]),
                                         card_pad, card)
        assert torch.equal(hist[b], want[0]) and torch.equal(total[b],
                                                             want[1])


@pytest.mark.parametrize("segments", (2, 3))
def test_stacked_flat_rows_sum_the_segments_jax_histograms(segments):
    """The stacked form is K4 over the flat [S * P] rows: the sum of each
    segment's JAX histogram."""
    P = 8192
    lanes = [_lanes(P, seed=10 + s) for s in range(segments)]
    masks = [_mask(P, "random", None, seed=s) for s in range(segments)]
    for col in ("i16", "i32d"):
        card_pad = ID_LANES[col][2]
        flat = np.concatenate([c[f"{col}.ids"] for c in lanes])
        got = tk.masked_histogram(_t(np.concatenate(masks)), _t(flat),
                                  card_pad)
        want = sum(_jax_hist(c, col, card_pad, m).astype(np.int64)
                   for c, m in zip(lanes, masks))
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("col", ("i8", "i16", "i32"))
@pytest.mark.parametrize("match", MATCHES)
@pytest.mark.parametrize("weight", WEIGHTS)
def test_fused_hll_plain_matches_jax_branch(col, match, weight):
    """Histogram and registers of the fused form, bit for bit the JAX
    `_agg_outputs` "hll" branch (and its histogram)."""
    P = 8192
    cols = _lanes(P, seed=6)
    mask = _mask(P, match, weight, seed=weight + 2)
    card_pad = ID_LANES[col][2]
    specs = (("hll", col, "sv", ("hll", card_pad, M)),
             ("distinctcount", col, "sv", ("hist", card_pad)))
    jcols = {k: jnp.asarray(v) for k, v in cols.items()
             if k.startswith(f"{col}.")}
    want = jk._agg_outputs(specs, jcols, jnp.asarray(mask != 0), P)
    hist, regs = tk.masked_histogram_hll(
        _t(mask), _t(cols[f"{col}.ids"]), card_pad,
        _t(cols[f"{col}.hllidx"]), _t(cols[f"{col}.hllrank"]), M)
    assert regs.dtype == torch.int32 and regs.shape == (M,)
    np.testing.assert_array_equal(regs.numpy(), np.asarray(want["agg0.hll"]))
    np.testing.assert_array_equal(hist.numpy(), np.asarray(want["agg1"]))
    if match == "empty":
        assert not regs.any()
    masks = np.stack([mask, _mask(P, "random", None, seed=9)])
    bh, br = tk.masked_histogram_hll_batched(
        _t(masks), _t(cols[f"{col}.ids"]), card_pad,
        _t(cols[f"{col}.hllidx"]), _t(cols[f"{col}.hllrank"]), M)
    assert torch.equal(bh[0], hist) and torch.equal(br[0], regs)


def test_agg_outputs_share_one_fused_launch(monkeypatch):
    """DISTINCTCOUNT and DISTINCTCOUNTHLL on one column: one fused call,
    no plain histogram call, outputs equal to JAX's."""
    P = 8192
    cols = _lanes(P, seed=7)
    mask = _mask(P, "random", 127, seed=3)
    card_pad = ID_LANES["i16"][2]
    specs = (("distinctcount", "i16", "sv", ("hist", card_pad)),
             ("hll", "i16", "sv", ("hll", card_pad, M)),
             ("percentile", "i16", "sv", ("hist", card_pad)),
             ("hll", "i8", "sv", ("hll", 64, M)))
    calls = {"fused": 0, "hist": 0}
    fused, hist = tk.masked_histogram_hll, tk.masked_histogram

    def count_fused(*a, **k):
        calls["fused"] += 1
        return fused(*a, **k)

    def count_hist(*a, **k):
        calls["hist"] += 1
        return hist(*a, **k)

    monkeypatch.setattr(tk, "masked_histogram_hll", count_fused)
    monkeypatch.setattr(tk, "masked_histogram", count_hist)
    got = tk._agg_outputs(_t(mask), specs, {k: _t(v) for k, v in cols.items()})
    assert calls == {"fused": 2, "hist": 0}
    want = jk._agg_outputs(specs, {k: jnp.asarray(v) for k, v in cols.items()},
                           jnp.asarray(mask != 0), P)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)


@pytest.mark.parametrize("offset", (0, 1, 16))
@pytest.mark.parametrize("forced", (None, "vector", "bytes"))
def test_word_route_of_misaligned_views(offset, forced):
    """K4 reads 16-byte words: a mask view off a 16-byte boundary, or a
    batch whose rows a member are not a multiple of 16, takes "bytes"; a
    forced "vector" there raises, and the plain version answers."""
    P = 4096
    cols = _lanes(P, seed=8)
    ids = _t(cols["i8.ids"])
    mask = _t(_mask(P, "random", None, seed=1))
    buf = torch.zeros(P + 32, dtype=torch.uint8)
    start = (16 - buf.data_ptr() % 16) % 16 + offset
    view = buf[start:start + P]
    view.copy_(mask)
    want = tk.masked_histogram_plain(mask, ids, 64)
    picked = "vector" if offset % 16 == 0 else "bytes"
    assert tk.word_route([view, ids]) == picked
    if forced == "vector" and picked == "bytes":
        with pytest.raises(ValueError):
            tk.masked_histogram(view, ids, 64, route=forced)
        with pytest.raises(ValueError):
            tk.masked_histogram_hll(
                view, ids, 64, _t(cols["i8.hllidx"]),
                _t(cols["i8.hllrank"]), M, route=forced)
    else:
        assert torch.equal(tk.masked_histogram(view, ids, 64, route=forced),
                           want)
    # two members of P - 8 rows: member 1 starts off the boundary
    masks = torch.stack([mask[:P - 8], mask[8:]])
    assert tk.word_route([masks, ids[:P - 8]],
                         aligned=(P - 8) % 16 == 0) == "bytes"
    if forced == "vector":
        with pytest.raises(ValueError):
            tk.masked_histogram_batched(masks, ids[:P - 8].clone(), 64,
                                        route=forced)
    with pytest.raises(ValueError):
        tk.masked_histogram(mask, ids, 64, table="shared")


#: (card_pad, room bytes, forced table) -> table or ValueError
TABLE_CASES = [
    (32, 232_448, None, "smem"),             # baseball teamID
    (1024, 232_448, None, "smem"),           # playerName
    (16384, 232_448, None, "smem"),          # 10,000 ids: 64 KB
    (58112, 232_448, None, "smem"),          # the room to the byte
    (65536, 232_448, None, "global"),        # past the room
    (65536, 232_448, "smem", ValueError),
    (131072, 232_448, None, "global"),       # 100,000 ids
    (64, 232_448, "global", "global"),
    (64, 232_448, "smem", "smem"),
    (64, 232_448, "tiles", ValueError),
    (16384, 49_152, None, "global"),         # a card with 48 KB a block
    (12288, 49_152, None, "smem"),
]


@pytest.mark.parametrize("card_pad,room,forced,want", TABLE_CASES)
def test_table_route_by_fit(card_pad, room, forced, want):
    if want is ValueError:
        with pytest.raises(ValueError):
            tk.hist_table(card_pad, room, forced)
    else:
        assert tk.hist_table(card_pad, room, forced) == want


def test_route_counters_cover_every_route():
    for name in ("masked_histogram", "masked_histogram_batched"):
        nodes = tk.KERNELS[name].node_launches
        assert set(tk.WORD_ROUTES) | set(tk.HIST_TABLES) | {"hll"} <= \
            set(nodes)
    assert "hll_registers" not in tk.KERNELS


# ---------------------------------------------------------------------------
# On the card: every route of K4 against the plain version
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _offset_view(t: torch.Tensor) -> torch.Tensor:
    """A copy of `t` one element past a 16-byte boundary."""
    n = t.numel() * t.element_size()
    buf = torch.zeros(n + 32, dtype=torch.uint8, device=t.device)
    start = (16 - buf.data_ptr() % 16) % 16 + t.element_size()
    raw = buf[start:start + n]
    raw.copy_(t.contiguous().reshape(-1).view(torch.uint8))
    return raw.view(t.dtype).reshape(t.shape)


def _routes(masks, lane, rows: int, card_pad: int, device):
    """Every (word route, table) a forced call takes on these operands,
    and None (the picked ones)."""
    words = ["bytes"] + (["vector"] if tk.word_route(
        [masks, lane], aligned=masks.dim() == 1 or masks.shape[0] == 1 or
        masks.shape[-1] % 16 == 0) == "vector" else [])
    tables = ["global"]
    try:
        tk.hist_table(card_pad, tk.hist_room(device), "smem")
        tables.append("smem")
    except ValueError:
        pass
    return [(None, None)] + [(w, t) for w in words for t in tables]


def _same(got, want) -> bool:
    if isinstance(want, tuple):
        return all(_same(g, w) for g, w in zip(got, want))
    return got.dtype == want.dtype and got.shape == want.shape and \
        torch.equal(got, want)


def _check_routes(name, run, want, routes, hll: bool) -> None:
    """run(route, table) against `want` ROUTE_REPEATS times a route, each
    launch counted once on the routes asked."""
    for route, table in routes:
        for _ in range(ROUTE_REPEATS):
            tk.reset_launch_counts()
            got = run(route, table)
            torch.cuda.synchronize()
            counts = tk.launch_counts()
            taken = [r for r in (*tk.WORD_ROUTES, *tk.HIST_TABLES)
                     if counts[f"{name}[{r}]"]]
            assert counts[name] == 1 and len(taken) == 2, counts
            assert counts[f"{name}[hll]"] == hll
            if route is not None:
                assert taken == [route, table]
            assert _same(got, want), (route, table)


#: (P, case): rows a member (one not a multiple of 16), the lane and mask
CUDA_CASES = [(P, case) for P in (8192, 8200)
              for case in ("i8", "i16", "i32", "m8", "m16", "m32",
                           "weighted", "empty", "full", "offset")]


def _cuda_operands(P, case, device, B=1):
    cols = _lanes(P, seed=P)
    col = case if case in ID_LANES or case in MV_LANES else "i16"
    match = {"empty": "empty", "full": "full"}.get(case, "random")
    weight = None if case == "weighted" else 1
    masks = torch.from_numpy(np.stack([_mask(P, match, weight, seed=b)
                                       for b in range(B)])).to(device)
    key = f"{col}.mv" if col in MV_LANES else f"{col}.ids"
    lane = torch.from_numpy(cols[key]).to(device)
    if case == "offset":
        lane = _offset_view(lane)
    hll = None if col in MV_LANES else (
        torch.from_numpy(cols[f"{col}.hllidx"]).to(device),
        torch.from_numpy(cols[f"{col}.hllrank"]).to(device))
    return col, masks, lane, hll


@pytest.mark.cuda
@pytest.mark.parametrize("P,case", CUDA_CASES)
def test_single_routes_cuda_match_plain(cuda_device, P, case):
    col, masks, lane, hll = _cuda_operands(P, case, cuda_device)
    mask = masks[0]
    if col in MV_LANES:
        _dt, card, card_pad, _w = MV_LANES[col]
        want = tk.masked_entry_histogram_plain(mask, lane, card_pad, card)

        def run(route, table):
            return tk.masked_entry_histogram(mask, lane, card_pad, card,
                                             route=route, table=table)
        _check_routes("masked_histogram", run, want,
                      _routes(mask, lane, P, card_pad, cuda_device), False)
        return
    card_pad = ID_LANES[col][2]
    routes = _routes(mask, lane, P, card_pad, cuda_device)
    want = tk.masked_histogram_plain(mask, lane, card_pad)
    _check_routes("masked_histogram", lambda r, t: tk.masked_histogram(
        mask, lane, card_pad, route=r, table=t), want, routes, False)
    want = tk.masked_histogram_hll_plain(mask, lane, card_pad, *hll, M)
    _check_routes("masked_histogram", lambda r, t: tk.masked_histogram_hll(
        mask, lane, card_pad, *hll, M, route=r, table=t), want, routes, True)


@pytest.mark.cuda
@pytest.mark.parametrize("B", (1, 3, 8))
@pytest.mark.parametrize("P,case", [(8192, c) for c in
                                    ("i8", "i32", "m8", "weighted")] +
                         [(8200, "i16")])
def test_batched_routes_cuda_match_plain(cuda_device, B, P, case):
    col, masks, lane, hll = _cuda_operands(P, case, cuda_device, B)
    name = "masked_histogram_batched"
    if col in MV_LANES:
        _dt, card, card_pad, _w = MV_LANES[col]
        want = tk.masked_entry_histogram_batched_plain(masks, lane, card_pad,
                                                       card)
        _check_routes(name, lambda r, t: tk.masked_entry_histogram_batched(
            masks, lane, card_pad, card, route=r, table=t), want,
            _routes(masks, lane, P, card_pad, cuda_device), False)
        return
    card_pad = ID_LANES[col][2]
    routes = _routes(masks, lane, P, card_pad, cuda_device)
    want = tk.masked_histogram_batched_plain(masks, lane, card_pad)
    _check_routes(name, lambda r, t: tk.masked_histogram_batched(
        masks, lane, card_pad, route=r, table=t), want, routes, False)
    want = tk.masked_histogram_hll_batched_plain(masks, lane, card_pad, *hll,
                                                 M)
    _check_routes(name, lambda r, t: tk.masked_histogram_hll_batched(
        masks, lane, card_pad, *hll, M, route=r, table=t), want, routes,
        True)
    single = torch.stack([tk.masked_histogram(m, lane, card_pad)
                          for m in masks])
    assert torch.equal(tk.masked_histogram_batched(masks, lane, card_pad),
                       single)


@pytest.mark.cuda
@pytest.mark.parametrize("card_pad", (16, 1024, 16384))
def test_stacked_and_hot_ids_cuda_match_plain(cuda_device, card_pad):
    """Flat rows of 3 segments of 65,536 (the stacked form), a mask of
    bytes 2-255, ids hot on few values (a block's table copies, one a
    warp for small tables) and, at 16,384 bins, a lane whose ids span the
    table; both table routes."""
    rows = 3 * 65536
    rng = np.random.default_rng(card_pad)
    ids = rng.integers(0, card_pad, rows)
    ids[rng.random(rows) < 0.7] = 3                  # one hot id
    dt = torch.int8 if card_pad <= 64 else torch.int16
    lane = torch.from_numpy(ids).to(dt).to(cuda_device)
    mask = torch.from_numpy(_mask(rows, "random", None, seed=4)).to(
        cuda_device)
    idx, rank = (torch.from_numpy(t).to(cuda_device) for t in
                 hll_tables_padded(np.arange(card_pad - 1)))
    routes = _routes(mask, lane, rows, card_pad, cuda_device)
    want = tk.masked_histogram_hll_plain(mask, lane, card_pad, idx, rank, M)
    _check_routes("masked_histogram", lambda r, t: tk.masked_histogram_hll(
        mask, lane, card_pad, idx, rank, M, route=r, table=t), want, routes,
        True)
