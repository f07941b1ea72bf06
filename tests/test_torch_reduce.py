"""K2 masked_part_sums and K5 masked_reduce against the JAX package.

The plain versions (what the wrappers run for a CPU tensor) are held to
the JAX device functions on operands made from a seed with numpy, under
masks whose matched bytes are not 1 (2, 127, 255: any nonzero byte is a
match, and the JAX side takes the same mask as bool): `_part_sums` (one
reduce below 2^31 / 127 rows, int32 block partials past it, which the
port gives as part_sum_range row ranges), `_chunked_float_sum` and
`_agg_outputs` with K2's part sums and K5's count, min / max and block
sums over every id and raw dtype and MV id lanes, for empty, full and
random matches. Integers and min / max are equal (min / max in the JAX
dtype too, but for MV lanes: int32 in the port, as for single-value ids);
float64 block sums agree to rtol 1e-12 (both sides sum in
float64, in different orders). The route choice (word_route) is tested
here too. Tests marked `cuda` hold every route of the CUDA kernels,
single, stacked and batched, to the plain versions bit for bit, 20
launches a case, and skip where there is no card.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pinot_tpu.ops import kernels as jk
from pinot_tpu_torch.ops import kernels as tk
from pinot_tpu_torch.segment.loader import int_part_table

BLOCK = tk.BLOCK
WEIGHTS = (2, 127, 255)
MATCHES = ("random", "empty", "full")
#: id lanes (dtype, cardinality); raw lanes by dtype
ID_LANES = {"i8": (np.int8, 50), "i16": (np.int16, 1000),
            "i32": (np.int32, 40000)}
RAW_DTYPES = {"ri32": np.int32, "ri64": np.int64, "rf32": np.float32,
              "rf64": np.float64}
#: MV id lanes (dtype, cardinality, width)
MV_LANES = {"m8": (np.int8, 10, 3), "m16": (np.int16, 700, 1)}
ROUTE_REPEATS = 20


def _mask(P: int, match: str, weight, seed: int) -> np.ndarray:
    """uint8 [P]: matched rows hold `weight` (or 2-255 by row for
    weight None), the others 0."""
    rng = np.random.default_rng(seed)
    hit = {"random": rng.random(P) < 0.3, "empty": np.zeros(P, bool),
           "full": np.ones(P, bool)}[match]
    w = np.full(P, weight, np.uint8) if weight else \
        (np.arange(P) % 254 + 2).astype(np.uint8)
    return np.where(hit, w, 0).astype(np.uint8)


def _parts(P: int, n_metrics: int, seed: int) -> list:
    """[n_parts, P] int8 part lanes of `n_metrics` integer metrics."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_metrics):
        values = np.unique(rng.integers(0, 2**20, 300)).astype(np.int64)
        n_parts = -(-int(values[-1] - values[0]).bit_length() // 7)
        table = int_part_table(values, n_parts, int(values[0]))
        out.append(np.ascontiguousarray(
            table[:, rng.integers(0, len(values), P)]))
    return out


def _lanes(P: int, seed: int, nan: bool = False) -> dict:
    rng = np.random.default_rng(seed)
    cols = {}
    for c, (dt, card) in ID_LANES.items():
        cols[f"{c}.ids"] = rng.integers(0, card, P).astype(dt)
    for c, dt in RAW_DTYPES.items():
        if np.issubdtype(dt, np.integer):
            lo, hi = (-2**40, 2**40) if dt == np.int64 else (-5000, 5000)
            cols[f"{c}.raw"] = rng.integers(lo, hi, P).astype(dt)
        else:
            v = ((rng.random(P) - 0.5) * 1e6).astype(dt)
            if nan:
                v[rng.integers(0, P, 3)] = np.nan
            cols[f"{c}.raw"] = v
    for c, (dt, card, w) in MV_LANES.items():
        mv = rng.integers(0, card, (P, w)).astype(dt)
        width = rng.integers(1, w + 1, P)
        mv[np.arange(w)[None, :] >= width[:, None]] = card   # padding
        cols[f"{c}.mv"] = mv
    for i, p in enumerate(_parts(P, 2, seed + 1)):
        cols[f"p{i}.parts"] = p
    return cols


#: K2 (two part-sum metrics) and every K5 request: ids min / max at each
#: id width, raw sums and extremes at each raw dtype, MV min / max
AGG_SPECS = (("count", "*", "none", None),
             ("sum", "p0", "sv", ("parts", 1024)),
             ("avg", "p1", "sv", ("parts", 1024)),
             ("min", "i8", "sv", ("ids", 64)),
             ("minmaxrange", "i16", "sv", ("ids", 1024)),
             ("max", "i32", "sv", ("ids", 65536)),
             ("sum", "ri32", "raw", None),
             ("minmaxrange", "ri32", "raw", None),
             ("avg", "ri64", "raw", None),
             ("min", "ri64", "raw", None),
             ("sum", "rf32", "raw", None),
             ("minmaxrange", "rf32", "raw", None),
             ("avg", "rf64", "raw", None),
             ("max", "rf64", "raw", None),
             ("minmaxrange", "m8", "mv", (16, 10)),
             ("min", "m16", "mv", (1024, 700)))


#: the MV specs' outputs: JAX keeps an MV lane's narrow dtype for its min
#: / max, the port returns int32 as for single-value ids (equal values)
MV_OUTS = tuple(f"agg{i}." for i, s in enumerate(AGG_SPECS) if s[2] == "mv")


def _assert_outputs_match(got: dict, want: dict) -> None:
    assert set(want) <= set(got)
    for k in want:
        g = got[k].numpy()
        if k.endswith(".vsum"):
            np.testing.assert_allclose(g, want[k], rtol=1e-12, atol=0,
                                       err_msg=k)
        else:
            if k.endswith((".min", ".max")) and not k.startswith(MV_OUTS):
                assert g.dtype == want[k].dtype, k
            np.testing.assert_array_equal(g, want[k], err_msg=k)


@pytest.mark.parametrize("P", (8192, 16384))
@pytest.mark.parametrize("match", MATCHES)
@pytest.mark.parametrize("weight", WEIGHTS)
def test_agg_outputs_plain_match_jax_under_weighted_masks(P, match, weight):
    cols = _lanes(P, seed=P + weight)
    mask = _mask(P, match, weight, seed=7)
    want = jk._agg_outputs(AGG_SPECS, {k: jnp.asarray(v)
                                       for k, v in cols.items()},
                           jnp.asarray(mask != 0), P)
    want = {k: np.asarray(v) for k, v in want.items()}
    got = tk._agg_outputs(torch.from_numpy(mask), AGG_SPECS,
                          {k: torch.from_numpy(v) for k, v in cols.items()})
    _assert_outputs_match(got, want)
    assert int(got["stats.num_docs_matched"]) == int((mask != 0).sum())
    if match == "empty":
        assert int(got["agg3.min"]) == 64 and int(got["agg5.max"]) == -1
        assert float(got["agg9.min"]) == np.inf


@pytest.mark.parametrize("match", MATCHES)
@pytest.mark.parametrize("weight", WEIGHTS)
@pytest.mark.parametrize("segments", (1, 3))
def test_part_sums_plain_match_jax_under_weighted_masks(match, weight,
                                                        segments):
    P = 8192
    parts = _parts(P * segments, 2, seed=weight)
    mask = _mask(P * segments, match, weight, seed=segments)
    lanes = [torch.from_numpy(p) for p in parts]
    got = tk.masked_part_sums(torch.from_numpy(mask), lanes,
                              seg_rows=P if segments > 1 else None)
    combined = np.concatenate(parts, 0)
    for s in range(segments):
        rows = slice(s * P, (s + 1) * P)
        sums, reduced = jk._part_sums(jnp.asarray(combined[:, rows]),
                                      jnp.asarray(mask[rows] != 0))
        assert reduced
        row = got if segments == 1 else got[s]
        np.testing.assert_array_equal(row[:-1].numpy(), np.asarray(sums))
        assert int(row[-1]) == int((mask[rows] != 0).sum())


def test_part_sums_past_the_int32_bound_match_jax():
    # 2,065 blocks: 127 * P >= 2^31, so JAX returns int32 block partials
    # and the port one exact row a part_sum_range (413 blocks), R = 5
    P = 2065 * BLOCK
    assert 127 * P >= 2**31
    per = tk.part_sum_range(P)
    assert per == 413 * BLOCK and P // per == 5
    rng = np.random.default_rng(3)
    parts = np.full((2, P), 127, np.int8)
    parts[1] = rng.integers(0, 128, P).astype(np.int8)
    mask = np.where(rng.random(P) < 0.97, 255, 0).astype(np.uint8)
    got = tk.masked_part_sums(torch.from_numpy(mask),
                              [torch.from_numpy(parts)])
    assert got.shape == (5, 3) and got.dtype == torch.int32
    sums, reduced = jk._part_sums(jnp.asarray(parts), jnp.asarray(mask != 0))
    assert not reduced
    want = np.asarray(sums).astype(np.int64).reshape(2, 5, -1).sum(-1)
    np.testing.assert_array_equal(got[:, :2].numpy().T, want)
    np.testing.assert_array_equal(
        got[:, 2].numpy(), (mask != 0).reshape(5, -1).sum(-1))
    # every range's sum stays below 2^31 at the bound's worst lane
    assert int(got[:, 0].max()) <= 127 * per < 2**31


REDUCE_CASES = {
    **{f"ids {c}": (f"{c}.ids", "ids", 2 ** (card.bit_length()), None)
       for c, (_dt, card) in ID_LANES.items()},
    **{f"raw {c}": (f"{c}.raw", "raw", 0, None) for c in RAW_DTYPES},
    **{f"mv {c}": (f"{c}.mv", "ids", 2 ** (card.bit_length()), card)
       for c, (_dt, card, _w) in MV_LANES.items()},
}


def _jax_reduce(lane, kind, card_pad, card, mask):
    """JAX's min / max of `_agg_outputs` and `_chunked_float_sum`."""
    m = jnp.asarray(mask != 0)
    v = jnp.asarray(lane)
    if card is not None:
        m = m[:, None] & (v < card)
    if kind == "ids":
        ids = v.astype(jnp.int32)
        out = {"min": jnp.where(m, ids, card_pad).min(),
               "max": jnp.where(m, ids, -1).max()}
    else:
        out = {"min": jnp.where(m, v, jnp.inf).min(),
               "max": jnp.where(m, v, -jnp.inf).max()}
    if card is None:
        out["sums"] = jk._chunked_float_sum(v, jnp.asarray(mask != 0))
    return {k: np.asarray(x) for k, x in out.items()}


@pytest.mark.parametrize("case", sorted(REDUCE_CASES))
@pytest.mark.parametrize("match", MATCHES)
@pytest.mark.parametrize("weight", WEIGHTS)
def test_reduce_plain_matches_jax_under_weighted_masks(case, match, weight):
    P = 16384
    key, kind, card_pad, card = REDUCE_CASES[case]
    cols = _lanes(P, seed=weight, nan=match == "random" and weight == 127)
    mask = _mask(P, match, weight, seed=11)
    want_sum = card is None
    got = tk.masked_reduce(torch.from_numpy(mask),
                           torch.from_numpy(cols[key]), kind, card_pad,
                           want_sum, card)
    want = _jax_reduce(cols[key], kind, card_pad, card, mask)
    for k in ("min", "max"):
        g = got[k].numpy()
        # an MV lane's: int32 in the port, the lane's dtype in JAX
        assert g.dtype == (np.int32 if card is not None else want[k].dtype)
        np.testing.assert_array_equal(g, want[k], err_msg=k)
    assert int(got["count"]) == int((mask != 0).sum())
    if want_sum:
        np.testing.assert_allclose(got["sums"].numpy(), want["sums"],
                                   rtol=1e-12, atol=0)


@pytest.mark.parametrize("offset", (0, 1, 8, 16))
@pytest.mark.parametrize("forced", (None, "vector", "bytes", "words"))
def test_word_route_choice(offset, forced):
    buf = torch.zeros(4096 + 32, dtype=torch.uint8)
    base = buf[(16 - buf.data_ptr() % 16) % 16:]      # 16-byte aligned
    aligned = base[:4096]
    view = base[offset:offset + 4096]
    want = "vector" if offset % 16 == 0 else "bytes"
    if forced == "words" or (forced == "vector" and want == "bytes"):
        with pytest.raises(ValueError):
            tk.word_route([aligned, view], forced)
        return
    assert tk.word_route([aligned, view], forced) == (forced or want)
    assert tk.word_route([aligned], forced) == (forced or "vector")


def test_wrappers_take_routes_on_the_cpu():
    """A forced route is checked on the CPU too, then the plain version
    answers; an operand off a 16-byte boundary refuses "vector"."""
    P = 8192
    cols = _lanes(P, seed=1)
    mask = torch.from_numpy(_mask(P, "random", None, seed=2))
    buf = torch.zeros(P + 32, dtype=torch.uint8)
    start = (16 - buf.data_ptr() % 16) % 16 + 1
    off = buf[start:start + P]
    off.copy_(mask)
    parts = [torch.from_numpy(cols["p0.parts"])]
    want = tk.masked_part_sums_plain(mask, parts)
    for route in (None, "bytes"):
        assert torch.equal(tk.masked_part_sums(off, parts, route=route), want)
        assert torch.equal(tk.masked_part_sums_batched(
            torch.stack([mask, off]), parts, route=route),
            torch.stack([want, want]))
    lane = torch.from_numpy(cols["rf64.raw"])
    ref = tk.masked_reduce_plain(mask, lane, "raw", 0, True)
    got = tk.masked_reduce(off, lane, "raw", 0, True, route="bytes")
    assert all(torch.equal(got[k], ref[k]) for k in ref)
    with pytest.raises(ValueError):
        tk.masked_part_sums(off, parts, route="vector")
    with pytest.raises(ValueError):
        tk.masked_reduce(off, lane, "raw", 0, True, route="vector")


# ---------------------------------------------------------------------------
# On the card: every route of K2 and K5 against the plain version
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _offset_view(t: torch.Tensor) -> torch.Tensor:
    """A copy of `t` one element past a 16-byte boundary (one byte for a
    byte lane, the least a wider lane's view can be moved)."""
    n = t.numel() * t.element_size()
    buf = torch.zeros(n + 32, dtype=torch.uint8, device=t.device)
    start = (16 - buf.data_ptr() % 16) % 16 + t.element_size()
    raw = buf[start:start + n]
    raw.copy_(t.contiguous().reshape(-1).view(torch.uint8))
    return raw.view(t.dtype).reshape(t.shape)


def _same(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal values and dtype, NaNs equal."""
    return a.dtype == b.dtype and a.shape == b.shape and bool(
        ((a == b) | (a.isnan() & b.isnan()) if a.is_floating_point()
         else a == b).all())


def _routes(*operands):
    picked = tk.word_route(operands)
    return [None, "bytes"] + (["vector"] if picked == "vector" else [])


def _counted(name, route, fn):
    """fn() with the launch counts from 0: its result, after checking it
    launched `name` once on the route asked (the picked one for None)."""
    tk.reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    counts = tk.launch_counts()
    taken = [r for r in tk.WORD_ROUTES if counts[f"{name}[{r}]"]]
    assert counts[name] == 1 and len(taken) == 1, counts
    if route is not None:
        assert taken == [route]
    return out


K2_LAYOUTS = ("single", "stacked3", "batched1", "batched3", "batched8")


@pytest.mark.cuda
@pytest.mark.parametrize("P", (256, 8192))
@pytest.mark.parametrize("layout", K2_LAYOUTS)
@pytest.mark.parametrize("match", MATCHES + ("offset",))
def test_part_sums_routes_cuda_match_plain(cuda_device, P, layout, match):
    S = 3 if layout == "stacked3" else 1
    B = int(layout[7:]) if layout.startswith("batched") else 0
    rows = P * S
    parts = [torch.from_numpy(p).to(cuda_device)
             for p in _parts(rows, 3, seed=P)]
    masks = torch.from_numpy(np.stack([
        _mask(rows, "random" if match == "offset" else match, None, seed=b)
        for b in range(max(B, 1))])).to(cuda_device)
    if match == "offset":
        parts = [_offset_view(p) for p in parts]
    if B:
        name = "masked_part_sums_batched"
        want = tk.masked_part_sums_batched_plain(masks, parts)

        def run(route):
            return tk.masked_part_sums_batched(masks, parts, route=route)
        singles = [tk.masked_part_sums(m, parts) for m in masks]
    else:
        name, mask = "masked_part_sums", masks[0]
        seg = P if S > 1 else None
        want = tk.masked_part_sums_plain(mask, parts, seg)

        def run(route):
            return tk.masked_part_sums(mask, parts, seg, route=route)
        singles = None
    routes = _routes(masks, *[p[k] for p in parts for k in range(p.shape[0])])
    assert ("vector" in routes) == (match != "offset")
    for route in routes:
        for _ in range(ROUTE_REPEATS):
            got = _counted(name, route, lambda: run(route))
            assert torch.equal(got, want), route
    if singles is not None:
        assert torch.equal(run(None), torch.stack(singles))
    if match == "offset":
        with pytest.raises(ValueError):
            run("vector")


K5_LAYOUTS = ("single", "stacked3", "batched1", "batched3", "batched8")
#: (case, match): NaN rows only in a float lane
K5_MATCHES = [(c, m) for c in sorted(REDUCE_CASES)
              for m in ("random", "empty", "nan", "offset")
              if m != "nan" or REDUCE_CASES[c][0].startswith("rf")]


@pytest.mark.cuda
@pytest.mark.parametrize("case,match", K5_MATCHES)
@pytest.mark.parametrize("layout", K5_LAYOUTS)
def test_reduce_routes_cuda_match_plain(cuda_device, case, layout, match):
    key, kind, card_pad, card = REDUCE_CASES[case]
    S = 3 if layout == "stacked3" else 1
    B = int(layout[7:]) if layout.startswith("batched") else 0
    P = 8192 * S if S > 1 else 16384
    lane = torch.from_numpy(_lanes(P, seed=5, nan=match == "nan")[key]).to(
        cuda_device)
    if match == "offset":
        lane = _offset_view(lane)
    masks = torch.from_numpy(np.stack([
        _mask(P, "empty" if match == "empty" else "random", None, seed=b)
        for b in range(max(B, 1))])).to(cuda_device)
    want_sum = card is None
    args = (kind, card_pad, want_sum, card)
    if B:
        name = "masked_reduce_batched"
        want = tk.masked_reduce_batched_plain(masks, lane, *args)

        def run(route):
            return tk.masked_reduce_batched(masks, lane, *args, route=route)
    else:
        name = "masked_reduce"
        want = tk.masked_reduce_plain(masks[0], lane, *args)

        def run(route):
            return tk.masked_reduce(masks[0], lane, *args, route=route)
    routes = _routes(masks, lane)
    assert ("vector" in routes) == (match != "offset")
    first = None
    for route in routes:
        for _ in range(ROUTE_REPEATS):
            got = _counted(name, route, lambda: run(route))
            for k in ("min", "max", "count"):
                assert _same(got[k], want[k]), (route, k)
            if want_sum:
                torch.testing.assert_close(got["sums"], want["sums"],
                                           rtol=1e-12, atol=0,
                                           equal_nan=True)
                # one summation order: every launch and route bit-equal
                first = got["sums"] if first is None else first
                assert torch.equal(got["sums"].view(torch.int64),
                                   first.view(torch.int64)), route
    if not want_sum:
        return
    if B:
        singles = [tk.masked_reduce(m, lane, *args)["sums"] for m in masks]
        assert torch.equal(first.view(torch.int64),
                           torch.stack(singles).view(torch.int64))
    elif S > 1:
        per = [tk.masked_reduce(masks[0][s * 8192:(s + 1) * 8192],
                                lane[s * 8192:(s + 1) * 8192], *args)["sums"]
               for s in range(S)]
        assert torch.equal(first.view(torch.int64),
                           torch.cat(per).view(torch.int64))
