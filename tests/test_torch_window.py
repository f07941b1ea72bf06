"""Window functions on the port against the JAX package.

1. Kernels: the window of K12 radix_sort + K13 window_scan (their plain
   versions, ops/kernels.py:run_window_kernel) against the JAX
   build_window_kernel jitted on the CPU, bit for bit on win.perm,
   win.rn and every win.sum<j> over the whole padded width: n_pad 8 to
   65,536, 0-3 order keys ascending and descending (negative ~code
   keys), heavy ties, rows past num_rows; and one case whose global
   int32 prefix passes 2^31 while every partition's sum fits. K12 alone
   against numpy's stable lexsort (int32 and int64 keys, negatives,
   payloads, valid_rows), K13 alone against a numpy reference, and
   K13's plain version against the JAX kernel on one partition, all
   singletons, starts at the 2,048-row tile edges +- 1 and a prefix past
   2^31.
2. The window stage: the port's execute_window (plain versions on the
   CPU, and the numpy twin) against the JAX execute_window(use_device=
   True) and its twin, bit-identical on every output column: integer
   partitions, string partitions with DESC order, the per-partition
   overflow bound; the typed errors (float SUM argument, int32 overflow,
   mixed frames, the row cap); execute_window_stage over blocks
   published in two ExchangeManagers.

K12's cluster route as a numpy model (cluster_sort.cuh's per-CTA counts,
digit-major / CTA-minor offsets and warp-by-warp stable ranks) against
np.lexsort and the JAX window kernel's permutation: 1 to 65,536 rows,
int32 and int64, 1-8 key lanes, all-equal keys, valid_rows < n.

`cuda` tests hold K12 on both routes (1 to 65,537 rows, 0 / 1 / 8
payloads, 20 repeats a case, the route counters, no host wait) and K13
(1 to 2^22 + 3 rows, four partition patterns, 0 / 1 / 8 / 9 lanes, 20
repeats a case) to their plain versions on the card, and the card's
window stage to the CPU's; they skip where there is no card.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from pinot_tpu.ops import kernels as jk
from pinot_tpu.pql.parser import compile_pql as jax_compile
from pinot_tpu.query.stages import window as jax_window
from pinot_tpu_torch.common.datatable import DataTable
from pinot_tpu_torch.ops import kernels as tk
from pinot_tpu_torch.pql.parser import compile_pql
from pinot_tpu_torch.query.blocks import IntermediateResultsBlock
from pinot_tpu_torch.query.stages import exchange as xmod
from pinot_tpu_torch.query.stages import window as wmod
from pinot_tpu_torch.query.stages.errors import StageCompileError


def _window_lanes(n_pad, num_rows, n_order, n_sums, seed, n_parts=13,
                  ties=8, big=False):
    """int32 lanes as execute_window pads them: partition codes, order
    keys (even ones DESC as ~code), value lanes; zeros past num_rows."""
    rng = np.random.default_rng(seed)
    part = np.zeros(n_pad, np.int32)
    part[:num_rows] = rng.integers(0, n_parts, num_rows)
    orders = []
    for j in range(n_order):
        code = rng.integers(0, ties, num_rows).astype(np.int32)
        o = np.zeros(n_pad, np.int32)
        o[:num_rows] = ~code if j % 2 == 0 else code
        orders.append(o)
    sums = []
    for j in range(n_sums):
        v = np.zeros(n_pad, np.int32)
        v[:num_rows] = np.full(num_rows, 2_000_000, np.int32) if big else \
            rng.integers(-50_000, 50_000, num_rows)
        sums.append(v)
    return part, orders, sums


def _jax_window(part, orders, sums, num_rows):
    outs = jk.run_window_kernel(part, tuple(orders), tuple(sums), num_rows)
    return {k: np.asarray(v) for k, v in outs.items()}


def _port_window(part, orders, sums, num_rows, device="cpu"):
    t = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    outs = tk.run_window_kernel(t(part), [t(o) for o in orders],
                                [t(v) for v in sums], num_rows)
    return {k: v.cpu().numpy() for k, v in outs.items()}


def _assert_bits(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == np.int32, k
        np.testing.assert_array_equal(got[k], want[k].astype(np.int32),
                                      err_msg=k)


# ---------------------------------------------------------------------------
# 1. kernels
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_order", [0, 1, 2, 3])
@pytest.mark.parametrize("n_pad,num_rows", [(8, 5), (1024, 1000),
                                            (65536, 40000)])
def test_window_kernel_plain_matches_jax_bit_for_bit(n_pad, num_rows,
                                                     n_order):
    part, orders, sums = _window_lanes(n_pad, num_rows, n_order, 2,
                                       seed=n_pad + n_order)
    _assert_bits(_port_window(part, orders, sums, num_rows),
                 _jax_window(part, orders, sums, num_rows))


def test_window_kernel_global_prefix_passes_2_31():
    """100 partitions of 2,000,000 a row: the global int32 prefix passes
    2^31 (JAX's cumsum wraps), every partition's sum fits; the port
    gives the same bits."""
    n_pad, num_rows = 4096, 2000
    part, orders, sums = _window_lanes(n_pad, num_rows, 1, 1, seed=5,
                                       n_parts=100, big=True)
    assert int(sums[0].astype(np.int64).sum()) >= 2 ** 31
    per = np.bincount(part[:num_rows],
                      weights=sums[0][:num_rows].astype(np.int64))
    assert per.max() < 2 ** 31
    got = _port_window(part, orders, sums, num_rows)
    _assert_bits(got, _jax_window(part, orders, sums, num_rows))
    # and it is each partition's own running sum
    perm = got["win.perm"][:num_rows]
    sp = part[perm]
    for g in np.unique(sp)[:5]:
        rows = np.nonzero(sp == g)[0]
        np.testing.assert_array_equal(
            got["win.sum0"][rows],
            np.cumsum(sums[0][perm[rows]].astype(np.int64)))


@pytest.mark.parametrize("dtype", [np.int32, np.int64])
@pytest.mark.parametrize("valid", [None, 700])
def test_radix_sort_plain_is_a_stable_lexsort(dtype, valid):
    rng = np.random.default_rng(7)
    n = 1000
    big = 2 ** 40 if dtype == np.int64 else 2 ** 30
    k0 = rng.integers(-3, 3, n).astype(dtype)
    k1 = rng.integers(-big, big, n).astype(dtype)
    k1[::7] = k1[0]                              # ties
    pay = rng.integers(-9, 9, n).astype(np.int32)
    perm, (s0, s1), (sp,) = tk.radix_sort(
        [torch.from_numpy(k0), torch.from_numpy(k1)],
        [torch.from_numpy(pay)], valid)
    iota = np.arange(n)
    keys = [iota, k1, k0]
    if valid is not None:
        keys.append(iota >= valid)
    want = np.lexsort(tuple(keys))
    np.testing.assert_array_equal(perm.numpy(), want)
    np.testing.assert_array_equal(s0.numpy(), k0[want])
    np.testing.assert_array_equal(s1.numpy(), k1[want])
    np.testing.assert_array_equal(sp.numpy(), pay[want])
    assert perm.dtype == torch.int32


#: cluster_sort.cuh: threads of a CTA (32 warps), rows a lane holds in a
#: pass, CTAs of a cluster
SORT_THREADS, SORT_ITEMS, SORT_MAX_CTAS = 1024, 8, 8
SORT_WARPS = SORT_THREADS // 32


def _sort_ctas(n):
    c = 1
    while c < SORT_MAX_CTAS and c * SORT_THREADS < n:
        c <<= 1
    return c


def _flipped_bits(lane):
    """A key lane's bits with the sign flipped, as uint64 (unsigned order
    equals the signed order)."""
    if lane.dtype == np.int64:
        return lane.view(np.uint64) ^ np.uint64(1 << 63)
    return (lane.view(np.uint32) ^ np.uint32(1 << 31)).astype(np.uint64)


def _cluster_pass(perm, digit, chunk, warp_rows):
    """One pass of cluster_sort.cuh as the kernel computes it: each
    position's (CTA, warp, step, lane), per-warp counts turned into offsets
    within the CTA, per-CTA counts summed over the cluster digit-major and
    CTA-minor, a warp's running count over its steps and a lane's peers in
    lower lanes (__match_any_sync). Returns the permutation after the
    pass."""
    n = perm.shape[0]
    n_ctas = -(-n // chunk)
    pos = np.arange(n)
    cta = pos // chunk
    warp = (pos - cta * chunk) // warp_rows
    gwarp = cta * SORT_WARPS + warp                 # a warp of the cluster
    group = pos // 32                               # one step of one warp
    assert (((pos - cta * chunk) % warp_rows) // 32 < SORT_ITEMS).all()
    d = digit[perm].astype(np.int64)
    # per-warp counts -> offsets inside the CTA, per-CTA counts
    wc = np.zeros((n_ctas * SORT_WARPS, 256), np.int64)
    np.add.at(wc, (gwarp, d), 1)
    wc = wc.reshape(n_ctas, SORT_WARPS, 256)
    warp_off = np.cumsum(wc, axis=1) - wc
    cta_count = wc.sum(axis=1)                      # [n_ctas, 256]
    total = cta_count.sum(axis=0)
    before = np.cumsum(cta_count, axis=0) - cta_count
    base = (np.cumsum(total) - total)[None, :] + before
    # a warp's running count of each digit over its earlier steps
    steps = np.zeros((group.max() + 1, 256), np.int64)
    np.add.at(steps, (group, d), 1)
    run = np.cumsum(steps, axis=0) - steps          # over every earlier step
    warp_start = (cta * chunk + warp * warp_rows) // 32   # the warp's 1st
    running = run[group, d] - run[warp_start, d]
    # peers in lower lanes of the same step
    pad = np.full(((n + 31) // 32) * 32, -1, np.int64)
    pad[:n] = d
    g = pad.reshape(-1, 32)
    eq = (g[:, :, None] == g[:, None, :]) & \
        np.tril(np.ones((32, 32), bool), -1)[None, :, :]
    lower = eq.sum(axis=2).reshape(-1)[:n]
    dest = base[cta, d] + warp_off[cta, warp, d] + running + lower
    assert np.array_equal(np.sort(dest), pos), "not a permutation"
    out = np.empty_like(perm)
    out[dest] = perm
    return out


def _runs(v):
    """The runs of consecutive set bits of v, lowest first: (shift, len)."""
    out, t = [], 0
    while v:
        while not (v >> t) & 1:
            t += 1
        n = 0
        while (v >> (t + n)) & 1:
            n += 1
        out.append((t, n))
        v &= ~(((1 << n) - 1) << t)
        t += n
    return out


def cluster_sort_model(lanes, valid_rows=None):
    """numpy model of K12's cluster route (cluster_sort.cuh): the bits
    that vary over the cluster (each CTA's OR / AND, combined); where
    they and the valid bit above them number at most 64, each row's
    varying bits packed into a 64-bit key (the last lane's lowest, runs of
    consecutive bits kept together) and one _cluster_pass per 8 bits of
    it; else one pass per varying byte, the least significant of the last
    lane first, then the one-bit valid pass. Returns (perm, passes run,
    packed, the byte passes it would take unpacked)."""
    n = lanes[0].shape[0]
    assert n <= SORT_MAX_CTAS * SORT_THREADS * SORT_ITEMS
    n_ctas = _sort_ctas(n)
    chunk = (-(-n // n_ctas) + 31) & ~31
    warp_rows = (-(-chunk // SORT_WARPS) + 31) & ~31
    assert warp_rows <= 32 * SORT_ITEMS
    bits = [_flipped_bits(lane) for lane in lanes]
    valid = valid_rows is not None and valid_rows < n
    iota = np.arange(n)
    cut = valid_rows if valid else n

    def or_and(b, rows):
        o, a = np.uint64(0), ~np.uint64(0)
        for c in range(n_ctas):                      # each CTA's words
            part = b[c * chunk:(c + 1) * chunk][rows[c * chunk:(c + 1) *
                                                     chunk]]
            if part.size:
                o |= np.bitwise_or.reduce(part)
                a &= np.bitwise_and.reduce(part)
        return int(o), int(a)

    groups = [[or_and(b, iota < cut), or_and(b, iota >= cut)] for b in bits]
    # split: the rows past valid_rows share one key, so only the valid
    # rows' bits are packed
    split = valid and all(g[1][0] == g[1][1] for g in groups)
    runs, byte_passes, pos = [], [], 0
    for lane in reversed(range(len(lanes))):
        (vo, va), (io, ia) = groups[lane]
        every = (vo | io) & ~(va & ia)
        varies = vo & ~va if split else every
        width = 64 if lanes[lane].dtype == np.int64 else 32
        byte_passes += [(lane, sh) for sh in range(0, width, 8)
                        if (every >> sh) & 0xFF]
        for shift, length in _runs(varies):
            runs.append((lane, shift, length, pos))
            pos += length
    if valid:
        byte_passes.append((-1, 0))
        valid_bit, pos = pos, pos + 1
    packed = pos <= 64
    perm = np.arange(n, dtype=np.int64)
    if packed:
        key = np.zeros(n, np.uint64)
        for lane, shift, length, at in runs:
            mask = np.uint64((1 << length) - 1)
            key |= ((bits[lane] >> np.uint64(shift)) & mask) << np.uint64(at)
        if split:
            key[cut:] = 0
        if valid:
            key |= (iota >= valid_rows).astype(np.uint64) << np.uint64(
                valid_bit)
        passes = -(-pos // 8)
        for j in range(passes):
            digit = (key >> np.uint64(8 * j)) & np.uint64(0xFF)
            perm = _cluster_pass(perm, digit, chunk, warp_rows)
        return perm, passes, packed, len(byte_passes)
    for lane, shift in byte_passes:
        digit = (iota >= valid_rows).astype(np.uint64) if lane < 0 else \
            (bits[lane] >> np.uint64(shift)) & np.uint64(0xFF)
        perm = _cluster_pass(perm, digit, chunk, warp_rows)
    return perm, len(byte_passes), packed, len(byte_passes)


def _sort_lanes(n, dtype, n_lanes, seed, equal=False):
    """n_lanes key lanes: the last (least significant) over a wide range,
    the others over narrow ones (ties), negatives included."""
    rng = np.random.default_rng(seed)
    wide = 2 ** 40 if dtype == np.int64 else 2 ** 30
    lanes = []
    for j in range(n_lanes):
        if equal:
            lanes.append(np.full(n, -7, dtype))
            continue
        r = wide if j == n_lanes - 1 else (3, 100, 70000)[j % 3]
        lanes.append(rng.integers(-r, r, n).astype(dtype))
    return lanes


@pytest.mark.parametrize("dtype", [np.int32, np.int64])
@pytest.mark.parametrize("n", [1, 4095, 8192, 8193, 19584, 32768, 65536])
def test_cluster_sort_model_is_a_stable_lexsort(n, dtype):
    """K12's cluster pass (per-CTA counts, digit-major / CTA-minor
    offsets, a warp-by-warp stable rank) gives np.lexsort's permutation:
    1, 2 and 8 key lanes, all-equal keys, valid_rows < n."""
    for n_lanes, equal, valid in ((1, False, None), (2, False, n - n // 3),
                                  (8, False, None), (3, True, n // 2)):
        lanes = _sort_lanes(n, dtype, n_lanes, seed=n + n_lanes, equal=equal)
        perm, passes, packed, _bytes = cluster_sort_model(lanes, valid)
        keys = [np.arange(n)] + lanes[::-1]
        if valid is not None:
            keys.append(np.arange(n) >= valid)
        np.testing.assert_array_equal(perm, np.lexsort(tuple(keys)))
        if equal:          # no bit varies: only the valid bit's pass runs
            assert packed and passes == (valid is not None and valid < n)
        if valid is not None and valid < n:   # padding rows of one key
            lanes = [np.concatenate([x[:valid], np.full(n - valid, x[0])])
                     for x in lanes]
            perm, _p, _k, _b = cluster_sort_model(lanes, valid)
            keys = [np.arange(n)] + lanes[::-1] + [np.arange(n) >= valid]
            np.testing.assert_array_equal(perm, np.lexsort(tuple(keys)))
        if n_lanes == 8 and n > 1:    # 8 lanes of varying bytes: unpacked
            assert not packed
        got = tk.radix_sort_plain([torch.from_numpy(x) for x in lanes], [],
                                  valid)[0]
        np.testing.assert_array_equal(got.numpy(), perm)


@pytest.mark.parametrize("n", [1, 4095, 8193, 19584, 65536])
def test_cluster_sort_model_equals_the_jax_window_sort(n):
    """The model over the window's lanes (partition codes, an ASC and a
    DESC ~code order key, rows past num_rows) is the JAX window kernel's
    win.perm."""
    num_rows = max(1, n - n // 5)
    part, orders, sums = _window_lanes(n, num_rows, 2, 1, seed=n)
    perm, passes, packed, byte_passes = cluster_sort_model(
        [part] + orders, num_rows)
    want = _jax_window(part, orders, sums, num_rows)["win.perm"]
    np.testing.assert_array_equal(perm, want)
    # the padding rows share one key: 13 partition codes (4 bits), an ASC
    # code and a DESC ~code of 8 values (3 bits each) and the valid bit,
    # 11 bits in 2 passes, where whole bytes (the ~code lane against the
    # padding's 0 varies in all 4) take 7
    assert packed and (n < 5 or (passes, byte_passes) == (2, 7))


SCAN_TILE = 2048          # sort_window.cu: rows of one K13 tile
SCAN_PATTERNS = ("one", "singletons", "tile_edges", "random")


def _scan_case(n, pattern, n_lanes, seed):
    """A sorted partition lane sp int32 [n] of one pattern (one partition
    over every row; every row its own; starts at each 2,048-row tile edge
    and one row either side; random sorted codes) and n_lanes value lanes.
    Lane 0 holds values in [2^29, 2^30): its whole-array prefix passes
    2^31 from the 5th row; the others are signed in [-2^30, 2^30)."""
    rng = np.random.default_rng(seed)
    if pattern == "one":
        sp = np.zeros(n, np.int32)
    elif pattern == "singletons":
        sp = np.arange(n, dtype=np.int32)
    elif pattern == "tile_edges":
        new = np.zeros(n, bool)
        for edge in range(0, n + SCAN_TILE, SCAN_TILE):
            new[[i for i in (edge - 1, edge, edge + 1) if 0 <= i < n]] = True
        sp = np.cumsum(new).astype(np.int32)
    else:
        sp = np.sort(rng.integers(0, max(1, n // 50), n)).astype(np.int32)
    vals = [rng.integers(2 ** 29, 2 ** 30, n).astype(np.int32) if j == 0
            else rng.integers(-2 ** 30, 2 ** 30, n).astype(np.int32)
            for j in range(n_lanes)]
    return sp, vals


@pytest.mark.parametrize("n", [2047, 2048, 2049])
@pytest.mark.parametrize("pattern", SCAN_PATTERNS[:3] + ("prefix_past_2_31",))
def test_window_scan_plain_matches_jax_on_edge_shapes(n, pattern):
    """K13's plain version against the JAX build_window_kernel's rn and
    sums on sp lanes that are sorted already (the JAX sort keeps them in
    place): one partition, all singletons, starts at the 2,048-row tile
    edges +- 1, and a whole-array prefix past 2^31 with every partition's
    own sum inside int32. These are the shapes the `cuda` test holds K13
    to this plain version on."""
    if pattern == "prefix_past_2_31":
        sp = np.repeat(np.arange(n // 4 + 1, dtype=np.int32), 4)[:n]
        vals = [np.full(n, 2 ** 29, np.int32),
                np.random.default_rng(n).integers(-2 ** 20, 2 ** 20, n)
                .astype(np.int32)]
        assert int(vals[0].astype(np.int64).sum()) >= 2 ** 31
    else:
        sp, vals = _scan_case(n, pattern, 2, seed=n)
    want = _jax_window(sp, [], vals, n)
    np.testing.assert_array_equal(want["win.perm"], np.arange(n))
    rn, run = tk.window_scan_plain(torch.from_numpy(sp),
                                   [torch.from_numpy(v) for v in vals])
    np.testing.assert_array_equal(rn.numpy(), want["win.rn"])
    for j, r in enumerate(run):
        np.testing.assert_array_equal(r.numpy(), want[f"win.sum{j}"])


def test_window_scan_plain_matches_numpy():
    rng = np.random.default_rng(9)
    n = 5000
    sp = np.sort(rng.integers(0, 40, n)).astype(np.int32)
    v = rng.integers(-2 ** 20, 2 ** 20, n).astype(np.int32)
    rn, (run,) = tk.window_scan(torch.from_numpy(sp), [torch.from_numpy(v)])
    for g in np.unique(sp):
        rows = np.nonzero(sp == g)[0]
        np.testing.assert_array_equal(rn.numpy()[rows],
                                      np.arange(1, len(rows) + 1))
        np.testing.assert_array_equal(run.numpy()[rows],
                                      np.cumsum(v[rows].astype(np.int64)))


def test_window_kernel_operand_checks():
    with pytest.raises(TypeError):
        tk.radix_sort([torch.zeros(8, dtype=torch.float32)])
    with pytest.raises(ValueError):
        tk.radix_sort([torch.zeros(8, dtype=torch.int32)] * 9)
    with pytest.raises(ValueError):
        tk.window_scan(torch.zeros(8, dtype=torch.int32),
                       [torch.zeros(7, dtype=torch.int32)])


# ---------------------------------------------------------------------------
# 2. the window stage
# ---------------------------------------------------------------------------


def _window_request(sum_col="v"):
    return (f"SELECT g, o, ROW_NUMBER() OVER (PARTITION BY g ORDER BY o), "
            f"SUM({sum_col}) OVER (PARTITION BY g ORDER BY o) FROM t "
            f"LIMIT 100000")


def _both(pql, cols, n):
    """{name: block} of the port (plain versions, numpy twin) and of JAX
    (device, twin) over the same columns."""
    req, jreq = compile_pql(pql), jax_compile(pql)
    return {"port_device": wmod.execute_window(req, dict(cols), n,
                                               device="cpu"),
            "port_host": wmod.execute_window(req, dict(cols), n,
                                             use_device=False),
            "jax_device": jax_window.execute_window(jreq, dict(cols), n,
                                                    use_device=True),
            "jax_host": jax_window.execute_window(jreq, dict(cols), n,
                                                  use_device=False)}


def _assert_same_blocks(blocks):
    want = blocks["jax_device"]
    for name, blk in blocks.items():
        assert blk.selection_columns == want.selection_columns, name
        for a, b in zip(blk.selection_cols, want.selection_cols):
            a, b = np.asarray(a), np.asarray(b)
            assert a.dtype == b.dtype, name
            assert np.array_equal(a, b), name


def test_window_stage_int_partitions_matches_jax():
    rng = np.random.default_rng(11)
    n = 3000
    cols = {"g": rng.integers(0, 13, n).astype(np.int64),
            "o": rng.integers(0, 500, n).astype(np.int64),
            "v": rng.integers(-50, 50, n).astype(np.int64)}
    blocks = _both(_window_request(), cols, n)
    _assert_same_blocks(blocks)
    dcols = dict(zip(blocks["port_device"].selection_columns,
                     blocks["port_device"].selection_cols))
    g, rn, run = dcols["g"], dcols["row_number()_over"], dcols["sum(v)_over"]
    for gv in np.unique(g):
        rows = np.nonzero(g == gv)[0]
        assert rn[rows].tolist() == list(range(1, len(rows) + 1))
        assert (np.diff(dcols["o"][rows]) >= 0).all()
        assert run[rows][-1] == cols["v"][cols["g"] == gv].sum()


def test_window_stage_string_partition_and_desc_order():
    n = 500
    rng = np.random.default_rng(3)
    cols = {"g": np.array([f"t{int(i)}" for i in rng.integers(0, 4, n)],
                          dtype=object),
            "o": rng.integers(0, 50, n).astype(np.int64),
            "v": rng.integers(0, 9, n).astype(np.int64)}
    pql = ("SELECT g, o, ROW_NUMBER() OVER (PARTITION BY g ORDER BY o "
           "DESC), SUM(v) OVER (PARTITION BY g ORDER BY o DESC) FROM t "
           "LIMIT 100000")
    blocks = _both(pql, cols, n)
    want = blocks["jax_device"]
    for name, blk in blocks.items():
        for a, b in zip(blk.selection_cols, want.selection_cols):
            assert np.array_equal(np.asarray(a, dtype=object),
                                  np.asarray(b, dtype=object)), name
    g = np.asarray(blocks["port_device"].selection_cols[0], dtype=object)
    o = np.asarray(blocks["port_device"].selection_cols[1])
    for gv in np.unique(g):
        assert (np.diff(o[g == gv]) <= 0).all()


def test_window_stage_two_order_keys_no_partition():
    rng = np.random.default_rng(21)
    n = 2500
    cols = {"d_year": rng.integers(1992, 1999, n).astype(np.int32),
            "lo_revenue": rng.integers(100, 10_000, n).astype(np.int64) * 100,
            "lo_quantity": rng.integers(1, 51, n).astype(np.int32)}
    pql = ("SELECT d_year, lo_quantity, ROW_NUMBER() OVER (ORDER BY d_year, "
           "lo_revenue), SUM(lo_quantity) OVER (ORDER BY d_year, lo_revenue) "
           "FROM lineorderj LIMIT 65536")
    _assert_same_blocks(_both(pql, cols, n))


def test_window_stage_per_partition_overflow_bound():
    """The int32 guard is per partition: a global abs-sum past 2^31 with
    every partition within runs, bit-identical to JAX; one partition
    past the bound is a typed error."""
    n = 2000
    rng = np.random.default_rng(5)
    cols = {"g": np.arange(n) % 100,
            "o": rng.integers(0, 9, n).astype(np.int64),
            "v": np.full(n, 2_000_000, dtype=np.int64)}
    assert int(np.abs(cols["v"]).sum()) >= 2 ** 31
    _assert_same_blocks(_both(_window_request(), cols, n))
    cols["g"] = np.zeros(n, dtype=np.int64)
    with pytest.raises(StageCompileError):
        wmod.execute_window(compile_pql(_window_request()), dict(cols), n,
                            device="cpu")


def test_window_typed_errors():
    req = compile_pql(_window_request())
    cols = {"g": np.zeros(4, np.int64), "o": np.arange(4),
            "v": np.ones(4, np.float64)}
    with pytest.raises(StageCompileError):              # float argument
        wmod.execute_window(req, cols, 4, device="cpu")
    cols["v"] = np.full(4, 2 ** 40, dtype=np.int64)
    with pytest.raises(StageCompileError):              # int32 overflow
        wmod.execute_window(req, cols, 4, device="cpu")
    mixed = compile_pql(
        "SELECT g, ROW_NUMBER() OVER (PARTITION BY g ORDER BY o), "
        "SUM(v) OVER (ORDER BY o) FROM t LIMIT 10")
    with pytest.raises(StageCompileError):              # mixed frames
        wmod.execute_window(mixed, {"g": np.zeros(1, np.int64),
                                    "o": np.zeros(1, np.int64),
                                    "v": np.zeros(1, np.int64)}, 1,
                            device="cpu")
    with pytest.raises(StageCompileError):              # the row cap
        wmod.execute_window(req, {}, wmod.WINDOW_CAP + 1, device="cpu")


def test_window_stage_over_published_blocks():
    """execute_window_stage fetches every source in (server, id) order,
    concatenates the columns and runs the window: equal to
    execute_window over the columns in that order."""
    rng = np.random.default_rng(17)
    pql = _window_request()
    req = compile_pql(pql)
    parts, managers, sources = [], [], []
    for i, n in enumerate((700, 300)):
        cols = {"g": rng.integers(0, 5, n).astype(np.int64),
                "o": rng.integers(0, 40, n).astype(np.int64),
                "v": rng.integers(-9, 9, n).astype(np.int64)}
        parts.append(cols)
        blk = IntermediateResultsBlock(selection_cols=[cols[c] for c in
                                                       ("g", "o", "v")],
                                       selection_columns=["g", "o", "v"])
        m = xmod.ExchangeManager()
        m.put(f"w.{i}", DataTable.from_block(req, blk).to_bytes())
        managers.append(m)
        sources.append({"server": f"Server_{i}", "xkey": m.xkey,
                        "id": f"w.{i}"})
    try:
        got = wmod.execute_window_stage(req, sources[::-1], device="cpu")
        cat = {c: np.concatenate([p[c] for p in parts]) for c in parts[0]}
        want = wmod.execute_window(req, cat, 1000, use_device=False)
        assert got.stats.num_docs_scanned == 1000
        for a, b in zip(got.selection_cols, want.selection_cols):
            assert np.array_equal(np.asarray(a), np.asarray(b))
    finally:
        for m in managers:
            m.close()


# ---------------------------------------------------------------------------
# 3. on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n_order", [0, 1, 3])
@pytest.mark.parametrize("n_pad,num_rows", [(8, 5), (4096, 4096),
                                            (65536, 40000)])
def test_window_kernel_cuda_matches_plain(cuda_device, n_pad, num_rows,
                                          n_order):
    part, orders, sums = _window_lanes(n_pad, num_rows, n_order, 2,
                                       seed=3 * n_pad + n_order)
    tk.reset_launch_counts()
    got = _port_window(part, orders, sums, num_rows, cuda_device)
    counts = tk.launch_counts()
    assert counts["radix_sort"] == 1 and counts["window_scan"] == 1
    assert counts["radix_sort[cluster]"] == 1
    _assert_bits(got, _port_window(part, orders, sums, num_rows))


@pytest.mark.cuda
def test_window_kernel_cuda_global_prefix_passes_2_31(cuda_device):
    part, orders, sums = _window_lanes(4096, 2000, 1, 1, seed=5,
                                       n_parts=100, big=True)
    _assert_bits(_port_window(part, orders, sums, 2000, cuda_device),
                 _port_window(part, orders, sums, 2000))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.int32, np.int64])
def test_radix_sort_cuda_matches_plain(cuda_device, dtype):
    rng = np.random.default_rng(13)
    n = 65536
    big = 2 ** 40 if dtype == np.int64 else 2 ** 30
    keys = [rng.integers(-big, big, n).astype(dtype),
            rng.integers(0, 4, n).astype(dtype)]
    pay = [rng.integers(-9, 9, n).astype(np.int32) for _ in range(3)]
    for valid in (None, 50000):
        outs = {}
        for dev in ("cpu", cuda_device):
            perm, sk, sp = tk.radix_sort(
                [torch.from_numpy(k).to(dev) for k in keys],
                [torch.from_numpy(p).to(dev) for p in pay], valid)
            outs[str(dev)] = [perm.cpu()] + [t.cpu() for t in sk + sp]
        for a, b in zip(outs["cpu"], outs[str(cuda_device)]):
            assert torch.equal(a, b)


SORT_CUDA_REPEATS = 20    # a race between CTAs shows only as a wrong row


def _route_lanes(n, dtype, seed):
    """Two key lanes whose high bytes never vary (a narrow lane of codes
    and one below 2^20, negatives included) and 8 payload lanes."""
    rng = np.random.default_rng(seed)
    keys = [rng.integers(0, 13, n).astype(dtype),
            rng.integers(-2 ** 20, 2 ** 20, n).astype(dtype)]
    pay = [rng.integers(-2 ** 31, 2 ** 31 - 1, n).astype(np.int32)
           for _ in range(8)]
    return keys, pay


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.int32, np.int64])
@pytest.mark.parametrize("n", [1, 2, 4096, 8193, 65535, 65536, 65537])
def test_radix_sort_cuda_routes_match_plain(cuda_device, n, dtype):
    """K12 on both routes ("cluster" up to 65,536 rows, "passes" at any
    n) equal to its plain version: 0, 1 and 8 payloads, valid_rows < n
    (the rows past it of any keys, and all zeros), keys whose high bytes
    never vary; every case 20 times, and the route counters name the
    route that ran."""
    base_keys, pay = _route_lanes(n, dtype, seed=n)
    tpay = [torch.from_numpy(p).to(cuda_device) for p in pay]
    routes = ("cluster", "passes") if n <= tk.SORT_CLUSTER_ROWS else \
        ("passes",)
    for n_pay, valid, pad in ((0, None, False), (1, n - n // 3, False),
                              (8, n // 2, False), (2, n - n // 3, True)):
        # pad: the rows past valid_rows zeros, as the window pads them
        keys = [np.where(np.arange(n) < valid, k, 0).astype(dtype)
                for k in base_keys] if pad else base_keys
        tkeys = [torch.from_numpy(k).to(cuda_device) for k in keys]
        want = tk.radix_sort_plain([torch.from_numpy(k) for k in keys],
                                   [torch.from_numpy(p)
                                    for p in pay[:n_pay]], valid)
        want = [want[0]] + want[1] + want[2]
        for route in routes:
            for _ in range(SORT_CUDA_REPEATS):
                tk.reset_launch_counts()
                perm, sk, sp = tk.radix_sort(tkeys, tpay[:n_pay], valid,
                                             route=route)
                counts = tk.launch_counts()
                assert counts["radix_sort"] == 1
                assert counts[f"radix_sort[{route}]"] == 1
                for g, w in zip([perm] + sk + sp, want):
                    assert torch.equal(g.cpu(), w), (route, n_pay, valid)
    tkeys = [torch.from_numpy(k).to(cuda_device) for k in base_keys]
    with pytest.raises(ValueError):
        tk.radix_sort(tkeys, route="cluster") if n > tk.SORT_CLUSTER_ROWS \
            else tk.radix_sort(tkeys, route="bitonic")


@pytest.mark.cuda
def test_radix_sort_cuda_cluster_limit_and_no_host_sync(cuda_device):
    """The cluster route's row limit is the C source's, and the window,
    join and rank-sort calls of K12 wait for nothing under
    torch.cuda.set_sync_debug_mode("error")."""
    import ctypes
    from pinot_tpu_torch.ops import build
    fn = build.load("sort_window.cu").pinot_radix_sort_cluster_rows
    fn.restype = ctypes.c_longlong
    assert fn() == tk.SORT_CLUSTER_ROWS
    part, orders, sums = _window_lanes(65536, 49183, 2, 2, seed=3)
    t = [torch.from_numpy(a).to(cuda_device) for a in [part] + orders + sums]
    calls = {
        "radix_sort": lambda: tk.radix_sort(t[:3], t[3:], 49183),
        "radix_sort_join": lambda: tk.radix_sort(
            t[1:2], t[3:4], counter="radix_sort_join"),
        "radix_sort_rank": lambda: tk.radix_sort(
            t[:2], counter="radix_sort_rank")}
    for name, call in calls.items():
        want = call()
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            got = call()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        for g, w in zip([got[0]] + got[1] + got[2],
                        [want[0]] + want[1] + want[2]):
            assert torch.equal(g, w), name


@pytest.mark.cuda
@pytest.mark.parametrize("n_lanes", [0, 1, 8, 9])   # 9: two launches' worth
@pytest.mark.parametrize("pattern", SCAN_PATTERNS)
@pytest.mark.parametrize("n", [1, 31, 2047, 2048, 2049, 65536, 2 ** 22 + 3])
def test_window_scan_cuda_matches_plain(cuda_device, n, pattern, n_lanes):
    """K13 bit-equal to its plain version on each of 20 repeats: a race in
    the look-back shows only as a wrong bit, so every case runs again."""
    sp, vals = _scan_case(n, pattern, n_lanes, seed=n + n_lanes)
    tsp = torch.from_numpy(sp).to(cuda_device)
    tvals = [torch.from_numpy(v).to(cuda_device) for v in vals]
    rn_p, run_p = tk.window_scan_plain(tsp, tvals)
    for _ in range(20):
        tk.reset_launch_counts()
        rn, run = tk.window_scan(tsp, tvals)
        assert tk.launch_counts()["window_scan"] == 1
        assert torch.equal(rn, rn_p)
        assert len(run) == n_lanes
        for a, b in zip(run, run_p):
            assert torch.equal(a, b)


@pytest.mark.cuda
def test_window_stage_cuda_matches_cpu(cuda_device):
    rng = np.random.default_rng(11)
    n = 30000
    cols = {"g": rng.integers(0, 13, n).astype(np.int64),
            "o": rng.integers(0, 500, n).astype(np.int64),
            "v": rng.integers(-50, 50, n).astype(np.int64)}
    req = compile_pql(_window_request())
    card = wmod.execute_window(req, dict(cols), n)
    cpu = wmod.execute_window(req, dict(cols), n, device="cpu")
    for a, b in zip(card.selection_cols, cpu.selection_cols):
        assert np.array_equal(np.asarray(a), np.asarray(b))
