"""The compacted filtered group-by (kmax > 0) on the port against the JAX
package: K14 block_compact, K15 slot_tables, K16 rank_slots, K3's idoff /
idrank keys and the sorted rung, and the planner's adaptive driver.

1. Contract cases. The JAX package's group_compacted, group_ranked and
   group_adaptive (pinot_tpu/ops/kernels.py:contract_cases), a ranked
   case with many groups, an MV case and the sorted rung, on numpy lanes
   made from a seed, through the jitted JAX build_segment_kernel and the
   port's run_segment_kernel (plain versions on the CPU), key by key:
   integer outputs (overflow, counts, cpsums / rpsums, rkeys, rcount,
   dictId min / max) equal; float outputs within rtol 1e-6, because the
   JAX compacted path rounds float lanes to float32 before it compacts
   (:1094, :1105) and the port keeps float64. Each case runs with a
   sparse filter and with a crowded one that overflows blocks, at 8,192
   and 16,384 rows. The stacked form: run_stacked_kernel against the JAX
   get_sharded_kernel (its 16-bit cpsums halves recombined in int64).
2. The driver functions on the same scout inputs: adaptive_phase_a_specs,
   adaptive_hist_specs, _adaptive_kmax, adaptive_phase_b_spec (spec
   tuples and extra operands equal), the kmax ladder.
3. Twins of tests/test_device_coverage.py:217-420 (the ranked layout, the
   adaptive offset and rank remaps) and tests/test_regressions.py:112
   (chunked cpsums past DENSE_ROWS_LIMIT, monkeypatched in both packages),
   a forced escalation, an MV group-by and a join group-by, through both
   engines per segment and stacked: equal rows, the oracle's, and equal
   final kernel specs (key kinds, cardinalities, g_pad, kmax), recorded
   by wrapping both packages' drive_group_execution.

`cuda` tests hold K14, K15, K16 (both routes) and K3's idoff / idrank keys
to their plain versions on the card; they skip where there is no card.
"""
from __future__ import annotations

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pinot_tpu.common.datatype import DataType as JaxDataType
from pinot_tpu.common.schema import FieldSpec, FieldType, Schema, \
    dimension, metric
from pinot_tpu.engine import QueryEngine as JaxQueryEngine
from pinot_tpu.ops import kernels as jk
from pinot_tpu.parallel import make_mesh as jax_make_mesh
from pinot_tpu.parallel.sharded import get_sharded_kernel
from pinot_tpu.query import plan as jplan
from pinot_tpu.segment.creator import SegmentCreator as JaxCreator
from pinot_tpu.segment.loader import ImmutableSegmentLoader as JaxLoader
from pinot_tpu_torch.engine import QueryEngine
from pinot_tpu_torch.ops import kernels as tk
from pinot_tpu_torch.parallel import make_mesh
from pinot_tpu_torch.parallel import sharded as tsharded
from pinot_tpu_torch.pql.parser import compile_pql
from pinot_tpu_torch.query import plan as tplan
from pinot_tpu_torch.query.executor import ServerQueryExecutor
from pinot_tpu_torch.segment.loader import ImmutableSegmentLoader

FLOAT_RTOL = 1e-6      # JAX rounds compacted float lanes to float32
SHAPES = (8192, 16384)


def _case(name):
    return next(c for c in jk.contract_cases() if c[0] == name)


def _ids(rng, n, card, hot=None, share=0.0):
    """n dictIds below card; `share` of them the `hot` id."""
    ids = rng.integers(0, card, n)
    if hot is not None:
        ids[rng.random(n) < share] = hot
    return ids.astype(np.int32)


def _lanes(name, P, num_docs, crowded, seed):
    """Lanes of a contract case (padding rows hold id == card, zeros)."""
    rng = np.random.default_rng(seed)
    share = 0.35 if crowded else 0.01
    cols = {}

    def pad(vals, fill, dtype):
        lane = np.full(P, fill, dtype)
        lane[:num_docs] = vals
        return lane

    if name in ("group_compacted", "group_adaptive", "group_mv",
                "group_sorted"):
        cols["d0.ids"] = pad(_ids(rng, num_docs, 8, 3, share), 8, np.int32)
        cols["d1.ids"] = pad(_ids(rng, num_docs, 8), 8, np.int32)
    else:                               # the ranked cases: d0 card 70000
        cols["d0.ids"] = pad(_ids(rng, num_docs, 70000, 4242, share),
                             70000, np.int32)
    parts = np.zeros((2, P), np.int8)
    parts[:, :num_docs] = rng.integers(0, 128, (2, num_docs))
    cols["m0.parts"] = parts
    cols["v0.vlane"] = pad(rng.random(num_docs).astype(np.float32), 0,
                           np.float32)
    cols["r0.raw"] = pad(rng.integers(-10**6, 10**6, num_docs), 0, np.int64)
    if name == "group_mv":
        mv = np.full((P, 3), 5, np.int32)
        mv[:num_docs] = rng.integers(0, 5, (num_docs, 3))
        width = rng.integers(1, 4, num_docs)
        mv[:num_docs][np.arange(3)[None, :] >= width[:, None]] = 5
        cols["t0.mv"] = mv
    return cols


_EQ3 = ("pred", "eq_id", "d0", "sv", None)
#: name → (filter, group spec, params); the first three are the JAX
#: package's contract cases, the others reach the ranked layout with many
#: groups, an MV key and the sorted rung
CASES = {
    name: (_case(name)[1], _case(name)[3], None)
    for name in ("group_compacted", "group_ranked", "group_adaptive")}
CASES["group_ranked_range"] = (
    ("pred", "range_ids", "d0", "sv", None),
    ((("d0", "ids", 0, 70000),), (1,), 131072,
     (("sum", "m0", "sv", ("psums", 2)), ("count", "*", "sv", None),
      ("min", "d0", "sv", ("ids", 131072)), ("max", "r0", "raw", None),
      ("sum", "v0", "sv", ("csums",))), 1024), None)
CASES["group_mv"] = (
    _EQ3,
    ((("t0", "mvids", 0, 5), ("d1", "ids", 0, 8)), (8, 1), 64,
     (("sum", "m0", "sv", ("psums", 2)), ("count", "*", "sv", None),
      ("minmaxrange", "r0", "raw", None)), 1024), None)
CASES["group_sorted"] = (
    _EQ3,
    ((("d0", "ids", 0, 8), ("d1", "ids", 0, 8)), (8, 1), 64,
     (("sum", "m0", "sv", ("psums", 2)), ("min", "d0", "sv", ("ids", 16)),
      ("sum", "v0", "sv", ("csums",))), 8192), None)


def _params(name, P):
    if name == "group_adaptive":
        return [np.int32(2), np.array([0, 3, 1, 7, 2, 0, 5, 6], np.int32)]
    if name == "group_ranked_range":
        return [np.int32(1000), np.int32(69000)]
    if name == "group_ranked":
        return [np.int32(4242)]
    return [np.int32(3)]


def _jax_run(P, filt, group, cols, params, num_docs):
    fn = jax.jit(jk.build_segment_kernel(P, filt, (), group, None))
    outs = fn({k: jnp.asarray(v) for k, v in cols.items()},
              tuple(jnp.asarray(x) for x in params), jnp.int32(num_docs))
    return {k: np.asarray(v) for k, v in outs.items()}


def _port_run(P, filt, group, tcols, params, num_docs, device):
    """The port's dispatch; the JAX params list the filter's first, then
    the remap keys' operands, which the port takes as group params."""
    n = tk.filter_param_count(filt)
    return tk.run_segment_kernel(P, filt, (), group, None, tcols,
                                 params[:n], num_docs, device,
                                 group_params=params[n:])


def _tcols(cols, device="cpu"):
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in cols.items()}


def assert_outputs_equal(got, want):
    """Key by key: integers equal, floats within FLOAT_RTOL."""
    assert set(got) == set(want)
    for k, w in want.items():
        g = got[k].cpu().numpy() if torch.is_tensor(got[k]) else got[k]
        assert g.shape == w.shape, (k, g.shape, w.shape)
        if w.dtype.kind == "f":
            np.testing.assert_allclose(g, w, rtol=FLOAT_RTOL, atol=0,
                                       err_msg=k)
        else:
            np.testing.assert_array_equal(g, w, err_msg=k)


@pytest.mark.parametrize("P", SHAPES)
@pytest.mark.parametrize("crowded", [False, True])
@pytest.mark.parametrize("name", sorted(CASES))
def test_compacted_outputs_match_jax(P, crowded, name):
    filt, group, _ = CASES[name]
    num_docs = P - 333
    cols = _lanes(name, P, num_docs, crowded, seed=P + crowded)
    params = _params(name, P)
    want = _jax_run(P, filt, group, cols, params, num_docs)
    tk.reset_launch_counts()
    got = _port_run(P, filt, group, _tcols(cols), params, num_docs, "cpu")
    assert_outputs_equal(got, want)
    routes = tk.group_route_counts
    if name == "group_sorted":
        assert routes["sorted"] == 1 and int(got["group.overflow"]) == 0
    elif group[4]:
        assert routes["ranked" if group[2] > tk.DENSE_G_LIMIT
                      else "compacted"] == 1
    if crowded and name == "group_compacted" and P == 8192:
        assert int(got["group.overflow"]) == 1      # blocks dropped rows


def test_ranked_layout_holds_many_groups():
    P = 16384
    filt, group, _ = CASES["group_ranked_range"]
    cols = _lanes("group_ranked_range", P, P, False, seed=1)
    got = _port_run(P, filt, group, _tcols(cols),
                    _params("group_ranked_range", P), P, "cpu")
    n = int((got["group.rkeys"] < group[2]).sum())
    assert n > 500 and int(got["group.rcount"][:n].min()) >= 1
    assert bool((got["group.rkeys"][:n].diff() > 0).all())


def test_chunked_cpsums_past_dense_rows_limit(monkeypatch):
    """cap > DENSE_ROWS_LIMIT (monkeypatched to 256 in both packages):
    the int32 part sums come in [C, L, g_pad] chunks of 256 slots, equal
    chunk for chunk; a JAX kernel traced outside build_segment_kernel's
    cache sees the patched limit."""
    monkeypatch.setattr(jk, "DENSE_ROWS_LIMIT", 256)
    monkeypatch.setattr(tk, "DENSE_ROWS_LIMIT", 256)
    P = 8192
    filt, group, _ = CASES["group_compacted"]
    cols = _lanes("group_compacted", P, P, False, seed=3)
    mask = np.asarray(cols["d0.ids"] == 3)
    fn = jax.jit(lambda c, m: jk._group_outputs(group, c, m, P, []))
    want = {k: np.asarray(v) for k, v in fn(
        {k: jnp.asarray(v) for k, v in cols.items()},
        jnp.asarray(mask)).items()}
    got = tk._group_outputs(torch.from_numpy(mask.astype(np.uint8)), group,
                            _tcols(cols), [])
    assert want["gagg0.cpsums"].shape == (4, 2, 64)    # cap 1024: 4 chunks
    got.pop("stats.num_docs_matched")
    assert_outputs_equal(got, want)


# -- the stacked form --------------------------------------------------------

STACK_GROUPS = {
    "dense": ((("g2", "ids", 0, 2), ("g7", "ids", 0, 7)), (7, 1), 16,
              (("count", "*", "none", None),
               ("sum", "r1", "sv", ("psums", 1024)),
               ("avg", "x", "raw", ("csums",)),
               ("min", "a", "sv", ("ids", 64)),
               ("max", "rf32", "raw", None)), 64),
    "ranked": ((("b", "ids", 0, 1000), ("a", "ids", 0, 50)), (50, 1), 65536,
               (("count", "*", "none", None),
                ("sum", "r1", "sv", ("psums", 1024)),
                ("min", "a", "sv", ("ids", 64)),
                ("max", "rf32", "raw", None)), 1024),
    "sorted": ((("g2", "ids", 0, 2), ("g7", "ids", 0, 7)), (7, 1), 16,
               (("sum", "r1", "sv", ("psums", 1024)),
                ("avg", "x", "raw", ("csums",))), 4096),
    "mv": ((("m3", "mvids", 0, 10), ("g2", "ids", 0, 2)), (2, 1), 32,
           (("count", "*", "none", None),
            ("avg", "r1", "sv", ("psums", 1024))), 1024),
    # the sorted rung over MV keys: one K3 a segment counts its entry
    # combinations against kmax
    "mv_sorted": ((("m3", "mvids", 0, 10), ("g2", "ids", 0, 2)), (2, 1), 32,
                  (("count", "*", "none", None),
                   ("avg", "r1", "sv", ("psums", 1024)),
                   ("min", "a", "sv", ("ids", 64))), 4096),
}


@pytest.mark.parametrize("n_segs", [8, 5])
@pytest.mark.parametrize("gname", sorted(STACK_GROUPS))
def test_stacked_compacted_matches_jax_sharded(n_segs, gname):
    from test_torch_sharded import FILTERS, P, _stack
    filt, params = FILTERS["mixed"]
    group = STACK_GROUPS[gname]
    port, jax_cols, docs, jdocs = _stack(n_segs, seed=n_segs)
    for k in ("a.hllidx", "a.hllrank"):
        del port[k], jax_cols[k]
    fn = get_sharded_kernel(jax_make_mesh(), P, filt, (), group, None,
                            tuple(sorted(jax_cols)))
    want = {k: np.asarray(v) for k, v in fn(
        jax_cols, tuple(jnp.asarray(x) for x in params),
        jnp.asarray(jdocs)).items()}
    tk.reset_launch_counts()
    got = tk.run_stacked_kernel(P, n_segs, filt, (), group, None, port,
                                params, torch.from_numpy(docs))
    route = "sorted" if gname.endswith("sorted") else \
        "ranked" if gname == "ranked" else "compacted"
    assert tk.group_route_counts == {route: 1}
    assert bool(got["group.overflow"]) == bool(want.pop("group.overflow"))
    got.pop("group.overflow")
    for k in [k for k in want if k.endswith(".cpsums.lo")]:
        base = k[:-3]
        want[base] = (want.pop(base + ".hi").astype(np.int64) << 16) + \
            want.pop(k).astype(np.int64)
    for k in list(want):
        if k.endswith((".rkeys", ".rcount", ".rpsums", ".rsum", ".rmin",
                       ".rmax")) or k == "stats.seg_matched":
            want[k] = want[k][:n_segs]
    assert_outputs_equal(got, want)


# -- the driver functions ----------------------------------------------------

AGGS = (("sum", "v", "sv", ("psums", 1024)), ("count", "*", "none", None))
SPECS = {
    "wide": ((("a", "ids", 0, 300), ("b", "ids", 0, 250)), (250, 1),
             131072, AGGS, 1024),
    "ssb3": ((("c_nation", "ids", 0, 25), ("s_nation", "ids", 0, 25),
              ("d_year", "ids", 0, 7)), (175, 7, 1), 8192, AGGS, 65536),
    "raw": ((("r", "rawoff", -5, 900), ("a", "ids", 0, 300)), (300, 1),
            524288, AGGS, 1024),
    "dense0": ((("a", "ids", 0, 300),), (1,), 512, AGGS, 0),
}
BOUNDS = {"wide": [[(100, 105), (0, 249)], [(0, 299), (0, 249)],
                   [(7, 7), (3, 3)], [(0, 299), (200, 249)]],
          "ssb3": [[(0, 24), (0, 24), (0, 6)], [(5, 9), (5, 9), (0, 5)],
                   [(2, 20), (0, 24), (1, 1)]]}
SCOUTS = [
    [("present", np.arange(100, 106)), ("present", np.arange(0, 250))],
    [("present", np.array([3, 40, 77, 101, 130])),
     ("present", np.arange(250))],
    [("present", np.array([3, 40, 77, 101, 130])),
     ("present", np.array([1, 9, 200]))],
    [("bounds", 100, 105), ("bounds", 0, 249)],
    [("bounds", 5, 4), ("bounds", 0, 249)],
    [("present", np.array([], np.int64)), ("present", np.arange(3))],
]


def _same(a, b):
    """Spec tuples with numpy leaves (present ids, rank vectors) equal."""
    if isinstance(a, (tuple, list)):
        assert isinstance(b, (tuple, list)) and len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        assert np.asarray(a).dtype == np.asarray(b).dtype
    else:
        assert a == b and type(a) is type(b) or \
            (np.isscalar(a) and np.asarray(a) == np.asarray(b) and
             np.asarray(a).dtype == np.asarray(b).dtype), (a, b)


@pytest.mark.parametrize("name", sorted(SPECS))
def test_scout_specs_and_ladder_match_jax(name):
    spec = SPECS[name]
    _same(tplan.adaptive_phase_a_specs(spec),
          jplan.adaptive_phase_a_specs(spec))
    for bounds in BOUNDS.get(name, []):
        _same(tplan.adaptive_hist_specs(spec, bounds),
              jplan.adaptive_hist_specs(spec, bounds))
    for padded in (8192, 2_506_752, 7_503_872):
        assert tplan.initial_group_kmax(padded) == \
            jplan.initial_group_kmax(padded)
        _same(tplan.set_group_kmax(spec, padded),
              jplan.set_group_kmax(spec, padded))
        ts, js = spec, spec
        while js is not None:
            ts = tplan.escalate_group_kmax(ts, padded)
            js = jplan.escalate_group_kmax(js, padded)
            _same(ts, js)


@pytest.mark.parametrize("g_pad", [8, 512, 32768, 65536])
@pytest.mark.parametrize("padded", [8192, 204_800, 7_503_872])
def test_adaptive_kmax_matches_jax(padded, g_pad):
    for matched in (0, 1, 17, 1000, padded // 100, padded // 9, padded):
        total = padded - 1000
        assert tplan._adaptive_kmax(matched, padded, total, g_pad) == \
            jplan._adaptive_kmax(matched, padded, total, g_pad)


@pytest.mark.parametrize("scout", range(len(SCOUTS)))
@pytest.mark.parametrize("matched", [2, 2000, 60000])
def test_phase_b_spec_matches_jax(scout, matched):
    spec = SPECS["wide"]
    args = (spec, SCOUTS[scout], matched, 204_800, 200_000)
    _same(tplan.adaptive_phase_b_spec(*args),
          jplan.adaptive_phase_b_spec(*args))


# -- engines: ranked, adaptive remaps, chunks, escalation, MV, join ----------


def _recorder(monkeypatch):
    """{"jax": [...], "port": [...]}: the (key kinds and cardinalities,
    g_pad, kmax) of each final spec of drive_group_execution, None when
    the scout matched nothing."""
    rec = {"jax": [], "port": []}

    def wrap(real, key):
        def drive(run, spec, padded, total):
            outs, used = real(run, spec, padded, total)
            rec[key].append(None if used is None else (
                tuple((g[1], g[3]) for g in used[0]), used[2], used[4]))
            return outs, used
        return drive

    monkeypatch.setattr(jplan, "drive_group_execution",
                        wrap(jplan.drive_group_execution, "jax"))
    drive = wrap(tplan.drive_group_execution, "port")
    monkeypatch.setattr(tplan, "drive_group_execution", drive)
    monkeypatch.setattr(tsharded, "drive_group_execution", drive)
    return rec


def _groups(resp, fi=0):
    return {tuple(g["group"]): float(g["value"])
            for g in resp.aggregation_results[fi].group_by_result}


def _engines(dirs):
    """(JAX per segment, JAX stacked, port per segment, port stacked)
    over segments one creator wrote, each package's loader."""
    jsegs = [JaxLoader.load(d) for d in dirs]
    tsegs = [ImmutableSegmentLoader.load(d, device="cpu") for d in dirs]
    return (JaxQueryEngine(jsegs), JaxQueryEngine(jsegs, mesh=jax_make_mesh()),
            QueryEngine(tsegs, device="cpu"),
            QueryEngine(tsegs, device="cpu", mesh=make_mesh(["cpu"])))


def _check_engines(engines, pql, expected, monkeypatch, n_aggs=None):
    """Every engine's rows equal `expected` ([{group: value}] per
    aggregation); the port's final specs equal the JAX ones, per segment
    and stacked. Returns the port's route counts of the two runs."""
    jseq, jst, tseq, tst = engines
    routes = []
    for jax_e, port_e in ((jseq, tseq), (jst, tst)):
        rec = _recorder(monkeypatch)
        tk.reset_launch_counts()
        jresp, resp = jax_e.query(pql), port_e.query(pql)
        routes.append(dict(tk.group_route_counts))
        monkeypatch.undo()
        assert not resp.exceptions, resp.exceptions
        assert rec["port"] == rec["jax"] and rec["port"]
        for fi, exp in enumerate(expected):
            assert _groups(resp, fi) == pytest.approx(exp, rel=1e-9)
            assert _groups(jresp, fi) == pytest.approx(exp, rel=1e-5)
    assert tst.last_route == ("stacked", None)
    return routes


@pytest.fixture(scope="module")
def wide_dirs(tmp_path_factory):
    """tests/test_device_coverage.py's wide_group_setup: 4 segments of
    4,096 rows, a (300) x b (250) past DENSE_G_LIMIT."""
    base = str(tmp_path_factory.mktemp("wide"))
    rng = np.random.default_rng(5)
    n = 4096
    schema = Schema("w", [dimension("a", JaxDataType.STRING),
                          dimension("b", JaxDataType.STRING),
                          metric("v", JaxDataType.INT),
                          metric("f", JaxDataType.FLOAT)])
    avals = np.array([f"a{i:03d}" for i in range(300)], dtype=object)
    bvals = np.array([f"b{i:03d}" for i in range(250)], dtype=object)
    dirs, datas = [], []
    for s in range(4):
        cols = {"a": avals[rng.integers(0, 300, n)],
                "b": bvals[rng.integers(0, 250, n)],
                "v": rng.integers(-50, 100000, n).astype(np.int32),
                "f": rng.random(n).astype(np.float32)}
        d = os.path.join(base, f"w{s}")
        os.makedirs(d)
        JaxCreator(schema, None, segment_name=f"w{s}",
                   fixed_dictionaries={"a": avals, "b": bvals}
                   ).build(cols, d)
        dirs.append(d)
        datas.append(cols)
    merged = {k: np.concatenate([c[k] for c in datas]) for k in datas[0]}
    return dirs, merged


@pytest.fixture(scope="module")
def wide(wide_dirs):
    return _engines(wide_dirs[0]), wide_dirs[1]


def _sums(merged, m, keys=("a", "b"), col="v"):
    out = {}
    for k, v in zip(zip(*(merged[c][m] for c in keys)), merged[col][m]):
        out[k] = out.get(k, 0) + float(v)
    return out


def test_wide_key_group_by_takes_ranked_path(wide_dirs):
    seg = ImmutableSegmentLoader.load(wide_dirs[0][0], device="cpu")
    plan = tplan.InstancePlanMaker().make_segment_plan(seg, compile_pql(
        "SELECT SUM(v) FROM w WHERE v >= 0 GROUP BY a, b TOP 20000"))
    assert plan.group_spec[2] > tk.DENSE_G_LIMIT    # g_pad: ranked layout
    assert plan.group_spec[4] > 0                   # compacted
    off = tplan.InstancePlanMaker(allow_group_compaction=False)
    assert off.make_segment_plan(seg, compile_pql(
        "SELECT SUM(v) FROM w WHERE v >= 0 GROUP BY a, b TOP 20000")
    ).group_spec[4] == 0


def test_wide_key_group_by_matches_oracle(wide, monkeypatch):
    engines, merged = wide
    pql = ("SELECT SUM(v), COUNT(*), MIN(v), MAX(v), AVG(f) FROM w "
           "WHERE v >= 0 GROUP BY a, b TOP 20000")
    m = merged["v"] >= 0
    keys = list(zip(merged["a"][m], merged["b"][m]))
    cnt, mn, mx, fs = {}, {}, {}, {}
    for k, v, f in zip(keys, merged["v"][m], merged["f"][m]):
        cnt[k] = cnt.get(k, 0) + 1
        mn[k] = min(mn.get(k, 1 << 40), int(v))
        mx[k] = max(mx.get(k, -(1 << 40)), int(v))
        fs[k] = fs.get(k, 0.0) + float(f)
    routes = _check_engines(engines, pql, [
        _sums(merged, m), {k: float(c) for k, c in cnt.items()},
        {k: float(v) for k, v in mn.items()},
        {k: float(v) for k, v in mx.items()},
        {k: fs[k] / cnt[k] for k in cnt}], monkeypatch)
    # a v >= 0 filter matches most rows: the ladder climbs to the sorted
    # rung, or the ranked layout holds every block
    assert all(r.get("ranked", 0) + r.get("sorted", 0) >= 1 for r in routes)


def test_adaptive_offset_remap_group_by(wide, monkeypatch):
    engines, merged = wide
    pql = ("SELECT SUM(v), COUNT(*) FROM w WHERE a BETWEEN 'a100' AND "
           "'a105' GROUP BY a, b TOP 20000")
    m = (merged["a"] >= "a100") & (merged["a"] <= "a105")
    cnt = {}
    for k in zip(merged["a"][m], merged["b"][m]):
        cnt[k] = cnt.get(k, 0.0) + 1
    routes = _check_engines(engines, pql, [_sums(merged, m), cnt],
                            monkeypatch)
    # one drive a segment, one over the stack
    assert [(r["scout"], r["idoff"]) for r in routes] == [(4, 4), (1, 1)]


def test_rank_remap_scattered_actives_end_to_end(wide, monkeypatch):
    engines, merged = wide
    picks = ["a003", "a091", "a155", "a202", "a249"]
    lst = ", ".join(f"'{p}'" for p in picks)
    pql = (f"SELECT SUM(v), COUNT(*) FROM w WHERE a IN ({lst}) "
           "GROUP BY a, b TOP 20000")
    m = np.isin(merged["a"], picks)
    cnt = {}
    for k in zip(merged["a"][m], merged["b"][m]):
        cnt[k] = cnt.get(k, 0.0) + 1
    routes = _check_engines(engines, pql, [_sums(merged, m), cnt],
                            monkeypatch)
    assert [(r["hist"], r["idrank"]) for r in routes] == [(4, 4), (1, 1)]


@pytest.fixture(scope="module")
def chunk_dirs(tmp_path_factory):
    """tests/test_regressions.py:112's table: 3,100 rows, 7 groups."""
    rng = np.random.default_rng(11)
    n = 3100
    schema = Schema("t", [dimension("g", JaxDataType.STRING),
                          metric("v", JaxDataType.INT)])
    cols = {"g": np.array(["g%02d" % i for i in rng.integers(0, 7, n)],
                          dtype=object),
            "v": rng.integers(0, 100_000, n).astype(np.int32)}
    d = os.path.join(str(tmp_path_factory.mktemp("chunk")), "t")
    os.makedirs(d)
    JaxCreator(schema, None).build(cols, d)
    return d, cols


def test_compacted_group_by_chunked_psums(chunk_dirs, monkeypatch):
    """DENSE_ROWS_LIMIT 256: no scout (the segment is past the limit),
    rung one (kmax 1024, cap 1024) folds four int32 chunks, overflows,
    and the sorted rung (kmax 4096) runs K3 over 32 row slices; the host
    adds every chunk in int64."""
    d, cols = chunk_dirs
    monkeypatch.setattr(tk, "DENSE_ROWS_LIMIT", 256)
    expected = {}
    for g, v in zip(cols["g"], cols["v"]):
        if v >= 1000:
            expected[(g,)] = expected.get((g,), 0.0) + float(v)
    engine = QueryEngine([ImmutableSegmentLoader.load(d, device="cpu")],
                         device="cpu")
    tk.reset_launch_counts()
    # v >= 1000 (the JAX test's v >= 5 can resolve to match-all: no
    # value below 5 in the dictionary, and kmax 0)
    r = engine.query("SELECT SUM(v) FROM t WHERE v >= 1000 GROUP BY g "
                     "TOP 10")
    assert _groups(r) == expected
    routes = tk.group_route_counts
    assert routes == {"compacted": 1, "escalation": 1, "sorted": 1}, routes


@pytest.fixture(scope="module")
def crowd_dirs(tmp_path_factory):
    """A sorted key, so a range filter's matches crowd into a few blocks:
    2 segments of 65,536 rows, the first 1% of rows of each matching."""
    schema = Schema("c", [dimension("k", JaxDataType.INT),
                          dimension("g", JaxDataType.STRING),
                          metric("v", JaxDataType.INT)])
    rng = np.random.default_rng(2)
    n = 65536
    base = str(tmp_path_factory.mktemp("crowd"))
    dirs, datas = [], []
    for s in range(2):
        cols = {"k": np.arange(n, dtype=np.int32),
                "g": np.array(["g%d" % i for i in rng.integers(0, 9, n)],
                              dtype=object),
                "v": rng.integers(0, 1000, n).astype(np.int32)}
        d = os.path.join(base, f"c{s}")
        os.makedirs(d)
        JaxCreator(schema, None, segment_name=f"c{s}").build(cols, d)
        dirs.append(d)
        datas.append(cols)
    merged = {k: np.concatenate([c[k] for c in datas]) for k in datas[0]}
    return dirs, merged


def test_crowded_filter_escalates(crowd_dirs, monkeypatch):
    dirs, merged = crowd_dirs
    m = merged["k"] < 655
    exp = {}
    for g, v in zip(merged["g"][m], merged["v"][m]):
        exp[(g,)] = exp.get((g,), 0.0) + float(v)
    routes = _check_engines(
        _engines(dirs), "SELECT SUM(v) FROM c WHERE k < 655 GROUP BY g "
        "TOP 100", [exp], monkeypatch)
    # the scout sizes kmax for 1% spread evenly (r = 64); the first
    # block holds all 655 matches, so rungs one and two overflow
    assert [r["scout"] for r in routes] == [2, 1]
    assert all(r["escalation"] >= 2 * r["scout"] for r in routes), routes


def test_mv_group_by_compacted(tmp_path, monkeypatch):
    """An MV key: no scout (not a dictionary SV key), K14 walks the
    expanded rows from rung one."""
    rng = np.random.default_rng(9)
    n = 4096
    schema = Schema("mvw", [dimension("k", JaxDataType.STRING),
                            FieldSpec("tags", JaxDataType.STRING,
                                      FieldType.DIMENSION,
                                      single_value=False),
                            metric("v", JaxDataType.INT)])
    kvals = np.array([f"k{i:02d}" for i in range(40)], dtype=object)
    tvals = np.array([f"t{i:02d}" for i in range(12)], dtype=object)
    dirs, datas = [], []
    for s in range(2):
        cols = {"k": kvals[rng.integers(0, 40, n)],
                "tags": [list(rng.choice(tvals, rng.integers(1, 4),
                                         replace=False))
                         for _ in range(n)],
                "v": rng.integers(0, 1000, n).astype(np.int32)}
        d = str(tmp_path / f"s{s}")
        os.makedirs(d)
        JaxCreator(schema, None, segment_name=f"mvw{s}",
                   fixed_dictionaries={"k": kvals, "tags": tvals}
                   ).build(cols, d)
        dirs.append(d)
        datas.append(cols)
    cnt, sums = {}, {}
    for cols in datas:
        for tags, k, v in zip(cols["tags"], cols["k"], cols["v"]):
            if v < 900:
                for t in tags:
                    cnt[(t, k)] = cnt.get((t, k), 0.0) + 1
                    sums[(t, k)] = sums.get((t, k), 0.0) + float(v)
    routes = _check_engines(
        _engines(dirs), "SELECT COUNT(*), SUM(v) FROM mvw WHERE v < 900 "
        "GROUP BY tags, k TOP 5000", [cnt, sums], monkeypatch)
    assert all(not r.get("scout") and r.get("compacted", 0) +
               r.get("sorted", 0) >= 1 for r in routes)


def test_join_group_by_compacted(tmp_path, monkeypatch):
    """A join's jcode key (dictionary fact key) and jraw key (raw fact
    key): no scout, the compacted kernels and the ladder, equal to JAX and
    join_oracle per segment and stacked (test_torch_stages.py's tables)."""
    import test_torch_stages as st
    from pinot_tpu.pql.parser import compile_pql as jax_compile
    from pinot_tpu.tools import datagen as jax_datagen
    fact_dirs, _d, dim, fact = jax_datagen.build_join_table_dirs(
        str(tmp_path), fact_rows=12000, num_fact_segments=3, dim_rows=400,
        seed=5)
    segs = [ImmutableSegmentLoader.load(d, device="cpu") for d in fact_dirs]
    jsegs = [JaxLoader.load(d) for d in fact_dirs]
    pql, dim_filter, fact_filter, group_cols = st.JOIN_PQLS[
        "j21_dim_and_fact_filter"]
    ctx, jctx = st._contexts(compile_pql(pql), jax_compile(pql), dim,
                             dim_filter)
    rec = _recorder(monkeypatch)
    tk.reset_launch_counts()
    st._check_all(pql, ctx, jctx, segs, jsegs, st._oracle_dict(
        dim, fact, dim_filter, fact_filter, group_cols))
    routes = dict(tk.group_route_counts)
    monkeypatch.undo()
    assert not routes.get("scout") and routes.get("compacted", 0) + \
        routes.get("sorted", 0) >= 2
    # per segment the JAX executor's specs (its stacked one is not run)
    jax_specs = rec["jax"]
    assert jax_specs and all(s[0][0][0] == "jcode" for s in jax_specs)
    assert rec["port"][:len(jax_specs)] == jax_specs


# ---------------------------------------------------------------------------
# On the card: K14, K15, K16 and K3's remap keys against their plain versions
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _on(outs, device):
    return {k: v.to(device) if torch.is_tensor(v) else v
            for k, v in outs.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("crowded", [False, True])
@pytest.mark.parametrize("name", sorted(CASES))
def test_compacted_outputs_cuda_match_plain(cuda_device, crowded, name):
    P = SHAPES[-1]
    filt, group, _ = CASES[name]
    cols = _lanes(name, P, P - 333, crowded, seed=7)
    params = _params(name, P)
    want = _port_run(P, filt, group, _tcols(cols), params, P - 333, "cpu")
    got = _port_run(P, filt, group, _tcols(cols, cuda_device), params,
                    P - 333, cuda_device)
    torch.cuda.synchronize()
    for k, w in want.items():
        g = got[k].cpu()
        assert g.dtype == w.dtype and g.shape == w.shape, k
        if w.dtype == torch.float64:
            # float64 atomics add in a run-dependent order
            torch.testing.assert_close(g, w, rtol=1e-9, atol=0)
        else:
            assert torch.equal(g, w), k


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["bitmap", "sort"])
@pytest.mark.parametrize("segs", [1, 3])
def test_rank_slots_cuda_routes_match_plain(cuda_device, route, segs):
    rng = np.random.default_rng(segs)
    cap, g_pad = 4096, 131072
    kc = rng.integers(0, 60000, segs * cap).astype(np.int32)
    kc[rng.random(segs * cap) < 0.3] = g_pad           # unused slots
    want = tk.rank_slots_plain(torch.from_numpy(kc), cap, g_pad)
    tk.reset_launch_counts()
    got = tk.rank_slots(torch.from_numpy(kc).to(cuda_device), cap, g_pad,
                        route=route)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
    counts = tk.launch_counts()
    assert counts["rank_slots"] == 1
    assert counts["radix_sort_rank"] == (route == "sort")


@pytest.mark.cuda
@pytest.mark.parametrize("wide", [False, True])
def test_slot_tables_cuda_chunks_match_plain(cuda_device, wide):
    rng = np.random.default_rng(4)
    n, cap, t = 3 * 2048, 2048, 300
    gslot = torch.from_numpy(rng.integers(0, t + 1, n).astype(np.int32))
    parts = torch.from_numpy(rng.integers(0, 128, (2, n)).astype(np.int8))
    sums = torch.from_numpy(rng.random((1, n)))
    ids = torch.from_numpy(rng.integers(0, 50, n).astype(np.int32))
    ext = (("ids", ids, "min", 64), ("raw", sums[0], "max", 0))
    want = tk.slot_tables_plain(gslot, t, cap, parts, sums, ext, 512, wide)
    dev = [x.to(cuda_device) for x in (gslot, parts, sums, ids)]
    got = tk.slot_tables(dev[0], t, cap, dev[1], dev[2],
                         (("ids", dev[3], "min", 64),
                          ("raw", dev[2][0], "max", 0)), 512, wide)
    torch.cuda.synchronize()
    assert torch.equal(got[0].cpu(), want[0])
    assert torch.equal(got[1].cpu(), want[1])
    torch.testing.assert_close(got[2].cpu(), want[2], rtol=1e-9, atol=0)
    for g, w in zip(got[3], want[3]):
        assert torch.equal(g.cpu(), w)


@pytest.mark.cuda
def test_stacked_compacted_cuda_match_plain(cuda_device):
    from test_torch_sharded import FILTERS, P, _stack
    filt, params = FILTERS["mixed"]
    port, _j, docs, _jd = _stack(5, seed=5)
    for k in ("a.hllidx", "a.hllrank"):
        del port[k]
    card = {k: v.to(cuda_device) for k, v in port.items()}
    for group in STACK_GROUPS.values():
        want = tk.run_stacked_kernel(P, 5, filt, (), group, None, port,
                                     params, torch.from_numpy(docs))
        got = tk.run_stacked_kernel(P, 5, filt, (), group, None, card,
                                    params,
                                    torch.from_numpy(docs).to(cuda_device))
        for k, w in want.items():
            g = got[k].cpu()
            assert g.shape == w.shape and g.dtype == w.dtype, k
            if w.dtype == torch.float64:
                torch.testing.assert_close(g, w, rtol=1e-9, atol=0)
            else:
                assert torch.equal(g, w), k
