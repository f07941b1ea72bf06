"""Registry contract cases through both packages' run_segment_kernel.

pinot_tpu/ops/kernels.py:contract_cases() lists the kernel surface the
JAX planner can emit. The cases that only hand-made lanes held in the
port's tests, `join_raw_probe` (K1's join_raw leaf and K3's jraw key)
and `group_scatter` (K3 past the dense group limit, a dictionary SUM by
the ("vals",) strategy and a raw MAX), run here through the JAX
run_segment_kernel and the port's (its plain versions on the CPU) at
each of CONTRACT_SHAPE_BUCKETS, on operands drawn from a seed with
numpy. Their outputs compare key by key: integers equal, float sums
within FLOAT_RTOL (the port adds in another order than the JAX scatter).

The port takes two operands in another form, mapped here: a join's dim
keys are a SortedKeys (the join_raw leaf's keys as params; the jraw
key's keys with their group codes as group_params), where the JAX
kernel takes the arrays and sorts them inside the launch. join_raw_probe
runs at a narrow key span (K1's bitmap route) and a wide one (its
probe route).

The three cases that hold K4 and its fused HLL form, `agg_float_hist`
(a DISTINCTCOUNT histogram beside raw and decoded-value sums and id
extremes), `agg_mv` (the MV entry histogram, COUNTMV's total and the
entry min) and `agg_hll` (the fused histogram and registers), run the
same way; their dictionaries' HLL tables come from the loader.

A `cuda` test holds group_scatter on the card to the CPU's answer, and
one the three K4 cases.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pinot_tpu.ops import kernels as jk
from pinot_tpu_torch.ops import kernels as tk
from pinot_tpu_torch.segment.loader import hll_tables_padded

#: float sums: the JAX scatter and K3 add float64 values in other orders
FLOAT_RTOL = 1e-12
SEEDS = (0, 1)


def _case(name: str):
    for case in jk.contract_cases():
        if case[0] == name:
            return case
    raise KeyError(name)


def _group_scatter_operands(P: int, seed: int):
    """group_scatter's lanes (ids over the 512-entry dictionaries, the
    decoded values positive so that no sum cancels) and no params."""
    _n, _f, _a, _g, _s, cols, params = _case("group_scatter")
    assert params == ()
    rng = np.random.default_rng([seed, P])
    lanes = {"d0.ids": rng.integers(0, 512, P).astype(np.int32),
             "v0.ids": rng.integers(0, 512, P).astype(np.int32),
             "v0.vals": rng.uniform(0.5, 2.0, 512).astype(np.float32),
             "r0.raw": rng.standard_normal(P).astype(np.float32)}
    assert {k: (str(v.dtype), v.shape) for k, v in lanes.items()} == \
        {k: (dt, tuple(P if d == "P" else d for d in shape))
         for k, (dt, shape) in cols.items()}
    return lanes, (), (), ()


def _join_raw_probe_operands(P: int, seed: int, span: str):
    """join_raw_probe's key lane (60% of rows a dim key) and its three
    params: the dim keys padded to 128 by repeating the largest (the
    join_raw leaf's), and the same keys with their group codes in [0, 8)
    (the jraw key's; the padding repeats the largest key's code). The
    port's params: SortedKeys of the keys, and of the keys with codes."""
    _n, _f, _a, _g, _s, cols, params = _case("join_raw_probe")
    rng = np.random.default_rng([seed, P, span == "wide"])
    top = 5_000 if span == "narrow" else 2 ** 30
    dim = rng.choice(np.arange(-top, top), 100, replace=False).astype(np.int32)
    keys = np.full(128, dim.max(), np.int32)
    keys[:100] = dim
    codes = np.full(128, 0, np.int32)
    codes[:100] = rng.integers(0, 8, 100)
    codes[100:] = codes[int(np.argmax(dim))]
    lane = np.where(rng.random(P) < 0.6, rng.choice(dim, P),
                    rng.integers(-top, top, P)).astype(np.int32)
    assert [(dt, shape) for dt, shape in params] == \
        [(str(a.dtype), a.shape) for a in (keys, keys, codes)]
    assert cols == {"k0.raw": ("int32", ("P",))}
    return ({"k0.raw": lane}, (keys, keys, codes), [tk.SortedKeys(keys)],
            [tk.SortedKeys(keys, codes)])


def _histogram_case_operands(name: str, P: int, seed: int):
    """The lanes of agg_float_hist, agg_mv or agg_hll as the registry
    gives their shapes (ids over 50-entry dictionaries padded to 64, MV
    rows of 1-4 entries padded with the cardinality, the HLL tables of
    50 strings), and the eq_id literal where the filter takes one."""
    _n, _f, _a, _g, _s, cols, params = _case(name)
    rng = np.random.default_rng([seed, P])
    lanes = {}
    for key, (dt, shape) in cols.items():
        if key.endswith(".ids"):
            lanes[key] = rng.integers(0, 50, P).astype(dt)
        elif key.endswith(".mv"):
            mv = rng.integers(0, 50, (P, shape[1])).astype(dt)
            width = rng.integers(1, shape[1] + 1, P)
            mv[np.arange(shape[1])[None, :] >= width[:, None]] = 50
            lanes[key] = mv
        elif key.endswith((".raw", ".vlane")):
            lanes[key] = rng.standard_normal(P).astype(dt)
    if "v0.hllidx" in cols:
        idx, rank = hll_tables_padded(np.array([f"v{i:02d}"
                                                for i in range(50)]))
        lanes["v0.hllidx"], lanes["v0.hllrank"] = idx, rank
    assert {k: (str(v.dtype), v.shape) for k, v in lanes.items()} == \
        {k: (dt, tuple(P if d == "P" else d for d in shape))
         for k, (dt, shape) in cols.items()}
    lits = tuple(np.int32(7) for _ in params)
    return lanes, lits, list(lits), ()


def _compare(jax_out, port_out) -> None:
    assert set(jax_out) == set(port_out)
    for key, want in jax_out.items():
        want = np.asarray(want)
        got = port_out[key].cpu().numpy()
        assert got.shape == want.shape, key
        if want.dtype.kind == "f":
            np.testing.assert_allclose(got, want, rtol=FLOAT_RTOL, err_msg=key)
        else:
            np.testing.assert_array_equal(got, want, err_msg=key)


def _run_both(name, P, lanes, jax_params, params, group_params,
              device="cpu"):
    _n, filt, aggs, group, select, _cols, _p = _case(name)
    num_docs = P - 100
    want = jk.run_segment_kernel(P, filt, aggs, group, select,
                                 {k: jnp.asarray(v) for k, v in lanes.items()},
                                 jax_params, num_docs)
    got = tk.run_segment_kernel(
        P, filt, aggs, group, select,
        {k: torch.from_numpy(v).to(device) for k, v in lanes.items()},
        list(params), num_docs, device=device, group_params=group_params)
    return want, got


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("P", jk.CONTRACT_SHAPE_BUCKETS)
def test_group_scatter_case_equals_jax(P, seed):
    """group_scatter: g_pad 2 x DENSE_G_LIMIT, SUM of dictionary values by
    the JAX scatter fallback's ("vals",) strategy (the port decodes
    vals[ids] and folds it as K3's float sums, named gagg0.sum as JAX
    names it) and a raw MAX."""
    lanes, jax_params, params, group_params = _group_scatter_operands(P, seed)
    want, got = _run_both("group_scatter", P, lanes, jax_params, params,
                          group_params)
    _compare(want, got)
    assert set(got) == {"stats.num_docs_matched", "group.count",
                        "gagg0.sum", "gagg1.max"}
    assert int(got["stats.num_docs_matched"]) == P - 100


@pytest.mark.parametrize("span", ["narrow", "wide"])
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("P", jk.CONTRACT_SHAPE_BUCKETS)
def test_join_raw_probe_case_equals_jax(P, seed, span):
    """join_raw_probe: K1's join_raw leaf (the bitmap route at a narrow
    key span, the probe at a wide one) and K3's jraw key over the same
    dim side."""
    lanes, jax_params, params, group_params = _join_raw_probe_operands(
        P, seed, span)
    assert (params[0].bitmap_span() is not None) == (span == "narrow")
    want, got = _run_both("join_raw_probe", P, lanes, jax_params, params,
                          group_params)
    _compare(want, got)
    assert 0 < int(got["stats.num_docs_matched"]) < P - 100


@pytest.mark.parametrize("name", ["agg_float_hist", "agg_mv", "agg_hll"])
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("P", jk.CONTRACT_SHAPE_BUCKETS)
def test_histogram_case_equals_jax(P, seed, name):
    """K4's registry cases: the histogram (JAX's one-hot matrix products
    at card_pad 64), the MV entry histogram with COUNTMV's total and the
    fused HLL registers, key by key against JAX."""
    lanes, jax_params, params, group_params = _histogram_case_operands(
        name, P, seed)
    want, got = _run_both(name, P, lanes, jax_params, params, group_params)
    _compare(want, got)
    if name == "agg_hll":
        assert got["agg0.hll"].dtype == torch.int32
        assert int((got["agg0.hll"] > 0).sum()) > 0


def test_group_vals_spec_with_card_pad():
    """The planner's form of the spec, ("vals", card_pad), takes the same
    route as the registry's ("vals",): equal outputs."""
    P = jk.CONTRACT_SHAPE_BUCKETS[0]
    lanes, _jp, _p, _gp = _group_scatter_operands(P, 3)
    _n, filt, aggs, group, select, _c, _pp = _case("group_scatter")
    gcols, strides, g_pad, gaggs, kmax = group
    planner = (gcols, strides, g_pad,
               ((gaggs[0][0], gaggs[0][1], gaggs[0][2], ("vals", 512)),
                gaggs[1]), kmax)
    cols = {k: torch.from_numpy(v) for k, v in lanes.items()}
    a = tk.run_segment_kernel(P, filt, aggs, group, select, cols, [],
                              P - 100, device="cpu")
    b = tk.run_segment_kernel(P, filt, aggs, planner, select, cols, [],
                              P - 100, device="cpu")
    assert set(a) == set(b)
    for key in a:
        assert torch.equal(a[key], b[key]), key


@pytest.mark.cuda
@pytest.mark.parametrize("P", jk.CONTRACT_SHAPE_BUCKETS)
def test_group_scatter_case_cuda_equals_cpu(P):
    """group_scatter on the card (K1, then K3 over the decoded values at
    g_pad 65,536) against the CPU's plain answer and JAX's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    lanes, jax_params, params, group_params = _group_scatter_operands(P, 4)
    want, got = _run_both("group_scatter", P, lanes, jax_params, params,
                          group_params, device="cuda")
    _compare(want, got)
    cpu = _run_both("group_scatter", P, lanes, jax_params, params,
                    group_params)[1]
    for key in cpu:
        if cpu[key].dtype.is_floating_point:
            torch.testing.assert_close(got[key].cpu(), cpu[key],
                                       rtol=FLOAT_RTOL, atol=0)
        else:
            assert torch.equal(got[key].cpu(), cpu[key]), key


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["agg_float_hist", "agg_mv", "agg_hll"])
@pytest.mark.parametrize("P", jk.CONTRACT_SHAPE_BUCKETS)
def test_histogram_case_cuda_equals_cpu(P, name):
    """K4's registry cases on the card against the CPU's plain answer and
    JAX's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    lanes, jax_params, params, group_params = _histogram_case_operands(
        name, P, 5)
    want, got = _run_both(name, P, lanes, jax_params, params, group_params,
                          device="cuda")
    _compare(want, got)
    cpu = _run_both(name, P, lanes, jax_params, params, group_params)[1]
    for key in cpu:
        if cpu[key].dtype.is_floating_point:
            torch.testing.assert_close(got[key].cpu(), cpu[key],
                                       rtol=FLOAT_RTOL, atol=0)
        else:
            assert torch.equal(got[key].cpu(), cpu[key]), key
