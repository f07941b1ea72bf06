"""The JAX bench's SSB data in the port, held to JAX's bit for bit.

(a) K17's plain arithmetic: threefry2x32 against jax.extend.random's on
counters with nonzero high words, the key chain against jax.random.split,
randint (uint32 wrap included) and uniform against jax.random's.
(b) make_ssb_device_stack(mesh=make_mesh(["cpu"])) against
pinot_tpu.tools.datagen.make_ssb_device_stack on a one-device CPU mesh
(x64 on, as the suite runs JAX): every lane bit-equal, dtypes and
num_docs equal, at two shapes and seeds, one of them with `per` not a
multiple of the pad block; the derived and part lanes are exact
functions of the base ids; the 13 SSB queries over the synthesized stack
through ShardedQueryExecutor.execute_stack meet the numpy oracle on the
ids pulled back. (c) build_ssb_segment_dirs(star_tree=True) of both
packages writes the same segments and the same nine cubes. (d) On the
card: K17 against its plain version, bit for bit.
"""
from __future__ import annotations

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.extend.random import threefry_2x32

from pinot_tpu.parallel import make_mesh as jax_make_mesh
from pinot_tpu.tools import datagen as jax_datagen
from pinot_tpu_torch.ops import kernels as K
from pinot_tpu_torch.ops import synth
from pinot_tpu_torch.parallel import make_mesh
from pinot_tpu_torch.parallel.sharded import ShardedQueryExecutor
from pinot_tpu_torch.pql.optimizer import BrokerRequestOptimizer
from pinot_tpu_torch.pql.parser import compile_pql
from pinot_tpu_torch.query.reduce import BrokerReduceService
from pinot_tpu_torch.segment.loader import ImmutableSegmentLoader
from pinot_tpu_torch.startree.cube import StarTreeCube
from pinot_tpu_torch.tools import datagen
from pinot_tpu_torch.tools.ssb import (SSB_PQLS, canon_response, check,
                                       make_cpu_queries)

#: the SSB pools' cardinalities (lo_revenue's at seed 3), 1, a power of
#: two, and a span past 2^16 where randint's multiplier wraps
CARDS = [50, 11, 5627, 53, 84, 250, 1000, 1, 4096, 70_000]
#: (total_rows, num_segments, seed): the issue's shape, and one whose
#: per-segment rows (33,333) are not a multiple of the pad block
STACKS = [(160_000, 8, 3), (100_000, 3, 5)]


def _u32(a) -> np.ndarray:
    return np.asarray(a).astype(np.uint32)


def test_threefry_matches_jax_with_high_counter_words():
    rng = np.random.default_rng(11)
    for _ in range(4):
        key = rng.integers(0, 2**32, 2, dtype=np.uint64).astype(np.uint32)
        hi = rng.integers(0, 2**32, 512, dtype=np.uint64).astype(np.uint32)
        hi[:8] = [0, 1, 2, 3, 0xFFFFFFFF, 0x80000000, 7, 0]
        lo = rng.integers(0, 2**32, 512, dtype=np.uint64).astype(np.uint32)
        want = _u32(threefry_2x32(jnp.asarray(key),
                                  jnp.asarray(np.concatenate([hi, lo]))))
        y0, y1 = synth.threefry2x32_plain(
            int(key[0]), int(key[1]), torch.from_numpy(hi.astype(np.int64)),
            torch.from_numpy(lo.astype(np.int64)))
        got = np.concatenate([y0.numpy(), y1.numpy()]).astype(np.uint32)
        np.testing.assert_array_equal(got, want)


def test_random_bits_past_two_to_the_32_rows():
    """Rows at flat index >= 2^32 (SF >= 716 at the bench's layout) draw
    with hi = index >> 32, as iota_2x32_shape gives JAX's counters."""
    key = (0x12345678, 0x9ABCDEF0)
    index = torch.tensor([0, 1, 2**32 - 1, 2**32, 2**32 + 5, 3 * 2**32 + 7,
                          2**40 + 123], dtype=torch.int64)
    hi = (index >> 32).numpy().astype(np.uint32)
    lo = (index & synth.M32).numpy().astype(np.uint32)
    out = _u32(threefry_2x32(jnp.asarray(np.array(key, np.uint32)),
                             jnp.asarray(np.concatenate([hi, lo]))))
    want = out[:len(hi)] ^ out[len(hi):]
    got = synth.random_bits_plain(key, index).numpy().astype(np.uint32)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", [0, 3, 2**33 + 17])
def test_key_chain_matches_jax_split(seed):
    key = jax.random.PRNGKey(seed)
    want = []
    for _ in synth.SYNTH_DRAWS:
        key, sub = jax.random.split(key)
        k1, k2 = jax.random.split(sub)
        want.append(tuple(int(w) for w in np.concatenate(
            [_u32(k1), _u32(k2)])))
    key, sub = jax.random.split(key)
    keys = synth.ssb_synth_keys(seed, [1] * len(synth.SYNTH_DRAWS))
    assert list(keys.randint) == want
    assert keys.uniform == tuple(int(w) for w in _u32(sub))


@pytest.mark.parametrize("card", CARDS)
def test_randint_matches_jax(card):
    sub = jax.random.PRNGKey(card + 1)
    want = np.asarray(jax.random.randint(sub, (7, 1001), 0, card,
                                         dtype=jnp.int32)).ravel()
    k1, k2 = synth.split_key(tuple(int(w) for w in _u32(sub)))
    got = synth.randint_plain(k1 + k2, card, torch.arange(7 * 1001))
    np.testing.assert_array_equal(got.numpy(), want)


def test_uniform_matches_jax():
    key = jax.random.PRNGKey(9)
    want = np.asarray(jax.random.uniform(key, (3, 4099), jnp.float32) * 1e5)
    got = synth.uniform_plain((0, 9), torch.arange(3 * 4099)) * 1e5
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  want.ravel().view(np.uint32))


@pytest.fixture(scope="module", params=STACKS, ids=lambda s: "x".join(
    map(str, s)))
def stacks(request):
    rows, segs, seed = request.param
    jax_out = jax_datagen.make_ssb_device_stack(
        rows, segs, jax_make_mesh(jax.devices()[:1]), seed=seed)
    port_out = datagen.make_ssb_device_stack(rows, segs, make_mesh(["cpu"]),
                                             seed=seed)
    return request.param, jax_out, port_out


def test_device_stack_equals_jax_bit_for_bit(stacks):
    (rows, segs, _seed), (jl, jn, jp, jpad), (pl, pn, pp, ppad) = stacks
    assert ppad == jpad
    assert sorted(pl) == sorted(jl)
    for name, want in jl.items():
        want = np.asarray(want)
        got = pl[name].numpy()
        assert got.dtype == want.dtype, name
        assert got.shape == want.shape, name
        np.testing.assert_array_equal(got.view(np.uint8), want.view(np.uint8),
                                      err_msg=name)
    np.testing.assert_array_equal(pn.numpy(), np.asarray(jn))
    assert pn.dtype == torch.int32
    np.testing.assert_array_equal(
        pp.segments[0].data_source("lo_revenue").dictionary.values,
        jp.segments[0].data_source("lo_revenue").dictionary.values)
    assert jpad % K.BLOCK == 0 and (rows // segs) <= jpad


def test_derived_and_part_lanes_are_functions_of_the_base_ids(stacks):
    (_rows, _segs, seed), _jax, (lanes, _n, _pt, _pad) = stacks
    maps = datagen.ssb_derivation_tables(datagen.ssb_pools(seed))

    def ids(c):
        return lanes[f"{c}.ids"].numpy().astype(np.int64)

    ymn = ids("d_yearmonthnum")
    np.testing.assert_array_equal(ids("d_year"), ymn // 12)
    np.testing.assert_array_equal(ids("d_yearmonth"), maps["ymn_to_ym"][ymn])
    for side in ("c", "s"):
        nation = ids(f"{side}_city") // 10
        np.testing.assert_array_equal(ids(f"{side}_nation"), nation)
        np.testing.assert_array_equal(ids(f"{side}_region"),
                                      maps["nation_region"][nation])
    brand = ids("p_brand1")
    np.testing.assert_array_equal(ids("p_category"), brand // 40)
    np.testing.assert_array_equal(ids("p_mfgr"), brand // 200)
    vals = datagen.ssb_pools(seed)["lo_revenue"]
    parts = lanes["lo_revenue.parts"].numpy().astype(np.int64)
    rebuilt = sum(parts[:, k] << (7 * k) for k in range(parts.shape[1]))
    np.testing.assert_array_equal(rebuilt + vals[0], vals[ids("lo_revenue")])
    cost = lanes["lo_supplycost.raw"].numpy()
    assert cost.dtype == np.float32 and (cost >= 0).all() and \
        (cost < 1e5).all()


def test_plain_rows_equal_the_whole_stack(stacks):
    """synth_rows_plain at scattered rows (the chip check's sampling)
    equals the stack the wrapper made."""
    (rows, segs, seed), _jax, (lanes, _n, _pt, padded) = stacks
    keys, tables, _dtypes = datagen.ssb_synth_inputs(seed, "cpu")
    n_parts = lanes["lo_revenue.parts"].shape[1]
    index = torch.tensor([0, 1, padded - 1, padded, rows // segs,
                          segs * padded - 1], dtype=torch.int64)
    got = synth.synth_rows_plain(keys, tables, index)
    for name in synth.SYNTH_LANES:
        want = lanes[f"{name}.ids"].reshape(-1)[index]
        np.testing.assert_array_equal(got[name].numpy(), want.long().numpy(),
                                      err_msg=name)
    np.testing.assert_array_equal(
        got["lo_supplycost"].numpy(),
        lanes["lo_supplycost.raw"].reshape(-1)[index].numpy())
    flat_parts = lanes["lo_revenue.parts"].permute(1, 0, 2).reshape(
        n_parts, -1)
    np.testing.assert_array_equal(got["parts"].numpy(),
                                  flat_parts[:, index].numpy())


@pytest.fixture(scope="module")
def synth_engine():
    rows, segs, seed = STACKS[0]
    mesh = make_mesh(["cpu"])
    lanes, num_docs, plan_table, padded = datagen.make_ssb_device_stack(
        rows, segs, mesh, seed=seed)
    stack = datagen.SynthStack(lanes, num_docs, plan_table, padded)
    per = rows // segs
    ids = {name[:-4]: lanes[name][:, :per].reshape(-1).numpy()
           for name in lanes if name.endswith(".ids")}
    cost = lanes["lo_supplycost.raw"][:, :per].reshape(-1).double().numpy()
    oracle = make_cpu_queries(datagen.ssb_pools(seed), ids, cost)
    return ShardedQueryExecutor(mesh=mesh), stack, oracle


@pytest.mark.parametrize("q", sorted(SSB_PQLS))
def test_ssb_over_the_synthesized_stack_meets_the_oracle(synth_engine, q):
    executor, stack, oracle = synth_engine
    request = BrokerRequestOptimizer().optimize(compile_pql(SSB_PQLS[q]))
    resp = BrokerReduceService().reduce(
        request, [executor.execute_stack(request, stack)])
    assert not resp.exceptions
    got = canon_response(q, resp)
    check(q, got, oracle[q]())
    assert resp.num_segments_processed == stack.n_real


def test_synth_stack_refuses_a_lane_it_did_not_make(synth_engine):
    _executor, stack, _oracle = synth_engine
    with pytest.raises(KeyError, match="salary"):
        stack.gather([("salary", "raw")])
    parts = stack.gather([("lo_revenue", "parts")])["lo_revenue.parts"]
    assert parts.is_contiguous() and parts.shape[1] == stack.n_real


def _cube_files(d):
    return sorted(n for n in os.listdir(d) if n.startswith("startree."))


def test_ssb_dirs_with_cubes_equal_jax(tmp_path):
    """build_ssb_segment_dirs(star_tree=True): the same files as the JAX
    function's, byte for byte apart from the build time (metadata.json's
    creationTimeMs and crc, and the cube archives' zip timestamps, whose
    arrays and configs must be equal)."""
    rows, segs, seed = 60_000, 2, 3
    jdirs, jids, jcost = jax_datagen.build_ssb_segment_dirs(
        str(tmp_path / "jax"), rows, segs, seed=seed, star_tree=True)
    pdirs, pids, pcost = datagen.build_ssb_segment_dirs(
        str(tmp_path / "port"), rows, segs, seed=seed, star_tree=True)
    np.testing.assert_array_equal(pcost, jcost)
    for c in jids:
        np.testing.assert_array_equal(pids[c], jids[c])
    n_cubes = 0
    for jd, pd in zip(jdirs, pdirs):
        names = sorted(os.listdir(jd))
        assert names == sorted(os.listdir(pd))
        cubes = _cube_files(jd)
        assert len(cubes) == 2 * len(datagen.SSB_STAR_TREE_CONFIGS)
        n_cubes += len(cubes) // 2
        for name in names:
            with open(os.path.join(jd, name), "rb") as f:
                want = f.read()
            with open(os.path.join(pd, name), "rb") as f:
                got = f.read()
            if name == "metadata.json":
                jm, pm = json.loads(want), json.loads(got)
                for field in ("creationTimeMs", "crc"):
                    jm.pop(field, None)
                    pm.pop(field, None)
                assert pm == jm
            elif name.endswith(".npz"):
                with np.load(os.path.join(jd, name)) as a, \
                        np.load(os.path.join(pd, name)) as b:
                    assert sorted(a.files) == sorted(b.files), name
                    for k in a.files:
                        assert a[k].dtype == b[k].dtype, (name, k)
                        np.testing.assert_array_equal(a[k], b[k])
            else:
                assert got == want, name
        seg = ImmutableSegmentLoader.load(pd, device="cpu")
        assert [c.dimensions for c in seg.star_trees] == [
            c["dimensionsSplitOrder"] for c in datagen.SSB_STAR_TREE_CONFIGS]
        assert all(isinstance(c, StarTreeCube) and
                   int(c.counts.sum()) == seg.num_docs
                   for c in seg.star_trees)
    assert n_cubes == segs * len(datagen.SSB_STAR_TREE_CONFIGS)


# ---------------------------------------------------------------------------
# On the card: K17 against its plain version
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", STACKS, ids=lambda s: "x".join(map(str, s)))
def test_ssb_synth_cuda_matches_plain(cuda_device, shape):
    rows, segs, seed = shape
    lanes, num_docs, _pt, padded = datagen.make_ssb_device_stack(
        rows, segs, make_mesh(["cuda"]), seed=seed)
    want, want_n, _wpt, _wpad = datagen.make_ssb_device_stack(
        rows, segs, make_mesh(["cpu"]), seed=seed)
    for name, t in want.items():
        got = lanes[name].cpu()
        assert got.dtype == t.dtype and got.shape == t.shape, name
        assert torch.equal(got.view(torch.uint8) if got.is_floating_point()
                           else got, t.view(torch.uint8)
                           if t.is_floating_point() else t), name
    assert torch.equal(num_docs.cpu(), want_n)
    assert K.KERNELS["ssb_synth"].launches >= 1
