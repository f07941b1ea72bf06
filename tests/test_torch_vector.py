"""VECTOR_SIMILARITY on the port against the JAX package.

(a) Kernel functions: the plain versions of K8 (`vector_scores`, the
`vec_tree_sum` tree), K9 (`ivf_select_probes`) and K6's "vector" kind
(through run_segment_kernel, K1's ivf_probe node in front) against the
JAX functions on the same numpy operands: bit for bit, docids, scores
and counts, including the contract cases select_vector_dot,
select_vector_cosine_filtered and select_vector_ivf_probed
(pinot_tpu/ops/kernels.py:1867, :1873, :1886; their upsert `vdoc`
liveness predicate, a kind the port's K1 does not have yet, is given to
the port as the equal predicate `eq_id 1` over the same liveness as an
int8 lane; the JAX kernel runs op by op, see the test). (b) Twins of tests/test_vector.py (DIM 16, 2 segments of 2,048
rows): the port's QueryEngine per segment and stacked (device="cpu")
against the JAX engine and tests/oracle.py. (c) `cuda` tests hold each
kernel to its plain version on the card and skip where there is none.
"""
from __future__ import annotations

import json
import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oracle import Oracle
from pinot_tpu.common.datatype import DataType as JaxDataType
from pinot_tpu.common.schema import Schema as JaxSchema
from pinot_tpu.common.schema import dimension as jax_dimension
from pinot_tpu.common.schema import metric as jax_metric
from pinot_tpu.common.schema import vector as jax_vector
from pinot_tpu.common.table_config import IndexingConfig as JaxIndexingConfig
from pinot_tpu.common.table_config import TableConfig as JaxTableConfig
from pinot_tpu.engine import QueryEngine as JaxQueryEngine
from pinot_tpu.ops import kernels as jk
from pinot_tpu.segment.creator import SegmentCreator as JaxSegmentCreator
from pinot_tpu.segment.loader import ImmutableSegmentLoader as JaxLoader
from pinot_tpu_torch.common.datatype import DataType
from pinot_tpu_torch.common.request import VECTOR_RESULT_COLUMNS
from pinot_tpu_torch.common.schema import Schema, dimension, metric, vector
from pinot_tpu_torch.engine import QueryEngine
from pinot_tpu_torch.ops import kernels as tk
from pinot_tpu_torch.parallel import make_mesh
from pinot_tpu_torch.segment.creator import SegmentCreator
from pinot_tpu_torch.segment.loader import ImmutableSegmentLoader

DIM = 16
P = 8192


def _bits(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a, np.float32)).view(np.int32)


def _jax_np(x):
    return np.asarray(x)


# ---------------------------------------------------------------------------
# (a) kernel functions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dim_pad", [1, 2, 16, 128])
def test_vec_tree_sum_bit_equal(dim_pad):
    rng = np.random.default_rng(dim_pad)
    x = (rng.standard_normal((4099, dim_pad)) *
         rng.choice([1e-3, 1.0, 1e4], (4099, 1))).astype(np.float32)
    want = _bits(jk.vec_tree_sum(jnp.asarray(x)))
    np.testing.assert_array_equal(
        _bits(tk.vec_tree_sum_plain(torch.from_numpy(x)).numpy()), want)
    np.testing.assert_array_equal(_bits(tk.vec_tree_sum_plain(x)), want)


def _vec_operands(rows: int, dim_pad: int, seed: int):
    rng = np.random.default_rng(seed)
    mat = rng.standard_normal((rows, dim_pad)).astype(np.float32)
    mat[3] = 0.0                              # a zero-norm row
    mat[9] = mat[11]                          # tied rows
    q = rng.standard_normal(dim_pad).astype(np.float32)
    q_norm = np.float32(np.sqrt(tk.vec_tree_sum_plain(q * q)))
    return mat, q, q_norm


@pytest.mark.parametrize("metric", ["cosine", "dot"])
@pytest.mark.parametrize("dim_pad", [2, 16, 128])
def test_vector_scores_bit_equal(metric, dim_pad):
    mat, q, q_norm = _vec_operands(5000, dim_pad, seed=dim_pad)
    want = jk._vector_scores(jnp.asarray(mat), jnp.asarray(q),
                             jnp.float32(q_norm), metric)
    got = tk.vector_scores(torch.from_numpy(mat), q, q_norm, metric)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
    if metric == "cosine":
        assert got[3] == float("-inf")


@pytest.mark.parametrize("metric", ["cosine", "dot"])
@pytest.mark.parametrize("nprobe", [1, 5, 64])
def test_ivf_select_probes_bit_equal(metric, nprobe):
    rng = np.random.default_rng(nprobe)
    n_segs, c_pad, dim_pad = 3, 64, 16
    cent = rng.standard_normal((n_segs, c_pad, dim_pad)).astype(np.float32)
    cent[:, 7] = cent[:, 5]                  # tied centroids: lower id wins
    cvalid = rng.random((n_segs, c_pad)) < 0.7
    cvalid[2, :] = False
    cvalid[2, :3] = True                      # fewer live than nprobe
    q = rng.standard_normal(dim_pad).astype(np.float32)
    q_norm = np.float32(np.sqrt(tk.vec_tree_sum_plain(q * q)))
    ids, ok = tk.ivf_select_probes(torch.from_numpy(cent),
                                   torch.from_numpy(cvalid), q, q_norm,
                                   metric, nprobe)
    assert ids.shape == ok.shape == (n_segs, nprobe)
    for s in range(n_segs):
        want_ids, want_ok = jk.ivf_select_probes(
            jnp.asarray(cent[s]), jnp.asarray(cvalid[s]), jnp.asarray(q),
            jnp.float32(q_norm), metric, nprobe)
        np.testing.assert_array_equal(ids[s].numpy(), _jax_np(want_ids))
        np.testing.assert_array_equal(ok[s].numpy(), _jax_np(want_ok))
        one_ids, one_ok = tk.ivf_select_probes(
            torch.from_numpy(cent[s]), torch.from_numpy(cvalid[s]), q,
            q_norm, metric, nprobe)
        assert torch.equal(one_ids, ids[s]) and torch.equal(one_ok, ok[s])


def _probe_codebook(c_pad: int, dim_pad: int, live: str, seed: int):
    """A codebook with ties 1,024 ids apart (across what are separate
    tiles of K9's cluster) and next to each other, and its liveness:
    "mixed" (70% live), "few" (10 live, fewer than nprobe 16) or "none"
    (no live centroid: every key INT32_MIN, ids by id)."""
    rng = np.random.default_rng([c_pad, dim_pad, seed])
    cent = rng.standard_normal((c_pad, dim_pad)).astype(np.float32)
    for c in range(1024 + 5, c_pad, 1024):
        cent[c] = cent[5]
    if c_pad > 9:
        cent[9] = cent[8]
    cvalid = rng.random(c_pad) < 0.7
    if live == "few":
        cvalid[:] = False
        cvalid[rng.choice(c_pad, min(10, c_pad), replace=False)] = True
    elif live == "none":
        cvalid[:] = False
    q = rng.standard_normal(dim_pad).astype(np.float32)
    q_norm = np.float32(np.sqrt(tk.vec_tree_sum_plain(q * q)))
    return cent, cvalid, q, q_norm


@pytest.mark.parametrize("live", ["mixed", "few"])
@pytest.mark.parametrize("metric", ["cosine", "dot"])
@pytest.mark.parametrize("nprobe", [1, 16, 8192])
def test_ivf_select_probes_full_codebook_equals_jax(nprobe, metric, live):
    """The plain K9 over MAX_CENTROIDS (8,192 x 16) equals the JAX
    ivf_select_probes: ties across 1,024-id tiles go to the lower id,
    dead centroids rank after the live ones by id, ok marks the live
    count, at nprobe 1, 16 and the whole codebook."""
    cent, cvalid, q, q_norm = _probe_codebook(tk.MAX_CENTROIDS, 16, live, 0)
    want_ids, want_ok = jk.ivf_select_probes(
        jnp.asarray(cent), jnp.asarray(cvalid), jnp.asarray(q),
        jnp.float32(q_norm), metric, nprobe)
    ids, ok = tk.ivf_select_probes(torch.from_numpy(cent),
                                   torch.from_numpy(cvalid), q, q_norm,
                                   metric, nprobe)
    np.testing.assert_array_equal(ids.numpy(), _jax_np(want_ids))
    np.testing.assert_array_equal(ok.numpy(), _jax_np(want_ok))
    if live == "few":
        assert int(ok.sum()) == min(10, nprobe)


def test_query_upload_values_on_the_cpu():
    """_query: a numpy array, a float64 array or a list becomes the same
    f32 [dim_pad] values; a tensor already on the device passes through
    untouched; a wrong width or dtype raises."""
    rng = np.random.default_rng(6)
    q = rng.standard_normal(16).astype(np.float32)
    cpu = torch.device("cpu")
    for given in (q, q.astype(np.float64), list(q)):
        got = tk._query(given, 16, cpu)
        assert got.dtype == torch.float32 and got.device.type == "cpu"
        np.testing.assert_array_equal(got.numpy(), q)
    qt = torch.from_numpy(q)
    assert tk._query(qt, 16, cpu).data_ptr() == qt.data_ptr()
    with pytest.raises(ValueError, match="float32"):
        tk._query(q[:8], 16, cpu)
    with pytest.raises(ValueError, match="float32"):
        tk._query(qt.double(), 16, cpu)


# ---------------------------------------------------------------------------
# the kernels' add order, as numpy float32 lanes
# ---------------------------------------------------------------------------

#: vec_tree.cuh's kMaxMembers: the batched K8's member slots
K8_MEMBER_SLOTS = 8


def _lane_tree(leaves: np.ndarray) -> np.ndarray:
    """vec_tree.cuh:lane_tree over the last axis, literally: a binary
    counter over the leaves, leaf i closing one subtree per trailing one
    bit of i."""
    partial = []
    for i in range(leaves.shape[-1]):
        v = leaves[..., i]
        b = i
        while b & 1:
            v = partial.pop() + v
            b >>= 1
        partial.append(v)
    return partial[0]


def _warp_tree_scatter(v: np.ndarray, L: int) -> np.ndarray:
    """vec_tree.cuh:warp_tree_scatter over lanes: v [..., L lanes, N sums]
    to [..., L, N / min(N, L)]. At offset o lane x keeps its sums 2i +
    bit (bit = x & o) and adds lane x ^ o's copy of them, the subtree of
    the lane with bit o clear first (float addition is commutative and
    the card's NaNs are canonical, so the card's order of the two gives
    these bits); once a lane holds one sum, lane x adds lane x ^ o's."""
    lanes = np.arange(L)
    o = 1
    while o < L:
        lo, hi = lanes & ~o, lanes | o
        n = v.shape[-1]
        if n > 1:
            bit = ((lanes & o) != 0).astype(np.int64)
            idx = 2 * np.arange(n // 2)[None, :] + bit[:, None]   # [L, n/2]
            left = np.take_along_axis(v[..., lo, :], np.broadcast_to(
                idx, v.shape[:-2] + idx.shape), axis=-1)
            right = np.take_along_axis(v[..., hi, :], np.broadcast_to(
                idx, v.shape[:-2] + idx.shape), axis=-1)
            v = left + right
        else:
            v = v[..., lo, :] + v[..., hi, :]
        o <<= 1
    return v


def _scatter_scores_model(mat: np.ndarray, qs: np.ndarray, U: int,
                          slots: int = K8_MEMBER_SLOTS):
    """The dot and squared-norm sums of each (member, row) as the lanes of
    the batched K8 (`slots` member slots) and of K9 (one slot) hold them:
    a row over L = min(32, dim_pad) lanes of E elements, U rows a pass,
    the products' subtrees a lane (lane_tree), the U x slots dots (sum j
    = b * U + u, member slots past B zero) and the U norms reduced by
    warp_tree_scatter, and each lane's sum t read back as the kernels
    read it: dot j = (x & (K - 1)) + t * K, its row's norm at t % TN.
    Returns (dot [B, rows], norm2 [rows])."""
    rows, dim_pad = mat.shape
    B = qs.shape[0]
    L = min(32, dim_pad)
    E = dim_pad // L
    V = U * slots
    K, KN = min(V, L), min(U, L)
    T, TN = V // K, U // KN
    G = -(-rows // U)
    m = np.zeros((G * U, dim_pad), np.float32)
    m[:rows] = mat
    m = m.reshape(G, U, L, E)                                  # [G, U, L, E]
    q = np.zeros((slots, dim_pad), np.float32)
    q[:B] = qs
    q = q.reshape(slots, L, E)
    with np.errstate(over="ignore", invalid="ignore"):
        prod = m[:, None] * q[None, :, None]                   # [G, slots, U, L, E]
        dots = _lane_tree(prod)                                # [G, slots, U, L]
        dots = dots.reshape(G, V, L).transpose(0, 2, 1)        # [G, L, V]
        dots = _warp_tree_scatter(dots, L)                     # [G, L, T]
        norms = _lane_tree(m * m).transpose(0, 2, 1)           # [G, L, U]
        norms = _warp_tree_scatter(norms, L)                   # [G, L, TN]
    assert dots.shape == (G, L, T) and norms.shape == (G, L, TN)
    dot = np.full((B, G * U), np.nan, np.float32)
    norm2 = np.full(G * U, np.nan, np.float32)
    for x in range(L):
        for t in range(T):
            j = (x & (K - 1)) + t * K
            b, u = divmod(j, U)
            if x >= K:
                # a copy of lane x & (K - 1)'s sum, never stored
                np.testing.assert_array_equal(
                    dots[:, x, t].view(np.int32),
                    dots[:, x & (K - 1), t].view(np.int32))
                continue
            if b < B:
                dot[b, u::U] = dots[:, x, t]
            norm2[u::U] = norms[:, x, t % TN]
    return dot[:, :rows], norm2[:rows]

@pytest.mark.parametrize("dim_pad", [1 << i for i in range(13)])
def test_k9_scoring_order_equals_vec_tree_sum(dim_pad):
    """K9's scoring (one query, U = 1..16 rows a lane group, their dot
    and norm butterflies as one reduce-scatter each) gives JAX's
    vec_tree_sum bit for bit: random rows at three scales, zero rows and
    +-huge rows."""
    rng = np.random.default_rng(dim_pad)
    rows = 37
    mat = (rng.standard_normal((rows, dim_pad)) *
           rng.choice([1e-3, 1.0, 1e4], (rows, 1))).astype(np.float32)
    mat[1] = 0.0
    mat[2] = np.float32(3e38) * rng.choice([-1.0, 1.0], dim_pad)
    q = rng.standard_normal((1, dim_pad)).astype(np.float32)
    with np.errstate(over="ignore", invalid="ignore"):
        want = _bits(jk.vec_tree_sum(jnp.asarray(mat * q[0])))
        want_norm = _bits(jk.vec_tree_sum(jnp.asarray(mat * mat)))
    for U in (1, 2, 4, 8, 16):
        dot, norm2 = _scatter_scores_model(mat, q, U, slots=1)
        np.testing.assert_array_equal(_bits(dot[0]), want)
        np.testing.assert_array_equal(_bits(norm2), want_norm)


def _contract_case(name: str):
    for case in jk.contract_cases():
        if case[0] == name:
            return case
    raise KeyError(name)


def _draw(dtype: str, shape, rng, key: str = ""):
    shape = tuple(P if d == "P" else d for d in shape)
    if key.endswith(".ivfa"):
        return rng.integers(0, 65, shape).astype(dtype)   # 64 = sentinel
    if dtype == "bool":
        return rng.random(shape) < 0.8
    if dtype == "float32":
        return rng.standard_normal(shape).astype(np.float32)
    return rng.integers(0, 8, shape).astype(dtype)


def _to_port(filt, cols: dict, params: list):
    """The JAX case's operands for the port: its bool `vdoc` liveness lane
    as the port's uint8 lane; the filter, vdoc leaf included, and the
    params as they are."""
    cols = {k: v.astype(np.uint8) if k.endswith(".vdoc") else v
            for k, v in cols.items()}
    return filt, cols, list(params)


@pytest.mark.parametrize("name", ["select_vector_dot",
                                  "select_vector_cosine_filtered",
                                  "select_vector_ivf_probed"])
def test_vector_contract_cases_bit_equal(name):
    _n, filt, aggs, group, select, lane_specs, param_specs = \
        _contract_case(name)
    rng = np.random.default_rng(len(name))
    cols = {k: _draw(dt, shape, rng, k) for k, (dt, shape) in
            lane_specs.items()}
    cols[next(k for k in cols if k.endswith(".vec"))][5] = 0.0
    params = []
    for dt, shape in param_specs:
        if shape == (128,):
            q = rng.standard_normal(128).astype(np.float32)
            params.append(q)
        elif dt == "float32" and shape == ():
            params.append(np.float32(np.sqrt(tk.vec_tree_sum_plain(q * q))))
        else:
            params.append(np.int32(3))
    num_docs = P - 321
    # op by op, as the contract is written: XLA's CPU jit fuses the
    # 128-wide product into the tree's first level (one rounding where
    # the contract has two), so the jitted kernel's scores leave the
    # contract in the last bits at this width (its own numpy twin too)
    with jax.disable_jit():
        want = jk.build_segment_kernel(P, filt, aggs, group, select)(
            {k: jnp.asarray(v) for k, v in cols.items()}, tuple(params),
            jnp.int32(num_docs))
    port_filt, port_cols, port_params = _to_port(filt, cols, params)
    got = tk.run_segment_kernel(
        P, port_filt, aggs, group, select,
        {k: torch.from_numpy(np.ascontiguousarray(v))
         for k, v in port_cols.items()}, port_params, num_docs)
    assert int(got["sel.count"]) == int(want["sel.count"]) > 16
    np.testing.assert_array_equal(got["sel.docids"].numpy(),
                                  _jax_np(want["sel.docids"]))
    np.testing.assert_array_equal(_bits(got["sel.scores"].numpy()),
                                  _bits(want["sel.scores"]))
    for key in want:
        if key.startswith("sel.") and key not in ("sel.scores",):
            np.testing.assert_array_equal(got[key].numpy(),
                                          _jax_np(want[key]))


def test_vector_select_past_the_matches():
    """k above the match count: docid -1 and score 0 after the matches,
    per segment of a stack too."""
    mat, q, q_norm = _vec_operands(2 * P, 16, seed=4)
    mask = torch.zeros(2 * P, dtype=torch.uint8)
    mask[[1, 5, 9, 11, P + 2]] = 1
    cols = {"e.vec": torch.from_numpy(mat)}
    spec = ("vector", 8, (("e", "cosine", 16),), ())
    out = tk.masked_select(spec, cols, mask, 2, vector_params=(q, q_norm))
    assert out["sel.count"].tolist() == [4, 1]
    docids = out["sel.docids"].numpy()
    assert (docids[0, 4:] == -1).all() and (docids[1, 1:] == -1).all()
    assert (out["sel.scores"].numpy()[docids == -1] == 0).all()
    # rows 9 and 11 tie: the lower docid ranks first
    order = list(docids[0, :4])
    assert order.index(9) == order.index(11) - 1
    with pytest.raises(ValueError, match="query"):
        tk.masked_select(spec, cols, mask, 2)


# ---------------------------------------------------------------------------
# (b) twins of tests/test_vector.py
# ---------------------------------------------------------------------------


def jax_vec_schema(dim=DIM):
    return JaxSchema("vectab", [
        jax_dimension("shard", JaxDataType.INT),
        jax_metric("rid", JaxDataType.INT),
        jax_vector("emb", dim)])


def vec_schema(dim=DIM):
    return Schema("vectab", [dimension("shard", DataType.INT),
                             metric("rid", DataType.INT),
                             vector("emb", dim)])


def vec_columns(n, seed=0, dim=DIM, rid_base=0):
    rng = np.random.default_rng(seed)
    return {"shard": rng.integers(0, 4, n).astype(np.int32),
            "rid": (np.arange(n, dtype=np.int32) + rid_base),
            "emb": rng.standard_normal((n, dim)).astype(np.float32)}


def build_vec_dirs(base, n_segs=2, n=2048, dim=DIM, seed=3, version="v1"):
    """Segment directories written by the JAX creator, as
    tests/test_vector.py builds them."""
    dirs, cols_list = [], []
    idx = JaxIndexingConfig()
    idx.segment_version = version
    cfg = JaxTableConfig("vectab", indexing_config=idx)
    for s in range(n_segs):
        cols = vec_columns(n, seed=seed + s, dim=dim, rid_base=s * n)
        d = os.path.join(base, f"v{s}")
        JaxSegmentCreator(jax_vec_schema(dim), cfg,
                          segment_name=f"v{s}").build(cols, d)
        dirs.append(d)
        cols_list.append(cols)
    return dirs, cols_list


def pql_for(q, k=7, metric="COSINE", where="WHERE shard < 2",
            select="rid, "):
    qs = ", ".join(repr(float(x)) for x in q)
    return (f"SELECT {select}VECTOR_SIMILARITY(emb, [{qs}], {k}, "
            f"'{metric}') FROM vectab {where}").strip()


def result_rows(resp):
    assert not resp.exceptions, resp.exceptions
    return [tuple(r) for r in resp.selection_results.results]


@pytest.fixture(scope="module")
def vec_setup():
    base = tempfile.mkdtemp()
    dirs, cols_list = build_vec_dirs(base)
    q = np.random.default_rng(99).standard_normal(DIM).astype(np.float32)
    jax_segs = [JaxLoader.load(d) for d in dirs]
    return {
        "dirs": dirs, "cols": cols_list, "q": q,
        "jax": JaxQueryEngine(jax_segs),
        "jax_host": JaxQueryEngine(jax_segs, use_device=False),
        "port": QueryEngine.from_dirs(dirs, device="cpu"),
        "stacked": QueryEngine.from_dirs(dirs, device="cpu",
                                         mesh=make_mesh(["cpu"])),
    }


@pytest.mark.parametrize("version", ["v1", "v3"])
def test_build_load_roundtrip(tmp_path, version):
    """A JAX-built VECTOR segment (v1 directory or v3 container) loads
    into the port with its embeddings and the padded device lane; a
    port-built one is byte-identical to the JAX creator's apart from the
    creation time."""
    dirs, cols_list = build_vec_dirs(str(tmp_path / "jax"), n_segs=1, n=512,
                                     version=version)
    seg = ImmutableSegmentLoader.load(dirs[0])
    assert seg.metadata.crc
    ds = seg.data_source("emb")
    assert ds.metadata.vector_dimension == DIM
    assert not ds.metadata.has_dictionary
    np.testing.assert_array_equal(ds.vec_values, cols_list[0]["emb"])
    op = ds.host_operand("vec")
    assert op.shape == (P, DIM) and op.dtype == np.float32
    np.testing.assert_array_equal(op[:512], cols_list[0]["emb"])
    assert op[512:].sum() == 0
    assert ds.ivf_centroids is None
    if version == "v1":
        pdir = str(tmp_path / "port")
        SegmentCreator(vec_schema(), segment_name="v0").build(
            vec_columns(512, seed=3), pdir)
        assert sorted(os.listdir(pdir)) == sorted(os.listdir(dirs[0]))
        for name in os.listdir(pdir):
            with open(os.path.join(pdir, name), "rb") as f:
                got = f.read()
            with open(os.path.join(dirs[0], name), "rb") as f:
                want = f.read()
            if name == "metadata.json":
                got, want = json.loads(got), json.loads(want)
                for field in ("creationTimeMs", "crc"):
                    got.pop(field, None)
                    want.pop(field, None)
            assert got == want, name


def test_dimension_mismatch_rejected_at_build(tmp_path):
    cols = vec_columns(64)
    cols["emb"] = cols["emb"][:, :8]
    with pytest.raises(ValueError, match="dimension"):
        SegmentCreator(vec_schema(), segment_name="bad").build(
            cols, str(tmp_path / "bad"))


@pytest.mark.parametrize("metric", ["COSINE", "DOT"])
def test_filtered_topk_bit_identical_and_oracle(vec_setup, metric):
    q = vec_setup["q"]
    pql = pql_for(q, k=9, metric=metric)
    want = result_rows(vec_setup["jax"].query(pql))
    assert result_rows(vec_setup["port"].query(pql)) == want
    stacked = vec_setup["stacked"]
    assert result_rows(stacked.query(pql)) == want
    assert stacked.last_route == ("stacked", None)
    assert len(want) == 9
    cand = []
    for s, cols in enumerate(vec_setup["cols"]):
        o = Oracle(cols)
        m = o.mask(lambda r: r["shard"] < 2)
        for doc, score in o.vector_topk("emb", q, 9, m,
                                        metric=metric.lower()):
            cand.append((-score, f"v{s}", doc, int(cols["rid"][doc]),
                         score))
    cand.sort()
    assert want == [(rid, doc, name, score)
                    for _ns, name, doc, rid, score in cand[:9]]
    cols = vec_setup["port"].query(pql).selection_results.columns
    assert cols == ["rid"] + list(VECTOR_RESULT_COLUMNS)


def test_empty_filter_returns_no_rows(vec_setup):
    pql = pql_for(vec_setup["q"], where="WHERE shard = 999")
    for engine in ("port", "stacked", "jax"):
        resp = vec_setup[engine].query(pql)
        assert result_rows(resp) == []
        assert resp.selection_results.columns == \
            ["rid"] + list(VECTOR_RESULT_COLUMNS)


def test_predicate_over_vector_column_rejected(vec_setup):
    pql = pql_for(vec_setup["q"], where="WHERE emb = 1")
    for engine in ("port", "stacked"):
        with pytest.raises(ValueError, match="VECTOR"):
            vec_setup[engine].query(pql)


def test_dimension_mismatch_query_errors(vec_setup):
    for engine in ("port", "stacked"):
        with pytest.raises(ValueError, match="dimension"):
            vec_setup[engine].query(
                "SELECT VECTOR_SIMILARITY(emb, [1.0, 2.0], 3) FROM vectab")


def test_zero_query_vector_cosine_rejected(vec_setup):
    zeros = ", ".join(["0.0"] * DIM)
    for engine in ("port", "stacked"):
        with pytest.raises(ValueError, match="non-zero"):
            vec_setup[engine].query(
                f"SELECT VECTOR_SIMILARITY(emb, [{zeros}], 3) FROM vectab")
        # DOT accepts a zero query: every score 0.0, docid order
        rows = result_rows(vec_setup[engine].query(
            f"SELECT VECTOR_SIMILARITY(emb, [{zeros}], 3, 'DOT') "
            "FROM vectab"))
        assert [r[-1] for r in rows] == [0.0, 0.0, 0.0]
        assert [r[0] for r in rows] == [0, 1, 2]


def test_k_larger_than_matches_returns_all(vec_setup):
    pql = pql_for(vec_setup["q"], k=5000, where="WHERE shard = 3")
    n_exp = sum(int((c["shard"] == 3).sum()) for c in vec_setup["cols"])
    want = result_rows(vec_setup["jax_host"].query(pql))
    assert len(want) == min(n_exp, 5000)
    for engine in ("port", "stacked"):
        assert result_rows(vec_setup[engine].query(pql)) == want


def test_vector_column_selectable_on_host_path(vec_setup):
    """A selection of the VECTOR column itself has no device gather lane:
    the planner refuses it, as the JAX planner does, and the host twin
    answers with the embeddings as float lists."""
    pql = "SELECT emb FROM vectab LIMIT 2"
    port = vec_setup["port"]
    port.executor.reset_path_counts()
    rows = result_rows(port.query(pql))
    assert port.executor.path_counts["host"] == 2
    assert len(rows) == 2 and len(rows[0][0]) == DIM
    assert rows == result_rows(vec_setup["jax_host"].query(pql))


# ---------------------------------------------------------------------------
# (c) the kernels on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("metric", ["cosine", "dot"])
@pytest.mark.parametrize("dim_pad", [1, 16, 128, 1024])
def test_vector_scores_cuda_bit_equal_plain(cuda_device, metric, dim_pad):
    mat, q, q_norm = _vec_operands(70001, dim_pad, seed=dim_pad)
    m = torch.from_numpy(mat).to(cuda_device)
    got = tk.vector_scores(m, q, q_norm, metric)
    want = tk.vector_scores_plain(m, q, q_norm, metric)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


#: launches of each K9 case on the card: a race between the cluster's
#: CTAs shows only as a wrong id now and then
K9_REPEATS = 20


@pytest.mark.cuda
@pytest.mark.parametrize("metric", ["cosine", "dot"])
@pytest.mark.parametrize("c_pad,dim_pad", [(1, 128), (256, 128), (1024, 128),
                                           (8192, 128), (2048, 1),
                                           (1500, 4), (2048, 4096)])
def test_ivf_select_probes_cuda_equal_plain(cuda_device, c_pad, dim_pad,
                                            metric):
    """K9's cluster ranking (1 CTA up to 1,024 centroids, 8 at 8,192; an
    odd 1,500 in 2 tiles of 750) at 128 dims and at the widths' extremes
    (a lane a row, 128 floats a lane): single, stacked and batched B =
    1..8, ties across tiles, a codebook with no live centroid (the
    "mixed" and "none" ones of _probe_codebook), nprobe 1, 16 and C_pad,
    each launch repeated K9_REPEATS times against the plain version."""
    for live in ("mixed", "none"):
        books = [_probe_codebook(c_pad, dim_pad, live, seed)
                 for seed in range(8)]
        cent, cvalid, q, q_norm = books[0]
        host = (torch.from_numpy(cent), torch.from_numpy(cvalid))
        card = tuple(t.to(cuda_device) for t in host)
        st_host = (torch.from_numpy(np.stack([b[0] for b in books[:3]])),
                   torch.from_numpy(np.stack([b[1] for b in books[:3]])))
        st_card = tuple(t.to(cuda_device) for t in st_host)
        qs, norms = [b[2] for b in books], [b[3] for b in books]
        for nprobe in sorted({1, min(16, c_pad), c_pad}):
            cases = [
                (tk.ivf_select_probes_plain(*host, q, q_norm, metric,
                                            nprobe),
                 lambda: tk.ivf_select_probes(*card, q, q_norm, metric,
                                              nprobe)),
                (tk.ivf_select_probes_plain(*st_host, q, q_norm, metric,
                                            nprobe),
                 lambda: tk.ivf_select_probes(*st_card, q, q_norm, metric,
                                              nprobe))]
            for B in range(1, 9):
                cases.append((
                    tk.ivf_select_probes_batched_plain(
                        *host, qs[:B], norms[:B], metric, nprobe),
                    lambda B=B: tk.ivf_select_probes_batched(
                        *card, qs[:B], norms[:B], metric, nprobe)))
            for want, launch in cases:
                for _ in range(K9_REPEATS):
                    ids, ok = launch()
                    assert torch.equal(ids.cpu(), want[0]), \
                        (live, nprobe, ids.shape)
                    assert torch.equal(ok.cpu(), want[1]), \
                        (live, nprobe, ok.shape)


@pytest.mark.cuda
def test_vector_wrappers_no_host_sync(cuda_device):
    """K8 and K9, single, stacked and batched, take numpy queries (as the
    planner passes them) without a host wait: they run under
    torch.cuda.set_sync_debug_mode("error"), and their outputs equal the
    plain versions'."""
    mat, q, q_norm = _vec_operands(70001, 128, seed=7)
    cent, cvalid, _q, _n = _probe_codebook(8192, 128, "mixed", 2)
    rng = np.random.default_rng(8)
    qs = [rng.standard_normal(128).astype(np.float32) for _ in range(8)]
    norms = [np.float32(np.sqrt(tk.vec_tree_sum_plain(x * x))) for x in qs]
    m = torch.from_numpy(mat).to(cuda_device)
    c, v = (torch.from_numpy(cent).to(cuda_device),
            torch.from_numpy(cvalid).to(cuda_device))
    sc, sv = c.reshape(4, 2048, 128), v.reshape(4, 2048)
    calls = {
        "vector_scores": lambda: tk.vector_scores(m, q, q_norm, "cosine"),
        "vector_scores_batched": lambda: tk.vector_scores_batched(
            m, qs, norms, "cosine"),
        "ivf_select_probes": lambda: tk.ivf_select_probes(
            c, v, q, q_norm, "cosine", 16),
        "ivf_select_probes stacked": lambda: tk.ivf_select_probes(
            sc, sv, q, q_norm, "dot", 16),
        "ivf_select_probes_batched": lambda: tk.ivf_select_probes_batched(
            c, v, qs, norms, "cosine", 16)}
    plain = {
        "vector_scores": lambda: tk.vector_scores_plain(m, q, q_norm,
                                                        "cosine"),
        "vector_scores_batched": lambda: tk.vector_scores_batched_plain(
            m, qs, norms, "cosine"),
        "ivf_select_probes": lambda: tk.ivf_select_probes_plain(
            c, v, q, q_norm, "cosine", 16),
        "ivf_select_probes stacked": lambda: tk.ivf_select_probes_plain(
            sc, sv, q, q_norm, "dot", 16),
        "ivf_select_probes_batched": lambda:
        tk.ivf_select_probes_batched_plain(c, v, qs, norms, "cosine", 16)}
    for name, call in calls.items():
        call()                          # built and loaded outside the check
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            got = call()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        want = plain[name]()
        for g, w in zip(got if isinstance(got, tuple) else (got,),
                        want if isinstance(want, tuple) else (want,)):
            assert torch.equal(g.view(torch.int32) if g.is_floating_point()
                               else g,
                               w.view(torch.int32) if w.is_floating_point()
                               else w), name


@pytest.mark.parametrize("tool", ["vector_kernel_bench", "vector_e2e_bench"])
def test_vector_bench_tools_need_a_card(monkeypatch, capsys, tool):
    """The vector timing tools refuse to run without a CUDA card (exit
    2), before they build or time anything."""
    import importlib
    mod = importlib.import_module(f"pinot_tpu_torch.tools.{tool}")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert mod.main([]) == 2
    assert "CUDA" in capsys.readouterr().err


def test_one_yardstick_for_chip_smoke_and_the_benches():
    """chip_smoke.py and the bench tools time with tools/timing.py, and its
    bound is the larger of the byte time and the operation time."""
    import chip_smoke
    from pinot_tpu_torch.tools import join_leaf_bench, timing
    from pinot_tpu_torch.tools import vector_kernel_bench
    assert chip_smoke.time_ms is timing.time_ms
    assert chip_smoke.launch_breakdown is timing.launch_breakdown
    assert chip_smoke.bound is timing.bound
    assert join_leaf_bench.time_ms is timing.time_ms
    assert os.path.samefile(vector_kernel_bench.T.__file__, timing.__file__)
    assert timing.bound(timing.HBM_BYTES_PER_S, 1.0) == \
        (pytest.approx(1e3), "bytes")
    assert timing.bound(1.0, timing.SCALAR_OPS_PER_S * 2) == \
        (pytest.approx(2e3), "operations")


@pytest.mark.cuda
@pytest.mark.parametrize("stacked", [False, True])
def test_vector_plan_cuda_equal_plain(cuda_device, stacked):
    """K9, K1's ivf_probe node, K8 and K6's vector kind through the
    dispatch, one segment and a stack of three."""
    rng = np.random.default_rng(3)
    n_segs, c_pad = 3, 64
    cols = {"e0.vec": rng.standard_normal((n_segs, P, 128))
            .astype(np.float32),
            "e0.ivfa": rng.integers(0, c_pad + 1, (n_segs, P))
            .astype(np.int8),
            "e0.ivfc": rng.standard_normal((n_segs, c_pad, 128))
            .astype(np.float32),
            "e0.ivfv": rng.random((n_segs, c_pad)) < 0.9,
            "d0.ids": rng.integers(0, 5, (n_segs, P)).astype(np.int8)}
    q = rng.standard_normal(128).astype(np.float32)
    q_norm = np.float32(np.sqrt(tk.vec_tree_sum_plain(q * q)))
    filt = ("and", (("pred", "ivf_probe", "e0", "ivf", (8, "cosine")),
                    ("pred", "eq_id", "d0", "sv", None)))
    select = ("vector", 16, (("e0", "cosine", 128),), (("d0", "sv"),))
    params = [q, q_norm, np.int32(2), q, q_norm]
    host = {k: torch.from_numpy(v) for k, v in cols.items()}
    card = {k: v.to(cuda_device) for k, v in host.items()}
    if stacked:
        docs = torch.tensor([P - 100, P, 5], dtype=torch.int32)
        got = tk.run_stacked_kernel(P, n_segs, filt, (), None, select, card,
                                    params, docs.to(cuda_device))
        want = tk.run_stacked_kernel(P, n_segs, filt, (), None, select,
                                     host, params, docs)
    else:
        got = tk.run_segment_kernel(P, filt, (), None, select,
                                    {k: v[0] for k, v in card.items()},
                                    params, P - 100)
        want = tk.run_segment_kernel(P, filt, (), None, select,
                                     {k: v[0] for k, v in host.items()},
                                     params, P - 100)
    assert set(got) == set(want)
    for key in want:
        assert torch.equal(got[key].cpu(), want[key]), key


# ---------------------------------------------------------------------------
# (d) the vector configuration (tools/vecdata.py) and its oracle
# ---------------------------------------------------------------------------


def test_vecdata_draws_are_the_scripts():
    """VecDraws draws what scripts/vec_ann_bench.py draws from its seed:
    the centres, each segment's rows, then the query vectors."""
    from pinot_tpu_torch.tools import vecdata
    rows, segs, dim, n_c = 4000, 4, 8, 16
    draws = vecdata.VecDraws(rows, segs, dim, n_c, seed=2016)
    got = [draws.segment(s)["emb"] for s in range(segs)]
    got_q = draws.queries(3)
    rng = np.random.default_rng(2016)
    centers = rng.standard_normal((n_c, dim)).astype(np.float32) * 4
    for s in range(segs):
        which = rng.integers(0, n_c, rows // segs)
        want = centers[which] + rng.standard_normal(
            (rows // segs, dim)).astype(np.float32) * 0.3
        np.testing.assert_array_equal(got[s], want)
    for q in got_q:
        want = centers[int(rng.integers(n_c))] + \
            rng.standard_normal(dim).astype(np.float32) * 0.3
        np.testing.assert_array_equal(q, want)


def test_vecdata_engine_equals_oracle(tmp_path):
    """The port's engine over a small vecbench table (codebooks trained
    on the CPU): exact answers equal VecOracle bit for bit, filtered
    too, per segment and stacked; probing keeps the recall."""
    from pinot_tpu_torch.tools import vecdata
    dirs, draws, _secs = vecdata.build_segment_dirs(
        str(tmp_path), rows=20000, segments=2, dim=32, centers=16,
        sample=4096, device="cpu")
    engine = QueryEngine.from_dirs(dirs, device="cpu")
    stacked = QueryEngine.from_dirs(dirs, device="cpu",
                                    mesh=make_mesh(["cpu"]))
    oracle = vecdata.VecOracle(
        [(s.segment_name, s.data_source("emb").vec_values)
         for s in engine.segments], chunk=3000)
    masks = [s.data_source("rid").dictionary.values[
        s.data_source("rid").dict_ids] < 7000 for s in engine.segments]
    for q in draws.queries(2):
        qs = ", ".join(repr(float(x)) for x in q)
        for metric in ("COSINE", "DOT"):
            pql = (f"SELECT rid, VECTOR_SIMILARITY(emb, [{qs}], 10, "
                   f"'{metric}') FROM vecbench")
            want = oracle.topk(q, 10, metric)
            want_f = oracle.topk(q, 10, metric, masks)
            for eng in (engine, stacked):
                rows = result_rows(eng.query(pql))
                assert [(r[1], r[2], r[3]) for r in rows] == want
                rows = result_rows(eng.query(pql + " WHERE rid < 7000"))
                assert [(r[1], r[2], r[3]) for r in rows] == want_f
            probed = engine.query(pql.replace(f"'{metric}')",
                                              f"'{metric}', nprobe=4)"))
            got = [tuple(r[1:3]) for r in result_rows(probed)]
            assert vecdata.recall(got, [w[:2] for w in want]) >= 0.9
            assert probed.num_docs_scanned < 0.5 * 20000
