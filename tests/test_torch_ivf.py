"""The port's IVF index (index/ivf.py over K9-K11) against the JAX package.

(a) Kernel functions: K10 `ivf_assign` and the train step (K10 then K11
`ivf_recenter`) against pinot_tpu/ops/ivf_kernels.py on the shapes of its
`extra_contract_cases` (n_pad rows, 64 centroids, 128 dims), on
well-separated clusters: assignments equal; distances within rtol 1e-5 /
atol 1e-3 and centroids within rtol 1e-5 / atol 1e-5 (the JAX kernels sum
with XLA matmuls, the port in its own order: training has no
cross-backend bit contract, the JAX module says so). (b) Twins of
tests/test_ivf.py (DIM 16, 2 segments of 2,048 rows, 16 centroids): the
JAX-built directories load into the port and its probed answers equal the
JAX engine's bit for bit, per segment and stacked; the port's own creator
trains byte-identical codebooks run after run. (c) `cuda` tests hold K10
and K11 to their plain versions on the card (K11 also with every row on
one centroid, empty centroids and Zipf-skewed assignments, at dim_pad 1 to
4,096 and c_pad 8 to 4,096) and skip where there is none.
"""
from __future__ import annotations

import os
import tempfile

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pinot_tpu.common.datatype import DataType as JaxDataType
from pinot_tpu.common.schema import Schema as JaxSchema
from pinot_tpu.common.schema import dimension as jax_dimension
from pinot_tpu.common.schema import metric as jax_metric
from pinot_tpu.common.schema import vector as jax_vector
from pinot_tpu.common.table_config import IndexingConfig as JaxIndexingConfig
from pinot_tpu.common.table_config import TableConfig as JaxTableConfig
from pinot_tpu.engine import QueryEngine as JaxQueryEngine
from pinot_tpu.index import ivf as jax_ivf
from pinot_tpu.ops import ivf_kernels as jik
from pinot_tpu.segment.creator import SegmentCreator as JaxSegmentCreator
from pinot_tpu.segment.loader import ImmutableSegmentLoader as JaxLoader
from pinot_tpu_torch.common.datatype import DataType
from pinot_tpu_torch.common.schema import Schema, dimension, metric, vector
from pinot_tpu_torch.common.table_config import IndexingConfig, TableConfig
from pinot_tpu_torch.engine import QueryEngine
from pinot_tpu_torch.index import ivf
from pinot_tpu_torch.ops import ivf_kernels as ik
from pinot_tpu_torch.ops import kernels as tk
from pinot_tpu_torch.parallel import NotShardable, ShardedQueryExecutor, \
    make_mesh
from pinot_tpu_torch.pql.parser import compile_pql
from pinot_tpu_torch.segment.creator import SegmentCreator
from pinot_tpu_torch.segment.loader import ImmutableSegmentLoader

DIM = 16
N_CENTROIDS = 16
DIST_RTOL, DIST_ATOL = 1e-5, 1e-3
CENT_RTOL, CENT_ATOL = 1e-5, 1e-5


# ---------------------------------------------------------------------------
# (a) kernel functions
# ---------------------------------------------------------------------------


def _clusters(n: int, c: int, dim: int, seed: int):
    """Rows around c well-separated centres, and c of them as centroids."""
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((c, dim)).astype(np.float32) * 4
    data = (centers[rng.integers(0, c, n)] +
            rng.standard_normal((n, dim)).astype(np.float32) * 0.3)
    return data.astype(np.float32), centers


@pytest.mark.parametrize("n_pad", [8192, 16384])
def test_ivf_assign_matches_jax(n_pad):
    data, centers = _clusters(n_pad, 64, 128, seed=n_pad)
    n_rows, n_cent = n_pad - 77, 61          # padding rows, dead centroids
    want = jik.build_ivf_assign_kernel(n_pad, 64, 128)(
        jnp.asarray(data), jnp.asarray(centers), jnp.int32(n_rows),
        jnp.int32(n_cent))
    assign, dist = ik.ivf_assign(torch.from_numpy(data),
                                 torch.from_numpy(centers), n_rows, n_cent)
    np.testing.assert_array_equal(assign.numpy(),
                                  np.asarray(want["ivf.assign"]))
    assert assign.max() < n_cent
    np.testing.assert_allclose(dist.numpy(), np.asarray(want["ivf.dist"]),
                               rtol=DIST_RTOL, atol=DIST_ATOL)
    assert (dist.numpy()[n_rows:] == 0).all()


@pytest.mark.parametrize("n_pad", [8192, 16384])
def test_ivf_train_step_matches_jax(n_pad):
    data, centers = _clusters(n_pad, 64, 128, seed=n_pad + 1)
    prior = centers + np.float32(0.5)
    prior[63] = 1e3                           # a centroid no row picks
    n_rows = n_pad - 77
    want = jik.build_ivf_train_kernel(n_pad, 64, 128)(
        jnp.asarray(data), jnp.asarray(prior), jnp.int32(n_rows),
        jnp.int32(64))
    got = ik.ivf_train_step(torch.from_numpy(data), torch.from_numpy(prior),
                            n_rows, 64)
    np.testing.assert_array_equal(got["ivf.counts"].numpy(),
                                  np.asarray(want["ivf.counts"]))
    assert int(got["ivf.counts"][63]) == 0
    np.testing.assert_array_equal(got["ivf.centroids"][63].numpy(),
                                  prior[63])
    np.testing.assert_allclose(got["ivf.centroids"].numpy(),
                               np.asarray(want["ivf.centroids"]),
                               rtol=CENT_RTOL, atol=CENT_ATOL)


def test_ivf_probe_select_kernel_matches_jax():
    rng = np.random.default_rng(8)
    cent = rng.standard_normal((64, 128)).astype(np.float32)
    cvalid = rng.random(64) < 0.8
    q = rng.standard_normal(128).astype(np.float32)
    q_norm = np.float32(np.sqrt(tk.vec_tree_sum_plain(q * q)))
    want = jik.build_ivf_probe_kernel(64, 128, 8, "dot")(
        jnp.asarray(cent), jnp.asarray(cvalid), jnp.asarray(q),
        jnp.float32(q_norm))
    got = ik.ivf_probe_select(torch.from_numpy(cent),
                              torch.from_numpy(cvalid), q, q_norm, "dot", 8)
    for key in ("ivf.probe", "ivf.probe_ok"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]))


# ---------------------------------------------------------------------------
# (b) twins of tests/test_ivf.py
# ---------------------------------------------------------------------------


def jax_ivf_schema(dim=DIM):
    return JaxSchema("vectab", [jax_dimension("shard", JaxDataType.INT),
                                jax_metric("rid", JaxDataType.INT),
                                jax_vector("emb", dim)])


def ivf_schema(dim=DIM):
    return Schema("vectab", [dimension("shard", DataType.INT),
                             metric("rid", DataType.INT),
                             vector("emb", dim)])


def ivf_table_config(num_centroids=N_CENTROIDS, indexed=True, jax=False):
    idx = (JaxIndexingConfig if jax else IndexingConfig)()
    if indexed:
        idx.vector_index_configs = {"emb": {"numCentroids": num_centroids}}
    return (JaxTableConfig if jax else TableConfig)(
        "vectab", indexing_config=idx)


def clustered_columns(n, seed=0, dim=DIM, rid_base=0, n_clusters=8):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((n_clusters, dim)).astype(np.float32) * 4
    which = rng.integers(0, n_clusters, n)
    emb = centers[which] + \
        rng.standard_normal((n, dim)).astype(np.float32) * 0.3
    return {"shard": rng.integers(0, 4, n).astype(np.int32),
            "rid": (np.arange(n, dtype=np.int32) + rid_base),
            "emb": emb.astype(np.float32)}


def build_jax_dirs(base, n_segs=2, n=2048, seed=3, indexed=True):
    """Directories the JAX creator writes (codebooks trained by XLA)."""
    dirs = []
    for s in range(n_segs):
        d = os.path.join(base, f"v{s}")
        JaxSegmentCreator(jax_ivf_schema(), ivf_table_config(
            indexed=indexed, jax=True), segment_name=f"v{s}").build(
            clustered_columns(n, seed=seed + s, rid_base=s * n), d)
        dirs.append(d)
    return dirs


def pql_for(q, k=7, metric="COSINE", where="WHERE shard < 2", nprobe=0):
    qs = ", ".join(repr(float(x)) for x in q)
    np_clause = f", nprobe={nprobe}" if nprobe else ""
    return (f"SELECT rid, VECTOR_SIMILARITY(emb, [{qs}], {k}, "
            f"'{metric}'{np_clause}) FROM vectab {where}").strip()


def result_rows(resp):
    assert not resp.exceptions, resp.exceptions
    return [tuple(r) for r in resp.selection_results.results]


@pytest.fixture(scope="module")
def ivf_setup():
    base = tempfile.mkdtemp()
    dirs = build_jax_dirs(base)
    q = np.random.default_rng(99).standard_normal(DIM).astype(np.float32)
    jax_segs = [JaxLoader.load(d) for d in dirs]
    return {"dirs": dirs, "q": q,
            "jax": JaxQueryEngine(jax_segs),
            "jax_host": JaxQueryEngine(jax_segs, use_device=False),
            "port": QueryEngine.from_dirs(dirs, device="cpu"),
            "stacked": QueryEngine.from_dirs(dirs, device="cpu",
                                             mesh=make_mesh(["cpu"]))}


def test_train_clamps_k_to_rows():
    rng = np.random.default_rng(0)
    mat = rng.standard_normal((5, DIM)).astype(np.float32)
    index = ivf.train(mat, num_centroids=64, iterations=4, seed=0,
                      sample_size=65536, device="cpu")
    assert index.num_centroids == 5
    assert index.assignments.shape == (5,)
    assert (index.assignments >= 0).all() and (index.assignments < 5).all()


def test_train_identical_embeddings():
    mat = np.ones((128, DIM), np.float32)
    index = ivf.train(mat, num_centroids=8, iterations=4, seed=0,
                      sample_size=65536, device="cpu")
    assert index.meta["baselineMeanDist"] < 1e-6
    custom = {}
    ivf.stamp_custom(custom, "emb", index.meta)
    assert ivf.drift_from_custom(custom, "emb") is None
    assert len(np.unique(index.assignments)) == 1


def test_identical_embeddings_probe_still_serves(tmp_path):
    """A degenerate codebook (one live centroid) still answers, equal to
    the JAX host twin's answer over the same port-built segment."""
    n = 64
    cols = {"shard": np.zeros(n, np.int32),
            "rid": np.arange(n, dtype=np.int32),
            "emb": np.ones((n, DIM), np.float32)}
    d = os.path.join(str(tmp_path), "ident")
    SegmentCreator(ivf_schema(), ivf_table_config(num_centroids=8),
                   segment_name="ident", device="cpu").build(cols, d)
    pql = pql_for(np.ones(DIM), k=5, metric="DOT", where="", nprobe=2)
    rd = result_rows(QueryEngine.from_dirs([d], device="cpu").query(pql))
    rh = result_rows(JaxQueryEngine([JaxLoader.load(d)],
                                    use_device=False).query(pql))
    assert rh == rd and len(rd) == 5


def test_nan_inf_rejected_everywhere():
    mat = np.ones((16, DIM), np.float32)
    mat[3, 2] = np.nan
    with pytest.raises(ValueError, match="NaN/Inf"):
        ivf.train(mat, num_centroids=4, iterations=2, seed=0,
                  sample_size=100, device="cpu")
    mat[3, 2] = np.inf
    with pytest.raises(ValueError, match="NaN/Inf"):
        ivf.train(mat, num_centroids=4, iterations=2, seed=0,
                  sample_size=100, device="cpu")
    f = ivf_schema().field("emb")
    with pytest.raises(ValueError, match="NaN/Inf"):
        f.convert([float("nan")] + [0.0] * (DIM - 1))
    cols = {"shard": np.zeros(16, np.int32),
            "rid": np.arange(16, dtype=np.int32), "emb": mat}
    with pytest.raises(ValueError, match="finite|NaN/Inf"):
        SegmentCreator(ivf_schema(), ivf_table_config(num_centroids=4),
                       segment_name="bad", device="cpu").build(
            cols, tempfile.mkdtemp())


@pytest.mark.parametrize("metric", ["COSINE", "DOT"])
def test_probed_topk_bit_identical(ivf_setup, metric):
    pql = pql_for(ivf_setup["q"], k=9, metric=metric, nprobe=4)
    want = result_rows(ivf_setup["jax"].query(pql))
    assert want == result_rows(ivf_setup["jax_host"].query(pql))
    port = ivf_setup["port"]
    port.executor.plan_maker.path_counts.clear()
    assert result_rows(port.query(pql)) == want
    assert port.executor.plan_maker.path_counts == {"ivfProbe": 2}
    stacked = ivf_setup["stacked"]
    assert result_rows(stacked.query(pql)) == want
    assert stacked.last_route == ("stacked", None)
    assert len(want) == 9


def test_probe_scans_fraction_and_recall(ivf_setup):
    q = ivf_setup["q"]
    for name in ("port", "stacked"):
        engine = ivf_setup[name]
        exact = engine.query(pql_for(q, k=10, where=""))
        probed = engine.query(pql_for(q, k=10, where="", nprobe=3))
        jax_probed = ivf_setup["jax"].query(pql_for(q, k=10, where="",
                                                    nprobe=3))
        assert probed.num_docs_scanned == jax_probed.num_docs_scanned
        total = 2 * 2048
        assert probed.num_docs_scanned < 0.5 * total
        assert probed.num_docs_scanned < exact.num_docs_scanned
        got = {r[:3] for r in result_rows(probed)}
        want = {r[:3] for r in result_rows(exact)}
        assert len(got & want) / len(want) >= 0.9


def test_nprobe_on_indexless_segments_is_exact(tmp_path):
    """ANN is best effort: no index means an exact scan, never an error."""
    dirs = build_jax_dirs(str(tmp_path), n=512, indexed=False)
    q = np.random.default_rng(7).standard_normal(DIM).astype(np.float32)
    exact = result_rows(JaxQueryEngine(
        [JaxLoader.load(d) for d in dirs], use_device=False).query(
        pql_for(q, k=6)))
    for mesh in (None, make_mesh(["cpu"])):
        engine = QueryEngine.from_dirs(dirs, device="cpu", mesh=mesh)
        assert result_rows(engine.query(pql_for(q, k=6, nprobe=4))) == exact
    engine = QueryEngine.from_dirs(dirs, device="cpu")
    engine.query(pql_for(q, k=6, nprobe=4))
    assert engine.executor.plan_maker.path_counts == {"ivfExactFallback": 2}


def test_mixed_stack_falls_back_to_sequential(tmp_path):
    """One indexed and one index-less segment: the stacked executor
    refuses the stack (probe / exact would diverge), the engine falls back
    to the per-segment path, and the answer equals the JAX engines'."""
    dir_i = build_jax_dirs(os.path.join(str(tmp_path), "i"), n_segs=1,
                           n=512)[0]
    dir_x = build_jax_dirs(os.path.join(str(tmp_path), "x"), n_segs=1,
                           n=512, seed=11, indexed=False)[0]
    dirs = [dir_i, dir_x]
    q = np.random.default_rng(13).standard_normal(DIM).astype(np.float32)
    pql = pql_for(q, k=6, where="", nprobe=4)
    jax_segs = [JaxLoader.load(d) for d in dirs]
    want = result_rows(JaxQueryEngine(jax_segs, use_device=False).query(pql))
    assert result_rows(JaxQueryEngine(jax_segs).query(pql)) == want
    stacked = QueryEngine.from_dirs(dirs, device="cpu",
                                    mesh=make_mesh(["cpu"]))
    assert result_rows(stacked.query(pql)) == want and len(want) == 6
    assert stacked.last_route[0] == "NotShardable"
    with pytest.raises(NotShardable, match="IVF"):
        ShardedQueryExecutor(mesh=make_mesh(["cpu"])).execute(
            compile_pql(pql), stacked.segments)


def test_probe_mask_np_matches_device_selection(ivf_setup):
    """The host twin's probe lists and K9's (plain) pick the same
    centroids, and both equal the JAX kernel's."""
    seg = ImmutableSegmentLoader.load(ivf_setup["dirs"][0])
    ds = seg.data_source("emb")
    q = ivf_setup["q"]
    q_pad = np.zeros(ivf.pad_dim(DIM), np.float32)
    q_pad[:DIM] = q
    q_norm = np.float32(np.sqrt((q_pad * q_pad).sum()))
    cpad, cvalid = ds.host_operand("ivfc"), ds.host_operand("ivfv")
    for metric in ("cosine", "dot"):
        probes, ok = ivf.select_probes_np(cpad, cvalid, q_pad, q_norm,
                                          metric, 3)
        dev_probes, dev_ok = tk.ivf_select_probes(
            torch.from_numpy(cpad), torch.from_numpy(cvalid), q_pad, q_norm,
            metric, 3)
        want_probes, want_ok = jax_ivf.select_probes_np(
            cpad, cvalid, q_pad, q_norm, metric, 3)
        np.testing.assert_array_equal(probes, dev_probes.numpy())
        np.testing.assert_array_equal(ok, dev_ok.numpy())
        np.testing.assert_array_equal(probes, want_probes)
        np.testing.assert_array_equal(ok, want_ok)
        assert (probes[ok] < ivf.pad_centroids(
            ds.ivf_centroids.shape[0])).all()


def test_seal_writes_index_and_stamps_custom(tmp_path):
    """The port's creator writes the JAX file layout and custom keys, the
    codebook is byte-identical run after run, its assignments equal the
    JAX creator's on these clusters and its centroids agree to the
    training tolerance; the rest of the directory is the JAX creator's,
    byte for byte."""
    cols = clustered_columns(512, seed=1)
    dirs = []
    for name in ("s0", "s1"):
        d = os.path.join(str(tmp_path), name)
        SegmentCreator(ivf_schema(), ivf_table_config(), segment_name=name,
                       device="cpu").build(cols, d)
        dirs.append(d)
    index = ivf.load_index(dirs[0], "emb")
    assert index is not None and index.num_centroids == N_CENTROIDS
    assert index.assignments.shape == (512,)
    seg = ImmutableSegmentLoader.load(dirs[0])
    custom = seg.metadata.custom
    assert ivf.CUSTOM_CENTROIDS.format(col="emb") in custom
    drift = ivf.drift_from_custom(custom, "emb")
    assert drift is not None and abs(drift) < 1e-9
    for f in ("emb.ivf.centroids.npy", "emb.ivf.assign.npy",
              "emb.ivf.meta.json"):
        with open(os.path.join(dirs[0], f), "rb") as a, \
                open(os.path.join(dirs[1], f), "rb") as b:
            assert a.read() == b.read(), f
    jdir = os.path.join(str(tmp_path), "jax")
    JaxSegmentCreator(jax_ivf_schema(), ivf_table_config(jax=True),
                      segment_name="s0").build(cols, jdir)
    want = jax_ivf.load_index(jdir, "emb")
    np.testing.assert_array_equal(index.assignments, want.assignments)
    np.testing.assert_allclose(index.centroids, want.centroids,
                               rtol=CENT_RTOL, atol=CENT_ATOL)
    # the drift mean: d2 = |r|^2 - 2 r.c + |c|^2 cancels, so the cross
    # term's summation order shows at ~1e-5 of a small distance
    assert index.meta["meanDist"] == pytest.approx(want.meta["meanDist"],
                                                   rel=1e-4)
    for f in sorted(os.listdir(jdir)):
        if f.startswith("emb.ivf.") or f == "metadata.json":
            continue
        with open(os.path.join(jdir, f), "rb") as a, \
                open(os.path.join(dirs[0], f), "rb") as b:
            assert a.read() == b.read(), f


def test_priors_carry_baseline():
    rng = np.random.default_rng(3)
    mat = rng.standard_normal((600, DIM)).astype(np.float32)
    cfg = dict(ivf.DEFAULT_CONFIG, numCentroids=8)
    trained = ivf.build_for_column(mat, cfg, device="cpu")
    base = trained.meta["baselineMeanDist"]
    rebuilt = ivf.build_for_column(mat * 1.8, cfg, priors=trained,
                                   device="cpu")
    assert rebuilt.meta["baselineMeanDist"] == base
    assert rebuilt.meta["meanDist"] > base
    np.testing.assert_array_equal(rebuilt.centroids, trained.centroids)


# ---------------------------------------------------------------------------
# (c) the kernels on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(65536, 256, 128), (10007, 16, 16),
                                   (4096, 8, 4)])
def test_ivf_kernels_cuda_match_plain(cuda_device, shape):
    n, c, dim = shape
    data, centers = _clusters(n, c, dim, seed=n)
    d = torch.from_numpy(data).to(cuda_device)
    cen = torch.from_numpy(centers).to(cuda_device)
    assign, dist = ik.ivf_assign(d, cen, n - 3, c - 1)
    want_a, want_d = ik.ivf_assign_plain(d, cen, n - 3, c - 1)
    assert torch.equal(assign, want_a)
    assert torch.allclose(dist, want_d, rtol=DIST_RTOL, atol=DIST_ATOL)
    new_c, counts = ik.ivf_recenter(d, assign, n - 3, cen)
    again, _ = ik.ivf_recenter(d, assign, n - 3, cen)
    assert torch.equal(new_c.view(torch.int32), again.view(torch.int32))
    want_c, want_n = ik.ivf_recenter_plain(d, assign, n - 3, cen)
    assert torch.equal(counts, want_n)
    assert torch.allclose(new_c, want_c, rtol=CENT_RTOL, atol=CENT_ATOL)


def _recenter_case(kind: str, m_pad: int, dim_pad: int, c_pad: int,
                   seed: int):
    """Rows, assignments and a prior for K11: every live row on one
    centroid; only even centroids assigned (the odd ones keep their
    prior); or Zipf-skewed (s = 1.3) ids. The 37 padding rows past n_rows
    carry random ids that must count nowhere."""
    rng = np.random.default_rng(seed)
    data = rng.standard_normal((m_pad, dim_pad)).astype(np.float32)
    prior = rng.standard_normal((c_pad, dim_pad)).astype(np.float32)
    if kind == "one":
        assign = np.full(m_pad, c_pad // 3, np.int64)
    elif kind == "even":
        assign = rng.integers(0, c_pad // 2, m_pad) * 2
    else:
        assign = np.minimum(rng.zipf(1.3, m_pad) - 1, c_pad - 1)
    n_rows = m_pad - 37
    assign[n_rows:] = rng.integers(0, c_pad, m_pad - n_rows)
    return data, assign.astype(np.int32), n_rows, prior


@pytest.mark.cuda
@pytest.mark.parametrize("c_pad", [8, 256, 4096])
@pytest.mark.parametrize("dim_pad", [1, 128, 4096])
@pytest.mark.parametrize("kind", ["one", "even", "zipf"])
def test_ivf_recenter_cuda_shapes(cuda_device, kind, dim_pad, c_pad):
    """K11 on skewed and sparse assignments: counts equal, the codebook
    bit-equal run to run, within rtol / atol 1e-5 of the plain version,
    and centroids with no row keep their prior bits."""
    m_pad = 65536 if dim_pad < 4096 else 8192
    data, assign, n_rows, prior = _recenter_case(kind, m_pad, dim_pad, c_pad,
                                                 seed=dim_pad + c_pad)
    d = torch.from_numpy(data).to(cuda_device)
    a = torch.from_numpy(assign).to(cuda_device)
    cen = torch.from_numpy(prior).to(cuda_device)
    new_c, counts = ik.ivf_recenter(d, a, n_rows, cen)
    again, again_n = ik.ivf_recenter(d, a, n_rows, cen)
    assert torch.equal(new_c.view(torch.int32), again.view(torch.int32))
    assert torch.equal(counts, again_n)
    want_c, want_n = ik.ivf_recenter_plain(d, a, n_rows, cen)
    assert torch.equal(counts, want_n)
    assert torch.equal(counts.cpu(), torch.from_numpy(np.bincount(
        assign[:n_rows], minlength=c_pad).astype(np.int32)))
    assert torch.allclose(new_c, want_c, rtol=CENT_RTOL, atol=CENT_ATOL)
    empty = counts == 0
    assert torch.equal(new_c[empty].view(torch.int32),
                       cen[empty].view(torch.int32))


@pytest.mark.cuda
def test_codebook_byte_identical_on_the_card(cuda_device):
    data, _centers = _clusters(20000, 32, 128, seed=5)
    runs = [ivf.train(data, num_centroids=32, iterations=5, seed=0,
                      sample_size=8192, device=cuda_device)
            for _ in range(2)]
    assert runs[0].centroids.tobytes() == runs[1].centroids.tobytes()
    np.testing.assert_array_equal(runs[0].assignments, runs[1].assignments)
