"""The vector configuration: VECTOR_SIMILARITY over clustered embeddings.

Counterpart of the data half of the JAX package's vector rung,
scripts/vec_ann_bench.py:48-90 (its artifact is VEC_r16.json): a
`vecbench` table of `rid` INT and `emb` VECTOR(128), the width of SIFT
descriptors (Jegou et al., ANN_SIFT1M), 10,000,000 rows in 4 segments of
2,500,000, each sealed with a 256-centroid IVF codebook (10 Lloyd
iterations on a 65,536-row sample). Embeddings are drawn around 256 shared
centres (N(0, 1) * 4, noise sigma 0.3) from numpy's default_rng(2016), in
the script's order: the centres, then per segment the centre of each row
and its noise, then the query vectors (a centre plus noise each), so the
same seed gives the script's rows and queries.

`VecOracle` is the oracle: a chunked numpy top k with the engine's own
scoring contract (the balanced pairwise f32 tree of
ops/kernels.py:vec_tree_sum_plain over the power-of-two padded dims, the
cosine quotient), chunked by rows, which leaves every row's bits as they
are, so the engine's exact answers must equal it bit for bit, docids and
scores. Rows rank by score descending, then (segment name, docid)
ascending, the engine's merge order (query/combine.py:vector_order_key).
"""
from __future__ import annotations

import concurrent.futures
import os
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from pinot_tpu_torch.common.datatype import DataType
from pinot_tpu_torch.common.schema import Schema, metric, vector
from pinot_tpu_torch.common.table_config import IndexingConfig, TableConfig
from pinot_tpu_torch.ops.kernels import vec_tree_sum_plain

TABLE = "vecbench"
ROWS = 10_000_000
SEGMENTS = 4
DIM = 128
CENTERS = 256            # shared cluster centres, and centroids a segment
SEED = 2016
K = 10
NPROBES = (1, 4, 16)
IVF_ITERATIONS = 10
IVF_SAMPLE = 65536


def make_schema(dim: int = DIM) -> Schema:
    return Schema(TABLE, [metric("rid", DataType.INT), vector("emb", dim)])


def make_table_config(num_centroids: int = CENTERS,
                      iterations: int = IVF_ITERATIONS,
                      sample: int = IVF_SAMPLE) -> TableConfig:
    idx = IndexingConfig()
    idx.vector_index_configs = {"emb": {
        "numCentroids": num_centroids, "trainIterations": iterations,
        "trainSampleSize": sample}}
    return TableConfig(TABLE, indexing_config=idx)


class VecDraws:
    """The script's draws from one Generator: `centers` first, then
    `segment(s)` for s = 0, 1, ... in order, then `queries(n)`."""

    def __init__(self, rows: int = ROWS, segments: int = SEGMENTS,
                 dim: int = DIM, centers: int = CENTERS, seed: int = SEED):
        self.per = rows // segments
        self.segments = segments
        self.dim = dim
        self.rng = np.random.default_rng(seed)
        self.centers = self.rng.standard_normal((centers, dim)).astype(
            np.float32) * 4
        self._next = 0

    def segment(self, s: int) -> Dict[str, np.ndarray]:
        if s != self._next:
            raise ValueError(f"segment {s} drawn out of order "
                             f"(next is {self._next})")
        self._next += 1
        which = self.rng.integers(0, len(self.centers), self.per)
        emb = (self.centers[which] + self.rng.standard_normal(
            (self.per, self.dim)).astype(np.float32) * 0.3)
        return {"rid": np.arange(self.per, dtype=np.int32) + s * self.per,
                "emb": emb}

    def queries(self, n: int) -> List[np.ndarray]:
        if self._next != self.segments:
            raise ValueError("queries are drawn after every segment")
        return [(self.centers[int(self.rng.integers(len(self.centers)))] +
                 self.rng.standard_normal(self.dim).astype(np.float32) * 0.3)
                for _ in range(n)]


def build_segment_dirs(base: str, rows: int = ROWS,
                       segments: int = SEGMENTS, dim: int = DIM,
                       centers: int = CENTERS, seed: int = SEED,
                       iterations: int = IVF_ITERATIONS,
                       sample: int = IVF_SAMPLE, device=None):
    """Draw and seal `segments` segment directories under `base` with the
    port's SegmentCreator (IVF codebooks trained on `device`, None: the
    card). Returns (dirs, draws, seconds): `seconds` splits the build
    into "draw" (numpy), "seal" (files and codebooks) and, within seal,
    "train" (the IVF index: training and the assignment sweep)."""
    from pinot_tpu_torch.segment.creator import SegmentCreator
    draws = VecDraws(rows, segments, dim, centers, seed)
    cfg = make_table_config(centers, iterations, sample)
    dirs = []
    seconds = {"draw": 0.0, "seal": 0.0, "train": 0.0}
    for s in range(segments):
        t0 = time.perf_counter()
        cols = draws.segment(s)
        t1 = time.perf_counter()
        d = os.path.join(base, f"b{s}")
        creator = SegmentCreator(make_schema(dim), cfg, segment_name=f"b{s}",
                                 device=device)
        creator.build(cols, d)
        seconds["draw"] += t1 - t0
        seconds["seal"] += time.perf_counter() - t1
        seconds["train"] += creator.ivf_seconds
        dirs.append(d)
    return dirs, draws, seconds


class VecOracle:
    """The chunked numpy top k over segments `blocks` = [(name,
    embeddings [n, dim])]. Each row's squared-norm tree is computed once
    and each query's dot trees once, whatever the metrics and masks asked
    of that query. Chunks of 16,384 rows (8 MB at 128 dims) keep a
    chunk's temporaries in the host's caches; chunks of 2^20 rows ran
    several times slower."""

    def __init__(self, blocks: Sequence[Tuple[str, np.ndarray]],
                 chunk: int = 1 << 14):
        self.blocks = list(blocks)
        self.chunk = chunk
        dim = self.blocks[0][1].shape[1]
        self.dim_pad = 1
        while self.dim_pad < dim:
            self.dim_pad *= 2
        self._norm2 = None
        self._dots: Tuple[bytes, List[np.ndarray]] = (b"", [])

    def _trees(self, mat: np.ndarray, qp: Optional[np.ndarray]) -> np.ndarray:
        """tree(m * q) per row, or tree(m * m) with qp None; chunks run on
        a thread pool (numpy's ufuncs release the GIL), which leaves
        every row's bits as they are."""
        n, dim = mat.shape
        out = np.empty(n, np.float32)

        def chunk(a: int) -> None:
            m = np.zeros((min(self.chunk, n - a), self.dim_pad), np.float32)
            m[:, :dim] = mat[a:a + self.chunk]
            out[a:a + len(m)] = vec_tree_sum_plain(m * (m if qp is None else
                                                     qp[None, :]))

        workers = min(8, os.cpu_count() or 1)
        with concurrent.futures.ThreadPoolExecutor(workers) as pool:
            list(pool.map(chunk, range(0, n, self.chunk)))
        return out

    def scores(self, q: np.ndarray, metric: str) -> List[np.ndarray]:
        """f32 scores per segment, the engine's contract bit for bit."""
        qp = np.zeros(self.dim_pad, np.float32)
        qp[:len(q)] = np.asarray(q, np.float32)
        if self._dots[0] != qp.tobytes():
            self._dots = (qp.tobytes(), [self._trees(mat, qp)
                                         for _n, mat in self.blocks])
        dots = self._dots[1]
        if metric.lower() != "cosine":
            return dots
        if self._norm2 is None:
            self._norm2 = [self._trees(mat, None) for _n, mat in self.blocks]
        q_norm = np.float32(np.sqrt(vec_tree_sum_plain(qp * qp)))
        out = []
        for dot, norm2 in zip(dots, self._norm2):
            denom = np.sqrt(norm2).astype(np.float32) * q_norm
            with np.errstate(divide="ignore", invalid="ignore"):
                s = (dot / denom).astype(np.float32)
            s[~(denom > 0)] = -np.inf
            out.append(s)
        return out

    def topk(self, q: np.ndarray, k: int, metric: str,
             masks: Optional[Sequence[np.ndarray]] = None
             ) -> List[Tuple[int, str, float]]:
        """[(docid, segment name, score)]: the top k by score
        descending, then (name, docid), over the rows each segment's mask
        keeps (all rows without masks)."""
        cand = []
        for i, s in enumerate(self.scores(q, metric)):
            name = self.blocks[i][0]
            docs = np.arange(len(s)) if masks is None else \
                np.nonzero(masks[i])[0]
            sd = s[docs]
            order = np.lexsort((docs, -sd))[:k]
            cand.extend((-float(sd[j]), name, int(docs[j])) for j in order)
        cand.sort()
        return [(doc, name, -neg) for neg, name, doc in cand[:k]]


def recall(got: Sequence, want: Sequence) -> float:
    """|got ∩ want| / |want| over (docid, segment name) pairs."""
    want_set = set(want)
    return len(set(got) & want_set) / len(want_set) if want_set else 1.0
