"""IVF coarse quantizer for VECTOR columns (ANN pre-filtering).

Counterpart of pinot_tpu/index/ivf.py, which the IVF family of Johnson et
al. (billion-scale similarity search) adapts to the segment model: each
sealed segment carries its own k-means codebook,

  {col}.ivf.centroids.npy   f32 [numCentroids, dim]   trained codebook
  {col}.ivf.assign.npy      i32 [num_docs]            per-row coarse cell
  {col}.ivf.meta.json       seed/iterations/meanDist baseline (drift)

in the JAX module's file format, so each package reads the other's.
Training is a fixed-iteration Lloyd's loop with the JAX module's seeded
init (numpy Generator) over the port's kernels: K10 `ivf_assign` (nearest
centroid) then K11 `ivf_recenter` (means in row order, no atomics) per
step, on the card unless the caller asks for the CPU; big segments train
on a seeded sample and then K10 assigns all rows.

The codebook is byte-identical from run to run on one backend, not
across backends: XLA and the port sum the training products in
different orders (the JAX ivf_kernels module gives training no
cross-backend contract). A JAX-built directory loads here as it is, and
probing it picks the same cells as the JAX engine.

At query time `VECTOR_SIMILARITY(..., nprobe=N)` turns into an
"ivf_probe" filter predicate over three lanes (assignments, padded
centroids, centroid validity); K9 selects the probe list on the card, so
stacked execution can share one plan across segments with different live
centroid counts. The numpy twins here mirror the device math op for op
(same balanced-tree sums, same monotone int32 keys, same tie-breaking),
so host, device and stacked paths agree on the probed candidate set bit
for bit.

Why a validity lane instead of a runtime count: zero-padded centroid
rows score 0.0 under dot product (beating real negative scores), and a
count would ride in the plan's params, which stacked execution shares
across segments. A bool lane (centroid has >= 1 assigned row) solves
padding, per-segment counts and dead-cell probing at once.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Dict, Optional, Tuple

import numpy as np

import torch

from pinot_tpu_torch.common.device import resolve_device
from pinot_tpu_torch.ops import ivf_kernels, kernels
from pinot_tpu_torch.segment import format as fmt

INT32_MAX = np.int32(2 ** 31 - 1)

# index-config knobs (tableIndexConfig.vectorIndexConfigs.<col>)
DEFAULT_CONFIG = {
    "type": "IVF",
    "numCentroids": 256,
    "trainIterations": 10,
    "seed": 0,
    "trainSampleSize": 65536,
}
# segment-custom keys stamped by the creator and read by the minion
# drift generator (controller record "customMap" mirrors them)
CUSTOM_MEAN = "ivf.{col}.meanDist"
CUSTOM_BASELINE = "ivf.{col}.baselineMeanDist"
CUSTOM_CENTROIDS = "ivf.{col}.numCentroids"

ASSIGN_BLOCK = 65536       # the JAX sweep's row block: the drift mean
#                            sums its distances per block of this many rows


def pad_dim(dim: int) -> int:
    """Embedding dim padding: MUST match the planner's query padding."""
    return kernels.pow2_bucket(max(dim, 1), floor=1)


def pad_centroids(c: int) -> int:
    return kernels.pow2_bucket(max(c, 1), floor=8)


# ---------------------------------------------------------------------------
# config / custom-map helpers
# ---------------------------------------------------------------------------


def column_config(table_config, col: str) -> Optional[dict]:
    """Effective IVF config for a column, or None when not indexed."""
    idx = getattr(table_config, "indexing_config", None)
    cfgs = getattr(idx, "vector_index_configs", None) or {}
    raw = cfgs.get(col)
    if raw is None:
        return None
    cfg = dict(DEFAULT_CONFIG)
    cfg.update(raw)
    return cfg


def validate_config(cfg: dict, col: str) -> None:
    if str(cfg.get("type", "IVF")).upper() != "IVF":
        raise ValueError(
            f"vector index for '{col}': unknown type {cfg.get('type')!r}")
    for key in ("numCentroids", "trainIterations", "trainSampleSize"):
        if int(cfg.get(key, DEFAULT_CONFIG[key])) < 1:
            raise ValueError(f"vector index for '{col}': {key} must be >= 1")


def stamp_custom(custom: Dict[str, str], col: str, meta: dict) -> None:
    custom[CUSTOM_MEAN.format(col=col)] = repr(float(meta["meanDist"]))
    custom[CUSTOM_BASELINE.format(col=col)] = \
        repr(float(meta["baselineMeanDist"]))
    custom[CUSTOM_CENTROIDS.format(col=col)] = str(int(meta["numCentroids"]))


def drift_from_custom(custom: Dict[str, str], col: str) -> Optional[float]:
    """Relative drift = meanDist / trained baseline - 1 (None if absent
    or the baseline is ~0, e.g. all-identical embeddings)."""
    try:
        mean = float(custom[CUSTOM_MEAN.format(col=col)])
        base = float(custom[CUSTOM_BASELINE.format(col=col)])
    except (KeyError, TypeError, ValueError):
        return None
    if base <= 1e-12:
        return None
    return mean / base - 1.0


# ---------------------------------------------------------------------------
# index files
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class IvfIndex:
    centroids: np.ndarray     # f32 [numCentroids, dim]
    assignments: np.ndarray   # i32 [num_docs]
    meta: dict

    @property
    def num_centroids(self) -> int:
        return int(self.centroids.shape[0])


def write_index(out_dir: str, col: str, index: IvfIndex) -> None:
    import os
    np.save(os.path.join(out_dir, fmt.IVF_CENTROIDS.format(col=col)),
            np.ascontiguousarray(index.centroids, dtype=np.float32))
    np.save(os.path.join(out_dir, fmt.IVF_ASSIGN.format(col=col)),
            np.ascontiguousarray(index.assignments, dtype=np.int32))
    with open(os.path.join(out_dir, fmt.IVF_META.format(col=col)), "w") as f:
        json.dump(index.meta, f, indent=1, sort_keys=True)


def load_index(seg_dir, col: str) -> Optional[IvfIndex]:
    d = fmt.open_dir(seg_dir)
    name = fmt.IVF_META.format(col=col)
    if not d.exists(name):
        return None
    meta = json.loads(d.read_text(name))
    return IvfIndex(
        centroids=d.load_array(fmt.IVF_CENTROIDS.format(col=col)),
        assignments=d.load_array(fmt.IVF_ASSIGN.format(col=col)),
        meta=meta)


# ---------------------------------------------------------------------------
# query-time lanes (padded operands served by the loader)
# ---------------------------------------------------------------------------


def centroid_lane(centroids: np.ndarray) -> np.ndarray:
    """f32 [C_pad, dim_pad] zero-padded codebook lane."""
    c, dim = centroids.shape
    out = np.zeros((pad_centroids(c), pad_dim(dim)), np.float32)
    out[:c, :dim] = centroids
    return out


def validity_lane(assignments: np.ndarray, num_centroids: int) -> np.ndarray:
    """bool [C_pad]: centroid has >= 1 assigned row (padding rows and
    dead cells both drop out of probe selection)."""
    counts = np.bincount(np.asarray(assignments, np.int64),
                         minlength=pad_centroids(num_centroids))
    return counts[:pad_centroids(num_centroids)] > 0


def assignment_lane(assignments: np.ndarray, num_centroids: int,
                    padded_rows: int) -> np.ndarray:
    """Narrowed [padded_rows] assignment lane; padding rows carry the
    (never-probed) sentinel id `num_centroids`."""
    dt = np.dtype(np.int8 if num_centroids <= 127 else
                  np.int16 if num_centroids <= 32767 else np.int32)
    out = np.full(padded_rows, num_centroids, dt)
    out[:assignments.shape[0]] = assignments.astype(dt)
    return out


# ---------------------------------------------------------------------------
# numpy probe-select twin (host oracle; bit-parity with the device path)
# ---------------------------------------------------------------------------


def np_monotone_i32(scores: np.ndarray) -> np.ndarray:
    """f32 → order-preserving int32 keys (same IEEE bit trick as
    kernels._monotone_int32_keys)."""
    b = np.ascontiguousarray(np.asarray(scores, np.float32)).view(np.int32)
    return b ^ ((b >> 31) & np.int32(0x7FFFFFFF))


def np_centroid_scores(centroids_pad: np.ndarray, q_pad: np.ndarray,
                       q_norm, metric: str) -> np.ndarray:
    """Twin of kernels._vector_scores over the padded codebook."""
    mat = np.asarray(centroids_pad, np.float32)
    q = np.asarray(q_pad, np.float32)
    dot = kernels.vec_tree_sum_plain(mat * q[None, :])
    if metric == "cosine":
        denom = np.sqrt(kernels.vec_tree_sum_plain(mat * mat)
                        ).astype(np.float32) * np.float32(q_norm)
        with np.errstate(divide="ignore", invalid="ignore"):
            return np.where(denom > 0, dot / denom,
                            np.float32(-np.inf)).astype(np.float32)
    return dot


def select_probes_np(centroids_pad: np.ndarray, cvalid: np.ndarray,
                     q_pad: np.ndarray, q_norm, metric: str,
                     nprobe: int) -> Tuple[np.ndarray, np.ndarray]:
    """(probe_ids i32 [nprobe], probe_ok bool [nprobe]) — same ranking
    and tie-breaking (equal key → lower centroid id) as lax.top_k."""
    score = np_centroid_scores(centroids_pad, q_pad, q_norm, metric)
    key = np.maximum(np_monotone_i32(score), np.int32(-INT32_MAX))
    key = np.where(np.asarray(cvalid, bool), key,
                   np.int32(-INT32_MAX - 1)).astype(np.int64)
    order = np.lexsort((np.arange(key.shape[0]), -key))[:nprobe]
    ok = np.arange(nprobe) < int(np.asarray(cvalid, bool).sum())
    return order.astype(np.int32), ok


def probe_mask_np(assignments: np.ndarray, centroids_pad: np.ndarray,
                  cvalid: np.ndarray, q_pad: np.ndarray, q_norm,
                  metric: str, nprobe: int) -> np.ndarray:
    """bool [P] row mask: row's coarse cell is in the top-nprobe list."""
    probe, ok = select_probes_np(centroids_pad, cvalid, q_pad, q_norm,
                                 metric, nprobe)
    a = np.asarray(assignments, np.int32)
    return ((a[:, None] == probe[None, :]) & ok[None, :]).any(axis=1)


# ---------------------------------------------------------------------------
# training (seeded Lloyd's; K10 / K11 in ops/ivf_kernels.py)
# ---------------------------------------------------------------------------

ASSIGN_CHUNK = 1 << 20     # rows per K10 launch of the seal-time sweep


def _assign_all(mat: np.ndarray, centroids: np.ndarray, device):
    """Assign every row with K10, ASSIGN_CHUNK rows a launch.

    Returns (assignments i32 [n], mean_dist float): the mean L2 distance
    to the assigned centroid (the drift metric), summed per ASSIGN_BLOCK
    rows in float64 as the JAX sweep sums its blocks."""
    n, dim = mat.shape
    c = centroids.shape[0]
    c_pad, d_pad = pad_centroids(c), pad_dim(dim)
    cen = torch.zeros((c_pad, d_pad), dtype=torch.float32, device=device)
    cen[:c, :dim] = torch.from_numpy(np.ascontiguousarray(centroids))
    out = np.empty(n, np.int32)
    dist = np.empty(n, np.float32)
    for start in range(0, n, ASSIGN_CHUNK):
        stop = min(start + ASSIGN_CHUNK, n)
        block = torch.from_numpy(np.ascontiguousarray(mat[start:stop]))
        if dim != d_pad:
            block = torch.nn.functional.pad(block, (0, d_pad - dim))
        a, d2 = ivf_kernels.ivf_assign(block.to(device), cen, stop - start, c)
        out[start:stop] = a.cpu().numpy()
        dist[start:stop] = d2.cpu().numpy()
    total = 0.0
    for start in range(0, n, ASSIGN_BLOCK):
        d2 = dist[start:start + ASSIGN_BLOCK].astype(np.float64)
        total += float(np.sqrt(np.maximum(d2, 0.0)).sum())
    return out, (total / n if n else 0.0)


def train(mat: np.ndarray, *, num_centroids: int, iterations: int,
          seed: int, sample_size: int, device=None) -> IvfIndex:
    """Fixed-iteration Lloyd's with seeded init; deterministic artifacts.

    The sample and the initial centroids are the JAX module's (the same
    numpy Generator draws); each step is K10 then K11 on `device` (None:
    the card). L2 k-means regardless of query metric (standard IVF
    practice: the coarse partition only has to be consistent between
    build and probe). NaN/Inf embeddings are rejected."""
    mat = np.ascontiguousarray(mat, dtype=np.float32)
    if mat.ndim != 2:
        raise ValueError(f"IVF training needs [n, dim] input, got "
                         f"shape {mat.shape}")
    if mat.size and not np.isfinite(mat).all():
        raise ValueError("IVF training input contains NaN/Inf embeddings")
    device = resolve_device(device)
    n, dim = mat.shape
    k = max(1, min(int(num_centroids), n))
    rng = np.random.default_rng(int(seed))
    if n > sample_size:
        sample = mat[np.sort(rng.choice(n, int(sample_size), replace=False))]
    else:
        sample = mat
    m = sample.shape[0]
    centroids = sample[np.sort(rng.choice(m, k, replace=False))].copy() \
        if m else np.zeros((k, dim), np.float32)

    m_pad, c_pad, d_pad = pad_centroids(m), pad_centroids(k), pad_dim(dim)
    data = torch.zeros((m_pad, d_pad), dtype=torch.float32, device=device)
    data[:m, :dim] = torch.from_numpy(np.ascontiguousarray(sample))
    cen = torch.zeros((c_pad, d_pad), dtype=torch.float32, device=device)
    cen[:k, :dim] = torch.from_numpy(centroids)
    for _ in range(max(0, int(iterations))):
        cen = ivf_kernels.ivf_train_step(data, cen, m, k)["ivf.centroids"]
    centroids = np.ascontiguousarray(cen[:k, :dim].cpu().numpy())

    assignments, mean_dist = _assign_all(mat, centroids, device) if n else \
        (np.zeros(0, np.int32), 0.0)
    meta = {
        "version": 1,
        "numCentroids": k,
        "dim": dim,
        "seed": int(seed),
        "iterations": int(iterations),
        "trainRows": m,
        "meanDist": mean_dist,
        "baselineMeanDist": mean_dist,
    }
    return IvfIndex(centroids=centroids, assignments=assignments, meta=meta)


def build_for_column(mat: np.ndarray, cfg: dict,
                     priors: Optional[IvfIndex] = None,
                     device=None) -> IvfIndex:
    """Build a column's index: fresh train, or, given priors (the
    compaction path), reuse the existing codebook, reassign the
    surviving rows, and CARRY the trained baseline forward so the drift
    metric measures real movement since training."""
    validate_config(cfg, cfg.get("column", "?"))
    if priors is not None and priors.num_centroids:
        mat = np.ascontiguousarray(mat, dtype=np.float32)
        if mat.size and not np.isfinite(mat).all():
            raise ValueError("IVF input contains NaN/Inf embeddings")
        assignments, mean_dist = _assign_all(
            mat, priors.centroids, resolve_device(device)) \
            if mat.shape[0] else (np.zeros(0, np.int32), 0.0)
        meta = dict(priors.meta)
        meta["meanDist"] = mean_dist
        meta.setdefault("baselineMeanDist", mean_dist)
        return IvfIndex(centroids=priors.centroids.copy(),
                        assignments=assignments, meta=meta)
    return train(mat,
                 num_centroids=int(cfg["numCentroids"]),
                 iterations=int(cfg["trainIterations"]),
                 seed=int(cfg["seed"]),
                 sample_size=int(cfg["trainSampleSize"]),
                 device=device)
