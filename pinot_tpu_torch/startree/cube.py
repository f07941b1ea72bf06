"""Star-tree analogue: pre-aggregated cubes over dictId combinations.

Copy of pinot_tpu/startree/cube.py with imports rebased onto
pinot_tpu_torch: host numpy work at segment build (the grouping loops in
native/seglib.cpp, numpy fallbacks) and load; no device lanes.

Parity: pinot-core/.../core/startree/v2/ — StarTreeV2BuilderConfig
(dimensionsSplitOrder, functionColumnPairs, maxLeafRecords) and the
pre-aggregation the tree encodes. The columnar form drops the node
tree entirely: a cube is a *columnar grouped table* — one row per distinct
dictId combination of the configured dimensions, with materialized
count/sum/min/max stats per configured metric. Queries that only touch
cube dimensions and covered metrics run over n_groups rows instead of
n_docs (OffHeapStarTree.java:35-76's O(tree) skip becomes an O(groups)
columnar scan — groups are bounded at build time, typically 1000-100000x
smaller than the segment).

The cube's dimension lanes share the parent segment's dictionaries, so
every id-domain predicate the engine can resolve against the segment
resolves identically against the cube.
"""
from __future__ import annotations

import dataclasses
import glob
import json
import os
from typing import Dict, List, Optional

import numpy as np

STARTREE_META = "startree.{idx}.json"
STARTREE_DATA = "startree.{idx}.npz"
DEFAULT_MAX_GROUPS = 1 << 20


@dataclasses.dataclass
class StarTreeConfig:
    dimensions: List[str]                 # split order (all materialized)
    metrics: List[str]                    # metric columns with stats lanes
    max_groups: int = DEFAULT_MAX_GROUPS  # build refused above this

    @classmethod
    def from_json(cls, d: dict) -> "StarTreeConfig":
        metrics = []
        for pair in d.get("functionColumnPairs", d.get("metrics", [])):
            # "SUM__revenue" → revenue (the cube stores the full stat set)
            col = pair.split("__", 1)[1] if "__" in pair else pair
            if col not in metrics and col != "*":
                metrics.append(col)
        # NOTE: Pinot's maxLeafRecords is a node-SPLIT threshold, not a
        # size cap — a ported config's maxLeafRecords (default 10k) must
        # not disable cube builds, so only maxGroups/maxSize cap the build
        return cls(
            dimensions=list(d.get("dimensionsSplitOrder",
                                  d.get("dimensions", []))),
            metrics=metrics,
            max_groups=int(d.get("maxGroups",
                                 d.get("maxSize", DEFAULT_MAX_GROUPS))))

    def to_json(self) -> dict:
        return {"dimensionsSplitOrder": self.dimensions,
                "metrics": self.metrics, "maxSize": self.max_groups}


class StarTreeCube:
    """One materialized cube: dim id lanes + per-metric stat lanes."""

    def __init__(self, config: StarTreeConfig, n_groups: int,
                 dim_ids: Dict[str, np.ndarray],
                 counts: np.ndarray,
                 metric_stats: Dict[str, Dict[str, np.ndarray]]):
        self.config = config
        self.n_groups = n_groups
        self.dim_ids = dim_ids                  # col → int32 [n_groups]
        self.counts = counts                    # int64 [n_groups]
        self.metric_stats = metric_stats        # col → {sum,min,max}[n_groups]

    @property
    def dimensions(self) -> List[str]:
        return self.config.dimensions

    @property
    def metrics(self) -> List[str]:
        return self.config.metrics

    def save(self, seg_dir: str, idx: int) -> None:
        # narrow on disk (near-height cubes are ~75% of segment bytes):
        # dims to their minimal int dtype, counts to int32, min/max to
        # f32 when every value round-trips exactly (integer metrics
        # < 2^24 — the dictionary-encoded SSB case); load() upcasts back
        from pinot_tpu_torch.segment.loader import min_id_dtype
        arrays = {"counts": self.counts.astype(np.int32)
                  if self.counts.size and self.counts.max() < 2**31
                  else self.counts}
        for d, ids in self.dim_ids.items():
            mx = int(ids.max()) if len(ids) else 0
            arrays[f"dim.{d}"] = ids.astype(min_id_dtype(mx))
        for m, stats in self.metric_stats.items():
            for k, arr in stats.items():
                if k in ("min", "max") and arr.size:
                    f32 = arr.astype(np.float32)
                    if np.array_equal(f32.astype(np.float64), arr):
                        arr = f32
                arrays[f"met.{m}.{k}"] = arr
        # data first, meta last: the .json is the commit marker, so a
        # crash mid-save never leaves a json pointing at a missing npz
        np.savez(os.path.join(seg_dir, STARTREE_DATA.format(idx=idx)),
                 **arrays)
        with open(os.path.join(seg_dir, STARTREE_META.format(idx=idx)),
                  "w") as fh:
            json.dump(self.config.to_json(), fh)

    @classmethod
    def load(cls, seg_dir, idx: int) -> "StarTreeCube":
        import io

        from pinot_tpu_torch.segment import format as fmt
        d = fmt.open_dir(seg_dir)
        config = StarTreeConfig.from_json(json.loads(
            d.read_text(STARTREE_META.format(idx=idx))))
        data = np.load(io.BytesIO(
            d.read_bytes(STARTREE_DATA.format(idx=idx))))
        dim_ids = {d: data[f"dim.{d}"].astype(np.int32)
                   for d in config.dimensions}
        metric_stats = {
            m: {k: data[f"met.{m}.{k}"].astype(np.float64)
                for k in ("sum", "min", "max")}
            for m in config.metrics}
        counts = data["counts"].astype(np.int64)
        return cls(config, len(counts), dim_ids, counts, metric_stats)


def build_star_trees(segment, table_config) -> List[StarTreeCube]:
    """Materialize every configured cube from a loaded segment's host
    lanes. Parity: BaseSingleTreeBuilder — but a single vectorized
    group-by pass instead of a sort+split tree walk."""
    cubes: List[StarTreeCube] = []
    for raw_cfg in table_config.indexing_config.star_tree_configs or []:
        config = StarTreeConfig.from_json(raw_cfg) \
            if isinstance(raw_cfg, dict) else raw_cfg
        cube = _build_cube(segment, config)
        if cube is not None:
            cubes.append(cube)
    return cubes


def _build_cube(segment, config: StarTreeConfig
                ) -> Optional[StarTreeCube]:
    n = segment.num_docs
    if n == 0 or not config.dimensions:
        return None
    dim_lanes: Dict[str, tuple] = {}
    for d in config.dimensions:
        if not segment.has_column(d):
            return None
        ds = segment.data_source(d)
        cm = ds.metadata
        if not (cm.has_dictionary and cm.single_value):
            return None                     # MV/raw dims unsupported
        dim_lanes[d] = (ds.dict_ids, cm.cardinality)
    def _metric(ds):
        # deferred: only decoded if the cube survives the group-count
        # checks (a rejected cube must not cost O(n) per metric)
        cm = ds.metadata
        if cm.has_dictionary:
            return lambda: np.asarray(ds.dictionary.values,
                                      dtype=np.float64)[ds.dict_ids]
        return lambda: ds.raw_values.astype(np.float64)

    metric_vals: Dict[str, object] = {}
    for m in config.metrics:
        if not segment.has_column(m):
            return None
        ds = segment.data_source(m)
        cm = ds.metadata
        if not cm.single_value or not cm.data_type.is_numeric:
            return None
        metric_vals[m] = _metric(ds)
    return build_cube_from_arrays(config, dim_lanes, metric_vals)


def build_cube_from_arrays(config: StarTreeConfig,
                           dim_lanes: Dict[str, tuple],
                           metric_vals: Dict[str, np.ndarray]
                           ) -> Optional[StarTreeCube]:
    """Core cube pass over host arrays: dim_lanes maps dimension →
    (dict_ids, cardinality), metric_vals maps metric → float64 values
    (or a zero-arg callable producing them, resolved only once the cube
    passes the group-count checks). Linear-time grouping (hash factorize
    + bincount) instead of the O(n log n) unique sort; the creator calls
    this directly on its in-memory ids so sealing a segment never
    re-reads it from disk."""
    if not config.dimensions or \
            any(d not in dim_lanes for d in config.dimensions):
        return None
    cards = [dim_lanes[d][1] for d in config.dimensions]
    if np.prod([float(c) for c in cards]) >= 2**62:
        return None                         # packed key would overflow
    n = len(dim_lanes[config.dimensions[0]][0])
    if n == 0:
        return None
    from pinot_tpu_torch import native

    lanes = [dim_lanes[d][0] for d in config.dimensions]
    key = native.packed_key(lanes, cards)
    if key is None:
        key = np.zeros(n, dtype=np.int64)
        for lane, card in zip(lanes, cards):
            key = key * card + lane

    # grouping ladder (measured at 8M rows): bounded spans take the O(n)
    # LUT factorize (0.2s); wide key spaces take ONE C-speed argsort
    # (~1s — beats both hashed grouping and ufunc.at extrema). Stats are
    # then one native pass per metric (gather fused into the run walk),
    # with bincount/reduceat numpy fallbacks.
    from pinot_tpu_torch.utils.factorize import int_lut_factorize
    inverse = order = starts = None
    fact = int_lut_factorize(key)
    if fact is not None:
        uniq, inverse = fact
        g = len(uniq)
    else:
        order = np.argsort(key)
        sk = key[order]
        starts = np.flatnonzero(
            np.concatenate(([True], sk[1:] != sk[:-1])))
        uniq = sk[starts]
        g = len(uniq)
    if g > config.max_groups:
        return None                         # cube would not pay off

    dim_ids: Dict[str, np.ndarray] = {}
    rem = uniq.copy()
    for d, card in zip(reversed(config.dimensions), reversed(cards)):
        dim_ids[d] = (rem % card).astype(np.int32)
        rem //= card
    if starts is not None:
        counts = np.diff(np.append(starts, n)).astype(np.int64)
    else:
        counts = native.group_counts(inverse, g)
        if counts is None:
            counts = np.bincount(inverse, minlength=g).astype(np.int64)

    metric_stats: Dict[str, Dict[str, np.ndarray]] = {}
    for m in config.metrics:
        if m not in metric_vals:
            return None
        vals = metric_vals[m]
        if callable(vals):
            vals = vals()
        vals = np.asarray(vals, dtype=np.float64)
        stats = None
        if starts is not None:
            stats = native.group_stats_sorted(order, starts, n, vals)
            if stats is None:
                sv = vals[order]
                stats = (np.add.reduceat(sv, starts),
                         np.minimum.reduceat(sv, starts),
                         np.maximum.reduceat(sv, starts))
        else:
            stats = native.group_stats(inverse, vals, g)
            if stats is None:
                sums = np.bincount(inverse, weights=vals, minlength=g)
                mins = np.full(g, np.inf)
                maxs = np.full(g, -np.inf)
                np.minimum.at(mins, inverse, vals)
                np.maximum.at(maxs, inverse, vals)
                stats = (sums, mins, maxs)
        metric_stats[m] = {"sum": stats[0], "min": stats[1],
                           "max": stats[2]}
    return StarTreeCube(config, g, dim_ids, counts, metric_stats)


def _linear_unique(key: np.ndarray):
    """(sorted unique keys, inverse codes) — O(n) hash factorize with an
    np.unique fallback (pandas missing)."""
    from pinot_tpu_torch.utils.factorize import sorted_factorize_or_unique
    return sorted_factorize_or_unique(key)


def load_star_trees(seg_dir) -> List[StarTreeCube]:
    from pinot_tpu_torch.segment import format as fmt
    d = fmt.open_dir(seg_dir)
    cubes = []
    for meta_name in d.list(prefix="startree.", suffix=".json"):
        idx = int(meta_name.split(".")[1])
        try:
            cubes.append(StarTreeCube.load(d, idx))
        except Exception:  # noqa: BLE001 — an acceleration structure must
            # never brick the segment; skip the broken cube
            import logging
            logging.getLogger(__name__).warning(
                "skipping unloadable star-tree cube %d in %s", idx,
                d.path, exc_info=True)
    return cubes
