"""Star-tree query execution: route eligible queries to a cube.

Copy of pinot_tpu/startree/executor.py with imports rebased onto
pinot_tpu_torch: host numpy over the cube's lanes, the JAX package's
eligibility, prefix descent and combine, unchanged.

Parity: core/startree/ query side — StarTreeFilterOperator +
StarTreeAggregationExecutor/StarTreeGroupByExecutor and the plan nodes
that swap in when a query's dimensions/metrics are covered
(StarTreeV2's eligibility rules). Here the cube is a columnar grouped
table, so execution is: evaluate the filter over the cube's dictId lanes,
then weighted aggregation over the surviving groups.

Cube rows are SORTED by the split order (lexicographic in the packed
dictId key — the build's sorted factorize guarantees it), which is the
flattened form of the reference's tree: a conjunctive filter whose
leading split dimensions resolve to dictId intervals narrows to
contiguous row blocks by binary search (OffHeapStarTreeNode child lookup
≡ np.searchsorted on the sorted dim lane), and only the surviving block
rows are scanned for the residual predicates. A covering cube therefore
answers in O(log groups + matched rows) host time instead of O(groups).
"""
from __future__ import annotations

import threading
from typing import Dict, List, Optional, Tuple

import numpy as np

from pinot_tpu_torch.common import expression as expr_mod
from pinot_tpu_torch.common.request import (BrokerRequest, FilterOperator,
                                      FilterQueryTree)
from pinot_tpu_torch.query.aggregation import make_functions
from pinot_tpu_torch.query.blocks import ExecutionStats, IntermediateResultsBlock

_COVERED_BASES = {"COUNT", "SUM", "AVG", "MIN", "MAX", "MINMAXRANGE"}

# stop expanding prefix blocks past this fan-out: the residual scan over
# a bounded union of blocks is cheaper than deep enumeration
_PREFIX_BLOCK_LIMIT = 512


class _CubeDataSource:
    """Segment-DataSource-shaped view of one cube dimension lane."""

    def __init__(self, parent_ds, ids: np.ndarray):
        self.metadata = parent_ds.metadata
        self.dictionary = parent_ds.dictionary
        self.dict_ids = ids
        self.raw_values = None
        self.mv_dict_ids = None
        self.inverted_index = None
        self.bloom_filter = None
        self.sorted_ranges = None


class _CubeView:
    """Segment-shaped facade so host filter evaluation runs unchanged."""

    def __init__(self, segment, cube):
        self._segment = segment
        self._cube = cube
        self.num_docs = cube.n_groups
        self.segment_name = segment.segment_name

    def has_column(self, col: str) -> bool:
        return col in self._cube.dim_ids

    def data_source(self, col: str) -> _CubeDataSource:
        return _CubeDataSource(self._segment.data_source(col),
                               self._cube.dim_ids[col])


def _eligible_cube(segment, request: BrokerRequest, functions):
    """Pick the first cube covering the query, or None.

    Coverage: filter + group columns ⊆ dimensions (expressions allowed in
    filters when their source columns are dimensions); aggregations are
    COUNT(*) or covered-base functions over cube metrics.
    """
    cubes = getattr(segment, "star_trees", None)
    if not cubes or not request.is_aggregation or request.is_selection:
        return None
    if request.query_options.options.get("useStarTree") == "false":
        return None
    needed_dims = set()
    for c in request.filter_columns():
        needed_dims.update(expr_mod.referenced_columns(c))
    group_cols = list(request.group_by.columns) if request.group_by else []
    for c in group_cols:
        if expr_mod.is_expression(c):
            return None                       # group keys must be plain dims
        needed_dims.add(c)
    needed_metrics = set()
    for f in functions:
        if f.info.is_mv:
            return None
        if f.info.base == "COUNT":
            continue
        if f.info.base not in _COVERED_BASES:
            return None
        if expr_mod.is_expression(f.column):
            return None
        needed_metrics.add(f.column)
    best = None
    best_score = None
    leaves = _conjunctive_leaves(request.filter)
    for cube in cubes:
        if not (needed_dims <= set(cube.dimensions) and
                needed_metrics <= set(cube.metrics)):
            continue
        score, frac = _prefix_narrowing(segment, cube, leaves)
        if cube.n_groups * frac * 8 > segment.num_docs:
            # a cube nearly as tall as the segment must be narrowed to a
            # genuinely small block before it beats the doc-scale kernel:
            # a prefix "hit" from one wide RANGE on the leading dim (e.g.
            # dim >= 'A') would otherwise degrade to a near-full host scan
            continue
        key = (score, -cube.n_groups * frac)
        if best is None or key > best_score:
            best, best_score = cube, key
    return best


def _prefix_narrowing(segment, cube, leaves) -> Tuple[int, float]:
    """(depth, est fraction): how many leading split dims a conjunctive
    filter narrows, and the estimated fraction of cube rows left after the
    descent (product of per-dim dictId coverage under a uniform-ids
    assumption). Depth ranks cube choice; the fraction gates eligibility so
    a wide RANGE on the leading dim doesn't count as real narrowing."""
    if not leaves:
        return 0, 1.0
    by_col = {}
    for lf in leaves:
        by_col.setdefault(lf.column, []).append(lf)
    score = 0
    frac = 1.0
    for dim in cube.dimensions:
        ivs = None
        ds = segment.data_source(dim)
        for lf in by_col.get(dim, ()):
            ivs = _leaf_id_intervals(lf, ds)
            if ivs is not None:
                break
        if ivs is None:
            break
        score += 1
        card = max(1, len(ds.dictionary)) if ds.dictionary is not None \
            else 1
        covered = sum(b - a for a, b in ivs)
        frac *= min(1.0, covered / card)
        if not all(b - a == 1 for a, b in ivs):
            break                       # descent stops after an interval
    return score, frac


def _conjunctive_leaves(tree: Optional[FilterQueryTree]
                        ) -> Optional[List[FilterQueryTree]]:
    """Flatten an AND-only filter tree into its leaves; None when the
    tree contains OR (prefix narrowing needs a pure conjunction)."""
    if tree is None:
        return []
    if tree.is_leaf():
        return [tree]
    if tree.operator != FilterOperator.AND:
        return None
    out: List[FilterQueryTree] = []
    for c in tree.children:
        sub = _conjunctive_leaves(c)
        if sub is None:
            return None
        out.extend(sub)
    return out


def _leaf_id_intervals(leaf: FilterQueryTree, ds
                       ) -> Optional[List[Tuple[int, int]]]:
    """Sorted-dictionary dictId intervals [a, b) equivalent to the leaf,
    or None when the leaf can't narrow a sorted cube lane (NOT/NOT_IN/
    REGEXP, expression columns, unsorted mutable dictionaries)."""
    if expr_mod.is_expression(leaf.column):
        return None
    d = ds.dictionary
    if d is None or not getattr(d, "is_sorted", True):
        return None
    op = leaf.operator
    if op == FilterOperator.EQUALITY:
        i = d.index_of(leaf.values[0])
        return [] if i < 0 else [(i, i + 1)]
    if op == FilterOperator.IN:
        ids = sorted({d.index_of(v) for v in leaf.values} - {-1})
        return [(i, i + 1) for i in ids]
    if op == FilterOperator.RANGE:
        lo, hi = d.range_to_id_interval(
            leaf.lower, leaf.upper, leaf.lower_inclusive,
            leaf.upper_inclusive)
        return [] if hi <= lo else [(lo, hi)]
    return None


def _prefix_select(segment, cube, leaves: List[FilterQueryTree]
                   ) -> Optional[Tuple[np.ndarray, int]]:
    """(selected row indices, rows examined) via sorted-prefix descent,
    or None when the leading split dimension is unconstrained (full scan
    is then the only option). Parity: StarTreeFilterOperator's
    depth-first child matching over OffHeapStarTreeNode, done as binary
    searches on the sorted dim lanes."""
    by_col: Dict[str, List[FilterQueryTree]] = {}
    for lf in leaves:
        by_col.setdefault(lf.column, []).append(lf)

    blocks: List[Tuple[int, int]] = [(0, cube.n_groups)]
    consumed: set = set()
    narrowed = False
    for dim in cube.dimensions:
        ivs = None
        src = None
        for lf in by_col.get(dim, ()):
            ivs = _leaf_id_intervals(lf, segment.data_source(dim))
            if ivs is not None:
                src = lf
                break
        if ivs is None:
            break                       # unconstrained dim: stop descent
        lane = cube.dim_ids[dim]
        new_blocks: List[Tuple[int, int]] = []
        if len(blocks) * max(len(ivs), 1) > _PREFIX_BLOCK_LIMIT:
            break
        dt = lane.dtype.type          # dim lanes are int32; ids fit
        for lo, hi in blocks:
            seg_lane = lane[lo:hi]
            for a, b in ivs:
                # dtype-matched scalars: a python-int key would make numpy
                # promote (copy+cast) the whole lane per call (~120x)
                s = lo + int(np.searchsorted(seg_lane, dt(a), side="left"))
                e = lo + int(np.searchsorted(seg_lane, dt(b), side="left"))
                if s < e:
                    new_blocks.append((s, e))
        blocks = new_blocks
        consumed.add(id(src))
        narrowed = True
        if not blocks:
            break
        if not all(b - a == 1 for a, b in ivs):
            # rows inside a multi-id block aren't sorted by deeper dims
            break
    if not narrowed:
        return None

    sel = (np.concatenate([np.arange(lo, hi, dtype=np.int64)
                           for lo, hi in blocks])
           if blocks else np.zeros(0, np.int64))
    examined = int(sel.size)
    residual = [lf for lf in leaves if id(lf) not in consumed]
    if residual and sel.size:
        from pinot_tpu_torch.query import host_exec
        view = _SlicedCubeView(segment, cube, sel)
        m = np.ones(sel.size, dtype=bool)
        for lf in residual:
            m &= host_exec._eval_leaf(lf, view)
        sel = sel[m]
    return sel, examined


class _SlicedCubeView:
    """_CubeView restricted to a row subset (residual predicate eval)."""

    def __init__(self, segment, cube, sel: np.ndarray):
        self._segment = segment
        self._cube = cube
        self._sel = sel
        self.num_docs = int(sel.size)
        self.segment_name = segment.segment_name

    def has_column(self, col: str) -> bool:
        return col in self._cube.dim_ids

    def data_source(self, col: str) -> _CubeDataSource:
        return _CubeDataSource(self._segment.data_source(col),
                               self._cube.dim_ids[col][self._sel])


def _cube_select(segment, cube, tree: Optional[FilterQueryTree]
                 ) -> Tuple[np.ndarray, int]:
    """Selected cube row indices + rows-examined. Prefix descent when
    the filter is conjunctive and constrains the leading split dims;
    full member-gather scan otherwise. Raises for predicates the host
    evaluator can't resolve (callers fall back to the non-cube path)."""
    leaves = _conjunctive_leaves(tree)
    if leaves is not None and tree is not None:
        ps = _prefix_select(segment, cube, leaves)
        if ps is not None:
            return ps
    from pinot_tpu_torch.query import host_exec
    view = _CubeView(segment, cube)
    mask = host_exec._eval_filter(tree, view)
    return np.nonzero(mask)[0], cube.n_groups


def try_star_tree_execute(segment, request: BrokerRequest
                          ) -> Optional[IntermediateResultsBlock]:
    """Execute over a covering cube; None when not eligible."""
    if not getattr(segment, "star_trees", None):
        return None
    functions = make_functions(request.aggregations)
    cube = _eligible_cube(segment, request, functions)
    if cube is None:
        return None
    try:
        sel, examined = _cube_select(segment, cube, request.filter)
    except Exception:  # noqa: BLE001 — unresolvable predicate: fall back
        return None

    blk = IntermediateResultsBlock()
    counts = cube.counts
    matched_docs = int(counts[sel].sum())
    if request.is_group_by:
        _cube_group_by(segment, cube, request, functions, sel, blk)
    else:
        blk.agg_intermediates = [
            _cube_aggregate(cube, f, sel) for f in functions]
    blk.stats = ExecutionStats(
        num_docs_scanned=int(sel.size),           # groups, not raw docs —
        # parity: star-tree queries report aggregated doc counts
        num_entries_scanned_in_filter=examined,
        num_segments_processed=1,
        num_segments_matched=1 if matched_docs else 0,
        total_docs=segment.num_docs)
    return blk


def try_star_tree_execute_multi(segments, request: BrokerRequest
                                ) -> Optional[IntermediateResultsBlock]:
    """Vectorized cube execution across MANY segments at once.

    The per-segment path emits one group_map dict per segment and merges
    them entry-by-entry in Python — fine for two segments, dominant cost
    for many. Here the matched cube rows (decoded group values, counts,
    stat lanes) from every segment are concatenated and aggregated in one
    numpy group-by pass. Parity: the combine step of
    StarTreeAggregationExecutor outputs, done columnar.
    """
    if not request.is_aggregation or request.is_selection:
        return None
    functions = make_functions(request.aggregations)
    pairs = []
    for seg in segments:
        cube = _eligible_cube(seg, request, functions)
        if cube is None:
            return None                   # all segments must be covered
        pairs.append((seg, cube))

    gcols = list(request.group_by.columns) if request.group_by else []
    # per gcol: (union value table, per-segment local-id -> union-id LUTs)
    # — cached per (segment set, column); keeps the hot path free of
    # OBJECT-array uniques (python string compares dominated the q3.2
    # residual at 8 segments)
    unions = [_union_lut([seg for seg, _ in pairs], c) for c in gcols]
    code_chunks: List[List[np.ndarray]] = [[] for _ in gcols]
    cnt_chunks: List[np.ndarray] = []
    stat_chunks: Dict[str, List[np.ndarray]] = {}
    # each column's stat lanes exactly once per segment — two functions
    # over the same column (MIN(x), MAX(x)) must not double-append
    stat_cols = sorted({f.column for f in functions
                        if f.info.base != "COUNT"})
    total_docs = 0
    matched_groups = 0
    scanned = 0
    for si, (seg, cube) in enumerate(pairs):
        total_docs += seg.num_docs
        try:
            sel, examined = _cube_select(seg, cube, request.filter)
        except Exception:  # noqa: BLE001 — unresolvable predicate
            return None
        scanned += examined
        matched_groups += len(sel)
        cnt_chunks.append(cube.counts[sel])
        for i, c in enumerate(gcols):
            lut = unions[i][1][si]
            code_chunks[i].append(lut[cube.dim_ids[c][sel]])
        for col in stat_cols:
            stats = cube.metric_stats[col]
            for k in ("sum", "min", "max"):
                stat_chunks.setdefault(f"{col}.{k}", []).append(
                    stats[k][sel])

    counts = np.concatenate(cnt_chunks) if cnt_chunks else \
        np.zeros(0, np.int64)
    stats_cat = {k: np.concatenate(v) for k, v in stat_chunks.items()}
    blk = IntermediateResultsBlock()
    if not gcols:
        mask_all = np.ones(len(counts), dtype=bool)
        flat_cube = StarTreeCubeLike(counts, stats_cat)
        blk.agg_intermediates = [
            _cube_aggregate(flat_cube, f, mask_all) for f in functions]
    else:
        _multi_group_by([u[0] for u in unions], code_chunks, counts,
                        stats_cat, functions, blk)
        from pinot_tpu_torch.query.combine import trim_group_map, trim_size_for
        t = trim_size_for(request.group_by.top_n)
        if len(blk.group_map) > 4 * t:
            # same memory/parity bound combine_blocks applies on the
            # per-segment path (AggregationGroupByTrimmingService)
            blk.group_map = trim_group_map(blk.group_map, functions, t)
    blk.stats = ExecutionStats(
        num_docs_scanned=matched_groups,
        num_entries_scanned_in_filter=scanned,
        num_segments_processed=len(segments),
        num_segments_matched=len(segments) if matched_groups else 0,
        total_docs=total_docs)
    return blk


class StarTreeCubeLike:
    """Concatenated cross-segment cube rows, shaped like a cube for
    _cube_aggregate."""

    def __init__(self, counts: np.ndarray, stats_cat: Dict[str, np.ndarray]):
        self.counts = counts
        self.metric_stats: Dict[str, Dict[str, np.ndarray]] = {}
        for k, arr in stats_cat.items():
            col, stat = k.rsplit(".", 1)
            self.metric_stats.setdefault(col, {})[stat] = arr


_UNION_LUT_CACHE: Dict = {}
_UNION_LUT_LOCK = threading.Lock()


def _segment_cache_identity(s, col: str):
    """Stable identity for one (segment, column) cache axis.

    id(s) is NOT stable: after a segment unload/reload the interpreter
    can reuse the address for the replacement segment, silently serving
    the OLD union LUT — wrong group-by values with no error. Name +
    num_docs + crc + dictionary fingerprint (cardinality and boundary
    values change whenever the value set changes) pin the entry to the
    segment artifact's contents instead of its transient address."""
    d = s.data_source(col).dictionary
    n = len(d)
    fingerprint = (n, str(d.values[0]), str(d.values[n - 1])) if n else (0,)
    md = getattr(s, "metadata", None)
    return (getattr(s, "segment_name", None), s.num_docs,
            getattr(md, "crc", None), fingerprint)


def _union_lut(segments, col: str):
    """(union value table, per-segment local-dictId -> union-id LUT).

    Cached per (segment identity tuple, column): the union merge and its
    object-array compares run once per segment set, leaving only int
    gathers on the query hot path."""
    key = (tuple(_segment_cache_identity(s, col) for s in segments), col)
    with _UNION_LUT_LOCK:
        hit = _UNION_LUT_CACHE.get(key)
    if hit is not None:
        return hit
    dicts = [np.asarray(s.data_source(col).dictionary.values)
             for s in segments]
    union = np.unique(np.concatenate(dicts)) if dicts else \
        np.zeros(0, object)
    luts = [np.searchsorted(union, d).astype(np.int64) for d in dicts]
    with _UNION_LUT_LOCK:
        if len(_UNION_LUT_CACHE) > 256:
            _UNION_LUT_CACHE.clear()
        _UNION_LUT_CACHE[key] = (union, luts)
    return union, luts


def _multi_group_by(uniq_vals, code_chunks, counts, stats_cat, functions,
                    blk) -> None:
    """Cross-segment group-by over UNION-id codes (int lanes only; the
    object-domain work happened once in _union_lut)."""
    n = len(counts)
    codes = [np.concatenate(chunks).astype(np.int64) if chunks else
             np.zeros(0, np.int64) for chunks in code_chunks]
    key = np.zeros(n, dtype=np.int64)
    for u, inv in zip(uniq_vals, codes):
        key = key * max(len(u), 1) + inv
    uniq_keys, inverse = np.unique(key, return_inverse=True)
    g = len(uniq_keys)

    value_cols = []
    rem = uniq_keys.copy()
    for u in reversed(uniq_vals):
        value_cols.append(u[rem % max(len(u), 1)])
        rem //= max(len(u), 1)
    value_cols.reverse()

    _fill_group_map(blk, functions, g, inverse, counts, value_cols,
                    lambda f, k: stats_cat[f"{f.column}.{k}"])


def _cube_aggregate(cube, f, sel: np.ndarray):
    """sel: selected row indices (or a boolean mask — fancy indexing
    treats both identically here)."""
    base = f.info.base
    mask = sel
    cnt = int(cube.counts[mask].sum())
    if base == "COUNT":
        return cnt
    if cnt == 0:
        return None
    stats = cube.metric_stats[f.column]
    if base == "SUM":
        return float(stats["sum"][mask].sum())
    if base == "AVG":
        return (float(stats["sum"][mask].sum()), cnt)
    if base == "MIN":
        return float(stats["min"][mask].min())
    if base == "MAX":
        return float(stats["max"][mask].max())
    if base == "MINMAXRANGE":
        return (float(stats["min"][mask].min()),
                float(stats["max"][mask].max()))
    raise ValueError(base)


def _cube_group_by(segment, cube, request, functions, sel: np.ndarray,
                   blk: IntermediateResultsBlock) -> None:
    gcols = request.group_by.columns
    lanes = [cube.dim_ids[c][sel].astype(np.int64) for c in gcols]
    cards = [segment.data_source(c).metadata.cardinality for c in gcols]
    key = np.zeros(len(sel), dtype=np.int64)
    for lane, card in zip(lanes, cards):
        key = key * card + lane
    uniq, inverse = np.unique(key, return_inverse=True)
    g = len(uniq)

    value_cols = []
    rem = uniq.copy()
    for c, card in zip(reversed(gcols), reversed(cards)):
        d = segment.data_source(c).dictionary
        value_cols.append(d.decode(rem % card))
        rem //= card
    value_cols.reverse()

    _fill_group_map(blk, functions, g, inverse, cube.counts[sel],
                    value_cols,
                    lambda f, k: cube.metric_stats[f.column][k][sel])


def _fill_group_map(blk: IntermediateResultsBlock, functions, g: int,
                    inverse: np.ndarray, row_counts: np.ndarray,
                    value_cols, stat_rows) -> None:
    """Shared group-by finisher for the single-segment and multi-segment
    cube paths: scatter matched cube rows into `g` group slots and emit
    the engine's standard intermediate formats (AVG = (sum, count),
    MINMAXRANGE = (min, max)). `stat_rows(f, kind)` yields the matched
    rows' "sum"/"min"/"max" lane for function f."""
    gcounts = np.zeros(g, dtype=np.int64)
    np.add.at(gcounts, inverse, row_counts)
    per_fn: List[List] = []
    for f in functions:
        base = f.info.base
        if base == "COUNT":
            per_fn.append([int(c) for c in gcounts])
            continue
        if base in ("SUM", "AVG"):
            sums = np.zeros(g)
            np.add.at(sums, inverse, stat_rows(f, "sum"))
            if base == "SUM":
                per_fn.append([float(s) for s in sums])
            else:
                per_fn.append([(float(s), int(c))
                               for s, c in zip(sums, gcounts)])
        else:
            mins = np.full(g, np.inf)
            maxs = np.full(g, -np.inf)
            np.minimum.at(mins, inverse, stat_rows(f, "min"))
            np.maximum.at(maxs, inverse, stat_rows(f, "max"))
            if base == "MIN":
                per_fn.append([float(v) for v in mins])
            elif base == "MAX":
                per_fn.append([float(v) for v in maxs])
            else:
                per_fn.append([(float(a), float(b))
                               for a, b in zip(mins, maxs)])
    # tolist() converts np scalars to python at C speed — the per-element
    # _plain/.item() genexpr was the profile's top fixed cost per query
    col_lists = [np.asarray(vc).tolist() for vc in value_cols]
    n_fn = len(functions)
    blk.group_map = {
        key: [per_fn[fi][i] for fi in range(n_fn)]
        for i, key in enumerate(zip(*col_lists))}
