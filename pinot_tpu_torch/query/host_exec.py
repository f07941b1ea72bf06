"""Host (numpy) query executor — the fallback + CPU baseline path.

Copy of pinot_tpu/query/host_exec.py with imports rebased onto
pinot_tpu_torch, reading the loader's host arrays (dict_ids, raw_values,
mv_dict_ids, dictionary). Two changes: the group-by codes string and
integer dictionary keys and DISTINCTCOUNT arguments by dictId and counts
small code spaces with np.bincount, where the JAX module sorts the
decoded values (the same answers; seconds less per query over millions
of rows), a join's dim-side group key is coded through the dim column's
sorted uniques in the same way; and a selection's ORDER BY over a consuming segment's
arrival-order dictionary ranks by value, where the JAX module orders by
dictId and returns rows out of value order. The executor reaches it only when the planner
refuses a segment plan as the JAX planner does (UnsupportedOnDevice,
GroupsLimitExceeded), never for a port gap (NotPorted). The vector
top-k (`_vector_topk`, exact or IVF-probed through index/ivf.py's numpy
twins) and the join probe (`_join_probe`, the twin of K1's join leaf,
applied after the upsert mask, and the dim-qualified group keys read
through the matched dim row) are the JAX module's.

Covers query shapes the device kernels don't (group cardinality over the
groups limit, order-by keys too wide to pack, percentile over raw columns)
and doubles as the CPU reference implementation the benchmarks compare
against. Produces IntermediateResultsBlock objects merge-compatible with the
device path.

Parity note: this is the moral equivalent of the reference's scan-based
operators (ScanBasedFilterOperator + DefaultAggregationExecutor /
DefaultGroupByExecutor / SelectionOperator) executed columnar-vectorized.

DELIBERATE TWIN DECISION (round 5): this module and ops/kernels.py both
implement the full operator semantics. The duplication is intentional,
not accidental: (a) the host twin doubles as the INDEPENDENT oracle the
randomized agreement sweeps (tests/test_query_generator.py) compare the
device path against — sharing a predicate-resolution layer would make
the two paths fail together; (b) the performance-critical layouts
diverge fundamentally (dictId-interval compares on padded lanes vs
member-vector gathers on exact arrays), so a shared abstraction would
be an interface with two disjoint implementations anyway. The cost — a
new scalar function must be added twice — is bounded by the agreement
sweep, which fails loudly when one side is missing or diverges.
"""
from __future__ import annotations

import re as _re
from typing import Dict, List, Optional, Tuple

import numpy as np

from pinot_tpu_torch.common import expression as expr_mod
from pinot_tpu_torch.common.request import (BrokerRequest, FilterOperator,
                                      FilterQueryTree)
from pinot_tpu_torch.common.sketches import HyperLogLog, TDigest
from pinot_tpu_torch.query.aggregation import AggregationFunction, make_functions
from pinot_tpu_torch.query.blocks import ExecutionStats, IntermediateResultsBlock
from pinot_tpu_torch.segment.loader import DataSource, ImmutableSegment


def _upsert_valid_mask(segment) -> Optional[np.ndarray]:
    """Per-doc liveness mask for upsert tables, or None. Mutable
    snapshot views carry a PINNED `valid_doc_mask`; immutable segments
    snapshot their live ValidDocIds bitmap here (realtime/upsert.py)."""
    vm = getattr(segment, "valid_doc_mask", None)
    if vm is not None:
        return vm
    vd = getattr(segment, "valid_doc_ids", None)
    if vd is not None and vd.num_invalid:
        return vd.valid_mask(0, segment.num_docs)
    return None


def execute_host(segment: ImmutableSegment, request: BrokerRequest
                 ) -> IntermediateResultsBlock:
    mask = _eval_filter(request.filter, segment)
    vm = _upsert_valid_mask(segment)
    if vm is not None:
        # superseded rows are masked BEFORE any aggregation/selection —
        # the host half of the host-vs-device upsert parity contract
        mask = mask & vm
    dimrow = None
    jctx = getattr(request, "_join_ctx", None)
    if jctx is not None:
        # inner-join probe (the twin of K1's join leaf): rows without a
        # dim match mask out BEFORE aggregation, and after the vdoc mask,
        # so dead upserted rows never join here either
        hit, dimrow = _join_probe(segment, jctx)
        mask = mask & hit
    blk = IntermediateResultsBlock()
    matched = int(mask.sum())

    if request.is_group_by:
        _group_by(segment, request, mask, blk, jctx=jctx, dimrow=dimrow)
    elif request.is_aggregation:
        blk.agg_intermediates = [
            _aggregate(segment, f, mask) for f in make_functions(
                request.aggregations)]
    if request.vector is not None:
        # ANN probing narrows the candidate set inside _vector_topk; the
        # returned count keeps the scanned-docs stats equal to the device
        # path's fused-filter accounting
        matched = _vector_topk(segment, request, mask, blk)
    elif request.is_selection:
        _selection(segment, request, mask, blk)

    blk.stats = ExecutionStats(
        num_docs_scanned=matched,
        num_entries_scanned_in_filter=(
            _count_leaves(request.filter) * segment.num_docs),
        num_segments_processed=1,
        num_segments_matched=1 if matched else 0,
        total_docs=segment.num_docs)
    return blk


def _count_leaves(tree: Optional[FilterQueryTree]) -> int:
    if tree is None:
        return 0
    if tree.is_leaf():
        return 1
    return sum(_count_leaves(c) for c in tree.children)


# ---------------------------------------------------------------------------
# Filter evaluation (vectorized numpy over decoded / id lanes)
# ---------------------------------------------------------------------------


def _eval_filter(tree: Optional[FilterQueryTree], segment: ImmutableSegment
                 ) -> np.ndarray:
    n = segment.num_docs
    if tree is None:
        return np.ones(n, dtype=bool)
    if tree.operator in (FilterOperator.AND, FilterOperator.OR):
        masks = [_eval_filter(c, segment) for c in tree.children]
        out = masks[0]
        for m in masks[1:]:
            out = (out & m) if tree.operator == FilterOperator.AND else \
                (out | m)
        return out
    return _eval_leaf(tree, segment)


def _expr_rows(text: str, segment: ImmutableSegment) -> np.ndarray:
    """Row-domain expression evaluation (host fallback / mutable path).

    Memoized per segment object (immutable segments are immutable; mutable
    segments are queried through per-query snapshot views, so the cache is
    naturally query-scoped there)."""
    cache = getattr(segment, "_expr_cache", None)
    if cache is None:
        try:
            cache = segment._expr_cache = {}
        except AttributeError:      # __slots__ or frozen object
            cache = None
    if cache is not None and text in cache:
        return cache[text]

    def resolve(c: str) -> np.ndarray:
        ds = segment.data_source(c)
        cm = ds.metadata
        if not cm.single_value:
            raise ValueError(f"MV column {c} in expression")
        if cm.has_dictionary:
            return np.asarray(ds.dictionary.values)[ds.dict_ids]
        return ds.raw_values

    out = np.asarray(expr_mod.evaluate(text, resolve))
    if cache is not None:
        if len(cache) > 32:
            cache.clear()
        cache[text] = out
    return out


def _eval_expr_leaf(tree: FilterQueryTree, segment: ImmutableSegment
                    ) -> np.ndarray:
    from pinot_tpu_torch.query.plan import _pred_over_values
    vals = _expr_rows(tree.column, segment).astype(np.float64)
    return _pred_over_values(tree, vals)


def _eval_leaf(tree: FilterQueryTree, segment: ImmutableSegment) -> np.ndarray:
    if expr_mod.is_expression(tree.column):
        return _eval_expr_leaf(tree, segment)
    ds = segment.data_source(tree.column)
    cm = ds.metadata
    n = segment.num_docs
    op = tree.operator

    if op == FilterOperator.IS_NULL:
        return np.zeros(n, dtype=bool)
    if op == FilterOperator.IS_NOT_NULL:
        return np.ones(n, dtype=bool)

    if not cm.has_dictionary:
        vals = ds.raw_values
        cv = _coercer(cm.data_type)
        if op == FilterOperator.EQUALITY:
            return vals == cv(tree.values[0])
        if op == FilterOperator.NOT:
            return vals != cv(tree.values[0])
        if op == FilterOperator.IN:
            return np.isin(vals, [cv(v) for v in tree.values])
        if op == FilterOperator.NOT_IN:
            return ~np.isin(vals, [cv(v) for v in tree.values])
        if op == FilterOperator.RANGE:
            m = np.ones(n, dtype=bool)
            if tree.lower is not None:
                lo = cv(tree.lower)
                m &= (vals >= lo) if tree.lower_inclusive else (vals > lo)
            if tree.upper is not None:
                hi = cv(tree.upper)
                m &= (vals <= hi) if tree.upper_inclusive else (vals < hi)
            return m
        if op == FilterOperator.REGEXP_LIKE:
            import re
            pattern = re.compile(str(tree.values[0]))
            return np.fromiter(
                (pattern.search(str(v)) is not None for v in vals),
                dtype=bool, count=len(vals))
        raise ValueError(f"unsupported raw filter {op}")

    # dictionary-encoded: resolve to id-domain predicate, then test lanes
    dictionary = ds.dictionary
    card = dictionary.cardinality
    member = np.zeros(card + 1, dtype=bool)  # slot card = MV padding
    if op == FilterOperator.EQUALITY:
        i = dictionary.index_of(tree.values[0])
        if i >= 0:
            member[i] = True
    elif op == FilterOperator.NOT:
        member[:card] = True
        i = dictionary.index_of(tree.values[0])
        if i >= 0:
            member[i] = False
    elif op == FilterOperator.IN:
        for v in tree.values:
            i = dictionary.index_of(v)
            if i >= 0:
                member[i] = True
    elif op == FilterOperator.NOT_IN:
        member[:card] = True
        for v in tree.values:
            i = dictionary.index_of(v)
            if i >= 0:
                member[i] = False
    elif op == FilterOperator.RANGE:
        if getattr(dictionary, "is_sorted", True):
            lo, hi = dictionary.range_to_id_interval(
                tree.lower, tree.upper, tree.lower_inclusive,
                tree.upper_inclusive)
            member[lo:hi] = True
        else:
            # mutable (arrival-order) dictionary: compare every value
            vals = dictionary.values
            m = np.ones(card, dtype=bool)
            if cm.data_type.is_numeric:
                cv = _coercer(cm.data_type)
            else:
                cv = str
            if tree.lower is not None:
                lo_v = cv(tree.lower)
                m &= (vals >= lo_v) if tree.lower_inclusive else (vals > lo_v)
            if tree.upper is not None:
                hi_v = cv(tree.upper)
                m &= (vals <= hi_v) if tree.upper_inclusive else (vals < hi_v)
            member[:card] = m
    elif op == FilterOperator.REGEXP_LIKE:
        pat = _re.compile(tree.values[0])
        for i in range(card):
            if pat.search(str(dictionary.get(i))):
                member[i] = True
    else:
        raise ValueError(f"unsupported filter {op}")

    if cm.single_value:
        return member[ds.dict_ids]
    return member[ds.mv_dict_ids].any(axis=1)


def _coercer(data_type):
    """Predicate-literal coercion for a column's DataType (raw columns
    compare in the value domain: hex literals become bytes for BYTES,
    everything else numeric/str)."""
    dt = data_type.np_dtype
    if dt.kind == "f":
        return lambda v: dt.type(float(v))
    if dt.kind in "iu":
        return lambda v: dt.type(int(str(v)))
    from pinot_tpu_torch.common.datatype import DataType as _DT
    if data_type == _DT.BYTES:
        return lambda v: v if isinstance(v, bytes) \
            else bytes.fromhex(str(v))
    return str          # chunked raw string columns compare as strings


# ---------------------------------------------------------------------------
# Aggregation
# ---------------------------------------------------------------------------


def _masked_values(segment: ImmutableSegment, col: str, mask: np.ndarray
                   ) -> np.ndarray:
    src = _mv_group_source(segment, col)
    if src is not None:                  # MV column or valuein(mvcol, ...)
        vals, _counts = _mv_entries(src[0], src[1], np.nonzero(mask)[0])
        return vals
    if expr_mod.is_expression(col):
        return _expr_rows(col, segment)[mask]
    ds = segment.data_source(col)
    cm = ds.metadata
    if not cm.has_dictionary:
        return ds.raw_values[mask]
    return ds.dictionary.values[ds.dict_ids[mask]]


def _hll_derived(segment: ImmutableSegment, col: str) -> bool:
    """True when `col` is a derived serialized-HLL column (its values are
    hex sketches to union, not raw values to hash)."""
    try:
        cm = segment.data_source(col).metadata
    except KeyError:
        return False
    return getattr(cm, "derived_metric_type", None) == "HLL"


def _aggregate(segment: ImmutableSegment, f: AggregationFunction,
               mask: np.ndarray):
    base = f.info.base
    if base == "COUNT" and not f.info.is_mv:
        return int(mask.sum())
    if f.info.is_mv and _mv_group_source(segment, f.column) is None:
        raise ValueError(
            f"{base}MV needs a multi-value column, got {f.column}")
    vals = _masked_values(segment, f.column, mask)
    if base == "COUNT":  # COUNTMV: entries
        return int(len(vals))
    if len(vals) == 0:
        return None
    if base == "SUM":
        return float(np.sum(np.asarray(vals, dtype=np.float64)))
    if base == "MIN":
        return float(vals.min())
    if base == "MAX":
        return float(vals.max())
    if base == "AVG":
        return (float(np.sum(np.asarray(vals, dtype=np.float64))), len(vals))
    if base == "MINMAXRANGE":
        return (float(vals.min()), float(vals.max()))
    if base == "DISTINCTCOUNT":
        return set(_plain(v) for v in np.unique(vals))
    if base in ("DISTINCTCOUNTHLL", "FASTHLL", "DISTINCTCOUNTRAWHLL"):
        if base == "FASTHLL" and _hll_derived(segment, f.column):
            from pinot_tpu_torch.common.sketches import union_serialized_hlls
            return union_serialized_hlls(np.unique(vals))
        return HyperLogLog.from_values(np.unique(vals))
    if base == "PERCENTILE":
        uniq, counts = np.unique(vals, return_counts=True)
        return {_plain(u): int(c) for u, c in zip(uniq, counts)}
    if base in ("PERCENTILEEST", "PERCENTILETDIGEST"):
        uniq, counts = np.unique(np.asarray(vals, dtype=np.float64),
                                 return_counts=True)
        return TDigest.from_values(uniq, weights=counts)
    raise ValueError(base)


# ---------------------------------------------------------------------------
# Group-by
# ---------------------------------------------------------------------------


def _valuein_parts(c: str):
    """(column, literal texts) if ``c`` is ``valuein(col, lit, ...)``,
    else None (shared validation: expression.valuein_parts)."""
    if not expr_mod.is_expression(c):
        return None
    return expr_mod.valuein_parts(c)


def _mv_group_source(segment: ImmutableSegment, c: str):
    """(data source, allowed-dictId bool mask | None) when ``c`` is an MV
    dictionary column or ``valuein(mvcol, ...)``; None for scalar keys.

    Parity: DefaultGroupByExecutor.aggregateGroupByMV — MV keys
    contribute one group entry per (doc, value); ValueInTransformFunction
    restricts the value set (`core/operator/transform/transformer`)."""
    vi = _valuein_parts(c)
    name = vi[0] if vi else c
    if expr_mod.is_expression(name):
        return None
    ds = segment.data_source(name)
    cm = ds.metadata
    if cm.single_value or not cm.has_dictionary:
        if vi:
            raise ValueError(
                f"valuein needs a dictionary-encoded MV column, got {name}")
        return None
    allowed = None
    if vi:
        allowed = np.zeros(cm.cardinality, dtype=bool)
        ids = ds.dictionary.index_of_many(vi[1])
        allowed[ids[ids >= 0]] = True
    return ds, allowed


def _mv_entries(ds, allowed, row2doc: np.ndarray):
    """Per-row MV entries for the given doc rows: (values, counts) where
    counts[i] is row i's entry count and values holds the entries
    row-major (padding slots — id == cardinality — and, for valuein,
    disallowed values are dropped)."""
    card = ds.metadata.cardinality
    ids = ds.mv_dict_ids[row2doc]                 # [rows, width]
    valid = ids < card
    if allowed is not None:
        valid &= allowed[np.clip(ids, 0, card - 1)]
    counts = valid.sum(axis=1)
    values = np.asarray(ds.dictionary.values)[ids[valid]]
    return values, counts


def _group_value_rows(segment: ImmutableSegment, c: str,
                      row2doc: np.ndarray) -> np.ndarray:
    """Row values for one scalar group-by key (column or expression) over
    the expanded row space (row2doc maps rows back to doc ids)."""
    if expr_mod.is_expression(c):
        return _expr_rows(c, segment)[row2doc]
    ds = segment.data_source(c)
    cm = ds.metadata
    if cm.has_dictionary and cm.single_value:
        return np.asarray(ds.dictionary.values)[ds.dict_ids[row2doc]]
    if not cm.has_dictionary:
        return ds.raw_values[row2doc]
    raise ValueError(f"host group-by needs SV column {c}")


#: the largest code space counted densely (np.bincount) instead of sorted
DENSE_CODES = 1 << 22


def _dict_rows(segment: ImmutableSegment, c: str, row2doc: np.ndarray
               ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """(sorted dictionary values, int64 dictIds of the rows) of a string
    or integer dictionary SV column, else None. Its dictIds code its
    values in value order, as np.unique over the values would."""
    if expr_mod.is_expression(c):
        return None
    ds = segment.data_source(c)
    cm = ds.metadata
    vals = np.asarray(ds.dictionary.values) if cm.has_dictionary else None
    if not cm.single_value or vals is None or vals.dtype.kind == "f":
        return None
    return vals, ds.dict_ids[row2doc].astype(np.int64)


def _unique_codes(codes: np.ndarray, size: int
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """(sorted distinct codes, each row's index among them) of int codes
    in [0, size): np.unique(codes, return_inverse=True), counted densely
    when the code space is small."""
    if size > DENSE_CODES:
        u, inv = np.unique(codes, return_inverse=True)
        return u, inv.reshape(-1).astype(np.int64)
    u = np.nonzero(np.bincount(codes, minlength=size))[0]
    slot = np.zeros(size, np.int64)
    slot[u] = np.arange(len(u))
    return u, slot[codes]


# ---------------------------------------------------------------------------
# Join probe (host twin of the fused device join predicate)
# ---------------------------------------------------------------------------


def _join_probe(segment: ImmutableSegment, jctx):
    """(hit mask [n], dim row index [n]) for the fact key column:
    value-domain searchsorted against the JoinContext's dim keys, so
    consuming (arrival-order-dictionary) segments probe exactly like
    committed ones."""
    from pinot_tpu_torch.query.plan import _join_key_source
    n = segment.num_docs
    if jctx.empty:
        return np.zeros(n, dtype=bool), np.zeros(n, dtype=np.int64)
    source, ds = _join_key_source(jctx, segment)
    if source == "sv":
        vals = np.asarray(ds.dictionary.values)[ds.dict_ids[:n]]
    else:
        vals = ds.raw_values[:n]
    return jctx.probe_values(vals)


def _group_by(segment: ImmutableSegment, request: BrokerRequest,
              mask: np.ndarray, blk: IntermediateResultsBlock,
              jctx=None, dimrow=None) -> None:
    gcols = request.group_by.columns
    join = request.join if jctx is not None else None
    # MV keys expand the row space: one row per (doc, value) — and per
    # value combination when several keys are MV (reference cross-product
    # semantics, DefaultGroupByExecutor.aggregateGroupByMV). Scalar keys
    # and aggregations then index rows through row2doc.
    row2doc = np.nonzero(mask)[0]
    mv_lanes: Dict[int, np.ndarray] = {}
    for idx, c in enumerate(gcols):
        if join is not None and join.qualifies(c):
            continue            # dim-side keys are scalar by contract
        src = _mv_group_source(segment, c)
        if src is None:
            continue
        values, counts = _mv_entries(src[0], src[1], row2doc)
        rep = np.repeat(np.arange(len(row2doc)), counts)
        row2doc = row2doc[rep]
        for k in mv_lanes:
            mv_lanes[k] = mv_lanes[k][rep]
        mv_lanes[idx] = values
    # per-key-column unique coding (value domain, so plain columns,
    # no-dictionary columns and transform expressions all group uniformly)
    codes: List[np.ndarray] = []
    uniq_vals: List[np.ndarray] = []
    for idx, c in enumerate(gcols):
        lane = mv_lanes.get(idx)
        coded = None
        if lane is None and join is not None and join.qualifies(c):
            # dim-side group key: the matched dim row's code in the dim
            # column's sorted uniques (JoinContext.group_coding), where the
            # JAX module decodes the row values and sorts them: the same
            # groups (the mask guarantees every surviving row has a row)
            dcodes, duniq = jctx.group_coding(join.unqualify(c))
            coded = (duniq, dcodes[dimrow[row2doc]].astype(np.int64))
        elif lane is None:
            coded = _dict_rows(segment, c, row2doc)
        if coded is not None:
            present, inv = _unique_codes(coded[1], len(coded[0]))
            u = coded[0][present]
        else:
            if lane is None:
                lane = _group_value_rows(segment, c, row2doc)
            u, inv = np.unique(lane, return_inverse=True)
        uniq_vals.append(u)
        codes.append(inv.reshape(-1).astype(np.int64))
    key = np.zeros(len(row2doc), dtype=np.int64)
    for u, inv in zip(uniq_vals, codes):
        key = key * max(len(u), 1) + inv
    space = int(np.prod([max(len(u), 1) for u in uniq_vals],
                        dtype=np.int64))
    uniq_keys, inverse = _unique_codes(key, space)
    g = len(uniq_keys)

    # decode group values
    value_cols = []
    rem = uniq_keys.copy()
    for u in reversed(uniq_vals):
        value_cols.append(u[rem % max(len(u), 1)])
        rem //= max(len(u), 1)
    value_cols.reverse()
    group_keys = [tuple(_plain(vc[i]) for vc in value_cols) for i in range(g)]

    functions = make_functions(request.aggregations)
    per_fn: List[List] = []
    for f in functions:
        base = f.info.base
        if base == "COUNT" and (f.column == "*" or not f.info.is_mv):
            counts = np.zeros(g, dtype=np.int64)
            np.add.at(counts, inverse, 1)
            per_fn.append([int(c) for c in counts])
            continue
        # MV aggregation argument (SUMMV/COUNTMV/... or valuein(...)):
        # one contribution per (row, entry) — reference aggregateGroupByMV.
        # Non-suffixed aggregations over MV columns keep the engine-wide
        # entry-flattening semantics (the device kernels' source=="mv"
        # path does the same); only *MV over a single-value column is
        # rejected. COUNT stays row-count — COUNTMV is the entry count.
        src = _mv_group_source(segment, f.column)
        if src is None and f.info.is_mv:
            raise ValueError(
                f"{base}MV needs a multi-value column, got {f.column}")
        coded = None
        if src is not None:
            vals, ecounts = _mv_entries(src[0], src[1], row2doc)
            inv_f = np.repeat(inverse, ecounts)
        else:
            coded = _dict_rows(segment, f.column, row2doc)
            vals = coded[0][coded[1]] if coded is not None else \
                _group_value_rows(segment, f.column, row2doc)
            inv_f = inverse
        if base == "COUNT":              # COUNTMV: entries per group
            counts = np.zeros(g, dtype=np.int64)
            np.add.at(counts, inv_f, 1)
            per_fn.append([int(c) for c in counts])
            continue
        if base not in ("DISTINCTCOUNT", "DISTINCTCOUNTHLL", "FASTHLL",
                        "DISTINCTCOUNTRAWHLL"):
            vals = vals.astype(np.float64)   # distinct bases keep strings
        if base in ("SUM", "AVG"):
            sums = np.zeros(g)
            np.add.at(sums, inv_f, vals)
            if base == "SUM":
                per_fn.append([float(s) for s in sums])
            else:
                counts = np.zeros(g, dtype=np.int64)
                np.add.at(counts, inv_f, 1)
                per_fn.append([(float(s), int(c))
                               for s, c in zip(sums, counts)])
        elif base in ("MIN", "MAX", "MINMAXRANGE"):
            mins = np.full(g, np.inf)
            maxs = np.full(g, -np.inf)
            np.minimum.at(mins, inv_f, vals)
            np.maximum.at(maxs, inv_f, vals)
            if base == "MIN":
                per_fn.append([float(v) for v in mins])
            elif base == "MAX":
                per_fn.append([float(v) for v in maxs])
            else:
                per_fn.append([(float(a), float(b))
                               for a, b in zip(mins, maxs)])
        elif base == "DISTINCTCOUNT" and coded is not None:
            # the (group, dictId) pairs present, in group order
            card = len(coded[0])
            pairs, _ = _unique_codes(inv_f * card + coded[1], g * card)
            cuts = np.searchsorted(pairs // card, np.arange(g + 1))
            per_fn.append([set(coded[0][pairs[a:b] % card].tolist())
                           for a, b in zip(cuts[:-1], cuts[1:])])
        else:
            # set/map/sketch intermediates per group
            items: List = [None] * g
            for gi in range(g):
                sel = vals[inv_f == gi]
                if base == "DISTINCTCOUNT":
                    items[gi] = set(_plain(v) for v in np.unique(sel))
                elif base in ("DISTINCTCOUNTHLL", "FASTHLL", "DISTINCTCOUNTRAWHLL"):
                    if base == "FASTHLL" and _hll_derived(segment, f.column):
                        from pinot_tpu_torch.common.sketches import \
                            union_serialized_hlls
                        items[gi] = union_serialized_hlls(np.unique(sel))
                    else:
                        items[gi] = HyperLogLog.from_values(np.unique(sel))
                elif base == "PERCENTILE":
                    u, c = np.unique(sel, return_counts=True)
                    items[gi] = {_plain(x): int(y) for x, y in zip(u, c)}
                else:
                    u, c = np.unique(sel, return_counts=True)
                    items[gi] = TDigest.from_values(u, weights=c)
            per_fn.append(items)

    blk.group_map = {
        group_keys[i]: [per_fn[fi][i] for fi in range(len(functions))]
        for i in range(g)}


# ---------------------------------------------------------------------------
# Vector similarity (exact filtered top-k: the oracle twin of the device
# path's "vector" selection kind)
# ---------------------------------------------------------------------------


def _np_tree_sum(x: np.ndarray) -> np.ndarray:
    """Balanced pairwise f32 sum over the last (pow2) axis — the host
    half of the score exactness contract (kernels.vec_tree_sum): both
    sides run the SAME sequence of IEEE f32 adds, so scores agree
    bit-for-bit with the device kernel."""
    x = np.asarray(x, np.float32)
    while x.shape[-1] > 1:
        x = x[..., 0::2] + x[..., 1::2]
    return x[..., 0]


def _np_vector_scores(mat: np.ndarray, query, metric: str) -> np.ndarray:
    """float32 [n] similarity scores over pow2-dim-padded operands."""
    dim = mat.shape[1]
    dim_pad = 1
    while dim_pad < max(dim, 1):
        dim_pad *= 2
    m = np.zeros((len(mat), dim_pad), np.float32)
    m[:, :dim] = mat
    q = np.zeros(dim_pad, np.float32)
    q[:dim] = np.asarray(query, np.float32)
    dot = _np_tree_sum(m * q[None, :])
    if metric == "cosine":
        q_norm = np.float32(np.sqrt(_np_tree_sum(q * q)))
        if not q_norm > 0:
            raise ValueError("COSINE similarity needs a non-zero, finite "
                             "query vector")
        denom = np.sqrt(_np_tree_sum(m * m)).astype(np.float32) * q_norm
        with np.errstate(divide="ignore", invalid="ignore"):
            scores = (dot / denom).astype(np.float32)
        scores[~(denom > 0)] = -np.inf
        return scores
    return dot.astype(np.float32)


def _vector_topk(segment: ImmutableSegment, request: BrokerRequest,
                 mask: np.ndarray, blk: IntermediateResultsBlock) -> int:
    from pinot_tpu_torch.common.datatype import DataType
    from pinot_tpu_torch.common.request import VECTOR_RESULT_COLUMNS
    v = request.vector
    ds = segment.data_source(v.column)
    cm = ds.metadata
    if cm.data_type != DataType.VECTOR:
        raise ValueError(
            f"VECTOR_SIMILARITY over non-VECTOR column '{v.column}'")
    if len(v.query) != cm.vector_dimension:
        raise ValueError(
            f"query vector has {len(v.query)} dimensions; column "
            f"'{v.column}' stores {cm.vector_dimension}")
    # wire-arrived requests bypass the parser/planner guards, so the
    # host twin re-validates k and metric itself
    if v.k <= 0:
        raise ValueError(f"VECTOR_SIMILARITY k must be positive, "
                         f"got {v.k}")
    metric = v.metric.lower()
    if metric == "mips":
        metric = "dot"
    if metric not in ("cosine", "dot"):
        raise ValueError(f"unknown similarity metric '{v.metric}' "
                         "(COSINE | DOT | MIPS)")
    # ANN probe: nprobe>0 with a built IVF index narrows the candidate
    # mask to rows whose coarse cell is in the query's top-nprobe list.
    # The numpy twins in index/ivf.py select the SAME probe ids (same
    # tree sums, monotone-int32 keys, tie-breaking) as the device pred,
    # so host and device agree on the probed candidate set bit-exactly.
    # Segments without an index (and consuming tails) stay exact.
    nprobe = int(getattr(v, "nprobe", 0) or 0)
    if nprobe > 0 and getattr(ds, "ivf_centroids", None) is not None \
            and getattr(ds, "ivf_assignments", None) is not None:
        from pinot_tpu_torch.index import ivf as ivf_mod
        dim = cm.vector_dimension
        q = np.zeros(ivf_mod.pad_dim(dim), np.float32)
        q[:dim] = np.asarray(v.query, np.float32)
        q_norm = np.float32(np.sqrt(_np_tree_sum(q * q)))
        nprobe_eff = min(nprobe, ivf_mod.pad_centroids(
            int(ds.ivf_centroids.shape[0])))
        probed = ivf_mod.probe_mask_np(
            np.asarray(ds.ivf_assignments, np.int32),
            ds.host_operand("ivfc"), ds.host_operand("ivfv"),
            q, q_norm, metric, nprobe_eff)
        aligned = np.zeros(len(mask), bool)
        aligned[: len(probed)] = probed[: len(mask)]
        mask = mask & aligned
    # score ONLY the filter's candidates: per-row scores are independent
    # of which other rows are scored (the tree contract is per-row), so
    # this is bit-identical to scoring everything at a fraction of the
    # work on selective queries
    docids = np.nonzero(mask)[0]
    num_candidates = len(docids)
    s = _np_vector_scores(ds.vec_values[docids], v.query, metric)
    # rank: score desc, docid asc — lexsort's LAST key is primary, and
    # stability gives equal scores ascending docids (the device kernel's
    # top_k tie-break)
    order = np.lexsort((docids, -s))[: v.k]
    docids = docids[order]
    s = s[order]

    # consuming tail views report GLOBAL docids under the base segment
    # name, so frozen+tail merges are indistinguishable from a
    # whole-segment pass (same contract as the device finish)
    from pinot_tpu_torch.query.execution import vector_segment_identity
    name, base = vector_segment_identity(segment)

    user_cols = list(request.selection.columns) if request.selection else []
    decoded = {}
    for c in user_cols:
        cds = segment.data_source(c)
        ccm = cds.metadata
        if ccm.data_type == DataType.VECTOR:
            decoded[c] = [[float(x) for x in row]
                          for row in cds.vec_values[docids]]
        elif not ccm.has_dictionary:
            decoded[c] = cds.raw_values[docids]
        elif ccm.single_value:
            decoded[c] = cds.dictionary.values[cds.dict_ids[docids]]
        else:
            card = ccm.cardinality
            decoded[c] = [
                [_plain(cds.dictionary.get(i)) for i in row if i < card]
                for row in cds.mv_dict_ids[docids]]
    rows = []
    for r in range(len(docids)):
        rows.append(tuple(_plain(decoded[c][r]) for c in user_cols) +
                    (int(docids[r]) + base, name, float(s[r])))
    blk.selection_rows = rows
    blk.selection_columns = user_cols + list(VECTOR_RESULT_COLUMNS)
    blk.selection_display_cols = None
    return num_candidates


# ---------------------------------------------------------------------------
# Selection
# ---------------------------------------------------------------------------


def _selection(segment: ImmutableSegment, request: BrokerRequest,
               mask: np.ndarray, blk: IntermediateResultsBlock) -> None:
    from pinot_tpu_torch.query.plan import selection_columns
    sel = request.selection
    cols = selection_columns(segment, request)
    extras = [ob.column for ob in (sel.order_by or [])
              if ob.column not in cols]
    docids = np.nonzero(mask)[0]
    if sel.order_by:
        sort_keys = []
        for ob in reversed(sel.order_by):  # lexsort: last key is primary
            ds = segment.data_source(ob.column)
            cm = ds.metadata
            if getattr(ds, "vec_values", None) is not None:
                raise ValueError("order-by on VECTOR column (use "
                                 "VECTOR_SIMILARITY for ranked results)")
            if cm.has_dictionary and cm.single_value:
                k = ds.dict_ids[docids].astype(np.int64)
                if not getattr(ds.dictionary, "is_sorted", True):
                    # a consuming segment's arrival-order dictionary:
                    # order by the values' ranks, not by the ids (the
                    # JAX twin orders by the ids here, out of value order)
                    vals = np.asarray(ds.dictionary.values)
                    rank = np.empty(len(vals), np.int64)
                    rank[np.argsort(vals, kind="stable")] = \
                        np.arange(len(vals))
                    k = rank[k]
            elif not cm.has_dictionary:
                k = ds.raw_values[docids]
            else:
                raise ValueError("order-by on MV column")
            if k.dtype.kind == "O":
                # strings/bytes: rank-encode so DESC can negate
                _u, k = np.unique(k, return_inverse=True)
            sort_keys.append(-k if not ob.ascending else k)
        order = np.lexsort(sort_keys)
        docids = docids[order]
    docids = docids[: sel.offset + sel.size]

    rows = []
    decoded = {}
    display_n = len(cols)
    cols = cols + extras
    for c in cols:
        ds = segment.data_source(c)
        cm = ds.metadata
        if getattr(ds, "vec_values", None) is not None:
            decoded[c] = [[float(x) for x in row]
                          for row in ds.vec_values[docids]]
        elif not cm.has_dictionary:
            decoded[c] = ds.raw_values[docids]
        elif cm.single_value:
            decoded[c] = ds.dictionary.values[ds.dict_ids[docids]]
        else:
            card = cm.cardinality
            decoded[c] = [
                [_plain(ds.dictionary.get(i)) for i in row if i < card]
                for row in ds.mv_dict_ids[docids]]
    for r in range(len(docids)):
        rows.append(tuple(_plain(decoded[c][r]) for c in cols))
    blk.selection_rows = rows
    blk.selection_columns = cols
    blk.selection_display_cols = display_n


def _plain(v):
    if isinstance(v, np.generic):
        return v.item()
    if isinstance(v, np.ndarray):
        return v.tolist()
    return v
