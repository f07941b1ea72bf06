"""Combine per-segment result blocks into one per-server block.

Parity: pinot-core/.../operator/CombineOperator.java (selection/agg merge via
CombineService) and CombineGroupByOperator.java:107-156 (concurrent group map
merge) + AggregationGroupByTrimmingService.java:44 (trim to
max(5·topN, 5000) when the merged map passes 4× that size).

Two merge engines live here:

- the ROW engine (the original, kept as the correctness oracle): dict
  inserts per group, python sorts keyed by `_order_key`/`_Rev` per row;
- the COLUMNAR engine: when every input block carries column blocks
  (zero-copy DataTable v3 decode) and the aggregation functions fold
  with numpy ufuncs, merges run as vectorized folds — group-by via
  factorize + bincount/ufunc.at, selection ordering via ONE stable
  `np.lexsort` over the concatenated key columns instead of a `_Rev`
  key object allocated per row per merge.

Any block or function the columnar engine cannot express falls back to
the row engine for the whole payload, so results are bit-identical by
construction (tests/test_transport_mux.py pins the parity).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from pinot_tpu_torch.common.datatable import _col_to_list
from pinot_tpu_torch.common.request import BrokerRequest, SelectionSort
from pinot_tpu_torch.query.aggregation import AggregationFunction, make_functions
from pinot_tpu_torch.query.blocks import IntermediateResultsBlock

# aggregation bases whose intermediates are scalars foldable with a
# numpy reduction (everything else — AVG pairs, sketches, sets,
# percentile maps — merges through the row engine's f.merge)
_NP_FOLD_BASES = ("COUNT", "SUM", "MIN", "MAX")


def trim_size_for(top_n: int) -> int:
    return max(5 * top_n, 5000)


def np_foldable(functions: List[AggregationFunction]) -> bool:
    return all(f.info.base in _NP_FOLD_BASES for f in functions)


def group_map_of(blk: IntermediateResultsBlock
                 ) -> Optional[Dict[Tuple, List]]:
    """The block's group map, materializing a columnar payload lazily
    (the fallback bridge from the columnar engine to the row engine)."""
    if blk.group_map is None and blk.group_cols is not None:
        key_cols, inter_cols = blk.group_cols
        keys = zip(*[_col_to_list(c) for c in key_cols]) if key_cols \
            else iter(())
        inters = zip(*[_col_to_list(c) for c in inter_cols])
        blk.group_map = {k: list(v) for k, v in zip(keys, inters)}
        blk.group_cols = None
    return blk.group_map


def selection_rows_of(blk: IntermediateResultsBlock
                      ) -> Optional[List[tuple]]:
    """Row tuples of a selection block, materializing columnar form."""
    if blk.selection_rows is None and blk.selection_cols is not None:
        cols = blk.selection_cols
        blk.selection_rows = list(zip(*[_col_to_list(c) for c in cols])) \
            if cols else []
        blk.selection_cols = None
    return blk.selection_rows


def combine_blocks(request: BrokerRequest,
                   blocks: List[IntermediateResultsBlock]
                   ) -> IntermediateResultsBlock:
    if not blocks:
        return IntermediateResultsBlock()
    out = blocks[0]
    functions = make_functions(request.aggregations) \
        if request.is_aggregation else []
    for blk in blocks[1:]:
        _merge_into(request, functions, out, blk)
        out.stats.merge(blk.stats)
        out.exceptions.extend(blk.exceptions)
    if request.is_group_by:
        t = trim_size_for(request.group_by.top_n)
        if out.group_cols is not None and _columnar_group(out) and \
                np_foldable(functions):
            inter_cols = out.group_cols[1]
            n_groups = len(inter_cols[0]) if inter_cols else 0
            if n_groups > 4 * t:
                out.group_cols = _trim_group_cols(out.group_cols,
                                                  functions, t)
        else:
            # object-tagged intermediates (AVG pairs, sketches) or a
            # single unfolded columnar block: the row engine trims
            gm = group_map_of(out)
            if gm is not None and len(gm) > 4 * t:
                out.group_map = trim_group_map(gm, functions, t)
    if request.is_selection and (out.selection_rows is not None or
                                 out.selection_cols is not None):
        _trim_selection(request, out)
    return out


def _merge_into(request: BrokerRequest,
                functions: List[AggregationFunction],
                a: IntermediateResultsBlock,
                b: IntermediateResultsBlock) -> None:
    if request.is_group_by:
        _merge_group_by(functions, a, b)
    elif request.is_aggregation:
        if a.agg_intermediates is None:
            a.agg_intermediates = b.agg_intermediates
        elif b.agg_intermediates is not None:
            a.agg_intermediates = [
                f.merge(x, y) for f, x, y in
                zip(functions, a.agg_intermediates, b.agg_intermediates)]
    if request.is_selection:
        _merge_selection(request, a, b)


# ---------------------------------------------------------------------------
# group-by merge
# ---------------------------------------------------------------------------

def _group_empty(blk: IntermediateResultsBlock) -> bool:
    if blk.group_cols is not None:
        inter = blk.group_cols[1]
        return not inter or len(inter[0]) == 0
    return blk.group_map is not None and not blk.group_map


def _merge_group_by(functions: List[AggregationFunction],
                    a: IntermediateResultsBlock,
                    b: IntermediateResultsBlock) -> None:
    if b.group_map is None and b.group_cols is None:
        return
    # empty-side shortcuts FIRST: a zero-row block decodes its columns
    # as untyped lists, and letting it into the type checks below would
    # demote the whole merge to the row engine for nothing
    if a.group_map is None and a.group_cols is None or _group_empty(a):
        a.group_map, a.group_cols = b.group_map, b.group_cols
        return
    if _group_empty(b):
        return
    if _columnar_group(a) and _columnar_group(b) and \
            np_foldable(functions):
        a.group_cols = merge_group_cols(functions,
                                        [a.group_cols, b.group_cols])
        return
    # row engine (oracle): materialize whichever side is columnar
    a_map = group_map_of(a)
    b_map = group_map_of(b)
    for key, inters in b_map.items():
        mine = a_map.get(key)
        if mine is None:
            a_map[key] = inters
        else:
            a_map[key] = [f.merge(x, y) for f, x, y in
                          zip(functions, mine, inters)]


def _columnar_group(blk: IntermediateResultsBlock) -> bool:
    """Columnar AND numerically foldable: every intermediate column is
    a numeric numpy array (an object-tagged column — AVG pairs, Nones —
    cannot fold, and an int column that could overflow an exact int64
    fold must use the row engine's unbounded python ints), and key
    columns are arrays (without NaN, which np.unique would collapse
    across groups while the dict oracle keeps NaN keys distinct) or
    all-string lists."""
    if blk.group_cols is None or blk.group_map is not None:
        return False
    key_cols, inter_cols = blk.group_cols
    for c in inter_cols:
        if not (isinstance(c, np.ndarray) and c.dtype.kind in "if"):
            return False
        if c.dtype.kind == "i" and not _int_fold_safe(c):
            return False
    for c in key_cols:
        if isinstance(c, np.ndarray):
            if c.dtype.kind == "f" and bool(np.isnan(c).any()):
                return False
        elif not _is_str_list(c):
            return False
    return True


def _int_fold_safe(col: np.ndarray) -> bool:
    """Can an exact int64 np.add fold of this column EVER wrap? Bound
    |sum| ≤ n·max|x| in python ints (no wrap in the check itself);
    conservative — epoch-nano magnitudes fall back to the row engine's
    unbounded python-int accumulation."""
    if len(col) == 0:
        return True
    mx = max(abs(int(col.max())), abs(int(col.min())))
    return mx * len(col) < (1 << 62)


def _is_str_list(col) -> bool:
    # EVERY element must be str: an object-tagged column exists exactly
    # because the encoder saw a non-homogeneous column, so a first-
    # element probe would let ('5',) and (5,) cross-type collapse under
    # np.unique's stringification (or crash on None) instead of falling
    # back to the row engine
    return isinstance(col, list) and all(type(v) is str for v in col)


def _concat_cols(parts: List[object]) -> object:
    """Concatenate one column's per-block pieces: ndarray-only parts
    stay an ndarray, anything else flattens to a python list."""
    if all(isinstance(p, np.ndarray) for p in parts):
        return np.concatenate(parts)
    merged: list = []
    for p in parts:
        merged.extend(_col_to_list(p))
    return merged


def _factorize(col) -> Tuple[np.ndarray, int]:
    """→ (codes ascending-by-value, cardinality) for one key column."""
    arr = col if isinstance(col, np.ndarray) else np.asarray(col)
    uniq, inv = np.unique(arr, return_inverse=True)
    return inv.astype(np.int64, copy=False), len(uniq)


def _group_ids(key_cols: List[object]) -> np.ndarray:
    """One int64 id per row, equal iff the full key tuple is equal.
    Pairwise combine + re-compact keeps intermediate products bounded
    by n_rows × cardinality — no overflow at any column count."""
    ids, _ = _factorize(key_cols[0])
    for col in key_cols[1:]:
        codes, card = _factorize(col)
        ids = ids * np.int64(card) + codes
        uniq, inv = np.unique(ids, return_inverse=True)
        ids = inv.astype(np.int64, copy=False)
    return ids


def merge_group_cols(functions: List[AggregationFunction],
                     block_cols: List[Tuple[List, List]]
                     ) -> Tuple[List, List]:
    """Vectorized group merge over columnar blocks: concatenate, group
    by first occurrence (dict-merge insertion-order parity), fold each
    intermediate column with its numpy reduction."""
    n_keys = len(block_cols[0][0])
    key_cols = [_concat_cols([bc[0][ki] for bc in block_cols])
                for ki in range(n_keys)]
    inter_cols = [np.concatenate([bc[1][fi] for bc in block_cols])
                  for fi in range(len(functions))]

    ids = _group_ids(key_cols)
    _uniq, first_idx, inv = np.unique(ids, return_index=True,
                                      return_inverse=True)
    # groups ordered by FIRST OCCURRENCE in the concatenation — exactly
    # the row engine's dict-merge insertion order
    order = np.argsort(first_idx, kind="stable")
    rank = np.empty(len(order), dtype=np.int64)
    rank[order] = np.arange(len(order), dtype=np.int64)
    gpos = rank[inv]
    n_groups = len(order)
    sel = first_idx[order]

    out_keys: List[object] = []
    for col in key_cols:
        if isinstance(col, np.ndarray):
            out_keys.append(col[sel])
        else:
            out_keys.append([col[i] for i in sel])
    out_inters: List[object] = []
    for f, col in zip(functions, inter_cols):
        base = f.info.base
        if base in ("COUNT", "SUM"):
            if col.dtype.kind == "i":
                # EXACT int64 accumulation — a float64 bincount would
                # silently round sums past 2^53 (epoch-nanos, big
                # counters) and break row-engine bit-parity
                folded = np.zeros(n_groups, dtype=col.dtype)
                np.add.at(folded, gpos, col)
            else:
                folded = np.bincount(gpos, weights=col,
                                     minlength=n_groups)
            out_inters.append(folded)
        else:
            ufunc = np.minimum if base == "MIN" else np.maximum
            if col.dtype.kind == "i":
                info = np.iinfo(col.dtype)
                init = info.max if base == "MIN" else info.min
            else:
                init = np.inf if base == "MIN" else -np.inf
            folded = np.full(n_groups, init, dtype=col.dtype)
            ufunc.at(folded, gpos, col)
            out_inters.append(folded)
    return out_keys, out_inters


def _trim_group_cols(group_cols: Tuple[List, List],
                     functions: List[AggregationFunction],
                     trim_size: int) -> Tuple[List, List]:
    """Columnar trim: union of per-function top-`trim_size` groups
    (value desc, first-occurrence stable), kept in group order."""
    key_cols, inter_cols = group_cols
    n = len(inter_cols[0])
    keep = np.zeros(n, dtype=bool)
    for f, col in zip(functions, inter_cols):
        top = np.argsort(sortable_desc_key(f, col),
                         kind="stable")[:trim_size]
        keep[top] = True
    idx = np.flatnonzero(keep)
    kept_keys = [c[idx] if isinstance(c, np.ndarray)
                 else [c[i] for i in idx] for c in key_cols]
    kept_inters = [c[idx] for c in inter_cols]
    return kept_keys, kept_inters


def trim_group_map(group_map: Dict[Tuple, List],
                   functions: List[AggregationFunction],
                   trim_size: int) -> Dict[Tuple, List]:
    """Keep the union of per-function top-`trim_size` groups (value desc).

    Parity: AggregationGroupByTrimmingService sorts per function and keeps
    the heads, so a group surviving under ANY function survives the trim.
    """
    keep = set()
    keys = list(group_map.keys())
    for fi, f in enumerate(functions):
        scored = sorted(
            keys, key=lambda k: f.sortable_final(group_map[k][fi]),
            reverse=True)
        keep.update(scored[:trim_size])
    return {k: group_map[k] for k in keep}


# ---------------------------------------------------------------------------
# selection merge
# ---------------------------------------------------------------------------

def _selection_empty(blk: IntermediateResultsBlock) -> bool:
    if blk.selection_cols is not None:
        cols = blk.selection_cols
        return not cols or len(cols[0]) == 0
    return blk.selection_rows is not None and not blk.selection_rows


def _merge_selection(request: BrokerRequest,
                     a: IntermediateResultsBlock,
                     b: IntermediateResultsBlock) -> None:
    if b.selection_rows is None and b.selection_cols is None:
        return
    # adopt-and-skip shortcuts: a zero-row block's columns decode as
    # untyped empty lists, which must not demote the lexsort engine
    if (a.selection_rows is None and a.selection_cols is None) or \
            (_selection_empty(a) and not _selection_empty(b)):
        a.selection_rows = b.selection_rows
        a.selection_cols = b.selection_cols
        a.selection_columns = b.selection_columns
        a.selection_display_cols = b.selection_display_cols
        return
    if _selection_empty(b):
        return
    if a.selection_cols is not None and b.selection_cols is not None and \
            _lexsortable(request, a.selection_columns, a.selection_cols):
        a.selection_cols = merge_selection_cols(
            request, a.selection_columns,
            [a.selection_cols, b.selection_cols])
        return
    rows_b = selection_rows_of(b)
    if rows_b:
        a.selection_rows = merge_selection_rows(
            request, a.selection_columns, selection_rows_of(a), rows_b)
        a.selection_cols = None


def _sort_spec(request: BrokerRequest, columns: List[str]
               ) -> List[Tuple[int, bool]]:
    """[(column index, ascending)] in significance order, covering both
    ORDER BY and the vector-similarity merge order."""
    if request.vector is not None:
        return [(columns.index("$score"), False),
                (columns.index("$segmentName"), True),
                (columns.index("$docId"), True)]
    sel = request.selection
    idx = {c: i for i, c in enumerate(columns)}
    return [(idx[ob.column], ob.ascending) for ob in sel.order_by]


def _lexsortable(request: BrokerRequest, columns: Optional[List[str]],
                 cols: List[object]) -> bool:
    """Every merge-order key column must be a numeric array or a string
    list for the lexsort engine; anything else → row engine."""
    if columns is None:
        return False
    try:
        spec = _sort_spec(request, columns)
    except (ValueError, KeyError):
        return False
    for ci, _asc in spec:
        col = cols[ci]
        if not (isinstance(col, np.ndarray) and col.dtype.kind in "if"
                or _is_str_list(col)):
            return False
    return True


def _desc_key(col: np.ndarray) -> np.ndarray:
    """Ascending sort key that orders `col` DESCENDING, exactly: `~x`
    (= -x-1) is a monotone-decreasing int map with no overflow at
    INT64_MIN, and no float round-trip that would rank distinct int64
    values past 2^53 as ties."""
    if col.dtype.kind == "i":
        return ~col
    return -col


def sortable_desc_key(f: AggregationFunction,
                      col: np.ndarray) -> np.ndarray:
    """Descending group-ranking key that reproduces the row engine's
    `sortable_final` semantics EXACTLY: COUNT finals are python ints
    (exact comparisons — `~x`, overflow-free), everything else ranks by
    its float final, so ties land precisely where the oracle ties."""
    if f.info.base == "COUNT" and col.dtype.kind == "i":
        return ~col
    return -col.astype(np.float64, copy=False)


def _lexsort_keys(cols: List[object],
                  spec: List[Tuple[int, bool]]) -> List[np.ndarray]:
    """np.lexsort keys (least-significant first, per its contract)."""
    keys: List[np.ndarray] = []
    for ci, asc in reversed(spec):
        col = cols[ci]
        if isinstance(col, np.ndarray):
            keys.append(col if asc else _desc_key(col))
        else:
            codes, _card = _factorize(col)
            keys.append(codes if asc else ~codes)
    return keys


def merge_selection_cols(request: BrokerRequest, columns: List[str],
                         block_cols: List[List[object]]
                         ) -> List[object]:
    """Columnar selection merge: concatenate, ONE stable np.lexsort
    over the order-by key columns, slice the top offset+size."""
    sel = request.selection
    limit = sel.offset + sel.size
    n_cols = len(block_cols[0])
    cols: List[object] = []
    for ci in range(n_cols):
        cols.append(_concat_cols([bc[ci] for bc in block_cols]))
    spec = _sort_spec(request, columns)
    if spec:
        idx = np.lexsort(_lexsort_keys(cols, spec))[:limit]
        cols = [c[idx] if isinstance(c, np.ndarray)
                else [c[i] for i in idx] for c in cols]
    else:
        cols = [c[:limit] for c in cols]
    return cols


def vector_order_key(columns: List[str]):
    """Merge order for vector-similarity rows: score desc, then
    (segment, docId) asc — total and deterministic, so every merge
    topology (frozen+tail pair, per-server combine, broker reduce)
    produces the same top-k as one global pass."""
    si = columns.index("$score")
    ni = columns.index("$segmentName")
    di = columns.index("$docId")

    def key(row: tuple):
        return (-row[si], row[ni], row[di])

    return key


def merge_selection_rows(request: BrokerRequest, columns: List[str],
                         rows_a: List[tuple], rows_b: List[tuple]
                         ) -> List[tuple]:
    sel = request.selection
    limit = sel.offset + sel.size
    merged = list(rows_a) + list(rows_b)
    if request.vector is not None:
        merged.sort(key=vector_order_key(columns))
    elif sel.order_by:
        merged.sort(key=_order_key(sel.order_by, columns))
    return merged[:limit]


def _order_key(order_by: List[SelectionSort], columns: List[str]):
    idx = {c: i for i, c in enumerate(columns)}

    def key(row: tuple):
        parts = []
        for ob in order_by:
            v = row[idx[ob.column]]
            parts.append(_Rev(v) if not ob.ascending else v)
        return tuple(parts)

    return key


class _Rev:
    """Reverse-order wrapper for mixed-type sort keys."""
    __slots__ = ("v",)

    def __init__(self, v):
        self.v = v

    def __lt__(self, other):
        return other.v < self.v

    def __eq__(self, other):
        return other.v == self.v


def _trim_selection(request: BrokerRequest,
                    out: IntermediateResultsBlock) -> None:
    sel = request.selection
    limit = sel.offset + sel.size
    if out.selection_cols is not None:
        if _lexsortable(request, out.selection_columns,
                        out.selection_cols):
            out.selection_cols = merge_selection_cols(
                request, out.selection_columns, [out.selection_cols])
            return
        selection_rows_of(out)        # fall through to the row engine
    rows = out.selection_rows
    if not rows:
        out.selection_rows = []
        return
    if request.vector is not None:
        rows = sorted(rows, key=vector_order_key(out.selection_columns))
    elif sel.order_by:
        rows = sorted(rows, key=_order_key(sel.order_by,
                                           out.selection_columns))
    out.selection_rows = rows[:limit]
