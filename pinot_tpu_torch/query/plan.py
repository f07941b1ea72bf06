"""Per-segment plan maker.

Counterpart of pinot_tpu/query/plan.py for the port's slices so far:
resolves the filter tree against each column's sorted dictionary
host-side (so the card sees only integer compares and member bitsets),
picks the device aggregation strategy, builds the group-by spec, and
plans selections (LIMIT / ORDER BY) as the JAX planner does.

Supported here: filters over dictionary single-value and multi-value
columns (eq_id, neq_id, range_ids, in_ids, notin_ids, member), over
numeric raw columns (eq_raw, neq_raw, in_raw, notin_raw, range_raw) and
single-column expressions over a dictionary column (a member bitset over
the transformed dictionary); every aggregation the JAX planner runs on
its device: COUNT, SUM, AVG, MIN, MAX, MINMAXRANGE, DISTINCTCOUNT,
PERCENTILE and FASTHLL over single-value columns, DISTINCTCOUNTHLL /
DISTINCTCOUNTRAWHLL as device HLL registers, single-column expression
aggregations (the source column's histogram) and the MV aggregations
(the entry histogram, the entry min / max); GROUP BY over dictionary
single-value, multi-value ("mvids"), valuein ("mvin"), raw integer
("rawoff") and single-column expression keys with COUNT, SUM, AVG, MIN,
MAX and MINMAXRANGE; selections with the JAX planner's select specs
("limit", "order", "ordertk", "ordermk"); VECTOR_SIMILARITY top k
("vector", exact or with an IVF "ivf_probe" filter predicate); the
metadata, match-all and inverted-index / sorted-range COUNT fast paths.
Star-tree cubes are not used yet.

Refusals. UnsupportedOnDevice is raised exactly where the JAX planner
raises it (DISTINCTCOUNT / PERCENTILE in a group-by, an MV metric in a
group-by, MV expression aggregations such as COUNTMV(valuein(...)),
order keys over MV columns, k > MAX_SELECTION_K, ...) and
GroupsLimitExceeded where it does; the executor answers those segments
on the host twin (query/host_exec.py), as the JAX executor does.
NotPorted is raised for the requests the port has no path for yet
(join and window); nothing catches it.

Design change from the JAX planner, on purpose: it picks TPU-shaped
strategies (matrix-unit block compaction, adaptive min/max and histogram
scouts, the kmax escalation ladder) because scatter is slow on the TPU.
On Hopper, atomics into device memory are the natural primitive, so this
planner always emits the dense direct-keyed group spec (kmax = 0), with
`psums` for integer dictionaries and `csums` for raw / float columns, at
any g_pad up to the groups limit. The spec tuples keep the JAX grammar.
"""
from __future__ import annotations

import collections
import copy
import dataclasses
import re as _re
from typing import Dict, List, Optional, Tuple

import numpy as np

from pinot_tpu_torch.common import expression as expr_mod
from pinot_tpu_torch.common.datatype import DataType
from pinot_tpu_torch.common.request import AggregationInfo, BrokerRequest, \
    FilterOperator, FilterQueryTree, VECTOR_RESULT_COLUMNS
from pinot_tpu_torch.ops import kernels
from pinot_tpu_torch.query.aggregation import AggregationFunction, \
    make_functions
from pinot_tpu_torch.query.blocks import ExecutionStats, \
    IntermediateResultsBlock
from pinot_tpu_torch.segment.loader import ImmutableSegment

DEFAULT_NUM_GROUPS_LIMIT = 100_000     # parity: num.groups.limit
IN_LIST_MEMBER_THRESHOLD = 16          # small IN → compare list, else
                                       # member bitset
MAX_SELECTION_K = 1 << 16


class GroupsLimitExceeded(Exception):
    pass


class UnsupportedOnDevice(Exception):
    """The JAX planner refuses this shape too: the host twin answers it."""


class NotPorted(Exception):
    """A request the port has no path for yet (join, window). The
    executor does not catch it."""


# ---------------------------------------------------------------------------
# Filter resolution: FilterQueryTree → (kernel spec, params)
# ---------------------------------------------------------------------------

MATCH_ALL = ("match_all",)
EMPTY = ("empty",)


def resolve_filter(tree: Optional[FilterQueryTree], segment: ImmutableSegment
                   ) -> Tuple[tuple, List]:
    if tree is None:
        return MATCH_ALL, []
    params: List = []
    spec = _resolve(tree, segment, params)
    return spec, params


def _resolve(node: FilterQueryTree, segment: ImmutableSegment, params: List
             ) -> tuple:
    if node.operator in (FilterOperator.AND, FilterOperator.OR):
        is_and = node.operator == FilterOperator.AND
        children = []
        for c in node.children:
            sub_params: List = []
            spec = _resolve(c, segment, sub_params)
            if spec == EMPTY:
                if is_and:
                    return EMPTY
                continue
            if spec == MATCH_ALL:
                if not is_and:
                    return MATCH_ALL
                continue
            children.append((spec, sub_params))
        if not children:
            return MATCH_ALL if is_and else EMPTY
        if len(children) == 1:
            params.extend(children[0][1])
            return children[0][0]
        for _, p in children:
            params.extend(p)
        return ("and" if is_and else "or",
                tuple(spec for spec, _ in children))
    return _resolve_leaf(node, segment, params)


def _resolve_expr_leaf(node: FilterQueryTree, segment: ImmutableSegment,
                       params: List) -> tuple:
    """An expression filter → a member bitset over the transformed
    dictionary (the JAX planner's _resolve_expr_leaf): the transform runs
    once over the cardinality-sized value table on the host, and the card
    sees only K1's member gather."""
    expr = expr_mod.parse_expression(node.column)
    srcs = expr_mod.columns_of(expr)
    if len(srcs) != 1:
        raise UnsupportedOnDevice("multi-column expression filter")
    src = srcs[0]
    ds = segment.data_source(src)
    cm = ds.metadata
    if not (cm.has_dictionary and cm.single_value):
        raise UnsupportedOnDevice(
            f"expression over non-dictionary/MV column {src}")
    vals = np.asarray(ds.dictionary.values)
    tv = np.asarray(expr_mod.evaluate(expr, lambda c: vals),
                    dtype=np.float64)
    card = cm.cardinality
    card_pad = kernels.pow2_bucket(card + 1)
    member = np.zeros(card_pad, dtype=bool)
    member[:card] = _pred_over_values(node, tv)
    if not member.any():
        return EMPTY
    if member[:card].all():
        return MATCH_ALL
    params.append(member)
    return ("pred", "member", src, "sv", card_pad)


def _resolve_leaf(node: FilterQueryTree, segment: ImmutableSegment,
                  params: List) -> tuple:
    if expr_mod.is_expression(node.column):
        return _resolve_expr_leaf(node, segment, params)
    ds = segment.data_source(node.column)
    cm = ds.metadata
    if cm.data_type == DataType.VECTOR:
        # embeddings have no value order or equality a WHERE predicate
        # could use; similarity is the VECTOR_SIMILARITY clause
        raise ValueError(
            f"column '{node.column}' is a VECTOR column — WHERE "
            "predicates over embeddings are not supported")
    if not cm.has_dictionary:
        return _resolve_raw_leaf(node, ds, params)
    source = "sv" if cm.single_value else "mv"
    dictionary = ds.dictionary
    op = node.operator
    card = dictionary.cardinality
    card_pad = kernels.pow2_bucket(card + 1)

    if op == FilterOperator.EQUALITY:
        i = dictionary.index_of(node.values[0])
        if i < 0:
            return EMPTY
        params.append(np.int32(i))
        return ("pred", "eq_id", node.column, source, None)

    if op == FilterOperator.NOT:
        i = dictionary.index_of(node.values[0])
        if i < 0:
            return MATCH_ALL
        if source == "mv":
            # see NOT_IN: member vector keeps padding entries non-matching
            member = np.zeros(card_pad, dtype=bool)
            member[:card] = True
            member[i] = False
            params.append(member)
            return ("pred", "member", node.column, source, card_pad)
        params.append(np.int32(i))
        return ("pred", "neq_id", node.column, source, None)

    if op in (FilterOperator.IN, FilterOperator.NOT_IN):
        ids = [dictionary.index_of(v) for v in node.values]
        ids = sorted({i for i in ids if i >= 0})
        negate = op == FilterOperator.NOT_IN
        if not ids:
            return MATCH_ALL if negate else EMPTY
        if negate and source == "mv":
            # negated MV predicates go through a member vector: the padded
            # id compare would let padding entries (id == card) satisfy
            # the negation and match every doc
            member = np.zeros(card_pad, dtype=bool)
            member[:card] = True
            member[ids] = False
            params.append(member)
            return ("pred", "member", node.column, source, card_pad)
        if len(ids) <= IN_LIST_MEMBER_THRESHOLD:
            k = kernels.pow2_bucket(len(ids), floor=1)
            arr = np.full(k, -1, dtype=np.int32)
            arr[: len(ids)] = ids
            params.append(arr)
            return ("pred", "notin_ids" if negate else "in_ids",
                    node.column, source, k)
        member = np.zeros(card_pad, dtype=bool)
        member[ids] = True
        if negate:
            member = ~member
            member[card:] = False   # padding ids never match
        params.append(member)
        return ("pred", "member", node.column, source, card_pad)

    if op == FilterOperator.RANGE:
        lo, hi = dictionary.range_to_id_interval(
            node.lower, node.upper, node.lower_inclusive,
            node.upper_inclusive)
        if lo >= hi:
            return EMPTY
        if lo == 0 and hi >= card and source == "sv":
            return MATCH_ALL
        params.append(np.int32(lo))
        params.append(np.int32(hi))
        return ("pred", "range_ids", node.column, source, None)

    if op == FilterOperator.REGEXP_LIKE:
        # find() semantics over the dictionary → member bitset
        pattern = _re.compile(node.values[0])
        member = np.zeros(card_pad, dtype=bool)
        for i in range(card):
            if pattern.search(str(dictionary.get(i))):
                member[i] = True
        if not member.any():
            return EMPTY
        params.append(member)
        return ("pred", "member", node.column, source, card_pad)

    if op == FilterOperator.IS_NULL:
        return EMPTY      # no null vector yet: nothing is null
    if op == FilterOperator.IS_NOT_NULL:
        return MATCH_ALL

    raise UnsupportedOnDevice(f"filter operator {op}")


def _resolve_raw_leaf(node: FilterQueryTree, ds, params: List) -> tuple:
    """A predicate over a no-dictionary numeric column. Constants are cast
    to the lane's dtype (`cv`), and the kernel compares in that dtype."""
    dt = ds.metadata.data_type.np_dtype
    if dt.kind not in "iuf":
        raise UnsupportedOnDevice(
            f"filter over non-numeric raw column {node.column}")
    op = node.operator
    col = node.column

    def cv(v):
        return dt.type(float(v)) if dt.kind == "f" else dt.type(int(str(v)))

    if op == FilterOperator.EQUALITY:
        params.append(cv(node.values[0]))
        return ("pred", "eq_raw", col, "raw", None)
    if op == FilterOperator.NOT:
        params.append(cv(node.values[0]))
        return ("pred", "neq_raw", col, "raw", None)
    if op in (FilterOperator.IN, FilterOperator.NOT_IN):
        vals = sorted({cv(v) for v in node.values})
        k = kernels.pow2_bucket(len(vals), floor=1)
        arr = np.full(k, vals[0], dtype=dt)
        arr[: len(vals)] = vals
        params.append(arr)
        return ("pred", "notin_raw" if op == FilterOperator.NOT_IN
                else "in_raw", col, "raw", k)
    if op == FilterOperator.RANGE:
        info = np.iinfo(dt) if dt.kind in "iu" else np.finfo(dt)
        lo = cv(node.lower) if node.lower is not None else dt.type(info.min)
        hi = cv(node.upper) if node.upper is not None else dt.type(info.max)
        lo_inc = node.lower_inclusive if node.lower is not None else True
        hi_inc = node.upper_inclusive if node.upper is not None else True
        params.append(lo)
        params.append(hi)
        return ("pred", "range_raw", col, "raw", (lo_inc, hi_inc))
    raise UnsupportedOnDevice(f"raw-column filter operator {op}")


def _pred_over_values(node: FilterQueryTree, tv: np.ndarray) -> np.ndarray:
    """Apply a numeric predicate to an array of (transformed) values (the
    host twin's expression leaves)."""
    op = node.operator
    if op == FilterOperator.IS_NULL:
        return np.zeros(len(tv), dtype=bool)   # transforms never yield null
    if op == FilterOperator.IS_NOT_NULL:
        return np.ones(len(tv), dtype=bool)
    if op == FilterOperator.REGEXP_LIKE:
        pat = _re.compile(node.values[0])
        return np.array([bool(pat.search(str(v))) for v in tv])
    if op == FilterOperator.EQUALITY:
        return tv == float(node.values[0])
    if op == FilterOperator.NOT:
        return tv != float(node.values[0])
    if op == FilterOperator.IN:
        return np.isin(tv, [float(v) for v in node.values])
    if op == FilterOperator.NOT_IN:
        return ~np.isin(tv, [float(v) for v in node.values])
    if op == FilterOperator.RANGE:
        m = np.ones(len(tv), dtype=bool)
        if node.lower is not None:
            lo = float(node.lower)
            m &= (tv >= lo) if node.lower_inclusive else (tv > lo)
        if node.upper is not None:
            hi = float(node.upper)
            m &= (tv <= hi) if node.upper_inclusive else (tv < hi)
        return m
    raise UnsupportedOnDevice(f"expression filter operator {op}")


# ---------------------------------------------------------------------------
# Plan construction
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class SegmentPlan:
    segment: ImmutableSegment
    request: BrokerRequest
    # device kernel inputs (None when fast_path_result is set)
    filter_spec: Optional[tuple] = None
    params: Optional[List] = None
    agg_specs: Tuple = ()
    group_spec: Optional[tuple] = None
    # one member table per "mvin" group key, in key order (the JAX planner
    # appends them to params; here K1 takes params and K3 these)
    group_params: List = dataclasses.field(default_factory=list)
    # per group column: the transformed value table of an expression key
    # (decoded on the host), else None
    group_value_tables: Optional[tuple] = None
    select_spec: Optional[tuple] = None
    select_display: Optional[int] = None   # leading display columns
    needed_cols: Tuple[Tuple[str, str], ...] = ()   # (column, lane-kind)
    functions: List[AggregationFunction] = dataclasses.field(
        default_factory=list)
    fast_path_result: Optional[IntermediateResultsBlock] = None

    def execute(self) -> IntermediateResultsBlock:
        from pinot_tpu_torch.query import execution
        return execution.execute_segment_plan(self)


def preprocess_request(segments, request):
    """Rewrite FASTHLL(col) to the derived serialized-HLL column that the
    segments' metadata records (pinot_tpu/query/plan.py:
    preprocess_request; parity: BrokerRequestPreProcessor.preProcess).
    Raises when the segments disagree on that column.

    Returns the original request when nothing is rewritten, else a
    shallow copy with fresh AggregationInfo entries: the caller's request
    is never changed."""
    if not request.aggregations:
        return request
    rewrites: Dict[int, str] = {}
    for idx, agg in enumerate(request.aggregations):
        if agg.function_name.upper() != "FASTHLL":
            continue
        derived = None
        first_name = None
        for i, seg in enumerate(segments):
            md = getattr(seg, "metadata", None)
            d = md.get_derived_column(agg.column, "HLL") \
                if hasattr(md, "get_derived_column") else None
            if i == 0:
                derived, first_name = d, getattr(seg, "segment_name", "?")
            elif d != derived:
                raise RuntimeError(
                    "Found inconsistency HLL derived column name. In "
                    f"segment {first_name}: {derived}; in segment "
                    f"{getattr(seg, 'segment_name', '?')}: {d}")
        if derived is not None:
            rewrites[idx] = derived
    if not rewrites:
        return request
    out = copy.copy(request)
    out.aggregations = [
        AggregationInfo(a.function_name, rewrites[i]) if i in rewrites
        else a
        for i, a in enumerate(request.aggregations)]
    return out


class InstancePlanMaker:
    """Builds a SegmentPlan per segment for a BrokerRequest."""

    def __init__(self, num_groups_limit: int = DEFAULT_NUM_GROUPS_LIMIT):
        self.num_groups_limit = num_groups_limit
        # vector plans per segment since construction: "ivfProbe" (an
        # indexed segment probed) or "ivfExactFallback" (nprobe asked of
        # a segment without an index: an exact scan), the JAX planner's
        # path counts
        self.path_counts: collections.Counter = collections.Counter()

    def make_segment_plan(self, segment: ImmutableSegment,
                          request: BrokerRequest) -> SegmentPlan:
        if request.join is not None or request.windows:
            raise NotPorted("join / window queries")
        if not request.is_aggregation and not request.is_selection:
            raise NotPorted("query without aggregation or selection")
        plan = SegmentPlan(segment=segment, request=request)
        if request.is_aggregation:
            plan.functions = make_functions(request.aggregations)
        count_only = request.is_aggregation and not request.is_group_by \
            and all(f.info.base == "COUNT" and not f.info.is_mv
                    for f in plan.functions)

        # fast path: no filter, metadata-answerable aggregations
        if request.is_aggregation and not request.is_group_by and \
                request.filter is None and \
                self._try_metadata_fast_path(plan, segment):
            return plan

        filter_spec, params = resolve_filter(request.filter, segment)
        if filter_spec == EMPTY:
            plan.fast_path_result = _empty_block(plan, segment)
            return plan

        # fast path: COUNT(*) on a pure match-all filter
        if filter_spec == MATCH_ALL and count_only:
            blk = IntermediateResultsBlock(
                agg_intermediates=[segment.num_docs for _ in plan.functions])
            _fill_stats(blk, segment, segment.num_docs, 0, 0)
            plan.fast_path_result = blk
            return plan

        # fast path: COUNT(*) + single EQ/IN/range leaf answered by the
        # inverted index or the sorted ranges
        if count_only:
            cnt = self._try_inverted_count(segment, filter_spec, params)
            if cnt is not None:
                blk = IntermediateResultsBlock(
                    agg_intermediates=[cnt for _ in plan.functions])
                _fill_stats(blk, segment, cnt, 0, 0)
                plan.fast_path_result = blk
                return plan

        plan.filter_spec = filter_spec
        plan.params = params

        needed: Dict[Tuple[str, str], None] = {}
        _collect_filter_cols(filter_spec, needed)
        if request.is_group_by:
            self._plan_group_by(plan, segment, request, needed)
        elif request.is_aggregation:
            plan.agg_specs = tuple(
                _agg_device_spec(f, segment, needed)
                for f in plan.functions)
        if request.vector is not None:
            self._plan_vector(plan, segment, request, needed)
        elif request.is_selection:
            self._plan_selection(plan, segment, request, needed)
        plan.needed_cols = tuple(needed.keys())
        return plan

    # -- helpers -----------------------------------------------------------
    def _try_metadata_fast_path(self, plan: SegmentPlan,
                                segment: ImmutableSegment) -> bool:
        inters: List = []
        for f in plan.functions:
            base = f.info.base
            if base == "COUNT" and not f.info.is_mv:
                inters.append(segment.num_docs)
                continue
            if base in ("MIN", "MAX", "MINMAXRANGE") and \
                    segment.has_column(f.column):
                cm = segment.data_source(f.column).metadata
                if cm.has_dictionary and cm.single_value and \
                        cm.data_type.is_numeric:
                    mn, mx = float(cm.min_value), float(cm.max_value)
                    inters.append(mn if base == "MIN" else
                                  mx if base == "MAX" else (mn, mx))
                    continue
            return False
        blk = IntermediateResultsBlock(agg_intermediates=inters)
        _fill_stats(blk, segment, segment.num_docs, 0, 0)
        plan.fast_path_result = blk
        return True

    def _try_inverted_count(self, segment: ImmutableSegment, spec: tuple,
                            params: List) -> Optional[int]:
        if spec[0] != "pred":
            return None
        _, kind, col, source, _extra = spec
        if source != "sv":
            return None
        ds = segment.data_source(col)
        if ds.inverted_index is not None:
            if kind == "eq_id":
                return ds.inverted_index.count(int(params[0]))
            if kind == "in_ids":
                ids = [int(i) for i in np.asarray(params[0]) if i >= 0]
                return sum(ds.inverted_index.count(i) for i in ids)
            if kind == "range_ids":
                return ds.inverted_index.count_range(int(params[0]),
                                                     int(params[1]))
        if ds.sorted_ranges is not None:
            r = ds.sorted_ranges
            if kind == "eq_id":
                s, e = r[int(params[0])]
                return int(e - s)
            if kind == "range_ids":
                lo, hi = int(params[0]), int(params[1])
                return int(r[lo:hi, 1].sum() - r[lo:hi, 0].sum())
        return None

    def _plan_group_by(self, plan: SegmentPlan, segment: ImmutableSegment,
                       request: BrokerRequest, needed: Dict) -> None:
        """The JAX planner's group spec (pinot_tpu/query/plan.py:
        _plan_group_by) with kmax = 0: key kinds "ids", "mvids", "mvin"
        (its member table in plan.group_params) and "rawoff";
        expression keys group by the source column's ids and decode
        through their value table (plan.group_value_tables)."""
        gcols = []
        value_tables = []
        cards = []
        for c in request.group_by.columns:
            if expr_mod.is_expression(c):
                expr = expr_mod.parse_expression(c)
                srcs = expr_mod.columns_of(expr)
                if len(srcs) != 1:
                    raise UnsupportedOnDevice(
                        "multi-column expression group key")
                src = srcs[0]
                ds = segment.data_source(src)
                cm = ds.metadata
                vi = expr_mod.valuein_parts(expr)   # raises on malformed
                if vi is not None:
                    # an MV key restricted to the allowed values: K3
                    # drops the other entries through a member table
                    if not cm.has_dictionary or cm.single_value:
                        raise UnsupportedOnDevice(
                            "valuein group key needs a dict MV column")
                    card_pad = kernels.pow2_bucket(cm.cardinality + 1)
                    member = np.zeros(card_pad, dtype=bool)
                    ids = ds.dictionary.index_of_many(vi[1])
                    member[ids[ids >= 0]] = True
                    plan.group_params.append(member)
                    gcols.append((src, "mvin", 0, cm.cardinality))
                    value_tables.append(None)
                    cards.append(cm.cardinality)
                    needed[(src, "mv")] = None
                    continue
                if not (cm.has_dictionary and cm.single_value):
                    raise UnsupportedOnDevice(
                        f"expression group key over non-dict/MV column "
                        f"{src}")
                # group by the source column's ids; the transformed value
                # table decodes them on the host, where the collisions of
                # a non-injective transform merge
                vals = np.asarray(ds.dictionary.values)
                tv = np.asarray(expr_mod.evaluate(expr, lambda _: vals))
                gcols.append((src, "ids", 0, cm.cardinality))
                value_tables.append(tv)
                cards.append(cm.cardinality)
                needed[(src, "ids")] = None
                continue
            cm = segment.data_source(c).metadata
            if cm.has_dictionary:
                # MV: a doc adds once per entry combination (K3's walk)
                kind = "ids" if cm.single_value else "mvids"
                gcols.append((c, kind, 0, cm.cardinality))
                value_tables.append(None)
                cards.append(cm.cardinality)
                needed[(c, "ids" if cm.single_value else "mv")] = None
                continue
            if cm.single_value and cm.data_type.np_dtype.kind in "iu" and \
                    cm.min_value is not None and \
                    -2**31 <= int(cm.min_value) and \
                    int(cm.max_value) < 2**31:
                # no-dictionary integer key: value - min, bounded by the
                # metadata range; the groups limit below refuses a range
                # too wide for the table
                span = int(cm.max_value) - int(cm.min_value) + 1
                gcols.append((c, "rawoff", int(cm.min_value), span))
                value_tables.append(None)
                cards.append(span)
                needed[(c, "raw")] = None
                continue
            raise UnsupportedOnDevice(
                f"group-by on non-dictionary/MV column {c}")
        plan.group_value_tables = tuple(value_tables)
        g = int(np.prod(cards, dtype=np.int64))
        # per-query override (parity: the numGroupsLimit query option)
        limit = self.num_groups_limit
        opt = request.query_options.options.get("numGroupsLimit")
        if opt is not None:
            limit = int(opt)
        if g > limit:
            raise GroupsLimitExceeded(
                f"{g} potential groups > limit {limit}")
        strides = mixed_radix_strides(cards)
        g_pad = kernels.pow2_bucket(g)
        agg_specs = tuple(
            _agg_device_spec(f, segment, needed, for_group=True)
            for f in plan.functions)
        plan.group_spec = (tuple(gcols), strides, g_pad, agg_specs, 0)

    def _plan_vector(self, plan: SegmentPlan, segment: ImmutableSegment,
                     request: BrokerRequest, needed: Dict) -> None:
        """A ranked vector selection (pinot_tpu/query/plan.py:_plan_vector):
        the filtered top k of K8's scores, K6's "vector" kind. The WHERE
        filter is already plan.filter_spec, so it narrows the candidates
        before scores rank. With nprobe > 0 on a segment with an IVF
        index, an "ivf_probe" predicate (K9's probe list, tested in K1)
        ANDs in first, its (query, norm) params ahead of the filter's; a
        segment without an index is scanned exactly."""
        v = request.vector
        ds = segment.data_source(v.column)
        cm = ds.metadata
        if cm.data_type != DataType.VECTOR:
            raise ValueError(
                f"VECTOR_SIMILARITY over non-VECTOR column '{v.column}'")
        dim = cm.vector_dimension
        q_raw = np.asarray(v.query, dtype=np.float32)
        if q_raw.shape != (dim,):
            raise ValueError(
                f"query vector has {q_raw.shape[0] if q_raw.ndim == 1 else '?'}"
                f" dimensions; column '{v.column}' stores {dim}")
        if v.k <= 0:
            raise ValueError(f"VECTOR_SIMILARITY k must be positive, "
                             f"got {v.k}")
        metric = v.metric.lower()
        if metric == "mips":
            metric = "dot"
        if metric not in ("cosine", "dot"):
            raise ValueError(f"unknown similarity metric '{v.metric}' "
                             "(COSINE | DOT | MIPS)")
        gather = []
        for c in request.selection.columns if request.selection else []:
            ccm = segment.data_source(c).metadata
            if ccm.data_type == DataType.VECTOR:
                raise UnsupportedOnDevice(
                    f"selection of VECTOR column {c} (host path)")
            if not ccm.has_dictionary:
                if ccm.data_type.np_dtype.kind not in "iuf":
                    raise UnsupportedOnDevice(
                        f"selection over non-numeric raw column {c}")
                gather.append((c, "raw"))
                needed[(c, "raw")] = None
            elif ccm.single_value:
                gather.append((c, "sv"))
                needed[(c, "ids")] = None
            else:
                gather.append((c, "mv"))
                needed[(c, "mv")] = None
        dim_pad = kernels.pow2_bucket(max(dim, 1), floor=1)
        q = np.zeros(dim_pad, np.float32)
        q[:dim] = q_raw
        q_norm = np_vec_tree_norm(q)
        if metric == "cosine" and not q_norm > 0:
            raise ValueError("COSINE similarity needs a non-zero, finite "
                             "query vector")
        nprobe = int(getattr(v, "nprobe", 0) or 0)
        if nprobe > 0:
            if ds.ivf_centroids is not None and \
                    ds.ivf_assignments is not None:
                from pinot_tpu_torch.index import ivf as ivf_mod
                # K9 ranks at most the padded codebook
                nprobe_eff = min(nprobe,
                                 ivf_mod.pad_centroids(ds.ivf_centroids.shape[0]))
                pred = ("pred", "ivf_probe", v.column, "ivf",
                        (nprobe_eff, metric))
                plan.filter_spec = pred if plan.filter_spec == MATCH_ALL \
                    else ("and", (pred, plan.filter_spec))
                # the probe's operands precede the other filter params: it
                # is the first AND child in depth-first order
                plan.params = [q, np.float32(q_norm)] + plan.params
                for lane in ("ivfa", "ivfc", "ivfv"):
                    needed[(v.column, lane)] = None
                self.path_counts["ivfProbe"] += 1
            else:
                # nprobe asked of a segment without an index: an exact
                # scan keeps the answer right (ANN is best effort)
                self.path_counts["ivfExactFallback"] += 1
        k = min(kernels.pow2_bucket(v.k, floor=1), segment.padded_docs)
        plan.select_spec = ("vector", k, ((v.column, metric, dim_pad),),
                            tuple(gather))
        plan.select_display = None
        needed[(v.column, "vec")] = None
        # the selection's operands follow the filter's (depth-first order)
        plan.params.append(q)
        plan.params.append(np.float32(q_norm))

    def _plan_selection(self, plan: SegmentPlan, segment: ImmutableSegment,
                        request: BrokerRequest, needed: Dict) -> None:
        """The JAX planner's select spec (pinot_tpu/query/plan.py:
        _plan_selection), refusals included."""
        sel = request.selection
        cols = selection_columns(segment, request)
        plan.select_display = len(cols)
        # ORDER BY columns outside the display list ride along at the end
        # of each row so cross-segment merges can re-sort; the reducer
        # trims them via selection_display_cols
        extras = [ob.column for ob in (sel.order_by or [])
                  if ob.column not in cols]
        gather = []
        for c in cols + extras:
            ds = segment.data_source(c)
            if ds.metadata.data_type == DataType.VECTOR:
                raise UnsupportedOnDevice(
                    f"selection over VECTOR column {c}")
            if not ds.metadata.has_dictionary:
                if ds.metadata.data_type.np_dtype.kind not in "iuf":
                    raise UnsupportedOnDevice(
                        f"selection over non-numeric raw column {c}")
                gather.append((c, "raw"))
                needed[(c, "raw")] = None
            elif ds.metadata.single_value:
                gather.append((c, "sv"))
                needed[(c, "ids")] = None
            else:
                gather.append((c, "mv"))
                needed[(c, "mv")] = None
        k = sel.offset + sel.size
        if k > MAX_SELECTION_K:
            raise UnsupportedOnDevice(f"selection k={k} too large")
        k = min(kernels.pow2_bucket(k, floor=1), segment.padded_docs)
        if not sel.order_by:
            plan.select_spec = ("limit", k, (), tuple(gather))
            return
        order = []
        packed_bits = 0
        all_dict = True
        single_lane_raw = False
        for ob in sel.order_by:
            cm = segment.data_source(ob.column).metadata
            if cm.has_dictionary and cm.single_value:
                # sorted dictionary ⇒ id order == value order
                card_pad = cm.cardinality + 1
                packed_bits += int(np.ceil(np.log2(max(card_pad, 2))))
                order.append((ob.column, ob.ascending, card_pad, "sv"))
                needed[(ob.column, "ids")] = None
                continue
            if not cm.has_dictionary and cm.single_value and \
                    cm.data_type.is_numeric:
                all_dict = False
                single_lane_raw = cm.data_type.np_dtype.itemsize <= 4
                order.append((ob.column, ob.ascending, 0, "raw"))
                needed[(ob.column, "raw")] = None
                continue
            raise UnsupportedOnDevice(
                f"order-by on MV/non-numeric-raw column {ob.column}")
        if all_dict and packed_bits <= 30:
            # one packed int32 key
            plan.select_spec = ("order", k, tuple(order), tuple(gather))
        elif len(order) == 1 and single_lane_raw:
            # a single raw int32 / float32 key through the monotone map
            plan.select_spec = ("ordertk", k, tuple(order), tuple(gather))
        else:
            # per-column key words: wide packings, raw columns, mixes
            plan.select_spec = ("ordermk", k, tuple(order), tuple(gather))


def np_vec_tree_norm(q: np.ndarray) -> np.float32:
    """The f32 balanced-tree norm of a (power-of-two padded) query vector:
    the q_norm operand K8 and K9 divide by, with the same tree as the
    row norms (pinot_tpu/query/plan.py:np_vec_tree_norm)."""
    qf = np.asarray(q, np.float32)
    return np.float32(np.sqrt(kernels.vec_tree_sum_plain(qf * qf)))


def mixed_radix_strides(cards) -> tuple:
    """Strides for the mixed-radix group key (last column fastest)."""
    strides = []
    acc = 1
    for c in reversed(list(cards)):
        strides.append(acc)
        acc *= c
    return tuple(reversed(strides))


#: aggregation base → the JAX planner's device function name
_DEVICE_FNAMES = {
    "COUNT": "count", "SUM": "sum", "MIN": "min", "MAX": "max",
    "AVG": "avg", "MINMAXRANGE": "minmaxrange",
    "DISTINCTCOUNT": "distinctcount", "DISTINCTCOUNTHLL": "distinctcount",
    "FASTHLL": "distinctcount", "DISTINCTCOUNTRAWHLL": "distinctcount",
    "PERCENTILE": "percentile", "PERCENTILEEST": "percentile",
    "PERCENTILETDIGEST": "percentile"}


def _agg_device_spec(f: AggregationFunction, segment: ImmutableSegment,
                     needed: Dict, for_group: bool = False) -> tuple:
    """The JAX planner's device strategy for one aggregation
    (pinot_tpu/query/plan.py:_agg_device_spec), with the dense group
    table always taken (kmax = 0), and its refusals (UnsupportedOnDevice)
    in the same order."""
    base = f.info.base
    if base == "COUNT" and not f.info.is_mv:
        return ("count", "*", "none", None)
    col = f.column
    if expr_mod.is_expression(col):
        # K4 counts the source column's ids; the host evaluates the
        # transform over the dictionary and finishes from the counts
        if f.info.is_mv:
            raise UnsupportedOnDevice("MV expression aggregation")
        if for_group:
            raise UnsupportedOnDevice(
                "expression metric inside group-by (host path)")
        srcs = expr_mod.columns_of(col)
        if len(srcs) != 1:
            raise UnsupportedOnDevice("multi-column expression aggregation")
        src = srcs[0]
        cm = segment.data_source(src).metadata
        if not (cm.has_dictionary and cm.single_value):
            raise UnsupportedOnDevice(
                f"expression over non-dictionary/MV column {src}")
        card_pad = kernels.pow2_bucket(cm.cardinality + 1)
        needed[(src, "ids")] = None
        return ("hist", src, "sv", ("hist", card_pad))
    fname = "countmv" if base == "COUNT" else _DEVICE_FNAMES[base]
    cm = segment.data_source(col).metadata
    if cm.data_type == DataType.VECTOR:
        raise ValueError(
            f"aggregation {base} over VECTOR column '{col}' is not "
            "supported (use VECTOR_SIMILARITY for ranking)")
    if not cm.has_dictionary:
        if fname in ("percentile", "distinctcount"):
            raise UnsupportedOnDevice(f"{fname} over no-dictionary column")
        needed[(col, "raw")] = None
        if for_group and fname in ("sum", "avg"):
            return (fname, col, "raw", ("csums",))
        return (fname, col, "raw", None)
    card_pad = kernels.pow2_bucket(cm.cardinality + 1)
    if cm.single_value:
        is_int_dict = cm.data_type.np_dtype.kind in "iu"
        if for_group:
            if fname in ("distinctcount", "percentile"):
                raise UnsupportedOnDevice(
                    f"group-by with {fname} aggregation")
            if fname in ("sum", "avg"):
                if is_int_dict:
                    needed[(col, "parts")] = None
                    return (fname, col, "sv", ("psums", card_pad))
                needed[(col, "vlane")] = None
                return (fname, col, "sv", ("csums", card_pad))
            needed[(col, "ids")] = None
            return (fname, col, "sv", ("ids", card_pad))
        if base in ("DISTINCTCOUNTHLL", "DISTINCTCOUNTRAWHLL") and \
                not f.info.is_mv:
            # K4's histogram, then K7 scatter-maxes the present ids'
            # (register, rank) tables: the host sketch's registers.
            # FASTHLL keeps the histogram path, as in JAX.
            from pinot_tpu_torch.common.sketches import DEFAULT_LOG2M
            needed[(col, "ids")] = None
            needed[(col, "hllidx")] = None
            needed[(col, "hllrank")] = None
            return ("hll", col, "sv", ("hll", card_pad, 1 << DEFAULT_LOG2M))
        if fname in ("sum", "avg"):
            if is_int_dict:
                needed[(col, "parts")] = None
                return (fname, col, "sv", ("parts", card_pad))
            # float dictionaries: histogram · dictionary on the host (exact)
            # up to the JAX cap, else the decoded value lane's block sums
            if card_pad <= kernels.DENSE_CARD_LIMIT:
                needed[(col, "ids")] = None
                return (fname, col, "sv", ("hist", card_pad))
            needed[(col, "vlane")] = None
            return (fname, col, "sv", ("vlane", card_pad))
        needed[(col, "ids")] = None
        if fname in ("distinctcount", "percentile"):
            return (fname, col, "sv", ("hist", card_pad))
        return (fname, col, "sv", ("ids", card_pad))
    needed[(col, "mv")] = None
    if for_group:
        raise UnsupportedOnDevice("group-by over MV metric")
    return (fname, col, "mv", (card_pad, cm.cardinality))


def _collect_filter_cols(spec: tuple, needed: Dict) -> None:
    if spec[0] in ("and", "or"):
        for c in spec[1]:
            _collect_filter_cols(c, needed)
    elif spec[0] == "pred":
        _, _kind, col, source, _extra = spec
        if source == "ivf":
            # three lanes: assignments, padded codebook, validity
            for lane in ("ivfa", "ivfc", "ivfv"):
                needed[(col, lane)] = None
            return
        needed[(col, {"sv": "ids", "mv": "mv", "raw": "raw"}[source])] = None


def selection_columns(segment: ImmutableSegment, request: BrokerRequest
                      ) -> List[str]:
    """Expand SELECT * to the segment's physical columns."""
    cols = request.selection.columns
    if cols == ["*"]:
        return [c for c in segment.column_names if not c.startswith("$")]
    return list(cols)


def _empty_block(plan: SegmentPlan, segment: ImmutableSegment
                 ) -> IntermediateResultsBlock:
    blk = IntermediateResultsBlock()
    if plan.request.is_group_by:
        blk.group_map = {}
    elif plan.request.is_aggregation:
        blk.agg_intermediates = [None for _ in plan.functions]
    if plan.request.vector is not None:
        blk.selection_rows = []
        blk.selection_columns = list(plan.request.selection.columns) + \
            list(VECTOR_RESULT_COLUMNS)
    elif plan.request.is_selection:
        blk.selection_rows = []
        blk.selection_columns = selection_columns(segment, plan.request)
    _fill_stats(blk, segment, 0, 0, 0)
    return blk


def _fill_stats(blk: IntermediateResultsBlock, segment: ImmutableSegment,
                docs_scanned: int, entries_filter: int, entries_post: int
                ) -> None:
    blk.stats = ExecutionStats(
        num_docs_scanned=docs_scanned,
        num_entries_scanned_in_filter=entries_filter,
        num_entries_scanned_post_filter=entries_post,
        num_segments_processed=1,
        num_segments_matched=1 if docs_scanned else 0,
        total_docs=segment.num_docs)
