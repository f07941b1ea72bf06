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
metadata, match-all and inverted-index / sorted-range COUNT fast paths;
stage 2 of a join (a JoinContext attached as request._join_ctx, query/
stages/join.py): the join match ANDs into K1 as a member leaf (a
dictionary fact key) or a join_raw leaf (a raw one), and dim-qualified
group keys plan as "jcode" / "jraw" K3 keys; a covering star-tree cube
(startree/executor.py) as the JAX planner's fast path, after the metadata
one (pinot_tpu/query/plan.py:539-549).

Refusals. UnsupportedOnDevice is raised exactly where the JAX planner
raises it (DISTINCTCOUNT / PERCENTILE in a group-by, an MV metric in a
group-by, MV expression aggregations such as COUNTMV(valuein(...)),
order keys over MV columns, k > MAX_SELECTION_K, ...) and
GroupsLimitExceeded where it does; the executor answers those segments
on the host twin (query/host_exec.py), as the JAX executor does.
NotPorted is raised for a request with neither aggregations nor a
selection; nothing catches it.

Group-by strategy, as the JAX planner's: with `allow_group_compaction`
(the default) a filtered group-by plans kmax = initial_group_kmax(padded)
and the executor drives it through drive_group_execution: a min / max
scout of each dictionary key (K1 + K5), where it pays a histogram scout
(K4) for the rank remap, then the remapped ("idoff" / "idrank") spec over
K14 block_compact and K15 slot_tables (K16 rank_slots for the ranked
layout past DENSE_G_LIMIT, K3 for the sorted rung), up the kmax ladder
while a block overflows; keys the scout cannot narrow (raw, MV, join)
go to the compacted kernels and the ladder straight away.
`allow_group_compaction=False`, and every unfiltered group-by, plan
kmax = 0: K3's dense direct-keyed table. The port's aggregation
strategies in a group spec are the JAX planner's under compaction
(`psums` for integer dictionaries, `csums` for raw and float columns)
whatever the spec: K3 takes them at any g_pad up to the groups limit,
where the JAX planner's uncompacted route falls back to its scatter
strategy ("vals") past its dense limits.
"""
from __future__ import annotations

import collections
import copy
import dataclasses
import re as _re
import threading
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
from pinot_tpu_torch.startree.executor import try_star_tree_execute

DEFAULT_NUM_GROUPS_LIMIT = 100_000     # parity: num.groups.limit
IN_LIST_MEMBER_THRESHOLD = 16          # small IN → compare list, else
                                       # member bitset
MAX_SELECTION_K = 1 << 16


class GroupsLimitExceeded(Exception):
    pass


class UnsupportedOnDevice(Exception):
    """The JAX planner refuses this shape too: the host twin answers it."""


class NotPorted(Exception):
    """A request or source the port has no path for yet (a request with
    neither aggregations nor a selection, an exchange source outside
    this process, the TCP stream connector). The executor does not catch
    it."""


# ---------------------------------------------------------------------------
# Filter resolution: FilterQueryTree → (kernel spec, params)
# ---------------------------------------------------------------------------

MATCH_ALL = ("match_all",)
EMPTY = ("empty",)

# -- upsert validDocIds masking (pinot_tpu/query/plan.py:60-96) ---------------
# A segment of an upsert table carries a ValidDocIds bitmap
# (realtime/upsert.py); its superseded rows are masked on every result
# path. On the card the mask is one more K1 leaf over the segment's uint8
# liveness lane ("$validDocIds.vdoc", loader.device_valid_lane), so every
# kernel after K1 sees only live rows.

VALID_DOC_COLUMN = "$validDocIds"
VALID_DOC_PRED = ("pred", "vdoc", VALID_DOC_COLUMN, "vdoc", None)


def upsert_mask_active(segment) -> bool:
    """True when the segment has superseded rows to mask. A bitmap with
    no invalidation plans without the leaf, and keeps the fast paths."""
    vd = getattr(segment, "valid_doc_ids", None)
    return vd is not None and vd.num_invalid > 0


def has_valid_doc_mask(spec) -> bool:
    if spec == VALID_DOC_PRED:
        return True
    return spec is not None and spec[0] == "and" and \
        VALID_DOC_PRED in spec[1]


def with_valid_doc_mask(spec):
    """The filter spec ANDed with the validDocIds leaf. The leaf takes no
    params, so the depth-first param order of the tree is unchanged."""
    if spec == EMPTY or has_valid_doc_mask(spec):
        return spec
    if spec is None or spec == MATCH_ALL:
        return VALID_DOC_PRED
    return ("and", (VALID_DOC_PRED, spec))


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
# Join resolution (stage 2 of the multi-stage engine,
# pinot_tpu/query/plan.py:349-405)
#
# The dim side arrives as a JoinContext (query/stages/join.py): the
# exchanged, already dim-filtered key / column arrays. A dictionary fact
# key resolves on the host in O(cardinality): the join match becomes a
# K1 member leaf over the fact key's dictIds, each dim group key a
# "jcode" code table. A raw fact key probes on the card: K1's "join_raw"
# leaf and K3's "jraw" key read the dim keys sorted once by K12 (the
# JoinContext's SortedKeys). Either way the match ANDs into the filter
# ahead of the upsert vdoc lane's plan, so a dead row never joins.
# ---------------------------------------------------------------------------


def _join_key_source(jctx, segment: ImmutableSegment):
    """-> ("sv"|"raw", DataSource) for the fact key column, with the
    integer-key contract enforced (typed StageCompileError)."""
    from pinot_tpu_torch.query.stages.errors import StageCompileError
    if not segment.has_column(jctx.fact_key):
        raise StageCompileError(
            f"join key column '{jctx.fact_key}' does not exist on the "
            "fact table")
    ds = segment.data_source(jctx.fact_key)
    cm = ds.metadata
    if not cm.single_value or cm.data_type.np_dtype.kind not in "iu":
        raise StageCompileError(
            f"join keys must be single-value INTEGER columns; fact key "
            f"'{jctx.fact_key}' is {cm.data_type.name}"
            f"{'' if cm.single_value else ' (multi-value)'}")
    return ("sv" if cm.has_dictionary else "raw"), ds


def _resolve_join_pred(jctx, segment: ImmutableSegment):
    """(filter spec, params) for the join-match predicate: a member leaf
    over the fact key's dictIds, or a join_raw leaf whose one param is
    the JoinContext's SortedKeys in the fact key's dtype."""
    if jctx.empty:
        return EMPTY, []
    source, ds = _join_key_source(jctx, segment)
    cm = ds.metadata
    if source == "sv":
        member = jctx.member_for(np.asarray(ds.dictionary.values))
        if not member.any():
            return EMPTY, []
        card_pad = kernels.pow2_bucket(cm.cardinality + 1)
        memb = np.zeros(card_pad, dtype=bool)
        memb[: cm.cardinality] = member
        return ("pred", "member", jctx.fact_key, "sv", card_pad), [memb]
    keys = jctx.sorted_keys(cm.data_type.np_dtype)
    if keys is None:
        # no dim key is representable in the fact dtype: nothing can
        # match (the raw twin of the all-False member vector above)
        return EMPTY, []
    return ("pred", "join_raw", jctx.fact_key, "raw",
            len(keys.keys)), [keys]


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


def batch_signature(plan: SegmentPlan) -> Optional[tuple]:
    """The compiled-spec identity under which plans for one segment share
    a batched launch (ops/kernels.py:run_segment_kernel_batched), or None
    when the plan does not batch (pinot_tpu/query/plan.py:
    batch_signature): fast paths never reach the card, and group-by plans
    run one by one. Plans with equal signatures run the same kernels and
    differ only in their params, a raw-key join's sorted dim side among
    them (the batched K1 takes the join_raw leaf; Dp is in the spec)."""
    if plan.fast_path_result is not None or plan.group_spec is not None:
        return None
    return (plan.segment.padded_docs, plan.filter_spec,
            tuple(plan.agg_specs or ()), plan.select_spec,
            tuple(plan.needed_cols))


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

    def __init__(self, num_groups_limit: int = DEFAULT_NUM_GROUPS_LIMIT,
                 allow_group_compaction: bool = True):
        self.num_groups_limit = num_groups_limit
        self.allow_group_compaction = allow_group_compaction
        # vector plans per segment since construction: "ivfProbe" (an
        # indexed segment probed) or "ivfExactFallback" (nprobe asked of
        # a segment without an index: an exact scan), the JAX planner's
        # path counts (a lock: the server's workers plan concurrently)
        self.path_counts: collections.Counter = collections.Counter()
        self._count_lock = threading.Lock()

    def _count(self, path: str) -> None:
        with self._count_lock:
            self.path_counts[path] += 1

    def make_segment_plan(self, segment: ImmutableSegment,
                          request: BrokerRequest) -> SegmentPlan:
        if not request.is_aggregation and not request.is_selection:
            raise NotPorted("query without aggregation or selection")
        if getattr(segment, "is_mutable", False):
            # arrival-order (unsorted) dictionaries break the sorted-id
            # predicates: a consuming segment's rows go to the host twin
            # (its frozen prefix is an ImmutableSegment and plans here)
            raise UnsupportedOnDevice("mutable segment")
        plan = SegmentPlan(segment=segment, request=request)
        if request.is_aggregation:
            plan.functions = make_functions(request.aggregations)
        # stage-2 join context (query/stages/join.py, attached to the
        # request copy): the probe fuses into the filter, so every
        # whole-segment shortcut below is off (they would count unjoined
        # rows), as are they for a masked segment (metadata counts and
        # inverted-index counts include superseded rows)
        jctx = getattr(request, "_join_ctx", None)
        masked = upsert_mask_active(segment)
        no_fast = masked or jctx is not None
        count_only = request.is_aggregation and not request.is_group_by \
            and not no_fast and all(f.info.base == "COUNT" and
                                    not f.info.is_mv for f in plan.functions)

        # fast path: no filter, metadata-answerable aggregations
        if request.is_aggregation and not request.is_group_by and \
                request.filter is None and not no_fast and \
                self._try_metadata_fast_path(plan, segment):
            return plan

        # star-tree: a covering pre-aggregated cube answers the query in
        # O(groups) host work (startree/executor.py). This hook serves the
        # stacked path, which plans directly: its fast path sends the query
        # to the per-segment executor, which checked the cube already
        if request.is_aggregation and not request.is_selection and \
                not no_fast and getattr(segment, "star_trees", None):
            blk = try_star_tree_execute(segment, request)
            if blk is not None:
                plan.fast_path_result = blk
                return plan

        filter_spec, params = resolve_filter(request.filter, segment)
        if jctx is not None and filter_spec != EMPTY:
            # the join-match predicate ANDs in FIRST (its params precede
            # the original tree's in depth-first order)
            jspec, jparams = _resolve_join_pred(jctx, segment)
            if jspec == EMPTY:
                filter_spec = EMPTY
            elif jspec != MATCH_ALL:
                params = jparams + params
                filter_spec = jspec if filter_spec == MATCH_ALL else \
                    ("and", (jspec, filter_spec))
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

        if masked:
            filter_spec = with_valid_doc_mask(filter_spec)
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
        _plan_group_by), kmax > 0 for a filtered one under compaction:
        key kinds "ids", "mvids", "mvin"
        (its member table in plan.group_params), "rawoff", and a join's
        dim-qualified keys, "jcode" (its code table in plan.group_params)
        or "jraw" (its SortedKeys with codes there); expression and join
        keys decode through their value table (plan.group_value_tables)."""
        gcols = []
        value_tables = []
        cards = []
        jctx = getattr(request, "_join_ctx", None)
        for c in request.group_by.columns:
            if jctx is not None and request.join is not None and \
                    request.join.qualifies(c):
                # dim-side group key: the fact key lane group-codes
                # through the join translation (a jcode gather table for
                # a dictionary key, a jraw probe for a raw one); decode
                # goes through the dim value table
                dcol = request.join.unqualify(c)
                _codes, uniq = jctx.group_coding(dcol)
                source, ds = _join_key_source(jctx, segment)
                n = len(uniq)
                if source == "sv":
                    cm = ds.metadata
                    card_pad = kernels.pow2_bucket(cm.cardinality + 1)
                    plan.group_params.append(jctx.code_table_for(
                        np.asarray(ds.dictionary.values), dcol, card_pad))
                    gcols.append((jctx.fact_key, "jcode", 0, n))
                    needed[(jctx.fact_key, "ids")] = None
                else:
                    plan.group_params.append(jctx.sorted_keys(
                        ds.metadata.data_type.np_dtype, dcol))
                    gcols.append((jctx.fact_key, "jraw", 0, n))
                    needed[(jctx.fact_key, "raw")] = None
                value_tables.append(uniq)
                cards.append(n)
                continue
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
        # compaction for filtered group-bys: start at ~0.8% of the
        # segment; the executor escalates on the overflow flag
        kmax = 0
        if self.allow_group_compaction and plan.filter_spec is not None \
                and plan.filter_spec != MATCH_ALL:
            kmax = initial_group_kmax(segment.padded_docs)
        agg_specs = tuple(
            _agg_device_spec(f, segment, needed, for_group=True)
            for f in plan.functions)
        plan.group_spec = (tuple(gcols), strides, g_pad, agg_specs, kmax)

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
                self._count("ivfProbe")
            else:
                # nprobe asked of a segment without an index: an exact
                # scan keeps the answer right (ANN is best effort)
                self._count("ivfExactFallback")
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


# ---------------------------------------------------------------------------
# The adaptive compacted group-by (pinot_tpu/query/plan.py:990-1274)
# ---------------------------------------------------------------------------

#: the hist scout and rank remap run only when every group column's
#: card_pad fits this (the JAX default of PINOT_TPU_RANK_HIST_CARD)
RANK_HIST_CARD_LIMIT = 512
#: within the dense regime the hist rung fires only when every column's
#: card_pad is at most this ... (PINOT_TPU_DENSE_RANK_HIST_CARD)
DENSE_RANK_HIST_CARD = 128
#: ... and the span key space exceeds this (PINOT_TPU_DENSE_RANK_HIST_G)
DENSE_RANK_HIST_G = 2048


def initial_group_kmax(padded: int) -> int:
    """The first rung: ~0.8% of the segment (r = 64 slots a 8192-row
    block), at least 1024 rows."""
    return min(kernels.pow2_bucket(max(padded // 128, 1024)), padded)


def set_group_kmax(group_spec: tuple, padded: int) -> tuple:
    """kmax re-derived for another padded size (a plan made against one
    segment, run over lanes of another)."""
    gcols, strides, g_pad, agg_specs, kmax = group_spec
    if not kmax:
        return group_spec
    return (gcols, strides, g_pad, agg_specs, initial_group_kmax(padded))


def escalate_group_kmax(group_spec: tuple, padded: int):
    """The next rung of the kmax ladder (x4, pow2), None at full size."""
    gcols, strides, g_pad, agg_specs, kmax = group_spec
    if not kmax or kmax >= padded:
        return None
    nk = min(kernels.pow2_bucket(kmax * 4), padded)
    return (gcols, strides, g_pad, agg_specs, nk)


def run_with_group_escalation(run, group_spec, padded: int):
    """run(group_spec) -> host outs; runs again one rung up while the
    compacted kernels report group.overflow. Returns (outs, final spec)."""
    outs = run(group_spec)
    while group_spec is not None and int(outs.get("group.overflow", 0)) > 0:
        group_spec = escalate_group_kmax(group_spec, padded)
        if group_spec is None:
            raise RuntimeError("group.overflow at full kmax")
        kernels.count_route("escalation")
        outs = run(group_spec)
    return outs, group_spec


def adaptive_phase_a_specs(group_spec) -> Optional[tuple]:
    """Phase A's scout: masked MIN and MAX of each group column's dictIds
    (K5), or None when the plan is not eligible (kmax = 0, or a key that
    is not a dictionary column's ids)."""
    if group_spec is None or not group_spec[4]:
        return None
    specs = []
    for (c, gkind, _off, card) in group_spec[0]:
        if gkind != "ids":
            return None
        card_pad = kernels.pow2_bucket(card + 1)
        specs.append(("min", c, "sv", ("ids", card_pad)))
        specs.append(("max", c, "sv", ("ids", card_pad)))
    return tuple(specs)


def adaptive_hist_specs(group_spec, bounds) -> Optional[tuple]:
    """Phase A2's conditional scout: matched-id histograms (K4), from
    which the host takes each column's present ids for the rank remap.
    It runs to escape the ranked layout (the span key space past
    DENSE_G_LIMIT, every card_pad within RANK_HIST_CARD_LIMIT), or to
    shrink a dense span space past DENSE_RANK_HIST_G whose columns all
    have card_pad <= DENSE_RANK_HIST_CARD; else None."""
    spans, cards = [], []
    for (c, _gkind, _off, card), (lo, hi) in zip(group_spec[0], bounds):
        card_pad = kernels.pow2_bucket(card + 1)
        if card_pad > RANK_HIST_CARD_LIMIT:
            return None
        cards.append(card_pad)
        spans.append(kernels.pow2_bucket(max(hi - lo + 1, 1), floor=1))
    g_span = int(np.prod(spans, dtype=np.int64))
    if kernels.pow2_bucket(g_span) <= kernels.DENSE_G_LIMIT:
        if g_span <= DENSE_RANK_HIST_G or \
                any(cp > DENSE_RANK_HIST_CARD for cp in cards):
            return None
    return tuple(("hist", c, "sv",
                  ("hist", kernels.pow2_bucket(card + 1)))
                 for (c, _gkind, _off, card) in group_spec[0])


def _adaptive_kmax(matched: int, padded: int, total_docs: int,
                   g_pad: int) -> int:
    """kmax from the scout's selectivity: r = pow2(2 mu + 8), mu the mean
    matched rows of a CBLOCK-row block; 0 (K3's dense table) for a barely
    selective filter (r > 128) whose table is dense anyway."""
    t = max(padded // kernels.CBLOCK, 1)
    mu = matched * kernels.CBLOCK / max(total_docs, 1)
    r = kernels.pow2_bucket(max(16, int(2 * mu + 8)))
    if r > 128 and g_pad <= kernels.DENSE_G_LIMIT:
        return 0
    return min(t * r, padded)


def adaptive_phase_b_spec(group_spec, scout, matched: int, padded: int,
                          total_docs: int):
    """Phase B's spec from the scout: per column ("bounds", lo, hi), the
    matched id range (the offset remap), or ("present", ids), the matched
    id set (the rank remap, taken where the present counts bucket below
    the spans). Returns (kernel spec, finish spec, extra params, empty):
    the kernel spec's remap columns carry placeholders (their offsets and
    rank vectors ride as the extra params), the finish spec the offsets
    and present ids the host decodes with."""
    gcols, _strides, _g_pad, agg_specs, _kmax = group_spec
    dims = []                    # (span, n_rank | None, payload)
    for c, dim in zip(gcols, scout):
        if dim[0] == "present":
            present = dim[1]
            if len(present) == 0:
                return None, None, (), True
            span = kernels.pow2_bucket(
                int(present[-1]) - int(present[0]) + 1, floor=1)
            n = kernels.pow2_bucket(len(present), floor=1)
            dims.append((span, n if n < span else None, present))
        else:
            lo, hi = dim[1], dim[2]
            if hi < lo:
                return None, None, (), True
            span = kernels.pow2_bucket(hi - lo + 1, floor=1)
            dims.append((span, None, (lo, hi)))
    g_span = int(np.prod([d[0] for d in dims], dtype=np.int64))
    g_rank = int(np.prod([d[1] if d[1] is not None else d[0]
                          for d in dims], dtype=np.int64))
    use_rank = kernels.pow2_bucket(g_rank) < kernels.pow2_bucket(g_span)
    kernel_gcols, finish_gcols, spans, extra = [], [], [], []
    for c, (span, n, payload) in zip(gcols, dims):
        card_pad = kernels.pow2_bucket(c[3] + 1)
        if use_rank and n is not None:
            present = payload
            rank = np.zeros(card_pad, np.int32)
            rank[present] = np.arange(len(present), dtype=np.int32)
            kernel_gcols.append((c[0], "idrank", 0, n))
            finish_gcols.append((c[0], "idrank", present, n))
            spans.append(n)
            extra.append(rank)
            continue
        if isinstance(payload, tuple):
            lo, hi = payload
        else:                        # a present set, contiguous enough
            lo, hi = int(payload[0]), int(payload[-1])
        kernel_gcols.append((c[0], "idoff", 0, span))
        finish_gcols.append((c[0], "idoff", lo, span))
        spans.append(span)
        extra.append(np.int32(lo))
    strides = mixed_radix_strides(spans)
    g_pad = kernels.pow2_bucket(int(np.prod(spans, dtype=np.int64)))
    kmax = _adaptive_kmax(matched, padded, total_docs, g_pad)
    kernel_spec = (tuple(kernel_gcols), strides, g_pad, agg_specs, kmax)
    finish_spec = (tuple(finish_gcols), strides, g_pad, agg_specs, kmax)
    return kernel_spec, finish_spec, tuple(extra), False


def drive_group_execution(run, group_spec, padded: int, total_docs: int):
    """The execution policy of device group-bys
    (pinot_tpu/query/plan.py:drive_group_execution).

    `run(agg_specs, group_spec, extra_params)` launches the plan's kernels
    (extra_params after the plan's own runtime operands) and returns the
    HOST outputs (one device-to-host pull a dispatch). A filtered group-by
    over dictionary keys takes the adaptive path: phase A, the min / max
    scout and the match count; phase A2, matched-id histograms where
    adaptive_hist_specs judges them worth it; phase B, the group tables
    over the remapped key space with kmax from the scout's selectivity,
    up the kmax ladder on overflow. Other plans run their spec up the
    ladder (kmax = 0 runs once). Returns (outs, spec to finish with);
    None for the spec when the filter matched nothing (outs then holds
    phase A's stats)."""
    pa = adaptive_phase_a_specs(group_spec) \
        if padded <= kernels.DENSE_ROWS_LIMIT else None
    if pa is not None:
        kernels.count_route("scout")
        ha = run(pa, None, ())
        bounds = [(int(ha[f"agg{2 * i}.min"]), int(ha[f"agg{2 * i + 1}.max"]))
                  for i in range(len(pa) // 2)]
        matched = int(ha["stats.num_docs_matched"])
        scout = [("bounds", lo, hi) for lo, hi in bounds]
        if matched > 0:
            ph = adaptive_hist_specs(group_spec, bounds)
            if ph is not None:
                kernels.count_route("hist")
                hh = run(ph, None, ())
                scout = [("present",
                          np.nonzero(np.asarray(hh[f"agg{i}"])[: c[3]])[0])
                         for i, c in enumerate(group_spec[0])]
        kspec, fspec, extra, empty = adaptive_phase_b_spec(
            group_spec, scout, matched, padded, total_docs)
        if empty:
            return ha, None
        for kind in {g[1] for g in kspec[0]}:
            kernels.count_route(kind)
        if not kspec[4]:
            kernels.count_route("dense_regime")
        outs, final = run_with_group_escalation(
            lambda gs: run((), gs, extra), kspec, padded)
        if final is not kspec:            # the ladder escalated kmax
            fspec = fspec[:4] + (final[4],)
        return outs, fspec
    return run_with_group_escalation(lambda gs: run((), gs, ()),
                                     group_spec, padded)


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
    (pinot_tpu/query/plan.py:_agg_device_spec), in a group spec the one
    it takes under compaction (compact=True) at any size, and its
    refusals (UnsupportedOnDevice) in the same order."""
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
        needed[(col, {"sv": "ids", "mv": "mv", "raw": "raw",
                      "vdoc": "vdoc"}[source])] = None


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
