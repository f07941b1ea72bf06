"""Compiled query representation: the broker request model.

Parity: the Thrift types in pinot-common/src/thrift/request.thrift
(BrokerRequest, FilterQuery/FilterQueryMap, AggregationInfo, GroupBy,
Selection, SelectionSort, HavingFilterQuery) plus
org.apache.pinot.common.utils.request.FilterQueryTree. We use plain
dataclass trees instead of flattened thrift id-maps — the semantics
(operators, nesting, value lists) are identical.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import List, Optional


class FilterOperator(enum.Enum):
    AND = "AND"
    OR = "OR"
    EQUALITY = "EQUALITY"
    NOT = "NOT"                 # not-equals
    IN = "IN"
    NOT_IN = "NOT_IN"
    RANGE = "RANGE"
    REGEXP_LIKE = "REGEXP_LIKE"
    IS_NULL = "IS_NULL"
    IS_NOT_NULL = "IS_NOT_NULL"


@dataclasses.dataclass
class FilterQueryTree:
    """A node in the filter tree.

    Leaf nodes carry (column, operator, values); AND/OR nodes carry children.
    RANGE values use Pinot's interval string syntax, e.g. ``["(10\t\t20)"]``
    is 10 < col < 20, ``["[10\t\t*)"]`` is col >= 10 (values joined by the
    RANGE delimiter). We keep a structured form instead: values =
    [lower, upper] with inclusive flags.
    """
    operator: FilterOperator
    column: Optional[str] = None
    values: List[str] = dataclasses.field(default_factory=list)
    children: List["FilterQueryTree"] = dataclasses.field(default_factory=list)
    # RANGE only:
    lower: Optional[str] = None          # None = unbounded (*)
    upper: Optional[str] = None
    lower_inclusive: bool = True
    upper_inclusive: bool = True

    def is_leaf(self) -> bool:
        return not self.children

    def __repr__(self) -> str:  # compact, for plan/debug output
        if self.operator in (FilterOperator.AND, FilterOperator.OR):
            return f"{self.operator.value}({', '.join(map(repr, self.children))})"
        if self.operator == FilterOperator.RANGE:
            lb = "[" if self.lower_inclusive else "("
            ub = "]" if self.upper_inclusive else ")"
            return (f"RANGE({self.column} in {lb}{self.lower or '*'},"
                    f"{self.upper or '*'}{ub})")
        return f"{self.operator.value}({self.column}, {self.values})"


@dataclasses.dataclass
class AggregationInfo:
    """One aggregation call, e.g. SUM(metric).

    Parity: request.thrift AggregationInfo {aggregationType, aggregationParams}.
    """
    function_name: str                    # upper-case, e.g. "SUM", "PERCENTILE95"
    column: str                           # "*" for COUNT(*)
    # parsed expression for transform args (round 1: plain column only)

    @property
    def call(self) -> str:
        return f"{self.function_name.lower()}({self.column})"


@dataclasses.dataclass
class SelectionSort:
    column: str
    ascending: bool = True


@dataclasses.dataclass
class GroupBy:
    columns: List[str]
    top_n: int = 10


@dataclasses.dataclass
class Selection:
    columns: List[str]
    order_by: List[SelectionSort] = dataclasses.field(default_factory=list)
    offset: int = 0
    size: int = 10


#: result columns every vector-similarity row ends with, in order: the
#: global doc id within its segment, the (logical) segment name, and the
#: float32 similarity score. Cross-segment/server merges order by
#: (score desc, segment, docId) — deterministic on every path.
VECTOR_RESULT_COLUMNS = ("$docId", "$segmentName", "$score")


@dataclasses.dataclass
class VectorSimilarity:
    """A ranked top-k similarity clause: VECTOR_SIMILARITY(col, [..], k).

    `metric` ∈ {COSINE, DOT, MIPS} (MIPS is an alias of DOT — maximum
    inner product). With `nprobe` == 0 (the default) the candidate set
    is the WHERE filter's (and the upsert validDocIds mask's) surviving
    rows, scored exhaustively. `nprobe` > 0 requests IVF ANN: segments
    carrying a built index score only rows assigned to the query's
    top-nprobe coarse cells; segments without one (and consuming/
    unsealed rows) transparently fall back to the exact scan, so upsert
    freshness semantics are unchanged.
    """
    column: str
    query: List[float]
    k: int = 10
    metric: str = "COSINE"
    nprobe: int = 0


@dataclasses.dataclass
class JoinSpec:
    """One INNER equi-join against a small dimension table.

    Compiled from ``FROM fact JOIN dim ON fact.k = dim.k``. The fact side
    is the request's own table; the dim side is scanned in stage 1 of the
    multi-stage plan (filtered by `dim_filter`, projecting `dim_key` +
    `dim_columns`), shipped through the exchange plane, and probed by the
    stage-2 fact kernels. Dim join keys must be unique (star-schema PK
    semantics: each fact row matches at most one dim row).

    Column name conventions in a compiled join request: fact columns are
    stored UNQUALIFIED (the engine resolves them against fact segments);
    dim columns appear qualified as ``<dim_table>.<col>`` wherever they
    ride in the shared request shape (group_by.columns), and unqualified
    inside this spec's dim-side fields.
    """
    dim_table: str
    fact_key: str                         # fact column (unqualified)
    dim_key: str                          # dim column (unqualified)
    dim_filter: Optional[FilterQueryTree] = None   # dim-side WHERE conjuncts
    dim_columns: List[str] = dataclasses.field(default_factory=list)

    def qualifies(self, col: str) -> bool:
        """True when `col` is a dim-qualified reference of this join."""
        return col.startswith(self.dim_table + ".")

    def unqualify(self, col: str) -> str:
        return col[len(self.dim_table) + 1:]


@dataclasses.dataclass
class WindowSpec:
    """One window function: ``ROW_NUMBER() OVER (...)`` or
    ``SUM(col) OVER (PARTITION BY ... ORDER BY ...)``.

    Frame semantics: rows between unbounded preceding and CURRENT ROW in
    the window order (running aggregates), with ties broken by input
    order — the one deterministic frame the device cumsum kernel and the
    host oracle reproduce bit-identically. SUM windows are integer-only
    (int32 running sums are the cross-backend exactness contract; the
    executor rejects inputs whose running sums could wrap).
    """
    function: str                          # "ROW_NUMBER" | "SUM"
    column: Optional[str] = None           # SUM argument (None: ROW_NUMBER)
    partition_by: List[str] = dataclasses.field(default_factory=list)
    order_by: List[SelectionSort] = dataclasses.field(default_factory=list)

    @property
    def result_name(self) -> str:
        arg = self.column or ""
        return f"{self.function.lower()}({arg})_over"


@dataclasses.dataclass
class HavingNode:
    """HAVING clause tree: comparison over aggregation results, or AND/OR."""
    operator: FilterOperator              # EQUALITY/NOT/RANGE/IN/... or AND/OR
    agg: Optional[AggregationInfo] = None
    values: List[str] = dataclasses.field(default_factory=list)
    children: List["HavingNode"] = dataclasses.field(default_factory=list)
    lower: Optional[str] = None
    upper: Optional[str] = None
    lower_inclusive: bool = True
    upper_inclusive: bool = True


@dataclasses.dataclass
class QueryOptions:
    trace: bool = False
    timeout_ms: Optional[int] = None
    debug_options: dict = dataclasses.field(default_factory=dict)
    options: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class BrokerRequest:
    """The compiled query, handed from broker to servers.

    Exactly one of (aggregations, selection) is populated: aggregation queries
    may also carry group_by; selection queries carry columns + order by.
    """
    table_name: str
    filter: Optional[FilterQueryTree] = None
    aggregations: List[AggregationInfo] = dataclasses.field(default_factory=list)
    group_by: Optional[GroupBy] = None
    selection: Optional[Selection] = None
    # ranked vector top-k (set together with `selection`, whose columns
    # are the ride-along display columns and whose size bounds the merge)
    vector: Optional[VectorSimilarity] = None
    # multi-stage surfaces (query/stages/): an INNER equi-join against a
    # dim table, or window functions over the scan result. Mutually
    # exclusive with each other and with `vector`.
    join: Optional[JoinSpec] = None
    windows: List[WindowSpec] = dataclasses.field(default_factory=list)
    having: Optional[HavingNode] = None
    query_options: QueryOptions = dataclasses.field(default_factory=QueryOptions)
    limit: int = 10

    @property
    def is_aggregation(self) -> bool:
        return bool(self.aggregations)

    @property
    def is_group_by(self) -> bool:
        return self.group_by is not None

    @property
    def is_selection(self) -> bool:
        return self.selection is not None

    def filter_columns(self) -> List[str]:
        cols: List[str] = []

        def walk(node: Optional[FilterQueryTree]):
            if node is None:
                return
            if node.is_leaf():
                if node.column:
                    cols.append(node.column)
            else:
                for c in node.children:
                    walk(c)

        walk(self.filter)
        return cols

    def referenced_columns(self) -> List[str]:
        """All physical columns the query touches (for pruning/validation).

        Transform expressions are expanded to their source columns."""
        from pinot_tpu_torch.common.expression import referenced_columns as expand
        cols = set()
        for c in self.filter_columns():
            cols.update(expand(c))
        for a in self.aggregations:
            if a.column != "*":
                cols.update(expand(a.column))
        if self.group_by:
            for c in self.group_by.columns:
                if self.join is not None and self.join.qualifies(c):
                    continue      # dim-side key: lives on the dim table
                cols.update(expand(c))
        if self.selection:
            for c in self.selection.columns:
                if c != "*":
                    cols.update(expand(c))
            cols.update(s.column for s in self.selection.order_by)
        if self.vector:
            cols.add(self.vector.column)
        if self.join is not None:
            cols.add(self.join.fact_key)
        for w in self.windows:
            if w.column is not None:
                cols.add(w.column)
            cols.update(w.partition_by)
            cols.update(s.column for s in w.order_by)
        return sorted(cols)


@dataclasses.dataclass
class InstanceRequest:
    """Broker→server RPC payload.

    Parity: request.thrift InstanceRequest {requestId, query, searchSegments,
    enableTrace, brokerId}.
    """
    request_id: int
    query: BrokerRequest
    # None = all hosted segments (embedded/test convenience);
    # [] = explicitly zero segments; list = exactly those segments
    search_segments: Optional[List[str]] = None
    enable_trace: bool = False
    broker_id: str = ""
    # remaining query budget at dispatch time (deadline propagation):
    # the server drops or truncates work once this much time has passed
    # since the request arrived. None = no propagated deadline (the
    # server falls back to its own default timeout).
    deadline_budget_ms: Optional[float] = None
    # distributed-tracing context (enable_trace only): the broker's
    # trace id and the id of the dispatch span this server call belongs
    # to — the server roots its span subtree under parent_span_id so
    # the broker can merge one cross-process trace tree at reduce
    trace_id: Optional[str] = None
    parent_span_id: Optional[str] = None
    # tenant/workload tag (optional serde key, version-skew safe): the
    # server maps it to a per-tenant TokenSchedulerGroup so one
    # tenant's flood burns its own tokens, and admission control
    # applies per-tenant fair-share shedding under overload
    workload: Optional[str] = None
    # True on hedged duplicate dispatches: under queue pressure the
    # server sheds hedges FIRST (the primary is still in flight
    # somewhere — dropping the duplicate loses nothing)
    hedge: bool = False
    # -- multi-stage exchange plane (query/stages/) -------------------------
    # stage-1 producer: {"id": exchange id, "keyColumn": join/partition
    # key} — the server executes the query normally, PUBLISHES the
    # serialized result into its ExchangeManager under the id, and
    # replies with a small ack (rows, partition tags) instead of the
    # payload. Optional serde key: older peers ignore it.
    publish_exchange: Optional[dict] = None
    # stage-2 consumer: descriptors of stage-1 blocks to fetch over the
    # data plane before executing — [{"server", "xkey", "host", "port",
    # "id", "rows", "partitions"?, "partitionFunction"?,
    # "numPartitions"?}]. Optional serde key.
    exchange_sources: Optional[List[dict]] = None
