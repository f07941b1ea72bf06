"""PQL recursive-descent parser → BrokerRequest.

Parity: org.apache.pinot.pql.parsers.Pql2Compiler.compileToBrokerRequest
(pinot-common/.../pql/parsers/Pql2Compiler.java:63-102) and the PQL2.g4
grammar: SELECT output list (columns or aggregation calls), FROM, WHERE
predicate tree (comparison / BETWEEN / IN / NOT IN / REGEXP_LIKE / IS NULL
with AND/OR nesting), GROUP BY, HAVING, ORDER BY, TOP, LIMIT.

Comparison predicates compile to the same FilterOperator encoding the
reference uses (Pql2AstNode → FilterQueryTree): ``=`` → EQUALITY, ``<>/!=`` →
NOT, ``< <= > >=`` → one-sided RANGE, BETWEEN → two-sided inclusive RANGE.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

from pinot_tpu_torch.common import expression as expr_mod
from pinot_tpu_torch.common.request import (AggregationInfo, BrokerRequest,
                                      FilterOperator, FilterQueryTree, GroupBy,
                                      HavingNode, JoinSpec, QueryOptions,
                                      Selection, SelectionSort,
                                      VectorSimilarity, WindowSpec)
from pinot_tpu_torch.pql.lexer import PqlSyntaxError, TokType, Token, tokenize

# Aggregation function names the engine recognizes (PERCENTILE variants are
# matched by prefix, e.g. PERCENTILE95 / PERCENTILETDIGEST99).
AGG_PREFIXES = (
    "COUNT", "SUM", "MIN", "MAX", "AVG", "MINMAXRANGE", "DISTINCTCOUNTHLL",
    "DISTINCTCOUNTRAWHLL", "DISTINCTCOUNT", "FASTHLL", "PERCENTILEEST",
    "PERCENTILETDIGEST", "PERCENTILE",
)
_MV_SUFFIX = "MV"


def is_aggregation_function(name: str) -> bool:
    up = name.upper()
    if up.endswith(_MV_SUFFIX):
        up = up[: -len(_MV_SUFFIX)]
    for p in sorted(AGG_PREFIXES, key=len, reverse=True):
        if up.startswith(p):
            rest = up[len(p):]
            return rest == "" or rest.isdigit()
    return False


class Pql2Compiler:
    """compile(pql) -> BrokerRequest."""

    def compile(self, pql: str) -> BrokerRequest:
        return _Parser(tokenize(pql), pql).parse_query()


def compile_pql(pql: str) -> BrokerRequest:
    return Pql2Compiler().compile(pql)


class _Parser:
    def __init__(self, toks: List[Token], text: str):
        self.toks = toks
        self.text = text
        self.i = 0

    # -- token plumbing ----------------------------------------------------
    def peek(self) -> Token:
        return self.toks[self.i]

    def next(self) -> Token:
        t = self.toks[self.i]
        self.i += 1
        return t

    def accept_kw(self, *words: str) -> bool:
        t = self.peek()
        if t.type == TokType.KEYWORD and t.upper == words[0]:
            # multi-word keyword like GROUP BY
            for k, w in enumerate(words):
                tk = self.toks[self.i + k]
                if not (tk.type == TokType.KEYWORD and tk.upper == w):
                    return False
            self.i += len(words)
            return True
        return False

    def expect_kw(self, *words: str):
        if not self.accept_kw(*words):
            raise PqlSyntaxError(
                f"expected {' '.join(words)} at {self.peek().pos} "
                f"(got {self.peek().value!r})")

    def expect(self, ttype: TokType) -> Token:
        t = self.next()
        if t.type != ttype:
            raise PqlSyntaxError(f"expected {ttype.value} at {t.pos}, "
                                 f"got {t.value!r}")
        return t

    # -- grammar -----------------------------------------------------------
    def parse_query(self) -> BrokerRequest:
        self.expect_kw("SELECT")
        select_items = self.parse_select_list()
        self.expect_kw("FROM")
        table = self.expect(TokType.IDENT).value

        join = None
        if self.accept_kw("JOIN"):
            join = self.parse_join_clause(table)

        filt = None
        if self.accept_kw("WHERE"):
            filt = self.parse_predicate()

        group_by_cols: List[str] = []
        if self.accept_kw("GROUP", "BY"):
            group_by_cols = self.parse_ident_list()

        having = None
        if self.accept_kw("HAVING"):
            having = self.parse_having()

        order_by: List[SelectionSort] = []
        if self.accept_kw("ORDER", "BY"):
            order_by = self.parse_order_list()

        top_n = None
        if self.accept_kw("TOP"):
            top_n = int(self.expect(TokType.INT).value)

        offset, size = 0, None
        if self.accept_kw("LIMIT"):
            first = int(self.expect(TokType.INT).value)
            if self.peek().type == TokType.COMMA:
                self.next()
                offset, size = first, int(self.expect(TokType.INT).value)
            elif self.accept_kw("OFFSET"):
                size, offset = first, int(self.expect(TokType.INT).value)
            else:
                size = first

        options = QueryOptions()
        if self.accept_kw("OPTION"):
            self.expect(TokType.LPAREN)
            while True:
                key = self.next().value
                self.expect(TokType.OP)  # '='
                val = self.next().value
                options.options[key] = val
                if key == "timeoutMs":
                    options.timeout_ms = int(val)
                elif key == "trace":
                    options.trace = str(val).lower() in ("true", "1")
                if self.peek().type == TokType.COMMA:
                    self.next()
                    continue
                break
            self.expect(TokType.RPAREN)

        if self.peek().type != TokType.EOF:
            raise PqlSyntaxError(
                f"trailing input at {self.peek().pos}: {self.peek().value!r}")

        # -- assemble ------------------------------------------------------
        aggs = [it for it in select_items if isinstance(it, AggregationInfo)]
        cols = [it for it in select_items if isinstance(it, str)]
        vecs = [it for it in select_items if isinstance(it, VectorSimilarity)]
        wins = [it for it in select_items if isinstance(it, WindowSpec)]
        if aggs and cols:
            raise PqlSyntaxError(
                "cannot mix aggregations and plain columns in SELECT "
                "(use GROUP BY for grouped output)")

        req = BrokerRequest(table_name=table, filter=filt,
                            query_options=options)
        if wins:
            if join is not None:
                raise PqlSyntaxError(
                    "window functions cannot mix with JOIN")
            if aggs or vecs or group_by_cols or having is not None:
                raise PqlSyntaxError(
                    "window functions cannot mix with aggregations, "
                    "GROUP BY, HAVING or VECTOR_SIMILARITY")
            if order_by or top_n is not None:
                raise PqlSyntaxError(
                    "outer ORDER BY/TOP do not apply to window queries — "
                    "rows come back in (PARTITION BY, ORDER BY) window "
                    "order")
            if "*" in cols:
                raise PqlSyntaxError(
                    "window queries must name their display columns "
                    "explicitly (SELECT * is not supported)")
            req.windows = wins
            req.selection = Selection(columns=cols, order_by=[],
                                      offset=offset,
                                      size=size if size is not None else 10)
            req.limit = size if size is not None else 10
            return req
        if vecs:
            if join is not None:
                raise PqlSyntaxError(
                    "VECTOR_SIMILARITY cannot mix with JOIN")
            if len(vecs) > 1:
                raise PqlSyntaxError(
                    "only one VECTOR_SIMILARITY clause per query")
            if aggs or group_by_cols or having is not None or order_by:
                raise PqlSyntaxError(
                    "VECTOR_SIMILARITY cannot mix with aggregations, "
                    "GROUP BY, HAVING or ORDER BY (results are ranked "
                    "by similarity score)")
            if "*" in cols:
                raise PqlSyntaxError(
                    "VECTOR_SIMILARITY with SELECT * is not supported — "
                    "name the ride-along columns explicitly")
            if top_n is not None or size is not None:
                raise PqlSyntaxError(
                    "VECTOR_SIMILARITY takes k as its third argument; "
                    "TOP/LIMIT do not apply")
            v = vecs[0]
            req.vector = v
            req.selection = Selection(columns=cols, order_by=[],
                                      offset=0, size=v.k)
            req.limit = v.k
            return req
        if aggs:
            req.aggregations = aggs
            if group_by_cols:
                req.group_by = GroupBy(columns=group_by_cols,
                                       top_n=top_n or size or 10)
            req.having = having
            req.limit = top_n or size or 10
        else:
            if group_by_cols:
                raise PqlSyntaxError("GROUP BY requires aggregations")
            req.selection = Selection(columns=cols or ["*"],
                                      order_by=order_by, offset=offset,
                                      size=size if size is not None else 10)
            req.limit = size if size is not None else 10
        if join is not None:
            _finalize_join(req, table, *join)
        return req

    def parse_join_clause(self, fact_table: str):
        """``JOIN dim ON a.x = b.y`` — returns (dim_table, left, right)
        raw qualified names; resolution against the two table names
        happens in _finalize_join once the whole query is parsed."""
        dim = self.expect(TokType.IDENT).value
        if dim == fact_table:
            raise PqlSyntaxError("self-joins are not supported")
        self.expect_kw("ON")
        left = self.expect(TokType.IDENT).value
        t = self.next()
        if t.type != TokType.OP or t.value != "=":
            raise PqlSyntaxError(
                f"JOIN ... ON supports only equality conditions, got "
                f"{t.value!r} at {t.pos}")
        right = self.expect(TokType.IDENT).value
        return dim, left, right

    def parse_select_list(self):
        items = []
        if self.peek().type == TokType.STAR:
            self.next()
            return ["*"]
        while True:
            items.append(self.parse_select_item())
            if self.peek().type == TokType.COMMA:
                self.next()
                continue
            return items

    def parse_select_item(self):
        t = self.peek()
        if t.type == TokType.IDENT and \
                self.toks[self.i + 1].type == TokType.LPAREN:
            if t.upper == "VECTOR_SIMILARITY":
                return self.parse_vector_call()
            if t.upper == "ROW_NUMBER":
                self.next()
                self.expect(TokType.LPAREN)
                self.expect(TokType.RPAREN)
                return self.parse_over_clause("ROW_NUMBER", None)
            if is_aggregation_function(t.value):
                agg = self.parse_agg_call()
                if self.peek().type == TokType.KEYWORD and \
                        self.peek().upper == "OVER":
                    if agg.function_name != "SUM":
                        raise PqlSyntaxError(
                            f"window function {agg.function_name} is not "
                            "supported (ROW_NUMBER | SUM)")
                    if agg.column == "*" or \
                            expr_mod.is_expression(agg.column):
                        raise PqlSyntaxError(
                            "SUM(...) OVER takes a plain column argument")
                    return self.parse_over_clause("SUM", agg.column)
                return agg
        if t.type == TokType.IDENT:
            return self.next().value
        raise PqlSyntaxError(f"bad select item at {t.pos}: {t.value!r}")

    def parse_over_clause(self, function: str,
                          column: Optional[str]) -> WindowSpec:
        """``OVER ( [PARTITION BY cols] ORDER BY cols )`` — ORDER BY is
        mandatory: the running-aggregate frame is defined by the window
        order, so an orderless window has no deterministic meaning."""
        self.expect_kw("OVER")
        self.expect(TokType.LPAREN)
        partition_by: List[str] = []
        if self.accept_kw("PARTITION", "BY"):
            partition_by = [self.expect(TokType.IDENT).value]
            while self.peek().type == TokType.COMMA:
                self.next()
                partition_by.append(self.expect(TokType.IDENT).value)
        if not self.accept_kw("ORDER", "BY"):
            raise PqlSyntaxError(
                f"window specification at {self.peek().pos} needs ORDER "
                "BY (running-aggregate frames are defined by the window "
                "order)")
        order_by = self.parse_order_list()
        self.expect(TokType.RPAREN)
        return WindowSpec(function=function, column=column,
                          partition_by=partition_by, order_by=order_by)

    def parse_vector_call(self) -> VectorSimilarity:
        """VECTOR_SIMILARITY(col, [f, f, ...], k[, 'COSINE'|'DOT'|'MIPS']
        [, nprobe=N]) — nprobe > 0 requests IVF ANN probing (segments
        without a built index fall back to the exact scan)."""
        self.next()                              # VECTOR_SIMILARITY
        self.expect(TokType.LPAREN)
        col = self.expect(TokType.IDENT).value
        self.expect(TokType.COMMA)
        self.expect(TokType.LBRACKET)
        q: List[float] = []
        while self.peek().type != TokType.RBRACKET:
            t = self.next()
            if t.type not in (TokType.INT, TokType.FLOAT):
                raise PqlSyntaxError(
                    f"expected a number in the query vector at {t.pos}, "
                    f"got {t.value!r}")
            q.append(float(t.value))
            if self.peek().type == TokType.COMMA:
                self.next()
        self.expect(TokType.RBRACKET)
        if not q:
            raise PqlSyntaxError("empty query vector")
        self.expect(TokType.COMMA)
        t = self.peek()
        k = int(self.expect(TokType.INT).value)
        if k <= 0:
            raise PqlSyntaxError(f"VECTOR_SIMILARITY k must be positive "
                                 f"at {t.pos}, got {k}")
        metric = "COSINE"
        nprobe = 0
        while self.peek().type == TokType.COMMA:
            self.next()
            t = self.peek()
            if t.type == TokType.STRING:
                m = self.next().value.upper()
                if m not in ("COSINE", "DOT", "MIPS"):
                    raise PqlSyntaxError(
                        f"unknown similarity metric {m!r} "
                        "(COSINE | DOT | MIPS)")
                metric = m
            elif t.type == TokType.IDENT and t.value.lower() == "nprobe":
                self.next()
                op = self.expect(TokType.OP)
                if op.value != "=":
                    raise PqlSyntaxError(
                        f"expected nprobe=N at {op.pos}, got {op.value!r}")
                nt = self.peek()
                nprobe = int(self.expect(TokType.INT).value)
                if nprobe <= 0:
                    raise PqlSyntaxError(
                        f"nprobe must be positive at {nt.pos}, got "
                        f"{nprobe}")
            else:
                raise PqlSyntaxError(
                    f"expected 'METRIC' or nprobe=N at {t.pos}, got "
                    f"{t.value!r}")
        self.expect(TokType.RPAREN)
        return VectorSimilarity(column=col, query=q, k=k, metric=metric,
                                nprobe=nprobe)

    def parse_agg_call(self) -> AggregationInfo:
        name = self.next().upper
        self.expect(TokType.LPAREN)
        if self.peek().type == TokType.STAR:
            self.next()
            col = "*"
        else:
            col = self.parse_column_or_expression()
        self.expect(TokType.RPAREN)
        return AggregationInfo(function_name=name, column=col)

    def parse_column_or_expression(self) -> str:
        """Plain column, or a transform call like time_convert(col,'D','H')
        — returned as a canonical expression string (parity:
        TransformExpressionTree's standardized column name)."""
        t = self.expect(TokType.IDENT)
        if self.peek().type != TokType.LPAREN or \
                not expr_mod.is_transform_function(t.value):
            return t.value
        return expr_mod.to_string(self._parse_expr_call(t.value))

    def _parse_expr_call(self, fname: str):
        self.expect(TokType.LPAREN)
        args = []
        if self.peek().type != TokType.RPAREN:
            args.append(self._parse_expr_arg())
            while self.peek().type == TokType.COMMA:
                self.next()
                args.append(self._parse_expr_arg())
        self.expect(TokType.RPAREN)
        return expr_mod.Call(fname.lower(), tuple(args))

    def _parse_expr_arg(self):
        t = self.next()
        if t.type == TokType.STRING:
            return expr_mod.Lit(t.value, is_string=True)
        if t.type in (TokType.INT, TokType.FLOAT):
            return expr_mod.Lit(t.value)
        if t.type == TokType.IDENT:
            if self.peek().type == TokType.LPAREN and \
                    expr_mod.is_transform_function(t.value):
                return self._parse_expr_call(t.value)
            return expr_mod.Col(t.value)
        raise PqlSyntaxError(
            f"bad expression argument at {t.pos}: {t.value!r}")

    def parse_ident_list(self) -> List[str]:
        out = [self.parse_column_or_expression()]
        while self.peek().type == TokType.COMMA:
            self.next()
            out.append(self.parse_column_or_expression())
        return out

    def parse_order_list(self) -> List[SelectionSort]:
        out = []
        while True:
            col = self.expect(TokType.IDENT).value
            asc = True
            if self.accept_kw("ASC"):
                asc = True
            elif self.accept_kw("DESC"):
                asc = False
            out.append(SelectionSort(column=col, ascending=asc))
            if self.peek().type == TokType.COMMA:
                self.next()
                continue
            return out

    # -- WHERE predicates --------------------------------------------------
    def parse_predicate(self) -> FilterQueryTree:
        return self.parse_or()

    def parse_or(self) -> FilterQueryTree:
        left = self.parse_and()
        children = [left]
        while self.accept_kw("OR"):
            children.append(self.parse_and())
        if len(children) == 1:
            return left
        return FilterQueryTree(FilterOperator.OR, children=children)

    def parse_and(self) -> FilterQueryTree:
        left = self.parse_unary()
        children = [left]
        while self.accept_kw("AND"):
            children.append(self.parse_unary())
        if len(children) == 1:
            return left
        return FilterQueryTree(FilterOperator.AND, children=children)

    def parse_unary(self) -> FilterQueryTree:
        if self.peek().type == TokType.LPAREN:
            self.next()
            node = self.parse_or()
            self.expect(TokType.RPAREN)
            return node
        # REGEXP_LIKE(col, 'pattern')
        t = self.peek()
        if t.type == TokType.IDENT and t.upper == "REGEXP_LIKE" and \
                self.toks[self.i + 1].type == TokType.LPAREN:
            self.next(); self.next()
            col = self.expect(TokType.IDENT).value
            self.expect(TokType.COMMA)
            pat = self.expect(TokType.STRING).value
            self.expect(TokType.RPAREN)
            return FilterQueryTree(FilterOperator.REGEXP_LIKE, column=col,
                                   values=[pat])
        return self.parse_comparison()

    def parse_literal(self) -> str:
        t = self.next()
        if t.type in (TokType.STRING, TokType.INT, TokType.FLOAT,
                      TokType.IDENT):
            return t.value
        raise PqlSyntaxError(f"expected literal at {t.pos}, got {t.value!r}")

    def parse_comparison(self) -> FilterQueryTree:
        col = self.parse_column_or_expression()
        t = self.peek()
        if t.type == TokType.OP:
            op = self.next().value
            val = self.parse_literal()
            return _comparison_to_tree(col, op, val)
        negate = self.accept_kw("NOT")
        if self.accept_kw("BETWEEN"):
            lo = self.parse_literal()
            self.expect_kw("AND")
            hi = self.parse_literal()
            node = FilterQueryTree(FilterOperator.RANGE, column=col,
                                   lower=lo, upper=hi,
                                   lower_inclusive=True, upper_inclusive=True)
            if negate:
                raise PqlSyntaxError("NOT BETWEEN is not supported")
            return node
        if self.accept_kw("IN"):
            self.expect(TokType.LPAREN)
            vals = [self.parse_literal()]
            while self.peek().type == TokType.COMMA:
                self.next()
                vals.append(self.parse_literal())
            self.expect(TokType.RPAREN)
            return FilterQueryTree(
                FilterOperator.NOT_IN if negate else FilterOperator.IN,
                column=col, values=vals)
        if self.accept_kw("IS"):
            is_not = self.accept_kw("NOT")
            self.expect_kw("NULL")
            return FilterQueryTree(
                FilterOperator.IS_NOT_NULL if is_not else FilterOperator.IS_NULL,
                column=col)
        raise PqlSyntaxError(f"bad predicate near {t.pos}: {t.value!r}")

    # -- HAVING ------------------------------------------------------------
    def parse_having(self) -> HavingNode:
        return self.parse_having_or()

    def parse_having_or(self) -> HavingNode:
        children = [self.parse_having_and()]
        while self.accept_kw("OR"):
            children.append(self.parse_having_and())
        if len(children) == 1:
            return children[0]
        return HavingNode(FilterOperator.OR, children=children)

    def parse_having_and(self) -> HavingNode:
        children = [self.parse_having_unary()]
        while self.accept_kw("AND"):
            children.append(self.parse_having_unary())
        if len(children) == 1:
            return children[0]
        return HavingNode(FilterOperator.AND, children=children)

    def parse_having_unary(self) -> HavingNode:
        if self.peek().type == TokType.LPAREN:
            self.next()
            node = self.parse_having_or()
            self.expect(TokType.RPAREN)
            return node
        agg = self.parse_agg_call()
        t = self.peek()
        if t.type == TokType.OP:
            op = self.next().value
            val = self.parse_literal()
            tree = _comparison_to_tree("_", op, val)
            return HavingNode(tree.operator, agg=agg, values=tree.values,
                              lower=tree.lower, upper=tree.upper,
                              lower_inclusive=tree.lower_inclusive,
                              upper_inclusive=tree.upper_inclusive)
        if self.accept_kw("BETWEEN"):
            lo = self.parse_literal()
            self.expect_kw("AND")
            hi = self.parse_literal()
            return HavingNode(FilterOperator.RANGE, agg=agg, lower=lo,
                              upper=hi)
        if self.accept_kw("IN"):
            self.expect(TokType.LPAREN)
            vals = [self.parse_literal()]
            while self.peek().type == TokType.COMMA:
                self.next()
                vals.append(self.parse_literal())
            self.expect(TokType.RPAREN)
            return HavingNode(FilterOperator.IN, agg=agg, values=vals)
        raise PqlSyntaxError(f"bad HAVING predicate at {t.pos}")


def _qual_split(name: str, fact: str, dim: str, what: str):
    """``table.column`` → (side, column) against the two joined tables."""
    if expr_mod.is_expression(name):
        raise PqlSyntaxError(
            f"transform expressions are not supported in JOIN queries "
            f"({what} {name!r})")
    if "." not in name:
        raise PqlSyntaxError(
            f"{what} {name!r} must be qualified as <table>.<column> in a "
            f"JOIN query (FROM {fact} JOIN {dim})")
    t, c = name.split(".", 1)
    if t == fact:
        return "fact", c
    if t == dim:
        return "dim", c
    raise PqlSyntaxError(
        f"{what} {name!r} references unknown table {t!r} "
        f"(FROM {fact} JOIN {dim})")


def _filter_side(node: FilterQueryTree, fact: str, dim: str) -> str:
    if node.is_leaf():
        return _qual_split(node.column, fact, dim, "WHERE column")[0]
    sides = {_filter_side(c, fact, dim) for c in node.children}
    if len(sides) != 1:
        raise PqlSyntaxError(
            "a nested OR predicate cannot span both join sides — only "
            "top-level AND may mix fact-side and dim-side conditions")
    return sides.pop()


def _strip_qualifiers(node: FilterQueryTree, fact: str, dim: str) -> None:
    if node.is_leaf():
        node.column = _qual_split(node.column, fact, dim,
                                  "WHERE column")[1]
        return
    for c in node.children:
        _strip_qualifiers(c, fact, dim)


def _finalize_join(req: BrokerRequest, fact: str, dim: str,
                   left: str, right: str) -> None:
    """Resolve qualified names of a JOIN query into the compiled form:
    fact columns unqualified, dim columns kept ``<dim>.<col>``-qualified
    (group keys) or collected into the JoinSpec; the WHERE tree splits
    into fact-side conjuncts (stay on the request) and dim-side
    conjuncts (pushed down into the stage-1 dim scan)."""
    if req.is_selection and not req.is_aggregation:
        raise PqlSyntaxError(
            "JOIN queries must aggregate (SELECT agg(...) "
            "[GROUP BY ...]) — row selection over joins is not supported")
    l_side, l_col = _qual_split(left, fact, dim, "join key")
    r_side, r_col = _qual_split(right, fact, dim, "join key")
    if {l_side, r_side} != {"fact", "dim"}:
        raise PqlSyntaxError(
            "JOIN ... ON must relate one fact-side and one dim-side "
            f"column (got {left} = {right})")
    fact_key = l_col if l_side == "fact" else r_col
    dim_key = r_col if l_side == "fact" else l_col

    join = JoinSpec(dim_table=dim, fact_key=fact_key, dim_key=dim_key)

    # WHERE: split top-level AND conjuncts by side
    if req.filter is not None:
        conjuncts = req.filter.children \
            if req.filter.operator == FilterOperator.AND \
            else [req.filter]
        fact_nodes, dim_nodes = [], []
        for c in conjuncts:
            (fact_nodes if _filter_side(c, fact, dim) == "fact"
             else dim_nodes).append(c)
        for c in fact_nodes + dim_nodes:
            _strip_qualifiers(c, fact, dim)
        req.filter = None if not fact_nodes else (
            fact_nodes[0] if len(fact_nodes) == 1 else
            FilterQueryTree(FilterOperator.AND, children=fact_nodes))
        join.dim_filter = None if not dim_nodes else (
            dim_nodes[0] if len(dim_nodes) == 1 else
            FilterQueryTree(FilterOperator.AND, children=dim_nodes))

    # aggregations: fact metrics only (COUNT(*) excepted)
    for a in req.aggregations:
        if a.column == "*":
            continue
        side, c = _qual_split(a.column, fact, dim, "aggregation argument")
        if side != "fact":
            raise PqlSyntaxError(
                f"aggregation over dim-table column {a.column!r} is not "
                "supported — aggregate fact metrics; dim columns may "
                "filter (WHERE) and group (GROUP BY)")
        a.column = c
    if req.having is not None:
        _rewrite_having_join(req.having, fact, dim)

    # GROUP BY: fact keys unqualified, dim keys stay qualified
    if req.group_by is not None:
        out = []
        for g in req.group_by.columns:
            side, c = _qual_split(g, fact, dim, "group-by column")
            if side == "fact":
                out.append(c)
            else:
                out.append(f"{dim}.{c}")
                if c not in join.dim_columns:
                    join.dim_columns.append(c)
        req.group_by.columns = out
    req.join = join


def _rewrite_having_join(node: HavingNode, fact: str, dim: str) -> None:
    for c in node.children:
        _rewrite_having_join(c, fact, dim)
    if node.agg is not None and node.agg.column != "*":
        side, c = _qual_split(node.agg.column, fact, dim,
                              "HAVING aggregation argument")
        if side != "fact":
            raise PqlSyntaxError(
                f"HAVING over dim-table column {node.agg.column!r} is "
                "not supported")
        node.agg.column = c


def _comparison_to_tree(col: str, op: str, val: str) -> FilterQueryTree:
    if op == "=":
        return FilterQueryTree(FilterOperator.EQUALITY, column=col,
                               values=[val])
    if op in ("<>", "!="):
        return FilterQueryTree(FilterOperator.NOT, column=col, values=[val])
    if op == "<":
        return FilterQueryTree(FilterOperator.RANGE, column=col, upper=val,
                               upper_inclusive=False)
    if op == "<=":
        return FilterQueryTree(FilterOperator.RANGE, column=col, upper=val,
                               upper_inclusive=True)
    if op == ">":
        return FilterQueryTree(FilterOperator.RANGE, column=col, lower=val,
                               lower_inclusive=False)
    if op == ">=":
        return FilterQueryTree(FilterOperator.RANGE, column=col, lower=val,
                               lower_inclusive=True)
    raise PqlSyntaxError(f"unknown comparison operator {op!r}")
