"""Broker-side filter-tree rewrites.

Parity: pinot-broker/.../requesthandler/
{FlattenNestedPredicatesFilterQueryTreeOptimizer,
MultipleOrEqualitiesToInClauseFilterQueryTreeOptimizer,
RangeMergeOptimizer}.java — flatten nested AND/OR, collapse OR of equalities
on one column into IN, and intersect ANDed ranges on one column.
"""
from __future__ import annotations

from typing import List, Optional

from pinot_tpu_torch.common.request import (BrokerRequest, FilterOperator,
                                      FilterQueryTree)


class BrokerRequestOptimizer:
    def optimize(self, request: BrokerRequest) -> BrokerRequest:
        if request.filter is not None:
            f = flatten(request.filter)
            f = or_eq_to_in(f)
            f = merge_ranges(f)
            request.filter = f
        return request


def flatten(node: FilterQueryTree) -> FilterQueryTree:
    """AND(AND(a,b),c) → AND(a,b,c); same for OR; unwrap single-child nodes."""
    if node.is_leaf():
        return node
    children = [flatten(c) for c in node.children]
    out: List[FilterQueryTree] = []
    for c in children:
        if not c.is_leaf() and c.operator == node.operator:
            out.extend(c.children)
        else:
            out.append(c)
    if len(out) == 1:
        return out[0]
    return FilterQueryTree(node.operator, children=out)


def or_eq_to_in(node: FilterQueryTree) -> FilterQueryTree:
    """OR(col=a, col=b, col IN (c)) → col IN (a,b,c)."""
    if node.is_leaf():
        return node
    children = [or_eq_to_in(c) for c in node.children]
    if node.operator != FilterOperator.OR:
        return FilterQueryTree(node.operator, children=children)
    by_col = {}
    rest: List[FilterQueryTree] = []
    for c in children:
        if c.is_leaf() and c.operator in (FilterOperator.EQUALITY,
                                          FilterOperator.IN):
            by_col.setdefault(c.column, []).extend(c.values)
        else:
            rest.append(c)
    merged: List[FilterQueryTree] = []
    for col, vals in by_col.items():
        uniq = list(dict.fromkeys(vals))
        if len(uniq) == 1:
            merged.append(FilterQueryTree(FilterOperator.EQUALITY, column=col,
                                          values=uniq))
        else:
            merged.append(FilterQueryTree(FilterOperator.IN, column=col,
                                          values=uniq))
    out = merged + rest
    if len(out) == 1:
        return out[0]
    return FilterQueryTree(FilterOperator.OR, children=out)


def merge_ranges(node: FilterQueryTree) -> FilterQueryTree:
    """AND(col>a, col<=b) → single RANGE(a, b]. Numeric bounds only."""
    if node.is_leaf():
        return node
    children = [merge_ranges(c) for c in node.children]
    if node.operator != FilterOperator.AND:
        return FilterQueryTree(node.operator, children=children)
    ranges = {}
    rest: List[FilterQueryTree] = []
    for c in children:
        if c.is_leaf() and c.operator == FilterOperator.RANGE and \
                _is_numeric_range(c):
            if c.column in ranges:
                ranges[c.column] = _intersect(ranges[c.column], c)
            else:
                ranges[c.column] = c
        else:
            rest.append(c)
    out = list(ranges.values()) + rest
    if len(out) == 1:
        return out[0]
    return FilterQueryTree(FilterOperator.AND, children=out)


def _is_numeric_range(n: FilterQueryTree) -> bool:
    for v in (n.lower, n.upper):
        if v is None:
            continue
        try:
            float(v)
        except ValueError:
            return False
    return True


def _intersect(a: FilterQueryTree, b: FilterQueryTree) -> FilterQueryTree:
    lower, lower_inc = a.lower, a.lower_inclusive
    if b.lower is not None:
        if lower is None or float(b.lower) > float(lower) or \
                (float(b.lower) == float(lower) and not b.lower_inclusive):
            lower, lower_inc = b.lower, b.lower_inclusive
    upper, upper_inc = a.upper, a.upper_inclusive
    if b.upper is not None:
        if upper is None or float(b.upper) < float(upper) or \
                (float(b.upper) == float(upper) and not b.upper_inclusive):
            upper, upper_inc = b.upper, b.upper_inclusive
    return FilterQueryTree(FilterOperator.RANGE, column=a.column,
                           lower=lower, upper=upper,
                           lower_inclusive=lower_inc,
                           upper_inclusive=upper_inc)
