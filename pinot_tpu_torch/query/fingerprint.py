"""Canonical query fingerprint: the result-cache key.

A copy of pinot_tpu/query/fingerprint.py (JAX-free), its imports on the
port's request and serde modules.

Two requests share a fingerprint iff they MUST produce identical
results over identical data. The fingerprint therefore hashes a
canonicalized form of the compiled request:

- execution-irrelevant options are dropped (trace, timeoutMs — they
  shape metadata and deadlines, never result values;
  minConsumingFreshnessTimeMs is enforced per-query at cache-GET time
  as a max-age bound, so queries that differ only in their freshness
  bound share one entry);
- IN/NOT_IN value lists are sorted (set semantics);
- AND/OR children are sorted by their canonical encoding (conjunction
  and disjunction are commutative over result values).

Canonicalization only ever MERGES equivalent queries — a query pair
with different results always hashes differently, so a cache keyed on
the fingerprint (plus segment CRCs) is exact by construction; an
imperfect canonicalization costs hit rate, never correctness.
"""
from __future__ import annotations

import hashlib
import json
from typing import Optional

from pinot_tpu_torch.common.request import (BrokerRequest, FilterOperator,
                                      FilterQueryTree)
from pinot_tpu_torch.common.serde import filter_to_json, request_to_json

_COMMUTATIVE = (FilterOperator.AND, FilterOperator.OR)
_SET_VALUED = (FilterOperator.IN, FilterOperator.NOT_IN)


def _canonical_filter(node: Optional[FilterQueryTree]):
    if node is None:
        return None
    d = filter_to_json(node)
    if node.operator in _COMMUTATIVE:
        children = [_canonical_filter(c) for c in node.children]
        children.sort(key=lambda c: json.dumps(c, sort_keys=True))
        d["children"] = children
    elif node.operator in _SET_VALUED:
        d["vals"] = sorted(node.values)
    return d


def canonical_request_dict(request: BrokerRequest) -> dict:
    d = request_to_json(request)
    d["filter"] = _canonical_filter(request.filter)
    opts = d.get("options") or {}
    # execution-shaping keys never change result values: "workload" is
    # a scheduling/quota tag (two tenants issuing the same query must
    # share one cache entry), trace/timeoutMs shape metadata and
    # deadlines (the parser mirrors them into options.options too)
    drop = {"workload", "trace", "timeoutMs",
            "minConsumingFreshnessTimeMs"}
    d["options"] = {"options": dict(sorted(
        (k, v) for k, v in (opts.get("options") or {}).items()
        if k not in drop))}
    return d


def query_fingerprint(request: BrokerRequest) -> str:
    """Stable hex digest of the canonicalized request (table included)."""
    payload = json.dumps(canonical_request_dict(request), sort_keys=True,
                         separators=(",", ":"))
    return hashlib.sha256(payload.encode("utf-8")).hexdigest()[:32]


# ---------------------------------------------------------------------------
# Plan-shape key: the canonical fingerprint with literals hoisted out.
#
# Two requests share a plan-shape key iff they compile to the same
# kernel SHAPE and differ only in runtime literal operands — the
# condition under which the dispatch coalescer may stack them along a
# leading batch axis and serve both from one kernel execution. The
# compiled filter spec carries structure (operator tree, columns,
# lane sources, padded widths); literal values ride as runtime params
# (dictionary ids, member vectors, range bounds), so hoisting them
# here mirrors the spec/params split in query/plan.py exactly.
#
# The key is ADVISORY: the executor re-verifies compiled-spec equality
# before stacking (plan-time constant folds — an EQUALITY literal
# missing from a segment dictionary folds to EMPTY, an IN list whose
# resolved-id count crosses a pow2 bucket widens its lane — can make
# same-key plans diverge). A collision therefore costs batch
# occupancy, never correctness.

_VALUE_LEAVES = (FilterOperator.EQUALITY, FilterOperator.NOT,
                 FilterOperator.IN, FilterOperator.NOT_IN,
                 FilterOperator.REGEXP_LIKE)


def _shape_filter(node: Optional[FilterQueryTree]):
    """Canonical shape dict + hoisted literal list for a filter tree."""
    if node is None:
        return None, []
    d = filter_to_json(node)
    lits: list = []
    if node.operator in _COMMUTATIVE:
        pairs = [_shape_filter(c) for c in node.children]
        # sort by shape first so literal-only rewrites keep the child
        # order (and thus the key) stable; tiebreak identical-shape
        # siblings by their literal sub-vectors for determinism — a
        # swap of such siblings permutes the literal vector but the
        # shape encoding, and the key, are unchanged
        pairs.sort(key=lambda p: (json.dumps(p[0], sort_keys=True),
                                  json.dumps(p[1], default=str)))
        d["children"] = [shape for shape, _ in pairs]
        for _, sub in pairs:
            lits.extend(sub)
    elif node.operator in _SET_VALUED:
        vals = sorted(node.values)
        lits.extend(vals)
        # arity stays structural: the compiled lane width is padded
        # from the list length, so a different-arity IN is (usually) a
        # different kernel shape
        d["vals"] = ["?"] * len(vals)
    elif node.operator in _VALUE_LEAVES:
        lits.extend(node.values)
        d["vals"] = ["?"] * len(node.values)
    elif node.operator is FilterOperator.RANGE:
        lits.append(node.lower)
        lits.append(node.upper)
        d["lo"] = "?" if node.lower is not None else None
        d["hi"] = "?" if node.upper is not None else None
        # bound PRESENCE and inclusivity flags stay structural
    return d, lits


def plan_shape_key(request: BrokerRequest):
    """``(key, literal_vector)`` — the canonical fingerprint with
    literals hoisted out. Same key == batchable modulo the compiled
    spec check; the literal vector is the hoisted operands in canonical
    order (diagnostics and property tests, not an execution input —
    the stacked params come from each member's compiled plan)."""
    d = request_to_json(request)
    shape, lits = _shape_filter(request.filter)
    d["filter"] = shape
    # LIMIT and the selection window are literal knobs too: they shape
    # the host-side finish (and at most a pow2 topk bucket the spec
    # check re-verifies), not the operator tree
    lits.append(d.get("limit"))
    d["limit"] = "?"
    sel = d.get("selection")
    if sel:
        lits.append(sel.get("offset"))
        lits.append(sel.get("size"))
        sel["offset"] = "?"
        sel["size"] = "?"
    gb = d.get("groupBy")
    if gb:
        lits.append(gb.get("topN"))
        gb["topN"] = "?"
    vec = d.get("vector")
    if vec:
        # the query embedding is a runtime operand; k shapes the topk
        # lane and stays structural
        lits.extend(vec.get("q") or ())
        vec["q"] = "?"
    opts = d.get("options") or {}
    drop = {"workload", "trace", "timeoutMs",
            "minConsumingFreshnessTimeMs"}
    d["options"] = {"options": dict(sorted(
        (k, v) for k, v in (opts.get("options") or {}).items()
        if k not in drop))}
    payload = json.dumps(d, sort_keys=True, separators=(",", ":"))
    key = hashlib.sha256(payload.encode("utf-8")).hexdigest()[:32]
    return key, tuple(lits)
