"""Transform expressions: parse, canonicalize, evaluate (numpy).

Parity: pinot-common TransformExpressionTree +
core/operator/transform/TransformFunctionFactory — function-call expressions
over columns and literals, usable as aggregation arguments, group-by keys
and filter left-hand sides. Function set: add/sub/mult/div arithmetic,
``time_convert(col, fromUnit, toUnit)`` and
``datetime_convert(col, inputFormat, outputFormat, granularity)`` with
"size:UNIT:EPOCH" formats (TimeConversionTransformFunction /
DateTimeConversionTransform).

TPU-first note: expressions are evaluated over *dictionary value tables*
(cardinality-sized numpy arrays) wherever the plan can keep doc-scale work
in the dictId domain — the device kernels never see the transform at all
(see query/plan.py). Row-domain evaluation here is only the host-fallback /
mutable-segment path.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Dict, List, Tuple, Union

import numpy as np

from pinot_tpu_torch.common.timeutils import unit_ms


@dataclasses.dataclass(frozen=True)
class Col:
    name: str


@dataclasses.dataclass(frozen=True)
class Lit:
    text: str           # raw literal text ('...'-quoted strings unwrapped)
    is_string: bool = False


@dataclasses.dataclass(frozen=True)
class Call:
    func: str           # lower-case registered name
    args: Tuple["Expr", ...]


Expr = Union[Col, Lit, Call]

TRANSFORM_FUNCTIONS = {"add", "sub", "mult", "div", "time_convert",
                       "datetime_convert", "valuein"}


def is_transform_function(name: str) -> bool:
    return name.lower() in TRANSFORM_FUNCTIONS


def is_expression(col: str) -> bool:
    """A 'column' string that is really a transform expression."""
    return "(" in col


def valuein_parts(expr_or_text):
    """(column, literal texts) when the expression is
    ``valuein(col, lit, ...)``; None when it isn't a valuein call.
    Malformed valuein calls (non-column first argument, non-literal
    values) raise ExpressionError — both executors share this so the
    device path can never silently accept what the host rejects."""
    expr = parse_expression(expr_or_text) \
        if isinstance(expr_or_text, str) else expr_or_text
    if not (isinstance(expr, Call) and expr.func == "valuein"):
        return None
    if not expr.args or not isinstance(expr.args[0], Col):
        raise ExpressionError("valuein needs a column as its first "
                              "argument")
    lits = []
    for a in expr.args[1:]:
        if not isinstance(a, Lit):
            raise ExpressionError("valuein values must be literals")
        lits.append(a.text)
    return expr.args[0].name, tuple(lits)


# ---------------------------------------------------------------------------
# Parsing (canonical text form: func(arg,arg,...), strings '-quoted)
# ---------------------------------------------------------------------------


class ExpressionError(ValueError):
    pass


def _tokenize(s: str) -> List[str]:
    toks: List[str] = []
    i, n = 0, len(s)
    while i < n:
        c = s[i]
        if c.isspace():
            i += 1
        elif c in "(),":
            toks.append(c)
            i += 1
        elif c == "'":
            j = s.find("'", i + 1)
            if j < 0:
                raise ExpressionError(f"unterminated string in {s!r}")
            toks.append(s[i:j + 1])
            i = j + 1
        else:
            j = i
            while j < n and s[j] not in "(),'" and not s[j].isspace():
                j += 1
            toks.append(s[i:j])
            i = j
    return toks


@functools.lru_cache(maxsize=4096)
def parse_expression(text: str) -> Expr:
    toks = _tokenize(text)
    pos = [0]

    def peek():
        return toks[pos[0]] if pos[0] < len(toks) else None

    def take():
        t = peek()
        pos[0] += 1
        return t

    def parse() -> Expr:
        t = take()
        if t is None:
            raise ExpressionError(f"unexpected end of expression {text!r}")
        if t.startswith("'"):
            return Lit(t[1:-1], is_string=True)
        if peek() == "(":
            take()
            args: List[Expr] = []
            if peek() != ")":
                args.append(parse())
                while peek() == ",":
                    take()
                    args.append(parse())
            if take() != ")":
                raise ExpressionError(f"missing ')' in {text!r}")
            fn = t.lower()
            if fn not in TRANSFORM_FUNCTIONS:
                raise ExpressionError(f"unknown transform function {t!r}")
            return Call(fn, tuple(args))
        if _is_number(t):
            return Lit(t)
        return Col(t)

    expr = parse()
    if pos[0] != len(toks):
        raise ExpressionError(f"trailing input in expression {text!r}")
    return expr


def _is_number(t: str) -> bool:
    try:
        float(t)
        return True
    except ValueError:
        return False


def to_string(expr: Expr) -> str:
    if isinstance(expr, Col):
        return expr.name
    if isinstance(expr, Lit):
        return f"'{expr.text}'" if expr.is_string else expr.text
    return f"{expr.func}({','.join(to_string(a) for a in expr.args)})"


def columns_of(expr_or_text) -> List[str]:
    expr = parse_expression(expr_or_text) \
        if isinstance(expr_or_text, str) else expr_or_text
    out: List[str] = []

    def walk(e: Expr):
        if isinstance(e, Col):
            if e.name not in out:
                out.append(e.name)
        elif isinstance(e, Call):
            for a in e.args:
                walk(a)

    walk(expr)
    return out


def referenced_columns(col: str) -> List[str]:
    """Physical columns behind a select/group/filter item (expression or
    plain column)."""
    if is_expression(col):
        return columns_of(col)
    return [col]


# ---------------------------------------------------------------------------
# Evaluation (vectorized numpy; works on value tables OR row lanes)
# ---------------------------------------------------------------------------


def _arg_str(e: Expr, what: str) -> str:
    if not isinstance(e, Lit):
        raise ExpressionError(f"{what} must be a literal")
    return e.text


def _epoch_format_ms(fmt: str) -> int:
    """'size:UNIT:EPOCH' → milliseconds per tick."""
    parts = fmt.split(":")
    if len(parts) < 3 or parts[2].upper() != "EPOCH":
        raise ExpressionError(
            f"only 'size:UNIT:EPOCH' datetime formats are supported "
            f"(got {fmt!r})")
    return int(parts[0]) * unit_ms(parts[1])


def _granularity_ms(gran: str) -> int:
    parts = gran.split(":")
    return int(parts[0]) * unit_ms(parts[1])


def _trunc_div(a: np.ndarray, b: int) -> np.ndarray:
    """Integer division truncating toward zero (Java semantics), not floor."""
    q = np.abs(a) // b
    return np.where(a >= 0, q, -q)


def evaluate(expr_or_text, resolve: Callable[[str], np.ndarray]
             ) -> np.ndarray:
    """Evaluate over columns provided by `resolve(name) -> np.ndarray`.

    Arithmetic runs in float64 (parity: the reference's arithmetic
    transforms operate on double); time conversions use integer math on
    int64 epochs with truncation toward zero (parity: TimeUnit.convert /
    Java integer division — differs from numpy floor division for
    pre-epoch values).
    """
    expr = parse_expression(expr_or_text) \
        if isinstance(expr_or_text, str) else expr_or_text

    def ev(e: Expr):
        if isinstance(e, Col):
            return resolve(e.name)
        if isinstance(e, Lit):
            return float(e.text) if not e.is_string else e.text
        args = e.args
        if e.func in ("add", "sub", "mult", "div"):
            vals = [np.asarray(ev(a), dtype=np.float64) for a in args]
            out = vals[0]
            for v in vals[1:]:
                if e.func == "add":
                    out = out + v
                elif e.func == "sub":
                    out = out - v
                elif e.func == "mult":
                    out = out * v
                else:
                    out = out / v
            return out
        if e.func == "time_convert":
            v = np.asarray(ev(args[0]), dtype=np.int64)
            src = unit_ms(_arg_str(args[1], "time_convert fromUnit"))
            dst = unit_ms(_arg_str(args[2], "time_convert toUnit"))
            return _trunc_div(v * src, dst)
        if e.func == "datetime_convert":
            v = np.asarray(ev(args[0]), dtype=np.int64)
            in_ms = _epoch_format_ms(_arg_str(args[1], "input format"))
            out_ms = _epoch_format_ms(_arg_str(args[2], "output format"))
            gran_ms = _granularity_ms(_arg_str(args[3], "granularity"))
            ms = v * in_ms
            ms = _trunc_div(ms, gran_ms) * gran_ms
            return _trunc_div(ms, out_ms)
        if e.func == "valuein":
            # MV→MV transform (ValueInTransformFunction): produces a value
            # SET per doc, not a scalar — group-by and MV aggregations
            # handle it in the dictId domain (host_exec._mv_group_source);
            # it has no scalar row-domain evaluation.
            raise ExpressionError(
                "valuein is a multi-value transform; it is only usable as "
                "a group-by key or MV aggregation argument")
        raise ExpressionError(f"unknown transform function {e.func!r}")

    return ev(expr)
