"""Aggregation functions: device-partial → intermediate → merge → final.

Parity: pinot-core/.../query/aggregation/function/AggregationFunction.java SPI
(aggregate → merge → extractFinalResult) and the factory's function set
(AggregationFunctionFactory): COUNT, SUM, MIN, MAX, AVG, MINMAXRANGE,
DISTINCTCOUNT, PERCENTILE<q>. Intermediate custom objects (AvgPair,
MinMaxRangePair — .../customobject/) are plain tuples here.

Exactness note (TPU-first design): for dictionary-encoded columns the device
returns an int32 dictId histogram, and SUM/AVG/PERCENTILE/DISTINCTCOUNT are
finished host-side in float64 against the (small) dictionary — bit-exact
regardless of device float width. MIN/MAX come back as dictIds (sorted
dictionary ⇒ order-preserving). Only raw no-dictionary columns aggregate in
device floats.
"""
from __future__ import annotations

import dataclasses
import math
import re
from typing import Dict, List, Optional, Tuple

import numpy as np

from pinot_tpu_torch.common.sketches import HyperLogLog, TDigest

_PERCENTILE_RE = re.compile(
    r"^(PERCENTILE|PERCENTILEEST|PERCENTILETDIGEST)(\d+)(MV)?$")


@dataclasses.dataclass(frozen=True)
class AggFunctionInfo:
    base: str              # COUNT / SUM / ... / PERCENTILE
    percentile: int = 0
    is_mv: bool = False


def parse_function_name(name: str) -> AggFunctionInfo:
    up = name.upper()
    is_mv = False
    if up.endswith("MV"):
        m = _PERCENTILE_RE.match(up)
        if m is None:
            is_mv = True
            up = up[:-2]
    m = _PERCENTILE_RE.match(up)
    if m:
        return AggFunctionInfo(m.group(1), int(m.group(2)),
                               bool(m.group(3)) or is_mv)
    return AggFunctionInfo(up, 0, is_mv)


class AggregationFunction:
    """One aggregation column's host-side semantics."""

    def __init__(self, name: str, column: str):
        self.name = name.upper()
        self.column = column
        self.info = parse_function_name(self.name)
        base = self.info.base
        if base not in ("COUNT", "SUM", "MIN", "MAX", "AVG", "MINMAXRANGE",
                        "DISTINCTCOUNT", "DISTINCTCOUNTHLL", "PERCENTILE",
                        "PERCENTILEEST", "PERCENTILETDIGEST", "FASTHLL",
                        "DISTINCTCOUNTRAWHLL"):
            raise ValueError(f"unsupported aggregation function {name}")

    @property
    def result_name(self) -> str:
        return f"{self.name.lower()}({self.column})"

    # -- intermediate construction (from device outputs, host finishers) ---
    def from_histogram(self, hist: np.ndarray, dict_values: np.ndarray):
        """hist: int32 per-dictId counts (len >= cardinality)."""
        base = self.info.base
        card = len(dict_values)
        h = np.asarray(hist[:card], dtype=np.int64)
        if base == "SUM":
            return float(np.dot(h, np.asarray(dict_values, dtype=np.float64)))
        if base == "AVG":
            s = float(np.dot(h, np.asarray(dict_values, dtype=np.float64)))
            return (s, int(h.sum()))
        if base == "DISTINCTCOUNT":
            nz = np.nonzero(h)[0]
            return set(_plain(dict_values[i]) for i in nz)
        if base in ("DISTINCTCOUNTHLL", "FASTHLL", "DISTINCTCOUNTRAWHLL"):
            # sketch intermediate: mergeable across segments/servers with
            # non-shared dictionaries (ObjectSerDeUtils HyperLogLog parity)
            nz = np.nonzero(h)[0]
            return HyperLogLog.from_values(np.asarray(dict_values)[nz])
        if base == "PERCENTILE":
            nz = np.nonzero(h)[0]
            out: Dict = {}
            for i in nz:
                # accumulate: transformed dictionaries can map several ids
                # to one value (non-injective transforms)
                k = _plain(dict_values[i])
                out[k] = out.get(k, 0) + int(h[i])
            return out
        if base in ("PERCENTILEEST", "PERCENTILETDIGEST"):
            nz = np.nonzero(h)[0]
            return TDigest.from_values(
                np.asarray(dict_values, dtype=np.float64)[nz],
                weights=h[nz])
        if base in ("MIN", "MAX", "MINMAXRANGE"):
            # expression path: transformed values are not id-ordered, so
            # extremes come from the histogram's support
            nz = np.nonzero(h)[0]
            if len(nz) == 0:
                return None if base != "MINMAXRANGE" else (None, None)
            present = np.asarray(dict_values, dtype=np.float64)[nz]
            mn, mx = float(present.min()), float(present.max())
            if base == "MIN":
                return mn
            if base == "MAX":
                return mx
            return (mn, mx)
        raise ValueError(f"{self.name} cannot be built from a histogram")

    def from_minmax_ids(self, min_id: Optional[int], max_id: Optional[int],
                        dict_values: np.ndarray):
        base = self.info.base
        card = len(dict_values)
        mn = (None if min_id is None or min_id >= card
              else float(dict_values[min_id]))
        mx = (None if max_id is None or max_id < 0
              else float(dict_values[max_id]))
        if base == "MIN":
            return mn
        if base == "MAX":
            return mx
        if base == "MINMAXRANGE":
            return (mn, mx)
        raise ValueError(base)

    # -- merge across segments / servers ----------------------------------
    def merge(self, a, b):
        base = self.info.base
        if a is None:
            return b
        if b is None:
            return a
        if base == "COUNT":
            return a + b
        if base == "SUM":
            return a + b
        if base == "MIN":
            return min(a, b)
        if base == "MAX":
            return max(a, b)
        if base == "AVG":
            return (a[0] + b[0], a[1] + b[1])
        if base == "MINMAXRANGE":
            mn = a[0] if b[0] is None else (b[0] if a[0] is None
                                            else min(a[0], b[0]))
            mx = a[1] if b[1] is None else (b[1] if a[1] is None
                                            else max(a[1], b[1]))
            return (mn, mx)
        if base == "DISTINCTCOUNT":
            return a | b
        if base in ("DISTINCTCOUNTHLL", "FASTHLL", "DISTINCTCOUNTRAWHLL"):
            return a.merge(b)
        if base == "PERCENTILE":
            out = dict(a)
            for k, v in b.items():
                out[k] = out.get(k, 0) + v
            return out
        if base in ("PERCENTILEEST", "PERCENTILETDIGEST"):
            return a.merge(b)
        raise ValueError(base)

    # -- final result ------------------------------------------------------
    def extract_final(self, intermediate):
        base = self.info.base
        if intermediate is None:
            return self.empty_result()
        if base == "COUNT":
            return int(intermediate)
        if base == "SUM":
            return float(intermediate)
        if base == "MIN":
            return float(intermediate) if intermediate is not None \
                else float("inf")
        if base == "MAX":
            return float(intermediate) if intermediate is not None \
                else float("-inf")
        if base == "AVG":
            s, c = intermediate
            return float("-inf") if c == 0 else s / c
        if base == "MINMAXRANGE":
            mn, mx = intermediate
            if mn is None or mx is None:
                return float("-inf")
            return mx - mn
        if base == "DISTINCTCOUNT":
            return len(intermediate)
        if base == "DISTINCTCOUNTRAWHLL":
            # serialized-sketch result (DistinctCountRawHLL parity): the
            # client merges/estimates; hex like SerializedHLL.toString()
            return intermediate.to_bytes().hex()
        if base in ("DISTINCTCOUNTHLL", "FASTHLL"):
            return int(round(intermediate.cardinality()))
        if base == "PERCENTILE":
            return self._percentile_from_counts(intermediate)
        if base in ("PERCENTILEEST", "PERCENTILETDIGEST"):
            if intermediate.total_weight == 0:
                return float("-inf")
            return intermediate.quantile(self.info.percentile / 100.0)
        raise ValueError(base)

    _UNSET = object()

    def sortable_final(self, intermediate, final=_UNSET) -> float:
        """Numeric ordering key for top-N / trim over group results.

        DISTINCTCOUNTRAWHLL's final value is a hex string, but it must
        order by the estimate (Pinot's SerializedHLL is Comparable by
        cardinality); everything else orders by its numeric final.
        Callers that already extracted the final pass it to avoid
        recomputing (percentile extraction sorts per group).
        """
        if self.info.base == "DISTINCTCOUNTRAWHLL":
            return 0.0 if intermediate is None \
                else float(intermediate.cardinality())
        v = self.extract_final(intermediate) if final is self._UNSET \
            else final
        return v if isinstance(v, (int, float)) else float("-inf")

    def empty_result(self):
        base = self.info.base
        if base == "COUNT":
            return 0
        if base == "DISTINCTCOUNTRAWHLL":
            return HyperLogLog().to_bytes().hex()
        if base in ("DISTINCTCOUNT", "DISTINCTCOUNTHLL", "FASTHLL"):
            return 0
        if base == "MIN":
            return float("inf")
        return float("-inf")

    def _percentile_from_counts(self, counts: Dict) -> float:
        """Exact percentile from a value→count map.

        Parity: PercentileAggregationFunction sorts the collected values and
        takes element ``(int)(size * percentile / 100)`` (clamped).
        """
        if not counts:
            return float("-inf")
        items = sorted(counts.items())
        total = sum(c for _, c in items)
        target = min((total * self.info.percentile) // 100, total - 1)
        acc = 0
        for v, c in items:
            acc += c
            if acc > target:
                return float(v)
        return float(items[-1][0])


def _plain(v):
    if isinstance(v, np.generic):
        return v.item()
    return v


def make_functions(aggregations) -> List[AggregationFunction]:
    return [AggregationFunction(a.function_name, a.column)
            for a in aggregations]
