"""The baseballStats table, its QueryGenerator traffic and a vectorised
oracle.

Counterpart of the JAX package's randomized integration tier
(tests/fixtures.py, tests/oracle.py and the `Gen` class of
tests/test_query_generator.py, which mirror Pinot's QueryGenerator.java):

- `make_schema` / `make_table_config`: Apache Pinot's quickstart
  `baseballStats` table (STRING dimensions teamID, league, playerName; a
  multi-value STRING position; INT runs, LONG hits, DOUBLE average,
  FLOAT salary without a dictionary; INT time column yearID), inverted
  indexes on teamID and league, a bloom filter on teamID;
- `make_columns`: the same value pools and distributions as the fixture's
  generator, drawn with whole-array numpy calls so that it reaches
  millions of rows (the fixture draws `position` row by row);
- `build_segment_dirs`: segments written by SegmentCreator, each from its
  own seed, so each has its own dictionaries, as a Pinot server sees them;
  `build_raw_key_dir`: one segment with runs, hits and salary written
  without a dictionary (raw group keys); `build_mv_metric_dir`: the JAX
  package's numeric-MV table (baseballStats has no numeric MV column,
  which MINMV, SUMMV and the other MV aggregations need);
- `Gen` and the `*_draws` functions: the generator's aggregation,
  group-by, HAVING, selection, two-key ORDER BY and MV group-by families
  with the reference's seeds, each draw as its PQL and the row mask it
  selects, fixed queries that reach the strategies the draws may miss
  (among them one selection of each select kind and one query per device
  shape of the planner: HLL, MV and expression aggregations, expression,
  MV and valuein keys), the raw-key table's group-bys and the MV metric
  table's aggregations and numeric MV key;
- `Oracle`: the expected answers, computed with array compares, MV
  membership over a padded value matrix, an MV key's entries expanded
  with `np.nonzero` over the value matrix, `np.unique` + `np.add.at` /
  `np.minimum.at` for group-bys, its own evaluation of the transforms,
  and for selections a hash of each row's value codes (the matched
  multiset) and `np.lexsort` (the top-k order keys). It shares no code
  with the planner or the kernels; DISTINCTCOUNTHLL's expected estimate
  is the host HyperLogLog's over the matched distinct values.
"""
from __future__ import annotations

import dataclasses
import os
import random
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from pinot_tpu_torch.common.datatype import DataType
from pinot_tpu_torch.common.schema import (Schema, TimeUnit, dimension,
                                           metric, time_field)
from pinot_tpu_torch.common.table_config import IndexingConfig, TableConfig

TEAMS = ["ANA", "BAL", "BOS", "CHA", "CLE", "DET", "HOU", "KCA", "LAA",
         "MIN", "NYA", "OAK", "SEA", "TBA", "TEX", "TOR"]
LEAGUES = ["AL", "NL"]
POSITIONS = ["P", "C", "1B", "2B", "3B", "SS", "LF", "CF", "RF", "DH"]
PLAYERS = [f"player_{i:03d}" for i in range(997)]

SEED = 20260730          # the reference's generator seed
N_AGG, N_GROUP, N_HAVING, N_SEL, N_ORDER = 14, 12, 6, 12, 8
N_MV_GROUP = 8

#: queries the draws may miss: one per device strategy, the inverted-index
#: COUNT path and a query the pruner answers alone
FIXED_PQLS = {
    "percentile90_runs": "SELECT PERCENTILE90(runs) FROM baseballStats "
                         "WHERE yearID >= 2000",
    "sum_average_hist": "SELECT SUM(average), AVG(average) FROM "
                        "baseballStats WHERE league = 'AL'",
    "minmaxrange_salary": "SELECT MINMAXRANGE(salary), MIN(salary), "
                          "MAX(salary) FROM baseballStats WHERE "
                          "position = 'SS'",
    "in_salary": "SELECT COUNT(*), SUM(salary) FROM baseballStats WHERE "
                 "salary IN ({values})",
    "not_in_salary": "SELECT COUNT(*), MAX(salary) FROM baseballStats "
                     "WHERE salary NOT IN ({values}) AND runs > 100",
    # answered from the inverted index's postings, no kernel
    "count_inverted": "SELECT COUNT(*) FROM baseballStats WHERE teamID IN "
                      "('BOS', 'NYA')",
    # every segment's yearID max is below: the pruner drops them all
    "pruned_years": "SELECT COUNT(*), MAX(salary) FROM baseballStats WHERE "
                    "yearID > 2025",
}


#: one selection per select kind, at full scale: ordertk (a raw float32
#: key), ordermk (a dictionary and a raw key), limit (every column: the MV
#: and raw gathers) and order (three packed dictionary keys, k = 2048,
#: every row)
FIXED_SELECTIONS = {
    "ordertk_salary": ("SELECT playerName, salary FROM baseballStats WHERE "
                       "league = 'NL' ORDER BY salary DESC LIMIT 100"),
    "ordermk_team_salary": ("SELECT teamID, yearID, salary FROM "
                            "baseballStats WHERE runs > 100 ORDER BY "
                            "teamID, salary LIMIT 50"),
    "limit_star": "SELECT * FROM baseballStats WHERE yearID = 2005 LIMIT 20",
    "order_runs_hits_player": ("SELECT runs, hits, playerName FROM "
                               "baseballStats ORDER BY runs DESC, hits DESC, "
                               "playerName LIMIT 2000"),
}
ALL_COLUMNS = ("teamID", "league", "playerName", "position", "runs", "hits",
               "average", "salary", "yearID")


def make_schema() -> Schema:
    return Schema("baseballStats", [
        dimension("teamID", DataType.STRING),
        dimension("league", DataType.STRING),
        dimension("playerName", DataType.STRING),
        dimension("position", DataType.STRING, single_value=False),
        metric("runs", DataType.INT),
        metric("hits", DataType.LONG),
        metric("average", DataType.DOUBLE),
        metric("salary", DataType.FLOAT),
        time_field("yearID", DataType.INT, TimeUnit.DAYS),
    ])


def make_table_config(no_dict: Sequence[str] = ("salary",)) -> TableConfig:
    return TableConfig("baseballStats", indexing_config=IndexingConfig(
        inverted_index_columns=["teamID", "league"],
        bloom_filter_columns=["teamID"],
        no_dictionary_columns=list(no_dict)))


# ---------------------------------------------------------------------------
# Columns in the oracle's form
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Categorical:
    """A single-value string column as a sorted value pool and codes."""
    pool: np.ndarray            # object [k], sorted
    codes: np.ndarray           # int [n]

    def __len__(self) -> int:
        return len(self.codes)


@dataclasses.dataclass
class MultiValue:
    """A multi-value string column: codes [n, W] into the pool, -1 where
    a row has fewer than W values."""
    pool: np.ndarray
    codes: np.ndarray

    def __len__(self) -> int:
        return self.codes.shape[0]

    def lists(self) -> List[list]:
        """The rows as lists of values (the creator's MV input)."""
        counts = (self.codes >= 0).sum(axis=1)
        flat = self.pool[self.codes[self.codes >= 0]].tolist()
        offs = np.concatenate([[0], np.cumsum(counts)]).tolist()
        return [flat[offs[i]:offs[i + 1]] for i in range(len(counts))]


def make_columns(n: int, seed: int = 0) -> Dict[str, object]:
    """The fixture table's pools and distributions, vectorised: teamID,
    league and playerName uniform over their pools, position 1 to 3
    distinct positions in random order, runs in [0, 150), hits in
    [0, 250), average uniform in [0, 1) at 3 decimals, salary uniform
    float32 in [0, 1e6) at 2 decimals, yearID in [1990, 2020)."""
    rng = np.random.default_rng(seed)
    k = len(POSITIONS)
    first = rng.integers(0, k, n)
    second = (first + 1 + rng.integers(0, k - 1, n)) % k
    lo, hi = np.minimum(first, second), np.maximum(first, second)
    third = rng.integers(0, k - 2, n)          # skip the two taken
    third = third + (third >= lo)
    third = third + (third >= hi)
    width = rng.integers(1, 4, n)
    codes = np.stack([first, second, third], axis=1)
    codes[np.arange(3)[None, :] >= width[:, None]] = -1
    pos_pool = np.array(POSITIONS, dtype=object)
    order = np.argsort(pos_pool)               # codes into the sorted pool
    rank = np.empty(k, np.int64)
    rank[order] = np.arange(k)
    codes = np.where(codes >= 0, rank[np.maximum(codes, 0)], -1)
    return {
        "teamID": Categorical(np.array(TEAMS, dtype=object),
                              rng.integers(0, len(TEAMS), n)),
        "league": Categorical(np.array(LEAGUES, dtype=object),
                              rng.integers(0, len(LEAGUES), n)),
        "playerName": Categorical(np.array(PLAYERS, dtype=object),
                                  rng.integers(0, len(PLAYERS), n)),
        "position": MultiValue(pos_pool[order], codes),
        "runs": rng.integers(0, 150, n).astype(np.int32),
        "hits": rng.integers(0, 250, n).astype(np.int64),
        "average": np.round(rng.random(n), 3),
        "salary": (rng.random(n).astype(np.float32) * 1e6).round(2),
        "yearID": rng.integers(1990, 2020, n).astype(np.int32),
    }


def from_fixture_columns(cols: Dict[str, object]) -> Dict[str, object]:
    """Row-built columns (object arrays, lists of lists for MV) → the
    oracle's form."""
    out: Dict[str, object] = {}
    for name, col in cols.items():
        if isinstance(col, list):
            pool = np.array(sorted({v for row in col for v in row}),
                            dtype=object)
            index = {v: i for i, v in enumerate(pool)}
            width = max((len(row) for row in col), default=1)
            codes = np.full((len(col), max(width, 1)), -1, np.int64)
            for i, row in enumerate(col):
                codes[i, :len(row)] = [index[v] for v in row]
            out[name] = MultiValue(pool, codes)
        elif np.asarray(col).dtype.kind == "O":
            pool, codes = np.unique(np.asarray(col), return_inverse=True)
            out[name] = Categorical(pool.astype(object), codes)
        else:
            out[name] = np.asarray(col)
    return out


def creator_columns(cols: Dict[str, object]) -> Dict[str, object]:
    """The oracle's form → SegmentCreator's columnar input."""
    from pinot_tpu_torch.segment.creator import DictionaryEncodedColumn
    out: Dict[str, object] = {}
    for name, col in cols.items():
        if isinstance(col, Categorical):
            out[name] = DictionaryEncodedColumn(col.pool, col.codes)
        elif isinstance(col, MultiValue):
            out[name] = col.lists()
        else:
            out[name] = col
    return out


def build_segment_dirs(base: str, rows: int, segments: int, seed: int = 0
                       ) -> Tuple[List[str], Dict[str, object]]:
    """`segments` segment directories under `base` holding `rows` rows in
    all, segment i made from seed + i; returns (dirs, the whole table in
    the oracle's form)."""
    from pinot_tpu_torch.segment.creator import SegmentCreator
    per = [rows // segments + (i < rows % segments) for i in range(segments)]
    dirs, parts = [], []
    for i, n in enumerate(per):
        cols = make_columns(n, seed + i)
        d = os.path.join(base, f"baseballStats_{i}")
        SegmentCreator(make_schema(), make_table_config(),
                       segment_name=f"baseballStats_{i}").build(
            creator_columns(cols), d)
        dirs.append(d)
        parts.append(cols)
    return dirs, concat_columns(parts)


#: the raw-key table's no-dictionary columns (the JAX
#: tests/test_device_coverage.py shape, with hits raw too): runs and hits
#: group by value - min ("rawoff")
RAW_KEY_NO_DICT = ("salary", "runs", "hits")
#: the raw-key table's rows, in one segment
RAW_KEY_ROWS = 2_500_000


def build_raw_key_dir(base: str, rows: int, seed: int = 0
                      ) -> Tuple[str, Dict[str, object]]:
    """One segment of `rows` rows (the same schema and seed rule as
    build_segment_dirs) with runs, hits and salary written without a
    dictionary; returns (its directory, the table in the oracle's form)."""
    from pinot_tpu_torch.segment.creator import SegmentCreator
    cols = make_columns(rows, seed)
    d = os.path.join(base, "baseballStats_raw")
    SegmentCreator(make_schema(), make_table_config(RAW_KEY_NO_DICT),
                   segment_name="baseballStats_raw").build(
        creator_columns(cols), d)
    return d, cols


#: rows of the MV metric table, in one segment
MV_METRIC_ROWS = 1_000_000


def make_mv_metric_schema() -> Schema:
    """The JAX package's numeric-MV table (tests/test_queries.py:
    test_mv_metric_sum_in_group_by): a STRING key k, a multi-value INT
    scores, an INT metric v."""
    return Schema("mv", [dimension("k", DataType.STRING),
                         dimension("scores", DataType.INT,
                                   single_value=False),
                         metric("v", DataType.INT)])


def make_mv_metric_columns(n: int, seed: int = 0) -> Dict[str, object]:
    """That table's distributions, vectorised: k uniform over a, b and c;
    1 to 3 scores per row, each uniform in [0, 50) (repeats allowed, as
    there); v uniform in [0, 100)."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 50, (n, 3))
    codes[np.arange(3)[None, :] >= rng.integers(1, 4, n)[:, None]] = -1
    return {"k": Categorical(np.array(["a", "b", "c"], dtype=object),
                             rng.integers(0, 3, n)),
            "scores": MultiValue(np.arange(50, dtype=np.int32), codes),
            "v": rng.integers(0, 100, n).astype(np.int32)}


def build_mv_metric_dir(base: str, rows: int, seed: int = 0
                        ) -> Tuple[str, Dict[str, object]]:
    """One segment of the MV metric table, named after its seed; returns
    (its directory, the table in the oracle's form)."""
    from pinot_tpu_torch.segment.creator import SegmentCreator
    cols = make_mv_metric_columns(rows, seed)
    name = f"mv_{seed}"
    d = os.path.join(base, name)
    SegmentCreator(make_mv_metric_schema(), None, segment_name=name).build(
        creator_columns(cols), d)
    return d, cols


def concat_columns(parts: Sequence[Dict[str, object]]) -> Dict[str, object]:
    """Tables in the oracle's form, one after another (codes re-based onto
    the union of the pools)."""
    out: Dict[str, object] = {}
    for name, first in parts[0].items():
        cols = [p[name] for p in parts]
        if isinstance(first, (Categorical, MultiValue)):
            pool = np.array(sorted({v for c in cols for v in c.pool}),
                            dtype=object)
            remapped = []
            for c in cols:
                lut = np.searchsorted(pool, c.pool)
                codes = np.asarray(c.codes)
                remapped.append(np.where(codes >= 0,
                                         lut[np.maximum(codes, 0)], -1))
            if isinstance(first, MultiValue):
                w = max(r.shape[1] for r in remapped)
                remapped = [np.pad(r, ((0, 0), (0, w - r.shape[1])),
                                   constant_values=-1) for r in remapped]
            out[name] = type(first)(pool, np.concatenate(remapped))
        else:
            out[name] = np.concatenate(cols)
    return out


# ---------------------------------------------------------------------------
# The oracle
# ---------------------------------------------------------------------------


#: the largest code space the oracle counts densely (np.bincount) instead
#: of sorting (np.unique takes seconds over tens of millions of rows)
DENSE_CODES = 1 << 22


def _present(codes: np.ndarray, size: int) -> np.ndarray:
    """The distinct values of non-negative int codes below `size`, sorted."""
    if size <= DENSE_CODES:
        return np.nonzero(np.bincount(codes, minlength=size))[0]
    return np.unique(codes)


def _value_bits(arr: np.ndarray) -> np.ndarray:
    """Exact int64 codes of numbers: integers as they are, floats by bits."""
    arr = np.asarray(arr)
    if arr.dtype == np.float32:
        return arr.view(np.int32).astype(np.int64)
    if arr.dtype == np.float64:
        return arr.view(np.int64)
    return arr.astype(np.int64)


class Oracle:
    """Expected answers over the whole table, from whole-array numpy."""

    def __init__(self, cols: Dict[str, object]):
        self.cols = cols
        self.n = len(next(iter(cols.values())))
        self._code_cache: Dict[str, np.ndarray] = {}

    # -- masks -------------------------------------------------------------
    def all(self) -> np.ndarray:
        return np.ones(self.n, dtype=bool)

    def _code(self, col: Categorical, value) -> int:
        i = int(np.searchsorted(col.pool, value))
        return i if i < len(col.pool) and col.pool[i] == value else -2

    def isin(self, name: str, values) -> np.ndarray:
        col = self.cols[name]
        if isinstance(col, (Categorical, MultiValue)):
            # a lookup table over the codes, shifted by one for MV padding
            lut = np.zeros(len(col.pool) + 1, dtype=bool)
            for v in values:
                if self._code(col, v) >= 0:
                    lut[self._code(col, v) + 1] = True
            hit = lut[col.codes + 1]
            return hit if isinstance(col, Categorical) else hit.any(axis=1)
        return np.isin(col, np.asarray(values, dtype=col.dtype))

    def eq(self, name: str, value) -> np.ndarray:
        return self.isin(name, [value])

    def cmp(self, name: str, op: str, value) -> np.ndarray:
        """Numeric compare in the column's own dtype."""
        col = self.cols[name]
        v = col.dtype.type(value)
        return {">": col > v, ">=": col >= v, "<": col < v,
                "<=": col <= v}[op]

    # -- values ------------------------------------------------------------
    def values(self, name: str, m: np.ndarray) -> np.ndarray:
        """The matched rows' values of a column, an MV column's valid
        entries (of a valuein's allowed values only), or a transform."""
        coded = self._coded_values(name, m)
        if coded is not None:
            return coded[0][coded[1]]
        return self.row_values(name)[m]

    def _coded_values(self, name: str, m: np.ndarray
                      ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        """(pool, codes) of values(name, m) for a string or MV column (or
        a valuein over one), else None: counting and distinct values work
        on the codes (np.unique over millions of Python strings takes
        seconds)."""
        vi = _valuein(name)
        col = self.cols.get(vi[0] if vi else name)
        if isinstance(col, Categorical):
            return col.pool, col.codes[m]
        if not isinstance(col, MultiValue):
            return None
        codes = col.codes[m]
        keep = codes >= 0
        if vi is not None:
            keep &= np.isin(col.pool, vi[1])[np.maximum(codes, 0)]
        return col.pool, codes[keep]

    def distinct_values(self, name: str, m: np.ndarray) -> np.ndarray:
        """The distinct values of values(name, m)."""
        coded = self._coded_values(name, m)
        if coded is not None:
            return coded[0][_present(coded[1], len(coded[0]))]
        if name in self.cols:
            pool, codes = self._codes(name)
            return pool[_present(codes[m], len(pool))]
        return np.unique(self.values(name, m))

    def row_values(self, name: str) -> np.ndarray:
        """Per-row values of a single-value column or of a transform over
        numeric columns."""
        if name not in self.cols:
            return _transform(name, self.row_values)
        col = self.cols[name]
        if isinstance(col, Categorical):
            return col.pool[col.codes]
        return col

    def _codes(self, name: str) -> Tuple[np.ndarray, np.ndarray]:
        """(value pool, per-row int64 codes into it) of a single-value
        column or transform; equal values share a code."""
        if name not in self._code_cache:
            col = self.cols.get(name)
            values = None if isinstance(col, Categorical) else \
                self.row_values(name)
            if values is None:
                pool, codes = col.pool, col.codes
            elif values.dtype.kind in "iu" and len(values) and \
                    int(values.max()) - int(values.min()) < DENSE_CODES:
                # integers over a small range: the range is the pool
                lo = int(values.min())
                pool = np.arange(lo, int(values.max()) + 1,
                                 dtype=values.dtype)
                codes = values.astype(np.int64) - lo
            else:
                pool, codes = np.unique(values, return_inverse=True)
            self._code_cache[name] = (pool, np.asarray(codes, np.int64))
        return self._code_cache[name]

    def _expand(self, dims: Sequence[str], m: np.ndarray):
        """The matched rows, repeated once per combination of their MV
        keys' valid entries (a valuein key's allowed ones only), as the
        reference's aggregateGroupByMV counts them: (row index, per dim
        its value pool and codes into it)."""
        rows = np.nonzero(m)[0]
        pools, codes = [], []
        for d in dims:
            vi = _valuein(d)
            col = self.cols.get(vi[0] if vi else d)
            if isinstance(col, MultiValue):
                entries = col.codes[rows]
                keep = entries >= 0
                if vi is not None:
                    keep &= np.isin(col.pool, vi[1])[np.maximum(entries, 0)]
                r_idx, e_idx = np.nonzero(keep)
                rows = rows[r_idx]
                codes = [c[r_idx] for c in codes]
                codes.append(entries[r_idx, e_idx])
                pools.append(col.pool)
            else:
                pool, all_codes = self._codes(d)
                codes.append(all_codes[rows])
                pools.append(pool)
        return rows, pools, codes

    # -- selections --------------------------------------------------------
    def row_codes(self, name: str) -> np.ndarray:
        """int64 [n]: each row's value of `name` as an exact code (pool
        code, integer value, float bits, or an MV row's codes mixed-radix)."""
        col = self.cols[name]
        if isinstance(col, Categorical):
            return np.asarray(col.codes, np.int64)
        if isinstance(col, MultiValue):
            radix = len(col.pool) + 1
            out = np.zeros(len(col), np.int64)
            for j in range(col.codes.shape[1] - 1, -1, -1):
                out = out * radix + (col.codes[:, j] + 1)
            return out
        return _value_bits(col)

    def value_codes(self, name: str, values: Sequence) -> np.ndarray:
        """The codes of row_codes for values as a response returns them."""
        col = self.cols[name]
        if isinstance(col, Categorical):
            return np.array([self._code(col, v) for v in values], np.int64)
        if isinstance(col, MultiValue):
            radix = len(col.pool) + 1
            out = np.zeros(len(values), np.int64)
            for i, row in enumerate(values):
                codes = [self._code(col, v) + 1 for v in row]
                codes += [0] * (col.codes.shape[1] - len(codes))
                for c in reversed(codes):
                    out[i] = out[i] * radix + c
            return out
        return _value_bits(np.asarray(values, dtype=col.dtype))

    def sort_keys(self, name: str) -> np.ndarray:
        """Per-row values in their order: pool codes for strings (the pool
        is sorted), float64 for numbers."""
        col = self.cols[name]
        if isinstance(col, Categorical):
            return np.asarray(col.codes, np.int64)
        return np.asarray(col, np.float64)

    def value_sort_keys(self, name: str, values: Sequence) -> np.ndarray:
        col = self.cols[name]
        if isinstance(col, Categorical):
            return np.array([self._code(col, v) for v in values], np.int64)
        return np.asarray(values, np.float64)

    def top_order_keys(self, m: np.ndarray, order: Sequence[Tuple[str, bool]],
                       limit: int) -> List[np.ndarray]:
        """The order-key values of the first `limit` matched rows by
        `order` ((column, descending) pairs), one array per key."""
        rows = np.nonzero(m)[0]
        keys = [self.sort_keys(c)[rows] for c, _desc in order]
        signed = [-k if desc else k for k, (_c, desc) in zip(keys, order)]
        if len(rows) > limit:
            # the first `limit` rows all sort at or before the limit-th
            # smallest first key: sort only those
            kth = np.partition(signed[0], limit - 1)[limit - 1]
            near = signed[0] <= kth
            keys = [k[near] for k in keys]
            signed = [k[near] for k in signed]
        first = np.lexsort(signed[::-1])[:limit]
        return [k[first] for k in keys]

    # -- aggregations ------------------------------------------------------
    def aggregate(self, name: str, col: Optional[str], m: np.ndarray,
                  q: int = 0):
        """The final value of one aggregation over the rows of m (the
        reference's conventions for an empty match)."""
        if name == "count":
            return int(m.sum())
        if name in ("distinctcount", "distinctcounthll"):
            distinct = self.distinct_values(col, m)
            if name == "distinctcount":
                return len(distinct)
            # the estimate of the matched value set's sketch: the
            # reference's host HyperLogLog over the distinct values
            from pinot_tpu_torch.common.sketches import HyperLogLog
            return int(round(HyperLogLog.from_values(distinct)
                             .cardinality()))
        if name == "countmv":
            return int(len(self._coded_values(col, m)[1]))
        v = self.values(col, m)
        v64 = v.astype(np.float64)
        if name == "sum":
            return float(v64.sum())
        if len(v) == 0:
            return float("inf") if name == "min" else float("-inf")
        if name == "avg":
            return float(v64.mean())
        if name == "min":
            return float(v.min())
        if name == "max":
            return float(v.max())
        if name == "minmaxrange":
            return float(v.max()) - float(v.min())
        if name == "percentile":
            s = np.sort(v64)
            return float(s[min((len(s) * q) // 100, len(s) - 1)])
        raise ValueError(name)

    def group_by(self, dims: Sequence[str], m: np.ndarray,
                 name: str, col: Optional[str]) -> Dict[tuple, object]:
        """{group values: final value} over the matched rows (MV keys
        expand them, see _expand)."""
        rows, pools, codes = self._expand(dims, m)
        if len(rows) == 0:
            return {}
        key = np.zeros(len(rows), np.int64)
        for pool, c in zip(pools, codes):
            key = key * len(pool) + c
        space = int(np.prod([len(p) for p in pools], dtype=np.int64))
        if space <= DENSE_CODES:
            uniq = _present(key, space)
            slot = np.zeros(space, np.int64)
            slot[uniq] = np.arange(len(uniq))
            inv = slot[key]
        else:
            uniq, inv = np.unique(key, return_inverse=True)
        g = len(uniq)
        counts = np.bincount(inv, minlength=g)
        dim_codes, rem = [], uniq
        for pool in reversed(pools):            # the last key is fastest
            dim_codes.append(rem % len(pool))
            rem = rem // len(pool)
        keys = list(zip(*[pool[c] for pool, c in
                          zip(pools, reversed(dim_codes))]))
        if name == "count":
            vals = counts
        elif name == "distinctcount":
            vpool, vc = self._codes(col)
            pairs = _present(inv * len(vpool) + vc[rows], g * len(vpool))
            vals = np.bincount(pairs // len(vpool), minlength=g)
        else:
            v = self.row_values(col)[rows]
            if name in ("sum", "avg"):
                vals = np.zeros(g)
                np.add.at(vals, inv, v.astype(np.float64))
                if name == "avg":
                    vals = vals / counts
            else:
                lo = np.full(g, np.inf)
                hi = np.full(g, -np.inf)
                np.minimum.at(lo, inv, v.astype(np.float64))
                np.maximum.at(hi, inv, v.astype(np.float64))
                vals = {"min": lo, "max": hi, "minmaxrange": hi - lo}[name]
        return {k: (int(x) if name in ("count", "distinctcount")
                    else float(x)) for k, x in zip(keys, vals)}


def _call(text: str) -> Tuple[str, List[str]]:
    """'f(a, g(b, 1))' → ('f', ['a', 'g(b, 1)'])."""
    i = text.index("(")
    args, depth, cur = [], 0, ""
    for ch in text[i + 1:text.rindex(")")]:
        if ch == "," and depth == 0:
            args.append(cur.strip())
            cur = ""
            continue
        depth += (ch == "(") - (ch == ")")
        cur += ch
    args.append(cur.strip())
    return text[:i].strip().lower(), args


def _valuein(name: str) -> Optional[Tuple[str, List[str]]]:
    """(column, allowed values) of 'valuein(col, 'a', ...)', else None."""
    if not name.lower().startswith("valuein("):
        return None
    _f, args = _call(name)
    return args[0], [a.strip("'") for a in args[1:]]


def _transform(text: str, column) -> np.ndarray:
    """The oracle's own evaluation of the transforms the mix uses: add /
    sub / mult / div in float64 over columns and numbers, and
    datetime_convert from and to '1:DAYS:EPOCH' at an 'N:DAYS'
    granularity (days truncated to a multiple of N)."""
    func, args = _call(text)

    def arg(a):
        if "(" in a:
            return _transform(a, column)
        try:
            return float(a)
        except ValueError:
            return np.asarray(column(a), np.float64)

    if func in ("add", "sub", "mult", "div"):
        out = arg(args[0])
        for a in args[1:]:
            v = arg(a)
            out = {"add": np.add, "sub": np.subtract, "mult": np.multiply,
                   "div": np.divide}[func](out, v)
        return out
    if func == "datetime_convert" and args[1:3] == ["'1:DAYS:EPOCH'"] * 2:
        n, unit = args[3].strip("'").split(":")
        if unit == "DAYS":
            days = np.asarray(column(args[0]), np.int64)
            return days // int(n) * int(n)
    raise ValueError(f"the oracle has no transform {text}")


# ---------------------------------------------------------------------------
# The generator: tests/test_query_generator.py:Gen, draw for draw
# ---------------------------------------------------------------------------

#: (PQL, oracle name, column, tolerance) — tolerance "exact" or "float"
AGGS = [
    ("COUNT(*)", "count", None, "exact"),
    ("SUM(runs)", "sum", "runs", "exact"),
    ("SUM(hits)", "sum", "hits", "exact"),
    ("SUM(salary)", "sum", "salary", "float"),
    ("MIN(runs)", "min", "runs", "exact"),
    ("MIN(average)", "min", "average", "exact"),
    ("MAX(hits)", "max", "hits", "exact"),
    ("MAX(salary)", "max", "salary", "exact"),
    ("AVG(runs)", "avg", "runs", "float"),
    ("AVG(hits)", "avg", "hits", "float"),
    ("MINMAXRANGE(runs)", "minmaxrange", "runs", "exact"),
    ("DISTINCTCOUNT(teamID)", "distinctcount", "teamID", "exact"),
    ("DISTINCTCOUNT(yearID)", "distinctcount", "yearID", "exact"),
    ("DISTINCTCOUNT(playerName)", "distinctcount", "playerName", "exact"),
]
FLOAT_RTOL = 1e-9        # float sums: float64 in another order


class Gen:
    """The reference generator's draws (same `random.Random` calls in the
    same order), each predicate as its PQL and its vectorised mask."""

    def __init__(self, rng: random.Random, oracle: Oracle):
        self.rng = rng
        self.oracle = oracle

    def predicate(self) -> Tuple[str, np.ndarray]:
        r, o = self.rng, self.oracle
        kind = r.choice(["eq_team", "neq_league", "in_team", "not_in_team",
                         "between_year", "range_year", "range_runs",
                         "range_hits", "range_salary", "eq_player",
                         "eq_position_mv"])
        if kind == "eq_team":
            v = r.choice(TEAMS)
            return f"teamID = '{v}'", o.eq("teamID", v)
        if kind == "neq_league":
            v = r.choice(["AL", "NL"])
            return f"league <> '{v}'", ~o.eq("league", v)
        if kind == "in_team":
            vs = r.sample(TEAMS, r.randint(2, 5))
            lst = ", ".join(f"'{v}'" for v in vs)
            return f"teamID IN ({lst})", o.isin("teamID", vs)
        if kind == "not_in_team":
            vs = r.sample(TEAMS, r.randint(2, 4))
            lst = ", ".join(f"'{v}'" for v in vs)
            return f"teamID NOT IN ({lst})", ~o.isin("teamID", vs)
        if kind == "between_year":
            a = r.randint(1990, 2015)
            b = a + r.randint(0, 10)
            return (f"yearID BETWEEN {a} AND {b}",
                    o.cmp("yearID", ">=", a) & o.cmp("yearID", "<=", b))
        if kind == "range_year":
            v = r.randint(1992, 2018)
            op = r.choice([">", ">=", "<", "<="])
            return f"yearID {op} {v}", o.cmp("yearID", op, v)
        if kind == "range_runs":
            v = r.randint(5, 140)
            op = r.choice([">", ">=", "<", "<="])
            return f"runs {op} {v}", o.cmp("runs", op, v)
        if kind == "range_hits":
            v = r.randint(10, 240)
            op = r.choice([">", "<"])
            return f"hits {op} {v}", o.cmp("hits", op, v)
        if kind == "range_salary":
            v = round(r.uniform(1e4, 9e5), 2)
            op = r.choice([">", "<"])
            return f"salary {op} {v}", o.cmp("salary", op, v)
        if kind == "eq_player":
            v = f"player_{r.randint(0, 996):03d}"
            return f"playerName = '{v}'", o.eq("playerName", v)
        v = r.choice(["P", "C", "1B", "SS", "CF"])
        return f"position = '{v}'", o.eq("position", v)

    def where(self) -> Tuple[str, np.ndarray]:
        """0-3 predicates joined by AND or OR; returns (sql, mask)."""
        r = self.rng
        k = r.randint(0, 3)
        if k == 0:
            return "", self.oracle.all()
        preds = [self.predicate() for _ in range(k)]
        joiner = r.choice([" AND ", " OR "])
        masks = [p[1] for p in preds]
        mask = np.logical_and.reduce(masks) if joiner == " AND " else \
            np.logical_or.reduce(masks)
        return " WHERE " + joiner.join(p[0] for p in preds), mask

    def aggs(self):
        return self.rng.sample(AGGS, self.rng.randint(1, 3))


@dataclasses.dataclass(eq=False)
class Draw:
    family: str                  # aggregation | group_by | having |
    pql: str                     # selection | order_by
    mask: np.ndarray
    aggs: list                   # entries of AGGS
    dims: Tuple[str, ...] = ()
    having: Optional[Tuple[str, int]] = None
    columns: Tuple[str, ...] = ()              # a selection's columns,
    limit: int = 0                             # its LIMIT
    order: Tuple[Tuple[str, bool], ...] = ()   # and (column, descending)
    host: bool = False           # a shape the JAX planner refuses

    @property
    def is_selection(self) -> bool:
        return bool(self.columns)

    @property
    def host_answered(self) -> bool:
        """The planner refuses these (as the JAX planner does) and the
        host twin answers them: group-by DISTINCTCOUNT, and the fixed
        shapes marked `host` (an MV expression aggregation)."""
        return self.host or (self.family == "group_by" and any(
            a[1] == "distinctcount" for a in self.aggs))


def aggregation_draws(oracle: Oracle, n: int = N_AGG, seed: int = SEED
                      ) -> Iterator[Draw]:
    gen = Gen(random.Random(seed), oracle)
    for _ in range(n):
        where, m = gen.where()
        aggs = gen.aggs()
        pql = ("SELECT " + ", ".join(a[0] for a in aggs) +
               " FROM baseballStats" + where)
        yield Draw("aggregation", pql, m, aggs)


def group_by_draws(oracle: Oracle, n: int = N_GROUP, seed: int = SEED + 1
                   ) -> Iterator[Draw]:
    gen = Gen(random.Random(seed), oracle)
    for _ in range(n):
        where, m = gen.where()
        aggs = gen.aggs()
        dims = gen.rng.sample(["teamID", "league", "yearID"],
                              gen.rng.randint(1, 2))
        pql = ("SELECT " + ", ".join(a[0] for a in aggs) +
               " FROM baseballStats" + where +
               " GROUP BY " + ", ".join(dims) + " TOP 2000")
        yield Draw("group_by", pql, m, aggs, tuple(dims))


def having_draws(oracle: Oracle, n: int = N_HAVING, seed: int = SEED + 3
                 ) -> Iterator[Draw]:
    gen = Gen(random.Random(seed), oracle)
    for _ in range(n):
        where, m = gen.where()
        dims = gen.rng.sample(["teamID", "league"], 1)
        thresh = gen.rng.randint(5, 200)
        op = gen.rng.choice([">", "<="])
        pql = ("SELECT COUNT(*) FROM baseballStats" + where +
               " GROUP BY " + dims[0] +
               f" HAVING COUNT(*) {op} {thresh} TOP 2000")
        yield Draw("having", pql, m, [AGGS[0]], tuple(dims), (op, thresh))


def selection_draws(oracle: Oracle, n: int = N_SEL, seed: int = SEED + 2
                    ) -> Iterator[Draw]:
    """The reference's random selection family: 1-3 columns, LIMIT 5-20,
    half of them ORDER BY one numeric column."""
    gen = Gen(random.Random(seed), oracle)
    for _ in range(n):
        where, m = gen.where()
        cols = gen.rng.sample(["teamID", "runs", "hits", "yearID"],
                              gen.rng.randint(1, 3))
        limit = gen.rng.randint(5, 20)
        order = ()
        if gen.rng.random() < 0.5:
            ocol = gen.rng.choice(["runs", "hits", "yearID"])
            desc = gen.rng.random() < 0.5
            if ocol not in cols:
                cols = cols + [ocol]
            order = ((ocol, desc),)
        pql = "SELECT " + ", ".join(cols) + " FROM baseballStats" + where
        if order:
            pql += f" ORDER BY {ocol} {'DESC' if desc else 'ASC'}"
        pql += f" LIMIT {limit}"
        yield Draw("selection", pql, m, [], columns=tuple(cols),
                   limit=limit, order=order)


def order_by_draws(oracle: Oracle, n: int = N_ORDER, seed: int = SEED + 9
                   ) -> Iterator[Draw]:
    """The reference's random two-key ORDER BY family (mixed ASC / DESC,
    LIMIT 5-15)."""
    gen = Gen(random.Random(seed), oracle)
    for _ in range(n):
        where, m = gen.where()
        o1, o2 = gen.rng.sample(["runs", "hits", "yearID"], 2)
        d1 = gen.rng.random() < 0.5
        d2 = gen.rng.random() < 0.5
        limit = gen.rng.randint(5, 15)
        pql = (f"SELECT {o1}, {o2} FROM baseballStats{where} "
               f"ORDER BY {o1} {'DESC' if d1 else 'ASC'}, "
               f"{o2} {'DESC' if d2 else 'ASC'} LIMIT {limit}")
        yield Draw("order_by", pql, m, [], columns=(o1, o2), limit=limit,
                   order=((o1, d1), (o2, d2)))


def mv_group_by_draws(oracle: Oracle, n: int = N_MV_GROUP,
                      seed: int = SEED + 7) -> Iterator[Draw]:
    """The reference's random MV group-by family
    (tests/test_query_generator.py:test_random_mv_group_by_queries):
    COUNT(*) and SUM(hits) grouped by position or by valuein(position,
    2-5 of its values), half of them with league as a second key."""
    gen = Gen(random.Random(seed), oracle)
    pos = oracle.cols["position"]
    all_pos = sorted(pos.pool[_present(pos.codes[pos.codes >= 0],
                                       len(pos.pool))])
    aggs = [AGGS[0], AGGS[2]]
    for _ in range(n):
        where, m = gen.where()
        if gen.rng.random() < 0.5:
            picks = gen.rng.sample(all_pos, gen.rng.randint(2, 5))
            mvkey = "valuein(position, %s)" % \
                ", ".join("'%s'" % p for p in picks)
        else:
            mvkey = "position"
        extra_sv = gen.rng.choice([None, "league"])
        dims = [mvkey] + ([extra_sv] if extra_sv else [])
        pql = ("SELECT COUNT(*), SUM(hits) FROM baseballStats" + where +
               " GROUP BY " + ", ".join(dims) + " TOP 5000")
        yield Draw("group_by", pql, m, aggs, tuple(dims))


#: one query per device shape of the aggregation / group-by planner that
#: the generator's families miss: device HLL (K7), the MV entry histogram
#: (K4), expression aggregations and keys (one with colliding keys), MV
#: and valuein keys (K3), and an MV expression aggregation the JAX planner
#: refuses (the host twin answers it)
SHAPE_PQLS = {
    "hll": "SELECT DISTINCTCOUNTHLL(playerName), DISTINCTCOUNTHLL(teamID) "
           "FROM baseballStats WHERE yearID >= 2000",
    "countmv": "SELECT COUNTMV(position), DISTINCTCOUNTMV(position) FROM "
               "baseballStats WHERE league = 'NL'",
    "expression_aggs": "SELECT SUM(mult(runs,2)), MIN(add(mult(runs,2),1)) "
                       "FROM baseballStats WHERE teamID = 'BOS'",
    "expression_key": "SELECT COUNT(*), SUM(runs) FROM baseballStats "
                      "GROUP BY div(yearID,10) TOP 100",
    "colliding_expression_key": (
        "SELECT COUNT(*), SUM(hits) FROM baseballStats WHERE runs > 50 "
        "GROUP BY datetime_convert(yearID,'1:DAYS:EPOCH','1:DAYS:EPOCH',"
        "'5:DAYS') TOP 100"),
    "position_league": "SELECT COUNT(*), SUM(runs), MIN(hits) FROM "
                       "baseballStats WHERE yearID < 2005 GROUP BY "
                       "position, league TOP 100",
    "valuein_team": "SELECT COUNT(*), AVG(runs) FROM baseballStats GROUP BY "
                    "valuein(position, 'P', 'C', 'SS'), teamID TOP 1000",
    "countmv_valuein": "SELECT COUNTMV(valuein(position, 'P', 'C')) FROM "
                       "baseballStats WHERE league = 'AL'",
}


def shape_draws(oracle: Oracle) -> Iterator[Draw]:
    """SHAPE_PQLS with their masks and oracle aggregations."""
    o = oracle
    agg = {a[0]: a for a in AGGS}
    q = SHAPE_PQLS
    yield Draw("aggregation", q["hll"], o.cmp("yearID", ">=", 2000), [
        ("DISTINCTCOUNTHLL(playerName)", "distinctcounthll", "playerName",
         "exact"),
        ("DISTINCTCOUNTHLL(teamID)", "distinctcounthll", "teamID",
         "exact")])
    yield Draw("aggregation", q["countmv"], o.eq("league", "NL"), [
        ("COUNTMV(position)", "countmv", "position", "exact"),
        ("DISTINCTCOUNTMV(position)", "distinctcount", "position",
         "exact")])
    yield Draw("aggregation", q["expression_aggs"], o.eq("teamID", "BOS"), [
        ("SUM(mult(runs,2))", "sum", "mult(runs,2)", "exact"),
        ("MIN(add(mult(runs,2),1))", "min", "add(mult(runs,2),1)",
         "exact")])
    yield Draw("group_by", q["expression_key"], o.all(),
               [agg["COUNT(*)"], agg["SUM(runs)"]], ("div(yearID,10)",))
    yield Draw("group_by", q["colliding_expression_key"],
               o.cmp("runs", ">", 50), [agg["COUNT(*)"], agg["SUM(hits)"]],
               ("datetime_convert(yearID,'1:DAYS:EPOCH','1:DAYS:EPOCH',"
                "'5:DAYS')",))
    yield Draw("group_by", q["position_league"], o.cmp("yearID", "<", 2005),
               [agg["COUNT(*)"], agg["SUM(runs)"],
                ("MIN(hits)", "min", "hits", "exact")],
               ("position", "league"))
    yield Draw("group_by", q["valuein_team"], o.all(),
               [agg["COUNT(*)"], agg["AVG(runs)"]],
               ("valuein(position, 'P', 'C', 'SS')", "teamID"))
    yield Draw("aggregation", q["countmv_valuein"], o.eq("league", "AL"),
               [("COUNTMV(valuein(position, 'P', 'C'))", "countmv",
                 "valuein(position, 'P', 'C')", "exact")], host=True)


#: group-bys over the raw-key table (build_raw_key_dir): runs spans 150
#: values and hits 250, each keyed by value - min
RAW_KEY_PQLS = {
    "runs": "SELECT COUNT(*), SUM(salary) FROM baseballStats GROUP BY runs "
            "TOP 200",
    "hits_league": "SELECT COUNT(*), SUM(runs) FROM baseballStats WHERE "
                   "yearID >= 2000 GROUP BY hits, league TOP 1000",
    "runs_min_hits": "SELECT MIN(hits), MAX(runs) FROM baseballStats WHERE "
                     "league = 'AL' GROUP BY runs TOP 200",
}


def raw_key_draws(oracle: Oracle) -> Iterator[Draw]:
    """RAW_KEY_PQLS over the raw-key table's oracle."""
    o = oracle
    agg = {a[0]: a for a in AGGS}
    yield Draw("group_by", RAW_KEY_PQLS["runs"], o.all(),
               [agg["COUNT(*)"], agg["SUM(salary)"]], ("runs",))
    yield Draw("group_by", RAW_KEY_PQLS["hits_league"],
               o.cmp("yearID", ">=", 2000),
               [agg["COUNT(*)"], agg["SUM(runs)"]], ("hits", "league"))
    yield Draw("group_by", RAW_KEY_PQLS["runs_min_hits"],
               o.eq("league", "AL"),
               [("MIN(hits)", "min", "hits", "exact"),
                ("MAX(runs)", "max", "runs", "exact")], ("runs",))


#: the MV metric table's queries: every MV aggregation over a numeric MV
#: column (K5's MV min / max, K4's entry histogram and their finishers)
#: and a numeric MV group key
MV_METRIC_PQLS = {
    "aggs": "SELECT MINMV(scores), MAXMV(scores), MINMAXRANGEMV(scores), "
            "SUMMV(scores), AVGMV(scores), PERCENTILE50MV(scores) FROM mv "
            "WHERE k = 'a'",
    "counts": "SELECT COUNTMV(scores), DISTINCTCOUNTMV(scores), COUNT(*) "
              "FROM mv WHERE v >= 50",
    "key": "SELECT COUNT(*), SUM(v) FROM mv WHERE k <> 'c' GROUP BY scores "
           "TOP 100",
}


def mv_metric_draws(oracle: Oracle) -> Iterator[Draw]:
    """MV_METRIC_PQLS over the MV metric table's oracle."""
    o = oracle
    q = MV_METRIC_PQLS
    yield Draw("aggregation", q["aggs"], o.eq("k", "a"), [
        ("MINMV(scores)", "min", "scores", "exact"),
        ("MAXMV(scores)", "max", "scores", "exact"),
        ("MINMAXRANGEMV(scores)", "minmaxrange", "scores", "exact"),
        ("SUMMV(scores)", "sum", "scores", "exact"),
        ("AVGMV(scores)", "avg", "scores", "float"),
        ("PERCENTILE50MV(scores)", "percentile", "scores", "exact")])
    yield Draw("aggregation", q["counts"], o.cmp("v", ">=", 50), [
        ("COUNTMV(scores)", "countmv", "scores", "exact"),
        ("DISTINCTCOUNTMV(scores)", "distinctcount", "scores", "exact"),
        ("COUNT(*)", "count", None, "exact")])
    yield Draw("group_by", q["key"], ~o.eq("k", "c"), [
        ("COUNT(*)", "count", None, "exact"),
        ("SUM(v)", "sum", "v", "exact")], ("scores",))


def fixed_selection_draws(oracle: Oracle) -> Iterator[Draw]:
    """FIXED_SELECTIONS with their masks, columns and order."""
    o = oracle
    specs = {
        "ordertk_salary": (o.eq("league", "NL"), ("playerName", "salary"),
                           100, (("salary", True),)),
        "ordermk_team_salary": (o.cmp("runs", ">", 100),
                                ("teamID", "yearID", "salary"), 50,
                                (("teamID", False), ("salary", False))),
        "limit_star": (o.eq("yearID", 2005), ALL_COLUMNS, 20, ()),
        "order_runs_hits_player": (o.all(), ("runs", "hits", "playerName"),
                                   2000, (("runs", True), ("hits", True),
                                          ("playerName", False))),
    }
    for name, (m, cols, limit, order) in specs.items():
        yield Draw("selection", FIXED_SELECTIONS[name], m, [],
                   columns=cols, limit=limit, order=order)


def fixed_draws(oracle: Oracle) -> Iterator[Draw]:
    """FIXED_PQLS with their masks; the salary IN lists take values the
    table holds, and one it does not."""
    salary = oracle.cols["salary"]
    picks = [float(salary[0]), float(salary[len(salary) // 2]), 0.5]
    values = ", ".join(repr(v) for v in picks)
    agg = {a[0]: a for a in AGGS}
    extra = {
        "percentile90_runs": ("PERCENTILE90(runs)", "percentile", "runs",
                              "exact"),
        "sum_average_hist": ("SUM(average)", "sum", "average", "float"),
        "avg_average": ("AVG(average)", "avg", "average", "float"),
        "mmr_salary": ("MINMAXRANGE(salary)", "minmaxrange", "salary",
                       "exact"),
        "min_salary": ("MIN(salary)", "min", "salary", "exact"),
    }
    in_mask = oracle.isin("salary", picks)
    yield Draw("aggregation", FIXED_PQLS["percentile90_runs"],
               oracle.cmp("yearID", ">=", 2000),
               [extra["percentile90_runs"]])
    yield Draw("aggregation", FIXED_PQLS["sum_average_hist"],
               oracle.eq("league", "AL"),
               [extra["sum_average_hist"], extra["avg_average"]])
    yield Draw("aggregation", FIXED_PQLS["minmaxrange_salary"],
               oracle.eq("position", "SS"),
               [extra["mmr_salary"], extra["min_salary"],
                agg["MAX(salary)"]])
    yield Draw("aggregation", FIXED_PQLS["in_salary"].format(values=values),
               in_mask, [agg["COUNT(*)"], agg["SUM(salary)"]])
    yield Draw("aggregation",
               FIXED_PQLS["not_in_salary"].format(values=values),
               ~in_mask & oracle.cmp("runs", ">", 100),
               [agg["COUNT(*)"], agg["MAX(salary)"]])
    yield Draw("aggregation", FIXED_PQLS["count_inverted"],
               oracle.isin("teamID", ["BOS", "NYA"]), [agg["COUNT(*)"]])
    yield Draw("aggregation", FIXED_PQLS["pruned_years"],
               oracle.cmp("yearID", ">", 2025),
               [agg["COUNT(*)"], agg["MAX(salary)"]])


def all_draws(oracle: Oracle) -> Iterator[Tuple[str, Draw]]:
    """Every draw of the mix with its family for reporting: the draw's own,
    "mv_group_by" for the MV group-by family, "fixed" for FIXED_PQLS,
    "fixed_selection" for FIXED_SELECTIONS or "shapes" for SHAPE_PQLS.
    The raw-key table's draws (raw_key_draws) and the MV metric table's
    (mv_metric_draws) need their own tables."""
    for gen in (aggregation_draws, group_by_draws, having_draws,
                selection_draws, order_by_draws):
        for draw in gen(oracle):
            yield draw.family, draw
    for draw in mv_group_by_draws(oracle):
        yield "mv_group_by", draw
    for draw in fixed_draws(oracle):
        yield "fixed", draw
    for draw in fixed_selection_draws(oracle):
        yield "fixed_selection", draw
    for draw in shape_draws(oracle):
        yield "shapes", draw


def batch_draws(oracle: Oracle) -> Dict[str, List[Draw]]:
    """Families of same-shape queries with varied literals, for
    execute_batch: the JAX tests' BATCH_PQLS (tests/test_batching.py:123),
    a min / max / average family (K5 over raw and id lanes), a selection
    family (ORDER BY salary, K6's ordertk), a DISTINCTCOUNTHLL family (K4
    and K7), and a mixed batch: two of BATCH_PQLS, a member whose literal
    no dictionary holds (a fast path) and two group-bys, which run one by
    one."""
    o = oracle
    agg = {a[0]: a for a in AGGS}
    count_hits = [agg["COUNT(*)"], agg["SUM(hits)"]]

    def runs_over(v):
        return Draw("aggregation", "SELECT COUNT(*), SUM(hits) FROM "
                    f"baseballStats WHERE runs > '{v}'", o.cmp("runs", ">", v),
                    count_hits)

    hll = ("DISTINCTCOUNTHLL(playerName)", "distinctcounthll",
           "playerName", "exact")
    return {
        "batch_pqls": [runs_over(v) for v in (10, 40, 75, 110, 130)],
        "min_max": [
            Draw("aggregation", "SELECT MIN(salary), AVG(salary), "
                 "MINMAXRANGE(runs) FROM baseballStats WHERE yearID = "
                 f"{y}", o.eq("yearID", y),
                 [("MIN(salary)", "min", "salary", "exact"),
                  ("AVG(salary)", "avg", "salary", "float"),
                  ("MINMAXRANGE(runs)", "minmaxrange", "runs", "exact")])
            for y in range(1995, 2003)],
        "selection": [
            Draw("selection", "SELECT playerName, salary FROM baseballStats "
                 f"WHERE yearID = {y} ORDER BY salary DESC LIMIT 50",
                 o.eq("yearID", y), [], columns=("playerName", "salary"),
                 limit=50, order=(("salary", True),))
            for y in range(2001, 2009)],
        "hll": [Draw("aggregation", "SELECT DISTINCTCOUNTHLL(playerName), "
                     f"COUNT(*) FROM baseballStats WHERE teamID = '{t}'",
                     o.eq("teamID", t), [hll, agg["COUNT(*)"]])
                for t in TEAMS[:8]],
        "mixed": [
            runs_over(10), runs_over(40),
            Draw("aggregation", "SELECT COUNT(*), SUM(hits) FROM "
                 "baseballStats WHERE teamID = 'ZZZ'", o.eq("teamID", "ZZZ"),
                 count_hits),
            Draw("group_by", "SELECT COUNT(*), SUM(hits) FROM baseballStats "
                 "WHERE runs > 50 GROUP BY league TOP 100",
                 o.cmp("runs", ">", 50), count_hits, ("league",)),
            Draw("group_by", "SELECT COUNT(*), SUM(runs) FROM baseballStats "
                 "WHERE yearID >= 2010 GROUP BY teamID TOP 100",
                 o.cmp("yearID", ">=", 2010),
                 [agg["COUNT(*)"], agg["SUM(runs)"]], ("teamID",))],
    }


# ---------------------------------------------------------------------------
# Checking a response
# ---------------------------------------------------------------------------


def _percentile_q(pql_fn: str) -> int:
    digits = "".join(ch for ch in pql_fn.split("(")[0] if ch.isdigit())
    return int(digits) if digits else 0


def _close(got: float, want: float, tol: str) -> bool:
    if tol == "exact":
        return got == want
    return abs(got - want) <= FLOAT_RTOL * max(abs(want), 1e-300)


def expected(oracle: Oracle, draw: Draw) -> list:
    """Per aggregation: a value (aggregation family) or a {group: value}
    dict (group_by / having)."""
    out = []
    for fn, name, col, _tol in draw.aggs:
        q = _percentile_q(fn)
        if draw.family == "aggregation":
            out.append(oracle.aggregate(name, col, draw.mask, q))
            continue
        groups = oracle.group_by(draw.dims, draw.mask, name, col)
        groups = {tuple(str(k) for k in key): v
                  for key, v in groups.items()}
        if draw.having is not None:
            op, thresh = draw.having
            groups = {k: v for k, v in groups.items()
                      if (v > thresh if op == ">" else v <= thresh)}
        out.append(groups)
    return out


def _hash_rows(codes: Sequence[np.ndarray]) -> np.ndarray:
    """uint64 hash of each row's tuple of int64 codes."""
    h = np.zeros(len(codes[0]), np.uint64)
    with np.errstate(over="ignore"):
        for c in codes:
            h = h * np.uint64(0x9E3779B97F4A7C15) + c.astype(np.uint64)
            h ^= h >> np.uint64(29)
    return h


def check_selection(resp, oracle: Oracle, draw: Draw) -> None:
    """The reference harness's selection checks: the row count is
    min(LIMIT, matched), every row is in the matched rows' multiset, and
    the rows' order-key values equal the oracle's top LIMIT."""
    res = resp.selection_results
    if res is None or list(res.columns) != list(draw.columns):
        raise AssertionError(f"{draw.pql}: columns "
                             f"{None if res is None else res.columns}")
    rows = res.results
    matched = int(draw.mask.sum())
    if len(rows) != min(draw.limit, matched):
        raise AssertionError(f"{draw.pql}: {len(rows)} rows, want "
                             f"{min(draw.limit, matched)}")
    if not rows:
        return
    cols = list(draw.columns)
    got = _hash_rows([oracle.value_codes(c, [r[i] for r in rows])
                      for i, c in enumerate(cols)])
    have = _hash_rows([oracle.row_codes(c)[draw.mask] for c in cols])
    # how often each returned row's hash occurs among the matched rows
    g_uniq, g_counts = np.unique(got, return_counts=True)
    pos = np.minimum(np.searchsorted(g_uniq, have), len(g_uniq) - 1)
    hit = g_uniq[pos] == have
    counts = np.bincount(pos[hit], minlength=len(g_uniq))
    if not (counts >= g_counts).all():
        raise AssertionError(f"{draw.pql}: a row is not among the matched "
                             "rows")
    if draw.order:
        want = oracle.top_order_keys(draw.mask, draw.order, draw.limit)
        for (col, _desc), w in zip(draw.order, want):
            i = cols.index(col)
            g = oracle.value_sort_keys(col, [r[i] for r in rows])
            if not np.array_equal(g, w):
                raise AssertionError(f"{draw.pql}: ORDER BY {col} values "
                                     "differ from the oracle's top rows")


def check(resp, oracle: Oracle, draw: Draw) -> None:
    """Raise AssertionError unless `resp` answers `draw` as the oracle
    does: counts, DISTINCTCOUNT, MIN / MAX / MINMAXRANGE, PERCENTILE and
    integer sums exactly, float sums and averages within FLOAT_RTOL. As in
    the reference's harness, an aggregation other than COUNT over no rows
    is not compared (its empty-result sentinel has golden tests).
    Selections: check_selection."""
    if resp.exceptions:
        raise AssertionError(f"{draw.pql}: {resp.exceptions}")
    if draw.is_selection:
        check_selection(resp, oracle, draw)
        return
    want = expected(oracle, draw)
    matched = int(draw.mask.sum())
    for i, ((_fn, name, _col, tol), w) in enumerate(zip(draw.aggs, want)):
        res = resp.aggregation_results[i]
        if draw.family == "aggregation":
            if name != "count" and matched == 0:
                continue
            got = float(res.value)
            if name in ("count", "distinctcount"):
                tol = "exact"
            if not _close(got, float(w), tol):
                raise AssertionError(f"{draw.pql}: agg {i} got {got}, "
                                     f"want {w}")
            continue
        got = {tuple(str(k) for k in g["group"]): float(g["value"])
               for g in res.group_by_result}
        if set(got) != set(w):
            raise AssertionError(f"{draw.pql}: agg {i} groups differ "
                                 f"({len(got)} vs {len(w)})")
        for key, v in w.items():
            if not _close(got[key], float(v), tol):
                raise AssertionError(f"{draw.pql}: agg {i} group {key} "
                                     f"got {got[key]}, want {v}")

