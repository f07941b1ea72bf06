"""Synthetic data generators: in-memory segments for benchmarks and tests.

Counterpart of pinot_tpu/tools/datagen.py, SSB subset. Builds
ImmutableSegment objects directly from numpy arrays — no file round-trip.
All segments of a table share one global dictionary per column.
`make_segment_from_arrays` is the function that carries data across from
the JAX package: it takes the plain arrays a segment holds (sorted
dictionaries, dictIds, raw values) and builds the port's segment.
"""
from __future__ import annotations


from typing import Dict, Optional, Tuple

import numpy as np

from pinot_tpu_torch.common.datatype import DataType
from pinot_tpu_torch.segment.dictionary import Dictionary
from pinot_tpu_torch.segment.loader import DataSource, ImmutableSegment, \
    min_id_dtype
from pinot_tpu_torch.segment.metadata import ColumnMetadata, SegmentMetadata


def _bits_for(card: int) -> int:
    return max(1, int(np.ceil(np.log2(max(card, 2)))))


def make_segment_from_arrays(
        name: str, table: str,
        dict_cols: Dict[str, Tuple[DataType, np.ndarray, np.ndarray]],
        raw_cols: Optional[Dict[str, Tuple[DataType, np.ndarray]]] = None,
        ) -> ImmutableSegment:
    """Build a queryable in-memory segment.

    dict_cols: col → (data_type, sorted_unique_values, dict_ids[int32])
    raw_cols:  col → (data_type, values)  (no-dictionary columns)
    """
    raw_cols = raw_cols or {}
    num_docs = None
    columns: Dict[str, ColumnMetadata] = {}
    sources: Dict[str, DataSource] = {}

    for col, (dt, values, ids) in dict_cols.items():
        ids = np.ascontiguousarray(ids, dtype=np.int32)
        if num_docs is None:
            num_docs = len(ids)
        assert len(ids) == num_docs, f"column {col} length mismatch"
        card = len(values)
        cm = ColumnMetadata(
            name=col, data_type=dt, cardinality=card,
            bits_per_element=_bits_for(card), single_value=True,
            sorted=bool(np.all(ids[1:] >= ids[:-1])) if len(ids) else True,
            has_dictionary=True,
            min_value=values[0] if card else None,
            max_value=values[-1] if card else None,
            total_number_of_entries=num_docs)
        ds = DataSource(cm, None)
        ds.dictionary = Dictionary(dt, values)
        ds.dict_ids = ids
        columns[col] = cm
        sources[col] = ds

    for col, (dt, vals) in raw_cols.items():
        vals = np.ascontiguousarray(vals)
        if num_docs is None:
            num_docs = len(vals)
        assert len(vals) == num_docs, f"column {col} length mismatch"
        cm = ColumnMetadata(
            name=col, data_type=dt, cardinality=num_docs,
            bits_per_element=vals.dtype.itemsize * 8, single_value=True,
            sorted=False, has_dictionary=False,
            min_value=vals.min() if num_docs else None,
            max_value=vals.max() if num_docs else None,
            total_number_of_entries=num_docs)
        ds = DataSource(cm, None)
        ds.raw_values = vals
        columns[col] = cm
        sources[col] = ds

    meta = SegmentMetadata(segment_name=name, table_name=table,
                           total_docs=int(num_docs), columns=columns)
    seg = ImmutableSegment(meta, sources)
    for ds in sources.values():
        ds._segment = seg
    return seg


# ---------------------------------------------------------------------------
# SSB star-schema table, denormalized (flat lineorder) — the layout the
# Star Schema Benchmark Q1.1–Q4.3 queries run against, and the shape the
# reference's contrib/pinot-druid-benchmark flattens TPC-H into.
# ---------------------------------------------------------------------------

SSB_REGIONS = ["AFRICA", "AMERICA", "ASIA", "EUROPE", "MIDDLE EAST"]
SSB_NATIONS = ["ALGERIA", "ARGENTINA", "BRAZIL", "CANADA", "CHINA", "EGYPT",
               "ETHIOPIA", "FRANCE", "GERMANY", "INDIA", "INDONESIA", "IRAN",
               "IRAQ", "JAPAN", "JORDAN", "KENYA", "MOROCCO", "MOZAMBIQUE",
               "PERU", "ROMANIA", "RUSSIA", "SAUDI ARABIA", "UNITED KINGDOM",
               "UNITED STATES", "VIETNAM"]
# TPC-H nation → region (SSB inherits it)
SSB_NATION_REGION = {
    "ALGERIA": "AFRICA", "ETHIOPIA": "AFRICA", "KENYA": "AFRICA",
    "MOROCCO": "AFRICA", "MOZAMBIQUE": "AFRICA",
    "ARGENTINA": "AMERICA", "BRAZIL": "AMERICA", "CANADA": "AMERICA",
    "PERU": "AMERICA", "UNITED STATES": "AMERICA",
    "CHINA": "ASIA", "INDIA": "ASIA", "INDONESIA": "ASIA", "JAPAN": "ASIA",
    "VIETNAM": "ASIA",
    "FRANCE": "EUROPE", "GERMANY": "EUROPE", "ROMANIA": "EUROPE",
    "RUSSIA": "EUROPE", "UNITED KINGDOM": "EUROPE",
    "EGYPT": "MIDDLE EAST", "IRAN": "MIDDLE EAST", "IRAQ": "MIDDLE EAST",
    "JORDAN": "MIDDLE EAST", "SAUDI ARABIA": "MIDDLE EAST",
}
_MONTHS = ["Jan", "Feb", "Mar", "Apr", "May", "Jun", "Jul", "Aug", "Sep",
           "Oct", "Nov", "Dec"]


SSB_TYPES = {
    "lo_quantity": DataType.INT, "lo_discount": DataType.INT,
    "lo_revenue": DataType.LONG, "lo_supplycost": DataType.DOUBLE,
    "d_year": DataType.INT, "d_yearmonthnum": DataType.INT,
    "d_yearmonth": DataType.STRING, "d_weeknuminyear": DataType.INT,
    "c_region": DataType.STRING, "c_nation": DataType.STRING,
    "c_city": DataType.STRING,
    "s_region": DataType.STRING, "s_nation": DataType.STRING,
    "s_city": DataType.STRING,
    "p_mfgr": DataType.STRING, "p_category": DataType.STRING,
    "p_brand1": DataType.STRING,
}
SSB_RAW_COLS = {"lo_supplycost"}


def _city_pool() -> np.ndarray:
    """250 cities: nation name truncated to 9 chars + digit (SSB layout,
    e.g. 'UNITED KI1'). Nations sorted + fixed-width suffix ⇒ the pool is
    lexicographically sorted and city_id == nation_id * 10 + digit."""
    nations = sorted(SSB_NATIONS)
    return np.array([n[:9] + str(d) for n in nations for d in range(10)],
                    dtype=object)


def ssb_pools(seed: int = 0) -> Dict[str, np.ndarray]:
    """Sorted global value pools (== the shared dictionaries)."""
    rng = np.random.default_rng(seed + 10_007)
    revenue = np.unique((rng.integers(100, 10_000, 8192) * 100)
                        .astype(np.int64))
    ymn = np.array(sorted(y * 100 + m for y in range(1992, 1999)
                          for m in range(1, 13)), dtype=np.int64)
    yearmonth = np.array(sorted(f"{_MONTHS[m]}{y}" for y in range(1992, 1999)
                                for m in range(12)), dtype=object)
    nations = np.array(sorted(SSB_NATIONS), dtype=object)
    return {
        "lo_quantity": np.arange(1, 51, dtype=np.int64),
        "lo_discount": np.arange(0, 11, dtype=np.int64),
        "lo_revenue": revenue,
        "d_year": np.arange(1992, 1999, dtype=np.int64),
        "d_yearmonthnum": ymn,
        "d_yearmonth": yearmonth,
        "d_weeknuminyear": np.arange(1, 54, dtype=np.int64),
        "c_region": np.array(sorted(SSB_REGIONS), dtype=object),
        "c_nation": nations,
        "c_city": _city_pool(),
        "s_region": np.array(sorted(SSB_REGIONS), dtype=object),
        "s_nation": nations,
        "s_city": _city_pool(),
        "p_mfgr": np.array([f"MFGR#{m}" for m in range(1, 6)], dtype=object),
        "p_category": np.array([f"MFGR#{m}{c}" for m in range(1, 6)
                                for c in range(1, 6)], dtype=object),
        "p_brand1": np.array([f"MFGR#{m}{c}{b:02d}" for m in range(1, 6)
                              for c in range(1, 6)
                              for b in range(1, 41)], dtype=object),
    }


def ssb_derivation_tables(pools) -> Dict[str, np.ndarray]:
    """Id-domain derivation maps for the correlated dimensions."""
    nations = pools["c_nation"]
    regions = list(pools["c_region"])
    nation_region = np.array(
        [regions.index(SSB_NATION_REGION[n]) for n in nations],
        dtype=np.int32)
    # ymn id (chronological) → d_yearmonth id (lexicographically sorted pool)
    ym_sorted = list(pools["d_yearmonth"])
    ymn_to_ym = np.array(
        [ym_sorted.index(f"{_MONTHS[(int(v) % 100) - 1]}{int(v) // 100}")
         for v in pools["d_yearmonthnum"]], dtype=np.int32)
    return {"nation_region": nation_region, "ymn_to_ym": ymn_to_ym}


def make_ssb_ids(total_rows: int, seed: int = 0
                 ) -> Tuple[Dict[str, np.ndarray], np.ndarray]:
    """Correlated id-domain SSB table: (ids per column, raw supplycost).

    Base draws are uniform; city→nation→region, ymn→year/yearmonth and
    brand→category→mfgr are derived exactly like the star schema's
    functional dependencies."""
    rng = np.random.default_rng(seed)
    pools = ssb_pools(seed)
    maps = ssb_derivation_tables(pools)
    n = total_rows

    def narrow(arr):
        # minimal id dtype: keeps a 100M-row table host-resident
        m = int(arr.max()) if len(arr) else 0
        return arr.astype(min_id_dtype(m))

    ids: Dict[str, np.ndarray] = {}
    ids["lo_quantity"] = narrow(rng.integers(0, 50, n))
    ids["lo_discount"] = narrow(rng.integers(0, 11, n))
    ids["lo_revenue"] = narrow(
        rng.integers(0, len(pools["lo_revenue"]), n))
    ymn = narrow(rng.integers(0, 84, n))
    ids["d_yearmonthnum"] = ymn
    ids["d_year"] = narrow(ymn // 12)
    ids["d_yearmonth"] = narrow(maps["ymn_to_ym"][ymn])
    ids["d_weeknuminyear"] = narrow(rng.integers(0, 53, n))
    for side in ("c", "s"):
        city = narrow(rng.integers(0, 250, n))
        nation = narrow(city // 10)
        ids[f"{side}_city"] = city
        ids[f"{side}_nation"] = nation
        ids[f"{side}_region"] = narrow(maps["nation_region"][nation])
    brand = narrow(rng.integers(0, 1000, n))
    ids["p_brand1"] = brand
    ids["p_category"] = narrow(brand // 40)
    ids["p_mfgr"] = narrow(brand // 200)
    supplycost = (rng.random(n) * 1e5).round(2)
    return ids, supplycost


class SsbTable:
    """Generated table: segments + id-level host arrays for oracle math.

    Oracle checks run on the int32 id arrays (decode via `pools`) so 100M-row
    tables never materialize 100M python-object string columns host-side.
    """

    def __init__(self, segments, pools, ids, supplycost):
        self.segments = segments
        self.pools = pools            # col → sorted values (the dictionary)
        self.ids = ids                # col → int32 [total_rows]
        self.supplycost = supplycost  # raw float64 [total_rows]


def make_ssb_segments(total_rows: int, num_segments: int, seed: int = 0
                      ) -> SsbTable:
    """num_segments equal slices of an SSB table with GLOBAL dictionaries.

    DictIds are generated directly against pre-sorted pools (no
    unique/searchsorted pass over the full table — 100M rows materialize in
    seconds). Same data as the JAX package's generator for the same seed.
    """
    pools = ssb_pools(seed)
    ids, supplycost = make_ssb_ids(total_rows, seed)

    per = total_rows // num_segments
    segments = []
    for i in range(num_segments):
        lo, hi = i * per, (i + 1) * per if i < num_segments - 1 else total_rows
        dict_part = {c: (SSB_TYPES[c], pools[c], ids[c][lo:hi])
                     for c in pools}
        raw_part = {"lo_supplycost": (DataType.DOUBLE, supplycost[lo:hi])}
        segments.append(make_segment_from_arrays(
            f"ssb_{i}", "lineorder", dict_part, raw_part))
    return SsbTable(segments, pools, ids, supplycost)
