"""Synthetic data generators: in-memory segments for benchmarks and tests.

Counterpart of pinot_tpu/tools/datagen.py: the SSB table in memory, on
disk through the SegmentCreator (with the nine star-tree cubes of the
JAX bench) and synthesized on the card by K17 (`make_ssb_device_stack`,
bit for bit the JAX function's lanes, and `SynthStack`, the stacked
executor's view of them), and the join tables (`lineorderj` x `part`).
Builds
ImmutableSegment objects directly from numpy arrays — no file round-trip.
All segments of a table share one global dictionary per column.
`make_segment_from_arrays` is the function that carries data across from
the JAX package: it takes the plain arrays a segment holds (sorted
dictionaries, dictIds, raw values) and builds the port's segment.
"""
from __future__ import annotations


from typing import Dict, List, Optional, Sequence, Tuple

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


def ssb_schema():
    """Schema for the flat lineorder table (creator/loader path)."""
    from pinot_tpu_torch.common.schema import Schema, dimension, metric
    fields = []
    for col, dt in SSB_TYPES.items():
        if col.startswith("lo_"):
            fields.append(metric(col, dt))
        else:
            fields.append(dimension(col, dt))
    return Schema("lineorder", fields)


# Star-tree cube configs for the SSB query classes (parity: the reference
# benchmark's star-tree segment variant, contrib/pinot-druid-benchmark
# config/; functional dependencies — city→nation→region, brand→category→
# mfgr — keep the actual group counts far below the dimension product).
# Split orders put each query class's FILTER dims first: cube rows are
# sorted by split order, so the executor's prefix descent narrows to
# contiguous blocks by binary search (the classic split-order guidance —
# most-filtered dimensions first). A copy of pinot_tpu/tools/datagen.py:
# SSB_STAR_TREE_CONFIGS.
SSB_STAR_TREE_CONFIGS = [
    {"dimensionsSplitOrder": ["s_region", "p_brand1", "d_year",
                              "p_category"],
     "metrics": ["lo_revenue"]},                      # Q2.2-2.3
    # Q2.1's EQ pair (s_region, p_category) leads its own cube so the
    # prefix descent lands on tens of rows instead of a region-block
    # residual scan (the chooser ranks by prefix depth, so Q2.2/2.3
    # keep the brand1-leading cube above)
    {"dimensionsSplitOrder": ["s_region", "p_category", "p_brand1",
                              "d_year"],
     "metrics": ["lo_revenue"]},                      # Q2.1
    {"dimensionsSplitOrder": ["c_region", "s_region", "c_nation",
                              "s_nation", "d_year"],
     "metrics": ["lo_revenue"]},                      # Q3.1
    {"dimensionsSplitOrder": ["c_nation", "s_nation", "c_city", "s_city",
                              "d_year"],
     "metrics": ["lo_revenue"]},                      # Q3.2
    {"dimensionsSplitOrder": ["c_city", "s_city", "d_year"],
     "metrics": ["lo_revenue"]},                      # Q3.3
    {"dimensionsSplitOrder": ["c_region", "s_region", "p_mfgr", "d_year",
                              "c_nation"],
     "metrics": ["lo_revenue", "lo_supplycost"]},     # Q4.1
    {"dimensionsSplitOrder": ["c_region", "s_region", "p_mfgr", "d_year",
                              "s_nation", "p_category"],
     "metrics": ["lo_revenue", "lo_supplycost"]},     # Q4.2
    # Q3.4/Q4.3: cubes whose row counts approach the segment's — useless
    # for scans, but the exact-prefix descents (c_city IN / region+
    # nation+category EQ) touch only tens of rows; maxSize raised past
    # the default cap because the scan-payoff heuristic doesn't apply
    {"dimensionsSplitOrder": ["c_city", "s_city", "d_yearmonth",
                              "d_year"],
     "metrics": ["lo_revenue"], "maxSize": 8_000_000},        # Q3.4
    {"dimensionsSplitOrder": ["c_region", "s_nation", "p_category",
                              "d_year", "s_city", "p_brand1"],
     "metrics": ["lo_revenue", "lo_supplycost"],
     "maxSize": 12_000_000},                                  # Q4.3
]


def ssb_table_config(star_tree: bool = False):
    from pinot_tpu_torch.common.table_config import IndexingConfig, \
        TableConfig
    return TableConfig("lineorder", indexing_config=IndexingConfig(
        no_dictionary_columns=sorted(SSB_RAW_COLS),
        star_tree_configs=list(SSB_STAR_TREE_CONFIGS) if star_tree
        else []))


def build_ssb_segment_dirs(base_dir: str, total_rows: int,
                           num_segments: int, seed: int = 0,
                           log=None, star_tree: bool = False
                           ) -> Tuple[List[str], Dict, np.ndarray]:
    """Full storage path: rows → SegmentCreator → segment dirs on disk
    (pinot_tpu/tools/datagen.py:build_ssb_segment_dirs, the same rows,
    dictionaries and cubes; the JAX function's shared_dictionaries option
    needs fixed dictionaries, which the port's creator does not build).

    Each segment builds its OWN dictionaries from its own rows — exactly
    what the reference's per-segment SegmentDictionaryCreator produces —
    and the stacked executor's stack-time union remap handles the
    differing id domains. `star_tree=True` builds the nine
    SSB_STAR_TREE_CONFIGS cubes into each segment.
    Returns (segment_dirs, ids, supplycost) — ids feed the numpy oracle."""
    import os

    from pinot_tpu_torch.segment.creator import DictionaryEncodedColumn, \
        SegmentCreator

    pools = ssb_pools(seed)
    ids, supplycost = make_ssb_ids(total_rows, seed)
    schema = ssb_schema()
    config = ssb_table_config(star_tree=star_tree)
    per = total_rows // num_segments
    dirs = []
    for i in range(num_segments):
        lo = i * per
        hi = (i + 1) * per if i < num_segments - 1 else total_rows
        cols = {}
        for c in SSB_TYPES:
            if c in SSB_RAW_COLS:
                cols[c] = supplycost[lo:hi]
            else:
                # dictionary-encoded columnar input: the creator still
                # builds a PER-SEGMENT dictionary of only this slice's
                # present values (byte-identical segments to the decoded
                # path) without hashing row-scale strings
                cols[c] = DictionaryEncodedColumn(pools[c], ids[c][lo:hi])
        d = os.path.join(base_dir, f"ssb_{i}")
        SegmentCreator(schema, config, segment_name=f"ssb_{i}").build(cols, d)
        dirs.append(d)
        if log:
            log(f"datagen: built segment {i + 1}/{num_segments} "
                f"({hi - lo} rows) via SegmentCreator")
    return dirs, ids, supplycost


#: rows of make_ssb_device_stack's plan table (pinot_tpu/tools/datagen.py)
BLOCK_ROWS = 16384


def make_ssb_device_stack(total_rows: int, num_segments: int, mesh=None,
                          seed: int = 0):
    """Stacked SSB lanes synthesized on the mesh's device by K17
    (ops/synth.py), equal bit for bit to
    pinot_tpu/tools/datagen.py:make_ssb_device_stack with the same
    arguments on a mesh of as many devices: the same pools, key chain,
    `s_total` rounding, `padded_size(per)`, lane names and dtypes
    (`min_id_dtype(card)`). Returns (lanes, num_docs, plan_table, padded):
    `lanes` maps "col.ids" / "lo_revenue.parts" / "lo_supplycost.raw" to
    [S, P] tensors (parts [S, n_parts, P], a view of the port's
    [n_parts, S, P] stacked lane), `num_docs` is int32 [S] on the device
    (`per` for each real segment, 0 for padding segments) and
    `plan_table` a small host SsbTable with the same dictionaries that
    plans build against. `mesh`: parallel.make_mesh()'s tuple (the card
    when None)."""
    import torch

    from pinot_tpu_torch.ops import synth
    from pinot_tpu_torch.parallel.sharded import make_mesh
    from pinot_tpu_torch.segment.loader import padded_size

    mesh = make_mesh() if mesh is None else tuple(mesh)
    per = total_rows // num_segments
    padded = padded_size(per)
    s_total = -(-num_segments // len(mesh)) * len(mesh)
    plan_table = make_ssb_segments(max(BLOCK_ROWS, 2 * padded_size(1)), 1,
                                   seed=seed)
    keys, tables, dtypes = ssb_synth_inputs(seed, mesh[0])
    out = synth.ssb_synth(keys, tables, s_total, padded, dtypes)
    lanes = {f"{c}.ids": out[c] for c in synth.SYNTH_LANES}
    lanes["lo_revenue.parts"] = out["parts"].permute(1, 0, 2)
    lanes["lo_supplycost.raw"] = out["lo_supplycost"]
    num_docs = torch.zeros(s_total, dtype=torch.int32)
    num_docs[:num_segments] = per
    return lanes, num_docs.to(mesh[0]), plan_table, padded


def ssb_synth_inputs(seed: int, device):
    """K17's inputs for `seed` (ops/synth.py), on `device`: (keys, tables,
    dtypes). The keys are JAX's chain from PRNGKey(seed) with the pools'
    cardinalities as spans; the tables are the derivation maps and
    lo_revenue's 7-bit part table over its dictionary (the plan table's,
    the pool itself); each id lane's dtype is min_id_dtype(card), as the
    JAX function narrows it."""
    import torch

    from pinot_tpu_torch.ops import synth
    from pinot_tpu_torch.segment.loader import int_part_info_for, \
        int_part_table

    pools = ssb_pools(seed)
    maps = ssb_derivation_tables(pools)
    rev = pools["lo_revenue"]
    n_parts, min_v = int_part_info_for(rev)

    def int8(arr):
        return torch.from_numpy(np.ascontiguousarray(
            arr, dtype=np.int8)).to(device)

    tables = synth.SynthTables(
        int8(maps["ymn_to_ym"]), int8(maps["nation_region"]),
        int8(int_part_table(rev, n_parts, min_v)[:, :len(rev)]))
    keys = synth.ssb_synth_keys(
        seed, [len(pools[c]) for c in synth.SYNTH_DRAWS])
    dtypes = {c: torch.from_numpy(np.zeros(0, min_id_dtype(len(pools[c])))
                                  ).dtype for c in synth.SYNTH_LANES}
    return keys, tables, dtypes


class SynthStack:
    """The stacked executor's view of a synthesized SSB stack
    (parallel/sharded.py:ShardedQueryExecutor.execute_stack), the port's
    counterpart of bench.py's lane-override stack (:1067-1090): plans
    build against `plan_table.segments[0]` (the same global
    dictionaries) and `gather` hands out make_ssb_device_stack's lanes.
    The JAX stack also adds replicated dictionary value tables ("vals")
    on demand; the port's SSB plans read none (their sums are 7-bit part
    lanes and the raw lo_supplycost lane), so a lane the synthesis did
    not make raises KeyError."""

    def __init__(self, lanes, num_docs, plan_table, padded: int):
        self.segments = plan_table.segments
        self.padded_docs = padded
        self.n_real = int(num_docs.shape[0])
        self.num_docs = num_docs.cpu().numpy()
        self._dev_num_docs = num_docs
        self._lanes = dict(lanes)

    def gather(self, needed_cols):
        out = {}
        for col, kind in needed_cols:
            key = f"{col}.{kind}"
            if key not in self._lanes:
                raise KeyError(f"the synthesized stack has no {key}")
            lane = self._lanes[key]
            # the kernels read part lanes as [n_parts, S, P]
            out[key] = lane.permute(1, 0, 2) if kind == "parts" else lane
        return out

    def device_num_docs(self):
        return self._dev_num_docs

    def union_column(self, col: str):
        return None                 # one set of global dictionaries

    def plan_segment(self):
        return self.segments[0]

    def device_bytes(self) -> int:
        """Bytes the synthesized lanes hold on the device (the parts'
        view counted once)."""
        return sum(t.numel() * t.element_size()
                   for t in self._lanes.values())


# ---------------------------------------------------------------------------
# Star-schema JOIN tables: a `part` dim table × a `lineorderj` fact table
# (the normalized shape the multi-stage join engine serves), copied from
# pinot_tpu/tools/datagen.py:346-520 with the same schema, distributions
# and seeds, so both packages build the same rows.
# ---------------------------------------------------------------------------


def part_dim_schema():
    from pinot_tpu_torch.common.schema import Schema, dimension
    return Schema("part", [
        dimension("p_partkey", DataType.INT),
        dimension("p_mfgr", DataType.STRING),
        dimension("p_category", DataType.STRING),
        dimension("p_brand1", DataType.STRING),
    ])


def fact_join_schema():
    from pinot_tpu_torch.common.schema import Schema, dimension, metric
    return Schema("lineorderj", [
        dimension("lo_partkey", DataType.INT),
        dimension("d_year", DataType.INT),
        metric("lo_quantity", DataType.INT),
        metric("lo_revenue", DataType.LONG),
    ])


def join_table_configs(num_partitions: int = 0):
    """(fact config, dim config); `num_partitions` > 0 partitions BOTH
    tables on their join keys (Modulo) — the co-partitioned dispatch
    shape."""
    from pinot_tpu_torch.common.table_config import IndexingConfig, TableConfig
    part_cfg = {"functionName": "Modulo",
                "numPartitions": num_partitions}
    fact_idx = IndexingConfig(
        segment_partition_config={"lo_partkey": dict(part_cfg)}
        if num_partitions else {})
    dim_idx = IndexingConfig(
        segment_partition_config={"p_partkey": dict(part_cfg)}
        if num_partitions else {})
    return (TableConfig("lineorderj", indexing_config=fact_idx),
            TableConfig("part", indexing_config=dim_idx))


def make_join_rows(fact_rows: int, dim_rows: int = 800, seed: int = 0,
                   miss_rate: float = 0.1) -> Tuple[Dict, Dict]:
    """(dim columns, fact columns) as plain arrays (oracle-friendly).

    Dim keys are a NON-CONTIGUOUS sorted sample (probes must not
    degenerate to offsets) with SSB-style brand→category→mfgr
    functional dependencies; `miss_rate` of fact keys reference no dim
    row (inner-join drops them).
    """
    rng = np.random.default_rng(seed + 40_009)
    keys = np.sort(rng.choice(np.arange(1, dim_rows * 7, dtype=np.int64),
                              size=dim_rows, replace=False))
    brand_id = rng.integers(0, 1000, dim_rows)
    dim = {
        "p_partkey": keys.astype(np.int32),
        "p_brand1": np.array(
            [f"MFGR#{b // 200 + 1}{(b // 40) % 5 + 1}{b % 40 + 1:02d}"
             for b in brand_id], dtype=object),
        "p_category": np.array(
            [f"MFGR#{b // 200 + 1}{(b // 40) % 5 + 1}" for b in brand_id],
            dtype=object),
        "p_mfgr": np.array([f"MFGR#{b // 200 + 1}" for b in brand_id],
                           dtype=object),
    }
    n = fact_rows
    fact_key = keys[rng.integers(0, dim_rows, n)].astype(np.int64)
    miss = rng.random(n) < miss_rate
    # miss keys: values guaranteed absent from the dim key set
    fact_key[miss] = -fact_key[miss] - 1
    fact = {
        "lo_partkey": fact_key.astype(np.int32),
        "d_year": rng.integers(1992, 1999, n).astype(np.int32),
        "lo_quantity": rng.integers(1, 51, n).astype(np.int32),
        "lo_revenue": (rng.integers(100, 10_000, n) * 100).astype(
            np.int64),
    }
    return dim, fact


def build_join_table_dirs(base_dir: str, fact_rows: int,
                          num_fact_segments: int, dim_rows: int = 800,
                          num_dim_segments: int = 1, seed: int = 0,
                          num_partitions: int = 0
                          ) -> Tuple[List[str], List[str], Dict, Dict]:
    """Segment dirs for the join tables via the real storage path.

    With `num_partitions` > 0, rows are partition-aligned: each segment
    holds exactly one Modulo partition's rows (per-segment partition
    metadata becomes discriminating, the co-partitioned exchange shape).
    Returns (fact_dirs, dim_dirs, dim columns, fact columns).
    """
    import os

    from pinot_tpu_torch.segment.creator import SegmentCreator

    dim, fact = make_join_rows(fact_rows, dim_rows, seed)
    fact_cfg, dim_cfg = join_table_configs(num_partitions)

    def build(schema, cfg, cols, key_col, n_segs, prefix):
        n = len(cols[key_col])
        if num_partitions:
            pids = np.abs(cols[key_col].astype(np.int64)) % num_partitions
            slices = [np.nonzero(pids == p)[0]
                      for p in range(num_partitions)]
        else:
            per = -(-n // n_segs)
            slices = [np.arange(i * per, min((i + 1) * per, n))
                      for i in range(n_segs)]
        dirs = []
        for i, rows in enumerate(slices):
            if not len(rows):
                continue
            d = os.path.join(base_dir, f"{prefix}_{i}")
            sub = {c: (v[rows] if isinstance(v, np.ndarray)
                       else [v[j] for j in rows])
                   for c, v in cols.items()}
            SegmentCreator(schema, cfg,
                           segment_name=f"{prefix}_{i}").build(sub, d)
            dirs.append(d)
        return dirs

    fact_dirs = build(fact_join_schema(), fact_cfg, fact, "lo_partkey",
                      num_fact_segments, "factj")
    dim_dirs = build(part_dim_schema(), dim_cfg, dim, "p_partkey",
                     num_dim_segments, "partd")
    return fact_dirs, dim_dirs, dim, fact


def join_probe(dim: Dict, fact: Dict) -> Tuple[np.ndarray, np.ndarray]:
    """(hit bool [n], dim row int64 [n]) of every fact row's part key:
    whether the dim side holds it, and at which row. A dense lookup table
    where the keys span fewer than 2^26 values (the generator's do), else
    a searchsorted of the sorted keys; the same arrays either way."""
    keys = dim["p_partkey"].astype(np.int64)
    fk = fact["lo_partkey"].astype(np.int64)
    if not len(keys):
        return np.zeros(len(fk), bool), np.zeros(len(fk), np.int64)
    lo, hi = int(keys.min()), int(keys.max())
    if hi - lo < 1 << 26:
        lut = np.full(hi - lo + 1, -1, np.int64)
        lut[keys - lo] = np.arange(len(keys))
        inside = (fk >= lo) & (fk <= hi)
        dimrow = np.where(inside, lut[np.clip(fk - lo, 0, hi - lo)], -1)
        hit = dimrow >= 0
        # a miss reads the row of the key searchsorted would clip to
        order = np.argsort(keys, kind="stable")
        miss_pos = np.clip(np.searchsorted(keys[order], fk[~hit]), 0,
                           len(keys) - 1)
        dimrow[~hit] = order[miss_pos]
        return hit, dimrow
    order = np.argsort(keys, kind="stable")
    skeys = keys[order]
    pos = np.clip(np.searchsorted(skeys, fk), 0, len(skeys) - 1)
    return skeys[pos] == fk, order[pos]


def join_oracle(dim: Dict, fact: Dict, dim_filter=None,
                group_cols: Sequence[str] = (),
                agg: str = "sum_revenue", probe=None) -> Dict:
    """Independent numpy oracle for the join smoke/bench parity gates:
    inner-join fact×dim on the part key, optional dim-side row mask
    (callable dim→bool [D]), group by (qualified) columns, aggregate
    SUM(lo_revenue)+COUNT. `probe`: join_probe(dim, fact), when the caller
    reuses it across queries of one table."""
    hit, dimrow = join_probe(dim, fact) if probe is None else probe
    if dim_filter is not None:
        hit = hit & dim_filter(dim)[dimrow]
    rows = np.nonzero(hit)[0]
    out: Dict = {"count": int(len(rows)),
                 "sum_revenue": int(fact["lo_revenue"][rows].sum())}
    if group_cols:
        # grouped with array ops where the JAX oracle loops over rows in
        # Python (the same groups and sums; seconds less at 60M rows):
        # each lane coded by np.unique (a dim column over the dim table,
        # then gathered), the codes joined mixed-radix, int64 sums
        codes, uniqs = [], []
        for c in group_cols:
            if c.startswith("part."):
                u, inv = np.unique(dim[c[5:]], return_inverse=True)
                code = inv.reshape(-1)[dimrow[rows]]
            else:
                u, code = np.unique(fact[c.split(".", 1)[-1]][rows],
                                    return_inverse=True)
            uniqs.append(u)
            codes.append(code.reshape(-1).astype(np.int64))
        key = np.zeros(len(rows), np.int64)
        for u, code in zip(uniqs, codes):
            key = key * max(len(u), 1) + code
        gkeys, ginv = np.unique(key, return_inverse=True)
        sums = np.zeros(len(gkeys), np.int64)
        np.add.at(sums, ginv.reshape(-1),
                  fact["lo_revenue"][rows].astype(np.int64))
        counts = np.bincount(ginv.reshape(-1), minlength=len(gkeys))
        groups: Dict[tuple, tuple] = {}
        for g, k in enumerate(gkeys):
            vals = []
            for u in reversed(uniqs):
                vals.append(u[k % max(len(u), 1)])
                k //= max(len(u), 1)
            groups[tuple(reversed(vals))] = (int(sums[g]), int(counts[g]))
        out["groups"] = groups
    return out
