"""The 13 Star Schema Benchmark queries and their numpy oracle.

SSB (O'Neil et al., Star Schema Benchmark, rev. 3) Q1.1-Q4.3 over the
flattened lineorder table of tools/datagen.py, in the PQL the JAX
package's bench.py runs. `make_cpu_queries` is a vectorized numpy
evaluation over the id-domain columns, independent of the engine;
`canon_response` turns a BrokerResponse into the oracle's result shape
and `check` compares the two.
"""
from __future__ import annotations

import numpy as np


SSB_PQLS = {
    "q1.1": "SELECT SUM(lo_revenue) FROM lineorder WHERE d_year = 1993 AND "
            "lo_discount BETWEEN 1 AND 3 AND lo_quantity < 25",
    "q1.2": "SELECT SUM(lo_revenue) FROM lineorder WHERE d_yearmonthnum = "
            "199401 AND lo_discount BETWEEN 4 AND 6 AND lo_quantity "
            "BETWEEN 26 AND 35",
    "q1.3": "SELECT SUM(lo_revenue) FROM lineorder WHERE d_weeknuminyear = "
            "6 AND d_year = 1994 AND lo_discount BETWEEN 5 AND 7 AND "
            "lo_quantity BETWEEN 26 AND 35",
    "q2.1": "SELECT SUM(lo_revenue) FROM lineorder WHERE p_category = "
            "'MFGR#12' AND s_region = 'AMERICA' GROUP BY d_year, p_brand1 "
            "TOP 10000",
    "q2.2": "SELECT SUM(lo_revenue) FROM lineorder WHERE p_brand1 BETWEEN "
            "'MFGR#2221' AND 'MFGR#2228' AND s_region = 'ASIA' GROUP BY "
            "d_year, p_brand1 TOP 10000",
    "q2.3": "SELECT SUM(lo_revenue) FROM lineorder WHERE p_brand1 = "
            "'MFGR#2221' AND s_region = 'EUROPE' GROUP BY d_year, p_brand1 "
            "TOP 10000",
    "q3.1": "SELECT SUM(lo_revenue) FROM lineorder WHERE c_region = 'ASIA' "
            "AND s_region = 'ASIA' AND d_year BETWEEN 1992 AND 1997 GROUP "
            "BY c_nation, s_nation, d_year TOP 10000",
    # c_city × s_city × d_year spans 437k potential groups — past the
    # default numGroupsLimit; the per-query option (reference parity)
    # routes these to the scatter group path instead of the host
    "q3.2": "SELECT SUM(lo_revenue) FROM lineorder WHERE c_nation = "
            "'UNITED STATES' AND s_nation = 'UNITED STATES' AND d_year "
            "BETWEEN 1992 AND 1997 GROUP BY c_city, s_city, d_year "
            "TOP 10000 OPTION(numGroupsLimit=4194304)",
    "q3.3": "SELECT SUM(lo_revenue) FROM lineorder WHERE c_city IN "
            "('UNITED KI1', 'UNITED KI5') AND s_city IN ('UNITED KI1', "
            "'UNITED KI5') AND d_year BETWEEN 1992 AND 1997 GROUP BY "
            "c_city, s_city, d_year TOP 10000 "
            "OPTION(numGroupsLimit=4194304)",
    "q3.4": "SELECT SUM(lo_revenue) FROM lineorder WHERE c_city IN "
            "('UNITED KI1', 'UNITED KI5') AND s_city IN ('UNITED KI1', "
            "'UNITED KI5') AND d_yearmonth = 'Dec1997' GROUP BY c_city, "
            "s_city, d_year TOP 10000 OPTION(numGroupsLimit=4194304)",
    "q4.1": "SELECT SUM(lo_revenue), SUM(lo_supplycost) FROM lineorder "
            "WHERE c_region = 'AMERICA' AND s_region = 'AMERICA' AND "
            "p_mfgr IN ('MFGR#1', 'MFGR#2') GROUP BY d_year, c_nation "
            "TOP 10000",
    "q4.2": "SELECT SUM(lo_revenue), SUM(lo_supplycost) FROM lineorder "
            "WHERE c_region = 'AMERICA' AND s_region = 'AMERICA' AND "
            "d_year IN (1997, 1998) AND p_mfgr IN ('MFGR#1', 'MFGR#2') "
            "GROUP BY d_year, s_nation, p_category TOP 10000",
    "q4.3": "SELECT SUM(lo_revenue), SUM(lo_supplycost) FROM lineorder "
            "WHERE c_region = 'AMERICA' AND s_nation = 'UNITED STATES' "
            "AND d_year IN (1997, 1998) AND p_category = 'MFGR#14' GROUP "
            "BY d_year, s_city, p_brand1 TOP 10000 "
            "OPTION(numGroupsLimit=4194304)",
}


#: Q1.1-Q1.3 with their literals as fields, and the benchmark's literals
#: (SSB_PQLS); the batch families vary them (q1_batches)
Q1_TEMPLATES = {
    "q1.1": "SELECT SUM(lo_revenue) FROM lineorder WHERE d_year = {year} "
            "AND lo_discount BETWEEN {dlo} AND {dhi} AND lo_quantity < {qty}",
    "q1.2": "SELECT SUM(lo_revenue) FROM lineorder WHERE d_yearmonthnum = "
            "{ym} AND lo_discount BETWEEN {dlo} AND {dhi} AND lo_quantity "
            "BETWEEN {qlo} AND {qhi}",
    "q1.3": "SELECT SUM(lo_revenue) FROM lineorder WHERE d_weeknuminyear = "
            "{week} AND d_year = {year} AND lo_discount BETWEEN {dlo} AND "
            "{dhi} AND lo_quantity BETWEEN {qlo} AND {qhi}",
}
Q1_LITERALS = {"q1.1": dict(year=1993, dlo=1, dhi=3, qty=25),
               "q1.2": dict(ym=199401, dlo=4, dhi=6, qlo=26, qhi=35),
               "q1.3": dict(week=6, year=1994, dlo=5, dhi=7, qlo=26,
                            qhi=35)}


def q1_batches():
    """Three families of 8 same-shape Q1 queries, {flight: [literals]}:
    Q1.1 in each d_year 1992-1998 and with lo_discount BETWEEN 4 AND 6,
    Q1.2 in each d_yearmonthnum 199401-199408, Q1.3 in each
    d_weeknuminyear 1-8."""
    base = Q1_LITERALS
    return {
        "q1.1": [dict(base["q1.1"], year=y) for y in range(1992, 1999)] +
                [dict(base["q1.1"], dlo=4, dhi=6)],
        "q1.2": [dict(base["q1.2"], ym=199400 + m) for m in range(1, 9)],
        "q1.3": [dict(base["q1.3"], week=w) for w in range(1, 9)],
    }


def q1_revenue(pools, ids, flight: str, lits: dict) -> float:
    """The oracle of one Q1 flight at any literals: SUM(lo_revenue) over
    the rows Q1_TEMPLATES[flight].format(**lits) keeps."""
    def vid(col, value):
        return _vid(pools, col, value)

    d_lo, d_hi = _range_ids(pools, "lo_discount", lits["dlo"], lits["dhi"])
    disc, qty = ids["lo_discount"], ids["lo_quantity"]
    mask = (disc >= d_lo) & (disc < d_hi)
    if flight == "q1.1":
        mask &= (ids["d_year"] == vid("d_year", lits["year"])) & \
            (qty < vid("lo_quantity", lits["qty"]))
    else:
        q_lo, q_hi = _range_ids(pools, "lo_quantity", lits["qlo"],
                                lits["qhi"])
        mask &= (qty >= q_lo) & (qty < q_hi)
        if flight == "q1.2":
            mask &= ids["d_yearmonthnum"] == vid("d_yearmonthnum",
                                                 lits["ym"])
        else:
            mask &= (ids["d_weeknuminyear"] == vid("d_weeknuminyear",
                                                   lits["week"])) & \
                (ids["d_year"] == vid("d_year", lits["year"]))
    h = np.bincount(ids["lo_revenue"][mask],
                    minlength=len(pools["lo_revenue"]))
    return float(h @ pools["lo_revenue"].astype(np.float64))


def _vid(pools, col, value) -> int:
    i = int(np.searchsorted(pools[col], value))
    assert str(pools[col][i]) == str(value), (col, value)
    return i


def _range_ids(pools, col, lo, hi):
    """[lo, hi] inclusive value range → [lo_id, hi_id) id interval."""
    a = int(np.searchsorted(pools[col], lo, side="left"))
    b = int(np.searchsorted(pools[col], hi, side="right"))
    return a, b


# ---------------------------------------------------------------------------
# CPU baseline + oracle: vectorized numpy over id-domain columns
# ---------------------------------------------------------------------------


def make_cpu_queries(pools, ids, supplycost):
    """name → fn; scalar queries return float, group queries return
    {(decoded key strings...): (sum_revenue[, sum_supplycost])}."""
    rev_vals = pools["lo_revenue"].astype(np.float64)

    def vid(col, value):
        return _vid(pools, col, value)

    def vids(col, values):
        return np.array([vid(col, v) for v in values], np.int32)

    def rng_ids(col, lo, hi):
        return _range_ids(pools, col, lo, hi)

    def revenue_sum(mask):
        h = np.bincount(ids["lo_revenue"][mask],
                        minlength=len(rev_vals))
        return float(h @ rev_vals)

    def group(mask, gcols, with_cost):
        key = np.zeros(int(mask.sum()), np.int64)
        cards = []
        for c in gcols:
            card = len(pools[c])
            key = key * card + ids[c][mask]
            cards.append(card)
        n_groups = int(np.prod([len(pools[c]) for c in gcols]))
        rev = np.bincount(key, weights=rev_vals[ids["lo_revenue"][mask]],
                          minlength=n_groups)
        cost = np.bincount(key, weights=supplycost[mask],
                           minlength=n_groups) if with_cost else None
        nz = np.nonzero(np.bincount(key, minlength=n_groups))[0]
        out = {}
        for gi in nz:
            rem, parts = int(gi), []
            for c in reversed(gcols):
                card = len(pools[c])
                parts.append(str(pools[c][rem % card]))
                rem //= card
            k = tuple(reversed(parts))
            out[k] = (float(rev[gi]),) + (
                (float(cost[gi]),) if with_cost else ())
        return out

    y = ids["d_year"]
    disc = ids["lo_discount"]
    qty = ids["lo_quantity"]

    # Scalar dictionary lookups (value → id bound) are precomputed — that
    # is O(log card) planner work. The ROW-SCALE filter evaluation happens
    # inside each timed closure, like it does on the device side.
    d1, d3 = rng_ids("lo_discount", 1, 3)
    d4, d6 = rng_ids("lo_discount", 4, 6)
    d5, d7 = rng_ids("lo_discount", 5, 7)
    q25 = vid("lo_quantity", 25)
    q26, q35 = rng_ids("lo_quantity", 26, 35)
    y93 = vid("d_year", 1993)
    y94 = vid("d_year", 1994)
    y92, y97 = rng_ids("d_year", 1992, 1997)
    ym9401 = vid("d_yearmonthnum", 199401)
    wk6 = vid("d_weeknuminyear", 6)
    b21, b28 = rng_ids("p_brand1", "MFGR#2221", "MFGR#2228")
    us = vid("c_nation", "UNITED STATES")
    ki = vids("c_city", ["UNITED KI1", "UNITED KI5"])
    mf12 = vids("p_mfgr", ["MFGR#1", "MFGR#2"])
    y9798 = vids("d_year", [1997, 1998])

    mask_fns = {
        "q1.1": lambda: (y == y93) & (disc >= d1) & (disc < d3) &
                        (qty < q25),
        "q1.2": lambda: (ids["d_yearmonthnum"] == ym9401) &
                        (disc >= d4) & (disc < d6) &
                        (qty >= q26) & (qty < q35),
        "q1.3": lambda: (ids["d_weeknuminyear"] == wk6) & (y == y94) &
                        (disc >= d5) & (disc < d7) &
                        (qty >= q26) & (qty < q35),
        "q2.1": lambda: (ids["p_category"] == vid("p_category",
                                                  "MFGR#12")) &
                        (ids["s_region"] == vid("s_region", "AMERICA")),
        "q2.2": lambda: (ids["p_brand1"] >= b21) &
                        (ids["p_brand1"] < b28) &
                        (ids["s_region"] == vid("s_region", "ASIA")),
        "q2.3": lambda: (ids["p_brand1"] == vid("p_brand1",
                                                "MFGR#2221")) &
                        (ids["s_region"] == vid("s_region", "EUROPE")),
        "q3.1": lambda: (ids["c_region"] == vid("c_region", "ASIA")) &
                        (ids["s_region"] == vid("s_region", "ASIA")) &
                        (y >= y92) & (y < y97),
        "q3.2": lambda: (ids["c_nation"] == us) &
                        (ids["s_nation"] == us) & (y >= y92) & (y < y97),
        "q3.3": lambda: np.isin(ids["c_city"], ki) &
                        np.isin(ids["s_city"], ki) &
                        (y >= y92) & (y < y97),
        "q3.4": lambda: np.isin(ids["c_city"], ki) &
                        np.isin(ids["s_city"], ki) &
                        (ids["d_yearmonth"] == vid("d_yearmonth",
                                                   "Dec1997")),
        "q4.1": lambda: (ids["c_region"] == vid("c_region", "AMERICA")) &
                        (ids["s_region"] == vid("s_region", "AMERICA")) &
                        np.isin(ids["p_mfgr"], mf12),
        "q4.2": lambda: (ids["c_region"] == vid("c_region", "AMERICA")) &
                        (ids["s_region"] == vid("s_region", "AMERICA")) &
                        np.isin(ids["p_mfgr"], mf12) & np.isin(y, y9798),
        "q4.3": lambda: (ids["c_region"] == vid("c_region", "AMERICA")) &
                        (ids["s_nation"] == us) & np.isin(y, y9798) &
                        (ids["p_category"] == vid("p_category",
                                                  "MFGR#14")),
    }

    fns = {}
    for q in ("q1.1", "q1.2", "q1.3"):
        fns[q] = (lambda mf: (lambda: revenue_sum(mf())))(mask_fns[q])
    for q, gcols in (("q2.1", ["d_year", "p_brand1"]),
                     ("q2.2", ["d_year", "p_brand1"]),
                     ("q2.3", ["d_year", "p_brand1"]),
                     ("q3.1", ["c_nation", "s_nation", "d_year"]),
                     ("q3.2", ["c_city", "s_city", "d_year"]),
                     ("q3.3", ["c_city", "s_city", "d_year"]),
                     ("q3.4", ["c_city", "s_city", "d_year"])):
        fns[q] = (lambda mf, gc: (lambda: group(mf(), gc, False)))(
            mask_fns[q], gcols)
    for q, gcols in (("q4.1", ["d_year", "c_nation"]),
                     ("q4.2", ["d_year", "s_nation", "p_category"]),
                     ("q4.3", ["d_year", "s_city", "p_brand1"])):
        fns[q] = (lambda mf, gc: (lambda: group(mf(), gc, True)))(
            mask_fns[q], gcols)
    return fns


def canon_response(name: str, resp):
    """BrokerResponse → the CPU functions' canonical result shape."""
    if name.startswith("q1"):
        v = resp.aggregation_results[0].value
        return 0.0 if v == "null" else float(v)
    n_aggs = len(resp.aggregation_results)
    out = {}
    for ai in range(n_aggs):
        for g in resp.aggregation_results[ai].group_by_result:
            k = tuple(str(x) for x in g["group"])
            out.setdefault(k, [0.0] * n_aggs)[ai] = float(g["value"])
    return {k: tuple(v) for k, v in out.items()}


def check(name: str, got, exp) -> None:
    if name.startswith("q1"):
        assert abs(got - exp) <= max(1e-6 * abs(exp), 1e-6), \
            f"{name}: {got} != {exp}"
        return
    assert set(got) == set(exp), \
        f"{name}: group keys differ ({len(got)} vs {len(exp)}); " \
        f"e.g. {list(set(exp) - set(got))[:3]} missing"
    for k, ev in exp.items():
        gv = got[k]
        # dense group paths (psums) are exact; past DENSE_G_LIMIT the
        # scatter path accumulates in device f32 (~1e-5 rel at this scale),
        # as does the supplycost carry — tolerance covers both
        assert abs(gv[0] - ev[0]) <= max(1e-4 * abs(ev[0]), 1e-6), \
            f"{name} {k}: revenue {gv[0]} != {ev[0]}"
        if len(ev) > 1:
            assert abs(gv[1] - ev[1]) <= max(2e-4 * abs(ev[1]), 1e-3), \
                f"{name} {k}: supplycost {gv[1]} != {ev[1]}"
