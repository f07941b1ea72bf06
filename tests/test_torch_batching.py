"""Cross-query batched execution on the port against the JAX package.

(a) Kernels: run_segment_kernel_batched (each kernel launched once for up
to 8 members of one plan; its plain versions on the CPU) against the JAX
run_segment_kernel_batched (the vmap of the segment kernel over a query
axis) key by key, for every case of pinot_tpu.ops.kernels.
batched_contract_cases() at CONTRACT_SHAPE_BUCKETS and B in {2, 3, 5, 8},
and for more plans of the same grammar (part sums, MV aggregations,
histograms and min / max, each K6 kind). The contract cases' upsert
`vdoc` leaf runs as K1's own vdoc node over the same liveness as the
port's uint8 lane (test_torch_vector._to_port). Integers are equal, float64 block sums agree
to rtol 1e-12 (both sides sum in float64, in other orders), and vector
scores are bit-equal to the JAX contract run op by op. Each member also
equals its own run_segment_kernel, bit for bit. Members whose params
disagree in arity or width raise before any kernel runs; N > 8 members
run in chunks of 8; plans without params run once for every member.
(b) Engine: ServerQueryExecutor.execute_batch against the port's
sequential execute and the JAX ServerQueryExecutor.execute_batch, member
by member (device path, on the CPU): aggregations, selections, exact and
IVF-probed vector members, members without params, members pruned
differently, 11 members (two chunks), a member whose literal is not in
the dictionary (a fast path), group-by members (sequential) and the
deadline's truncation. (c) Twins of the DispatchCoalescer state machine
tests (tests/test_batching.py) and of tests/test_fingerprint_shape.py for
the copied plan_shape_key. (d) `cuda` tests hold each batched kernel to
its plain version and to B single launches on the card, with one launch
per kernel for each chunk, and skip where there is no card.
"""
from __future__ import annotations

import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pinot_tpu.ops import kernels as jk
from pinot_tpu_torch.ops import kernels as tk
from test_torch_kernels import _in_list, _lanes, _member, _near, \
    _torch_cols
from test_torch_vector import _contract_case, _draw, _to_port

SHAPES = jk.CONTRACT_SHAPE_BUCKETS           # (8192, 16384)
BATCH_SIZES = (2, 3, 5, 8)
BATCHED_CASES = [c[0] for c in jk.batched_contract_cases()]


# ---------------------------------------------------------------------------
# (a) kernels
# ---------------------------------------------------------------------------


def _member_params(param_specs, rng):
    """One member's params for a contract case: ints in [0, 8), bool
    tables, and each query vector followed by its tree norm (a probe's
    query and the selection's are the same vector, as the planner
    gives them)."""
    params, q = [], None
    for dt, shape in param_specs:
        if dt == "float32" and shape == (128,):
            if q is None:
                q = rng.standard_normal(128).astype(np.float32)
            params.append(q)
        elif dt == "float32" and shape == () and q is not None:
            params.append(np.float32(np.sqrt(tk.vec_tree_sum_plain(q * q))))
        elif dt == "float32":
            params.append(np.float32(rng.standard_normal()))
        elif dt == "bool":
            params.append(rng.random(shape) < 0.5)
        else:
            params.append(rng.integers(0, 8, shape).astype(dt))
    return params


def _bits(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a, np.float32)).view(np.int32)


def _assert_outs_equal(got, want, n: int, what: str) -> None:
    """Port outputs [n, ...] against JAX's (whose bucket may hold more
    rows): integers and min / max equal, block sums to rtol 1e-12,
    scores bit for bit."""
    assert set(got) == set(want), (what, set(got) ^ set(want))
    for k, w in want.items():
        g = got[k].numpy()
        w = np.asarray(w)[:n]
        assert g.shape == w.shape, (what, k, g.shape, w.shape)
        if k.endswith(".vsum"):
            np.testing.assert_allclose(g, w, rtol=1e-12, atol=0,
                                       err_msg=f"{what} {k}")
        elif k == "sel.scores":
            np.testing.assert_array_equal(_bits(g), _bits(w),
                                          err_msg=f"{what} {k}")
        else:
            np.testing.assert_array_equal(g, w, err_msg=f"{what} {k}")


def _assert_members_equal_singles(P, filt, aggs, select, cols, params_list,
                                  num_docs, got) -> None:
    """Each member's rows of the batched outputs bit for bit its own
    run_segment_kernel."""
    for b, params in enumerate(params_list):
        one = tk.run_segment_kernel(P, filt, aggs, None, select, cols,
                                    params, num_docs, "cpu")
        assert set(one) == set(got)
        for k, v in one.items():
            assert torch.equal(got[k][b], v), (b, k)


@pytest.mark.parametrize("P", SHAPES)
@pytest.mark.parametrize("n", BATCH_SIZES)
@pytest.mark.parametrize("name", BATCHED_CASES)
def test_contract_cases_match_jax(name, n, P):
    _n, filt, aggs, group, select, lane_specs, param_specs = \
        _contract_case(name)
    assert group is None and param_specs
    rng = np.random.default_rng([P, n, len(name)])
    lane_specs = {k: (dt, tuple(P if d == "P" else d for d in shape))
                  for k, (dt, shape) in lane_specs.items()}
    cols = {k: _draw(dt, shape, rng, k) for k, (dt, shape) in
            lane_specs.items()}
    members = [_member_params(param_specs, rng) for _ in range(n)]
    num_docs = P - 321
    # op by op where the plan scores vectors (see test_torch_vector: XLA's
    # CPU jit fuses the product into the tree's first level)
    vector = select is not None and select[0] == "vector"
    with jax.disable_jit(vector):
        want = jk.run_segment_kernel_batched(
            P, filt, aggs, select, {k: jnp.asarray(v) for k, v in
                                    cols.items()},
            [tuple(jnp.asarray(p) for p in ps) for ps in members],
            jnp.int32(num_docs))
        want = {k: np.asarray(v) for k, v in want.items()}
    port = [_to_port(filt, cols, ps) for ps in members]
    port_filt, port_cols = port[0][0], port[0][1]
    tcols = {k: torch.from_numpy(np.ascontiguousarray(v))
             for k, v in port_cols.items()}
    params_list = [p[2] for p in port]
    got = tk.run_segment_kernel_batched(P, port_filt, aggs, select, tcols,
                                        params_list, num_docs)
    _assert_outs_equal(got, want, n, name)
    _assert_members_equal_singles(P, port_filt, aggs, select, tcols,
                                  params_list, num_docs, got)
    if "sel.count" in got:
        assert int(got["sel.count"].min()) > 0


def _pred(kind, col, source="sv", extra=None):
    return ("pred", kind, col, source, extra)


#: plans of the batchable grammar beyond the contract cases, each with a
#: function of the member index giving that member's params
EXTRA_CASES = {
    # K2 over part lanes, a raw range in K1
    "part_sums": (
        ("and", (_pred("eq_id", "a"),
                 _pred("range_raw", "rf32", "raw", (True, False)))),
        (("count", "*", "none", None),
         ("sum", "r1", "sv", ("parts", 1024)),
         ("avg", "r2", "sv", ("parts", 1024))), None,
        lambda b: [np.int32(3 + 7 * b % 50), _near("rf32", b),
                   _near("rf32", 40 + b)]),
    # K4 (ids and MV entries), K5 (ids, raw, MV entries, block sums)
    "hist_reduce_mv": (
        ("or", (_pred("member", "b", extra=1024),
                _pred("in_ids", "m3", "mv", 4))),
        (("count", "*", "none", None),
         ("distinctcount", "h15", "sv", ("hist", 16)),
         ("percentile", "b", "sv", ("hist", 1024)),
         ("minmaxrange", "c", "sv", ("ids", 65536)),
         ("sum", "rf64", "raw", None), ("minmaxrange", "ri64", "raw", None),
         ("countmv", "m3", "mv", (16, 10)), ("min", "m3", "mv", (16, 10)),
         ("distinctcount", "m3", "mv", (16, 10))), None,
        lambda b: [_member(1000, 10 + b), _in_list([b % 10, 9 - b], 4)]),
    "select_limit": (
        _pred("range_ids", "a"), (),
        ("limit", 16, (), (("a", "sv"), ("rf32", "raw"), ("m3", "mv"))),
        lambda b: [np.int32(b), np.int32(b + 3)]),
    "select_order": (
        _pred("range_ids", "a"), (),
        ("order", 32, (("a", True, 64, "sv"), ("b", False, 1024, "sv")),
         (("c", "sv"),)),
        lambda b: [np.int32(2 * b), np.int32(2 * b + 30)]),
    "select_ordertk": (
        _pred("neq_id", "h15"), (),
        ("ordertk", 64, (("rf32", False, 0, "raw"),), (("a", "sv"),)),
        lambda b: [np.int32(b)]),
    "select_ordermk": (
        _pred("in_ids", "a", extra=4), (),
        ("ordermk", 16, (("a", True, 64, "sv"), ("ri64", False, 0, "raw")),
         (("rf64", "raw"),)),
        lambda b: [_in_list([b, b + 1, 40 - b], 4)]),
}


def _extra_operands(name: str, P: int, n: int):
    filt, aggs, select, fn = EXTRA_CASES[name]
    num_docs = P - 777
    cols = _lanes(P, num_docs, seed=P + len(name))
    return filt, aggs, select, cols, [fn(b) for b in range(n)], num_docs


@pytest.mark.parametrize("n", (3, 8))
@pytest.mark.parametrize("name", sorted(EXTRA_CASES))
def test_extra_plans_match_jax(name, n):
    P = SHAPES[0]
    filt, aggs, select, cols, members, num_docs = _extra_operands(name, P,
                                                                  n)
    want = jk.run_segment_kernel_batched(
        P, filt, aggs, select, {k: jnp.asarray(v) for k, v in cols.items()},
        [tuple(jnp.asarray(p) for p in ps) for ps in members],
        jnp.int32(num_docs))
    want = {k: np.asarray(v) for k, v in want.items()}
    tcols = _torch_cols(cols)
    got = tk.run_segment_kernel_batched(P, filt, aggs, select, tcols,
                                        members, num_docs)
    _assert_outs_equal(got, want, n, name)
    _assert_members_equal_singles(P, filt, aggs, select, tcols, members,
                                  num_docs, got)


def test_chunks_and_param_free_plans():
    """11 members run as chunks of 8 and 3 and equal one run of each;
    plans without params run once and every member reads those outputs."""
    P = SHAPES[0]
    filt, aggs, select, cols, members, num_docs = _extra_operands(
        "part_sums", P, 11)
    tcols = _torch_cols(cols)
    got = tk.run_segment_kernel_batched(P, filt, aggs, select, tcols,
                                        members, num_docs)
    assert got["agg1.parts"].shape[0] == 11
    _assert_members_equal_singles(P, filt, aggs, select, tcols, members,
                                  num_docs, got)
    free = tk.run_segment_kernel_batched(P, ("match_all",), aggs, None,
                                         tcols, [(), (), ()], num_docs)
    one = tk.run_segment_kernel(P, ("match_all",), aggs, None, None, tcols,
                                (), num_docs, "cpu")
    for k, v in one.items():
        assert free[k].shape == (3,) + tuple(v.shape)
        assert all(torch.equal(free[k][b], v) for b in range(3))


def test_members_that_disagree_raise_before_launching():
    P = SHAPES[0]
    cols = _torch_cols(_lanes(P, P, seed=1))
    spec = _pred("in_ids", "a", extra=4)
    with pytest.raises(ValueError, match="arity"):
        tk.run_segment_kernel_batched(P, spec, (("count", "*", "none",
                                                 None),), None, cols,
                                      [[_in_list([1], 4)], []], P)
    with pytest.raises(ValueError, match="width"):
        tk.run_segment_kernel_batched(P, spec, (("count", "*", "none",
                                                 None),), None, cols,
                                      [[_in_list([1], 4)],
                                       [_in_list([1, 2], 8)]], P)
    with pytest.raises(ValueError, match="members"):
        tk.filter_mask_batched(P, spec, cols, [[_in_list([1], 4)]] * 9, P)
    assert tk.stack_param_leaves([(1, np.zeros(3)), (2, np.ones(3))])[1] \
        .shape == (2, 3)
    assert tk.MAX_BATCH == 8


# ---------------------------------------------------------------------------
# (b) the engine: execute_batch against sequential execution and JAX
# ---------------------------------------------------------------------------

#: segment i holds yearID in [1990 + 10 i, 2000 + 10 i): members with a
#: yearID filter are pruned differently
YEAR_BANDS = ((1990, 2000), (2000, 2010), (2010, 2020))

BATCHES = {
    # tests/test_batching.py's BATCH_PQLS
    "aggregation": ["SELECT COUNT(*), SUM(hits) FROM baseballStats WHERE "
                    "runs > '%d'" % lit for lit in (10, 40, 75, 110, 130)],
    "pruned": ["SELECT COUNT(*), SUM(runs), MAX(hits), MINMAXRANGE(salary) "
               "FROM baseballStats WHERE yearID >= %d AND league = 'NL'" % y
               for y in (1995, 2005, 2012, 2017)],
    "float_sums": ["SELECT AVG(salary), MIN(average), PERCENTILE90(hits), "
                   "DISTINCTCOUNT(teamID) FROM baseballStats WHERE "
                   "salary > %d" % v for v in (100000, 400000, 800000)],
    "hll": ["SELECT DISTINCTCOUNTHLL(playerName), COUNTMV(position) FROM "
            "baseballStats WHERE position IN ('%s', 'C')" % v
            for v in ("P", "SS", "1B")],
    "selection": ["SELECT teamID, runs, hits FROM baseballStats WHERE hits "
                  "> %d ORDER BY runs DESC, hits LIMIT 12" % v
                  for v in (10, 50, 100, 150)],
    "selection_limit": ["SELECT teamID, salary, position FROM baseballStats "
                        "WHERE runs < %d LIMIT 7" % v for v in (5, 20, 60)],
    "param_free": ["SELECT SUM(salary), AVG(hits) FROM baseballStats"] * 3,
    "eleven": ["SELECT COUNT(*), SUM(hits), MIN(runs) FROM baseballStats "
               "WHERE runs >= %d" % v for v in range(5, 115, 10)],
    # group-by members, a member whose literal no dictionary holds (a fast
    # path) and one the planner refuses (the host twin) run sequentially
    "mixed": ["SELECT COUNT(*), SUM(hits) FROM baseballStats WHERE runs > "
              "'10'",
              "SELECT COUNT(*), SUM(hits) FROM baseballStats WHERE runs > "
              "'40'",
              "SELECT COUNT(*), SUM(hits) FROM baseballStats WHERE teamID = "
              "'ZZZ'",
              "SELECT COUNT(*), SUM(hits) FROM baseballStats WHERE runs > 50 "
              "GROUP BY league TOP 10",
              "SELECT DISTINCTCOUNT(playerName) FROM baseballStats WHERE "
              "runs > 60 GROUP BY teamID TOP 100"],
}


@pytest.fixture(scope="module")
def engines(tmp_path_factory):
    from fixtures import make_columns, make_schema, make_table_config
    from pinot_tpu.engine import QueryEngine as JaxQueryEngine
    from pinot_tpu.segment.creator import SegmentCreator as JaxCreator
    from pinot_tpu_torch.engine import QueryEngine
    dirs = []
    for i, (lo, hi) in enumerate(YEAR_BANDS):
        cols = make_columns(2000, seed=80 + i)
        cols["yearID"] = np.random.default_rng(i).integers(
            lo, hi, 2000).astype(np.int32)
        d = str(tmp_path_factory.mktemp(f"batch{i}"))
        JaxCreator(make_schema(), make_table_config(),
                   segment_name=f"batch_{i}").build(cols, d)
        dirs.append(d)
    return JaxQueryEngine.from_dirs(dirs), QueryEngine.from_dirs(
        dirs, device="cpu")


def _answers(resp):
    if resp.selection_results is not None:
        return resp.selection_results.results
    return [(a.value, a.group_by_result) for a in resp.aggregation_results]


def _stats(resp):
    return (resp.num_docs_scanned, resp.num_segments_processed,
            resp.num_segments_matched, resp.total_docs,
            resp.num_entries_scanned_in_filter,
            resp.num_entries_scanned_post_filter)


def _batch(engine, pqls, **kw):
    """execute_batch on `engine` (either package's), each member's block
    reduced by the engine's reducer: (requests, responses)."""
    reqs = [engine.optimizer.optimize(_compile(engine, p)) for p in pqls]
    blocks = engine.executor.execute_batch(reqs, engine.segments, **kw)
    assert len(blocks) == len(reqs)
    return [engine.reducer.reduce(r, [b]) for r, b in zip(reqs, blocks)]


def _compile(engine, pql):
    if type(engine).__module__.startswith("pinot_tpu_torch"):
        from pinot_tpu_torch.pql.parser import compile_pql
    else:
        from pinot_tpu.pql.parser import compile_pql
    return compile_pql(pql)


@pytest.fixture
def batched_calls(monkeypatch):
    """The members of each run_segment_kernel_batched call."""
    calls = []
    real = tk.run_segment_kernel_batched

    def spy(*args, **kw):
        calls.append(len(args[5]))
        return real(*args, **kw)

    monkeypatch.setattr(tk, "run_segment_kernel_batched", spy)
    return calls


def _check_batch(jax_engine, port, pqls, batched_calls):
    port.executor.reset_path_counts()
    got = _batch(port, pqls)
    paths = dict(port.executor.path_counts)
    calls = list(batched_calls)
    want = _batch(jax_engine, pqls)
    for pql, g, w in zip(pqls, got, want):
        seq = port.query(pql)
        assert not g.exceptions and not seq.exceptions, pql
        assert _answers(g) == _answers(seq) == _answers(w), pql
        assert _stats(g) == _stats(seq) == _stats(w), pql
    return paths, calls


@pytest.mark.parametrize("name", sorted(BATCHES))
def test_execute_batch_matches_sequential_and_jax(engines, batched_calls,
                                                  name):
    jax_engine, port = engines
    pqls = BATCHES[name]
    paths, calls = _check_batch(jax_engine, port, pqls, batched_calls)
    n_segs = len(YEAR_BANDS)
    assert paths["pruned"] + paths["fast"] + paths["scan"] + \
        paths["host"] == len(pqls) * n_segs
    if name == "mixed":
        # runs > 10 and > 40 batch; ZZZ folds to a fast path on every
        # segment; the group-bys run one by one (the DISTINCTCOUNT one on
        # the host twin)
        assert calls == [2] * n_segs
        assert paths["fast"] == n_segs and paths["host"] == n_segs
    elif name == "pruned":
        # the members each segment keeps batch on it
        assert paths["pruned"] > 0 and calls and min(calls) > 1
        assert sum(calls) <= paths["scan"]
    elif name == "eleven":
        assert calls == [11] * n_segs
    else:
        assert calls == [len(pqls)] * n_segs
        assert paths == {"pruned": 0, "fast": 0, "scan": len(pqls) * n_segs,
                         "host": 0}


def test_vector_batches_match_sequential_and_jax(tmp_path, batched_calls):
    """Exact and IVF-probed VECTOR_SIMILARITY members, each member its own
    query vector, and a filtered family with varied literals."""
    from pinot_tpu.engine import QueryEngine as JaxQueryEngine
    from pinot_tpu_torch.engine import QueryEngine
    from test_torch_ivf import DIM, build_jax_dirs, pql_for
    dirs = build_jax_dirs(str(tmp_path))
    jax_engine = JaxQueryEngine.from_dirs(dirs)
    port = QueryEngine.from_dirs(dirs, device="cpu")
    rng = np.random.default_rng(7)
    qs = [rng.standard_normal(DIM).astype(np.float32) for _ in range(5)]
    families = [
        [pql_for(q, metric="COSINE", where="") for q in qs],
        [pql_for(q, metric="DOT", where="", nprobe=2) for q in qs],
        [pql_for(q, metric="COSINE", nprobe=4) for q in qs],
        [pql_for(qs[0], where=f"WHERE rid < {cut}")
         for cut in (2500, 3000, 3500)],
    ]
    for pqls in families:
        batched_calls.clear()
        paths, calls = _check_batch(jax_engine, port, pqls, batched_calls)
        assert calls == [len(pqls)] * len(dirs), pqls[0][-40:]
        assert paths["scan"] == len(pqls) * len(dirs)


def test_deadline_truncates_like_jax(engines, monkeypatch):
    """A deadline that passes before the second segment: every member
    keeps the first segment's rows and says what was left out, in the
    JAX executor's words; a deadline already past runs nothing."""
    from pinot_tpu_torch.query import executor as executor_mod
    jax_engine, port = engines
    pqls = BATCHES["aggregation"][:3]
    for resp in _batch(port, pqls, deadline=time.monotonic() - 1.0):
        assert [e["message"] if isinstance(e, dict) else e
                for e in resp.exceptions] and \
            "truncated at 0/3 segments" in str(resp.exceptions)
        assert resp.num_segments_processed == 0
    want = _batch(jax_engine, pqls, deadline=time.monotonic() - 1.0)
    assert [str(w.exceptions) for w in want] == \
        [str(g.exceptions) for g in _batch(
            port, pqls, deadline=time.monotonic() - 1.0)]
    ticks = iter([0.0, 10.0, 20.0, 30.0])
    monkeypatch.setattr(executor_mod, "time", types.SimpleNamespace(
        monotonic=lambda: next(ticks), perf_counter=time.perf_counter))
    got = _batch(port, pqls, deadline=5.0)
    for resp in got:
        assert "DeadlineExceededError: segment execution truncated at " \
            "1/3 segments (budget expired mid-query)" in str(resp.exceptions)
        assert resp.num_segments_processed == 1


# ---------------------------------------------------------------------------
# (c) the coalescer and the plan-shape key
# ---------------------------------------------------------------------------


class FakeClock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


def test_coalescer_solo_costs_nothing():
    from pinot_tpu_torch.server.scheduler import DispatchCoalescer
    c = DispatchCoalescer(0.002, clock=FakeClock())
    state, group = c.arrive("k", "m1", None)
    assert state == "solo" and group is None
    c.leave("k")
    assert c.arrive("k", "m2", None)[0] == "solo"


def test_coalescer_lead_join_seal():
    from pinot_tpu_torch.server.scheduler import DispatchCoalescer
    clk = FakeClock()
    occupancies = []
    c = DispatchCoalescer(0.002, clock=clk, on_dispatch=occupancies.append)
    assert c.arrive("k", "solo", None)[0] == "solo"
    state, g = c.arrive("k", "m1", None)
    assert state == "lead" and g is not None
    assert c.joinable("k")
    assert c.arrive("k", "m2", None) == ("joined", g)
    assert c.arrive("k", "m3", None) == ("joined", g)
    assert c.arrive("other", "x", None)[0] == "solo"
    clk.t += 0.001
    assert c.remaining_window_s(g) == pytest.approx(0.001)
    assert c.seal(g) == ["m1", "m2", "m3"]
    assert occupancies == [3]
    assert not c.joinable("k")
    assert c.seal(g) == [] and occupancies == [3]
    assert c.arrive("k", "m4", None)[0] == "lead"


def test_coalescer_deadline_bypass():
    from pinot_tpu_torch.server.scheduler import DispatchCoalescer
    clk = FakeClock()
    bypasses = []
    c = DispatchCoalescer(0.010, clock=clk,
                          on_bypass=lambda: bypasses.append(1))
    assert c.arrive("k", "solo", None)[0] == "solo"
    state, _ = c.arrive("k", "tight", clk.t + 0.015)
    assert state == "bypass" and len(bypasses) == 1
    state, g = c.arrive("k", "roomy", clk.t + 10.0)
    assert state == "lead"
    c.arrive("k", "tighter", clk.t + 5.0)
    assert g.deadline_s == pytest.approx(clk.t + 5.0)
    c.arrive("k", "looser", clk.t + 8.0)
    assert g.deadline_s == pytest.approx(clk.t + 5.0)


def test_coalescer_leave_accounting_survives_interleaving():
    from pinot_tpu_torch.server.scheduler import DispatchCoalescer
    c = DispatchCoalescer(0.002, clock=FakeClock())
    assert c.arrive("k", "a", None)[0] == "solo"
    _, g = c.arrive("k", "b", None)
    c.seal(g)
    c.leave("k")
    assert c.arrive("k", "c", None)[0] == "lead"
    c.leave("k")


#: the queries of tests/test_fingerprint_shape.py, in (same key) pairs and
#: (different key) pairs
SAME_SHAPE = [
    ("SELECT COUNT(*) FROM t WHERE x = 'a'",
     "SELECT COUNT(*) FROM t WHERE x = 'b'"),
    ("SELECT COUNT(*) FROM t WHERE x IN ('a', 'b', 'c')",
     "SELECT COUNT(*) FROM t WHERE x IN ('p', 'q', 'r')"),
    ("SELECT COUNT(*) FROM t WHERE x IN ('a', 'b', 'c')",
     "SELECT COUNT(*) FROM t WHERE x IN ('c', 'a', 'b')"),
    ("SELECT SUM(m) FROM t WHERE v > '10'",
     "SELECT SUM(m) FROM t WHERE v > '9000'"),
    ("SELECT a, b FROM t LIMIT 5", "SELECT a, b FROM t LIMIT 500"),
    ("SELECT a FROM t ORDER BY a LIMIT 10, 5",
     "SELECT a FROM t ORDER BY a LIMIT 90, 7"),
    ("SELECT SUM(m) FROM t GROUP BY g TOP 5",
     "SELECT SUM(m) FROM t GROUP BY g TOP 50"),
    ("SELECT COUNT(*) FROM t WHERE x = 'a'",
     "SELECT COUNT(*) FROM t WHERE x = 'a' OPTION(trace=true, "
     "timeoutMs=50)"),
    ("SELECT COUNT(*) FROM t WHERE x = '1' AND y = '2'",
     "SELECT COUNT(*) FROM t WHERE y = '2' AND x = '1'"),
    ("SELECT COUNT(*) FROM t WHERE x = '1' AND y = '2'",
     "SELECT COUNT(*) FROM t WHERE x = '9' AND y = '2'"),
    ("SELECT SUM(m) FROM t WHERE v > '10' AND x IN ('a','b') LIMIT 5",
     "SELECT SUM(m) FROM t WHERE v > '77' AND x IN ('c','d') LIMIT 9"),
]
OTHER_SHAPE = [
    ("SELECT COUNT(*) FROM t WHERE x IN ('a', 'b', 'c')",
     "SELECT COUNT(*) FROM t WHERE x IN ('a', 'b')"),
    ("SELECT SUM(m) FROM t WHERE v > '10'",
     "SELECT SUM(m) FROM t WHERE v >= '10'"),
    ("SELECT SUM(m) FROM t WHERE v > '10'",
     "SELECT SUM(m) FROM t WHERE v BETWEEN '10' AND '20'"),
    ("SELECT COUNT(*) FROM t WHERE x = 'a'",
     "SELECT COUNT(*) FROM t WHERE y = 'a'"),
    ("SELECT a, b FROM t LIMIT 5", "SELECT a, c FROM t LIMIT 5"),
    ("SELECT SUM(m) FROM t", "SELECT MAX(m) FROM t"),
    ("SELECT SUM(m) FROM t", "SELECT SUM(n) FROM t"),
    ("SELECT SUM(m) FROM t", "SELECT SUM(m), COUNT(*) FROM t"),
    ("SELECT SUM(m) FROM t GROUP BY g", "SELECT SUM(m) FROM t GROUP BY g, h"),
    ("SELECT SUM(m) FROM t GROUP BY g", "SELECT SUM(m) FROM t"),
    ("SELECT COUNT(*) FROM t WHERE x = '1' AND y = '2'",
     "SELECT COUNT(*) FROM t WHERE x = '1' OR y = '2'"),
    ("SELECT COUNT(*) FROM t WHERE x = '1'",
     "SELECT COUNT(*) FROM t WHERE x = '1' AND y = '2'"),
    ("SELECT COUNT(*) FROM t WHERE x = '1'",
     "SELECT COUNT(*) FROM t WHERE x <> '1'"),
    ("SELECT COUNT(*) FROM t WHERE x IN ('a','b')",
     "SELECT COUNT(*) FROM t WHERE x NOT IN ('a','b')"),
    ("SELECT COUNT(*) FROM t", "SELECT COUNT(*) FROM u"),
    ("SELECT a FROM t ORDER BY a LIMIT 5",
     "SELECT a FROM t ORDER BY a DESC LIMIT 5"),
]


def _shape(pql, port: bool):
    if port:
        from pinot_tpu_torch.pql.parser import compile_pql
        from pinot_tpu_torch.query.fingerprint import plan_shape_key, \
            query_fingerprint
    else:
        from pinot_tpu.pql.parser import compile_pql
        from pinot_tpu.query.fingerprint import plan_shape_key, \
            query_fingerprint
    req = compile_pql(pql)
    key, lits = plan_shape_key(req)
    return key, lits, query_fingerprint(req)


@pytest.mark.parametrize("a,b", SAME_SHAPE)
def test_literal_edits_keep_the_plan_shape_key(a, b):
    """The copied plan_shape_key and query_fingerprint give the JAX
    package's keys, literal vectors and fingerprints; a literal-only edit
    keeps the key, and the fingerprint differs where the literals do."""
    ka, kb = _shape(a, True), _shape(b, True)
    assert ka == _shape(a, False) and kb == _shape(b, False)
    assert ka[0] == kb[0]
    assert (ka[2] == kb[2]) == (ka[1] == kb[1])


@pytest.mark.parametrize("a,b", OTHER_SHAPE)
def test_structural_edits_change_the_plan_shape_key(a, b):
    ka, kb = _shape(a, True), _shape(b, True)
    assert ka == _shape(a, False) and kb == _shape(b, False)
    assert ka[0] != kb[0] and ka[2] != kb[2]


# ---------------------------------------------------------------------------
# (d) the batched kernels on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _case(name: str, P: int, n: int):
    """(filter, aggs, select, host lanes, members' params, num_docs) of a
    contract or extra case, in the port's terms."""
    if name in EXTRA_CASES:
        filt, aggs, select, cols, members, num_docs = _extra_operands(
            name, P, n)
        return filt, aggs, select, _torch_cols(cols), members, num_docs
    _n, filt, aggs, _group, select, lane_specs, param_specs = \
        _contract_case(name)
    rng = np.random.default_rng([P, n, len(name)])
    cols = {k: _draw(dt, tuple(P if d == "P" else d for d in shape), rng, k)
            for k, (dt, shape) in lane_specs.items()}
    port = [_to_port(filt, cols, _member_params(param_specs, rng))
            for _ in range(n)]
    return port[0][0], aggs, select, {
        k: torch.from_numpy(np.ascontiguousarray(v))
        for k, v in port[0][1].items()}, [p[2] for p in port], P - 321


@pytest.mark.cuda
@pytest.mark.parametrize("n", (2, 5, 8, 11))
@pytest.mark.parametrize("name", BATCHED_CASES + sorted(EXTRA_CASES))
def test_batched_kernels_cuda(cuda_device, name, n):
    """Each batched launch against its plain version (as the single
    launches are held: integers equal, block sums to rtol 1e-12, scores
    bit for bit) and against n single launches (bit for bit), with one
    launch per kernel for each chunk of 8 members."""
    P = SHAPES[-1]
    filt, aggs, select, host, members, num_docs = _case(name, P, n)
    card = {k: v.to(cuda_device) for k, v in host.items()}
    tk.reset_launch_counts()
    tk.run_segment_kernel(P, filt, aggs, None, select, card, members[0],
                          num_docs)
    single = {k: v for k, v in tk.launch_counts().items() if v}
    tk.reset_launch_counts()
    got = tk.run_segment_kernel_batched(P, filt, aggs, select, card,
                                        members, num_docs)
    torch.cuda.synchronize()
    launched = {k: v for k, v in tk.launch_counts().items() if v}
    # each launch of one member's plan is one batched launch per chunk
    # ("filter_mask[vdoc]", a launch whose program holds the vdoc node,
    # becomes "filter_mask_batched[vdoc]")
    chunks = -(-n // tk.MAX_BATCH)

    def batched_name(k):
        base, bracket, node = k.partition("[")
        return f"{base}_batched{bracket}{node}"

    assert launched == {batched_name(k): v * chunks
                        for k, v in single.items()}, (launched, single)
    want = tk.run_segment_kernel_batched(P, filt, aggs, select, host,
                                         members, num_docs)
    assert set(got) == set(want)
    for k, w in want.items():
        g = got[k].cpu()
        if k.endswith(".vsum"):
            torch.testing.assert_close(g, w, rtol=1e-12, atol=0)
        elif k == "sel.scores":
            assert torch.equal(g.view(torch.int32), w.view(torch.int32)), k
        else:
            assert torch.equal(g, w), k
    for b, params in enumerate(members):
        one = tk.run_segment_kernel(P, filt, aggs, None, select, card,
                                    params, num_docs)
        for k, v in one.items():
            assert torch.equal(got[k][b], v), (b, k)


@pytest.mark.cuda
@pytest.mark.parametrize("metric", ["cosine", "dot"])
@pytest.mark.parametrize("dim_pad", [16, 128, 4096])
def test_vector_scores_batched_cuda(cuda_device, metric, dim_pad):
    """K8 and K9 for 8 queries, the queries past 48 KB of shared memory
    at 4096 dims: bit for bit 8 single launches and the plain version."""
    rng = np.random.default_rng(dim_pad)
    rows = 3000 if dim_pad < 4096 else 700
    mat = rng.standard_normal((rows, dim_pad)).astype(np.float32)
    mat[3] = 0.0
    qs = [rng.standard_normal(dim_pad).astype(np.float32) for _ in range(8)]
    norms = [np.float32(np.sqrt(tk.vec_tree_sum_plain(q * q))) for q in qs]
    m = torch.from_numpy(mat).to(cuda_device)
    got = tk.vector_scores_batched(m, qs, norms, metric).cpu()
    plain = tk.vector_scores_batched_plain(torch.from_numpy(mat), qs, norms,
                                           metric)
    assert torch.equal(got.view(torch.int32), plain.view(torch.int32))
    for b in range(8):
        one = tk.vector_scores(m, qs[b], norms[b], metric).cpu()
        assert torch.equal(got[b].view(torch.int32), one.view(torch.int32))
    cent = torch.from_numpy(mat[:64].copy()).to(cuda_device)
    cvalid = torch.from_numpy(rng.random(64) < 0.8).to(cuda_device)
    ids, ok = tk.ivf_select_probes_batched(cent, cvalid, qs, norms, metric,
                                           5)
    for b in range(8):
        one_ids, one_ok = tk.ivf_select_probes(cent, cvalid, qs[b], norms[b],
                                               metric, 5)
        assert torch.equal(ids[b], one_ids) and torch.equal(ok[b], one_ok)
