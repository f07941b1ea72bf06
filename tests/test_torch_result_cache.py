"""The server's CRC-exact result cache on the port (the cases of
tests/test_result_cache.py that need no broker): the canonical
fingerprint, cached replies equal to uncached ones on the host, device
(plain versions on the CPU) and stacked paths, traced and failed
queries never cached, keys on (name, CRC, validDocIds version), an
upsert bump and a segment replacement invalidating end to end, and a
swap's clear winning over an in-flight store. Port ServerInstances
(device="cpu") over the JAX creator's segment directories.
"""
import tempfile

import pytest

from fixtures import build_segment

from pinot_tpu_torch.common.datatable import DataTable, RESULT_CACHE_HIT_KEY
from pinot_tpu_torch.common.metrics import ServerMeter
from pinot_tpu_torch.common.request import InstanceRequest
from pinot_tpu_torch.common.serde import instance_request_to_bytes
from pinot_tpu_torch.pql.parser import compile_pql
from pinot_tpu_torch.query.fingerprint import query_fingerprint
from pinot_tpu_torch.segment.loader import ImmutableSegmentLoader
from pinot_tpu_torch.server import ServerInstance
from pinot_tpu_torch.server.result_cache import segment_cache_states

QUERIES = [
    "SELECT COUNT(*) FROM baseballStats_OFFLINE",
    "SELECT SUM(hits), AVG(average) FROM baseballStats_OFFLINE "
    "WHERE league = 'NL'",
    "SELECT SUM(salary) FROM baseballStats_OFFLINE GROUP BY teamID TOP 50",
    "SELECT runs, hits FROM baseballStats_OFFLINE "
    "ORDER BY hits DESC LIMIT 7",
]


def _request(pql, request_id=1, **kw):
    return instance_request_to_bytes(InstanceRequest(
        request_id=request_id, query=compile_pql(pql), **kw))


def _payload_of(dt: DataTable):
    """The result payload, metadata that may legitimately differ on a
    cache hit (requestId, cache marker, timings) excluded."""
    meta = {k: v for k, v in dt.metadata.items()
            if k not in ("requestId", RESULT_CACHE_HIT_KEY, "timeUsedMs",
                         "profileInfo")}
    return dt.kind, dt.columns, dt.rows, meta, dt.exceptions


def _port_segment(n, seed, name):
    """The JAX creator's segment directory, loaded by the port."""
    d = tempfile.mkdtemp()
    build_segment(d, n=n, seed=seed, name=name)
    return ImmutableSegmentLoader.load(d)


def _server(mesh=None, use_device=True, num_segments=2):
    s = ServerInstance("cache0", mesh=mesh, use_device=use_device,
                       device="cpu")
    for i in range(num_segments):
        s.data_manager.table("baseballStats_OFFLINE",
                             create=True).add_segment(
            _port_segment(700, 40 + i, f"rc_{i}"))
    return s


# ---------------------------------------------------------------------------
# Fingerprint canonicalization
# ---------------------------------------------------------------------------


def test_fingerprint_merges_only_equivalent_queries():
    a = compile_pql("SELECT COUNT(*) FROM t WHERE x IN ('b', 'a') "
                    "AND y = '1'")
    b = compile_pql("SELECT COUNT(*) FROM t WHERE y = '1' "
                    "AND x IN ('a', 'b')")
    assert query_fingerprint(a) == query_fingerprint(b)
    c = compile_pql("SELECT COUNT(*) FROM t WHERE x IN ('a', 'c') "
                    "AND y = '1'")
    assert query_fingerprint(a) != query_fingerprint(c)
    # trace/timeout shape metadata, not results: same fingerprint
    d = compile_pql("SELECT COUNT(*) FROM t WHERE x IN ('a', 'b') "
                    "AND y = '1' OPTION(trace=true, timeoutMs=50)")
    assert query_fingerprint(a) == query_fingerprint(d)
    # a different table is a different result space
    e = compile_pql("SELECT COUNT(*) FROM u WHERE x IN ('a', 'b') "
                    "AND y = '1'")
    assert query_fingerprint(a) != query_fingerprint(e)


# ---------------------------------------------------------------------------
# Bit-identical cached results on every execution path
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("path", ["host", "device", "sharded"])
def test_cached_equals_uncached_bitwise(path):
    if path == "sharded":
        from pinot_tpu_torch.parallel import make_mesh
        s = _server(mesh=make_mesh(["cpu"]))
    else:
        s = _server(use_device=(path == "device"))
    try:
        for i, pql in enumerate(QUERIES):
            cold = DataTable.from_bytes(
                s.handle_request_bytes(_request(pql, 10 + i)))
            assert not cold.exceptions, (pql, cold.exceptions)
            warm = DataTable.from_bytes(
                s.handle_request_bytes(_request(pql, 100 + i)))
            assert warm.metadata.get(RESULT_CACHE_HIT_KEY) == "1", pql
            assert _payload_of(warm) == _payload_of(cold), pql
        assert s.metrics.meter(ServerMeter.RESULT_CACHE_HITS).count == \
            len(QUERIES)
    finally:
        s.stop()


def test_trace_and_errors_never_cached():
    s = _server()
    try:
        pql = QUERIES[0]
        traced = DataTable.from_bytes(s.handle_request_bytes(
            _request(pql, 1, enable_trace=True)))
        assert "traceInfo" in traced.metadata
        # the traced run neither stored nor read the cache
        assert s.result_cache.stats()["entries"] == 0
        again = DataTable.from_bytes(s.handle_request_bytes(
            _request(pql, 2, enable_trace=True)))
        assert RESULT_CACHE_HIT_KEY not in again.metadata
    finally:
        s.stop()


# ---------------------------------------------------------------------------
# Invalidation: new CRC, vdoc version bump, segment replacement
# ---------------------------------------------------------------------------


def test_cache_states_key_on_crc_and_vdoc_version():
    seg1 = _port_segment(300, 1, "k_0")
    seg2 = _port_segment(300, 2, "k_0")                     # same name!
    s1 = segment_cache_states([seg1])
    s2 = segment_cache_states([seg2])
    assert s1 is not None and s2 is not None
    assert s1 != s2                         # different content → new CRC
    # a validDocIds version bump changes the key too
    from pinot_tpu_torch.realtime.upsert import ValidDocIds
    seg1.valid_doc_ids = ValidDocIds()
    before = segment_cache_states([seg1])
    assert seg1.valid_doc_ids.invalidate(5)
    after = segment_cache_states([seg1])
    assert before != after
    # mutable / CRC-less segments are uncacheable
    class FakeMutable:
        is_mutable = True
        segment_name = "m"
    assert segment_cache_states([seg1, FakeMutable()]) is None


def test_upsert_vdoc_bump_invalidates_end_to_end():
    from pinot_tpu_torch.realtime.upsert import ValidDocIds
    s = ServerInstance("vd0", device="cpu")
    seg = _port_segment(400, 9, "vd_0")
    seg.valid_doc_ids = ValidDocIds()
    s.data_manager.table("baseballStats_OFFLINE",
                         create=True).add_segment(seg)
    try:
        pql = "SELECT COUNT(*) FROM baseballStats_OFFLINE"
        full = DataTable.from_bytes(s.handle_request_bytes(_request(pql)))
        assert full.rows[0][0] == 400
        hit = DataTable.from_bytes(s.handle_request_bytes(_request(pql, 2)))
        assert hit.metadata.get(RESULT_CACHE_HIT_KEY) == "1"
        # two rows get superseded → version bump → the stale 400 must
        # be unreachable
        seg.valid_doc_ids.invalidate(0)
        seg.valid_doc_ids.invalidate(1)
        masked = DataTable.from_bytes(
            s.handle_request_bytes(_request(pql, 3)))
        assert RESULT_CACHE_HIT_KEY not in masked.metadata
        assert masked.rows[0][0] == 398
        # and the masked result caches under ITS OWN key
        again = DataTable.from_bytes(s.handle_request_bytes(
            _request(pql, 4)))
        assert again.metadata.get(RESULT_CACHE_HIT_KEY) == "1"
        assert again.rows[0][0] == 398
    finally:
        s.stop()


def test_segment_replacement_invalidates_end_to_end():
    s = ServerInstance("cr0", device="cpu")
    seg1 = _port_segment(250, 1, "swap_0")
    seg2 = _port_segment(350, 2, "swap_0")
    tdm = s.data_manager.table("baseballStats_OFFLINE", create=True)
    tdm.add_segment(seg1)
    try:
        pql = "SELECT COUNT(*) FROM baseballStats_OFFLINE"
        first = DataTable.from_bytes(s.handle_request_bytes(_request(pql)))
        assert first.rows[0][0] == 250
        assert DataTable.from_bytes(
            s.handle_request_bytes(_request(pql, 2))).metadata.get(
                RESULT_CACHE_HIT_KEY) == "1"
        tdm.add_segment(seg2)            # same name, new CRC
        fresh = DataTable.from_bytes(s.handle_request_bytes(
            _request(pql, 3)))
        assert RESULT_CACHE_HIT_KEY not in fresh.metadata
        assert fresh.rows[0][0] == 350
    finally:
        s.stop()



def test_segment_swap_clear_wins_over_inflight_store():
    """A segment swap clears the cache; an execution that was already
    in flight over the PRE-swap segment must not re-insert its stale
    bytes afterwards — a same-CRC reload (evolved schema) constructs
    the identical key forever, so the raced entry would never age out."""
    from pinot_tpu_torch.server.result_cache import ServerResultCache
    c = ServerResultCache()
    key = ("t", "fp", (("s", "crc", -1),))
    gen = c.generation             # captured before "execution"
    c.clear()                      # the swap races the running query
    c.put(key, b"stale", gen=gen)
    assert c.get(key) is None      # stale insert dropped
    c.put(key, b"fresh", gen=c.generation)
    assert c.get(key) == b"fresh"
    c.clear()
    c.put(key, b"ungenned")        # gen-less puts still work
    assert c.get(key) == b"ungenned"
