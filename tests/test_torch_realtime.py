"""Consuming segments on the port against the JAX package.

Twins of tests/test_realtime.py, each run through the port and the JAX
package on the same rows (tests/test_realtime.py:make_rows):

- the high-level consumer (realtime/hlc.py): consume, flush full segments
  locally, persist the group checkpoint after the flush, resume from it
  replaying only the unflushed rows (:385); keep ingesting over a flaky
  stream (:472); size the next consuming segment from the flush stats
  (:761);
- frozen / tail serving (:578): the consuming segment's sorted frozen
  prefix runs the device path (the kernels' plain versions on the CPU)
  and the rows since the freeze the host twin; the answers equal the JAX
  executor's over the same rows and the rows' own sums, one logical
  segment, across a re-freeze;
- the commit conversion (realtime/converter.py): the directory the port
  writes from a consuming segment is byte-identical to the JAX
  converter's for the same rows (metadata.json apart from its creation
  time), and loads in both packages to the same answers.

Integer answers are equal; float sums are compared as the JAX tests do.
"""
from __future__ import annotations

import json
import os
import time

import pytest

from fixtures import make_schema, make_table_config
from pinot_tpu.pql.parser import compile_pql as jax_compile
from pinot_tpu.query.executor import ServerQueryExecutor as JaxExecutor
from pinot_tpu.query.reduce import BrokerReduceService as JaxReduce
from pinot_tpu.realtime import converter as jax_converter
from pinot_tpu.realtime import mutable_segment as jax_ms
from pinot_tpu.segment.loader import ImmutableSegmentLoader as JaxLoader
from pinot_tpu_torch.common.schema import Schema
from pinot_tpu_torch.common.table_config import TableConfig
from pinot_tpu_torch.controller.property_store import PropertyStore
from pinot_tpu_torch.engine import QueryEngine
from pinot_tpu_torch.pql.parser import compile_pql
from pinot_tpu_torch.query.executor import ServerQueryExecutor
from pinot_tpu_torch.query.plan import NotPorted
from pinot_tpu_torch.query.reduce import BrokerReduceService
from pinot_tpu_torch.realtime import converter, registry
from pinot_tpu_torch.realtime.hlc import HLRealtimeSegmentDataManager
from pinot_tpu_torch.realtime.mutable_segment import MutableSegmentImpl
from pinot_tpu_torch.realtime.stats_history import \
    RealtimeSegmentStatsHistory
from pinot_tpu_torch.realtime.stream import (FlakyConsumerFactory,
                                             JsonMessageDecoder, MemoryStream,
                                             MemoryStreamConsumerFactory,
                                             StreamConfig)
from pinot_tpu_torch.segment.loader import ImmutableSegmentLoader
from pinot_tpu_torch.server.data_manager import TableDataManager
from test_realtime import make_rows, rt_config as jax_rt_config
from test_torch_segment import TIME_FIELDS

RT_TABLE = "baseballStats_REALTIME"


def port_schema() -> Schema:
    return Schema.from_json_str(make_schema().to_json_str())


def rt_config(factory_name, topic, flush_rows=100_000) -> TableConfig:
    """tests/test_realtime.py:rt_config as the port's TableConfig."""
    return TableConfig.from_json_str(
        jax_rt_config(factory_name, topic, flush_rows).to_json_str())


def wait_until(cond, timeout=30.0, interval=0.05):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(interval)
    return False


def total_docs(tdm):
    sdms, _ = tdm.acquire_segments()
    try:
        return sum(s.segment.num_docs for s in sdms)
    finally:
        for s in sdms:
            tdm.release_segment(s)


def test_hlc_consume_flush_checkpoint_resume(tmp_path):
    stream = MemoryStream("rsvp", num_partitions=2)
    factory = MemoryStreamConsumerFactory(stream, batch_size=200)
    scfg = StreamConfig(topic="rsvp", consumer_factory=factory,
                        decoder=JsonMessageDecoder(),
                        flush_threshold_rows=1000)
    store = PropertyStore()
    tdm = TableDataManager(RT_TABLE)
    for r in make_rows(2500, seed=3):
        stream.publish(r)
    work = str(tmp_path / "a")
    mgr = HLRealtimeSegmentDataManager(
        RT_TABLE, port_schema(), rt_config("unused", "rsvp"), scfg,
        group_id="g1", store=store, table_data_manager=tdm,
        instance_id="Server_0", work_dir=work)
    try:
        assert wait_until(lambda: mgr.segments_flushed >= 2 and
                          total_docs(tdm) >= 2500)
        assert mgr.segments_flushed == 2 and total_docs(tdm) == 2500
        names = [f"baseballStats__Server_0__g1__{i}" for i in range(3)]
        assert sorted(tdm.segment_names()) == names
        sdms, _ = tdm.acquire_segments()
        try:
            flushed_docs = sum(s.segment.num_docs for s in sdms
                               if not getattr(s.segment, "is_mutable",
                                              False))
            engine = QueryEngine([s.segment for s in sdms], device="cpu")
            resp = engine.query("SELECT COUNT(*) FROM baseballStats")
            assert int(resp.aggregation_results[0].value) == 2500
            assert resp.num_consuming_segments_queried == 1
        finally:
            for s in sdms:
                tdm.release_segment(s)
        ck = store.get(f"/CONSUMERS/{RT_TABLE}/g1")
        assert ck["sequence"] == 2
        assert sum(ck["offsets"].values()) == flushed_docs < 2500
        # the flushed directories load in the JAX package to the same rows
        assert sum(JaxLoader.load(os.path.join(work, n)).num_docs
                   for n in names[:2]) == flushed_docs
    finally:
        mgr.stop()

    tdm2 = TableDataManager(RT_TABLE)
    mgr2 = HLRealtimeSegmentDataManager(
        RT_TABLE, port_schema(), rt_config("unused", "rsvp"), scfg,
        group_id="g1", store=store, table_data_manager=tdm2,
        instance_id="Server_0", work_dir=work)
    try:
        assert wait_until(lambda: total_docs(tdm2) >= 2500)
        assert total_docs(tdm2) == 2500
        assert sorted(tdm2.segment_names()) == [
            f"baseballStats__Server_0__g1__{i}" for i in range(3)]
        for r in make_rows(50, seed=4):
            stream.publish(r)
        assert wait_until(lambda: total_docs(tdm2) >= 2550)
        assert total_docs(tdm2) == 2550
    finally:
        mgr2.stop()


def test_hlc_flaky_consumer_keeps_ingesting(tmp_path):
    stream = MemoryStream("rsvp_flaky", num_partitions=2)
    factory = FlakyConsumerFactory(
        MemoryStreamConsumerFactory(stream, batch_size=100), seed=5)
    scfg = StreamConfig(topic="rsvp_flaky", consumer_factory=factory,
                        decoder=JsonMessageDecoder(),
                        flush_threshold_rows=400)
    store, tdm = PropertyStore(), TableDataManager(RT_TABLE)
    for r in make_rows(1500, seed=6):
        stream.publish(r)
    mgr = HLRealtimeSegmentDataManager(
        RT_TABLE, port_schema(), rt_config("unused", "rsvp_flaky"), scfg,
        group_id="gf", store=store, table_data_manager=tdm,
        instance_id="Server_0", work_dir=str(tmp_path / "f"))
    try:
        assert wait_until(lambda: mgr.segments_flushed >= 2 and
                          total_docs(tdm) >= 1200)
        assert store.get(f"/CONSUMERS/{RT_TABLE}/gf")["sequence"] >= 2
    finally:
        mgr.stop()


def test_hlc_stats_history_feedback(tmp_path):
    stream = MemoryStream("topic_hsh", num_partitions=1)
    registry.register_stream_factory(
        "mem_hsh_port", MemoryStreamConsumerFactory(stream, batch_size=64))
    cfg = rt_config("mem_hsh_port", "topic_hsh", flush_rows=6000)
    stream_config = registry.resolve_stream_config(cfg)
    hist = RealtimeSegmentStatsHistory(str(tmp_path / "sh.json"))
    tdm = TableDataManager(RT_TABLE)
    mgr = HLRealtimeSegmentDataManager(
        RT_TABLE, port_schema(), cfg, stream_config, "g0", PropertyStore(),
        tdm, "srv0", str(tmp_path), stats_history=hist)
    try:
        for r in make_rows(7000, seed=21):
            stream.publish(r, partition=0)
        assert wait_until(lambda: mgr.segments_flushed >= 1)
        assert wait_until(lambda: len(hist.entries(RT_TABLE)) >= 1)
        assert hist.entries(RT_TABLE)[0]["numRowsIndexed"] >= 6000
        est = hist.estimate(RT_TABLE)
        assert est["rows"] > 4096
        want = 4096
        while want < est["rows"]:
            want *= 2
        assert len(mgr.mutable._sources["teamID"]._sv._arr) >= want > 4096
    finally:
        mgr.stop()
        registry.unregister_stream_factory("mem_hsh_port")


def test_tcp_stream_provider_is_not_ported():
    cfg = rt_config("tcp", "t")
    cfg.indexing_config.stream_configs["stream.tcp.port"] = "1"
    with pytest.raises(NotPorted):
        registry.resolve_stream_config(cfg)


FROZEN_PQLS = (
    "SELECT COUNT(*), SUM(runs) FROM baseballStats WHERE yearID >= 1990",
    "SELECT SUM(hits) FROM baseballStats GROUP BY league TOP 10",
    "SELECT playerName, runs FROM baseballStats ORDER BY runs DESC, "
    "playerName LIMIT 5",
    "SELECT COUNT(*) FROM baseballStats WHERE position = 'P'",
    "SELECT MIN(salary), MAX(average) FROM baseballStats WHERE "
    "teamID = 'BOS'",
)


def test_device_snapshot_frozen_tail_serving():
    seg = MutableSegmentImpl(port_schema(), TableConfig.from_json_str(
        make_table_config().to_json_str()), "cons_dev").to("cpu")
    jseg = jax_ms.MutableSegmentImpl(make_schema(), make_table_config(),
                                     "cons_dev")
    rows = make_rows(10_000, seed=31)
    more = make_rows(8_000, seed=32)
    for r in rows[:9_000]:
        seg.index_row(r)
        jseg.index_row(r)
    frozen, tail = seg.device_view()
    assert frozen is not None and not getattr(frozen, "is_mutable", False)
    assert frozen.num_docs >= seg.FREEZE_MIN_ROWS
    assert frozen.num_docs + tail.num_docs == 9_000
    assert frozen.device.type == "cpu" and seg.freezes == 1
    fv = frozen.data_source("teamID").dictionary.values
    assert list(fv) == sorted(fv)
    n_first = frozen.num_docs
    ex, red = ServerQueryExecutor(), BrokerReduceService()
    jex, jred = JaxExecutor(), JaxReduce()

    def checks(sub):
        for pql in FROZEN_PQLS:
            req = compile_pql(pql)
            ex.reset_path_counts()
            resp = red.reduce(req, [ex.execute(req, [seg])])
            assert resp.num_segments_processed == 1   # one LOGICAL segment
            tail = seg.num_docs - seg._frozen.num_docs
            assert ex.path_counts["scan"] == 1
            assert ex.path_counts["host"] == (1 if tail else 0)
            assert ex.tail_docs == tail
            jreq = jax_compile(pql)
            want = jred.reduce(jreq, [jex.execute(jreq, [jseg])]).to_json()
            got = resp.to_json()
            # the JAX twin orders a tail's selection by arrival-order
            # dictIds: selections are held to the rows themselves below
            for key in ("aggregationResults", "numDocsScanned", "totalDocs"):
                assert got.get(key) == want.get(key), (pql, key)
        top = sorted(((-r["runs"], r["playerName"]) for r in sub))[:5]
        req = compile_pql(FROZEN_PQLS[2])
        resp = red.reduce(req, [ex.execute(req, [seg])])
        assert [(-int(r[1]), r[0]) for r in
                resp.selection_results.results] == top
        m = [r for r in sub if r["yearID"] >= 1990]
        req = compile_pql(FROZEN_PQLS[0])
        resp = red.reduce(req, [ex.execute(req, [seg])])
        assert int(resp.aggregation_results[0].value) == len(m)
        assert float(resp.aggregation_results[1].value) == \
            float(sum(r["runs"] for r in m))

    checks(rows[:9_000])
    for r in rows[9_000:]:
        seg.index_row(r)
        jseg.index_row(r)
    checks(rows)
    assert seg._frozen.num_docs == n_first and seg.freezes == 1
    for r in more:
        seg.index_row(r)
        jseg.index_row(r)
    frozen2, tail2 = seg.device_view()
    assert frozen2.num_docs == 18_000 and tail2.num_docs == 0
    assert seg.freezes == 2 and seg.last_freeze_seconds > 0
    checks(rows + more)


def test_converter_writes_the_jax_converters_files(tmp_path):
    seg = MutableSegmentImpl(port_schema(), TableConfig.from_json_str(
        make_table_config().to_json_str()), "conv")
    jseg = jax_ms.MutableSegmentImpl(make_schema(), make_table_config(),
                                     "conv")
    rows = make_rows(3000, seed=41)
    seg.index_rows(rows)
    jseg.index_rows(rows)
    pdir, jdir = str(tmp_path / "port"), str(tmp_path / "jax")
    meta = converter.convert(seg, pdir, "baseballStats__0__0__x")
    jax_converter.convert(jseg, jdir, "baseballStats__0__0__x")
    assert meta.total_docs == 3000
    names = sorted(os.listdir(jdir))
    assert names == sorted(os.listdir(pdir)) and len(names) > 20
    for name in names:
        with open(os.path.join(jdir, name), "rb") as f:
            want = f.read()
        with open(os.path.join(pdir, name), "rb") as f:
            got = f.read()
        if name != "metadata.json":
            assert got == want, name
            continue
        jmeta, pmeta = json.loads(want), json.loads(got)
        for field in TIME_FIELDS:
            pmeta.pop(field)
            jmeta.pop(field)
        assert pmeta == jmeta
    # each package loads the other's directory to the same answers
    pql = "SELECT COUNT(*), SUM(runs) FROM baseballStats GROUP BY teamID"
    engine = QueryEngine([ImmutableSegmentLoader.load(jdir)], device="cpu")
    jreq = jax_compile(pql)
    want = JaxReduce().reduce(jreq, [JaxExecutor().execute(
        jreq, [JaxLoader.load(pdir)])]).to_json()
    assert engine.query(pql).to_json()["aggregationResults"] == \
        want["aggregationResults"]


def test_tail_selections_order_by_value():
    """A consuming segment's tail has arrival-order dictionaries: the host
    twin ranks ORDER BY keys by value (the JAX twin orders them by dictId,
    out of value order), so the frozen prefix + tail answer equals the
    numpy oracle's top rows, ties apart."""
    from pinot_tpu_torch.tools import baseball
    cols = baseball.make_columns(26_384, 5)
    names = list(cols)
    vals = [c.pool[c.codes].tolist()
            if isinstance(c, baseball.Categorical) else c.lists()
            if isinstance(c, baseball.MultiValue) else c.tolist()
            for c in cols.values()]
    rows = [dict(zip(names, row)) for row in zip(*vals)]
    seg = MutableSegmentImpl(baseball.make_schema(),
                             baseball.make_table_config(), "tail_order")
    seg.index_rows(rows[:16_384])
    seg.to("cpu").device_view()                # frozen at 16,384 rows
    seg.index_rows(rows[16_384:])              # a tail of 10,000
    engine = QueryEngine([seg], device="cpu")
    oracle = baseball.Oracle(cols)
    draws = list(baseball.selection_draws(oracle, n=20))
    assert sum(bool(d.order) for d in draws) >= 5
    for draw in draws:
        engine.executor.reset_path_counts()
        baseball.check(engine.query(draw.pql), oracle, draw)
        assert engine.executor.tail_docs == 10_000
