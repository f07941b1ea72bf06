"""The port's residency ledger and tier manager against the JAX ones
(tests/test_residency.py, tests/test_residency_manager.py).

(a) The ledger (a copy): owner-replace registration, prefix release,
snapshots, sweepers, the gauges bind_registry pre-registers. (b) The
port's upload choke points: the ledger's bytes for a segment equal the
storage bytes of the tensors its lanes hold (segment lanes, the vdoc
lane, stacked lanes), and every release leaves the books. (c) The tiers
on the CPU: device (lanes as tensors), host (lanes copied to host
memory, answers from the host twin through device_gate), disk (row
payloads dropped, reloaded from the segment directory): crashes at each
staged-swap point, the pin that holds a demotion's release, the whole
device → host → disk → host → device cycle, cold hits, admission and
victims; every answer equal to a never-demoted twin and to the JAX
engine on the same directory. (d) A ServerInstance under a byte budget
answers as the JAX instance does.
"""
from __future__ import annotations

import gc
import threading
import time

import numpy as np
import pytest
import torch

from fixtures import build_segment

from pinot_tpu.engine import QueryEngine as JaxQueryEngine
from pinot_tpu.segment.loader import ImmutableSegmentLoader as JaxLoader
from pinot_tpu.server import ServerInstance as JaxServerInstance
from pinot_tpu_torch.common.datatable import DataTable
from pinot_tpu_torch.common.faults import InjectedCrash, crash_points
from pinot_tpu_torch.common.metrics import (MetricsRegistry, ServerGauge,
                                            ServerMeter)
from pinot_tpu_torch.engine import QueryEngine
from pinot_tpu_torch.obs import residency
from pinot_tpu_torch.obs.residency import LEDGER, ResidencyLedger
from pinot_tpu_torch.parallel import make_mesh
from pinot_tpu_torch.query.executor import ServerQueryExecutor
from pinot_tpu_torch.query.stages.exchange import ExchangeManager
from pinot_tpu_torch.segment.loader import ImmutableSegmentLoader
from pinot_tpu_torch.server import ServerInstance
from pinot_tpu_torch.server.residency_manager import (ResidencyError,
                                                      ResidencyManager,
                                                      TIER_DEVICE,
                                                      TIER_DISK, TIER_HOST)
from test_torch_server import assert_same_table, port_bytes

COUNT_SUM = ("SELECT COUNT(*), SUM(runs) FROM baseballStats "
             "WHERE yearID >= 2000")
GROUPS = ("SELECT COUNT(*), SUM(hits) FROM baseballStats "
          "WHERE league = 'AL' GROUP BY teamID TOP 1000")


@pytest.fixture(autouse=True)
def _clean_crash_points():
    crash_points.clear()
    yield
    crash_points.clear()


# ---------------------------------------------------------------------------
# (a) the ledger
# ---------------------------------------------------------------------------


def test_register_is_owner_replace_not_leak():
    led = ResidencyLedger()
    led.register("a", table="t", segment="s", kind="scan", nbytes=100)
    led.register("b", table="t", segment="s", kind="vdoc", nbytes=50)
    assert led.total_bytes() == 150
    led.register("a", table="t", segment="s", kind="scan", nbytes=40)
    assert led.total_bytes() == 90
    assert led.kind_bytes("scan") == 40 and led.kind_bytes("vdoc") == 50
    assert led.release("a") == 40
    assert led.release("a") == 0
    assert led.total_bytes() == 50


def test_release_prefix_and_snapshot():
    led = ResidencyLedger()
    for i in range(3):
        led.register(f"ds:1:lane{i}", table="t", segment="s",
                     kind="scan", nbytes=10 + i)
    led.register("ds:2:lane0", table="t", segment="s2", kind="vector",
                 nbytes=7)
    snap = led.snapshot(max_entries=2)
    assert snap["totalDeviceBytesResident"] == 40
    assert [e["bytes"] for e in snap["entries"]] == [12, 11]
    assert snap["tables"]["t"] == {"scan": 33, "vector": 7}
    assert snap["entryCount"] == 4
    assert led.release_prefix("ds:1:") == 33
    assert led.total_bytes() == 7 and led.kind_bytes("scan") == 0


def test_sweepers_run_on_scrape_and_exchange_reads_only():
    led = ResidencyLedger()
    calls = []
    sweeper = lambda: calls.append(1) or 0          # noqa: E731
    led.add_sweeper(sweeper)
    led.snapshot()
    led.kind_bytes("exchange")
    led.kind_bytes("scan")
    led.total_bytes()
    assert len(calls) == 2
    led.remove_sweeper(sweeper)
    led.remove_sweeper(sweeper)
    led.snapshot()
    assert len(calls) == 2


def test_bind_registry_preregisters_every_kind_series():
    from pinot_tpu_torch.obs.prometheus import render_prometheus
    reg = MetricsRegistry("server")
    residency.bind_registry(reg)
    text = render_prometheus(reg)
    assert "device_bytes_resident" in text
    for kind in residency.KINDS:
        assert f'"{kind}"' in text, kind


# ---------------------------------------------------------------------------
# (b) the upload choke points
# ---------------------------------------------------------------------------


def _segment_storage_bytes(seg) -> int:
    """Ground truth: the storage bytes of every tensor the segment's
    lanes hold now."""
    total = sum(t.untyped_storage().nbytes()
                for ds in seg._data_sources.values()
                for t in ds._dev.values())
    if seg._valid_dev is not None:
        total += seg._valid_dev[1].untyped_storage().nbytes()
    return total


def _segment_ledgered_bytes(seg) -> int:
    prefixes = tuple(f"ds:{id(ds)}:" for ds in seg._data_sources.values())
    prefixes += (f"seg:{id(seg)}:",)
    snap = LEDGER.snapshot(max_entries=1_000_000)
    return sum(e["bytes"] for e in snap["entries"]
               if e["owner"].startswith(prefixes))


def _port_segment(tmp_path, name, n=2048, seed=11):
    """(port segment bound to the CPU, JAX segment, columns, dir) of one
    directory the JAX creator wrote."""
    d = str(tmp_path / name)
    jseg, cols = build_segment(d, n=n, seed=seed, name=name)
    return ImmutableSegmentLoader.load(d).to("cpu"), jseg, cols, d


def test_ledgered_choke_points_count_storage_bytes():
    t = torch.arange(1000, dtype=torch.int16)
    out = residency.ledgered_put(t[::2], device="cpu", owner="t:put",
                                 table="x", segment="s", kind="scan")
    try:
        assert out.device.type == "cpu"
        # a strided view's storage is the whole buffer
        assert LEDGER.snapshot(1_000_000)["tables"]["x"]["scan"] == 2000
        a = residency.ledgered_asarray(np.zeros(300, np.float64),
                                       device="cpu", owner="t:put",
                                       table="x", segment="s", kind="scan")
        assert a.dtype == torch.float64
        assert LEDGER.table_kind_bytes()[("x", "scan")] == 2400
    finally:
        LEDGER.release("t:put")


def test_warm_device_ledger_matches_lane_storage(tmp_path):
    from pinot_tpu_torch.realtime.upsert import ValidDocIds
    seg, _j, _c, _d = _port_segment(tmp_path, "warm")
    seg.warm_device()
    seg.data_source("runs").device_part_lanes()
    seg.valid_doc_ids = ValidDocIds()
    seg.valid_doc_ids.invalidate(3)
    seg.device_valid_lane()
    actual = _segment_storage_bytes(seg)
    assert actual > 0 and _segment_ledgered_bytes(seg) == actual
    assert seg.device_bytes_estimate() <= actual
    before = LEDGER.total_bytes()
    seg.destroy()
    assert _segment_ledgered_bytes(seg) == 0
    assert LEDGER.total_bytes() == before - actual


def test_collected_segments_and_stacks_leave_the_books(tmp_path):
    seg, _j, _c, _d = _port_segment(tmp_path, "gc0")
    seg2, _j2, _c2, _d2 = _port_segment(tmp_path, "gc1", seed=12)
    eng = QueryEngine([seg, seg2], device="cpu", mesh=make_mesh(["cpu"]))
    eng.query(COUNT_SUM)
    stack = next(iter(eng.sharded._stacks.values()))
    prefix = f"stack:{id(stack)}:"
    held = sum(e["bytes"] for e in LEDGER.snapshot(1_000_000)["entries"]
               if e["owner"].startswith(prefix))
    assert held == sum(t.untyped_storage().nbytes()
                       for t in stack._lanes.values()) + \
        stack.device_num_docs().untyped_storage().nbytes()
    owners = [f"ds:{id(ds)}:" for s in (seg, seg2)
              for ds in s._data_sources.values()] + [prefix]
    del eng, stack, seg, seg2
    gc.collect()
    snap = LEDGER.snapshot(1_000_000)["entries"]
    assert not [e for e in snap if e["owner"].startswith(tuple(owners))]


def test_exchange_blocks_are_ledgered_until_close():
    mgr = ExchangeManager(ttl_s=60.0, max_bytes=1000)

    def held():
        return sum(e["bytes"] for e in LEDGER.snapshot(1_000_000)["entries"]
                   if e["owner"].startswith(f"xchg:{mgr.xkey}:"))

    mgr.put("a", b"x" * 10)
    mgr.put("b", b"y" * 20)
    assert held() == 30 and LEDGER.kind_bytes("exchange") >= 30
    mgr.put("a", b"z" * 5)                  # a republish replaces
    assert held() == 25
    mgr.close()
    assert held() == 0


# ---------------------------------------------------------------------------
# (c) the tiers
# ---------------------------------------------------------------------------


def make_manager(budget=None, host_budget=None):
    """A manager with a controllable clock; budgets relative to what the
    process already holds."""
    clk = [0.0]
    base = LEDGER.total_bytes()
    mgr = ResidencyManager(None if budget is None else base + budget,
                           host_budget, clock=lambda: clk[0])
    return mgr, clk


def tracked(tmp_path, mgr, name, n=2048, seed=11):
    seg, jseg, cols, d = _port_segment(tmp_path, name, n, seed)
    mgr.track("baseballStats", seg, seg_dir=d)
    seg.warm_device()
    return seg, jseg, cols, d


def answers(segs, pql=COUNT_SUM, gate=None, use_device=True, mesh=False):
    eng = QueryEngine(segs, device="cpu",
                      mesh=make_mesh(["cpu"]) if mesh else None)
    eng.executor = ServerQueryExecutor(use_device=use_device)
    eng.executor.device_gate = gate
    resp = eng.query(pql)
    assert not resp.exceptions, resp.exceptions
    return [(a.value, a.group_by_result) for a in resp.aggregation_results]


def jax_answers(jsegs, pql=COUNT_SUM):
    resp = JaxQueryEngine(jsegs).query(pql)
    return [(a.value, a.group_by_result) for a in resp.aggregation_results]


@pytest.mark.parametrize("point", ["residency.demote_staged",
                                   "residency.pre_publish",
                                   "residency.pre_release"])
def test_crash_mid_demotion_recovers_with_exact_results(tmp_path, point):
    mgr, _clk = make_manager()
    seg, jseg, _cols, d = tracked(tmp_path, mgr, f"c_{point[10:]}")
    want = jax_answers([jseg])
    crash_points.arm(point)
    with pytest.raises(InjectedCrash):
        mgr.demote_segment(seg.segment_name, TIER_DISK)
    # the survivor: no torn lanes on either path
    assert answers([seg], gate=mgr.device_allowed) == want
    assert answers([seg], use_device=False) == want
    # the restarted process: a fresh load of the artifact
    assert answers([ImmutableSegmentLoader.load(d)]) == want
    assert mgr.demote_segment(seg.segment_name, TIER_DISK) or \
        mgr.tracked(seg.segment_name) == TIER_DISK
    mgr.ensure_host(seg.segment_name)
    assert answers([seg], use_device=False) == want


def test_inflight_pin_blocks_lane_release_until_end_query(tmp_path):
    mgr, _clk = make_manager()
    released = []
    mgr.add_release_hook(released.append)
    seg, jseg, _cols, _d = tracked(tmp_path, mgr, "pin_race")
    want = jax_answers([jseg])
    token = mgr.begin_query([seg])
    done = threading.Event()
    result = {}

    def demoter():
        result["ok"] = mgr.demote_segment(seg.segment_name, TIER_HOST)
        done.set()

    t = threading.Thread(target=demoter, daemon=True)
    t.start()
    deadline = time.monotonic() + 5.0
    while mgr.tracked(seg.segment_name) != TIER_HOST:
        assert time.monotonic() < deadline, "publish never happened"
        time.sleep(0.01)
    assert not done.wait(0.15), "release did not wait for the pin"
    assert released == [] and _segment_storage_bytes(seg) > 0
    assert answers([seg], use_device=False) == want
    mgr.end_query(token)
    assert done.wait(5.0), "demotion wedged after pins drained"
    t.join(5.0)
    assert not t.is_alive() and result["ok"] is True
    assert released == [seg.segment_name]
    assert _segment_ledgered_bytes(seg) == 0


def test_host_tier_keeps_lanes_in_host_memory_for_promotion(tmp_path):
    """A demotion to host copies each resident lane to host memory and
    frees it on the device (the ledger drops it); the promotion uploads
    the same lanes back, the ledger as before."""
    mgr, _clk = make_manager()
    seg, jseg, _cols, _d = tracked(tmp_path, mgr, "pinned")
    answers([seg], GROUPS)                 # part lanes resident too
    lanes = {(name, k): v.clone() for name in seg.column_names
             for k, v in seg.data_source(name)._dev.items()}
    held = _segment_ledgered_bytes(seg)
    assert held == _segment_storage_bytes(seg) > 0
    assert seg.device_bytes_estimate() < held
    assert mgr.demote_segment(seg.segment_name, TIER_HOST)
    assert _segment_ledgered_bytes(seg) == 0
    hosts = {(name, k) for name in seg.column_names
             for k in seg.data_source(name)._host_lanes}
    assert hosts == set(lanes)
    assert seg.device_bytes_estimate() == held
    assert answers([seg], GROUPS, gate=mgr.device_allowed) == \
        jax_answers([jseg], GROUPS)
    assert mgr.promote_segment(seg.segment_name)
    assert _segment_ledgered_bytes(seg) == held
    for (name, k), v in lanes.items():
        assert torch.equal(seg.data_source(name)._dev[k], v)
        assert not seg.data_source(name)._host_lanes


def test_full_tier_cycle_parity_on_every_path(tmp_path):
    """device → disk → device for two segments, then the host, device
    and stacked paths against never-demoted twins and the JAX engine."""
    mgr, _clk = make_manager()
    segs, twins, jsegs = [], [], []
    for i in range(2):
        seg, jseg, _cols, d = tracked(tmp_path, mgr, f"cyc_{i}",
                                      seed=40 + i)
        segs.append(seg)
        jsegs.append(jseg)
        twins.append(ImmutableSegmentLoader.load(d))
    for seg in segs:
        assert mgr.demote_segment(seg.segment_name, TIER_DISK)
        assert mgr.tracked(seg.segment_name) == TIER_DISK
        assert seg.data_source("runs").dict_ids is None
        assert mgr.promote_segment(seg.segment_name)
        assert mgr.tracked(seg.segment_name) == TIER_DEVICE
    for pql in (COUNT_SUM, GROUPS):
        want = jax_answers(jsegs, pql)
        for kw in ({"use_device": False}, {}, {"mesh": True}):
            assert answers(segs, pql, **kw) == answers(twins, pql, **kw) \
                == want, (pql, kw)


def test_cold_hit_reload_is_metered_and_exact(tmp_path):
    metrics = MetricsRegistry("server")
    mgr, _clk = make_manager()
    mgr.bind_metrics(metrics)
    seg, jseg, _cols, _d = tracked(tmp_path, mgr, "cold_hit")
    assert mgr.demote_segment(seg.segment_name, TIER_DISK)
    token = mgr.begin_query([seg])
    try:
        assert mgr.tracked(seg.segment_name) in (TIER_HOST, TIER_DEVICE)
        assert answers([seg], use_device=False) == jax_answers([jseg])
    finally:
        mgr.end_query(token)
    assert metrics.meter(ServerMeter.RESIDENCY_COLD_HITS,
                         table="baseballStats").count == 1
    (entry,) = [s for s in mgr.snapshot()["segments"]
                if s["segment"] == seg.segment_name]
    assert entry["coldHits"] == 1
    mgr.shutdown()


def test_over_budget_attach_lands_host_tier(tmp_path):
    mgr, _clk = make_manager(budget=0)
    seg, jseg, _cols, d = _port_segment(tmp_path, "over_budget")
    mgr.track("baseballStats", seg, seg_dir=d)
    assert mgr.tracked(seg.segment_name) == TIER_HOST
    assert mgr.warm_device(seg.segment_name) is False
    assert not mgr.device_allowed(seg)
    assert answers([seg], gate=mgr.device_allowed) == jax_answers([jseg])
    assert _segment_ledgered_bytes(seg) == 0


def test_hotter_segment_evicts_strictly_colder_victim(tmp_path):
    mgr, clk = make_manager()
    cold, *_ = tracked(tmp_path, mgr, "victim_cold", seed=1)
    hot, *_ = tracked(tmp_path, mgr, "asker_hot", seed=2)
    for _ in range(6):
        mgr.end_query(mgr.begin_query([hot]))
    clk[0] += 120.0
    mgr.end_query(mgr.begin_query([hot]))
    full = LEDGER.total_bytes()
    assert mgr.demote_segment(hot.segment_name, TIER_HOST)
    mgr.configure(full - 1)
    assert mgr.promote_segment(hot.segment_name)
    assert mgr.tracked(hot.segment_name) == TIER_DEVICE
    assert mgr.tracked(cold.segment_name) == TIER_HOST
    assert not mgr.promote_segment(cold.segment_name)


def test_disk_demotion_without_artifact_is_refused(tmp_path):
    mgr, _clk = make_manager()
    seg, _j, _c, _d = _port_segment(tmp_path, "no_art", n=512, seed=5)
    mgr.track("baseballStats", seg)
    seg.warm_device()
    with pytest.raises(ResidencyError, match="artifact"):
        mgr.demote_segment(seg.segment_name, TIER_DISK)
    assert mgr.demote_segment(seg.segment_name, TIER_HOST)


def test_gauges_and_snapshot_expose_tiers(tmp_path):
    metrics = MetricsRegistry("server")
    mgr, _clk = make_manager()
    mgr.bind_metrics(metrics)
    seg, *_ = tracked(tmp_path, mgr, "gauged")
    dev = metrics.gauge(ServerGauge.RESIDENCY_TIER_BYTES,
                        table="|tier:device")
    host = metrics.gauge(ServerGauge.RESIDENCY_TIER_BYTES,
                         table="|tier:host")
    assert dev.value > 0 and host.value == 0
    assert mgr.demote_segment(seg.segment_name, TIER_HOST)
    assert dev.value == 0 and host.value > 0
    snap = mgr.snapshot()
    assert snap["tiers"]["host"]["segments"] == 1
    mgr.shutdown()


def test_stopped_stacked_instance_frees_its_stacks(tmp_path):
    """A stopped instance is collected with its stacks (the ledger holds
    none of their lanes): the manager's shutdown clears the ledger's
    annotator, which would otherwise keep the manager, its hooks and the
    instance's stacked lanes alive (a bound method compared with `is`
    never matches; the JAX copy keeps it so)."""
    import weakref
    srv = ServerInstance("stacked", device="cpu", mesh=make_mesh(["cpu"]))
    tdm = srv.data_manager.table("baseballStats", create=True)
    for i in range(2):
        seg, *_ = _port_segment(tmp_path, f"st_{i}", seed=30 + i)
        tdm.add_segment(seg)
    srv.start(port=0)
    reply = DataTable.from_bytes(srv.handle_request_bytes(
        port_bytes(COUNT_SUM, 1)))
    assert reply.metadata["executionPath"] == "sharded"
    stack = next(iter(srv.executor.sharded._stacks.values()))
    prefix = f"stack:{id(stack)}:"
    assert LEDGER._entry_annotator is not None
    srv.stop()
    assert LEDGER._entry_annotator is None
    ref = weakref.ref(srv)
    del srv, tdm, stack
    gc.collect()
    assert ref() is None
    assert not [e for e in LEDGER.snapshot(1_000_000)["entries"]
                if e["owner"].startswith(prefix)]


# ---------------------------------------------------------------------------
# (d) an instance under a byte budget
# ---------------------------------------------------------------------------


def test_budgeted_instance_answers_like_jax(tmp_path):
    """Four segments, a budget for about two: two attaches land on the
    host tier, queries over the host-tier pair promote it and demote the
    colder pair; every reply equals the JAX instance's (all on its
    device): rows, stats and exceptions, but numEntriesScannedPostFilter,
    which the host twin counts otherwise than the device path, in the
    JAX package as here."""
    port = jax = None
    try:
        dirs = []
        for i in range(4):
            d = str(tmp_path / f"b{i}")
            build_segment(d, n=2048, seed=90 + i, name=f"bud_{i}")
            dirs.append(d)
        segs = [ImmutableSegmentLoader.load(d).to("cpu") for d in dirs]
        per = segs[0].device_bytes_estimate()
        port = ServerInstance(device="cpu", batch_window_ms=0,
                              device_bytes_budget=LEDGER.total_bytes() +
                              2 * per + per // 2)
        jax = JaxServerInstance(batch_window_ms=0)
        tdm = port.data_manager.table("baseballStats", create=True)
        jtdm = jax.data_manager.table("baseballStats", create=True)
        for seg, d in zip(segs, dirs):
            tdm.add_segment(seg)
            port.residency.track("baseballStats", seg, seg_dir=d)
            port.residency.warm_device(seg.segment_name)
            jtdm.add_segment(JaxLoader.load(d))
        # admission evicts strictly colder residents, so which two stay
        # on the device depends on the heat decay between attaches
        tiers = {s.segment_name: port.residency.tracked(s.segment_name)
                 for s in segs}
        assert sorted(tiers.values()) == [TIER_DEVICE] * 2 + [TIER_HOST] * 2
        hosted = sorted(n for n, t in tiers.items() if t == TIER_HOST)
        rounds = [(COUNT_SUM, None), (GROUPS, None), (COUNT_SUM, hosted),
                  (GROUPS, hosted), (COUNT_SUM, None)]
        for i, (pql, names) in enumerate(rounds):
            raw = port_bytes(pql, 500 + i, names)
            assert_same_table(
                DataTable.from_bytes(port.handle_request_bytes(raw)),
                jax.handle_request_bytes(raw),
                ignore=("numEntriesScannedPostFilter",))
        demoted = port.metrics.meter(ServerMeter.RESIDENCY_DEMOTIONS,
                                     table=TIER_HOST).count
        promoted = port.metrics.meter(ServerMeter.RESIDENCY_PROMOTIONS,
                                      table="baseballStats").count
        assert demoted > 0 and promoted > 0
        assert LEDGER.total_bytes() <= port.residency.budget_bytes
    finally:
        for srv in (port, jax):
            if srv is not None:
                srv.stop()
