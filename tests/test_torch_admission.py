"""Admission control on the port's server (the cases of
tests/test_admission.py that need no broker): the shed order of
AdmissionController under a fake clock (deadline, hedge, tenant over
quota, brownout, capacity), the service-time estimator, the typed busy
DataTable, and a port ServerInstance (device="cpu") that sheds with a
typed reply, serves cache hits past a saturated queue, namespaces and
bounds workload tags and sheds hedges under pressure. The modules are
copies of the JAX ones; these are the JAX cases run against them.
"""
import tempfile

import pytest

from fixtures import build_segment

from pinot_tpu_torch.common.datatable import (DataTable, RESULT_CACHE_HIT_KEY,
                                              RETRY_AFTER_MS_KEY,
                                              SERVER_BUSY_EXC_PREFIX,
                                              SERVER_BUSY_KEY)
from pinot_tpu_torch.common.metrics import MetricsRegistry, ServerMeter
from pinot_tpu_torch.common.request import InstanceRequest
from pinot_tpu_torch.common.serde import instance_request_to_bytes
from pinot_tpu_torch.pql.parser import compile_pql
from pinot_tpu_torch.segment.loader import ImmutableSegmentLoader
from pinot_tpu_torch.server import ServerInstance
from pinot_tpu_torch.server.admission import (AdmissionController,
                                              ServiceTimeEstimator,
                                              busy_datatable)


class FakeClock:
    def __init__(self, t=100.0):
        self.t = t

    def __call__(self):
        return self.t


def _controller(max_pending=10, est_table=None, est_ms=None, **kw):
    metrics = MetricsRegistry("server")
    estimator = ServiceTimeEstimator(metrics)
    if est_table is not None:
        # seed the SAME per-table timer query_executor.py feeds after
        # every execution — the estimator only reads it
        from pinot_tpu_torch.common.metrics import ServerQueryPhase
        for _ in range(ServiceTimeEstimator.MIN_SAMPLES):
            metrics.timer(ServerQueryPhase.QUERY_PROCESSING,
                          table=est_table).update(est_ms)
    return AdmissionController(metrics=metrics, estimator=estimator,
                               max_pending=max_pending,
                               clock=FakeClock(), **kw), metrics


def _fill(ctrl, n, tenant="filler"):
    for _ in range(n):
        assert ctrl.admit("T", tenant)


# ---------------------------------------------------------------------------
# Shed order (deterministic, fake clock)
# ---------------------------------------------------------------------------


def test_deadline_aware_shed_uses_service_estimate():
    ctrl, _ = _controller(est_table="T", est_ms=100.0)   # low = 4
    # IDLE server: below the low watermark nothing deadline-sheds —
    # the p75 estimate is table-wide, so a cheap query class with a
    # tight timeout would otherwise hard-fail (terminally, since the
    # router never fails over a deadline shed) on an idle cluster;
    # the executor's deadline truncation handles truly doomed work
    assert ctrl.admit("T", "idle", budget_ms=50.0)
    _fill(ctrl, 3)                                       # depth 4 = low
    d = ctrl.admit("T", "a", budget_ms=50.0)
    assert not d and d.cause == "deadline"
    assert ctrl.admit("T", "a", budget_ms=200.0)
    # a table with no estimate yet never deadline-sheds
    assert ctrl.admit("U", "a", budget_ms=0.5)


def test_hedges_shed_first_at_low_watermark():
    ctrl, _ = _controller(max_pending=10)          # low = 4
    _fill(ctrl, 3)
    assert ctrl.admit("T", "a", hedge=True)        # below low: fine
    d = ctrl.admit("T", "a", hedge=True)           # depth 4 >= low
    assert not d and d.cause == "hedge"
    assert ctrl.admit("T", "a", hedge=False)       # primaries still admit


def test_hedge_joining_open_batch_window_is_admitted():
    """A hedged duplicate whose plan shape has an OPEN batch window on
    this server rides the primary's dispatch for (almost) free — the
    low-watermark hedge shed must not apply to it."""
    ctrl, _ = _controller(max_pending=10)          # low = 4
    _fill(ctrl, 4)
    d = ctrl.admit("T", "a", hedge=True)
    assert not d and d.cause == "hedge"            # no window: shed
    assert ctrl.admit("T", "a", hedge=True, batch_join=True)
    # the carve-out is hedge-specific sugar, not an admission bypass:
    # capacity still wins at max_pending (distinct tenants keep each
    # below its fair-share floor so only the capacity tier engages)
    for i in range(5):                             # depth 10 = max
        assert ctrl.admit("T", f"x{i}")
    d = ctrl.admit("T", "a", hedge=True, batch_join=True)
    assert not d and d.cause == "capacity"


def test_over_quota_tenant_shed_at_mid_watermark():
    ctrl, _ = _controller(max_pending=10)          # mid = 7
    _fill(ctrl, 6, tenant="aggressor")
    _fill(ctrl, 1, tenant="victim")                # depth 7, 2 active
    d = ctrl.admit("T", "aggressor")               # 6 >= fair (7//2=3)
    assert not d and d.cause == "tenantOverQuota"
    assert d.retry_after_ms > 0
    # the victim is under its fair share: admitted
    assert ctrl.admit("T", "victim")


def test_sole_tenant_never_fair_share_shed():
    # fair-share protects OTHER tenants: with a single active tenant
    # fair == depth == its own count, so the gate would shed EVERYTHING
    # at mid and brownout/capacity could never engage — it must not fire
    ctrl, _ = _controller(max_pending=10)          # mid = 7, high = 9
    _fill(ctrl, 7, tenant="only")
    d = ctrl.admit("T", "only")                    # depth 7 >= mid
    assert d and not d.brownout


def test_brownout_at_high_watermark_tightens_deadline():
    ctrl, _ = _controller(max_pending=10, est_table="T",
                          est_ms=40.0)             # high = 9
    _fill(ctrl, 5, tenant="a")
    _fill(ctrl, 4, tenant="b")                     # depth 9, fair split
    d = ctrl.admit("T", "c", budget_ms=10_000.0)
    assert d and d.brownout
    # deadline ≈ now + est × factor, far tighter than the 10s budget
    assert d.deadline_s == pytest.approx(
        100.0 + 40.0 * AdmissionController.BROWNOUT_FACTOR / 1e3)


@pytest.mark.parametrize("watermark, backlog, brownout", [
    (None, 3, False), (None, 4, True), (9, 4, False), (9, 9, True)])
def test_promotion_backlog_watermark_argument(watermark, backlog, brownout):
    """The promotion-backlog brownout fires at the class watermark (4) by
    default and at the controller's own when one is given; an idle queue
    otherwise never browns out."""
    ctrl, _ = _controller(max_pending=10, backlog_fn=lambda: backlog,
                          promotion_backlog_watermark=watermark)
    d = ctrl.admit("T", "a")
    assert d and d.brownout is brownout
    assert (d.deadline_s is not None) is brownout
    assert AdmissionController.PROMOTION_BACKLOG_WATERMARK == 4


def test_instance_passes_its_promotion_backlog_watermark():
    s = ServerInstance("wm0", device="cpu", promotion_backlog_watermark=9)
    try:
        assert s.admission.PROMOTION_BACKLOG_WATERMARK == 9
    finally:
        s.stop()
    s = ServerInstance("wm1", device="cpu")
    try:
        assert s.admission.PROMOTION_BACKLOG_WATERMARK == \
            AdmissionController.PROMOTION_BACKLOG_WATERMARK
    finally:
        s.stop()


def test_capacity_shed_at_max_pending():
    ctrl, metrics = _controller(max_pending=4)
    _fill(ctrl, 2, tenant="a")
    _fill(ctrl, 2, tenant="b")
    d = ctrl.admit("T", "c")
    assert not d and d.cause == "capacity"
    assert metrics.meter(ServerMeter.REQUESTS_SHED).count == 1
    assert metrics.meter(ServerMeter.REQUESTS_SHED,
                         table="capacity").count == 1


def test_release_restores_depth_and_tenant_share():
    ctrl, _ = _controller(max_pending=4)
    _fill(ctrl, 2, tenant="a")
    _fill(ctrl, 2, tenant="b")
    assert not ctrl.admit("T", "c")
    for _ in range(2):
        ctrl.release("a")
    assert ctrl.depth() == 2
    assert ctrl.admit("T", "c")


def test_estimator_never_registers_unknown_tables():
    # admission runs before any table-existence check — probing the
    # estimate must not create a per-table timer series, or a flood of
    # random table names grows the registry without bound
    ctrl, metrics = _controller(max_pending=100)
    for i in range(50):
        assert ctrl.admit(f"no-such-table-{i}", "a", budget_ms=1.0)
    _, _, timers = metrics.metric_maps()
    assert not any("no-such-table" in k for k in timers)


def test_busy_datatable_is_typed():
    dt = busy_datatable(7, "tenantOverQuota", 120.0)
    assert dt.metadata[SERVER_BUSY_KEY] == "tenantOverQuota"
    assert dt.metadata[RETRY_AFTER_MS_KEY] == "120"
    assert dt.metadata["requestId"] == "7"
    assert dt.exceptions[0].startswith(SERVER_BUSY_EXC_PREFIX)
    # survives the wire round-trip the router reads it from
    rt = DataTable.from_bytes(dt.to_bytes())
    assert rt.metadata[SERVER_BUSY_KEY] == "tenantOverQuota"


# ---------------------------------------------------------------------------
# Instance integration: typed busy replies + cache bypass
# ---------------------------------------------------------------------------


@pytest.fixture()
def server():
    s = ServerInstance("s0", max_pending=8, device="cpu")
    d = tempfile.mkdtemp()
    _jseg, cols = build_segment(d, n=800, seed=3, name="adm_0")
    s.data_manager.table("baseballStats_OFFLINE",
                         create=True).add_segment(
        ImmutableSegmentLoader.load(d))
    yield s, cols
    s.stop()


def _request(pql, request_id=1, **kw):
    return instance_request_to_bytes(InstanceRequest(
        request_id=request_id, query=compile_pql(pql), **kw))


def test_saturated_server_sheds_with_typed_reply(server):
    s, _ = server
    # saturate admission without real threads (distinct tenants so
    # the fair-share gate doesn't fire before the capacity gate)
    for i in range(s.admission.max_pending):
        assert s.admission.admit("baseballStats_OFFLINE", f"x{i}")
    reply = DataTable.from_bytes(s.handle_request_bytes(
        _request("SELECT COUNT(*) FROM baseballStats_OFFLINE")))
    assert reply.metadata.get(SERVER_BUSY_KEY) == "capacity"
    assert reply.exceptions and \
        reply.exceptions[0].startswith(SERVER_BUSY_EXC_PREFIX)


def test_cache_hit_bypasses_saturated_admission(server):
    s, cols = server
    pql = "SELECT COUNT(*) FROM baseballStats_OFFLINE"
    warm = DataTable.from_bytes(s.handle_request_bytes(_request(pql)))
    assert not warm.exceptions
    for i in range(s.admission.max_pending):
        assert s.admission.admit("baseballStats_OFFLINE", f"x{i}")
    hit = DataTable.from_bytes(s.handle_request_bytes(_request(pql, 2)))
    assert hit.metadata.get(RESULT_CACHE_HIT_KEY) == "1"
    assert hit.rows == warm.rows           # bit-identical result
    # ...while an uncached query is still shed
    other = DataTable.from_bytes(s.handle_request_bytes(
        _request("SELECT SUM(runs) FROM baseballStats_OFFLINE", 3)))
    assert other.metadata.get(SERVER_BUSY_KEY) == "capacity"


def test_workload_tags_namespaced_and_bounded(server):
    s, _ = server
    q = compile_pql("SELECT COUNT(*) FROM baseballStats_OFFLINE")
    untagged = InstanceRequest(request_id=1, query=q)
    tagged = InstanceRequest(request_id=2, query=q, workload="alice")
    spoof = InstanceRequest(request_id=3, query=q,
                            workload="baseballStats_OFFLINE")
    assert s._tenant(untagged) == "baseballStats_OFFLINE"
    assert s._tenant(tagged) == "w:alice"
    # OPTION(workload=<table name>) must NOT join untagged traffic's
    # per-table scheduler group / fair-share bucket
    assert s._tenant(spoof) != s._tenant(untagged)
    # past the cap, unseen client-chosen tags fall back to the
    # (config-bounded) table group instead of growing scheduler state
    s._tenant_tags = {f"t{i}" for i in range(s.MAX_TENANT_TAGS - 1)} \
        | {"alice"}
    flood = InstanceRequest(request_id=4, query=q, workload="fresh-tag")
    assert s._tenant(flood) == "baseballStats_OFFLINE"
    assert s._tenant(tagged) == "w:alice"      # seen tags keep working


def test_shed_requests_do_not_burn_tag_budget(server):
    """A flood of unique workload tags that are ALL shed must not
    consume permanent tag slots — otherwise 256 rejected requests
    would lock every later tenant out of per-tenant isolation until
    server restart. Slots commit only on admission."""
    s, _ = server
    for i in range(s.admission.max_pending):
        assert s.admission.admit("baseballStats_OFFLINE", f"x{i}")
    for i in range(20):
        reply = DataTable.from_bytes(s.handle_request_bytes(_request(
            "SELECT COUNT(*) FROM baseballStats_OFFLINE", 10 + i,
            workload=f"flood-{i}")))
        assert reply.metadata.get(SERVER_BUSY_KEY) == "capacity"
    assert s._tenant_tags == set()          # nothing committed
    for i in range(s.admission.max_pending):
        s.admission.release(f"x{i}")
    ok = DataTable.from_bytes(s.handle_request_bytes(_request(
        "SELECT COUNT(*) FROM baseballStats_OFFLINE", 99,
        workload="alice")))
    assert not ok.exceptions
    assert s._tenant_tags == {"alice"}      # admitted → slot committed


def test_hedge_flag_travels_and_sheds_under_pressure(server):
    s, _ = server
    low = s.admission.low
    for _ in range(low):
        assert s.admission.admit("baseballStats_OFFLINE", "x")
    reply = DataTable.from_bytes(s.handle_request_bytes(
        _request("SELECT MAX(hits) FROM baseballStats_OFFLINE",
                 hedge=True)))
    assert reply.metadata.get(SERVER_BUSY_KEY) == "hedge"
