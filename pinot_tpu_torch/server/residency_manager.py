"""Tiered segment residency: HBM ↔ host ↔ disk under a device budget.

Copy of pinot_tpu/server/residency_manager.py (its state machine,
:113-592), the three tiers mapped onto this machine:

- **device**: the segment's lanes are CUDA tensors (segment/loader.py,
  every upload ledgered); queries run the kernels.
- **host**: the lanes copied into pinned host memory and freed on the
  card (`ImmutableSegment.release_device_lanes`; plain memory when the
  segment's device is the CPU); queries go to the host twin
  (query/host_exec.py) through the executor's `device_gate`, as in JAX,
  and a promotion uploads the pinned copies back (`warm_device`).
- **disk**: the host row payloads and lane copies dropped too; the
  segment directory is the reload source (`_reload_from_artifact`).

Budgets count the ledger's bytes (obs/residency.py, the tensors'
storage), never `torch.cuda.memory_allocated`, whose caching allocator
keeps freed blocks. Admission, heat, victims, the staged demote /
promote order and the crash points are the JAX manager's: a demotion
stages the host copy, publishes the tier, drains the query pins and only
then releases; a promotion uploads before it publishes.
"""
from __future__ import annotations

import math
import os
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from pinot_tpu_torch.common.faults import crash_points
from pinot_tpu_torch.common.metrics import (ServerGauge, ServerMeter,
                                      ServerQueryPhase)
from pinot_tpu_torch.obs import profiler as obs_profiler
from pinot_tpu_torch.obs.residency import LEDGER

TIER_DEVICE = "device"
TIER_HOST = "host"
TIER_DISK = "disk"
TIERS = (TIER_DEVICE, TIER_HOST, TIER_DISK)

#: env override for the device byte budget (config key
#: ``deviceBytesBudget`` on ServerInstance); unset → unbounded, which
#: preserves the pre-manager behavior exactly
BUDGET_ENV = "PINOT_TPU_DEVICE_BYTES_BUDGET"
#: optional host-RAM budget: when the host tier outgrows it, the
#: coldest host-tier segments continue to disk
HOST_BUDGET_ENV = "PINOT_TPU_HOST_BYTES_BUDGET"

#: heat decays with this half-life; an untouched segment loses half its
#: heat every interval, so "cold" is a property of recency, not age
HEAT_HALF_LIFE_S = 30.0
#: a non-device segment at or above this heat wants a promotion slot —
#: the promotion-backlog gauge (and the admission brownout watermark)
#: counts exactly these
PROMOTE_MIN_HEAT = 0.5
#: demotion waits at most this long for in-flight pins to drain before
#: skipping the victim (a wedged query must not wedge the evictor)
PIN_DRAIN_TIMEOUT_S = 30.0


class ResidencyError(RuntimeError):
    """A tier transition could not be performed safely (e.g. demote to
    disk without a reloadable artifact)."""


class _Entry:
    """Residency state for one tracked immutable segment."""

    __slots__ = ("table", "name", "seg", "seg_dir", "tier", "heat",
                 "last_access", "device_bytes", "host_bytes", "pins",
                 "epoch", "cond", "swap_lock", "disk_columns",
                 "cold_hits")

    def __init__(self, table: str, seg, seg_dir: Optional[str],
                 now: float, seed_heat: float):
        self.table = table
        self.name = seg.segment_name
        self.seg = seg
        self.seg_dir = seg_dir
        self.tier = TIER_DEVICE
        self.heat = seed_heat
        self.last_access = now
        self.device_bytes = int(seg.device_bytes_estimate())
        from pinot_tpu_torch.segment.loader import segment_host_bytes
        self.host_bytes = int(segment_host_bytes(seg))
        self.pins = 0
        self.epoch = 0
        self.cond = threading.Condition()
        # serializes demote/promote on this entry; pin/unpin do NOT
        # take it (a drain-waiting evictor must not block unpinning)
        self.swap_lock = threading.Lock()
        self.disk_columns: Tuple[str, ...] = ()
        self.cold_hits = 0


class ResidencyManager:
    """Budgeted, heat-driven HBM residency for immutable segments.

    One instance per server process (HBM is a per-process resource —
    the module-global ``MANAGER`` mirrors the ledger's process-global
    convention); ``ServerInstance`` configures the budget and wires the
    metrics registry, removal listeners and release hooks.
    """

    def __init__(self, budget_bytes: Optional[int] = None,
                 host_budget_bytes: Optional[int] = None,
                 clock: Callable[[], float] = time.monotonic):
        self.budget_bytes = budget_bytes
        self.host_budget_bytes = host_budget_bytes
        self._clock = clock
        self._lock = threading.Lock()
        # segment name → entry; bounded by the segments this server
        # hosts: untrack (the data-manager removal listener) pops
        self._entries: Dict[str, _Entry] = {}
        self._metrics = None
        # called with the segment name whenever its device lanes are
        # released, so derived caches (sharded stacks) evict promptly
        self._release_hooks: List[Callable[[str], None]] = []
        # called under budget pressure BEFORE victim demotion — derived
        # duplicated HBM (stack caches) is the cheapest eviction
        self._pressure_hooks: List[Callable[[], None]] = []

    # -- configuration ------------------------------------------------------
    def configure(self, budget_bytes: Optional[int],
                  host_budget_bytes: Optional[int] = None) -> None:
        with self._lock:
            self.budget_bytes = budget_bytes
            self.host_budget_bytes = host_budget_bytes

    def bind_metrics(self, metrics) -> None:
        """Wire gauges onto a component registry: per-tier
        deviceBytesResident twins (`|tier:<t>` suffix → `tier` label)
        and the promotion backlog the admission brownout watches."""
        with self._lock:
            self._metrics = metrics
        for tier in TIERS:
            metrics.gauge(ServerGauge.RESIDENCY_TIER_BYTES,
                          table=f"|tier:{tier}").set_callable(
                lambda t=tier: self.tier_bytes(t))
        metrics.gauge(ServerGauge.RESIDENCY_PROMOTION_BACKLOG) \
            .set_callable(self.promotion_backlog)
        LEDGER.set_entry_annotator(self._annotate_entry)

    def add_release_hook(self, fn: Callable[[str], None]) -> None:
        self._release_hooks.append(fn)

    def add_pressure_hook(self, fn: Callable[[], None]) -> None:
        self._pressure_hooks.append(fn)

    # -- tracking -----------------------------------------------------------
    def track(self, table: str, seg, *,
              seg_dir: Optional[str] = None) -> str:
        """Register a segment under residency management (attach path).
        Admission is decided HERE: within budget the segment enters
        device-tier (warm uploads proceed); over budget it enters
        host-tier directly — a cold table's bulk reload cannot evict a
        hot table's working set, because eviction only claims victims
        strictly colder than the segment asking."""
        now = self._clock()
        entry = _Entry(table, seg, seg_dir, now,
                       self._seed_heat(table))
        with self._lock:
            self._entries[entry.name] = entry
        if not self._admit_device(entry):
            entry.tier = TIER_HOST
        return entry.name

    def untrack(self, segment_name: str) -> None:
        """Removal-listener hook: the data manager owns destruction;
        the manager only forgets (and stops gauging) the segment."""
        with self._lock:
            self._entries.pop(segment_name, None)

    def tracked(self, segment_name: str) -> Optional[str]:
        entry = self._entries.get(segment_name)
        return entry.tier if entry is not None else None

    def warm_device(self, segment_name: str, columns=None) -> bool:
        """Budget-routed eager warm-up: uploads a tracked segment's
        lanes only while it holds device tier (the loader's raw
        ``seg.warm_device()`` bypasses admission — serving paths go
        through here). Returns whether the warm actually ran."""
        entry = self._entries.get(segment_name)
        if entry is None or entry.tier != TIER_DEVICE:
            return False
        entry.seg.warm_device(columns)
        return True

    # -- heat ---------------------------------------------------------------
    def _seed_heat(self, table: str) -> float:
        """New segments of query-hot tables start warm (PR 5 per-table
        queryProcessing stats feed the seed) so attach ordering does
        not decide who gets evicted first."""
        base = 1.0
        if self._metrics is not None:
            timer = self._metrics.peek_timer(
                ServerQueryPhase.QUERY_PROCESSING, table=table)
            if timer is not None and timer.count:
                base += math.log2(1.0 + timer.count)
        return base

    def _heat(self, entry: _Entry, now: Optional[float] = None) -> float:
        now = self._clock() if now is None else now
        dt = max(0.0, now - entry.last_access)
        return entry.heat * 0.5 ** (dt / HEAT_HALF_LIFE_S)

    def _touch(self, entry: _Entry) -> None:
        now = self._clock()
        entry.heat = self._heat(entry, now) + 1.0
        entry.last_access = now

    # -- query-path hooks ---------------------------------------------------
    def device_allowed(self, seg) -> bool:
        """Per-segment execution gate: untracked segments keep the
        default device path; tracked segments run device kernels only
        while device-tier (host/disk serve through host_exec)."""
        entry = self._entries.get(getattr(seg, "segment_name", None))
        return entry is None or entry.tier == TIER_DEVICE

    def begin_query(self, segments: Sequence) -> List[Tuple[_Entry, int]]:
        """Per-query entry: bump heat, reload disk-tier segments
        (metered cold hits), promote hot off-device segments when the
        budget admits them, and pin each tracked segment's lane epoch
        so a concurrent demotion cannot release lanes mid-read. The
        returned token MUST be passed to end_query (try/finally)."""
        entries = []
        for seg in segments:
            entry = self._entries.get(getattr(seg, "segment_name", None))
            if entry is not None and entry.seg is seg:
                entries.append(entry)
        # pin strictly BEFORE tier work: victim scans skip pinned
        # entries, so once our pins are up no eviction we trigger below
        # (and no concurrent one) can release a lane this query reads.
        # Promotion/reload never drain pins, so holding our own pins
        # here cannot self-deadlock
        pinned: List[Tuple[_Entry, int]] = []
        for entry in entries:
            with entry.cond:
                entry.pins += 1
                pinned.append((entry, entry.epoch))
        # the ledger counts HBM the manager did not allocate (join/
        # window/exchange scratch, realtime snapshots); when THAT
        # pushes the total over budget, shed the coldest unpinned
        # segments — external pressure degrades residency, it never
        # breaks the budget invariant
        if self.budget_bytes is not None and \
                LEDGER.total_bytes() > self.budget_bytes:
            self._evict_for(0, float("inf"))
        for entry in entries:
            self._touch(entry)
            if entry.tier == TIER_DISK:
                self.ensure_host(entry.name)
            if entry.tier != TIER_DEVICE and \
                    self._heat(entry) >= PROMOTE_MIN_HEAT:
                self.promote_segment(entry.name)
        return pinned

    def end_query(self, token: List[Tuple[_Entry, int]]) -> None:
        for entry, _epoch in token:
            with entry.cond:
                entry.pins -= 1
                entry.cond.notify_all()

    def mutable_device_allowed(self, _mseg) -> bool:
        """Gate for realtime frozen-snapshot uploads: under budget
        pressure the consuming segment serves host-side instead of
        freezing a new device snapshot."""
        if self.budget_bytes is None:
            return True
        return LEDGER.total_bytes() < self.budget_bytes

    # -- admission / eviction ----------------------------------------------
    def _admit_device(self, entry: _Entry) -> bool:
        """May `entry` occupy HBM? Judged against the LEDGER total (the
        ground truth that includes stacks/join/window/exchange bytes),
        evicting strictly-colder victims first when over budget."""
        if self.budget_bytes is None:
            return True
        need = entry.device_bytes
        if LEDGER.total_bytes() + need <= self.budget_bytes:
            return True
        self._evict_for(need, self._heat(entry))
        return LEDGER.total_bytes() + need <= self.budget_bytes

    def _evict_for(self, need: int, asking_heat: float) -> None:
        """Free HBM for `need` bytes: derived caches first (pressure
        hooks), then device-tier victims strictly colder than the
        asking segment, ordered (heat asc, bytes desc)."""
        for hook in self._pressure_hooks:
            hook()
        if LEDGER.total_bytes() + need <= self.budget_bytes:
            return
        now = self._clock()
        with self._lock:
            # pinned entries are under active read — poor victims; skip
            # them rather than stall the asker on their drain (a racing
            # pin after this check still drains in demote_segment).
            # Mid-swap entries (locked swap_lock) are skipped too: one
            # of them may be the ASKER whose promotion is driving this
            # eviction, and its lock is not reentrant
            victims = [e for e in self._entries.values()
                       if e.tier == TIER_DEVICE and e.pins == 0 and
                       not e.swap_lock.locked() and
                       self._heat(e, now) < asking_heat]
        victims.sort(key=lambda e: (self._heat(e, now),
                                    -e.device_bytes, e.name))
        for victim in victims:
            if LEDGER.total_bytes() + need <= self.budget_bytes:
                return
            try:
                self.demote_segment(victim.name, TIER_HOST)
            except ResidencyError:
                # drain timeout / stage failure: eviction degrades (the
                # asker stays off-device), it never fails the query
                continue
        self._enforce_host_budget()

    def _enforce_host_budget(self) -> None:
        """Host tier overflow continues to disk (coldest first) when a
        host budget is configured — the second stage of degradation."""
        if self.host_budget_bytes is None:
            return
        now = self._clock()
        with self._lock:
            # a mid-swap host-tier entry may be the asker promoting out
            # of this tier right now (it holds its own swap_lock, which
            # is not reentrant) — never pick it as a victim; pinned
            # entries are under active read, skip them likewise
            hosted = [e for e in self._entries.values()
                      if e.tier == TIER_HOST and e.pins == 0 and
                      not e.swap_lock.locked()]
        hosted.sort(key=lambda e: (self._heat(e, now),
                                   -e.host_bytes, e.name))
        held = sum(e.host_bytes for e in hosted)
        for victim in hosted:
            if held <= self.host_budget_bytes:
                return
            try:
                if self.demote_segment(victim.name, TIER_DISK):
                    held -= victim.host_bytes
            except ResidencyError:
                continue

    # -- staged tier transitions -------------------------------------------
    #
    # The step order below is EXTRACTED by analysis/protocol.py
    # (extract_residency) and model-checked; renaming the helper calls
    # or reordering the publish/drain/release sequence is a protocol
    # change and shows up as a protocol-model.json diff.

    def demote_segment(self, key: str, tier: str) -> bool:
        """Staged demotion (device→host, or any→disk). Publishes the
        fallback BEFORE releasing the device lanes: stage/verify the
        host copy (and, for disk, the reload artifact), publish the
        tier so new queries route off-device, drain in-flight query
        pins, then release."""
        assert tier in (TIER_HOST, TIER_DISK), tier
        entry = self._entries.get(key)
        if entry is None:
            return False
        with entry.swap_lock:
            if entry.tier == tier or \
                    (tier == TIER_HOST and entry.tier == TIER_DISK):
                return False
            self._stage_host(entry)
            crash_points.hit("residency.demote_staged")
            if tier == TIER_DISK:
                self._require_artifact(entry)
            crash_points.hit("residency.pre_publish")
            entry.tier = tier
            self._await_unpinned(entry)
            crash_points.hit("residency.pre_release")
            self._release_lanes(entry, tier)
            entry.epoch += 1
        if self._metrics is not None:
            self._metrics.meter(ServerMeter.RESIDENCY_DEMOTIONS,
                                table=tier).mark()
        return True

    def promote_segment(self, key: str) -> bool:
        """Staged promotion back to HBM: reload from the artifact when
        disk-tier, upload the lanes, and only then publish device-tier
        — a query routed mid-promotion still takes the host path
        against intact host arrays."""
        entry = self._entries.get(key)
        if entry is None:
            return False
        with entry.swap_lock:
            if entry.tier == TIER_DEVICE:
                return False
            if not self._admit_device(entry):
                return False
            if entry.tier == TIER_DISK:
                self._reload_from_artifact(entry)
            entry.seg.warm_device()
            entry.tier = TIER_DEVICE
            entry.epoch += 1
        if self._metrics is not None:
            self._metrics.meter(ServerMeter.RESIDENCY_PROMOTIONS,
                                table=entry.table).mark()
        obs_profiler.count_path("residencyPromote")
        return True

    def ensure_host(self, key: str) -> None:
        """Promote a disk-tier segment to host (the cold-hit path):
        reload+rebind BEFORE publishing host-tier, so a racing query
        never sees a half-rebound segment."""
        entry = self._entries.get(key)
        if entry is None:
            return
        with entry.swap_lock:
            if entry.tier != TIER_DISK:
                return
            self._reload_from_artifact(entry)
            entry.tier = TIER_HOST
            entry.epoch += 1

    # -- transition steps ---------------------------------------------------
    def _stage_host(self, entry: _Entry) -> None:
        """Verify the host copy every fallback path needs is present
        (device lanes are built from host arrays, so device-tier
        implies host copies — this guards the disk→host edge case,
        loudly)."""
        if entry.tier == TIER_DISK:
            raise ResidencyError(
                f"segment '{entry.name}' is disk-tier; promote before "
                "demoting again")
        seg = entry.seg
        for name in seg.column_names:
            ds = seg.data_source(name)
            if ds.dict_ids is None and ds.raw_values is None and \
                    ds.mv_dict_ids is None and ds.vec_values is None and \
                    ds.dictionary is None:
                raise ResidencyError(
                    f"segment '{entry.name}' column '{name}' has no "
                    "host copy to publish")

    def _require_artifact(self, entry: _Entry) -> None:
        """A disk-tier segment must stay reloadable: verify the
        artifact parses NOW (promoted-implies-artifact, the invariant
        the model checker holds crash-at-every-step) and record which
        columns it can restore — schema-synthesized default columns and
        virtual columns keep their (tiny) host arrays."""
        if entry.seg_dir is None:
            raise ResidencyError(
                f"segment '{entry.name}' has no artifact directory; "
                "cannot demote to disk")
        from pinot_tpu_torch.segment.metadata import SegmentMetadata
        try:
            meta = SegmentMetadata.load(entry.seg_dir)
        except Exception as exc:
            raise ResidencyError(
                f"segment '{entry.name}' artifact at "
                f"'{entry.seg_dir}' is not reloadable: {exc}") from exc
        entry.disk_columns = tuple(
            name for name in entry.seg.column_names
            if name in meta.columns)

    def _await_unpinned(self, entry: _Entry) -> None:
        """Drain in-flight query pins before releasing lanes — the
        runtime half of no-read-of-released-lane. Times out (skipping
        nothing: the release still happens only for an unpinned entry
        or after the deadline logs the wedge) rather than wedging the
        evictor forever behind a stuck query."""
        deadline = time.monotonic() + PIN_DRAIN_TIMEOUT_S
        with entry.cond:
            while entry.pins > 0:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise ResidencyError(
                        f"segment '{entry.name}' pins did not drain in "
                        f"{PIN_DRAIN_TIMEOUT_S}s; aborting demotion")
                entry.cond.wait(timeout=remaining)

    def _release_lanes(self, entry: _Entry, tier: str) -> None:
        """Release the device lanes (and, for disk, the host row
        payloads the verified artifact can restore), then poke release
        hooks so derived caches (sharded stacks) drop promptly."""
        entry.seg.release_device_lanes()
        if tier == TIER_DISK:
            entry.seg.release_host_lanes(entry.disk_columns)
        for hook in self._release_hooks:
            hook(entry.name)

    def _reload_from_artifact(self, entry: _Entry) -> None:
        """Disk→host: load a fresh copy of the artifact and rebind its
        host payloads into the LIVE segment object (identity preserved
        for the data manager / caches). Metered as a cold hit and
        profiler-attributed so PROFILE artifacts name the cost."""
        from pinot_tpu_torch.segment.loader import ImmutableSegmentLoader
        fresh = ImmutableSegmentLoader.load(entry.seg_dir)
        entry.seg.rebind_host_lanes(fresh)
        entry.cold_hits += 1
        if self._metrics is not None:
            self._metrics.meter(ServerMeter.RESIDENCY_COLD_HITS,
                                table=entry.table).mark()
        obs_profiler.count_path("residencyCold")

    # -- observability ------------------------------------------------------
    def tier_bytes(self, tier: str) -> int:
        """Estimated bytes per tier: device reads the entries' device
        charge, host/disk read the retained host footprint."""
        with self._lock:
            entries = [e for e in self._entries.values()
                       if e.tier == tier]
        if tier == TIER_DEVICE:
            return sum(e.device_bytes for e in entries)
        if tier == TIER_HOST:
            return sum(e.host_bytes for e in entries)
        return sum(e.host_bytes for e in entries)

    def promotion_backlog(self) -> int:
        """Segments hot enough for HBM but still off-device — the
        admission controller brownouts above a watermark of these (a
        reload storm means queries already pay cold/host penalties;
        shedding load early beats timing out late)."""
        now = self._clock()
        with self._lock:
            return sum(1 for e in self._entries.values()
                       if e.tier != TIER_DEVICE and
                       self._heat(e, now) >= PROMOTE_MIN_HEAT)

    def snapshot(self) -> dict:
        """JSON-able manager view (joined into /debug/residency)."""
        now = self._clock()
        with self._lock:
            entries = list(self._entries.values())
        tiers = {t: {"segments": 0, "bytes": 0} for t in TIERS}
        segs = []
        for e in sorted(entries, key=lambda e: e.name):
            tiers[e.tier]["segments"] += 1
            tiers[e.tier]["bytes"] += (e.device_bytes
                                       if e.tier == TIER_DEVICE
                                       else e.host_bytes)
            segs.append({"segment": e.name, "table": e.table,
                         "tier": e.tier,
                         "heat": round(self._heat(e, now), 3),
                         "deviceBytes": e.device_bytes,
                         "hostBytes": e.host_bytes,
                         "pins": e.pins, "epoch": e.epoch,
                         "coldHits": e.cold_hits})
        return {"deviceBytesBudget": self.budget_bytes,
                "ledgerTotalBytes": LEDGER.total_bytes(),
                "promotionBacklog": self.promotion_backlog(),
                "tiers": tiers, "segments": segs}

    def _annotate_entry(self, entry: dict) -> None:
        """Snapshot-entry annotator installed on the ledger: stamps
        `tier` and last-access `heat` onto /debug/residency's largest-
        entries rows for segments this manager tracks."""
        tracked = self._entries.get(entry.get("segment", ""))
        if tracked is not None:
            entry["tier"] = tracked.tier
            entry["heat"] = round(self._heat(tracked), 3)

    def shutdown(self) -> None:
        # `==`: each attribute access makes a new bound method, so `is`
        # never matches and the process-wide ledger would keep this
        # manager, its hooks and the instance's stacks (their lanes on
        # the card) alive after shutdown
        if LEDGER._entry_annotator == self._annotate_entry:
            LEDGER.set_entry_annotator(None)
        with self._lock:
            self._entries.clear()


def budget_from_env() -> Optional[int]:
    raw = os.environ.get(BUDGET_ENV, "").strip()
    return int(raw) if raw else None


def host_budget_from_env() -> Optional[int]:
    raw = os.environ.get(HOST_BUDGET_ENV, "").strip()
    return int(raw) if raw else None


#: the process-global manager (HBM is a per-process resource, like the
#: ledger); ServerInstance configures budget/metrics at boot
MANAGER = ResidencyManager(budget_from_env(), host_budget_from_env())
