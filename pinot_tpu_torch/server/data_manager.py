"""Server-side segment lifecycle: refcounted acquire/release, atomic swap.

Parity: pinot-core/.../core/data/manager/ — InstanceDataManager (:40) →
TableDataManager (BaseTableDataManager.acquireSegment :224) →
SegmentDataManager (synchronized refcount :29-60). Queries acquire segments
before planning and release after execution, so a segment replaced or
dropped mid-query stays alive (its HBM arrays undestroyed) until the last
in-flight query releases it — the reference's protection against Helix
transitions racing queries.
"""
from __future__ import annotations

import threading
from typing import Dict, List, Optional, Sequence

from pinot_tpu_torch.segment.loader import ImmutableSegment, ImmutableSegmentLoader


class SegmentDataManager:
    """Refcounted holder of one loaded segment (starts at refcount 1)."""

    def __init__(self, segment: ImmutableSegment):
        self.segment = segment
        self._refcount = 1
        self._lock = threading.Lock()

    @property
    def name(self) -> str:
        return self.segment.segment_name

    @property
    def refcount(self) -> int:
        return self._refcount

    def increase_reference_count(self) -> bool:
        with self._lock:
            if self._refcount == 0:
                return False
            self._refcount += 1
            return True

    def decrease_reference_count(self) -> bool:
        """Returns True when the segment should be destroyed (count hit 0)."""
        with self._lock:
            if self._refcount == 0:
                return False
            self._refcount -= 1
            return self._refcount == 0


class TableDataManager:
    """All segments of one table on this server.

    Parity: BaseTableDataManager — addSegment replaces same-name segments
    atomically; acquireSegments returns refcount-bumped managers plus the
    names it could not find (missing segments are reported, not fatal —
    ServerQueryExecutorV1Impl.java:136-147).
    """

    def __init__(self, table_name: str):
        self.table_name = table_name
        self._segments: Dict[str, SegmentDataManager] = {}
        self._lock = threading.Lock()
        self._removal_listeners: List = []

    def add_removal_listener(self, fn) -> None:
        """fn(segment_name) fires when a segment is replaced or removed —
        lets caches (e.g. the sharded stack cache) evict promptly."""
        self._removal_listeners.append(fn)

    def _notify_removed(self, name: str) -> None:
        for fn in self._removal_listeners:
            try:
                fn(name)
            except Exception:  # noqa: BLE001 — a listener bug must not
                pass           # abort the transition or leak the segment

    def add_segment(self, segment: ImmutableSegment) -> None:
        sdm = SegmentDataManager(segment)
        with self._lock:
            old = self._segments.get(sdm.name)
            self._segments[sdm.name] = sdm
        if old is not None:
            self._notify_removed(sdm.name)
            self._release(old)

    def add_segment_from_dir(self, seg_dir: str) -> None:
        self.add_segment(ImmutableSegmentLoader.load(seg_dir))

    def remove_segment(self, name: str) -> None:
        with self._lock:
            old = self._segments.pop(name, None)
        if old is not None:
            self._notify_removed(name)
            self._release(old)

    def segment_names(self) -> List[str]:
        with self._lock:
            return list(self._segments.keys())

    def acquire_segments(self, names: Optional[Sequence[str]] = None
                         ) -> tuple:
        """→ (acquired managers, missing names)."""
        acquired: List[SegmentDataManager] = []
        missing: List[str] = []
        with self._lock:
            wanted = list(names) if names is not None \
                else list(self._segments.keys())
            for n in wanted:
                sdm = self._segments.get(n)
                if sdm is not None and sdm.increase_reference_count():
                    acquired.append(sdm)
                else:
                    missing.append(n)
        return acquired, missing

    def release_segment(self, sdm: SegmentDataManager) -> None:
        if sdm.decrease_reference_count():
            sdm.segment.destroy()

    def _release(self, sdm: SegmentDataManager) -> None:
        # drop the table's own reference (taken at construction)
        if sdm.decrease_reference_count():
            sdm.segment.destroy()

    def shutdown(self) -> None:
        with self._lock:
            sdms = list(self._segments.values())
            self._segments.clear()
        for sdm in sdms:
            self._release(sdm)


class InstanceDataManager:
    """All tables hosted by this server instance."""

    def __init__(self):
        self._tables: Dict[str, TableDataManager] = {}
        self._lock = threading.Lock()
        self._removal_listeners: List = []

    def add_removal_listener(self, fn) -> None:
        """Attach fn(segment_name) to every current and future table."""
        with self._lock:
            self._removal_listeners.append(fn)
            tables = list(self._tables.values())
        for tdm in tables:
            tdm.add_removal_listener(fn)

    def table(self, table_name: str, create: bool = False
              ) -> Optional[TableDataManager]:
        with self._lock:
            tdm = self._tables.get(table_name)
            if tdm is None and create:
                tdm = TableDataManager(table_name)
                for fn in self._removal_listeners:
                    tdm.add_removal_listener(fn)
                self._tables[table_name] = tdm
            return tdm

    def table_names(self) -> List[str]:
        with self._lock:
            return list(self._tables.keys())

    def num_segments(self) -> int:
        with self._lock:
            tables = list(self._tables.values())
        return sum(len(t.segment_names()) for t in tables)

    def shutdown(self) -> None:
        with self._lock:
            tables = list(self._tables.values())
            self._tables.clear()
        for t in tables:
            t.shutdown()
