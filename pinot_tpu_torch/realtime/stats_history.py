"""Per-table consuming-segment statistics history.

Parity: core/realtime/impl/RealtimeSegmentStatsHistory.java:49 — a
bounded, disk-persisted window of completed consuming segments' observed
stats (rows indexed, per-column cardinality, average MV count). The next
consuming segment sizes its initial allocations from the estimates, the
memory-provisioning feedback loop that keeps steady-state consumption
from paying repeated growth copies.
"""
from __future__ import annotations

import json
import os
import threading
from typing import Dict, List, Optional

MAX_ENTRIES_PER_TABLE = 10


class RealtimeSegmentStatsHistory:
    """Rolling window of segment stats, persisted as JSON."""

    def __init__(self, path: str):
        self.path = path
        self._lock = threading.Lock()
        self._tables: Dict[str, List[dict]] = {}  # tpulint: disable=cache-bound -- keyed by table name (bounded by cluster tables); inner lists trimmed to max_rows
        try:
            with open(path) as fh:
                data = json.load(fh)
            if isinstance(data, dict):
                self._tables = {t: list(v) for t, v in data.items()}
        except (OSError, ValueError):
            pass                      # fresh/corrupt file: start empty

    # -- record ------------------------------------------------------------
    def add_segment_stats(self, table: str, stats: dict) -> None:
        """stats: {"numRowsIndexed": int,
        "columns": {col: {"cardinality": int, "avgMvCount": float}}}."""
        with self._lock:
            window = self._tables.setdefault(table, [])
            window.append(stats)
            del window[:-MAX_ENTRIES_PER_TABLE]
            self._save()

    def _save(self) -> None:
        tmp = f"{self.path}.tmp"
        try:
            os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
            with open(tmp, "w") as fh:  # tpulint: disable=lock-blocking -- stats persist at segment-flush cadence (minutes); the lock pairs the in-memory update with its durable image
                json.dump(self._tables, fh)
            os.replace(tmp, self.path)     # atomic: never a torn file
        except OSError:
            pass                      # stats are advisory, never fatal

    # -- estimate ----------------------------------------------------------
    def estimate(self, table: str) -> Optional[dict]:
        """Allocation hint for the next consuming segment, averaged over
        the window; None with no history (callers use defaults). Only
        the row estimate drives allocations today; per-column stats stay
        raw in entries() (read by provisioning tooling)."""
        with self._lock:
            window = self._tables.get(table)
            if not window:
                return None
            rows = [int(e.get("numRowsIndexed", 0)) for e in window]
            return {"rows": int(sum(rows) / len(rows))}

    def entries(self, table: str) -> List[dict]:
        with self._lock:
            return list(self._tables.get(table, ()))
