"""PropertyStore: hierarchical JSON records with watches + durability.

Parity: the ZooKeeper property store as Pinot uses it through Helix
(ZKMetadataProvider paths: /CONFIGS/TABLE, /SEGMENTS/<table>/<segment>,
ideal states, external views). In-process, thread-safe, watch callbacks on
path prefixes — the single source of truth for cluster state, exactly the
role ZK plays; a networked implementation can replace it behind the same
interface.

Durability (parity: ZK's transaction log + fuzzy snapshots): with a
`data_dir`, every mutation is journaled to an append-only JSONL
write-ahead log before the call returns, and the store periodically
writes a compacted `snapshot-<seq>.json` and truncates the WAL. On
startup the newest valid snapshot is loaded and the WAL replayed on top;
a torn final record (crash mid-append) is dropped and the file truncated
back to the last complete record, exactly like ZK discarding a torn
txn-log tail.

Two record classes never reach the journal, mirroring ZK ephemerals:
  - records written with ``ephemeral=True`` (session-scoped liveness),
  - records under ``non_durable_prefixes`` (live instances, current
    states, the controller leader lease) — session state that described
    processes which no longer exist after a restart; replaying them
    would resurrect dead peers.
"""
from __future__ import annotations

import json
import logging
import os
import threading
from typing import Callable, Dict, List, Optional, Tuple

log = logging.getLogger(__name__)

Watcher = Callable[[str, Optional[dict]], None]

#: session/liveness state and its derivatives — never journaled, never
#: replayed (the layout constants live in state_machine.py /
#: leadership.py / tenants.py; duplicated here as plain strings because
#: property_store is the layer *below* them). LIVEINSTANCES and
#: CURRENTSTATES describe processes that no longer exist after a
#: restart; EXTERNALVIEW and BROKERRESOURCE are recomputed from them on
#: the first membership event, so replaying stale copies would route
#: queries at dead servers/brokers.
DEFAULT_NON_DURABLE_PREFIXES = (
    "/LIVEINSTANCES/",
    "/CURRENTSTATES/",
    "/EXTERNALVIEW/",
    "/BROKERRESOURCE/",
    "/CONTROLLER/LEADER",
)

WAL_FILE = "wal.jsonl"
SNAPSHOT_PREFIX = "snapshot-"

#: fsync policies for the WAL: "always" = fsync every append (survives
#: power loss); "never" = flush to the OS only (survives process crash —
#: the failure model the crash-recovery tests exercise — without paying
#: an fsync per cluster-state write)
FSYNC_ALWAYS = "always"
FSYNC_NEVER = "never"


class PropertyStore:
    def __init__(self, data_dir: Optional[str] = None,
                 fsync: str = FSYNC_NEVER,
                 snapshot_every: int = 1000,
                 non_durable_prefixes: Tuple[str, ...] =
                 DEFAULT_NON_DURABLE_PREFIXES):
        """`data_dir`: enable WAL + snapshot durability under this
        directory (None = in-memory only, the test/default shape).
        `fsync`: WAL flush policy (FSYNC_ALWAYS | FSYNC_NEVER).
        `snapshot_every`: journaled mutations between compacted
        snapshots (0 disables automatic snapshots)."""
        if fsync not in (FSYNC_ALWAYS, FSYNC_NEVER):
            raise ValueError(f"unknown fsync policy {fsync!r}")
        self._data: Dict[str, dict] = {}
        self._watchers: List[tuple] = []        # (prefix, callback)
        self._lock = threading.RLock()
        # serializes external-view composition (state_machine.compose_view
        # read-compute-write cycles from coordinator + ViewComposer threads)
        self.compose_lock = threading.Lock()
        # -- durability state ----------------------------------------------
        self.data_dir = data_dir
        self._fsync = fsync
        self._snapshot_every = snapshot_every
        self._non_durable = tuple(non_durable_prefixes)
        self._ephemeral_paths: set = set()
        self._wal = None                        # open WAL file handle
        self._seq = 0                           # last journaled seq
        self._ops_since_snapshot = 0
        if data_dir is not None:
            os.makedirs(data_dir, exist_ok=True)
            self._recover()

    # -- durability --------------------------------------------------------
    def _is_durable(self, path: str) -> bool:
        if path in self._ephemeral_paths:
            return False
        return not any(path.startswith(p) or path == p.rstrip("/")
                       for p in self._non_durable)

    def _recover(self) -> None:
        """Load newest valid snapshot, replay the WAL on top, tolerate a
        torn final record, and leave the WAL open for appends."""
        snap_seq = 0
        snaps = sorted((f for f in os.listdir(self.data_dir)
                        if f.startswith(SNAPSHOT_PREFIX) and
                        f.endswith(".json")),
                       key=self._snapshot_seq, reverse=True)
        for name in snaps:
            try:
                with open(os.path.join(self.data_dir, name)) as f:
                    snap = json.load(f)
                self._data = dict(snap["data"])
                snap_seq = int(snap["seq"])
                break
            except (ValueError, KeyError, OSError):
                log.warning("discarding corrupt snapshot %s", name)
        self._seq = snap_seq
        wal_path = os.path.join(self.data_dir, WAL_FILE)
        valid_bytes = 0
        if os.path.exists(wal_path):
            with open(wal_path, "rb") as f:
                for line in f:
                    if not line.endswith(b"\n"):
                        log.warning("dropping torn WAL tail (%d bytes)",
                                    len(line))
                        break
                    try:
                        rec = json.loads(line)
                        seq, op = rec["seq"], rec["op"]
                    except (ValueError, KeyError):
                        log.warning("dropping torn/corrupt WAL record; "
                                    "replay stops here")
                        break
                    valid_bytes += len(line)
                    if seq <= snap_seq:
                        continue        # already folded into the snapshot
                    if op == "set":
                        self._data[rec["path"]] = rec["record"]
                    elif op == "remove":
                        self._data.pop(rec["path"], None)
                    self._seq = max(self._seq, seq)
            size = os.path.getsize(wal_path)
            if valid_bytes < size:
                # truncate back to the last complete record so new
                # appends don't concatenate onto torn bytes. Seeded
                # crash point: dying DURING recovery's repair truncate
                # (the double-crash window) must leave the WAL
                # recoverable again — truncation only ever removes
                # already-rejected torn bytes, so re-running recovery
                # converges to the same state
                from pinot_tpu_torch.common.faults import crash_points
                crash_points.hit("store.recover_truncate")
                with open(wal_path, "r+b") as f:
                    f.truncate(valid_bytes)
        self._wal = open(wal_path, "a", encoding="utf-8")

    def _journal(self, op: str, path: str,
                 blob: Optional[str] = None) -> None:
        """Append one mutation to the WAL (caller holds self._lock).
        `blob` is the record pre-serialized by the caller — parsed here
        only once the write is known to be durable, so ephemeral /
        session-state writes (current states, heartbeats, views) pay no
        extra copy."""
        if self._wal is None or not self._is_durable(path):
            return
        self._seq += 1
        entry = {"seq": self._seq, "op": op, "path": path}
        if op == "set":
            entry["record"] = json.loads(blob)
        line = json.dumps(entry) + "\n"
        from pinot_tpu_torch.common.faults import InjectedCrash, crash_points
        crash_points.hit("store.wal_append")      # die before the append
        if crash_points.consume("store.wal_torn"):
            # die mid-append: a torn record reaches the disk — recovery
            # must drop it and truncate back to the last complete record
            self._wal.write(line[: max(1, len(line) // 2)])
            self._wal.flush()
            raise InjectedCrash("store.wal_torn")
        self._wal.write(line)
        self._wal.flush()
        if self._fsync == FSYNC_ALWAYS:
            os.fsync(self._wal.fileno())  # tpulint: disable=lock-blocking -- WAL append IS the durability design: journal order must equal mutation order, so the fsync belongs inside the lock (fsync policy gates the cost)
        self._ops_since_snapshot += 1
        if self._snapshot_every and \
                self._ops_since_snapshot >= self._snapshot_every:
            self._snapshot_locked()

    @staticmethod
    def _snapshot_seq(name: str) -> int:
        try:
            return int(name[len(SNAPSHOT_PREFIX):-len(".json")])
        except ValueError:
            return -1

    def _snapshot_locked(self) -> None:
        """Write a compacted snapshot and truncate the WAL (lock held).

        Crash-safe ordering: the snapshot is staged and atomically
        renamed BEFORE the WAL truncates; replay skips WAL records with
        seq <= snapshot seq, so a crash between the two steps only
        leaves harmless duplicates."""
        durable = {p: r for p, r in self._data.items()
                   if self._is_durable(p)}
        name = f"{SNAPSHOT_PREFIX}{self._seq}.json"
        tmp = os.path.join(self.data_dir, name + ".tmp")
        with open(tmp, "w", encoding="utf-8") as f:  # tpulint: disable=lock-blocking -- compaction must atomically pair the snapshot with the WAL truncate; writers pause for the (bounded, every-N-ops) snapshot by design
            json.dump({"seq": self._seq, "data": durable}, f)
            f.flush()
            os.fsync(f.fileno())  # tpulint: disable=lock-blocking -- same snapshot-swap atomicity invariant as the open() above
        # seeded crash point: snapshot staged but not renamed — the WAL
        # is untruncated, so recovery ignores the .tmp and replays the
        # (longer) journal over the previous snapshot
        from pinot_tpu_torch.common.faults import crash_points
        crash_points.hit("store.snapshot_rename")
        os.replace(tmp, os.path.join(self.data_dir, name))
        self._wal.close()
        self._wal = open(os.path.join(self.data_dir, WAL_FILE), "w",  # tpulint: disable=lock-blocking -- the WAL swap is part of the atomic snapshot step; a mutation slipping between truncate and reopen would be lost
                         encoding="utf-8")
        self._ops_since_snapshot = 0
        for old in os.listdir(self.data_dir):
            if old.startswith(SNAPSHOT_PREFIX) and old != name and \
                    not old.endswith(".tmp"):
                try:
                    os.remove(os.path.join(self.data_dir, old))
                except OSError:
                    pass

    def snapshot(self) -> None:
        """Force a compacted snapshot + WAL truncation now."""
        with self._lock:
            if self._wal is not None:
                self._snapshot_locked()

    def close(self) -> None:
        with self._lock:
            if self._wal is not None:
                self._wal.flush()
                if self._fsync == FSYNC_ALWAYS:
                    os.fsync(self._wal.fileno())  # tpulint: disable=lock-blocking -- close(): final flush must serialize against in-flight journaled mutations
                self._wal.close()
                self._wal = None

    def _mark_class(self, path: str, ephemeral: bool) -> None:
        """Latest-write-wins durability class (lock held): an ephemeral
        write shadowing a durable record journals the removal so replay
        can't resurrect the stale durable value; a durable write over a
        once-ephemeral path makes it journalable again."""
        if ephemeral:
            if path not in self._ephemeral_paths and \
                    path in self._data and self._is_durable(path):
                self._journal("remove", path, None)
            self._ephemeral_paths.add(path)
        else:
            self._ephemeral_paths.discard(path)

    # -- records -----------------------------------------------------------
    def set(self, path: str, record: dict, ephemeral: bool = False) -> None:
        """`ephemeral` binds the record to the writer's session where the
        store is networked (store_server passes it through); locally it
        only excludes the record from the durability journal."""
        blob = json.dumps(record)
        with self._lock:
            self._mark_class(path, ephemeral)
            self._data[path] = json.loads(blob)
            self._journal("set", path, blob)
            watchers = [cb for p, cb in self._watchers
                        if path.startswith(p)]
        # each watcher receives its own deep-copied snapshot — never the
        # caller's still-mutable object, and never a dict shared with
        # another watcher that may mutate it (get() defensively copies;
        # the push path must too)
        for cb in watchers:
            cb(path, json.loads(blob))

    def get(self, path: str) -> Optional[dict]:
        with self._lock:
            rec = self._data.get(path)
            return json.loads(json.dumps(rec)) if rec is not None else None

    def update(self, path: str, fn: Callable[[Optional[dict]], dict]
               ) -> dict:
        """Atomic read-modify-write (single-writer ideal-state updates).
        Always a durable-class write."""
        with self._lock:
            rec = fn(self.get(path))
            blob = json.dumps(rec)
            self._mark_class(path, ephemeral=False)
            self._data[path] = json.loads(blob)
            self._journal("set", path, blob)
            watchers = [cb for p, cb in self._watchers
                        if path.startswith(p)]
        for cb in watchers:
            cb(path, json.loads(blob))
        return rec

    def cas(self, path: str, expected: Optional[dict],
            record: dict, ephemeral: bool = False) -> bool:
        """Compare-and-set: apply only if the current record equals
        `expected` (None = path absent). The remote client's update()
        builds its read-modify-write loop on this."""
        blob = json.dumps(record)
        with self._lock:
            if self._data.get(path) != expected:
                return False
            self._mark_class(path, ephemeral)
            self._data[path] = json.loads(blob)
            self._journal("set", path, blob)
            watchers = [cb for p, cb in self._watchers
                        if path.startswith(p)]
        for cb in watchers:
            cb(path, json.loads(blob))
        return True

    def remove(self, path: str) -> bool:
        with self._lock:
            existed = self._data.pop(path, None) is not None
            if existed:
                self._journal("remove", path, None)
            self._ephemeral_paths.discard(path)
            watchers = [cb for p, cb in self._watchers
                        if path.startswith(p)] if existed else []
        for cb in watchers:
            cb(path, None)
        return existed

    def children(self, prefix: str) -> List[str]:
        """Paths directly under prefix (like ZK getChildren)."""
        if not prefix.endswith("/"):
            prefix += "/"
        with self._lock:
            out = set()
            for p in self._data:
                if p.startswith(prefix):
                    out.add(p[len(prefix):].split("/", 1)[0])
            return sorted(out)

    def list_paths(self, prefix: str) -> List[str]:
        with self._lock:
            return sorted(p for p in self._data if p.startswith(prefix))

    # -- watches -----------------------------------------------------------
    def watch(self, prefix: str, callback: Watcher) -> None:
        with self._lock:
            self._watchers.append((prefix, callback))

    def unwatch(self, callback: Watcher) -> None:
        with self._lock:
            self._watchers = [(p, cb) for p, cb in self._watchers
                              if cb is not callback]
