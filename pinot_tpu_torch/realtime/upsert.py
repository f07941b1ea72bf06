"""Primary-key upsert metadata: key map, validDocIds, crash-consistent
recovery.

Parity: the reference's later-version upsert machinery
(PartitionUpsertMetadataManager / TableUpsertMetadataManager): a
per-partition map primary-key → (segment sequence, docId) of the LATEST
row per key, maintained by the realtime consumer; every superseded row
is recorded in its segment's `ValidDocIds` bitmap, which masks results
at query time on both the host scan path and the device kernels
(query/plan.py wires the mask as one more fused filter predicate).

Durability — the crash-consistency story (ISSUE 6 tentpole):

- **Delta journal** (`journal.jsonl`, per partition): one JSON line per
  ingested batch — the key→(seq, doc) assignments the batch made, plus
  the stream offset it ends at. Appended by the consumer thread, torn
  final line tolerated and truncated on recovery (same contract as the
  PR 4 property-store WAL).
- **Key-map snapshot** (`keymap-<seq>.json`): the whole partition map,
  written atomically at every segment SEAL (commit success). The journal
  is truncated after the snapshot lands — a crash between the two just
  replays deltas the snapshot already holds (idempotent).
- **validDocIds sidecars** (`validdocids-<segment>.json`): one per
  committed segment, rewritten at seal when the bitmap changed since
  the last write (a later row superseding an older segment's doc
  mutates that older segment's bitmap).

Recovery (restore(), run once per partition at first use after boot):
load the latest snapshot, load the sidecars, replay the journal tail —
the map and every bitmap converge to the crash instant without reading
the topic. The consuming segment then re-consumes from its durable
startOffset (its in-memory rows died with the process); re-applying
those rows is idempotent because replay is deterministic. A committed
segment that arrives with NO durable coverage (a replica that never
consumed it — the completion-FSM loser's download path — or a crash
before its first seal ever wrote) is FOLDED: its primary-key column is
read from the local artifact and reconciled against the map, which both
contributes its keys and recomputes its bitmap exactly.

The port's copy of pinot_tpu/realtime/upsert.py writes the same bytes
(journal, snapshots, sidecars) with fewer Python objects: key tuples
and numpy id arrays go to the JSON encoder as they are, and each file is
encoded in one call (the copy's ingest spent most of `apply_batch`
building per-row lists for the journal).

Crash points (common/faults.py): `upsert.seal` (at seal entry, after the
commit succeeded), `upsert.keymap_snapshot` (mid-snapshot-write, before
the atomic rename — the torn-write shape), `upsert.replay` (post-restart
journal replay). tests/test_upsert.py kills at each and asserts
exact-count + latest-value convergence after restart.
"""
from __future__ import annotations

import json
import logging
import os
import threading
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from pinot_tpu_torch.common.faults import crash_points
from pinot_tpu_torch.common.table_config import UpsertConfig
from pinot_tpu_torch.common.table_name import raw_table
from pinot_tpu_torch.realtime.segment_name import LLCSegmentName

log = logging.getLogger(__name__)

JOURNAL_FILE = "journal.jsonl"
SNAPSHOT_PREFIX = "keymap-"
SIDECAR_PREFIX = "validdocids-"

#: store prefix where servers publish per-committed-segment deadness
#: (invalid doc ids + doc count + bitmap version) for the minion
#: plane's compaction generator/executor — any replica's snapshot is a
#: safe UNDER-approximation (bits only ever set when a newer row won,
#: a global fact), so compaction may drop exactly those docs and the
#: swap-time remap re-derives whatever died since
DEADNESS_ROOT = "/DEADNESS"


def deadness_path(table: str, segment: str) -> str:
    return f"{DEADNESS_ROOT}/{table}/{segment}"


class ValidDocIds:
    """Per-segment liveness bitmap: a doc is valid unless invalidated.

    Default-valid semantics (only invalidations are recorded) make the
    consumer's index-then-apply sequence safe: a freshly indexed row is
    visible to queries before its upsert delta is applied, and is never
    transiently masked. Single writer (the partition's consumer thread
    or the restore/fold path, both serialized by the partition lock);
    readers take consistent snapshot copies under the lock. `version`
    bumps on every invalidation so device-lane caches know to re-upload.
    """

    def __init__(self):
        self._invalid = np.zeros(0, dtype=bool)
        self._num_invalid = 0
        self.version = 0
        self._lock = threading.Lock()

    @property
    def num_invalid(self) -> int:
        return self._num_invalid

    def invalidate(self, doc: int) -> bool:
        """Mark `doc` superseded; True when the bit flipped."""
        with self._lock:
            if doc >= len(self._invalid):
                cap = max(len(self._invalid), 1024)
                while cap <= doc:
                    cap *= 2
                bigger = np.zeros(cap, dtype=bool)
                bigger[: len(self._invalid)] = self._invalid
                self._invalid = bigger
            if self._invalid[doc]:
                return False
            self._invalid[doc] = True
            self._num_invalid += 1
            self.version += 1
            return True

    def invalidate_many(self, docs) -> int:
        flipped = 0
        for d in docs:
            if self.invalidate(int(d)):
                flipped += 1
        return flipped

    def valid_mask(self, start: int, end: int) -> np.ndarray:
        """Consistent bool copy of [start, end): True = doc is live."""
        with self._lock:
            out = np.ones(end - start, dtype=bool)
            m = min(len(self._invalid), end)
            if m > start:
                out[: m - start] = ~self._invalid[start:m]
            return out

    def invalid_ids(self, n: int) -> np.ndarray:
        with self._lock:
            return np.flatnonzero(self._invalid[:n]).astype(np.int64)


def _normalizer(field) -> Callable:
    """Value normalizer for one primary-key column: the SAME function is
    applied to ingested row values and to values decoded back out of a
    committed segment, so keys compare equal across both paths (a FLOAT
    column's f32 round-trip would otherwise split one key in two)."""
    from pinot_tpu_torch.common.datatype import DataType
    dt = field.data_type.np_dtype
    if dt.kind in "iu":
        return lambda v: int(v)
    if dt.kind == "f":
        return lambda v: float(dt.type(v))
    if field.data_type == DataType.BYTES:
        return lambda v: (v.hex() if isinstance(v, (bytes, bytearray))
                          else str(v))
    return lambda v: str(v)


class PartitionUpsertMetadata:
    """One stream partition's key map + bitmaps + durable state.

    Writers: the partition's single consumer thread (apply_batch, seal)
    and state-transition threads (on_committed_segment fold) — all
    mutations take `_lock`. Readers (query paths) never touch the map;
    they read per-segment ValidDocIds snapshots.
    """

    def __init__(self, data_dir: str, table: str, partition: int,
                 enable_snapshot: bool = True):
        self.table = table
        self.partition = partition
        self.data_dir = data_dir
        self.enable_snapshot = enable_snapshot
        self._lock = threading.RLock()
        # key tuple -> (segment sequence, docId) of the LATEST row
        self._map: Dict[tuple, Tuple[int, int]] = {}
        self._valid: Dict[int, ValidDocIds] = {}      # seq -> bitmap
        self._covered: Dict[int, int] = {}            # seq -> docs covered
        self._sidecar_versions: Dict[int, int] = {}   # seq -> last written
        self._journal_f = None
        self.snapshot_offset = -1       # stream offset the snapshot covers
        self.replayed_offset = -1       # ... advanced by journal replay
        self.upserted_rows = 0          # rows that superseded an older doc
        self.masked_docs = 0            # docs invalidated
        self.remapped_segments = 0      # compacted artifacts remapped in
        self.gced_keys = 0              # map entries dropped by segment GC
        self._snapshot_seq = -1         # filename seq of the last snapshot
        os.makedirs(data_dir, exist_ok=True)
        self._restore()

    # -- core fold ---------------------------------------------------------

    def _bitmap(self, seq: int) -> ValidDocIds:
        with self._lock:                  # RLock: reentrant from callers
            vd = self._valid.get(seq)
            if vd is None:
                vd = self._valid[seq] = ValidDocIds()
            return vd

    def _apply(self, key: tuple, seq: int, doc: int) -> bool:
        """Fold one row into the map; True when it superseded an older
        doc. Order-independent: applying rows in any order converges to
        the same map and bitmaps (newest (seq, doc) wins; losers are
        invalidated wherever they live)."""
        with self._lock:                  # RLock: reentrant from callers
            loc = (seq, doc)
            e = self._map.get(key)
            if e == loc:
                return False             # idempotent replay
            if e is not None and e > loc:
                # an even newer row already owns the key: this doc is dead
                if self._bitmap(seq).invalidate(doc):
                    self.masked_docs += 1
                return False
            if e is not None:
                if self._bitmap(e[0]).invalidate(e[1]):
                    self.masked_docs += 1
            self._map[key] = loc
            return e is not None

    # -- ingest path -------------------------------------------------------

    def register_consuming(self, seq: int) -> ValidDocIds:
        """Bitmap for the consuming segment (restored state reused so a
        restarted consumer's re-applied rows land on the same bits)."""
        with self._lock:
            return self._bitmap(seq)

    def apply_batch(self, seq: int, keys_docs: List[Tuple[tuple, int]],
                    end_offset: int) -> int:
        """Fold one consumed batch; journal the deltas; returns the
        number of rows that superseded an existing key."""
        if not keys_docs:
            return 0
        with self._lock:
            upserts = 0
            for key, doc in keys_docs:
                if self._apply(key, seq, doc):
                    upserts += 1
            top = max(doc for _k, doc in keys_docs) + 1
            self._covered[seq] = max(self._covered.get(seq, 0), top)
            self.upserted_rows += upserts
            self._journal_append(seq, end_offset, keys_docs)
        return upserts

    def key_map_size(self) -> int:
        return len(self._map)

    # -- durability --------------------------------------------------------

    def _journal_path(self) -> str:
        return os.path.join(self.data_dir, JOURNAL_FILE)

    def _journal_append(self, seq: int, end_offset: int,
                        keys_docs: List[Tuple[tuple, int]]) -> None:
        if not self.enable_snapshot:
            return
        with self._lock:                  # RLock: reentrant from callers
            # seeded crash point: die before the append — the batch is
            # in memory but neither journaled nor offset-acked, so the
            # restarted consumer re-fetches and re-applies it (the
            # order-independent fold makes the replay idempotent)
            crash_points.hit("upsert.journal_append")
            try:
                if self._journal_f is None:
                    self._journal_f = open(self._journal_path(), "a")  # tpulint: disable=lock-blocking -- crash-consistency: the key-map mutation and its journal record must be atomic; append cadence is per consume batch, not per query
                # tuples encode as JSON arrays: the JAX module's bytes
                # without building a list per row
                rec = {"seq": int(seq), "off": int(end_offset),
                       "d": keys_docs}
                self._journal_f.write(json.dumps(rec, default=int) + "\n")
                self._journal_f.flush()
            except OSError:
                log.warning("upsert journal append failed for %s/p%d",
                            self.table, self.partition, exc_info=True)

    def seal(self, seq: int, end_offset: int, num_docs: int) -> None:
        """Segment SEAL hook (commit succeeded): snapshot the key map,
        write/update validDocIds sidecars, truncate the journal.

        Write order is crash-safe at every instruction: sidecars and the
        snapshot are staged + atomically renamed; the journal is only
        truncated AFTER the snapshot landed, so a crash in between
        replays deltas the snapshot already contains (idempotent)."""
        if not self.enable_snapshot:
            return
        crash_points.hit("upsert.seal")
        with self._lock:
            self._covered[seq] = max(self._covered.get(seq, 0),
                                     int(num_docs))
            entries = [(k, s, d) for k, (s, d) in self._map.items()]
            covered = dict(self._covered)
            bitmaps = {s: (self._valid[s].version,
                           self._valid[s].invalid_ids(covered.get(s, 0)))
                       for s in self._valid}
        for s, (ver, invalid) in sorted(bitmaps.items()):
            if self._sidecar_versions.get(s) == ver and \
                    os.path.exists(self._sidecar_path(s)):
                continue
            self._write_sidecar(s, covered.get(s, 0), invalid, ver)
        snap = {"seq": int(seq), "offset": int(end_offset),
                "entries": entries}
        path = os.path.join(self.data_dir, f"{SNAPSHOT_PREFIX}{seq}.json")
        tmp = f"{path}.tmp"
        with open(tmp, "w") as fh:
            fh.write(json.dumps(snap, default=int))
            fh.flush()
            os.fsync(fh.fileno())
        # seeded torn-write point: the process dies with the snapshot
        # staged but not renamed — recovery ignores the .tmp and falls
        # back to the previous snapshot + the (untruncated) journal
        crash_points.hit("upsert.keymap_snapshot")
        os.replace(tmp, path)
        with self._lock:
            self.snapshot_offset = int(end_offset)
            self._snapshot_seq = int(seq)
        for name in os.listdir(self.data_dir):
            if name.startswith(SNAPSHOT_PREFIX) and \
                    name.endswith(".json") and \
                    name != os.path.basename(path):
                try:
                    os.remove(os.path.join(self.data_dir, name))
                except OSError:
                    pass
        with self._lock:
            try:
                if self._journal_f is not None:
                    self._journal_f.close()
                self._journal_f = open(self._journal_path(), "w")  # tpulint: disable=lock-blocking -- seal(): journal truncate must pair atomically with the just-written key-map snapshot
            except OSError:
                self._journal_f = None

    def _sidecar_path(self, seq: int) -> str:
        name = LLCSegmentName(raw_table(self.table), self.partition,
                              seq).name
        return os.path.join(self.data_dir, f"{SIDECAR_PREFIX}{name}.json")

    def _write_sidecar(self, seq: int, num_docs: int,
                       invalid: np.ndarray, version: int) -> None:
        path = self._sidecar_path(seq)
        tmp = f"{path}.tmp"
        try:
            with open(tmp, "w") as fh:
                fh.write(json.dumps({"seq": int(seq),
                                     "numDocs": int(num_docs),
                                     "invalid": invalid.tolist()}))
            os.replace(tmp, path)
            with self._lock:
                self._sidecar_versions[seq] = version
        except OSError:
            log.warning("sidecar write failed for %s/p%d seq %d",
                        self.table, self.partition, seq, exc_info=True)

    # -- recovery ----------------------------------------------------------

    def _restore(self) -> None:
        if not self.enable_snapshot:
            return
        # boot-time single-threaded, but take the lock anyway so every
        # mutation site in this class is lexically guarded (RLock:
        # reentrant into _bitmap/_apply/_replay_journal)
        with self._lock:
            snaps = []
            for name in os.listdir(self.data_dir):
                if name.startswith(SNAPSHOT_PREFIX) and \
                        name.endswith(".json"):
                    try:
                        snaps.append(
                            (int(name[len(SNAPSHOT_PREFIX):-5]), name))
                    except ValueError:
                        continue
            snapshot_lost = False
            if snaps:
                _seq, name = max(snaps)
                self._snapshot_seq = int(_seq)
                try:
                    with open(os.path.join(self.data_dir, name)) as fh:  # tpulint: disable=lock-blocking -- _restore runs once at boot before the consumer starts; nothing else can hold or want this lock yet
                        snap = json.load(fh)
                    for k, s, d in snap.get("entries", ()):
                        self._map[tuple(k)] = (int(s), int(d))
                    self.snapshot_offset = int(snap.get("offset", -1))
                except (OSError, ValueError):
                    snapshot_lost = True
                    log.warning("unreadable upsert snapshot %s; folding "
                                "from segments instead", name,
                                exc_info=True)
            for name in sorted(os.listdir(self.data_dir)):
                if not (name.startswith(SIDECAR_PREFIX) and
                        name.endswith(".json")):
                    continue
                try:
                    with open(os.path.join(self.data_dir, name)) as fh:  # tpulint: disable=lock-blocking -- same boot-time-only invariant as the snapshot read above
                        side = json.load(fh)
                    seq = int(side["seq"])
                    vd = self._bitmap(seq)
                    self.masked_docs += vd.invalidate_many(side["invalid"])
                    # a LOST snapshot means sidecar-covered segments'
                    # map entries are gone too: leave them uncovered so
                    # attach_or_fold re-folds their keys (keeping the
                    # sidecar bits is still sound — masks never
                    # resurrect, and a superseded doc stays superseded)
                    if not snapshot_lost:
                        self._covered[seq] = max(self._covered.get(seq, 0),
                                                 int(side["numDocs"]))
                    self._sidecar_versions[seq] = vd.version
                except (OSError, ValueError, KeyError):
                    log.warning("unreadable validDocIds sidecar %s; the "
                                "segment will be folded from its keys",
                                name, exc_info=True)
            self._replay_journal()

    def _replay_journal(self) -> None:
        path = self._journal_path()
        if not os.path.exists(path):
            return
        # post-restart replay crash point: dying HERE (map partially
        # rebuilt) must leave the durable state replayable again
        crash_points.hit("upsert.replay")
        with self._lock:                  # RLock: reentrant from _restore
            good = 0
            try:
                with open(path, "rb") as fh:  # tpulint: disable=lock-blocking -- journal replay is boot-time-only (see _restore); held lock is uncontended by construction
                    raw = fh.read()
            except OSError:
                # IO failures are advisory (module contract): the fold
                # path re-derives masks — never block transitions
                log.warning("unreadable upsert journal for %s/p%d; "
                            "relying on segment folds", self.table,
                            self.partition, exc_info=True)
                return
            lines = raw.split(b"\n")
            unterminated_ok = False
            for i, line in enumerate(lines):
                last = i == len(lines) - 1
                if not line.strip():
                    good += len(line) + (0 if last else 1)
                    continue
                try:
                    rec = json.loads(line)
                    seq, off = int(rec["seq"]), int(rec["off"])
                    deltas = [(tuple(k), int(doc)) for k, doc in rec["d"]]
                except (ValueError, KeyError, TypeError):
                    break                   # torn tail: drop + truncate
                for key, doc in deltas:
                    self._apply(key, seq, doc)
                if deltas:
                    top = max(doc for _k, doc in deltas) + 1
                    self._covered[seq] = max(self._covered.get(seq, 0),
                                             top)
                self.replayed_offset = max(self.replayed_offset, off)
                good += len(line) + (0 if last else 1)
                if last:                    # split: last piece has no \n
                    unterminated_ok = True
            try:
                if good < len(raw):
                    with open(path, "ab") as fh:  # tpulint: disable=lock-blocking -- boot-time torn-tail repair, same uncontended-lock invariant
                        fh.truncate(good)
                elif unterminated_ok:
                    # crash cut the write exactly between the record and
                    # its newline: repair the terminator so the next
                    # append can't merge two records into one torn line
                    with open(path, "ab") as fh:  # tpulint: disable=lock-blocking -- boot-time newline repair, same uncontended-lock invariant
                        fh.write(b"\n")
            except OSError:
                pass

    # -- committed-segment attach / fold / remap ---------------------------

    def attach_or_fold(self, seq: int, segment,
                       keys_fn: Callable[[], List[tuple]]) -> ValidDocIds:
        """Give `segment` its ValidDocIds. When durable state exactly
        covers the segment's docs (local consume, or snapshot+journal
        restore), the registered bitmap attaches as-is; when it covers
        FEWER docs, the segment's primary keys (``keys_fn``) are folded
        into the map — the loser-download / lost-durable-state
        convergence path. When it covers MORE docs than the artifact
        holds, the artifact is a compacted (or discard-truncated)
        rewrite: its doc ids shifted, so the stale bitmap is discarded
        and every row is REMAPPED against the key map (same-key map
        entries move to the new doc id; rows whose key a newer segment
        owns are invalidated fresh)."""
        with self._lock:
            vd = self._valid.get(seq)
            covered = self._covered.get(seq, 0)
            if vd is not None and covered == segment.num_docs:
                return vd
            needs_remap = covered > segment.num_docs
        keys = keys_fn()                  # heavy decode outside the lock
        if needs_remap:
            return self._remap_segment(seq, keys)
        with self._lock:
            vd = self._bitmap(seq)
            upserts = 0
            for doc, key in enumerate(keys):
                if self._apply(key, seq, doc):
                    upserts += 1
            self.upserted_rows += upserts
            self._covered[seq] = max(self._covered.get(seq, 0), len(keys))
            return vd

    def _remap_segment(self, seq: int, keys: List[tuple]) -> ValidDocIds:
        """Compaction swap: rebuild seq's bitmap and re-point its map
        entries at the rewritten artifact's doc ids. The fold stays
        order-independent: a key some NEWER segment owns masks the
        compacted row; a key an OLDER segment owns is superseded by it
        (the compacted row is the same logical row that already won).
        Idempotent — re-running over an already-remapped map is a
        no-op — and persisted (snapshot + sidecar) so a crash after the
        swap does not resurrect stale doc ids on restart."""
        with self._lock:
            vd = ValidDocIds()
            self._valid[seq] = vd
            for doc, key in enumerate(keys):
                loc = (seq, doc)
                e = self._map.get(key)
                if e is None or e[0] == seq:
                    # this key's winner lives (or lived) in this segment:
                    # the compacted row IS that winner, at its new id
                    self._map[key] = loc
                elif e > loc:
                    # a newer segment superseded the key since compaction
                    if vd.invalidate(doc):
                        self.masked_docs += 1
                else:
                    # an older segment held the key: compacted row wins
                    if self._bitmap(e[0]).invalidate(e[1]):
                        self.masked_docs += 1
                    self._map[key] = loc
            self._covered[seq] = len(keys)
            self._sidecar_versions.pop(seq, None)
            self.remapped_segments += 1
            invalid = vd.invalid_ids(len(keys))
            version = vd.version
            num_docs = len(keys)
        # persist OUTSIDE the lock: snapshot first (remapped entries),
        # then the sidecar — a crash anywhere here re-runs the remap on
        # restart from whatever durable state survived; every path is
        # idempotent by the fold above. Seeded crash point: die with the
        # remap applied in memory but nothing persisted.
        crash_points.hit("upsert.compact_snapshot")
        self.snapshot_now(seq)
        self._write_sidecar(seq, num_docs, invalid, version)
        return vd

    def snapshot_now(self, seq_hint: int = 0) -> None:
        """Write a key-map snapshot outside the seal path (compaction
        remap / GC persistence). Same staged + fsync + atomic-rename
        discipline as seal; the journal is NOT truncated — its replay
        is idempotent over the newer snapshot, and offset bookkeeping
        belongs to seal alone. Deliberate twin of seal()'s snapshot
        block, NOT a shared helper: seal's own `open(tmp…)` stage and
        `os.replace(tmp…)` rename statements are the protocol tier's
        extraction anchors (analysis/protocol.py extract_seal) — moving
        them into a callee would break the shape contract the
        upsert-seal model is built from."""
        if not self.enable_snapshot:
            return
        with self._lock:
            seq = max(self._snapshot_seq, int(seq_hint))
            entries = [(k, s, d) for k, (s, d) in self._map.items()]
            offset = int(self.snapshot_offset)
        snap = {"seq": int(seq), "offset": offset, "entries": entries}
        path = os.path.join(self.data_dir, f"{SNAPSHOT_PREFIX}{seq}.json")
        tmp = f"{path}.tmp"
        try:
            with open(tmp, "w") as fh:
                fh.write(json.dumps(snap, default=int))
                fh.flush()
                os.fsync(fh.fileno())
            os.replace(tmp, path)
            with self._lock:
                self._snapshot_seq = seq
        except OSError:
            # advisory (module contract): the remap re-derives on boot
            log.warning("compact snapshot write failed for %s/p%d",
                        self.table, self.partition, exc_info=True)

    def gc_segment(self, seq: int) -> int:
        """Table-wide segment deletion (TTL retention / merge-away):
        drop every key-map entry whose winner lived in `seq`, its
        bitmap, coverage and sidecar — the key no longer exists in the
        table, so the map must stop carrying it (the `upsertKeyMapSize`
        growth story). Masks never resurrect: other segments' bits for
        keys this segment once superseded stay set. Returns the number
        of entries dropped."""
        dropped = self._gc_segment_inner(seq)
        if dropped:
            self._persist_gc()
        return dropped

    def _gc_segment_inner(self, seq: int) -> int:
        with self._lock:
            doomed = [k for k, loc in self._map.items() if loc[0] == seq]
            for k in doomed:
                del self._map[k]
            self._valid.pop(seq, None)
            self._covered.pop(seq, None)
            self._sidecar_versions.pop(seq, None)
            self.gced_keys += len(doomed)
        try:
            os.remove(self._sidecar_path(seq))
        except OSError:
            pass                          # never written / already gone
        return len(doomed)

    def _persist_gc(self) -> None:
        """Persist the shrunken map NOW: the record-removal event fires
        exactly once, so waiting for the next seal would let a crash
        resurrect the dropped entries from the old snapshot forever on
        a low-traffic partition. Seeded crash point: dying HERE leaves
        zombie entries in the old snapshot — a bounded metric skew
        (key_map_size overcounts), never a correctness loss (the
        deleted segment is unrouted and masks never resurrect); the
        boot-time `gc_missing` reconcile re-converges them."""
        crash_points.hit("upsert.gc_snapshot")
        self.snapshot_now()

    def gc_missing(self, live_seqs) -> int:
        """Boot/build-time reconcile: garbage-collect every seq this
        partition's durable state still tracks whose segment RECORD no
        longer exists in the cluster state. The record-removal watch
        (the online GC path) is in-memory and one-shot — a server that
        was down, restarting, or had not yet built the table's upsert
        manager when retention deleted a segment would otherwise carry
        its zombie keys forever. Returns entries dropped."""
        live = set(live_seqs)
        with self._lock:
            known = set(self._covered) | set(self._valid) | \
                {loc[0] for loc in self._map.values()}
        dropped = 0
        for seq in sorted(known - live):
            dropped += self._gc_segment_inner(seq)
        if dropped:
            self._persist_gc()
        return dropped

    def deadness_report(self, skip_versions: Optional[Dict[int, int]]
                        = None) -> Dict[int, dict]:
        """Per-seq deadness snapshot (invalid doc ids + covered docs +
        bitmap version) for obs-plane publication — the compaction
        generator's scheduling signal and the executor's drop list.
        `skip_versions` (seq → already-published version) suppresses
        unchanged bitmaps BEFORE their invalid-id lists are
        materialized, so a per-seal publication sweep is O(changed),
        not O(all segments × invalid docs)."""
        with self._lock:
            out = {}
            for seq, vd in self._valid.items():
                if skip_versions is not None and \
                        skip_versions.get(seq) == vd.version:
                    continue
                n = int(self._covered.get(seq, 0))
                out[seq] = {"version": int(vd.version), "numDocs": n,
                            "invalid": [int(i) for i in
                                        vd.invalid_ids(n)]}
            return out

    def close(self) -> None:
        with self._lock:
            if self._journal_f is not None:
                try:
                    self._journal_f.close()
                except OSError:
                    pass
                self._journal_f = None


class TableUpsertMetadataManager:
    """All partitions' upsert metadata for one realtime table on one
    server. Owns key extraction (schema-normalized so ingested rows and
    decoded segment columns produce identical key tuples)."""

    def __init__(self, table: str, config: UpsertConfig, schema,
                 data_dir: str, metrics=None, live_seqs_fn=None):
        """`live_seqs_fn`: partition -> set of sequences with a LIVE
        segment record — when wired, a freshly built/restored
        partition reconciles its durable key-map state against the
        cluster state (gc_missing), catching table-wide deletions this
        server's one-shot record watch missed while down."""
        self.table = table
        self.config = config
        self.data_dir = data_dir
        self.metrics = metrics
        self._live_seqs_fn = live_seqs_fn
        self._parts: Dict[int, PartitionUpsertMetadata] = {}
        self._lock = threading.Lock()
        self._normalizers: List[Tuple[str, Callable]] = []
        for col in config.primary_key_columns:
            field = next((f for f in schema.fields if f.name == col), None)
            if field is None:
                raise ValueError(
                    f"upsert primary key column '{col}' not in schema "
                    f"'{schema.schema_name}'")
            if not field.single_value:
                raise ValueError(
                    f"upsert primary key column '{col}' must be "
                    "single-value")
            self._normalizers.append((col, _normalizer(field)))
        if metrics is not None:
            self.register_metrics(metrics)

    def register_metrics(self, metrics) -> None:
        """Bind the key-map size gauge to THIS instance. Callers that
        race on construction must register only the winning instance —
        a discarded loser's callable would pin the gauge at 0."""
        with self._lock:
            self.metrics = metrics
        from pinot_tpu_torch.common.metrics import ServerGauge
        metrics.gauge(ServerGauge.UPSERT_KEY_MAP_SIZE,
                      self.table).set_callable(self.key_map_size)

    def partition(self, partition: int) -> PartitionUpsertMetadata:
        with self._lock:
            part = self._parts.get(partition)
            created = part is None
            if created:
                part = PartitionUpsertMetadata(
                    os.path.join(self.data_dir, f"partition_{partition}"),
                    self.table, partition,
                    enable_snapshot=self.config.enable_snapshot)
                self._parts[partition] = part
        if created and self._live_seqs_fn is not None:
            # reconcile restored state against the cluster records:
            # segments deleted while this server was away leave no
            # watch event — their keys must not resurrect
            try:
                dropped = part.gc_missing(self._live_seqs_fn(partition))
            except Exception:  # noqa: BLE001 — advisory reconcile:
                dropped = 0    # a flaky store read must not block boot
                log.warning("upsert GC reconcile failed for %s/p%d",
                            self.table, partition, exc_info=True)
            if dropped and self.metrics is not None:
                from pinot_tpu_torch.common.metrics import ServerMeter
                self.metrics.meter(ServerMeter.UPSERT_KEYS_GCED,
                                   self.table).mark(dropped)
        return part

    def key_of(self, row: dict) -> Optional[tuple]:
        """Normalized primary-key tuple, or None when any key value is
        missing or unconvertible — callers DROP such rows before
        indexing (the poison-row policy: one bad record must never kill
        the partition consumer, and an unindexed row needs no map
        entry so ingest and segment-fold stay consistent)."""
        out = []
        for col, norm in self._normalizers:
            v = row.get(col)
            if v is None:
                return None
            try:
                out.append(norm(v))
            except (TypeError, ValueError):
                return None
        return tuple(out)

    def segment_keys(self, segment) -> List[tuple]:
        """Primary-key tuples per docId, decoded from a loaded segment's
        columns (same normalization as the ingest path)."""
        cols = []
        for name, norm in self._normalizers:
            ds = segment.data_source(name)
            if getattr(ds, "dictionary", None) is not None:
                vals = np.asarray(ds.dictionary.values)[ds.dict_ids]
            else:
                vals = ds.raw_values
            cols.append([norm(v) for v in vals])
        if not cols:
            return []
        return list(zip(*cols))

    def on_committed_segment(self, segment_name: str, segment) -> None:
        """CONSUMING→ONLINE swap / cold-start load: attach (or fold, or
        — for a compacted rewrite whose doc ids shifted — remap) the
        committed segment's validDocIds and mark superseded rows."""
        try:
            llc = LLCSegmentName.parse(segment_name)
        except ValueError:
            return                         # non-LLC segment: not upserted
        part = self.partition(llc.partition)
        before = part.remapped_segments
        segment.valid_doc_ids = part.attach_or_fold(
            llc.sequence, segment, lambda: self.segment_keys(segment))
        if part.remapped_segments > before and self.metrics is not None:
            from pinot_tpu_torch.common.metrics import ServerMeter
            self.metrics.meter(ServerMeter.UPSERT_SEGMENTS_REMAPPED,
                               self.table).mark()

    def gc_segment_record(self, segment_name: str) -> int:
        """A segment's durable record left the cluster state (TTL
        retention / table-wide delete): garbage-collect its key-map
        entries so the map stops growing. No-op for partitions this
        server never built metadata for."""
        try:
            llc = LLCSegmentName.parse(segment_name)
        except ValueError:
            return 0
        with self._lock:
            part = self._parts.get(llc.partition)
        if part is None:
            return 0
        dropped = part.gc_segment(llc.sequence)
        if dropped and self.metrics is not None:
            from pinot_tpu_torch.common.metrics import ServerMeter
            self.metrics.meter(ServerMeter.UPSERT_KEYS_GCED,
                               self.table).mark(dropped)
        return dropped

    def deadness_reports(self, skip_versions: Optional[Dict[str, int]]
                         = None) -> Dict[str, dict]:
        """segment name → deadness record for every partition/seq this
        manager tracks (the obs-plane publication payload).
        `skip_versions` (segment name → already-published version)
        suppresses unchanged bitmaps before their lists are built."""
        with self._lock:
            parts = dict(self._parts)
        out: Dict[str, dict] = {}
        raw = raw_table(self.table)
        for partition, part in parts.items():
            per_seq = None
            if skip_versions is not None:
                per_seq = {}
                for name, ver in skip_versions.items():
                    try:
                        llc = LLCSegmentName.parse(name)
                    except ValueError:
                        continue
                    if llc.partition == partition:
                        per_seq[llc.sequence] = ver
            for seq, info in part.deadness_report(per_seq).items():
                name = LLCSegmentName(raw, partition, seq).name
                out[name] = dict(info, segment=name)
        return out

    def key_map_size(self) -> int:
        with self._lock:
            parts = list(self._parts.values())
        return sum(p.key_map_size() for p in parts)

    def close(self) -> None:
        with self._lock:
            parts = list(self._parts.values())
            self._parts.clear()
        for p in parts:
            p.close()
