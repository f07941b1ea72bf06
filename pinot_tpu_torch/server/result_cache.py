"""Server-side CRC-exact result cache.

Copy of pinot_tpu/server/result_cache.py (JAX-free), its imports rebased
onto pinot_tpu_torch.

Key = (table, canonical query fingerprint, frozen segment state), where
the segment state is the sorted tuple of every queried segment's
``(name, CRC, validDocIds version)``. Exactness falls out of PR 4's
end-to-end CRC discipline:

- an immutable segment's bytes are named by its CRC — a refreshed or
  re-built segment is a NEW crc, so a stale entry can never be served
  (invalidation is free: the key simply stops being constructed);
- an upsert invalidation bumps the segment's validDocIds version,
  which is part of the key for the same reason;
- a consuming (mutable) segment has no CRC — any request touching one
  is simply not cacheable here (the broker-level freshness-bounded
  cache covers hybrid traffic).

Values are the serialized DataTable payload from the original
execution; a hit deserializes a FRESH DataTable (no shared mutable
state with past or future queries), so cached results are bit-identical
to uncached ones on every execution path — host, device scan, or
mesh-sharded — because they ARE the original path's bytes.

Hits bypass the admission queue entirely: under overload, repetitive
dashboard traffic keeps being served from cache while the admission
controller sheds the non-repetitive excess — the graceful-degradation
valve ROADMAP item 5 asks for.
"""
from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Optional, Tuple


def segment_cache_states(segments) -> Optional[Tuple]:
    """Frozen cache-state tuple for a set of acquired segments, or None
    when any segment is uncacheable (mutable / missing CRC)."""
    states = []
    for seg in segments:
        if getattr(seg, "is_mutable", False):
            return None
        meta = getattr(seg, "metadata", None)
        crc = getattr(meta, "crc", None) if meta is not None else None
        if not crc:
            return None
        vd = getattr(seg, "valid_doc_ids", None)
        states.append((seg.segment_name, crc,
                       -1 if vd is None else int(vd.version)))
    return tuple(sorted(states))


class ServerResultCache:
    """Bounded LRU of serialized DataTable payloads."""

    def __init__(self, max_entries: int = 256,
                 max_bytes: int = 64 << 20):
        self.max_entries = int(max_entries)
        self.max_bytes = int(max_bytes)
        self._entries: "OrderedDict[tuple, bytes]" = OrderedDict()
        self._bytes = 0
        self._gen = 0
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0

    @property
    def generation(self) -> int:
        """Bumped by every clear(). Capture it BEFORE executing a query
        and pass it to put(): a segment swap's clear between execution
        and store then drops the stale insert instead of letting it
        re-enter under a key the post-swap segment also constructs
        (a same-CRC reload over an evolved schema never changes the
        key again, so a raced re-insert would be served forever)."""
        with self._lock:
            return self._gen

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    @staticmethod
    def key(table: str, fingerprint: str, seg_states: Tuple) -> tuple:
        return (table, fingerprint, seg_states)

    def get(self, key: tuple) -> Optional[bytes]:
        with self._lock:
            payload = self._entries.get(key)
            if payload is None:
                self.misses += 1
                return None
            self._entries.move_to_end(key)
            self.hits += 1
            return payload

    def put(self, key: tuple, payload: bytes,
            gen: Optional[int] = None) -> None:
        size = len(payload)
        if size > self.max_bytes:
            return                       # a single giant result: skip
        with self._lock:
            if gen is not None and gen != self._gen:
                return    # a clear (segment swap) raced this execution
            old = self._entries.pop(key, None)
            if old is not None:
                self._bytes -= len(old)
            self._entries[key] = payload
            self._bytes += size
            while self._entries and (
                    len(self._entries) > self.max_entries or
                    self._bytes > self.max_bytes):
                _, evicted = self._entries.popitem(last=False)
                self._bytes -= len(evicted)

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            self._bytes = 0
            self._gen += 1

    def stats(self) -> dict:
        with self._lock:
            return {"entries": len(self._entries), "bytes": self._bytes,
                    "hits": self.hits, "misses": self.misses}


class SingleFlight:
    """Cold-cache dedup for IDENTICAL concurrent queries.

    N requests sharing a full result-cache key (table + canonical
    fingerprint + frozen segment states) on a cold cache are the
    degenerate batch — same literals, same everything. The first probe
    becomes the LEADER and executes; followers block (bounded) on the
    leader's completion and then RE-PROBE the cache. Correctness never
    depends on the leader: a follower whose wait times out, or whose
    re-probe still misses (leader failed, cache cleared by a segment
    swap, entry evicted), simply falls through to its own execution —
    the pre-existing behavior.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._waiters: "dict[tuple, threading.Event]" = {}

    def begin(self, key: tuple):
        """(is_leader, event). Leaders MUST call done(key) afterwards
        (any outcome); followers wait on the event then re-probe."""
        with self._lock:
            ev = self._waiters.get(key)
            if ev is not None:
                return False, ev
            ev = threading.Event()
            self._waiters[key] = ev
            return True, ev

    def done(self, key: tuple) -> None:
        """The leader finished (stored, failed, or skipped the store):
        release every follower and retire the key."""
        with self._lock:
            ev = self._waiters.pop(key, None)
        if ev is not None:
            ev.set()
