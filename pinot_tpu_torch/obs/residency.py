"""HBM residency ledger: every device upload on the serving path is
accounted at ONE choke point.

Copy of pinot_tpu/obs/residency.py (the ledger, the sweepers and
bind_registry); the two upload choke points are torch twins that
take an explicit device and count each tensor's storage bytes.

Parity: the reference's PinotDataBuffer global accounting
(segment-spi/.../memory/PinotDataBuffer.java keeps a process-wide map
of every off-heap allocation with owner/context strings so operators
can answer "what is holding native memory"). On this architecture the
native memory is HBM, and the allocations are device uploads: segment
scan lanes, upsert validDocIds lanes, vector ``[n, dim]`` blocks,
sharded stack lanes, stage-2 join probe structures, window/HLL
operands, and exchange-held stage-1 blocks.

Every upload registers ``(owner, table, segment, kind, bytes)`` here —
through the :func:`ledgered_put` / :func:`ledgered_asarray` choke
points for device arrays, or :meth:`ResidencyLedger.register` for
byte-budgeted stores (the exchange plane) — and releases on eviction /
segment drop / sweep. The port's loader, stacks, join and window
operands and exchange blocks all register here, so the residency
manager (server/residency_manager.py) budgets against the bytes the
tensors really hold, not against torch.cuda.memory_allocated, whose
caching allocator keeps freed blocks.

Exposure: ``deviceBytesResident{table,kind}`` gauges on every
component's /metrics (pre-registered at boot so the first scrape
already carries the series), and the ``/debug/residency`` view on the
server admin API.

The ledger is process-global on purpose: HBM is a per-process resource,
so embedded multi-component clusters report one truthful total from
every component's registry rather than a per-component fiction.
"""
from __future__ import annotations

import threading
import weakref
from typing import Callable, Dict, List, Optional, Tuple

from pinot_tpu_torch.common.metrics import CommonGauge

#: the accounted upload kinds — also the pre-registered gauge series.
#: scan: immutable/frozen segment column lanes (ids/vals/raw/mv/parts/
#: vlane); vdoc: upsert validDocIds liveness lanes; vector: [n, dim]
#: embedding blocks; hll: per-dictId HLL register tables; stack: the
#: sharded executor's mesh-stacked lanes (incl. its num_docs vector);
#: join: stage-2 probe structures built from exchanged dim blocks;
#: window: stage-2 window operand columns; exchange: published stage-1
#: DataTable bytes held by an ExchangeManager.
KINDS = ("scan", "vdoc", "vector", "hll", "stack", "join", "window",
         "exchange")


class ResidencyLedger:
    """Thread-safe (owner → table/segment/kind/bytes) residency map.

    ``register`` with an owner key that is already present REPLACES the
    entry (re-upload of the same lane — e.g. a vdoc version bump — is a
    replacement, not a leak). Totals are maintained incrementally so
    gauge reads are O(1) dict lookups, never a scan.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        # owner → (table, segment, kind, nbytes)
        self._entries: Dict[str, Tuple[str, str, str, int]] = {}
        self._by_kind: Dict[str, int] = {k: 0 for k in KINDS}
        self._by_table_kind: Dict[Tuple[str, str], int] = {}
        self._total = 0
        # sweepers run before exchange-kind reads so expired entries
        # leave the books on scrape, not on the next put/get (the
        # bytes-conservation invariant the protocol model checks)
        self._sweepers: List[Callable[[], int]] = []
        # optional snapshot-entry annotator (the residency manager adds
        # tier + last-access heat so /debug/residency says WHY a byte
        # is resident, not just that it is)
        self._entry_annotator: Optional[Callable[[dict], None]] = None

    # -- accounting --------------------------------------------------------
    def register(self, owner: str, *, table: str, segment: str,
                 kind: str, nbytes: int) -> None:
        assert kind in KINDS, kind
        nbytes = int(nbytes)
        with self._lock:
            self._drop(owner)
            self._entries[owner] = (table, segment, kind, nbytes)
            self._by_kind[kind] = self._by_kind.get(kind, 0) + nbytes
            tk = (table, kind)
            self._by_table_kind[tk] = \
                self._by_table_kind.get(tk, 0) + nbytes
            self._total += nbytes
        if table:
            _ensure_table_gauge(table, kind)

    def release(self, owner: str) -> int:
        """Release one owner's entry; returns the bytes released."""
        with self._lock:
            return self._drop(owner)

    def release_prefix(self, prefix: str) -> int:
        """Release every entry whose owner starts with `prefix` (one
        segment's lanes, one stack's lanes, one manager's blocks)."""
        with self._lock:
            owners = [o for o in self._entries if o.startswith(prefix)]
            return sum(self._drop(o) for o in owners)

    def _drop(self, owner: str) -> int:
        # caller holds the lock
        entry = self._entries.pop(owner, None)
        if entry is None:
            return 0
        table, _segment, kind, nbytes = entry
        self._by_kind[kind] -= nbytes
        tk = (table, kind)
        left = self._by_table_kind.get(tk, 0) - nbytes
        if left:
            self._by_table_kind[tk] = left
        else:
            self._by_table_kind.pop(tk, None)
        self._total -= nbytes
        return nbytes

    # -- reads -------------------------------------------------------------
    def total_bytes(self) -> int:
        return self._total

    def kind_bytes(self, kind: str) -> int:
        if kind == "exchange":
            self.run_sweepers()
        return self._by_kind.get(kind, 0)

    def table_kind_bytes(self) -> Dict[Tuple[str, str], int]:
        with self._lock:
            return dict(self._by_table_kind)

    def snapshot(self, max_entries: int = 512) -> dict:
        """JSON-able view for /debug/residency: totals by table/kind
        plus the largest individual entries."""
        self.run_sweepers()
        with self._lock:
            tables: Dict[str, Dict[str, int]] = {}
            for (table, kind), n in self._by_table_kind.items():
                tables.setdefault(table or "", {})[kind] = n
            largest = sorted(self._entries.items(),
                             key=lambda kv: -kv[1][3])[:max_entries]
            snap = {
                "totalDeviceBytesResident": self._total,
                "byKind": {k: v for k, v in sorted(self._by_kind.items())
                           if v},
                "tables": {t: dict(sorted(ks.items()))
                           for t, ks in sorted(tables.items())},
                "entries": [
                    {"owner": o, "table": t, "segment": s, "kind": k,
                     "bytes": n}
                    for o, (t, s, k, n) in largest],
                "entryCount": len(self._entries),
            }
            annot = self._entry_annotator
        if annot is not None:
            for entry in snap["entries"]:
                annot(entry)
        return snap

    def set_entry_annotator(self, fn: Callable[[dict], None]) -> None:
        """Install (or clear, with None) a per-entry snapshot annotator.
        The residency manager uses this to stamp `tier` and `heat`
        columns onto entries it tracks — annotation runs OUTSIDE the
        ledger lock, on the already-built entry dicts."""
        with self._lock:
            self._entry_annotator = fn

    # -- sweep hooks (exchange TTL) ----------------------------------------
    def add_sweeper(self, fn: Callable[[], int]) -> None:
        with self._lock:
            self._sweepers.append(fn)

    def remove_sweeper(self, fn: Callable[[], int]) -> None:
        with self._lock:
            try:
                self._sweepers.remove(fn)
            except ValueError:
                pass

    def run_sweepers(self) -> int:
        """TTL-sweep every registered byte-budgeted store (exchange
        managers) so expired entries release NOW — scraping /metrics or
        /debug/residency must observe quiescent held-bytes at zero, not
        whenever the next put/get happens to sweep."""
        with self._lock:
            sweepers = list(self._sweepers)
        return sum(fn() for fn in sweepers)


#: the process-global ledger every upload site and gauge reads
LEDGER = ResidencyLedger()

#: the declared metric name (common/metrics.py is the naming contract)
DEVICE_BYTES_RESIDENT = CommonGauge.DEVICE_BYTES_RESIDENT


# ---------------------------------------------------------------------------
# Upload choke points
# ---------------------------------------------------------------------------


def ledgered_put(tensor, *, device, owner: str, table: str, segment: str,
                 kind: str, non_blocking: bool = False):
    """``tensor.to(device)`` with ledger registration: THE accountable
    upload path (the torch twin of the JAX ``jax.device_put`` choke
    point). `owner` must be unique per resident tensor and stable across
    re-uploads of the same logical lane (replacement semantics). The
    entry counts the storage the tensor holds on `device`
    (``untyped_storage().nbytes()``), which is what the caching allocator
    cannot give back while the tensor lives."""
    out = tensor.to(device, non_blocking=non_blocking)
    LEDGER.register(owner, table=table, segment=segment, kind=kind,
                    nbytes=int(out.untyped_storage().nbytes()))
    return out


def ledgered_asarray(host, *, device, owner: str, table: str, segment: str,
                     kind: str):
    """A host array (numpy) as a tensor on `device`, registered in the
    ledger (the twin of the JAX ``jnp.asarray`` choke point; the dtype is
    the array's own: the port's lanes carry their narrow dtypes)."""
    import numpy as np
    import torch
    return ledgered_put(torch.from_numpy(np.ascontiguousarray(host)),
                        device=device, owner=owner, table=table,
                        segment=segment, kind=kind)


# ---------------------------------------------------------------------------
# Boot-time gauge wiring
# ---------------------------------------------------------------------------


#: registries bound at boot (weakly — embedded test clusters churn
#: registries); new (table, kind) pairs register their per-table gauge
#: on every live bound registry as uploads appear
_BOUND: List["weakref.ref"] = []
_BOUND_LOCK = threading.Lock()
_TABLE_GAUGES: set = set()


def _live_bound() -> List[object]:
    # caller holds _BOUND_LOCK; prunes dead refs in place
    live, refs = [], []
    for ref in _BOUND:
        m = ref()
        if m is not None:
            live.append(m)
            refs.append(ref)
    _BOUND[:] = refs
    return live


def bind_registry(metrics) -> None:
    """Pre-register every residency gauge on a component registry at
    boot: the bare process total plus one per-kind series (the
    ``kind`` label rides the registry's table-suffix convention as
    ``|<kind>``; obs/prometheus.py splits it back into labels). The
    first scrape therefore already carries `deviceBytesResident` —
    empty-registry exposition was a real PR 5 bug class. Per-table
    twins (``<table>|<kind>`` suffix) register as uploads appear."""
    metrics.gauge(DEVICE_BYTES_RESIDENT).set_callable(LEDGER.total_bytes)
    for kind in KINDS:
        metrics.gauge(DEVICE_BYTES_RESIDENT,
                      table=f"|{kind}").set_callable(
            lambda k=kind: LEDGER.kind_bytes(k))
    with _BOUND_LOCK:
        if not any(m is metrics for m in _live_bound()):
            _BOUND.append(weakref.ref(metrics))
        pairs = list(_TABLE_GAUGES)
    for table, kind in pairs:
        metrics.gauge(DEVICE_BYTES_RESIDENT,
                      table=f"{table}|{kind}").set_callable(
            lambda t=table, k=kind:
            LEDGER.table_kind_bytes().get((t, k), 0))


def _ensure_table_gauge(table: str, kind: str) -> None:
    with _BOUND_LOCK:
        if (table, kind) in _TABLE_GAUGES:
            return
        _TABLE_GAUGES.add((table, kind))
        bound = _live_bound()
    for metrics in bound:
        metrics.gauge(DEVICE_BYTES_RESIDENT,
                      table=f"{table}|{kind}").set_callable(
            lambda t=table, k=kind:
            LEDGER.table_kind_bytes().get((t, k), 0))
