"""Stage-2 join context: exchanged dim blocks → probe/gather tables.

Copy of pinot_tpu/query/stages/join.py. One addition: `sorted_keys`,
the raw-key probe operand sorted on the card by K12 once per query
(the JAX kernels sort it inside every launch).

The JoinContext is built once per server query from the fetched stage-1
dim blocks (already dim-filtered, already upsert-masked by the normal
scan path) and attached to the server-local request copy as
``request._join_ctx``; the planner (query/plan.py `_resolve_join_pred` /
`_plan_group_by`) and the host oracle (query/host_exec.py `_join_probe`)
both read it, so every execution path probes the SAME dim arrays.

Join-key contract: single-value INTEGER columns on both sides, and dim
keys UNIQUE (star-schema PK semantics — each fact row matches at most
one dim row). Violations raise StageCompileError → typed 4xx at the
broker, never a crash.

Co-partitioned dispatch: when both tables are partitioned on their join
keys by the same function, each published dim block carries the
partition ids of the segments it scanned, and `filter_sources` drops
sources disjoint from the fact server's own partitions. This is purely
a transfer optimization — fetching a superset of the needed dim rows
never changes the probe result (a dim row of another partition can
match no local fact key by the shared-partition-function premise), so
the mode is safe to decide per-server from segment metadata alone.
"""
from __future__ import annotations

import threading
import weakref
from typing import Dict, List, Optional, Tuple

import numpy as np

from pinot_tpu_torch.common.datatable import DataTable
from pinot_tpu_torch.common.request import JoinSpec
from pinot_tpu_torch.ops import kernels
from pinot_tpu_torch.query.stages import exchange
from pinot_tpu_torch.query.stages.errors import StageCompileError

#: dim-side row cap for a broadcast join — one device selection window
#: (plan.MAX_SELECTION_K); the stage-1 publish fails loudly past it
DIM_CAP = 1 << 16


def columns_of(dt: DataTable) -> Dict[str, object]:
    """name → column (numpy array or list) from a selection DataTable,
    preferring the zero-copy v3 column blocks."""
    if dt.col_data is not None and dt._rows is None:
        return dict(zip(dt.columns, dt.col_data))
    cols = list(zip(*dt.rows)) if dt.rows else \
        [() for _ in dt.columns]
    return {name: list(col) for name, col in zip(dt.columns, cols)}


class JoinContext:
    """Probe/gather tables over the assembled dim side."""

    def __init__(self, spec: JoinSpec, keys: np.ndarray,
                 columns: Dict[str, object]):
        self.spec = spec
        self.fact_key = spec.fact_key
        self.dim_table = spec.dim_table
        if len(keys) and (not isinstance(keys, np.ndarray) or
                          keys.dtype.kind not in "iu"):
            raise StageCompileError(
                f"join keys must be INTEGER columns; dim key "
                f"'{spec.dim_key}' decoded as "
                f"{getattr(keys, 'dtype', type(keys).__name__)}")
        self.keys = np.asarray(keys, dtype=np.int64)
        if len(np.unique(self.keys)) != len(self.keys):
            raise StageCompileError(
                f"dim join key '{spec.dim_key}' values are not unique — "
                "inner joins require star-schema PK semantics on the "
                "dim side")
        self._columns = columns
        self.order = np.argsort(self.keys, kind="stable").astype(np.int64)
        self.skeys = self.keys[self.order]
        self._lock = threading.Lock()
        self._member_cache: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}  # tpulint: disable=cache-bound -- keyed by id(dictionary): bounded by the query's segment count; the context dies with the query
        self._codings: Dict[str, Tuple[np.ndarray, np.ndarray]] = {}  # tpulint: disable=cache-bound -- one coding per projected dim column: bounded by the join's column list
        # the sorted device probes of a raw fact key (K12 builds each once
        # per device): (key dtype, dim column or None) -> SortedKeys
        self._sorted: Dict[tuple, kernels.SortedKeys] = {}  # tpulint: disable=cache-bound -- one per (fact key dtype, projected dim column): bounded by the join's column list
        # residency: the probe tables become kernel operands (member and
        # jcode tables a dispatch, the sorted raw keys once a device);
        # account them for the context's lifetime, as the JAX context
        # does: a query holds at most its own dim side, and the finalizer
        # releases when the stage's plans drop the context
        from pinot_tpu_torch.obs import residency
        nbytes = (self.keys.nbytes + self.order.nbytes +
                  self.skeys.nbytes +
                  sum(c.nbytes for c in columns.values()
                      if isinstance(c, np.ndarray)))
        owner = f"join:{id(self)}"
        residency.LEDGER.register(owner, table=spec.dim_table or "",
                                  segment="", kind="join", nbytes=nbytes)
        weakref.finalize(self, residency.LEDGER.release, owner)

    @property
    def empty(self) -> bool:
        return len(self.keys) == 0

    # -- probe -------------------------------------------------------------
    def _translate(self, values: np.ndarray
                   ) -> Tuple[np.ndarray, np.ndarray]:
        """(hit bool, dim row int64) per entry of `values` (any integer
        array — a dictionary's value table or a raw per-row lane).
        Cached per dictionary object for the per-segment planning path."""
        key = id(values)
        with self._lock:
            cached = self._member_cache.get(key)
        if cached is not None:
            return cached
        v = np.asarray(values, dtype=np.int64)
        if len(self.skeys):
            pos = np.clip(np.searchsorted(self.skeys, v), 0,
                          len(self.skeys) - 1)
            hit = self.skeys[pos] == v
            dimrow = self.order[pos]
        else:
            hit = np.zeros(len(v), dtype=bool)
            dimrow = np.zeros(len(v), dtype=np.int64)
        with self._lock:
            return self._member_cache.setdefault(key, (hit, dimrow))

    def member_for(self, dict_values: np.ndarray) -> np.ndarray:
        """bool [cardinality]: which fact dictIds join (the member-vector
        predicate of the dict-keyed probe)."""
        return self._translate(dict_values)[0]

    def probe_values(self, values: np.ndarray
                     ) -> Tuple[np.ndarray, np.ndarray]:
        """Row-domain probe (host oracle path): (hit, dimrow) —
        uncached, values are per-query row lanes."""
        v = np.asarray(values, dtype=np.int64)
        if not len(self.skeys):
            return np.zeros(len(v), dtype=bool), \
                np.zeros(len(v), dtype=np.int64)
        pos = np.clip(np.searchsorted(self.skeys, v), 0,
                      len(self.skeys) - 1)
        hit = self.skeys[pos] == v
        return hit, self.order[pos]

    # -- dim columns -------------------------------------------------------
    def dim_values(self, dcol: str) -> np.ndarray:
        col = self._columns.get(dcol)
        if col is None:
            raise StageCompileError(
                f"dim column '{dcol}' was not shipped by the stage-1 "
                "scan")
        return col if isinstance(col, np.ndarray) else \
            np.asarray(col, dtype=object)

    def group_coding(self, dcol: str) -> Tuple[np.ndarray, np.ndarray]:
        """(codes int32 [D], uniques): the dim column factorized — codes
        are the group-key domain the kernels aggregate in, uniques the
        decode table."""
        with self._lock:
            cached = self._codings.get(dcol)
        if cached is not None:
            return cached
        vals = self.dim_values(dcol)
        uniq, inv = np.unique(vals, return_inverse=True)
        coding = (inv.astype(np.int32), uniq)
        with self._lock:
            return self._codings.setdefault(dcol, coding)

    def code_table_for(self, dict_values: np.ndarray, dcol: str,
                       card_pad: int) -> np.ndarray:
        """int32 [card_pad] fact-dictId → dim group code (0 on misses —
        masked by the join predicate everywhere)."""
        hit, dimrow = self._translate(dict_values)
        codes, _uniq = self.group_coding(dcol)
        table = np.zeros(card_pad, dtype=np.int32)
        table[: len(hit)][hit] = codes[dimrow[hit]]
        return table

    # -- raw-key device operands -------------------------------------------
    def _dtype_mask(self, np_dtype) -> np.ndarray:
        """Dim keys representable in the fact key dtype (others can match
        no fact value and are dropped — a cast that WRAPPED them would
        fabricate matches)."""
        info = np.iinfo(np_dtype)
        return (self.keys >= info.min) & (self.keys <= info.max)

    def padded_keys(self, np_dtype) -> Optional[np.ndarray]:
        """Device probe operand: dim keys in the fact dtype, pow2-padded
        by REPEATING the max key (duplicates of a real key can neither
        create nor destroy a match). None when no key is representable."""
        pow2_bucket = kernels.pow2_bucket
        keys = self.keys[self._dtype_mask(np_dtype)].astype(np_dtype)
        if not len(keys):
            return None
        d_pad = pow2_bucket(len(keys), floor=8)
        out = np.full(d_pad, keys.max(), dtype=np_dtype)
        out[: len(keys)] = keys
        return out

    def padded_key_codes(self, dcol: str, np_dtype
                         ) -> Tuple[np.ndarray, np.ndarray]:
        """(keys [Dp], group codes [Dp] int32) for the jraw device
        probe; padding repeats (max key, its code) so padding-run probe
        hits resolve to the right code."""
        pow2_bucket = kernels.pow2_bucket
        codes, _uniq = self.group_coding(dcol)
        mask = self._dtype_mask(np_dtype)
        keys = self.keys[mask].astype(np_dtype)
        kcodes = codes[mask]
        if not len(keys):
            return (np.zeros(8, dtype=np_dtype),
                    np.zeros(8, dtype=np.int32))
        d_pad = pow2_bucket(len(keys), floor=8)
        mx = int(np.argmax(keys))
        out_k = np.full(d_pad, keys[mx], dtype=np_dtype)
        out_c = np.full(d_pad, kcodes[mx], dtype=np.int32)
        out_k[: len(keys)] = keys
        out_c[: len(keys)] = kcodes
        return out_k, out_c

    def sorted_keys(self, np_dtype, dcol: Optional[str] = None
                    ) -> Optional["kernels.SortedKeys"]:
        """The raw-key device probe: padded_keys (dcol None, K1's
        join_raw leaf) or padded_key_codes(dcol) (K3's jraw key) as one
        SortedKeys, which K12 sorts on each device once and caches, so a
        query sorts its dim side once per key dtype and column, where the
        JAX kernel sorts inside every launch. None when no dim key is
        representable in the fact dtype (join_raw only)."""
        key = (np.dtype(np_dtype).str, dcol)
        with self._lock:
            cached = self._sorted.get(key)
        if cached is not None:
            return cached
        if dcol is None:
            keys = self.padded_keys(np_dtype)
            if keys is None:
                return None
            probe = kernels.SortedKeys(keys)
        else:
            probe = kernels.SortedKeys(*self.padded_key_codes(dcol,
                                                              np_dtype))
        with self._lock:
            return self._sorted.setdefault(key, probe)


# ---------------------------------------------------------------------------
# Context assembly (stage-2 entry on the fact server)
# ---------------------------------------------------------------------------


def filter_sources(sources: List[dict],
                   fact_parts: Optional[Tuple[str, int, set]]
                   ) -> Tuple[List[dict], int]:
    """Co-partitioned dispatch: drop sources whose partition tags are
    provably disjoint from this server's fact partitions. `fact_parts`:
    (function name, num partitions, partition-id set) or None (unknown
    → fetch everything: a superset is always correct)."""
    if fact_parts is None:
        return list(sources), 0
    fn, n, pids = fact_parts
    kept: List[dict] = []
    skipped = 0
    for s in sources:
        parts = s.get("partitions")
        if parts is None or s.get("partitionFunction") != fn or \
                s.get("numPartitions") != n:
            kept.append(s)
            continue
        if set(parts) & pids:
            kept.append(s)
        else:
            skipped += 1
    return kept, skipped


def fact_partition_info(segments, fact_key: str
                        ) -> Optional[Tuple[str, int, set]]:
    """(function, N, partition ids) of the fact key column across the
    query's segments — None unless EVERY segment is consistently tagged
    (the only condition under which skipping a source is provably safe)."""
    fn = None
    n = 0
    pids: set = set()
    for seg in segments:
        if not seg.has_column(fact_key):
            return None
        cm = seg.data_source(fact_key).metadata
        if not cm.partition_function or not cm.partitions:
            return None
        if fn is None:
            fn, n = cm.partition_function, cm.num_partitions
        elif (cm.partition_function, cm.num_partitions) != (fn, n):
            return None
        pids.update(cm.partitions)
    return None if fn is None else (fn, n, pids)


def build_context(spec: JoinSpec, sources: List[dict],
                  fact_parts: Optional[Tuple[str, int, set]],
                  deadline_s: Optional[float] = None) -> JoinContext:
    """Fetch the (partition-filtered) dim blocks and assemble the
    probe context. Deterministic assembly order: sources sorted by
    (server, id) so every replica builds identical arrays."""
    chosen, skipped = filter_sources(sources, fact_parts)
    chosen = sorted(chosen, key=lambda s: (str(s.get("server")),
                                           str(s.get("id"))))
    blocks = exchange.fetch_blocks(chosen, deadline_s)
    key_parts: List[np.ndarray] = []
    col_parts: Dict[str, list] = {c: [] for c in spec.dim_columns}
    for dt in blocks:
        cols = columns_of(dt)
        if spec.dim_key not in cols:
            raise StageCompileError(
                f"stage-1 dim block is missing the join key column "
                f"'{spec.dim_key}'")
        key_col = cols[spec.dim_key]
        if not isinstance(key_col, np.ndarray):
            key_col = np.asarray(key_col)
        key_parts.append(key_col)
        for c in spec.dim_columns:
            col = cols.get(c)
            if col is None:
                raise StageCompileError(
                    f"stage-1 dim block is missing column '{c}'")
            col_parts[c].append(col)
    if key_parts:
        kp = [np.asarray(k) for k in key_parts]
        if any(k.dtype.kind not in "iu" for k in kp if len(k)):
            raise StageCompileError(
                f"join keys must be INTEGER columns; dim key "
                f"'{spec.dim_key}' decoded as "
                f"{[str(k.dtype) for k in kp]}")
        keys = np.concatenate([k.astype(np.int64) for k in kp]) \
            if kp else np.zeros(0, np.int64)
    else:
        keys = np.zeros(0, np.int64)
    columns: Dict[str, object] = {}
    for c, parts in col_parts.items():
        if all(isinstance(p, np.ndarray) for p in parts) and parts:
            columns[c] = np.concatenate(parts)
        else:
            merged: list = []
            for p in parts:
                merged.extend(list(p))
            columns[c] = np.asarray(merged, dtype=object)
    ctx = JoinContext(spec, keys, columns)
    ctx.sources_skipped = skipped
    return ctx


def attach(request, ctx: JoinContext, segments):
    """The stage-2 request: a copy of `request` carrying `ctx` as
    `_join_ctx`, after the fact key contract is checked against the
    first segment up front (exists, single-value integer), so an empty
    dim side cannot mask a misspelled or mistyped key (the tail of
    pinot_tpu/server/query_executor.py:_attach_join_context)."""
    import copy
    if segments:
        from pinot_tpu_torch.query.plan import _join_key_source
        _join_key_source(ctx, segments[0])
    out = copy.copy(request)
    out._join_ctx = ctx
    return out

