"""Per-segment query kernels: filter mask, masked sums, histograms, group
tables.

Counterpart of pinot_tpu/ops/kernels.py. The JAX package compiles a whole
segment plan into one jitted XLA program; here the same plan runs as a
short fixed sequence of kernels written by hand for Hopper
(ops/csrc/*.cu, built by ops/build.py):

- K1 `filter_mask`: the filter tree → uint8 row mask
  (replaces `_eval_filter` / `_eval_pred`);
- K2 `masked_part_sums`: exact sums of bit-sliced part lanes + the match
  count (replaces `_part_sums` and the masked count);
- K3 `dense_group_aggregate`: mixed-radix group key → per-group count,
  int32 part sums, float64 sums and min / max (replaces `_group_key` kinds
  "ids", "rawoff", "jcode", "jraw", "idoff" and "idrank",
  `_expand_mv_group` for kinds "mvids" / "mvin",
  `_dense_group_count`, `_dense_group_part_sums`,
  `_dense_group_float_sums`, `_dense_group_extreme` and the scatter
  fallback for count / sum / avg / min / max);
- K4 `masked_histogram`: dictId counts of the matched rows, or of their
  MV entries (replaces `_histogram` / `_mxu_histogram` and the MV
  histogram branch of `_agg_outputs`);
- K5 `masked_reduce`: one lane's match count, min / max and per-block
  float64 sums (replaces `_chunked_float_sum` and the id / MV / raw
  min-max branches of `_agg_outputs`);
- K6 `masked_select`: the first k matched rows by (key words, docid), the
  match count and the gathered columns (replaces `_selection_outputs`
  with `_monotone_int32_keys`, kinds limit / order / ordertk / ordermk);
- K7 `hll_registers`: HyperLogLog registers from K4's histogram and the
  per-dictId (index, rank) tables (replaces the "hll" branch of
  `_agg_outputs`);
- K12 `radix_sort`: a stable sort of int32 / int64 key lanes carrying
  int32 payload lanes (replaces the lax.sort of `build_window_kernel`, and
  as `radix_sort_join` the sorts of a raw-key join's dim side in the
  `join_raw` and `jraw` kinds);
- K13 `window_scan`: row numbers and running sums over the sorted
  partition lane (replaces the rest of `build_window_kernel`);
- K14 `block_compact`: a filtered group-by's matched rows moved to r
  slots a 2,048-row block, in row order, with their group key and metric
  values (replaces `_block_compact` and the lane registry of
  `_group_outputs_compacted`);
- K15 `slot_tables`: count, part sums, float64 sums and min / max over
  the slots, by key (dense) or by rank (ranked) (replaces
  `_slot_sum_tables` and the compacted scatter min / max);
- K16 `rank_slots`: the ranked layout's dedup of the slots' keys into
  ranks and the rkeys lane (replaces the sort and rank of
  `_group_outputs_compacted`); past RANK_BITMAP_G_LIMIT keys through K12
  (`radix_sort_rank`);
- K17 `ssb_synth`: the SSB lanes of a whole stack drawn on the card, JAX's
  threefry bits exactly (replaces the device synthesis of
  pinot_tpu/tools/datagen.py:make_ssb_device_stack; its wrapper and plain
  version are in ops/synth.py).

Every wrapper checks its operands, allocates its outputs, and launches on
the current stream. Beside each kernel is its plain PyTorch version: the
wrapper uses it for a tensor that lies on the CPU, and only then. For a
CUDA tensor the wrapper launches the kernel or raises.

Spec grammar (hashable tuples, the JAX package's own; this slice takes the
subset below; the planner refuses the rest, with UnsupportedOnDevice
where the JAX planner does and NotPorted where the port has no kernel):

  filter: ("and", (child, ...)) | ("or", (child, ...)) | ("match_all",)
        | ("empty",) | ("pred", kind, col, source, extra)
          source "sv" ({col}.ids [P]) or "mv" ({col}.mv [P, W]):
            kind ∈ {eq_id, neq_id, range_ids, in_ids, notin_ids, member}
          source "raw" ({col}.raw [P], int32/int64/float32/float64):
            kind ∈ {eq_raw, neq_raw, in_raw, notin_raw, range_raw}
          source "vdoc" ({col}.vdoc, uint8 [P], 1 = live): kind vdoc, the
            upsert liveness leaf (plan.py VALID_DOC_PRED), no params
          source "raw" (int32 / int64 {col}.raw): kind join_raw, the probe
            of a raw-key join against the dim side's keys
  params: flat sequence consumed in depth-first pred order: eq/neq one
          value, range_ids (lo, hi) half-open, range_raw (lo, hi) with
          extra = (lo_inclusive, hi_inclusive), in/notin a [k] list (ids
          padded with -1), member a bool [card_pad] table, join_raw the
          dim keys (a SortedKeys in the lane's dtype). Raw constants
          compare in the lane's dtype (the planner casts them to it).
  agg:    (fname, col, source, extra):
          ("count", "*", "none", None);
          ("sum" | "avg", col, "sv", ("parts", card_pad)) → K2;
          (fname, col, "sv", ("hist", card_pad)) → K4, fname ∈ {sum, avg,
            distinctcount, percentile, hist (an expression over col)};
          ("hll", col, "sv", ("hll", card_pad, m)) → K4, then K7 over the
            {col}.hllidx / {col}.hllrank tables;
          (fname, col, "mv", (card_pad, card)) over {col}.mv [P, W] → K4's
            entry histogram, fname ∈ {sum, avg, percentile, distinctcount,
            countmv}, or K5 over the entries, fname ∈ {min, max,
            minmaxrange};
          ("sum" | "avg", col, "sv", ("vlane", card_pad)) → K5 sums;
          ("min" | "max" | "minmaxrange", col, "sv", ("ids", card_pad))
            → K5 over ids;
          (fname, col, "raw", None) → K5 over the raw lane, fname ∈ {sum,
            avg, min, max, minmaxrange}.
  group:  (cols=((name, kind, off, card), ...), strides, g_pad,
           aggs=(count | sum/avg with ("psums", card_pad) over sv parts, or
                 ("csums",) over raw / ("csums", card_pad) over sv vlane |
                 min/max/minmaxrange with ("ids", card_pad) over sv ids, or
                 None over raw),
           kmax); kind "ids" ({name}.ids), "rawoff" ({name}.raw minus
          off), "mvids" ({name}.mv entries), "mvin" (entries in a member
          table popped from the group params, in key order), "jcode"
          ({name}.ids through an int32 code table popped from the group
          params), "jraw" ({name}.raw probed in a SortedKeys with codes
          popped from the group params), "idoff" ({name}.ids minus an
          int32 offset popped from the group params) or "idrank"
          ({name}.ids through an int32 rank vector popped from them).
          kmax = 0: K3's dense table; kmax > 0: the compacted route
          (K14, then K15 into dense tables, or K16 and K15 into ranked
          ones; K3 for the sorted rung), with group.overflow
  select: (kind, k, order=((col, asc, card_pad, source), ...),
           gather=((col, source), ...)), kind ∈ {limit, order, ordertk,
           ordermk}, source "sv" ({col}.ids), "raw" ({col}.raw) or, for a
           gathered column, "mv" ({col}.mv) → K6
"""
from __future__ import annotations

import collections
import ctypes
import dataclasses
import threading
import weakref
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

INT32_MAX = 2**31 - 1
BLOCK = 8192                 # row block: padded segment lengths are multiples
CBLOCK = 2048                # block_compact's row block (the JAX CBLOCK)
DENSE_G_LIMIT = 32768        # compacted tables: dense at most, ranked above
DENSE_ROWS_LIMIT = 1 << 24   # 127 * 2^24 < 2^31: int32 part sums stay exact
DENSE_CARD_LIMIT = 32768     # the JAX planner's histogram cap for float SUM
#: slots a compaction block keeps (r) above which the JAX kernel leaves
#: block compaction for its sorted rung
SORTED_RUNG_R = 256
#: K16 ranks by a presence bitmap of g_pad bits a segment up to this many
#: keys (a 512 KB bitmap: its one-block scan stays well under the slots'
#: own work at the caps the planner makes), by K12's sort of the cap keys
#: above it (numGroupsLimit raised past 4M potential groups)
RANK_BITMAP_G_LIMIT = 1 << 22


def pow2_bucket(n: int, floor: int = 8) -> int:
    """Round up to a power of two (the JAX package's shape buckets)."""
    n = max(n, floor)
    return 1 << int(np.ceil(np.log2(n)))


def sum_dtype() -> torch.dtype:
    """Accumulator dtype for float sums: float64 on every device."""
    return torch.float64


# ---------------------------------------------------------------------------
# Kernel registry: what each kernel replaces, and its launch count
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class KernelInfo:
    name: str
    source: str            # path in the repo
    replaces: str          # file:line of the JAX function
    launches: int = 0      # +1 per kernel launch, nowhere else
    symbol: str = ""       # the C entry point, pinot_<name> by default
    _fn: object = None     # the loaded C entry point
    #: launches whose program holds a node of this kind ("vdoc" for K1),
    #: reported as "<name>[<node>]"
    node_launches: Dict[str, int] = dataclasses.field(default_factory=dict)


KERNELS: Dict[str, KernelInfo] = {
    "filter_mask": KernelInfo(
        "filter_mask", "pinot_tpu_torch/ops/csrc/filter_mask.cu",
        "pinot_tpu/ops/kernels.py:175"),
    "masked_part_sums": KernelInfo(
        "masked_part_sums", "pinot_tpu_torch/ops/csrc/masked_part_sums.cu",
        "pinot_tpu/ops/kernels.py:248"),
    "dense_group_aggregate": KernelInfo(
        "dense_group_aggregate",
        "pinot_tpu_torch/ops/csrc/dense_group_aggregate.cu",
        "pinot_tpu/ops/kernels.py:407"),
    "masked_histogram": KernelInfo(
        "masked_histogram", "pinot_tpu_torch/ops/csrc/masked_histogram.cu",
        "pinot_tpu/ops/kernels.py:566"),
    "masked_reduce": KernelInfo(
        "masked_reduce", "pinot_tpu_torch/ops/csrc/masked_reduce.cu",
        "pinot_tpu/ops/kernels.py:281"),
    "masked_select": KernelInfo(
        "masked_select", "pinot_tpu_torch/ops/csrc/masked_select.cu",
        "pinot_tpu/ops/kernels.py:1479"),
    "hll_registers": KernelInfo(
        "hll_registers", "pinot_tpu_torch/ops/csrc/hll_registers.cu",
        "pinot_tpu/ops/kernels.py:620"),
    "vector_scores": KernelInfo(
        "vector_scores", "pinot_tpu_torch/ops/csrc/vector_scores.cu",
        "pinot_tpu/ops/kernels.py:1430"),
    # K6's vector kind: the masked_select kernel over K8's scores, counted
    # apart from K6's other kinds
    "masked_select_vector": KernelInfo(
        "masked_select_vector", "pinot_tpu_torch/ops/csrc/masked_select.cu",
        "pinot_tpu/ops/kernels.py:1482", symbol="pinot_masked_select"),
    "ivf_probe_select": KernelInfo(
        "ivf_probe_select", "pinot_tpu_torch/ops/csrc/ivf_probe_select.cu",
        "pinot_tpu/ops/kernels.py:140"),
    "ivf_assign": KernelInfo(
        "ivf_assign", "pinot_tpu_torch/ops/csrc/ivf_assign.cu",
        "pinot_tpu/ops/ivf_kernels.py:26"),
    "ivf_recenter": KernelInfo(
        "ivf_recenter", "pinot_tpu_torch/ops/csrc/ivf_recenter.cu",
        "pinot_tpu/ops/ivf_kernels.py:51"),
    "radix_sort": KernelInfo(
        "radix_sort", "pinot_tpu_torch/ops/csrc/sort_window.cu",
        "pinot_tpu/ops/kernels.py:1584"),
    # K12 as a raw-key join's dim-side build (the lax.sort of _eval_pred
    # kind join_raw and of _group_key kind jraw), counted apart
    "radix_sort_join": KernelInfo(
        "radix_sort_join", "pinot_tpu_torch/ops/csrc/sort_window.cu",
        "pinot_tpu/ops/kernels.py:127", symbol="pinot_radix_sort"),
    "window_scan": KernelInfo(
        "window_scan", "pinot_tpu_torch/ops/csrc/sort_window.cu",
        "pinot_tpu/ops/kernels.py:1588"),
    "block_compact": KernelInfo(
        "block_compact", "pinot_tpu_torch/ops/csrc/group_compact.cu",
        "pinot_tpu/ops/kernels.py:785"),
    "slot_tables": KernelInfo(
        "slot_tables", "pinot_tpu_torch/ops/csrc/group_compact.cu",
        "pinot_tpu/ops/kernels.py:835"),
    "rank_slots": KernelInfo(
        "rank_slots", "pinot_tpu_torch/ops/csrc/group_compact.cu",
        "pinot_tpu/ops/kernels.py:1122"),
    # K12 as K16's sort route (the lax.sort of the compacted keys of the
    # ranked layout), counted apart
    "radix_sort_rank": KernelInfo(
        "radix_sort_rank", "pinot_tpu_torch/ops/csrc/sort_window.cu",
        "pinot_tpu/ops/kernels.py:1124", symbol="pinot_radix_sort"),
    # K17: the device SSB synthesis of the JAX bench (ops/synth.py)
    "ssb_synth": KernelInfo(
        "ssb_synth", "pinot_tpu_torch/ops/csrc/ssb_synth.cu",
        "pinot_tpu/tools/datagen.py:538"),
}
#: the batched forms: one launch serves up to MAX_BATCH members of one
#: plan (the vmap of get_batched_segment_kernel), counted apart
for _name in ("filter_mask", "masked_part_sums", "masked_histogram",
              "masked_reduce", "masked_select", "masked_select_vector",
              "hll_registers", "vector_scores", "ivf_probe_select"):
    KERNELS[f"{_name}_batched"] = KernelInfo(
        f"{_name}_batched", KERNELS[_name].source,
        "pinot_tpu/ops/kernels.py:1672",
        symbol=f"{KERNELS[_name].symbol or 'pinot_' + _name}_batched")
del _name

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_PP = ctypes.POINTER(_P)
_IP = ctypes.POINTER(_I)
_LLP = ctypes.POINTER(_LL)
_F = ctypes.c_float
#: the key lanes of K3 and K14 (_key_args, group_key.cuh:fill_key_lanes)
_KEY_ARGTYPES = [_PP, _IP, _IP, _IP, _IP, _IP, _LLP, _PP, _IP, _PP, _PP,
                 _IP, _I]
_ARGTYPES = {
    "filter_mask": [_PP, _I, _P, _I, _I, _I, _LL, _LL, _P, _LL, _P, _P, _P],
    "masked_part_sums": [_P, _PP, _I, _LL, _LL, _P, _P],
    "dense_group_aggregate": [
        _P, *_KEY_ARGTYPES, _PP, _I, _PP, _I,
        _PP, _IP, _IP, _IP, _PP, _I,
        _LL, _I, _I, _I, _P, _P, _P, _P, _P],
    "masked_histogram": [_P, _P, _I, _LL, _I, _I, _I, _P, _P, _P],
    "masked_reduce": [_P, _P, _I, _I, _I, _I, _I, _I, _LL, _P, _P, _P, _P,
                      _P, _P],
    "masked_select": [_P, _LL, _I, _I, _PP, _IP, _IP, _IP, _IP, _I, _I,
                      _PP, _IP, _PP, _I, _I, _P, _LL, _P, _P, _P],
    "hll_registers": [_P, _P, _P, _I, _I, _P, _P],
    "vector_scores": [_P, _LL, _I, _P, _F, _I, _P, _P],
    "ivf_probe_select": [_P, _P, _I, _I, _I, _P, _F, _I, _I, _P, _P, _P],
    "ivf_assign": [_P, _LL, _I, _P, _I, _I, _LL, _P, _P, _P, _P],
    "ivf_recenter": [_P, _P, _LL, _I, _P, _I, _P, _P, _P, _P],
    "radix_sort": [_PP, _IP, _I, _PP, _I, _LL, _LL, _PP, _PP, _P, _P, _P],
    "window_scan": [_P, _PP, _I, _LL, _P, _PP, _P, _P],
}
_ARGTYPES.update({
    "block_compact": [_P, *_KEY_ARGTYPES, _PP, _I, _PP, _IP, _I, _PP, _IP,
                      _I, _LL, _I, _I, _P, _P, _P, _P, _P, _P, _P],
    "slot_tables": [_P, _LL, _LL, _LL, _PP, _I, _PP, _I, _PP, _IP, _IP, _PP,
                    _I, _I, _I, _I, _P, _P, _P, _P],
    "rank_slots": [_P, _LL, _LL, _I, _P, _P, _P, _P, _P, _P, _P, _P],
})
_UIP = ctypes.POINTER(ctypes.c_uint)
_ARGTYPES["ssb_synth"] = [_UIP, _UIP, _UIP, _PP, _IP, _P, _P, _P, _I, _I, _P,
                          _I, _P, _I, _LL, _LL, _P]
_ARGTYPES["radix_sort_join"] = _ARGTYPES["radix_sort"]
_ARGTYPES["radix_sort_rank"] = _ARGTYPES["radix_sort"]
_ARGTYPES["masked_select_vector"] = _ARGTYPES["masked_select"]
_FP = ctypes.POINTER(_F)
_ARGTYPES.update({
    "filter_mask_batched": [_PP, _I, _P, _I, _I, _I, _I, _LL, _LL, _P, _P,
                            _P],
    "masked_part_sums_batched": [_P, _PP, _I, _LL, _LL, _I, _P, _P],
    "masked_histogram_batched": [_P, _P, _I, _LL, _I, _I, _I, _I, _P, _P,
                                 _P],
    "masked_reduce_batched": [_P, _P, _I, _I, _I, _I, _I, _I, _LL, _I, _P,
                              _P, _P, _P, _P, _P],
    "masked_select_batched": [_P, _LL, _I, _I, _PP, _LLP, _IP, _IP, _IP,
                              _IP, _I, _I, _PP, _LLP, _IP, _PP, _I, _I, _P,
                              _LL, _P, _P, _P],
    "hll_registers_batched": [_P, _P, _P, _I, _I, _I, _P, _P],
    "vector_scores_batched": [_P, _LL, _I, _P, _FP, _I, _I, _P, _P],
    "ivf_probe_select_batched": [_P, _P, _I, _I, _I, _P, _FP, _I, _I, _I,
                                 _P, _P, _P],
})
_ARGTYPES["masked_select_vector_batched"] = _ARGTYPES["masked_select_batched"]


#: program nodes counted apart: K1's upsert liveness leaf and join probe,
#: K3's join group keys
KERNELS["filter_mask"].node_launches.update(vdoc=0, join_raw=0)
KERNELS["filter_mask_batched"].node_launches.update(vdoc=0, join_raw=0)
KERNELS["dense_group_aggregate"].node_launches.update(
    jcode=0, jraw=0, idoff=0, idrank=0)
KERNELS["block_compact"].node_launches.update(
    jcode=0, jraw=0, idoff=0, idrank=0)
KERNELS["rank_slots"].node_launches["sort"] = 0


#: the group-by route of each dispatch (query/plan.py:
#: drive_group_execution and _group_outputs): "scout" (phase A's min /
#: max), "hist" (phase A2's histograms), "idoff" / "idrank" (phase B specs
#: holding such a key), "dense_regime" (phase B with kmax = 0),
#: "compacted" (K14 + K15 into dense tables), "ranked" (K14 + K16 + K15),
#: "sorted" (the sorted rung, K3), "escalation" (a kmax rung climbed)
group_route_counts: collections.Counter = collections.Counter()
#: every count above moves under this lock: the server's workers launch
#: concurrently, and `+=` on a shared int is a read-modify-write
_COUNT_LOCK = threading.Lock()
#: guards the lazy load of each kernel's C entry point
_ENTRY_LOCK = threading.Lock()


def reset_launch_counts() -> None:
    with _COUNT_LOCK:
        for k in KERNELS.values():
            k.launches = 0
            k.node_launches = dict.fromkeys(k.node_launches, 0)
        group_route_counts.clear()


def count_route(route: str) -> None:
    """One more group-by dispatch on `route` (group_route_counts)."""
    with _COUNT_LOCK:
        group_route_counts[route] += 1


def _count_node(name: str, node: str) -> None:
    with _COUNT_LOCK:
        KERNELS[name].node_launches[node] += 1


def launch_counts() -> Dict[str, int]:
    """{kernel: launches}, and {"<kernel>[<node>]": launches whose program
    held the node} for the counted nodes."""
    out = {name: k.launches for name, k in KERNELS.items()}
    for name, k in KERNELS.items():
        out.update({f"{name}[{node}]": n
                    for node, n in k.node_launches.items()})
    return out


def _count_nodes(name: str, filter_spec, keys) -> None:
    """One more launch of K1 `name` for each counted node its program
    holds (the vdoc lane, a join_raw leaf)."""
    if any(k.endswith(".vdoc") for k in keys):
        _count_node(name, "vdoc")
    if "join_raw" in KERNELS[name].node_launches and \
            _has_leaf(filter_spec, "join_raw"):
        _count_node(name, "join_raw")


def _has_leaf(spec, kind: str) -> bool:
    if spec[0] in ("and", "or"):
        return any(_has_leaf(c, kind) for c in spec[1])
    return spec[0] == "pred" and spec[1] == kind


def _c_entry(name: str):
    info = KERNELS[name]
    if info._fn is None:
        with _ENTRY_LOCK:
            if info._fn is None:
                from pinot_tpu_torch.ops import build
                lib = build.load(info.source.rsplit("/", 1)[-1])
                fn = getattr(lib, info.symbol or f"pinot_{name}")
                fn.argtypes = _ARGTYPES[name]
                fn.restype = ctypes.c_int
                info._fn = fn
    return info._fn


def _launch(name: str, device: torch.device, *args) -> None:
    fn = _c_entry(name)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = fn(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed (CUDA error {rc})")
    with _COUNT_LOCK:
        KERNELS[name].launches += 1


def _scratch_words(source: str, symbol: str, argtypes, *args) -> int:
    """What a kernel's C sizing function (`symbol` in `source`'s library)
    says its scratch takes for these arguments."""
    from pinot_tpu_torch.ops import build
    fn = getattr(build.load(source), symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_longlong
    return int(fn(*args))


def _ptrs(tensors: Sequence[torch.Tensor]):
    return (_P * len(tensors))(*[t.data_ptr() for t in tensors])


def _ints(values: Sequence[int]):
    return (ctypes.c_int * len(values))(*[int(v) for v in values])


def _longs(values: Sequence[int]):
    return (ctypes.c_longlong * len(values))(*[int(v) for v in values])


#: element type codes shared with the .cu sources (pinot::Elem)
_ELEM = {torch.int8: 0, torch.int16: 1, torch.int32: 2, torch.int64: 3,
         torch.float32: 4, torch.float64: 5}
_ID_DTYPES = (torch.int8, torch.int16, torch.int32)
_RAW_DTYPES = (torch.int32, torch.int64, torch.float32, torch.float64)


def _check_lane(t: torch.Tensor, what: str, padded: int, device,
                dtypes: Tuple[torch.dtype, ...], ndim: int = 1) -> None:
    if t.device != device:
        raise ValueError(f"{what} on {t.device}, expected {device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{what} has dtype {t.dtype}, expected one of "
                        f"{dtypes}")
    if t.dim() != ndim or t.shape[0] != padded:
        raise ValueError(f"{what} has shape {tuple(t.shape)}, expected "
                         f"{ndim} dims of {padded} rows")
    if not t.is_contiguous():
        raise ValueError(f"{what} is not contiguous")


def _check_mask(mask: torch.Tensor) -> None:
    _check_lane(mask, "mask", mask.shape[0], mask.device, (torch.uint8,))


def _np_of(dtype: torch.dtype) -> np.dtype:
    return np.dtype(str(dtype).replace("torch.", ""))


# ---------------------------------------------------------------------------
# K1 filter_mask
# ---------------------------------------------------------------------------

_OP_TRUE, _OP_FALSE, _OP_AND, _OP_OR = 0, 1, 8, 9
_LEAF_OPS = {"eq_id": 2, "neq_id": 3, "range_ids": 4, "in_ids": 5,
             "notin_ids": 6, "member": 7, "eq_raw": 10, "neq_raw": 11,
             "range_raw": 12, "in_raw": 13, "notin_raw": 14,
             "ivf_probe": 15, "vdoc": 16, "join_raw": 17}
#: a batched join_raw leaf over the members' member map (JoinMemberMap)
_OP_JOIN_BITS = 18
#: params each predicate kind takes (an ivf_probe: the query and its norm;
#: the vdoc liveness leaf none)
_LEAF_PARAMS = {"range_ids": 2, "range_raw": 2, "ivf_probe": 2, "vdoc": 0}
_RAW_KINDS = ("eq_raw", "neq_raw", "range_raw", "in_raw", "notin_raw",
              "join_raw")
_NODE_WORDS = 6              # {op, lane, param offset, arg, elem, width}
_MAX_FILTER_LANES = 16
_MAX_STACK = 32


def _leaf(spec) -> Tuple[str, str]:
    """(kind, lane key) of a predicate node K1 evaluates."""
    _, kind, col, source, _extra = spec
    if source == "ivf" and kind == "ivf_probe":
        return kind, f"{col}.ivfa"          # + {col}.ivfc / .ivfv for K9
    if source == "vdoc" and kind == "vdoc":
        return kind, f"{col}.vdoc"          # uint8 liveness, no params
    if kind not in _LEAF_OPS or source not in ("sv", "mv", "raw") or \
            (source == "raw") != (kind in _RAW_KINDS):
        raise ValueError(f"predicate kind {kind} over {source} is not a "
                         "K1 filter_mask predicate")
    return kind, f"{col}.{'ids' if source == 'sv' else source}"


def _filter_lane_ok(t: torch.Tensor, key: str, padded: int, device) -> None:
    if key.endswith(".vdoc"):
        _check_lane(t, key, padded, device, (torch.uint8,))
    elif key.endswith(".raw"):
        _check_lane(t, key, padded, device, _RAW_DTYPES)
    else:
        _check_lane(t, key, padded, device, _ID_DTYPES,
                    2 if key.endswith(".mv") else 1)


def _raw_words(values, dtype) -> List[int]:
    """Raw constants in the lane's dtype as int32 words (low word first)."""
    arr = np.ascontiguousarray(np.asarray(values, dtype=_np_of(dtype))
                               .reshape(-1))
    return arr.view("<i4").astype(np.int64).tolist()


def filter_param_count(filter_spec) -> int:
    """How many params a filter spec consumes (the rest of a plan's params
    belong to its selection)."""
    if filter_spec[0] in ("and", "or"):
        return sum(filter_param_count(c) for c in filter_spec[1])
    if filter_spec[0] == "pred":
        return _LEAF_PARAMS.get(filter_spec[1], 1)
    return 0


def compile_filter(filter_spec, params: Sequence,
                   cols: Dict[str, torch.Tensor],
                   probe_lanes: Optional[List[torch.Tensor]] = None,
                   probe=None, join=None) -> Tuple[np.ndarray, int]:
    """Flatten a filter spec and its params into the K1 program.

    Returns (buffer int32 [6 * n_nodes + n_param_words], n_nodes). Node =
    {op, lane, param offset, arg, elem, width}, lane indexing
    filter_lane_keys(spec), elem the lane's element type code, width its
    values per row; the params follow the nodes, offsets count from their
    start. Raw constants are cast to the lane's dtype. An ivf_probe node
    runs K9 on its codebook lanes here (or takes `probe(spec, q, q_norm)`'s
    lanes) and appends the probe ids and ok flags to `probe_lanes` (K1's
    lane table continues with them); its two parameter words are their
    lane indices. A join_raw node appends the dim keys sorted on the
    lane's device (SortedKeys.on: K12 once per device) to `probe_lanes`
    (or `join(spec, keys)`'s lane: a batch's [B, Dp] keys); its parameter
    word is their lane index and its arg their count Dp. Where `join`
    gives a JoinMemberMap the node is a join_bits one: its words the member
    map's lane index and the range's base in the lane's dtype, its arg
    the range's span.
    """
    nodes: List[Tuple[int, ...]] = []
    words: List[int] = []
    lanes = filter_lane_keys(filter_spec)
    plist = list(params)
    depth = max_depth = 0

    def emit(op: int, lane: int = 0, off: int = 0, arg: int = 0,
             elem: int = 0, width: int = 1, pops: int = 0) -> None:
        nonlocal depth, max_depth
        nodes.append((op, lane, off, arg, elem, width))
        depth += 1 - pops
        max_depth = max(max_depth, depth)

    def walk(spec) -> None:
        op = spec[0]
        if op == "match_all":
            emit(_OP_TRUE)
        elif op == "empty":
            emit(_OP_FALSE)
        elif op in ("and", "or"):
            kids = spec[1]
            if not 1 <= len(kids) <= 31:
                raise ValueError(f"{op} node with {len(kids)} children")
            for c in kids:
                walk(c)
            emit(_OP_AND if op == "and" else _OP_OR, arg=len(kids),
                 pops=len(kids))
        elif op == "pred":
            kind, key = _leaf(spec)
            lane_t = cols[key]
            lane, off, arg = lanes.index(key), len(words), 0
            width = lane_t.shape[1] if lane_t.dim() == 2 else 1
            if kind == "vdoc":
                # the row's liveness byte, pushed as it is: no params
                emit(_LEAF_OPS[kind], lane, off)
                return
            code = _LEAF_OPS[kind]
            if kind in ("eq_id", "neq_id"):
                words.append(int(plist.pop(0)))
            elif kind == "range_ids":
                words.append(int(plist.pop(0)))
                words.append(int(plist.pop(0)))
            elif kind in ("in_ids", "notin_ids"):
                vals = np.asarray(plist.pop(0), dtype=np.int64).ravel()
                words.extend(int(v) for v in vals)
                arg = len(vals)
            elif kind == "member":
                member = np.asarray(plist.pop(0), dtype=bool).ravel()
                arg = len(member)
                bits = np.packbits(member, bitorder="little")
                bits = np.concatenate(
                    [bits, np.zeros(-len(bits) % 4, np.uint8)])
                words.extend(bits.view("<u4").astype(np.int64).tolist())
            elif kind == "ivf_probe":
                if probe_lanes is None:
                    raise ValueError("an ivf_probe filter needs probe_lanes")
                q, q_norm = plist.pop(0), plist.pop(0)
                nprobe, metric = spec[4]
                col = spec[2]
                ids, ok = probe(spec, q, q_norm) if probe else \
                    ivf_select_probes(cols[f"{col}.ivfc"],
                                      cols[f"{col}.ivfv"], q, q_norm,
                                      metric, nprobe)
                first = len(lanes) + len(probe_lanes)
                probe_lanes.extend([ids, ok])
                words.extend([first, first + 1])
                arg = int(nprobe)
            elif kind == "join_raw":
                if probe_lanes is None:
                    raise ValueError("a join_raw filter needs probe_lanes")
                keys = plist.pop(0)
                sk = join(spec, keys) if join else \
                    sorted_keys_for(keys, lane_t)
                words.append(len(lanes) + len(probe_lanes))
                if isinstance(sk, JoinMemberMap):
                    code = _OP_JOIN_BITS
                    sk, base = sk.map, sk.base
                    words.extend(_raw_words([base], lane_t.dtype))
                probe_lanes.append(sk)
                arg = int(sk.shape[-1])
            elif kind in ("eq_raw", "neq_raw"):
                words.extend(_raw_words(plist.pop(0), lane_t.dtype))
            elif kind == "range_raw":
                lo_inc, hi_inc = spec[4]
                words.extend(_raw_words([plist.pop(0), plist.pop(0)],
                                        lane_t.dtype))
                arg = int(bool(lo_inc)) | int(bool(hi_inc)) << 1
            else:                                      # in_raw / notin_raw
                vals = np.asarray(plist.pop(0)).ravel()
                words.extend(_raw_words(vals, lane_t.dtype))
                arg = len(vals)
            emit(code, lane, off, arg, _ELEM[lane_t.dtype],
                 width)
        else:
            raise ValueError(f"unknown filter node {op}")

    walk(filter_spec)
    if plist:
        raise ValueError(f"{len(plist)} filter params left unconsumed")
    if max_depth > _MAX_STACK:
        raise ValueError(f"filter needs a stack of {max_depth} > "
                         f"{_MAX_STACK}")
    n_lanes = len(lanes) + len(probe_lanes or ())
    if n_lanes > _MAX_FILTER_LANES:
        raise ValueError(f"filter reads {n_lanes} lanes > "
                         f"{_MAX_FILTER_LANES}")
    buf = np.concatenate([np.asarray(nodes, np.int64).reshape(-1),
                          np.asarray(words, np.int64)])
    # member words carry bit 31: wrap to int32 two's complement
    return buf.astype(np.uint32).view(np.int32), len(nodes)


def filter_lane_keys(filter_spec) -> List[str]:
    """Lane keys ({col}.ids / .mv / .raw) the filter reads, in first-use
    order."""
    keys: List[str] = []

    def walk(spec):
        if spec[0] in ("and", "or"):
            for c in spec[1]:
                walk(c)
        elif spec[0] == "pred":
            key = _leaf(spec)[1]
            if key not in keys:
                keys.append(key)

    walk(filter_spec)
    return keys


def _general(keys) -> bool:
    """True when K1 needs its general instantiation: a raw or MV leaf (or
    a probe). DictId leaves over SV lanes and the vdoc leaf run in the
    narrow one, which keeps fewer registers."""
    return any(not k.endswith((".ids", ".vdoc")) for k in keys)


def _mask_device(keys, cols, device) -> torch.device:
    if keys:
        return cols[keys[0]].device
    if device is None:
        raise ValueError("the filter reads no lane: pass the device")
    return torch.device(device)


def filter_mask(padded: int, filter_spec, cols: Dict[str, torch.Tensor],
                params: Sequence, num_docs: int,
                device=None) -> torch.Tensor:
    """uint8 [padded] mask: filter_spec over the lanes, AND row < num_docs.

    The mask lies on the lanes' device; `device` names it when the filter
    reads no lane (match_all / empty)."""
    keys = filter_lane_keys(filter_spec)
    device = _mask_device(keys, cols, device)
    for key in keys:
        _filter_lane_ok(cols[key], key, padded, device)
    if device.type == "cpu":
        return filter_mask_plain(padded, filter_spec, cols, params, num_docs,
                                 device)
    return _launch_filter(filter_spec, cols, params, keys, device, padded,
                          padded, None, int(num_docs), None)


def _launch_filter(filter_spec, cols, params, keys, device, rows: int,
                   seg_rows: int, seg_docs: Optional[torch.Tensor],
                   num_docs: int, matched: Optional[torch.Tensor],
                   general: Optional[bool] = None) -> torch.Tensor:
    """K1 over `rows` rows in segments of seg_rows: the uint8 mask, and
    each segment's matches added into `matched` when given. `general`
    picks the instantiation; None picks by the program (_general), the
    only choice the query path makes."""
    probes: List[torch.Tensor] = []
    buf, n_nodes = compile_filter(filter_spec, params, cols, probes)
    lanes = [cols[k] for k in keys] + probes
    # the one H2D copy, from pinned memory so the host does not wait
    prog = torch.from_numpy(buf).pin_memory().to(device, non_blocking=True)
    out = torch.empty(rows, dtype=torch.uint8, device=device)
    if general is None:
        general = _general(keys)
    _launch("filter_mask", device, _ptrs(lanes), len(lanes),
            prog.data_ptr(), n_nodes, int(buf.shape[0]), int(general),
            rows, seg_rows, None if seg_docs is None else seg_docs.data_ptr(),
            num_docs, out.data_ptr(),
            None if matched is None else matched.data_ptr())
    _count_nodes("filter_mask", filter_spec, keys)
    return out


def _check_seg_docs(seg_docs: torch.Tensor, n_segs: int, device) -> None:
    if seg_docs.device != device or seg_docs.dtype != torch.int32 or \
            seg_docs.shape != (n_segs,) or not seg_docs.is_contiguous():
        raise ValueError(f"seg_docs must be a contiguous int32 [{n_segs}] "
                         f"on {device}")


def filter_mask_stacked(padded: int, n_segs: int, filter_spec,
                        cols: Dict[str, torch.Tensor], params: Sequence,
                        seg_docs: torch.Tensor, device=None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1 over a stack of n_segs segments of `padded` rows each, the lanes
    [n_segs * padded] (flat views of [S, P] stacks): (uint8 mask [S * P],
    int32 [S] matched rows per segment). Row r is live iff r % padded <
    seg_docs[r // padded] (`seg_docs`: int32 [S] on the lanes' device)."""
    keys = filter_lane_keys(filter_spec)
    device = _mask_device(keys, cols, device)
    rows = n_segs * padded
    for key in keys:
        _filter_lane_ok(cols[key], key, rows, device)
    _check_seg_docs(seg_docs, n_segs, device)
    if padded % BLOCK:
        raise ValueError(f"{padded} rows is not a multiple of {BLOCK}")
    if device.type == "cpu":
        return filter_mask_stacked_plain(padded, n_segs, filter_spec, cols,
                                         params, seg_docs, device)
    matched = torch.zeros(n_segs, dtype=torch.int32, device=device)
    return _launch_filter(filter_spec, cols, params, keys, device, rows,
                          padded, seg_docs, 0, matched), matched


MAX_BATCH = 8        # members a batched launch serves (filter_mask.cu)


def _check_masks(masks: torch.Tensor) -> Tuple[int, int]:
    """(B, P) of a batch's masks, uint8 [B, P] with 1 <= B <= MAX_BATCH."""
    if masks.dim() != 2 or not 1 <= masks.shape[0] <= MAX_BATCH:
        raise ValueError(f"masks have shape {tuple(masks.shape)}, expected "
                         f"[B <= {MAX_BATCH}, P]")
    _check_lane(masks[0], "mask", masks.shape[1], masks.device,
                (torch.uint8,))
    if not masks.is_contiguous():
        raise ValueError("masks are not contiguous")
    return masks.shape[0], masks.shape[1]


def _batched_probes(filter_spec, params_list, cols) -> List[tuple]:
    """The batched K9's (ids [B, nprobe], ok [B, nprobe]) of each
    ivf_probe node, depth first: one launch per node for every member."""
    out, pos = [], 0

    def walk(spec) -> None:
        nonlocal pos
        if spec[0] in ("and", "or"):
            for c in spec[1]:
                walk(c)
        elif spec[0] == "pred":
            if spec[1] == "ivf_probe":
                col, (nprobe, metric) = spec[2], spec[4]
                out.append(ivf_select_probes_batched(
                    cols[f"{col}.ivfc"], cols[f"{col}.ivfv"],
                    [p[pos] for p in params_list],
                    [p[pos + 1] for p in params_list], metric, nprobe))
            pos += filter_param_count(spec)

    walk(filter_spec)
    return out


def _batched_join_keys(filter_spec, params_list, cols) -> List[torch.Tensor]:
    """Each join_raw node's dim keys for every member, depth first: one
    [B, Dp] lane whose row b is member b's keys as K12 sorted them
    (SortedKeys.on, cached per query and device), stacked once per batch
    (SortedKeys.stacked). Members of one signature share Dp (it is in the
    spec); their dim sides may differ."""
    out, pos = [], 0

    def walk(spec) -> None:
        nonlocal pos
        if spec[0] in ("and", "or"):
            for c in spec[1]:
                walk(c)
        elif spec[0] == "pred":
            if spec[1] == "join_raw":
                lane = cols[_leaf(spec)[1]]
                probes = [p[pos] for p in params_list]
                if len({p.keys.shape[0] for p in probes}) != 1:
                    raise ValueError("the batch's join_raw members have "
                                     "dim sides of different lengths")
                out.append(probes[0].batch_lane(probes, lane))
            pos += filter_param_count(spec)

    walk(filter_spec)
    return out


def compile_filter_batched(filter_spec, params_list,
                           cols: Dict[str, torch.Tensor],
                           probe_lanes: List[torch.Tensor]
                           ) -> Tuple[np.ndarray, int, int]:
    """The K1 program of B members of one plan: (buffer, n_nodes, words
    per member). The nodes are the members' common ones, then each
    member's parameter block, all of one length. An ivf_probe node runs
    the batched K9 once for all the members; its lanes ([B, nprobe] ids
    and ok flags, appended to `probe_lanes`) are indexed by the member in
    the kernel. A join_raw node's lane is the members' sorted dim keys,
    [B, Dp], row b member b's (_batched_join_keys). Raises ValueError where
    the members' programs differ (in lists of other lengths)."""
    probes = _batched_probes(filter_spec, params_list, cols)
    joins = _batched_join_keys(filter_spec, params_list, cols)
    bufs = []
    for params in params_list:
        lanes: List[torch.Tensor] = []
        pending, pending_j = iter(probes), iter(joins)
        buf, n_nodes = compile_filter(filter_spec, params, cols, lanes,
                                      probe=lambda *_: next(pending),
                                      join=lambda *_: next(pending_j))
        bufs.append(buf)
    node_words = _NODE_WORDS * n_nodes
    for buf in bufs[1:]:
        if buf.shape != bufs[0].shape or \
                not np.array_equal(buf[:node_words], bufs[0][:node_words]):
            raise ValueError("the batch's filter programs differ: its "
                             "members do not share one compiled spec")
    probe_lanes.extend(lanes)
    return (np.concatenate([bufs[0][:node_words]] +
                           [b[node_words:] for b in bufs]), n_nodes,
            int(bufs[0].shape[0]) - node_words)


def filter_mask_batched(padded: int, filter_spec,
                        cols: Dict[str, torch.Tensor], params_list,
                        num_docs: int, device=None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1 for B <= MAX_BATCH members of one plan, one launch: (uint8
    masks [B, padded], int32 [B] matched rows), member b's under
    params_list[b]. Each lane element is read once for every member; a
    join_raw leaf probes each member's own sorted dim keys with the one
    key it read."""
    keys = filter_lane_keys(filter_spec)
    device = _mask_device(keys, cols, device)
    n = len(params_list)
    if not 1 <= n <= MAX_BATCH:
        raise ValueError(f"{n} members outside [1, {MAX_BATCH}]")
    for key in keys:
        _filter_lane_ok(cols[key], key, padded, device)
    if device.type == "cpu":
        return filter_mask_batched_plain(padded, filter_spec, cols,
                                         params_list, num_docs, device)
    probes: List[torch.Tensor] = []
    buf, n_nodes, words = compile_filter_batched(filter_spec, params_list,
                                                 cols, probes)
    lanes = [cols[k] for k in keys] + probes
    prog = torch.from_numpy(buf).pin_memory().to(device, non_blocking=True)
    out = torch.empty(n, padded, dtype=torch.uint8, device=device)
    matched = torch.zeros(n, dtype=torch.int32, device=device)
    _launch("filter_mask_batched", device, _ptrs(lanes), len(lanes),
            prog.data_ptr(), n_nodes, words, n, int(_general(keys)), padded,
            int(num_docs), out.data_ptr(), matched.data_ptr())
    _count_nodes("filter_mask_batched", filter_spec, keys)
    return out, matched


def filter_mask_batched_plain(padded: int, filter_spec,
                              cols: Dict[str, torch.Tensor], params_list,
                              num_docs: int, device=None
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch batched K1: each member's plain mask, stacked, and
    its row sums (a join_raw leaf: torch.searchsorted in each member's own
    dim keys, sorted by torch.sort)."""
    masks = torch.stack([filter_mask_plain(padded, filter_spec, cols, p,
                                           num_docs, device)
                         for p in params_list])
    return masks, masks.sum(dim=1, dtype=torch.int32)


def filter_mask_stacked_plain(padded: int, n_segs: int, filter_spec,
                              cols: Dict[str, torch.Tensor], params: Sequence,
                              seg_docs: torch.Tensor, device=None
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch stacked K1: the filter tree over the flat lanes, each
    segment's rows past its seg_docs masked off, and the per-segment row
    sums."""
    device = _mask_device(filter_lane_keys(filter_spec), cols, device)
    row = torch.arange(padded, device=device)
    valid = (row[None, :] < seg_docs.long()[:, None]).reshape(-1)
    mask = _filter_plain(filter_spec, cols, params, valid, device)
    return mask, mask.reshape(n_segs, padded).sum(dim=1, dtype=torch.int32)


def filter_mask_plain(padded: int, filter_spec,
                      cols: Dict[str, torch.Tensor], params: Sequence,
                      num_docs: int, device=None) -> torch.Tensor:
    """Plain PyTorch K1: the filter tree evaluated with tensor ops."""
    device = _mask_device(filter_lane_keys(filter_spec), cols, device)
    valid = torch.arange(padded, device=device) < int(num_docs)
    return _filter_plain(filter_spec, cols, params, valid, device)


def _filter_plain(filter_spec, cols, params, valid: torch.Tensor,
                  device) -> torch.Tensor:
    """The filter tree over the lanes with tensor ops, AND `valid`."""
    plist = list(params)

    def as_t(v, dtype):
        return torch.as_tensor(np.asarray(v, dtype=_np_of(dtype)),
                               device=device)

    def walk(spec) -> torch.Tensor:
        op = spec[0]
        if op == "match_all":
            return valid
        if op == "empty":
            return torch.zeros_like(valid)
        if op in ("and", "or"):
            masks = [walk(c) for c in spec[1]]
            out = masks[0]
            for m in masks[1:]:
                out = (out & m) if op == "and" else (out | m)
            return out
        kind, key = _leaf(spec)
        lane = cols[key]
        if kind == "ivf_probe":
            return _probe_plain(spec, cols, plist.pop(0), plist.pop(0))
        if kind == "vdoc":
            return lane.bool()
        if kind == "join_raw":
            sk = sorted_keys_for(plist.pop(0), lane, plain=True)
            return sk[torch.searchsorted(sk, lane).clamp_max(
                sk.shape[0] - 1)] == lane
        if kind not in _RAW_KINDS:
            lane = lane.to(torch.int32)
        cdt = lane.dtype
        if kind in ("eq_id", "eq_raw"):
            m = lane == as_t(plist.pop(0), cdt)
        elif kind in ("neq_id", "neq_raw"):
            m = lane != as_t(plist.pop(0), cdt)
        elif kind == "range_ids":
            lo, hi = as_t(plist.pop(0), cdt), as_t(plist.pop(0), cdt)
            m = (lane >= lo) & (lane < hi)
        elif kind == "range_raw":
            lo, hi = as_t(plist.pop(0), cdt), as_t(plist.pop(0), cdt)
            lo_inc, hi_inc = spec[4]
            m = ((lane >= lo) if lo_inc else (lane > lo)) & \
                ((lane <= hi) if hi_inc else (lane < hi))
        elif kind in ("in_ids", "notin_ids", "in_raw", "notin_raw"):
            vals = as_t(plist.pop(0), cdt).reshape(-1)
            hit = (lane[..., None] == vals).any(-1)
            m = hit if kind in ("in_ids", "in_raw") else ~hit
        else:                                          # member
            member = as_t(plist.pop(0), torch.bool)
            m = member[lane.clamp(0, member.shape[0] - 1).long()]
        if m.dim() == 2:                               # MV: any entry
            m = m.any(-1)
        return m

    mask = walk(filter_spec) & valid
    return mask.to(torch.uint8)


def _probe_plain(spec, cols, q, q_norm) -> torch.Tensor:
    """An ivf_probe leaf: the row's assignment is one of its segment's ok
    probe ids (one segment, or a stack: the probe list per segment)."""
    _, _kind, col, _source, (nprobe, metric) = spec
    ids, ok = ivf_select_probes(cols[f"{col}.ivfc"], cols[f"{col}.ivfv"], q,
                                q_norm, metric, nprobe)
    assign = cols[f"{col}.ivfa"].to(torch.int32)
    segs = ids.shape[0] if ids.dim() == 2 else 1
    a = assign.reshape(segs, -1, 1)
    hit = (a == ids.reshape(segs, 1, -1)) & ok.reshape(segs, 1, -1)
    return hit.any(-1).reshape(-1)


# ---------------------------------------------------------------------------
# K2 masked_part_sums
# ---------------------------------------------------------------------------

_MAX_PARTS = 16


def _part_rows(part_lanes: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """[n_parts, P] lane blocks → their [P] rows (views, no copy)."""
    rows = []
    for pl in part_lanes:
        if pl.dim() != 2:
            raise ValueError(f"part lanes must be [n_parts, P], got "
                             f"{tuple(pl.shape)}")
        rows.extend(pl[k] for k in range(pl.shape[0]))
    return rows


def _part_lane_rows(part_lanes, padded: int, device) -> List[torch.Tensor]:
    """The [P] rows of K2's part lanes, checked."""
    rows = _part_rows(part_lanes)
    for k, r in enumerate(rows):
        _check_lane(r, f"part lane {k}", padded, device, (torch.int8,))
    if len(rows) > _MAX_PARTS:
        raise ValueError(f"{len(rows)} part lanes > {_MAX_PARTS}")
    return rows


def part_sum_range(rows: int) -> int:
    """The rows of one K2 output row for a segment of `rows` rows: all of
    them while 127 * rows < 2^31, else the largest multiple of BLOCK (of
    256, K2's block, where `rows` is not a multiple of BLOCK) that
    divides `rows` and stays below that bound (the JAX `_part_sums`
    block partials, folded on the host in int64)."""
    if 127 * rows < 2**31:
        return rows
    unit = BLOCK if rows % BLOCK == 0 else 256
    if rows % unit:
        raise ValueError(f"{rows} rows is not a multiple of 256")
    units = rows // unit
    per = max(b for b in range(1, (INT32_MAX // 127) // unit + 1)
              if units % b == 0)
    return per * unit


def masked_part_sums(mask: torch.Tensor,
                     part_lanes: Sequence[torch.Tensor],
                     seg_rows: Optional[int] = None) -> torch.Tensor:
    """int32 [L + 1]: the masked sum of each int8 part lane (L = all rows
    of all the [n_parts, P] blocks, in order), then the match count.

    With `seg_rows` (stacked segments of that many rows each), or when 127
    * P passes 2^31: int32 [R, L + 1], one such row per range of
    part_sum_range(segment rows) rows, segment by segment, each exact (the
    JAX `partsT` / `_part_sums` partials; the host adds the rows in
    int64)."""
    padded, device = mask.shape[0], mask.device
    _check_mask(mask)
    rows = _part_lane_rows(part_lanes, padded, device)
    seg = padded if seg_rows is None else int(seg_rows)
    if seg < 1 or padded % seg or seg % 256:
        raise ValueError(f"{padded} rows do not split into segments of "
                         f"{seg} (a multiple of 256)")
    per = part_sum_range(seg)
    if device.type == "cpu":
        out = masked_part_sums_plain(mask, part_lanes, per)
    else:
        out = torch.zeros(padded // per, len(rows) + 1, dtype=torch.int32,
                          device=device)
        _launch("masked_part_sums", device, mask.data_ptr(), _ptrs(rows),
                len(rows), padded, per, out.data_ptr())
    return out[0] if seg_rows is None and per == padded else out


def masked_part_sums_plain(mask: torch.Tensor,
                           part_lanes: Sequence[torch.Tensor],
                           seg_rows: Optional[int] = None) -> torch.Tensor:
    """Plain PyTorch K2: where + sum(dtype=int32); [L + 1], or [P /
    seg_rows, L + 1] with seg_rows."""
    per = mask.shape[0] if seg_rows is None else int(seg_rows)
    m = mask.bool().reshape(-1, per)
    sums = [torch.where(m[None], pl.reshape(pl.shape[0], -1, per), 0)
            .sum(dim=2, dtype=torch.int32).T for pl in part_lanes]
    count = m.sum(dim=1, dtype=torch.int32)[:, None]
    out = torch.cat(sums + [count], dim=1)
    return out[0] if seg_rows is None else out


def masked_part_sums_batched(masks: torch.Tensor,
                             part_lanes: Sequence[torch.Tensor]
                             ) -> torch.Tensor:
    """K2 for B members, one launch: int32 [B, L + 1], member b's sums
    under masks[b]; past 127 * P >= 2^31, [B, R, L + 1] with one exact row
    per range of part_sum_range(P) rows, as masked_part_sums gives one
    member."""
    n, padded = _check_masks(masks)
    device = masks.device
    rows = _part_lane_rows(part_lanes, padded, device)
    if padded % 256:
        raise ValueError(f"{padded} rows is not a multiple of 256")
    per = part_sum_range(padded)
    if device.type == "cpu":
        out = masked_part_sums_batched_plain(masks, part_lanes, per)
    else:
        out = torch.zeros(n, padded // per, len(rows) + 1,
                          dtype=torch.int32, device=device)
        _launch("masked_part_sums_batched", device, masks.data_ptr(),
                _ptrs(rows), len(rows), padded, per, n, out.data_ptr())
    return out[:, 0] if per == padded else out


def masked_part_sums_batched_plain(masks: torch.Tensor,
                                   part_lanes: Sequence[torch.Tensor],
                                   seg_rows: Optional[int] = None
                                   ) -> torch.Tensor:
    """Plain PyTorch batched K2: each member's plain sums, stacked."""
    return torch.stack([masked_part_sums_plain(m, part_lanes, seg_rows)
                        for m in masks])


# ---------------------------------------------------------------------------
# K3 dense_group_aggregate
# ---------------------------------------------------------------------------

_MAX_KEYS = 8
_MAX_FLOATS = 8
_MAX_EXT = 16
_EXT_MODES = {("ids", "min"): 0, ("ids", "max"): 1, ("raw", "min"): 2,
              ("raw", "max"): 3}
#: K3 folds into per-block shared-memory tables up to this many slots
#: (when they fit), into the device table above it. Set from chip_smoke's
#: K3 cases timed with the tables forced on and off (PERF.md): on the H100
#: on won at 32 and 256 slots, tied at 1024 and lost 2.6-3.8x at 8192.
K3_SMEM_SLOTS = 256


def _ext_init(kind: str, which: str, card_pad: int):
    """The value a min / max table starts at (the JAX sentinels)."""
    if kind == "ids":
        return card_pad if which == "min" else -1
    return float("inf") if which == "min" else float("-inf")


#: group key kinds shared with dense_group_aggregate.cu (KeyKind)
_KEY_KINDS = {"ids": 0, "rawoff": 1, "mvids": 2, "mvin": 3, "jcode": 4,
              "jraw": 5, "idoff": 6, "idrank": 7}
#: key kinds whose lane is a dictId lane [P]
_ID_KEY_KINDS = ("ids", "jcode", "idoff", "idrank")
_MV_KEY_KINDS = ("mvids", "mvin")
#: one K3 thread walks at most this many MV entry combinations of a doc;
#: a longer walk is split over several threads (dense_group_aggregate.cu)
MAX_GROUP_COMBOS = 1 << 16
#: combinations per doc above which even one row's int32 tables could
#: overflow (127 * W_total >= 2^31)
MAX_DOC_COMBOS = INT32_MAX // 127


@dataclasses.dataclass(eq=False)
class GroupKey:
    """One group column as K3 reads it (a bare tensor means kind "ids"):

    - "ids": a dictId lane [P];
    - "rawoff": an int32 / int64 raw lane [P]; the key is (value -
      offset) in the lane's width, narrowed to int32;
    - "mvids": an MV dictId lane [P, W]; entries >= card (the padding id,
      the cardinality) drop the combination;
    - "mvin": as "mvids", and entries whose `member` (bool [card_pad])
      is False drop it too;
    - "jcode": a dictId lane [P] (a join's fact key); the key is
      table[clip(id, 0, len - 1)], `table` the int32 dim group code of
      each fact dictId;
    - "jraw": an int32 / int64 raw lane [P] (a join's fact key); the key
      is codes[clip(searchsorted(table, value), 0, len - 1)], `table` the
      dim keys sorted ascending in the lane's dtype and `codes` their
      int32 group codes, as K12 sorted them (SortedKeys.on); `probe` is
      that SortedKeys, which the plain version sorts itself
      (SortedKeys.plain);
    - "idoff": a dictId lane [P]; the key is id - offset in int32 (the
      adaptive offset remap, `offset` the scout's smallest matched id);
    - "idrank": a dictId lane [P]; the key is table[id] (the adaptive
      rank remap, `table` an int32 [card_pad] rank of each present id),
      0 for an id outside [0, len)."""
    kind: str
    lane: torch.Tensor
    card: int = 0
    offset: int = 0
    member: Optional[torch.Tensor] = None
    table: Optional[torch.Tensor] = None
    codes: Optional[torch.Tensor] = None
    probe: Optional["SortedKeys"] = None

    @property
    def width(self) -> int:
        return self.lane.shape[1] if self.kind in _MV_KEY_KINDS else 1


def _as_key(k) -> GroupKey:
    return k if isinstance(k, GroupKey) else GroupKey("ids", k)


def _check_key(key: GroupKey, c: int, padded: int, device) -> None:
    what = f"key lane {c} ({key.kind})"
    if key.kind not in _KEY_KINDS:
        raise ValueError(f"group key kind {key.kind}")
    if key.kind in _ID_KEY_KINDS:
        _check_lane(key.lane, what, padded, device, _ID_DTYPES)
        if key.kind == "idoff" and not -2**31 <= key.offset <= INT32_MAX:
            raise ValueError(f"{what}: offset {key.offset} outside int32")
    elif key.kind == "jraw":
        _check_lane(key.lane, what, padded, device,
                    (torch.int32, torch.int64))
    elif key.kind == "rawoff":
        _check_lane(key.lane, what, padded, device,
                    (torch.int32, torch.int64))
        info = torch.iinfo(key.lane.dtype)
        if not info.min <= key.offset <= info.max:
            raise ValueError(f"{what}: offset {key.offset} outside "
                             f"{key.lane.dtype}")
    else:
        _check_lane(key.lane, what, padded, device, _ID_DTYPES, 2)
        if key.lane.shape[1] < 1 or not 0 <= key.card <= INT32_MAX:
            raise ValueError(f"{what}: width {key.lane.shape[1]}, card "
                             f"{key.card}")
    if key.kind == "mvin":
        m = key.member
        if m is None or m.device != device or m.dim() != 1 or \
                m.shape[0] < 1 or m.dtype not in (torch.bool, torch.uint8) \
                or not m.is_contiguous():
            raise ValueError(f"{what}: the member table must be a "
                             f"contiguous bool [card_pad] on {device}")
    if key.kind in ("jcode", "jraw", "idrank"):
        t = key.table
        dtype = key.lane.dtype if key.kind == "jraw" else torch.int32
        if t is None or t.device != device or t.dim() != 1 or \
                not 1 <= t.shape[0] <= INT32_MAX or t.dtype != dtype or \
                not t.is_contiguous():
            raise ValueError(f"{what}: the table must be a contiguous "
                             f"{dtype} [len >= 1] on {device}")
        c = key.codes
        if key.kind == "jraw" and (
                c is None or c.device != device or c.dtype != torch.int32
                or c.shape != t.shape or not c.is_contiguous()):
            raise ValueError(f"{what}: the codes must be a contiguous "
                             f"int32 {tuple(t.shape)} on {device}")


def group_combos(key_lanes) -> int:
    """W_total: the MV entry combinations K3 walks per doc."""
    return int(np.prod([_as_key(k).width for k in key_lanes],
                       dtype=np.int64))


def k3_rows_per_launch(w_total: int, psums_wide: bool = False) -> int:
    """The rows one K3 launch takes: a doc adds up to W_total times, and
    the launch's int32 counts and part sums stay exact while
    127 * rows * W_total < 2^31, as over DENSE_ROWS_LIMIT single rows;
    with int64 part sums (psums_wide) only the int32 counts bound it."""
    if psums_wide:
        return max(1, INT32_MAX // w_total)
    return max(1, DENSE_ROWS_LIMIT // w_total)


def dense_group_aggregate(mask: torch.Tensor, key_lanes: Sequence,
                          strides: Sequence[int], g_pad: int,
                          part_lanes: Sequence[torch.Tensor] = (),
                          float_lanes: Sequence[torch.Tensor] = (),
                          extremes: Sequence[tuple] = (),
                          smem_slots: int = K3_SMEM_SLOTS,
                          psums_wide: bool = False,
                          chunk_psums: bool = False):
    """Dense group table over key = clip(Σ term_c · stride_c, 0, g_pad-1).

    `key_lanes`: one GroupKey (or bare id lane) per group column. A doc
    with MV keys adds its values once per surviving cross-combination of
    their entries. `extremes`: ((kind, lane, which, card_pad), ...), kind
    "ids" (an id lane, int32 table starting at card_pad for min / -1 for
    max) or "raw" (an int32/int64/float32/float64 lane, float64 table
    starting at ±inf), which ∈ {"min", "max"}. `smem_slots`: the largest
    g_pad the kernel folds in shared memory (0: never).

    Returns (count int32 [g_pad], psums int32 [L, g_pad], csums float64
    [J, g_pad], matched int32 scalar (docs, once each), [one table per
    extreme]), L = all part-lane rows, J = float lanes (float64 [P]
    each). Past k3_rows_per_launch(W_total) rows, K3 runs once per slice
    of that many rows and the slices' tables add up, counts and part sums
    in int64. `psums_wide` (a stack of segments in one launch): psums are
    int64, folded exactly on the card, and only the int32 counts bound
    the rows of a launch. `chunk_psums`: past one launch's rows the
    slices' int32 part sums come back apart, [C, L, g_pad] (the compacted
    group-by's cpsums chunks), not added."""
    padded, device = mask.shape[0], mask.device
    _check_mask(mask)
    keys = [_as_key(k) for k in key_lanes]
    if not 1 <= len(keys) <= _MAX_KEYS or len(strides) != len(keys):
        raise ValueError(f"{len(keys)} key lanes / {len(strides)} "
                         f"strides (1..{_MAX_KEYS} keys)")
    for c, key in enumerate(keys):
        _check_key(key, c, padded, device)
    rows = _part_rows(part_lanes)
    for k, r in enumerate(rows):
        _check_lane(r, f"part lane {k}", padded, device, (torch.int8,))
    for j, f in enumerate(float_lanes):
        _check_lane(f, f"float lane {j}", padded, device, (torch.float64,))
    for e, (kind, lane, which, _cp) in enumerate(extremes):
        if (kind, which) not in _EXT_MODES:
            raise ValueError(f"extreme {e}: ({kind}, {which})")
        _check_lane(lane, f"extreme lane {e}", padded, device,
                    _ID_DTYPES if kind == "ids" else _RAW_DTYPES)
    if len(rows) > _MAX_PARTS or len(float_lanes) > _MAX_FLOATS or \
            len(extremes) > _MAX_EXT:
        raise ValueError(f"{len(rows)} part / {len(float_lanes)} float / "
                         f"{len(extremes)} extreme lanes over the kernel's "
                         "limits")
    if not 1 <= g_pad <= INT32_MAX:
        raise ValueError(f"g_pad {g_pad} outside the int32 table")
    w_total = group_combos(keys)
    if w_total > MAX_DOC_COMBOS:
        raise ValueError(f"{w_total} MV entry combinations per doc > "
                         f"{MAX_DOC_COMBOS}: int32 group tables overflow")
    step = k3_rows_per_launch(w_total, psums_wide)
    if padded > step:
        return _k3_slices(mask, keys, strides, g_pad, rows, float_lanes,
                          extremes, smem_slots, step, psums_wide,
                          chunk_psums)
    if device.type == "cpu":
        return dense_group_aggregate_plain(mask, keys, strides, g_pad,
                                           part_lanes, float_lanes,
                                           extremes, psums_wide)
    count = torch.zeros(g_pad, dtype=torch.int32, device=device)
    psums = torch.zeros(len(rows), g_pad, dtype=torch.int64 if psums_wide
                        else torch.int32, device=device)
    csums = torch.zeros(len(float_lanes), g_pad, dtype=torch.float64,
                        device=device)
    matched = torch.zeros((), dtype=torch.int32, device=device)
    ext_tables = [torch.full((g_pad,), _ext_init(kind, which, cp),
                             dtype=torch.int32 if kind == "ids"
                             else torch.float64, device=device)
                  for kind, _lane, which, cp in extremes]
    _launch("dense_group_aggregate", device, mask.data_ptr(),
            *_key_args(keys, strides), _ptrs(rows), len(rows),
            _ptrs(float_lanes), len(float_lanes),
            _ptrs([e[1] for e in extremes]),
            _ints([_ELEM[e[1].dtype] for e in extremes]),
            _ints([_EXT_MODES[(e[0], e[2])] for e in extremes]),
            _ints([_ext_init(e[0], e[2], e[3]) if e[0] == "ids" else 0
                   for e in extremes]),
            _ptrs(ext_tables), len(extremes), padded, int(g_pad),
            int(smem_slots), int(psums_wide), count.data_ptr(),
            psums.data_ptr(), csums.data_ptr(), matched.data_ptr())
    _count_key_nodes("dense_group_aggregate", keys)
    return count, psums, csums, matched, ext_tables


def _ptrs_or_null(ts):
    return (_P * len(ts))(*[None if t is None else t.data_ptr() for t in ts])


def _key_args(keys: Sequence[GroupKey], strides: Sequence[int]) -> tuple:
    """The key lanes as K3's and K14's C entry points take them
    (group_key.cuh:fill_key_lanes), through n_keys."""
    members = [k.member if k.kind == "mvin" else None for k in keys]
    tables = [k.table if k.kind in ("jcode", "jraw", "idrank") else None
              for k in keys]
    codes = [k.codes if k.kind == "jraw" else None for k in keys]
    return (_ptrs([k.lane for k in keys]),
            _ints([_ELEM[k.lane.dtype] for k in keys]), _ints(strides),
            _ints([_KEY_KINDS[k.kind] for k in keys]),
            _ints([k.width for k in keys]), _ints([k.card for k in keys]),
            _longs([k.offset for k in keys]), _ptrs_or_null(members),
            _ints([0 if m is None else m.shape[0] for m in members]),
            _ptrs_or_null(tables), _ptrs_or_null(codes),
            _ints([0 if t is None else t.shape[0] for t in tables]),
            len(keys))


def _count_key_nodes(name: str, keys: Sequence[GroupKey]) -> None:
    """One more launch of `name` for each counted key kind it holds."""
    for kind in {k.kind for k in keys} & set(KERNELS[name].node_launches):
        _count_node(name, kind)


def _k3_slices(mask, keys, strides, g_pad, rows, float_lanes, extremes,
               smem_slots, step, psums_wide=False, chunk_psums=False):
    """K3 over row slices of `step` rows, the slices' tables added
    (counts and part sums in int64, min / max tables by min / max), or
    with `chunk_psums` the part sums stacked [C, L, g_pad]."""
    outs = []
    for s in range(0, mask.shape[0], step):
        e = s + step
        outs.append(dense_group_aggregate(
            mask[s:e], [dataclasses.replace(k, lane=k.lane[s:e])
                        for k in keys], strides, g_pad,
            [r[s:e].unsqueeze(0) for r in rows],
            [f[s:e] for f in float_lanes],
            [(kind, lane[s:e], which, cp)
             for kind, lane, which, cp in extremes], smem_slots,
            psums_wide))
    count = sum(o[0].to(torch.int64) for o in outs)
    psums = torch.stack([o[1] for o in outs]) if chunk_psums else \
        sum(o[1].to(torch.int64) for o in outs)
    csums = sum(o[2] for o in outs)
    matched = sum(o[3] for o in outs)
    tables = []
    for e, (_kind, _lane, which, _cp) in enumerate(extremes):
        t = outs[0][4][e]
        for o in outs[1:]:
            t = (torch.minimum if which == "min" else torch.maximum)(
                t, o[4][e])
        tables.append(t)
    return count, psums, csums, matched, tables


def group_keys_plain(mask: torch.Tensor, key_lanes: Sequence,
                     strides: Sequence[int], g_pad: int,
                     with_index: bool = False) -> Tuple[torch.Tensor, ...]:
    """Plain PyTorch of K3's key walk, as `_expand_mv_group` and
    `_group_key` compute it: (row index, clipped int32 key) of every
    matched (doc, MV entry combination) that survives, first MV key
    fastest, in row order; `with_index` adds each one's index in the
    expanded row space (doc * W_total + combination)."""
    keys = [_as_key(k) for k in key_lanes]
    device = mask.device
    w_total = group_combos(keys)
    # only matched docs expand: [matched, W_total], not [P, W_total]
    docs = torch.nonzero(mask.bool()).reshape(-1)
    n = docs.shape[0]
    keep = torch.ones(n, w_total, dtype=torch.bool, device=device)
    key = torch.zeros(n, w_total, dtype=torch.int32, device=device)
    radix = 1
    for k, s in zip(keys, strides):
        if k.kind in _MV_KEY_KINDS:
            w = k.width
            entry = (torch.arange(w_total, device=device) // radix) % w
            radix *= w
            ids = k.lane[docs].to(torch.int32)[:, entry]     # [n, W_total]
            keep = keep & (ids < k.card)
            if k.kind == "mvin":
                member = k.member.bool()
                keep = keep & member[ids.clamp(0, member.shape[0] - 1)
                                     .long()]
        elif k.kind == "rawoff":
            ids = (k.lane[docs] - k.offset).to(torch.int32)[:, None]
        elif k.kind == "jcode":
            ids = k.table[k.lane[docs].to(torch.int64).clamp(
                0, k.table.shape[0] - 1)][:, None]
        elif k.kind == "jraw":
            table, codes = k.probe.plain(device)
            pos = torch.searchsorted(table, k.lane[docs]).clamp_max(
                table.shape[0] - 1)
            ids = codes[pos][:, None]
        elif k.kind == "idoff":
            ids = (k.lane[docs].to(torch.int64) - k.offset).to(
                torch.int32)[:, None]
        elif k.kind == "idrank":
            ids = k.lane[docs].to(torch.int64)
            inside = (ids >= 0) & (ids < k.table.shape[0])
            ids = torch.where(inside, k.table[ids.clamp(
                0, k.table.shape[0] - 1)], 0)[:, None]
        else:
            ids = k.lane[docs].to(torch.int32)[:, None]
        key += ids * int(np.int32(s))
    rows = docs[:, None].expand(n, w_total)[keep]
    key = key.clamp(0, g_pad - 1)[keep].long()
    if with_index:
        combo = torch.arange(w_total, device=device)[None].expand(
            n, w_total)[keep]
        return rows, key, rows * w_total + combo
    return rows, key


def dense_group_aggregate_plain(mask, key_lanes, strides, g_pad: int,
                                part_lanes=(), float_lanes=(), extremes=(),
                                psums_wide: bool = False):
    """Plain PyTorch K3: the key walk (group_keys_plain), then
    index_add_ / scatter_reduce_ of the surviving (row, key) pairs."""
    device = mask.device
    rows, key = group_keys_plain(mask, key_lanes, strides, g_pad)
    count = torch.zeros(g_pad, dtype=torch.int32, device=device)
    count.index_add_(0, key, torch.ones_like(key, dtype=torch.int32))
    prows = _part_rows(part_lanes)
    pdt = torch.int64 if psums_wide else torch.int32
    psums = torch.zeros(len(prows), g_pad, dtype=pdt, device=device)
    for k, r in enumerate(prows):
        psums[k].index_add_(0, key, r[rows].to(pdt))
    csums = torch.zeros(len(float_lanes), g_pad, dtype=torch.float64,
                        device=device)
    for j, f in enumerate(float_lanes):
        csums[j].index_add_(0, key, f[rows].to(torch.float64))
    tables = []
    for kind, lane, which, cp in extremes:
        dtype = torch.int32 if kind == "ids" else torch.float64
        t = torch.full((g_pad,), _ext_init(kind, which, cp), dtype=dtype,
                       device=device)
        t.scatter_reduce_(0, key, lane[rows].to(dtype),
                          "amin" if which == "min" else "amax")
        tables.append(t)
    return count, psums, csums, mask.bool().sum(dtype=torch.int32), tables


# ---------------------------------------------------------------------------
# K14 block_compact, K15 slot_tables, K16 rank_slots (group_compact.cu)
# ---------------------------------------------------------------------------

_MAX_COMPACT_LANES = 16          # group_compact.cu: parts, values, ids


def _check_compact_lanes(part_lanes, value_lanes, id_lanes, padded: int,
                         device) -> List[torch.Tensor]:
    rows = _part_rows(part_lanes)
    for k, r in enumerate(rows):
        _check_lane(r, f"part lane {k}", padded, device, (torch.int8,))
    for j, v in enumerate(value_lanes):
        _check_lane(v, f"value lane {j}", padded, device, _RAW_DTYPES)
    for i, v in enumerate(id_lanes):
        _check_lane(v, f"id lane {i}", padded, device, _ID_DTYPES)
    if max(len(rows), len(value_lanes), len(id_lanes)) > _MAX_COMPACT_LANES:
        raise ValueError(f"{len(rows)} part / {len(value_lanes)} value / "
                         f"{len(id_lanes)} id lanes over the kernel's limit "
                         f"of {_MAX_COMPACT_LANES} each")
    return rows


def block_compact(mask: torch.Tensor, key_lanes: Sequence,
                  strides: Sequence[int], g_pad: int, r: int,
                  part_lanes: Sequence[torch.Tensor] = (),
                  value_lanes: Sequence[torch.Tensor] = (),
                  id_lanes: Sequence[torch.Tensor] = ()):
    """K14: the matched rows (MV keys: _expand_mv_group's P * W_total
    expanded rows, walked and never written) in blocks of CBLOCK, each
    block's first r matched rows in row order moved to its r slots.

    Returns (keys int32 [cap], the clipped group key of each slot and
    g_pad for an unused one; parts int8 [L, cap]; values float64 [V,
    cap]; ids int32 [I, cap]; overflow int32 (1 when a block matched more
    than r rows); matched int32, the docs matched, each once), cap =
    P * W_total / CBLOCK * r, unused slots zero. A [S * P] stack's blocks
    never straddle two segments (P is a multiple of BLOCK), so segment s
    owns slots [s * cap / S, (s + 1) * cap / S)."""
    padded, device = mask.shape[0], mask.device
    _check_mask(mask)
    keys = [_as_key(k) for k in key_lanes]
    if not 1 <= len(keys) <= _MAX_KEYS or len(strides) != len(keys):
        raise ValueError(f"{len(keys)} key lanes / {len(strides)} strides")
    for c, key in enumerate(keys):
        _check_key(key, c, padded, device)
    rows = _check_compact_lanes(part_lanes, value_lanes, id_lanes, padded,
                                device)
    w_total = group_combos(keys)
    n_rows = padded * w_total
    if n_rows % CBLOCK or not 1 <= r <= CBLOCK or not 1 <= g_pad <= \
            INT32_MAX or w_total > MAX_DOC_COMBOS:
        raise ValueError(f"{n_rows} rows, r {r}, g_pad {g_pad}, "
                         f"{w_total} combinations a doc")
    if device.type == "cpu":
        return block_compact_plain(mask, keys, strides, g_pad, r,
                                   part_lanes, value_lanes, id_lanes)
    cap = n_rows // CBLOCK * r
    keys_out = torch.empty(cap, dtype=torch.int32, device=device)
    parts = torch.empty(len(rows), cap, dtype=torch.int8, device=device)
    vals = torch.empty(len(value_lanes), cap, dtype=torch.float64,
                       device=device)
    ids = torch.empty(len(id_lanes), cap, dtype=torch.int32, device=device)
    flags = torch.zeros(2, dtype=torch.int32, device=device)
    _launch("block_compact", device, mask.data_ptr(),
            *_key_args(keys, strides), _ptrs(rows), len(rows),
            _ptrs(value_lanes), _ints([_ELEM[v.dtype] for v in value_lanes]),
            len(value_lanes), _ptrs(id_lanes),
            _ints([_ELEM[v.dtype] for v in id_lanes]), len(id_lanes),
            n_rows, int(g_pad), int(r), keys_out.data_ptr(),
            parts.data_ptr(), vals.data_ptr(), ids.data_ptr(),
            flags[0].data_ptr(), flags[1].data_ptr())
    _count_key_nodes("block_compact", keys)
    return keys_out, parts, vals, ids, flags[0], flags[1]


def block_compact_plain(mask, key_lanes, strides, g_pad: int, r: int,
                        part_lanes=(), value_lanes=(), id_lanes=()):
    """Plain PyTorch K14: the key walk (group_keys_plain, in expanded row
    order), each survivor's rank in its block from a bincount and a
    cumsum, then the slots written by index."""
    device = mask.device
    keys = [_as_key(k) for k in key_lanes]
    n_blocks = mask.shape[0] * group_combos(keys) // CBLOCK
    cap = n_blocks * r
    rows, key, e = group_keys_plain(mask, keys, strides, g_pad,
                                    with_index=True)
    block = e // CBLOCK
    counts = torch.bincount(block, minlength=n_blocks)
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.arange(e.shape[0], device=device) - starts[block]
    take = rank < r
    slot, rows = block[take] * r + rank[take], rows[take]
    keys_out = torch.full((cap,), g_pad, dtype=torch.int32, device=device)
    keys_out[slot] = key[take].to(torch.int32)
    prows = _part_rows(part_lanes)
    parts = torch.zeros(len(prows), cap, dtype=torch.int8, device=device)
    vals = torch.zeros(len(value_lanes), cap, dtype=torch.float64,
                       device=device)
    ids = torch.zeros(len(id_lanes), cap, dtype=torch.int32, device=device)
    for k, p in enumerate(prows):
        parts[k, slot] = p[rows]
    for j, v in enumerate(value_lanes):
        vals[j, slot] = v[rows].to(torch.float64)
    for i, v in enumerate(id_lanes):
        ids[i, slot] = v[rows].to(torch.int32)
    return (keys_out, parts, vals, ids,
            (counts > r).any().to(torch.int32),
            mask.bool().sum(dtype=torch.int32))


def _psums_chunks(cap: int, chunk_slots: int) -> int:
    return -(-cap // chunk_slots)


def slot_tables(gslot: torch.Tensor, t_slots: int, cap: int,
                parts: torch.Tensor, sums: torch.Tensor,
                extremes: Sequence[tuple] = (),
                chunk_slots: Optional[int] = None, psums_wide: bool = False,
                smem_slots: int = K3_SMEM_SLOTS):
    """K15: tables over compacted slots. `gslot` int32 [n] addresses a
    table slot (gslot >= t_slots drops it); `cap` is a segment's slots
    (n a multiple of it); `parts` int8 [L, n] and `sums` float64 [J, n]
    are K14's compacted lanes; `extremes`: ((kind, lane, which, init),
    ...), kind "ids" (an int32 [n] lane, an int32 table starting at
    `init`) or "raw" (a float64 [n] lane, a float64 table starting at
    ±inf), which ∈ {"min", "max"}.

    Returns (count int32 [t_slots], psums, csums float64 [J, t_slots],
    [one table per extreme]): psums int32 [C, L, t_slots], one table per
    `chunk_slots` (DENSE_ROWS_LIMIT) slots of each segment's cap, so that
    each stays exact, or with `psums_wide` (a stack's dense table) int64
    [L, t_slots]."""
    n, device = gslot.shape[0], gslot.device
    chunk_slots = DENSE_ROWS_LIMIT if chunk_slots is None else chunk_slots
    _check_lane(gslot, "gslot", n, device, (torch.int32,))
    if parts.shape[1:] != (n,) or sums.shape[1:] != (n,) or \
            parts.dtype != torch.int8 or sums.dtype != torch.float64 or \
            parts.device != device or sums.device != device:
        raise ValueError(f"parts {tuple(parts.shape)} {parts.dtype} / sums "
                         f"{tuple(sums.shape)} {sums.dtype} do not match "
                         f"{n} int8 / float64 slots on {device}")
    for e, (kind, lane, which, _init) in enumerate(extremes):
        if (kind, which) not in _EXT_MODES:
            raise ValueError(f"extreme {e}: ({kind}, {which})")
        _check_lane(lane, f"extreme lane {e}", n, device,
                    (torch.int32,) if kind == "ids" else (torch.float64,))
    if max(parts.shape[0], sums.shape[0], len(extremes)) > \
            _MAX_COMPACT_LANES or not 1 <= t_slots <= INT32_MAX or \
            cap < 1 or n % cap or chunk_slots < 1:
        raise ValueError(f"{parts.shape[0]} part / {sums.shape[0]} sum / "
                         f"{len(extremes)} extreme lanes, t_slots {t_slots}, "
                         f"cap {cap} of {n} slots")
    if device.type == "cpu":
        return slot_tables_plain(gslot, t_slots, cap, parts, sums, extremes,
                                 chunk_slots, psums_wide)
    n_parts = parts.shape[0]
    count = torch.zeros(t_slots, dtype=torch.int32, device=device)
    psums = torch.zeros((n_parts, t_slots) if psums_wide else
                        (_psums_chunks(cap, chunk_slots), n_parts, t_slots),
                        dtype=torch.int64 if psums_wide else torch.int32,
                        device=device)
    csums = torch.zeros(sums.shape[0], t_slots, dtype=torch.float64,
                        device=device)
    tables = [torch.full((t_slots,), init if kind == "ids" else
                         _ext_init(kind, which, 0),
                         dtype=torch.int32 if kind == "ids"
                         else torch.float64, device=device)
              for kind, _lane, which, init in extremes]
    _launch("slot_tables", device, gslot.data_ptr(), n, int(cap),
            int(chunk_slots), _ptrs(list(parts)), n_parts, _ptrs(list(sums)),
            sums.shape[0], _ptrs([e[1] for e in extremes]),
            _ints([_EXT_MODES[(e[0], e[2])] for e in extremes]),
            _ints([e[3] if e[0] == "ids" else 0 for e in extremes]),
            _ptrs(tables), len(extremes), int(t_slots), int(smem_slots),
            int(psums_wide), count.data_ptr(), psums.data_ptr(),
            csums.data_ptr())
    return count, psums, csums, tables


def slot_tables_plain(gslot, t_slots: int, cap: int, parts, sums,
                      extremes=(), chunk_slots: Optional[int] = None,
                      psums_wide: bool = False):
    """Plain PyTorch K15: index_add_ and scatter_reduce_ over the valid
    slots."""
    device = gslot.device
    chunk_slots = DENSE_ROWS_LIMIT if chunk_slots is None else chunk_slots
    idx = torch.nonzero((gslot >= 0) & (gslot < t_slots)).reshape(-1)
    g = gslot[idx].long()
    count = torch.zeros(t_slots, dtype=torch.int32, device=device)
    count.index_add_(0, g, torch.ones_like(g, dtype=torch.int32))
    n_parts = parts.shape[0]
    if psums_wide:
        psums = torch.zeros(n_parts, t_slots, dtype=torch.int64,
                            device=device)
        for l in range(n_parts):
            psums[l].index_add_(0, g, parts[l, idx].to(torch.int64))
    else:
        psums = torch.zeros(_psums_chunks(cap, chunk_slots), n_parts,
                            t_slots, dtype=torch.int32, device=device)
        chunk = (idx % cap) // chunk_slots
        flat = psums.view(-1)
        for l in range(n_parts):
            flat.index_add_(0, (chunk * n_parts + l) * t_slots + g,
                            parts[l, idx].to(torch.int32))
    csums = torch.zeros(sums.shape[0], t_slots, dtype=torch.float64,
                        device=device)
    for j in range(sums.shape[0]):
        csums[j].index_add_(0, g, sums[j, idx])
    tables = []
    for kind, lane, which, init in extremes:
        t = torch.full((t_slots,), init if kind == "ids" else
                       _ext_init(kind, which, 0),
                       dtype=torch.int32 if kind == "ids" else torch.float64,
                       device=device)
        t.scatter_reduce_(0, g, lane[idx], "amin" if which == "min"
                          else "amax")
        tables.append(t)
    return count, psums, csums, tables


def rank_slots(kc: torch.Tensor, cap: int, g_pad: int,
               route: Optional[str] = None):
    """K16: the ranked layout's dedup over K14's keys (int32 [n], g_pad
    where a slot is unused; n = S * cap, segment s owning slots [s * cap,
    (s + 1) * cap)): (gslot int32 [n], s * cap + the rank of the slot's
    key among its segment's distinct keys ascending, n for an unused
    slot; rkeys int32 [S, cap], the distinct keys ascending, then g_pad;
    n_distinct int32 [S]).

    `route`: "bitmap" (a presence bitmap of g_pad bits a segment, scanned)
    up to RANK_BITMAP_G_LIMIT keys, "sort" (K12 sorts each segment's keys,
    counted as radix_sort_rank, then the new keys are numbered) above it,
    where a bitmap of g_pad bits would outgrow the slots; None picks by
    g_pad. A launch counts once under rank_slots, and under
    rank_slots[sort] on the sort route."""
    n, device = kc.shape[0], kc.device
    _check_lane(kc, "keys", n, device, (torch.int32,))
    if cap < 1 or n % cap or not 1 <= g_pad <= INT32_MAX - 1:
        raise ValueError(f"{n} keys, cap {cap}, g_pad {g_pad}")
    route = route or ("bitmap" if g_pad <= RANK_BITMAP_G_LIMIT else "sort")
    if route not in ("bitmap", "sort"):
        raise ValueError(f"rank route {route}")
    if device.type == "cpu":
        return rank_slots_plain(kc, cap, g_pad)
    segs = n // cap
    gslot = torch.empty(n, dtype=torch.int32, device=device)
    rkeys = torch.empty(segs, cap, dtype=torch.int32, device=device)
    n_distinct = torch.empty(segs, dtype=torch.int32, device=device)
    bitmap = prefix = sk = perm = None
    if route == "bitmap":
        words = -(-g_pad // 32)
        bitmap = torch.zeros(segs * words, dtype=torch.int32, device=device)
        prefix = torch.empty(segs * words, dtype=torch.int32, device=device)
    else:
        lanes = [kc] if segs == 1 else [
            torch.arange(segs, dtype=torch.int32, device=device
                         ).repeat_interleave(cap), kc]
        perm, sorted_keys, _ = radix_sort(lanes, counter="radix_sort_rank")
        sk = sorted_keys[-1]
    _launch("rank_slots", device, kc.data_ptr(), n, int(cap), int(g_pad),
            *[None if t is None else t.data_ptr()
              for t in (bitmap, prefix, sk, perm)],
            gslot.data_ptr(), rkeys.data_ptr(), n_distinct.data_ptr())
    if sk is not None:
        _count_node("rank_slots", "sort")
    return gslot, rkeys, n_distinct


def rank_slots_plain(kc, cap: int, g_pad: int):
    """Plain PyTorch K16: torch.unique per segment."""
    n, device = kc.shape[0], kc.device
    segs = n // cap
    gslot = torch.full((n,), n, dtype=torch.int32, device=device)
    rkeys = torch.full((segs, cap), g_pad, dtype=torch.int32, device=device)
    n_distinct = torch.zeros(segs, dtype=torch.int32, device=device)
    for s in range(segs):
        k = kc[s * cap:(s + 1) * cap]
        valid = (k >= 0) & (k < g_pad)
        uniq, inverse = torch.unique(k[valid], return_inverse=True)
        gslot[s * cap:(s + 1) * cap][valid] = (s * cap + inverse).to(
            torch.int32)
        rkeys[s, :uniq.shape[0]] = uniq
        n_distinct[s] = uniq.shape[0]
    return gslot, rkeys, n_distinct


# ---------------------------------------------------------------------------
# K4 masked_histogram
# ---------------------------------------------------------------------------


def masked_histogram(mask: torch.Tensor, ids: torch.Tensor,
                     card_pad: int) -> torch.Tensor:
    """int32 [card_pad]: how many matched rows hold each dictId (ids
    outside [0, card_pad) count nowhere)."""
    padded, device = mask.shape[0], mask.device
    _check_mask(mask)
    _check_lane(ids, "id lane", padded, device, _ID_DTYPES)
    if not 1 <= card_pad <= INT32_MAX:
        raise ValueError(f"card_pad {card_pad}")
    if device.type == "cpu":
        return masked_histogram_plain(mask, ids, card_pad)
    out = torch.zeros(card_pad, dtype=torch.int32, device=device)
    _launch("masked_histogram", device, mask.data_ptr(), ids.data_ptr(),
            _ELEM[ids.dtype], padded, 1, int(card_pad), int(card_pad),
            out.data_ptr(), None)
    return out


def masked_histogram_plain(mask: torch.Tensor, ids: torch.Tensor,
                           card_pad: int) -> torch.Tensor:
    """Plain PyTorch K4: bincount over the matched ids."""
    v = ids.to(torch.int64)
    keep = mask.bool() & (v >= 0) & (v < card_pad)
    return torch.bincount(v[keep], minlength=card_pad).to(torch.int32)


def masked_entry_histogram(mask: torch.Tensor, mv: torch.Tensor,
                           card_pad: int, card: int
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K4 over an MV lane [P, W]: (int32 [card_pad] counts of the matched
    rows' entries by dictId, int32 scalar count of those entries);
    padding entries (id >= card) count nowhere."""
    padded, device = mask.shape[0], mask.device
    _check_mask(mask)
    _check_lane(mv, "MV id lane", padded, device, _ID_DTYPES, 2)
    if not 0 <= card < card_pad <= INT32_MAX:
        raise ValueError(f"card {card} / card_pad {card_pad}")
    if device.type == "cpu":
        return masked_entry_histogram_plain(mask, mv, card_pad, card)
    out = torch.zeros(card_pad, dtype=torch.int32, device=device)
    total = torch.zeros((), dtype=torch.int32, device=device)
    _launch("masked_histogram", device, mask.data_ptr(), mv.data_ptr(),
            _ELEM[mv.dtype], padded, mv.shape[1], int(card), int(card_pad),
            out.data_ptr(), total.data_ptr())
    return out, total


def masked_entry_histogram_plain(mask: torch.Tensor, mv: torch.Tensor,
                                 card_pad: int, card: int
                                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch K4 over MV entries: bincount of the valid entries of
    the matched rows."""
    v = mv.to(torch.int64)
    keep = mask.bool()[:, None] & (v >= 0) & (v < card)
    hist = torch.bincount(v[keep], minlength=card_pad).to(torch.int32)
    return hist, keep.sum(dtype=torch.int32)


def masked_histogram_batched(masks: torch.Tensor, ids: torch.Tensor,
                             card_pad: int) -> torch.Tensor:
    """K4 for B members, one launch: int32 [B, card_pad], member b's
    counts under masks[b]."""
    n, padded = _check_masks(masks)
    device = masks.device
    _check_lane(ids, "id lane", padded, device, _ID_DTYPES)
    if not 1 <= card_pad <= INT32_MAX:
        raise ValueError(f"card_pad {card_pad}")
    if device.type == "cpu":
        return masked_histogram_batched_plain(masks, ids, card_pad)
    out = torch.zeros(n, card_pad, dtype=torch.int32, device=device)
    _launch("masked_histogram_batched", device, masks.data_ptr(),
            ids.data_ptr(), _ELEM[ids.dtype], padded, 1, int(card_pad),
            int(card_pad), n, out.data_ptr(), None)
    return out


def masked_histogram_batched_plain(masks: torch.Tensor, ids: torch.Tensor,
                                   card_pad: int) -> torch.Tensor:
    """Plain PyTorch batched K4: each member's bincount, stacked."""
    return torch.stack([masked_histogram_plain(m, ids, card_pad)
                        for m in masks])


def masked_entry_histogram_batched(masks: torch.Tensor, mv: torch.Tensor,
                                   card_pad: int, card: int
                                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K4 over an MV lane for B members, one launch: (int32 [B, card_pad]
    entry counts, int32 [B] entries counted)."""
    n, padded = _check_masks(masks)
    device = masks.device
    _check_lane(mv, "MV id lane", padded, device, _ID_DTYPES, 2)
    if not 0 <= card < card_pad <= INT32_MAX:
        raise ValueError(f"card {card} / card_pad {card_pad}")
    if device.type == "cpu":
        return masked_entry_histogram_batched_plain(masks, mv, card_pad,
                                                    card)
    out = torch.zeros(n, card_pad, dtype=torch.int32, device=device)
    total = torch.zeros(n, dtype=torch.int32, device=device)
    _launch("masked_histogram_batched", device, masks.data_ptr(),
            mv.data_ptr(), _ELEM[mv.dtype], padded, mv.shape[1], int(card),
            int(card_pad), n, out.data_ptr(), total.data_ptr())
    return out, total


def masked_entry_histogram_batched_plain(masks: torch.Tensor,
                                         mv: torch.Tensor, card_pad: int,
                                         card: int
                                         ) -> Tuple[torch.Tensor,
                                                    torch.Tensor]:
    """Plain PyTorch batched K4 over MV entries, stacked per member."""
    outs = [masked_entry_histogram_plain(m, mv, card_pad, card)
            for m in masks]
    return torch.stack([o[0] for o in outs]), torch.stack([o[1]
                                                           for o in outs])


# ---------------------------------------------------------------------------
# K5 masked_reduce
# ---------------------------------------------------------------------------


def masked_reduce(mask: torch.Tensor, lane: torch.Tensor, kind: str,
                  card_pad: int = 0, want_sum: bool = False,
                  card: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """One pass over `lane` under the mask.

    kind "ids" (a dictId lane): {"min", "max"} int32 scalars with the JAX
    sentinels (card_pad / -1 when nothing matched); an MV id lane [P, W]
    takes `card`, and only its entries below it (not padding) count. kind
    "raw" (int32 / int64 / float32 / float64): {"min", "max"} scalars in
    the JAX dtype (float32 for a float32 lane, else float64; ±inf when
    nothing matched). Both: "count" int32 scalar, matched rows; with
    want_sum (single-value lanes), "sums" float64 [P / 8192], the masked
    sum of each row block."""
    padded, device = mask.shape[0], mask.device
    _check_mask(mask)
    is_mv = _check_reduce(lane, kind, card_pad, want_sum, card, padded,
                          device)
    if device.type == "cpu":
        return masked_reduce_plain(mask, lane, kind, card_pad, want_sum,
                                   card)
    out_dt = torch.int32 if kind == "ids" else \
        (torch.float32 if lane.dtype == torch.float32 else torch.float64)
    state = torch.zeros(5, dtype=torch.int64, device=device)
    out = {"min": torch.empty((), dtype=out_dt, device=device),
           "max": torch.empty((), dtype=out_dt, device=device),
           "count": torch.empty((), dtype=torch.int32, device=device)}
    if want_sum:
        out["sums"] = torch.empty(padded // BLOCK, dtype=torch.float64,
                                  device=device)
    _launch("masked_reduce", device, mask.data_ptr(), lane.data_ptr(),
            _ELEM[lane.dtype], lane.shape[1] if is_mv else 1,
            int(card) if is_mv else INT32_MAX, int(kind == "ids"),
            int(card_pad), int(want_sum), padded, state.data_ptr(),
            out["sums"].data_ptr() if want_sum else None,
            out["min"].data_ptr(), out["max"].data_ptr(),
            out["count"].data_ptr())
    return out


def _check_reduce(lane, kind, card_pad, want_sum, card, padded: int,
                  device) -> bool:
    """K5's operands checked; True for an MV lane."""
    if kind not in ("ids", "raw"):
        raise ValueError(f"masked_reduce kind {kind}")
    is_mv = lane.dim() == 2
    if is_mv and (kind != "ids" or want_sum or card is None or
                  not 0 <= card <= card_pad):
        raise ValueError("an MV lane takes kind 'ids' with its card and no "
                         "sums")
    _check_lane(lane, f"{kind} lane", padded, device,
                _ID_DTYPES if kind == "ids" else _RAW_DTYPES,
                2 if is_mv else 1)
    if padded % BLOCK:
        raise ValueError(f"{padded} rows is not a multiple of {BLOCK}")
    return is_mv


def masked_reduce_plain(mask: torch.Tensor, lane: torch.Tensor, kind: str,
                        card_pad: int = 0, want_sum: bool = False,
                        card: Optional[int] = None
                        ) -> Dict[str, torch.Tensor]:
    """Plain PyTorch K5: where + amin / amax, and a reshape-sum."""
    m = mask.bool()
    count = m.sum(dtype=torch.int32)
    if lane.dim() == 2:                  # MV ids: the valid entries
        m = m[:, None] & (lane < card)
    if kind == "ids":
        v = lane.to(torch.int32)
        lo_fill, hi_fill = card_pad, -1
    else:
        v = lane.to(torch.float32 if lane.dtype == torch.float32
                    else torch.float64)
        lo_fill, hi_fill = float("inf"), float("-inf")
    out = {"min": torch.where(m, v, lo_fill).amin(),
           "max": torch.where(m, v, hi_fill).amax(),
           "count": count}
    if want_sum:
        out["sums"] = torch.where(m, lane.to(torch.float64), 0.0) \
            .reshape(-1, BLOCK).sum(dim=1)
    return out


def masked_reduce_batched(masks: torch.Tensor, lane: torch.Tensor,
                          kind: str, card_pad: int = 0,
                          want_sum: bool = False,
                          card: Optional[int] = None
                          ) -> Dict[str, torch.Tensor]:
    """K5 for B members, one launch: masked_reduce's outputs with a
    leading member axis ("min", "max", "count" [B]; "sums" float64 [B, P
    / 8192]), each member's block sums in its own launch's order."""
    n, padded = _check_masks(masks)
    device = masks.device
    is_mv = _check_reduce(lane, kind, card_pad, want_sum, card, padded,
                          device)
    if device.type == "cpu":
        return masked_reduce_batched_plain(masks, lane, kind, card_pad,
                                           want_sum, card)
    out_dt = torch.int32 if kind == "ids" else \
        (torch.float32 if lane.dtype == torch.float32 else torch.float64)
    state = torch.zeros(n, 5, dtype=torch.int64, device=device)
    out = {"min": torch.empty(n, dtype=out_dt, device=device),
           "max": torch.empty(n, dtype=out_dt, device=device),
           "count": torch.empty(n, dtype=torch.int32, device=device)}
    if want_sum:
        out["sums"] = torch.empty(n, padded // BLOCK, dtype=torch.float64,
                                  device=device)
    _launch("masked_reduce_batched", device, masks.data_ptr(),
            lane.data_ptr(), _ELEM[lane.dtype], lane.shape[1] if is_mv else 1,
            int(card) if is_mv else INT32_MAX, int(kind == "ids"),
            int(card_pad), int(want_sum), padded, n, state.data_ptr(),
            out["sums"].data_ptr() if want_sum else None,
            out["min"].data_ptr(), out["max"].data_ptr(),
            out["count"].data_ptr())
    return out


def masked_reduce_batched_plain(masks: torch.Tensor, lane: torch.Tensor,
                                kind: str, card_pad: int = 0,
                                want_sum: bool = False,
                                card: Optional[int] = None
                                ) -> Dict[str, torch.Tensor]:
    """Plain PyTorch batched K5: each member's plain outputs, stacked."""
    outs = [masked_reduce_plain(m, lane, kind, card_pad, want_sum, card)
            for m in masks]
    return {k: torch.stack([o[k] for o in outs]) for k in outs[0]}


# ---------------------------------------------------------------------------
# K6 masked_select
# ---------------------------------------------------------------------------

MAX_SELECT_K = 1 << 16           # the JAX planner's MAX_SELECTION_K
_SELECT_KINDS = ("limit", "order", "ordertk", "ordermk")
#: key-term modes shared with masked_select.cu
_PACK, _ID, _MONO, _MONO_CLAMP = 0, 1, 2, 3
_MAX_SELECT_TERMS = 8
_MAX_SELECT_WORDS = 8
_MAX_GATHERS = 32


def monotone_keys_plain(lane: torch.Tensor, asc: bool) -> List[torch.Tensor]:
    """A numeric lane → 1-2 int32 lanes whose lexicographic order is the
    value order, bit for bit the JAX `_monotone_int32_keys`: ints as they
    are, int64 / float64 split into hi and a biased lo word, floats through
    their IEEE-754 bits with a negative value's magnitude bits flipped (so
    -0.0 orders before +0.0 and NaNs by bit pattern). Descending flips
    every bit of every word."""
    dt = lane.dtype
    if dt in _ID_DTYPES:
        keys = [lane.to(torch.int32)]
    elif dt == torch.float32:
        b = lane.view(torch.int32)
        keys = [b ^ ((b >> 31) & 0x7FFFFFFF)]
    elif dt in (torch.int64, torch.float64):
        b = lane.view(torch.int64)
        if dt == torch.float64:
            b = b ^ ((b >> 63) & 0x7FFFFFFFFFFFFFFF)
        keys = [(b >> 32).to(torch.int32),
                ((b & 0xFFFFFFFF) - 0x80000000).to(torch.int32)]
    else:
        raise ValueError(f"unsupported order-by lane dtype {dt}")
    return keys if asc else [~k for k in keys]


def select_key_words(select_spec, cols: Dict[str, torch.Tensor]
                     ) -> List[torch.Tensor]:
    """The int32 key lanes a selection orders by, most significant first,
    as the JAX `_selection_outputs` builds them; rows tie-break by docid."""
    kind, _k, order, _gather = select_spec
    if kind == "limit":
        return []
    if kind == "order":
        # dictIds packed mixed-radix into one int32; DESC as card_pad-1-id
        key = None
        for col, asc, card_pad, _source in order:
            ids = cols[f"{col}.ids"].to(torch.int32)
            term = ids if asc else (card_pad - 1) - ids
            key = term if key is None else key * card_pad + term
        return [key]
    if kind == "ordertk":
        (col, asc, _cp, _source), = order
        key = monotone_keys_plain(cols[f"{col}.raw"], asc)[0]
        # INT32_MAX is the JAX masked-row sentinel: valid keys stop below
        return [key.clamp_max(INT32_MAX - 1)]
    if kind == "ordermk":
        words = []
        for col, asc, _cp, source in order:
            if source == "sv":
                ids = cols[f"{col}.ids"].to(torch.int32)
                words.append(ids if asc else ~ids)
            else:
                words.extend(monotone_keys_plain(cols[f"{col}.raw"], asc))
        return words
    raise ValueError(f"select kind {kind} is not a K6 masked_select kind")


_GATHER_LANES = {"sv": "ids", "raw": "raw", "mv": "mv"}


def gather_lane_key(col: str, source: str) -> str:
    """The lane key ({col}.ids / .raw / .mv) a select spec gathers."""
    return f"{col}.{_GATHER_LANES[source]}"


def selection_outputs_plain(select_spec, cols: Dict[str, torch.Tensor],
                            mask: torch.Tensor, n_segs: Optional[int] = None
                            ) -> Dict[str, torch.Tensor]:
    """Plain PyTorch K6: the matched docids sorted by their key words with
    stable sorts from the least significant word (docid order breaks the
    last ties, as `lax.top_k` and the iota key of `lax.sort` do), the
    first k kept, -1 after them; the match count; each gathered column at
    max(docid, 0). With n_segs: the same per segment of the flat lanes,
    stacked on a leading segment axis."""
    if n_segs is not None:
        per = mask.shape[0] // n_segs
        outs = [selection_outputs_plain(
            select_spec, {n: t[s * per:(s + 1) * per] for n, t in
                          cols.items() if t.shape[0] == mask.shape[0]},
            mask[s * per:(s + 1) * per])
            for s in range(n_segs)]
        return {n: torch.stack([o[n] for o in outs]) for n in outs[0]}
    _kind, k, _order, gather_cols = select_spec
    m = mask.bool()
    idx = torch.nonzero(m).reshape(-1)
    for word in reversed(select_key_words(select_spec, cols)):
        idx = idx[torch.sort(word[idx], stable=True).indices]
    docids = torch.full((k,), -1, dtype=torch.int32, device=mask.device)
    top = idx[:k]
    docids[:top.shape[0]] = top.to(torch.int32)
    out = {"sel.docids": docids, "sel.count": m.sum(dtype=torch.int32)}
    safe = docids.clamp_min(0).long()
    for col, source in gather_cols:
        out[f"sel.{col}"] = cols[gather_lane_key(col, source)][safe]
    return out


def _select_terms(select_spec, cols) -> List[Tuple[torch.Tensor, int, int,
                                                   bool, int]]:
    """K6's key terms: (lane, mode, card_pad, asc, key words it adds)."""
    kind, _k, order, _gather = select_spec
    if kind not in _SELECT_KINDS:
        raise ValueError(f"select kind {kind} is not a K6 masked_select "
                         "kind")
    terms = []
    for col, asc, card_pad, source in order:
        if source == "sv" and kind in ("order", "ordermk"):
            # "order" packs every term into one word
            terms.append((cols[f"{col}.ids"],
                          _PACK if kind == "order" else _ID,
                          int(card_pad), bool(asc),
                          int(kind == "ordermk" or not terms)))
        elif source == "raw" and kind in ("ordertk", "ordermk"):
            lane = cols[f"{col}.raw"]
            if kind == "ordertk" and lane.element_size() != 4:
                raise ValueError("ordertk takes one int32 / float32 lane")
            terms.append((lane, _MONO_CLAMP if kind == "ordertk" else _MONO,
                          0, bool(asc), lane.element_size() // 4))
        else:
            raise ValueError(f"order term ({col}, {source}) of a {kind} "
                             "selection")
    if kind == "ordertk" and len(terms) != 1:
        raise ValueError("ordertk orders by exactly one raw lane")
    return terms


def select_scratch_words(padded: int, k: int, n_words: int,
                         n_segs: int = 1) -> int:
    """int32 words of scratch K6 needs for n_segs segments of `padded`
    rows, as masked_select.cu decides them (its tile size and merge
    passes live there only)."""
    return _scratch_words("masked_select.cu",
                          "pinot_masked_select_scratch_words",
                          [_LL, _I, _I, _I], padded, k, n_words, n_segs)


def masked_select(select_spec, cols: Dict[str, torch.Tensor],
                  mask: torch.Tensor, n_segs: Optional[int] = None,
                  vector_params: Optional[Sequence] = None
                  ) -> Dict[str, torch.Tensor]:
    """One segment's selection: {"sel.docids" int32 [k] (-1 after the
    valid rows), "sel.count" int32 scalar, "sel.<col>" [k] or [k, W] in
    the lane's dtype}, as the JAX `_selection_outputs` returns them; the
    "vector" kind adds "sel.scores" f32 [k] (0 after the valid rows) and
    takes `vector_params` = (query f32 [dim_pad], its tree norm).

    With n_segs: the mask and lanes hold that many segments of equal
    length back to back (flat views of [S, P] stacks), and each output
    gains a leading segment axis: every segment's own top k, docids
    counted from its first row, as the vmapped JAX function gives them."""
    if select_spec[0] == "vector":
        return _vector_select(select_spec, cols, mask, n_segs,
                              vector_params)
    return _masked_select(select_spec, cols, mask, n_segs)


def _vector_select(select_spec, cols, mask, n_segs, vector_params):
    """The "vector" kind: K8 scores the rows, then K6 takes their top k
    (vector_topk)."""
    _kind, k, order, gather_cols = select_spec
    if vector_params is None or len(vector_params) != 2:
        raise ValueError("a vector selection takes its query vector and "
                         "norm (vector_params)")
    (col, metric, _dim_pad), = order
    q, q_norm = vector_params
    scores = vector_scores(cols[f"{col}.vec"], q, q_norm, metric)
    return vector_topk(scores, mask, k, cols, gather_cols, n_segs)


def _score_spec(k: int, gather_cols) -> tuple:
    """K6's "ordertk" over the score lane, descending: the JAX key
    (monotone int32 of the score, clamped to >= -INT32_MAX) reversed, ties
    to the lower docid; the scores ride as the last gathered column."""
    return ("ordertk", k, (("$score", False, 0, "raw"),),
            tuple(gather_cols) + (("$score", "raw"),))


def vector_topk(scores: torch.Tensor, mask: torch.Tensor, k: int,
                cols: Optional[Dict[str, torch.Tensor]] = None,
                gather_cols=(), n_segs: Optional[int] = None
                ) -> Dict[str, torch.Tensor]:
    """K6's "vector" kind over f32 scores [rows] (K8's): the top k
    matched rows by score descending, then docid, per segment with
    n_segs; "sel.scores" holds their scores, 0 after the valid rows, and
    "sel.<col>" each gathered column."""
    cols = dict(cols or {}, **{"$score.raw": scores})
    out = _masked_select(_score_spec(k, gather_cols), cols, mask, n_segs,
                         zero_invalid=("$score",),
                         counter="masked_select_vector")
    out["sel.scores"] = out.pop("sel.$score")
    return out


def vector_topk_plain(scores: torch.Tensor, mask: torch.Tensor, k: int,
                      cols: Optional[Dict[str, torch.Tensor]] = None,
                      gather_cols=(), n_segs: Optional[int] = None
                      ) -> Dict[str, torch.Tensor]:
    """Plain PyTorch of K6's vector kind (selection_outputs_plain over
    the score key, scores zeroed after the valid rows)."""
    cols = dict(cols or {}, **{"$score.raw": scores})
    out = selection_outputs_plain(_score_spec(k, gather_cols), cols, mask,
                                  n_segs)
    out["sel.scores"] = torch.where(out["sel.docids"] >= 0,
                                    out.pop("sel.$score"), 0)
    return out


def _masked_select(select_spec, cols, mask, n_segs=None,
                   zero_invalid: Sequence[str] = (),
                   counter: str = "masked_select",
                   member_keys: Optional[Sequence[str]] = None
                   ) -> Dict[str, torch.Tensor]:
    """K6 for kinds limit / order / ordertk / ordermk; the gathered
    columns named in `zero_invalid` hold zeros after the valid rows, and
    the launch counts under `counter`.

    With `member_keys` (a batch of B members of one plan, one launch
    counted under counter + "_batched"): `mask` is uint8 [B, P], one row
    per member; the lanes named in member_keys are the members' own,
    flat [B * P] (K8's scores), the others the segment's [P], shared;
    every output gains a leading member axis."""
    _kind, k, _order, gather_cols = select_spec
    device = mask.device
    batched = member_keys is not None
    if batched:
        segs, padded = _check_masks(mask)
        own = {id(cols[key]) for key in member_keys}
    else:
        segs = 1 if n_segs is None else n_segs
        if segs < 1 or mask.shape[0] % segs:
            raise ValueError(f"{mask.shape[0]} rows do not split into "
                             f"{segs} segments")
        padded = mask.shape[0] // segs
        own = set()
        _check_mask(mask)

    def rows_of(lane) -> int:
        return segs * padded if not batched or id(lane) in own else padded

    terms = _select_terms(select_spec, cols)
    for lane, mode, *_ in terms:
        _check_lane(lane, "order lane", rows_of(lane), device,
                    _ID_DTYPES if mode in (_PACK, _ID) else _RAW_DTYPES)
    gathers = []
    for col, source in gather_cols:
        lane = cols[gather_lane_key(col, source)]
        _check_lane(lane, f"gather lane {col}", rows_of(lane), device,
                    _RAW_DTYPES if source == "raw" else _ID_DTYPES,
                    2 if source == "mv" else 1)
        gathers.append(lane)
    n_words = sum(t[4] for t in terms)
    if not 1 <= k <= min(MAX_SELECT_K, padded):
        raise ValueError(f"select k {k} outside [1, min({MAX_SELECT_K}, "
                         f"{padded})]")
    if len(terms) > _MAX_SELECT_TERMS or n_words > _MAX_SELECT_WORDS or \
            len(gathers) > _MAX_GATHERS:
        raise ValueError(f"{len(terms)} order terms / {n_words} key words "
                         f"/ {len(gathers)} gathers over the kernel's "
                         "limits")
    if device.type == "cpu":
        out = selection_outputs_batched_plain(
            select_spec, cols, mask, member_keys) if batched else \
            selection_outputs_plain(select_spec, cols, mask, n_segs)
        for col in zero_invalid:
            out[f"sel.{col}"] = torch.where(out["sel.docids"] >= 0,
                                            out[f"sel.{col}"], 0)
        return out
    lead = (segs,) if batched or n_segs is not None else ()
    scratch_words = select_scratch_words(padded, k, n_words, segs)
    scratch = torch.empty(scratch_words, dtype=torch.int32, device=device)
    docids = torch.empty(lead + (k,), dtype=torch.int32, device=device)
    count = torch.zeros(lead, dtype=torch.int32, device=device)
    outs = [torch.empty(lead + (k,) + tuple(g.shape[1:]), dtype=g.dtype,
                        device=device) for g in gathers]
    zero_bits = sum(1 << g for g, (col, _src) in enumerate(gather_cols)
                    if col in zero_invalid)
    term_lanes = [t[0] for t in terms]
    term_args = (_ints([_ELEM[t.dtype] for t in term_lanes]),
                 _ints([t[1] for t in terms]), _ints([t[2] for t in terms]),
                 _ints([int(t[3]) for t in terms]), len(terms), n_words)
    tail = (_ints([g.element_size() * (g.shape[1] if g.dim() == 2 else 1)
                   for g in gathers]),
            _ptrs(outs), len(gathers), ctypes.c_int32(zero_bits).value,
            scratch.data_ptr(), scratch_words, docids.data_ptr(),
            count.data_ptr())
    if batched:
        def strides(lanes):          # rows between members: own P, shared 0
            return _longs([padded if id(t) in own else 0 for t in lanes])
        _launch(f"{counter}_batched", device, mask.data_ptr(), padded, segs,
                int(k), _ptrs(term_lanes), strides(term_lanes), *term_args,
                _ptrs(gathers), strides(gathers), *tail)
    else:
        _launch(counter, device, mask.data_ptr(), padded, segs, int(k),
                _ptrs(term_lanes), *term_args, _ptrs(gathers), *tail)
    res = {"sel.docids": docids, "sel.count": count}
    for (col, _source), o in zip(gather_cols, outs):
        res[f"sel.{col}"] = o
    return res


def selection_outputs_batched_plain(select_spec, cols: Dict[str,
                                                            torch.Tensor],
                                    masks: torch.Tensor,
                                    member_keys: Sequence[str] = ()
                                    ) -> Dict[str, torch.Tensor]:
    """Plain PyTorch batched K6: each member's plain selection under its
    mask row (its own rows of the member_keys lanes, flat [B * P]),
    stacked."""
    n, padded = masks.shape
    outs = []
    for b in range(n):
        mcols = {key: t[b * padded:(b + 1) * padded] if key in member_keys
                 else t for key, t in cols.items()}
        outs.append(selection_outputs_plain(select_spec, mcols, masks[b]))
    return {name: torch.stack([o[name] for o in outs]) for name in outs[0]}


def masked_select_batched(select_spec, cols: Dict[str, torch.Tensor],
                          masks: torch.Tensor,
                          vector_params_list: Optional[Sequence] = None
                          ) -> Dict[str, torch.Tensor]:
    """K6 for B members of one plan, one launch: masked_select's outputs
    with a leading member axis, member b's under masks[b]; the "vector"
    kind takes each member's (query, norm) in vector_params_list and runs
    the batched K8 first."""
    if select_spec[0] != "vector":
        return _masked_select(select_spec, cols, masks, member_keys=())
    _kind, k, order, gather_cols = select_spec
    if vector_params_list is None or \
            len(vector_params_list) != masks.shape[0] or \
            any(p is None or len(p) != 2 for p in vector_params_list):
        raise ValueError("a vector selection takes each member's query "
                         "vector and norm (vector_params_list)")
    (col, metric, _dim_pad), = order
    scores = vector_scores_batched(cols[f"{col}.vec"],
                                   [p[0] for p in vector_params_list],
                                   [p[1] for p in vector_params_list],
                                   metric)
    return vector_topk_batched(scores, masks, k, cols, gather_cols)


def vector_topk_batched(scores: torch.Tensor, masks: torch.Tensor, k: int,
                        cols: Optional[Dict[str, torch.Tensor]] = None,
                        gather_cols=()) -> Dict[str, torch.Tensor]:
    """K6's "vector" kind for B members, one launch: member b's top k by
    scores[b] (f32 [B, P], the batched K8's) under masks[b]."""
    cols = dict(cols or {}, **{"$score.raw": scores.reshape(-1)})
    out = _masked_select(_score_spec(k, gather_cols), cols, masks,
                         zero_invalid=("$score",),
                         counter="masked_select_vector",
                         member_keys=("$score.raw",))
    out["sel.scores"] = out.pop("sel.$score")
    return out


def vector_topk_batched_plain(scores: torch.Tensor, masks: torch.Tensor,
                              k: int,
                              cols: Optional[Dict[str, torch.Tensor]] = None,
                              gather_cols=()) -> Dict[str, torch.Tensor]:
    """Plain PyTorch batched K6 vector kind: each member's plain top k,
    stacked."""
    outs = [vector_topk_plain(scores[b], masks[b], k, cols, gather_cols)
            for b in range(masks.shape[0])]
    return {name: torch.stack([o[name] for o in outs]) for name in outs[0]}


# ---------------------------------------------------------------------------
# K8 vector_scores, K9 ivf_probe_select
# ---------------------------------------------------------------------------

MAX_VEC_DIM = 4096               # common/schema.py:MAX_VECTOR_DIMENSION
MAX_CENTROIDS = 8192             # K9: a cluster of 8 CTAs, 1,024 a CTA
_METRICS = ("cosine", "dot")


def vec_tree_sum_plain(x):
    """The balanced pairwise f32 sum over the last (power-of-two) axis,
    x[2i] + x[2i+1] level by level: pinot_tpu/ops/kernels.py:vec_tree_sum,
    the vector subsystem's bit-exactness contract. Slicing and adds only,
    so it takes a torch tensor or a numpy array (the planner's query
    norm, the IVF numpy twins and the oracle pass float32 arrays)."""
    while x.shape[-1] > 1:
        x = x[..., 0::2] + x[..., 1::2]
    return x[..., 0]


def _host_query(q, dim_pad: int) -> torch.Tensor:
    """A query vector as f32 [dim_pad] where it lies (numpy and sequences
    on the host)."""
    qt = q if isinstance(q, torch.Tensor) else \
        torch.from_numpy(np.ascontiguousarray(q, dtype=np.float32))
    if qt.dtype != torch.float32 or qt.shape != (dim_pad,):
        raise ValueError(f"query vector must be float32 [{dim_pad}], got "
                         f"{qt.dtype} {tuple(qt.shape)}")
    return qt


def _upload(t: torch.Tensor, device) -> torch.Tensor:
    """`t` on `device`, contiguous, without a host wait for the card: a
    tensor there passes through; a host tensor goes up with
    non_blocking=True, which the CUDA runtime stages from pageable memory
    at once without waiting for the stream (a blocking copy ends in a
    stream synchronise). Staging a query costs 8-15 µs of host time
    where pinning it first costs 35-50 µs (tools/vector_kernel_bench.py,
    `query_upload`), and a query uploads 3-4 times a segment."""
    device = torch.device(device)
    if t.device == device:
        return t.contiguous()
    if t.device.type == "cpu" and device.type == "cuda":
        return t.contiguous().to(device, non_blocking=True)
    return t.to(device).contiguous()


def _query(q, dim_pad: int, device) -> torch.Tensor:
    """The zero-padded query f32 [dim_pad] on `device`, uploaded without a
    host wait (_upload)."""
    return _upload(_host_query(q, dim_pad), device)


def _check_vec(mat: torch.Tensor, what: str, ndims: Tuple[int, ...]) -> int:
    if mat.dtype != torch.float32 or mat.dim() not in ndims or \
            not mat.is_contiguous():
        raise ValueError(f"{what} must be a contiguous float32 tensor of "
                         f"{ndims} dims, got {mat.dtype} "
                         f"{tuple(mat.shape)}")
    dim_pad = mat.shape[-1]
    if dim_pad < 1 or dim_pad & (dim_pad - 1) or dim_pad > MAX_VEC_DIM:
        raise ValueError(f"{what}: width {dim_pad} is not a power of two "
                         f"<= {MAX_VEC_DIM}")
    if mat.device.type == "cuda" and mat.data_ptr() % 16:
        raise ValueError(f"{what} is not 16-byte aligned")
    return dim_pad


def vector_scores(mat: torch.Tensor, q, q_norm, metric: str
                  ) -> torch.Tensor:
    """K8: f32 [rows] similarity of each row of `mat` (f32 [rows,
    dim_pad], zero-padded) to the zero-padded query `q` (f32 [dim_pad]),
    as pinot_tpu/ops/kernels.py:_vector_scores computes it, bit for bit:
    "dot" = tree(mat * q); "cosine" = dot / (sqrt(tree(mat * mat)) *
    q_norm), -inf where that denominator is not > 0. `q` may lie on the
    card or be a host array: it goes up without a host wait (_upload)."""
    dim_pad = _check_vec(mat, "vector lane", (2,))
    if metric not in _METRICS:
        raise ValueError(f"metric {metric}")
    device = mat.device
    qt = _query(q, dim_pad, device)
    if device.type == "cpu":
        return vector_scores_plain(mat, qt, q_norm, metric)
    out = torch.empty(mat.shape[0], dtype=torch.float32, device=device)
    _launch("vector_scores", device, mat.data_ptr(), mat.shape[0], dim_pad,
            qt.data_ptr(), float(np.float32(q_norm)),
            int(metric == "cosine"), out.data_ptr())
    return out


def vector_scores_plain(mat: torch.Tensor, q, q_norm, metric: str
                        ) -> torch.Tensor:
    """Plain PyTorch K8: the products, the tree, the cosine quotient, each
    rounded once as the kernel rounds them."""
    qt = _query(q, mat.shape[-1], mat.device)
    dot = vec_tree_sum_plain(mat * qt)
    if metric != "cosine":
        return dot
    qn = torch.tensor(np.float32(q_norm), device=mat.device)
    # the correctly rounded f32 root (XLA's and numpy's): torch's f32
    # sqrt on the CPU is not, its float64 one rounded once to f32 is
    norm = torch.sqrt(vec_tree_sum_plain(mat * mat).double()).float()
    denom = norm * qn
    return torch.where(denom > 0, dot / denom,
                       torch.tensor(float("-inf"), device=mat.device))


def score_keys_plain(scores: torch.Tensor) -> torch.Tensor:
    """The monotone int32 key of f32 scores clamped to >= -INT32_MAX (the
    JAX `_monotone_int32_keys` with INT32_MIN kept for masked rows)."""
    return monotone_keys_plain(scores, True)[0].clamp_min(-INT32_MAX)


def ivf_select_probes(centroids: torch.Tensor, cvalid: torch.Tensor, q,
                      q_norm, metric: str, nprobe: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K9: (probe ids int32 [..., nprobe], ok bool [..., nprobe]) of one
    codebook (centroids f32 [C_pad, dim_pad], cvalid bool [C_pad]) or of a
    stack of them ([S, C_pad, dim_pad], [S, C_pad]): the nprobe live
    centroids of highest score, ties to the lower id, ok[i] = i < the
    live count (pinot_tpu/ops/kernels.py:ivf_select_probes). One launch:
    a thread-block cluster per codebook (up to 8 CTAs of 1,024
    centroids), each CTA sorting its tile's (key, ~id) words and ranking
    its best against the other tiles' through distributed shared memory;
    `q` goes up without a host wait."""
    dim_pad = _check_vec(centroids, "codebook lane", (2, 3))
    c_pad, device = centroids.shape[-2], centroids.device
    if cvalid.device != device or cvalid.dtype != torch.bool or \
            cvalid.shape != centroids.shape[:-1] or \
            not cvalid.is_contiguous():
        raise ValueError(f"cvalid must be a contiguous bool "
                         f"{tuple(centroids.shape[:-1])} on {device}")
    if metric not in _METRICS or not 1 <= nprobe <= c_pad or \
            c_pad > MAX_CENTROIDS:
        raise ValueError(f"metric {metric}, nprobe {nprobe}, C_pad {c_pad} "
                         f"(nprobe <= C_pad <= {MAX_CENTROIDS})")
    qt = _query(q, dim_pad, device)
    if device.type == "cpu":
        return ivf_select_probes_plain(centroids, cvalid, qt, q_norm,
                                       metric, nprobe)
    lead = tuple(centroids.shape[:-2])
    ids = torch.empty(lead + (nprobe,), dtype=torch.int32, device=device)
    ok = torch.empty(lead + (nprobe,), dtype=torch.bool, device=device)
    _launch("ivf_probe_select", device, centroids.data_ptr(),
            cvalid.data_ptr(), int(np.prod(lead, dtype=np.int64)), c_pad,
            dim_pad, qt.data_ptr(), float(np.float32(q_norm)),
            int(metric == "cosine"), int(nprobe), ids.data_ptr(),
            ok.data_ptr())
    return ids, ok


def ivf_select_probes_plain(centroids: torch.Tensor, cvalid: torch.Tensor,
                            q, q_norm, metric: str, nprobe: int
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch K9: K8's scores of the centroids, their keys, a
    stable sort by key descending (ties keep the lower id): the order of
    the kernel's (key, ~id) words."""
    dim_pad = centroids.shape[-1]
    score = vector_scores_plain(centroids.reshape(-1, dim_pad), q, q_norm,
                                metric).reshape(centroids.shape[:-1])
    key = torch.where(cvalid, score_keys_plain(score), -INT32_MAX - 1)
    order = torch.sort(-key.to(torch.int64), dim=-1, stable=True).indices
    ids = order[..., :nprobe].to(torch.int32)
    live = cvalid.sum(dim=-1, keepdim=True, dtype=torch.int32)
    ok = torch.arange(nprobe, dtype=torch.int32,
                      device=centroids.device) < live
    return ids.contiguous(), ok.contiguous()


def _queries(qs, q_norms, dim_pad: int, device
             ) -> Tuple[torch.Tensor, List[float]]:
    """B <= MAX_BATCH zero-padded queries as f32 [B, dim_pad] on `device`,
    and their norms as float32 values, without a host wait: host queries
    go up as one [B, dim_pad] copy."""
    n = len(qs)
    if not 1 <= n <= MAX_BATCH or len(q_norms) != n:
        raise ValueError(f"{n} queries / {len(q_norms)} norms, expected "
                         f"1..{MAX_BATCH} of each")
    host = [_host_query(x, dim_pad) for x in qs]
    if all(t.device.type == "cpu" for t in host):
        # stacked on the host, one [B, dim_pad] copy up
        q = _upload(torch.stack(host), device)
    else:
        q = torch.stack([_upload(t, device) for t in host])
    return q, [float(np.float32(v)) for v in q_norms]


def vector_scores_batched(mat: torch.Tensor, qs, q_norms, metric: str
                          ) -> torch.Tensor:
    """K8 for B <= MAX_BATCH queries, one launch: f32 [B, rows], row b
    bit for bit vector_scores(mat, qs[b], q_norms[b], metric). Each row
    of `mat` is read once for every query, and under cosine its norm tree
    runs once; one reduce-scatter butterfly over the (row, member) sums
    takes the place of a butterfly per sum. Host queries go up as one
    [B, dim_pad] copy without a host wait."""
    dim_pad = _check_vec(mat, "vector lane", (2,))
    if metric not in _METRICS:
        raise ValueError(f"metric {metric}")
    device = mat.device
    q, norms = _queries(qs, q_norms, dim_pad, device)
    if device.type == "cpu":
        return vector_scores_batched_plain(mat, q, norms, metric)
    out = torch.empty(q.shape[0], mat.shape[0], dtype=torch.float32,
                      device=device)
    _launch("vector_scores_batched", device, mat.data_ptr(), mat.shape[0],
            dim_pad, q.data_ptr(), (_F * len(norms))(*norms), len(norms),
            int(metric == "cosine"), out.data_ptr())
    return out


def vector_scores_batched_plain(mat: torch.Tensor, qs, q_norms,
                                metric: str) -> torch.Tensor:
    """Plain PyTorch batched K8: each query's plain scores, stacked (the
    reduce-scatter adds the tree's own pairs, so the kernel's bits are
    these)."""
    return torch.stack([vector_scores_plain(mat, q, qn, metric)
                        for q, qn in zip(qs, q_norms)])


def ivf_select_probes_batched(centroids: torch.Tensor, cvalid: torch.Tensor,
                              qs, q_norms, metric: str, nprobe: int
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K9 for B <= MAX_BATCH queries over one codebook (centroids f32
    [C_pad, dim_pad], cvalid bool [C_pad]), one launch: (ids int32 [B,
    nprobe], ok bool [B, nprobe]), row b ivf_select_probes(..., qs[b],
    q_norms[b], ...): a cluster per member."""
    dim_pad = _check_vec(centroids, "codebook lane", (2,))
    c_pad, device = centroids.shape[0], centroids.device
    if cvalid.device != device or cvalid.dtype != torch.bool or \
            cvalid.shape != (c_pad,) or not cvalid.is_contiguous():
        raise ValueError(f"cvalid must be a contiguous bool [{c_pad}] on "
                         f"{device}")
    if metric not in _METRICS or not 1 <= nprobe <= c_pad or \
            c_pad > MAX_CENTROIDS:
        raise ValueError(f"metric {metric}, nprobe {nprobe}, C_pad {c_pad} "
                         f"(nprobe <= C_pad <= {MAX_CENTROIDS})")
    q, norms = _queries(qs, q_norms, dim_pad, device)
    if device.type == "cpu":
        return ivf_select_probes_batched_plain(centroids, cvalid, q, norms,
                                               metric, nprobe)
    n = q.shape[0]
    ids = torch.empty(n, nprobe, dtype=torch.int32, device=device)
    ok = torch.empty(n, nprobe, dtype=torch.bool, device=device)
    _launch("ivf_probe_select_batched", device, centroids.data_ptr(),
            cvalid.data_ptr(), 1, c_pad, dim_pad, q.data_ptr(),
            (_F * n)(*norms), n, int(metric == "cosine"), int(nprobe),
            ids.data_ptr(), ok.data_ptr())
    return ids, ok


def ivf_select_probes_batched_plain(centroids: torch.Tensor,
                                    cvalid: torch.Tensor, qs, q_norms,
                                    metric: str, nprobe: int
                                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch batched K9: each query's plain probe list, stacked."""
    outs = [ivf_select_probes_plain(centroids, cvalid, q, qn, metric,
                                    nprobe) for q, qn in zip(qs, q_norms)]
    return torch.stack([o[0] for o in outs]), torch.stack([o[1]
                                                           for o in outs])


# ---------------------------------------------------------------------------
# K7 hll_registers
# ---------------------------------------------------------------------------

MAX_HLL_REGISTERS = 8192         # hll_registers.cu keeps them in 32 KB


def hll_registers(hist: torch.Tensor, idx: torch.Tensor, rank: torch.Tensor,
                  m: int) -> torch.Tensor:
    """int32 [m] HyperLogLog registers: reg[idx[d]] = max rank[d] over the
    dictIds d with hist[d] > 0 (0 where none), as the JAX `_agg_outputs`
    "hll" branch scatter-maxes them."""
    device = hist.device
    card_pad = hist.shape[0]
    for name, t in (("hist", hist), ("hll index table", idx),
                    ("hll rank table", rank)):
        _check_lane(t, name, card_pad, device, (torch.int32,))
    if not 1 <= m <= MAX_HLL_REGISTERS:
        raise ValueError(f"{m} registers outside [1, {MAX_HLL_REGISTERS}]")
    if device.type == "cpu":
        return hll_registers_plain(hist, idx, rank, m)
    out = torch.zeros(m, dtype=torch.int32, device=device)
    _launch("hll_registers", device, hist.data_ptr(), idx.data_ptr(),
            rank.data_ptr(), card_pad, int(m), out.data_ptr())
    return out


def hll_registers_plain(hist: torch.Tensor, idx: torch.Tensor,
                        rank: torch.Tensor, m: int) -> torch.Tensor:
    """Plain PyTorch K7: scatter_reduce_ amax of the present ranks."""
    vals = torch.where(hist > 0, rank, 0)
    keep = (idx >= 0) & (idx < m)
    out = torch.zeros(m, dtype=torch.int32, device=hist.device)
    return out.scatter_reduce_(0, idx[keep].long(), vals[keep], "amax")


def hll_registers_batched(hists: torch.Tensor, idx: torch.Tensor,
                          rank: torch.Tensor, m: int) -> torch.Tensor:
    """K7 for B members, one launch: int32 [B, m], member b's registers
    from its histogram row hists[b] (int32 [B, card_pad], K4's)."""
    device = hists.device
    if hists.dim() != 2 or not 1 <= hists.shape[0] <= MAX_BATCH:
        raise ValueError(f"histograms have shape {tuple(hists.shape)}, "
                         f"expected [B <= {MAX_BATCH}, card_pad]")
    n, card_pad = hists.shape
    for name, t in (("hist", hists[0]), ("hll index table", idx),
                    ("hll rank table", rank)):
        _check_lane(t, name, card_pad, device, (torch.int32,))
    if not hists.is_contiguous():
        raise ValueError("histograms are not contiguous")
    if not 1 <= m <= MAX_HLL_REGISTERS:
        raise ValueError(f"{m} registers outside [1, {MAX_HLL_REGISTERS}]")
    if device.type == "cpu":
        return hll_registers_batched_plain(hists, idx, rank, m)
    out = torch.zeros(n, m, dtype=torch.int32, device=device)
    _launch("hll_registers_batched", device, hists.data_ptr(),
            idx.data_ptr(), rank.data_ptr(), card_pad, int(m), n,
            out.data_ptr())
    return out


def hll_registers_batched_plain(hists: torch.Tensor, idx: torch.Tensor,
                                rank: torch.Tensor, m: int) -> torch.Tensor:
    """Plain PyTorch batched K7: each member's registers, stacked."""
    return torch.stack([hll_registers_plain(h, idx, rank, m)
                        for h in hists])


# ---------------------------------------------------------------------------
# K12 radix_sort, K13 window_scan
# ---------------------------------------------------------------------------

MAX_SORT_KEYS = 8                # sort_window.cu: key lanes, payload lanes
MAX_SORT_PAYLOADS = 8


def _check_sort_lanes(keys, payloads, n: int, device) -> None:
    if not 1 <= len(keys) <= MAX_SORT_KEYS or \
            len(payloads) > MAX_SORT_PAYLOADS:
        raise ValueError(f"{len(keys)} key / {len(payloads)} payload lanes "
                         f"(1..{MAX_SORT_KEYS} / ..{MAX_SORT_PAYLOADS})")
    if not 1 <= n <= 1 << 30:
        raise ValueError(f"{n} rows outside [1, 2^30]")
    for i, k in enumerate(keys):
        _check_lane(k, f"sort key {i}", n, device, (torch.int32, torch.int64))
    for j, v in enumerate(payloads):
        _check_lane(v, f"sort payload {j}", n, device, (torch.int32,))


def radix_sort(keys: Sequence[torch.Tensor],
               payloads: Sequence[torch.Tensor] = (),
               valid_rows: Optional[int] = None,
               counter: str = "radix_sort"
               ) -> Tuple[torch.Tensor, List[torch.Tensor],
                          List[torch.Tensor]]:
    """K12: a stable sort of n rows by int32 / int64 key lanes (most
    significant first, signed order), rows at or past `valid_rows` after
    every other row, ties in input order: (perm int32 [n], the input row
    of each sorted position; the keys sorted; the int32 payload lanes
    carried). The launch counts under `counter` ("radix_sort_join" for a
    join's dim side)."""
    keys, payloads = list(keys), list(payloads)
    if not keys:
        raise ValueError("radix_sort needs a key lane")
    n, device = keys[0].shape[0], keys[0].device
    _check_sort_lanes(keys, payloads, n, device)
    valid = n if valid_rows is None else max(0, min(int(valid_rows), n))
    if device.type == "cpu":
        return radix_sort_plain(keys, payloads, valid)
    perm = torch.empty(n, dtype=torch.int32, device=device)
    key_outs = [torch.empty_like(k) for k in keys]
    pay_outs = [torch.empty_like(v) for v in payloads]
    words = _scratch_words("sort_window.cu", "pinot_radix_sort_scratch_words",
                           [_LL, _I], n, len(keys))
    # int64 elements: the scratch's first words hold 64-bit OR / AND masks
    scratch = torch.empty((words + 1) // 2, dtype=torch.int64, device=device)
    _launch(counter, device, _ptrs(keys), _ints([_ELEM[k.dtype] for k in keys]),
            len(keys), _ptrs(payloads), len(payloads), n, valid,
            _ptrs(key_outs), _ptrs(pay_outs), perm.data_ptr(),
            scratch.data_ptr())
    return perm, key_outs, pay_outs


def radix_sort_plain(keys: Sequence[torch.Tensor],
                     payloads: Sequence[torch.Tensor] = (),
                     valid_rows: Optional[int] = None
                     ) -> Tuple[torch.Tensor, List[torch.Tensor],
                                List[torch.Tensor]]:
    """Plain PyTorch K12: chained stable torch.sort from the least
    significant key, then by the at-or-past-valid_rows flag."""
    n = keys[0].shape[0]
    perm = torch.arange(n, device=keys[0].device)
    for k in reversed(list(keys)):
        perm = perm[torch.sort(k[perm], stable=True).indices]
    if valid_rows is not None and valid_rows < n:
        perm = perm[torch.sort((perm >= valid_rows).to(torch.int32),
                               stable=True).indices]
    return (perm.to(torch.int32), [k[perm] for k in keys],
            [v[perm] for v in payloads])


MAX_STACKED_BATCHES = 8   # SortedKeys.batch_lane's cache, per leading member
#: a batch's join_raw members take a member map (JoinMemberMap) where their
#: keys span at most this many values: a byte a key, 8 MB at most, which
#: stays in the H100's 50 MB L2
JOIN_MAP_MAX_SPAN = 1 << 23


@dataclasses.dataclass(frozen=True, eq=False)
class JoinMemberMap:
    """A batch's join_raw members as one member map: map uint8 [span],
    bit b of byte i set iff base + i is among member b's keys (B <= 8)."""
    map: torch.Tensor
    base: int


def join_member_map(probes: Sequence["SortedKeys"], lane: torch.Tensor
                ) -> Optional[JoinMemberMap]:
    """The members' keys as one member map over the range they span
    together, on `lane`'s device; None where the range is wider than
    JOIN_MAP_MAX_SPAN. Built on the host from the keys the members
    hold there (at most 8 x 65,536 of them), uploaded in one copy."""
    if len(probes) > MAX_BATCH:
        raise ValueError(f"{len(probes)} members past {MAX_BATCH}")
    typed = [p.typed() for p in probes]
    if typed[0].dtype != _np_of(lane.dtype):
        raise ValueError(f"join keys {typed[0].dtype} do not match the fact "
                         f"key lane's {lane.dtype}")
    lo = min(int(t.min()) for t in typed)
    span = max(int(t.max()) for t in typed) - lo + 1
    if span > JOIN_MAP_MAX_SPAN:
        return None
    bits = np.zeros(span, dtype=np.uint8)
    for b, t in enumerate(typed):
        bits[t.astype(np.int64) - lo] |= np.uint8(1 << b)
    return JoinMemberMap(torch.from_numpy(bits).to(lane.device), lo)


class SortedKeys:
    """A raw-key join's dim keys (and, for a jraw group key, their int32
    group codes) as JoinContext pads them, sorted once on each device by
    K12 (`radix_sort_join`) and cached: the K1 join_raw leaf and the K3
    jraw key read the sorted arrays, where the JAX kernels sort inside
    every launch. Padding repeats (largest key, its code), so the sort
    need not be stable there."""

    def __init__(self, keys, codes=None):
        self.keys = np.ascontiguousarray(keys)
        if self.keys.dtype.kind not in "iu" or self.keys.ndim != 1 or \
                not len(self.keys):
            raise ValueError("join keys must be a non-empty integer array")
        self.codes = None if codes is None else \
            np.ascontiguousarray(codes, dtype=np.int32)
        self._on: Dict[str, tuple] = {}   # device -> (keys, codes)
        # (device, lane dtype, ids of a batch's members) -> (weak refs to
        # them, their batch_lane), the last few batches this one led
        self._stacks: Dict[tuple, tuple] = {}
        self._lock = threading.Lock()

    def _unsorted(self, dev) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        keys = torch.from_numpy(self.typed()).to(dev)
        return keys, [] if self.codes is None else \
            [torch.from_numpy(self.codes).to(dev)]

    def on(self, device) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """(sorted keys, their codes or None) on `device`, sorted by K12
        there once and cached."""
        dev = torch.device(device)
        with self._lock:
            hit = self._on.get(str(dev))
        if hit is not None:
            return hit
        keys, pay = self._unsorted(dev)
        _perm, (sk,), sc = radix_sort([keys], pay,
                                      counter="radix_sort_join")
        out = (sk, sc[0] if sc else None)
        with self._lock:
            return self._on.setdefault(str(dev), out)

    def typed(self) -> np.ndarray:
        """The keys in the dtype of the lanes they are probed against
        (int64 past 4 bytes, else int32), on the host."""
        return self.keys.astype(
            np.int64 if self.keys.dtype.itemsize > 4 else np.int32)

    def batch_lane(self, probes: Sequence["SortedKeys"],
                   lane: torch.Tensor):
        """The lane a batched K1 join_raw node reads for the members
        `probes` (this one first) over the fact key lane `lane`: their
        JoinMemberMap (join_member_map) where their keys span a narrow range,
        else their K12-sorted keys stacked [B, Dp]. Made once per batch and
        device and cached here, as the coalescer runs one batch once a
        segment; the cache holds the other members weakly, so it keeps no
        query's keys alive."""
        key = (str(lane.device), lane.dtype, tuple(id(p) for p in probes))
        with self._lock:
            hit = self._stacks.get(key)
        if hit is not None and all(r() is p for r, p in zip(hit[0], probes)):
            return hit[1]
        out = join_member_map(probes, lane)
        if out is None:
            out = torch.stack([sorted_keys_for(p, lane) for p in probes])
        refs = tuple(weakref.ref(p) for p in probes)
        with self._lock:
            if len(self._stacks) >= MAX_STACKED_BATCHES:
                self._stacks.pop(next(iter(self._stacks)))
            self._stacks[key] = (refs, out)
        return out

    def plain(self, device) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """(sorted keys, their codes or None) on `device` by a stable
        torch.sort: the plain versions' own sort, apart from K12's."""
        keys, pay = self._unsorted(torch.device(device))
        sk, order = torch.sort(keys, stable=True)
        return sk, (pay[0][order] if pay else None)


def sorted_keys_for(probe: SortedKeys, lane: torch.Tensor,
                    plain: bool = False) -> torch.Tensor:
    """The sorted dim keys of a join_raw leaf over `lane`, on its device
    and in its dtype: K12's cached sort, or with `plain` the plain
    version's own (SortedKeys.plain)."""
    sk = (probe.plain if plain else probe.on)(lane.device)[0]
    if sk.dtype != lane.dtype:
        raise ValueError(f"join keys {sk.dtype} do not match the fact key "
                         f"lane's {lane.dtype}")
    return sk


def window_scan(sp: torch.Tensor, values: Sequence[torch.Tensor] = ()
                ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """K13 over a sorted partition lane sp (int32 [n]) and value lanes in
    the same order (int32 [n] each): (rn int32 [n], the 1-based row
    number within its partition; each lane's running sum within its
    partition, int32 with wraparound), as the JAX build_window_kernel
    computes them."""
    n, device = sp.shape[0], sp.device
    _check_lane(sp, "partition lane", n, device, (torch.int32,))
    for j, v in enumerate(values):
        _check_lane(v, f"value lane {j}", n, device, (torch.int32,))
    if not 1 <= n <= 1 << 30:
        raise ValueError(f"{n} rows outside [1, 2^30]")
    if device.type == "cpu":
        return window_scan_plain(sp, values)
    rn = torch.empty(n, dtype=torch.int32, device=device)
    outs = [torch.empty_like(v) for v in values]
    # the tile counters and the look-back descriptors start at zero
    scratch = torch.zeros(_scratch_words(
        "sort_window.cu", "pinot_window_scan_scratch_words", [_LL, _I], n,
        len(values)), dtype=torch.int64, device=device)
    _launch("window_scan", device, sp.data_ptr(), _ptrs(values), len(values),
            n, rn.data_ptr(), _ptrs(outs), scratch.data_ptr())
    return rn, outs


def window_scan_plain(sp: torch.Tensor, values: Sequence[torch.Tensor] = ()
                      ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """Plain PyTorch K13: cummax of the starts, torch.cumsum in int64
    rebased at each start, cast to int32."""
    n = sp.shape[0]
    iota = torch.arange(n, device=sp.device)
    new = torch.ones(n, dtype=torch.bool, device=sp.device)
    new[1:] = sp[1:] != sp[:-1]
    starts = torch.cummax(torch.where(new, iota, 0), dim=0).values
    rn = (iota - starts + 1).to(torch.int32)
    outs = []
    for v in values:
        cs = torch.cumsum(v.to(torch.int64), dim=0)
        base = cs[starts] - v[starts].to(torch.int64)
        outs.append((cs - base).to(torch.int32))
    return rn, outs


def run_window_kernel(part: torch.Tensor, orders: Sequence[torch.Tensor],
                      sums: Sequence[torch.Tensor], num_rows: int
                      ) -> Dict[str, torch.Tensor]:
    """The window of pinot_tpu/ops/kernels.py:run_window_kernel over int32
    lanes [n_pad] (partition codes, monotone order keys, value lanes; the
    first num_rows rows valid): K12 sorts by (valid, part, orders...)
    carrying the value lanes, K13 numbers and sums. Returns "win.perm",
    "win.rn" and "win.sum<j>", [n_pad] each, bit for bit the JAX
    outputs (padding rows included)."""
    perm, (sp, *_orders), svals = radix_sort(
        [part] + list(orders), list(sums), num_rows)
    rn, run = window_scan(sp, svals)
    outs = {"win.perm": perm, "win.rn": rn}
    outs.update({f"win.sum{j}": r for j, r in enumerate(run)})
    return outs


# ---------------------------------------------------------------------------
# Whole-plan dispatch
# ---------------------------------------------------------------------------


def _strategy(spec):
    extra = spec[3]
    return extra[0] if isinstance(extra, tuple) else None


def _is_parts_agg(spec) -> bool:
    fname, _col, source, _extra = spec
    return fname in ("sum", "avg") and source == "sv" and \
        _strategy(spec) == "parts"


def _extremes_of(fname: str) -> Tuple[str, ...]:
    return {"min": ("min",), "max": ("max",),
            "minmaxrange": ("min", "max")}.get(fname, ())


def run_segment_kernel(padded: int, filter_spec, agg_specs, group_spec,
                       select_spec, cols: Dict[str, torch.Tensor], params,
                       num_docs: int, device=None, group_params=()
                       ) -> Dict[str, torch.Tensor]:
    """One segment plan: K1, then K3 (group-by), or K2, K4, K5 and K7 as
    the aggregations need them, and K6 for a selection.

    Returns the device outputs under the JAX package's names
    (stats.num_docs_matched, agg{i}, agg{i}.parts, agg{i}.count,
    agg{i}.vsum, agg{i}.min, agg{i}.max, agg{i}.hll, group.count,
    gagg{i}.psums, gagg{i}.csums, gagg{i}.min, gagg{i}.max, sel.docids,
    sel.count, sel.<col>). `params`: the filter's; `group_params`: one
    member table per "mvin" group key. `device` is used only when no lane
    is read at all."""
    if cols:
        device = next(iter(cols.values())).device
    fparams, sparams = _split_params(filter_spec, select_spec, params)
    mask = filter_mask(padded, filter_spec, cols, fparams, num_docs, device)
    rest = list(group_params)
    outs: Dict[str, torch.Tensor] = {}
    if group_spec is not None:
        outs = _group_outputs(mask, group_spec, cols, rest)
    elif agg_specs or select_spec is None:
        outs = _agg_outputs(mask, agg_specs, cols)
    if rest:
        raise ValueError(f"{len(rest)} group params left unconsumed")
    if select_spec is not None:
        sel = masked_select(select_spec, cols, mask, vector_params=sparams)
        outs.setdefault("stats.num_docs_matched", sel["sel.count"])
        outs.update(sel)
    return outs


def _split_params(filter_spec, select_spec, params):
    """(the filter's params, the vector selection's (query, norm) or
    None): a plan's params list the filter's first, depth-first, then a
    vector selection's two."""
    plist = list(params)
    n = filter_param_count(filter_spec)
    fparams, sparams = plist[:n], plist[n:]
    if select_spec is not None and select_spec[0] == "vector":
        return fparams, sparams
    if sparams:
        raise ValueError(f"{len(sparams)} params left unconsumed")
    return fparams, None


def flat_lanes(cols: Dict[str, torch.Tensor], n_segs: int, padded: int
               ) -> Dict[str, torch.Tensor]:
    """A stack's lanes as the kernels read them, views without copies:
    row-scale lanes [S, P, ...] → [S * P, ...], part lanes [n_parts, S,
    P] → [n_parts, S * P]; dictionary-scale tables (.hllidx, .hllrank)
    as they are."""
    out = {}
    for key, t in cols.items():
        if key.endswith((".hllidx", ".hllrank", ".ivfc", ".ivfv")):
            out[key] = t                 # tables: per stack or per segment
        elif key.endswith(".parts"):
            if t.shape[1:] != (n_segs, padded):
                raise ValueError(f"{key} has shape {tuple(t.shape)}, "
                                 f"expected [n_parts, {n_segs}, {padded}]")
            out[key] = t.reshape(t.shape[0], n_segs * padded)
        else:
            if t.shape[:2] != (n_segs, padded):
                raise ValueError(f"{key} has shape {tuple(t.shape)}, "
                                 f"expected [{n_segs}, {padded}, ...]")
            out[key] = t.reshape((n_segs * padded,) + tuple(t.shape[2:]))
    return out


def run_stacked_kernel(padded: int, n_segs: int, filter_spec, agg_specs,
                       group_spec, select_spec, cols: Dict[str, torch.Tensor],
                       params, seg_docs: torch.Tensor, group_params=()
                       ) -> Dict[str, torch.Tensor]:
    """One plan over a stack of n_segs segments of `padded` rows each,
    every kernel launched once for the whole stack (the counterpart of
    pinot_tpu/parallel/sharded.py:get_sharded_kernel, which vmaps the
    segment kernel and combines with psum / pmin / pmax / all_gather).

    `cols`: row-scale lanes [S, P, ...] and part lanes [n_parts, S, P],
    contiguous (flat_lanes views them as [S * P]); HLL tables [card_pad].
    `seg_docs`: int32 [S] live rows per segment, on the lanes' device.
    Returns the JAX output names: stats.seg_matched [S]; the "sum",
    "min" and "max" kinds combined over the stack (counts, histograms,
    min / max, HLL registers, group count and min / max tables, and the
    float64 gagg{i}.csums); the "stack" kinds with a leading segment axis
    (agg{i}.parts [S, n_parts], agg{i}.vsum [S, P / 8192], sel.* [S, k,
    ...]), except gagg{i}.psums, which K3 folds exactly into int64 [L,
    g_pad] (the JAX per-segment tables summed over the segment axis)."""
    flat = flat_lanes(cols, n_segs, padded)
    device = seg_docs.device
    fparams, sparams = _split_params(filter_spec, select_spec, params)
    mask, seg_matched = filter_mask_stacked(padded, n_segs, filter_spec,
                                            flat, fparams, seg_docs, device)
    rest = list(group_params)
    outs: Dict[str, torch.Tensor] = {}
    if group_spec is not None:
        outs = _group_outputs(mask, group_spec, flat, rest, n_segs,
                              seg_matched)
    elif agg_specs or select_spec is None:
        outs = _agg_outputs(mask, agg_specs, flat, seg_rows=padded)
    if rest:
        raise ValueError(f"{len(rest)} group params left unconsumed")
    if select_spec is not None:
        sel = masked_select(select_spec, flat, mask, n_segs,
                            vector_params=sparams)
        outs.setdefault("stats.num_docs_matched",
                        seg_matched.sum(dtype=torch.int32))
        outs.update(sel)
    outs["stats.seg_matched"] = seg_matched
    return outs


def stack_param_leaves(params_list) -> Tuple[np.ndarray, ...]:
    """[(p0, p1, ...)] per member → one [B, ...] array per param leaf.

    The port's param check (pinot_tpu/ops/kernels.py:stack_param_leaves):
    one compiled spec gives every member params of one arity and one
    shape each (lists are padded from the spec), so a mismatch means
    plans of different specs were grouped, and raises ValueError before
    any launch."""
    n = len(params_list[0])
    for ps in params_list:
        if len(ps) != n:
            raise ValueError("batched plans disagree on param arity")
    leaves = []
    for i in range(n):
        vals = [np.asarray(ps[i]) for ps in params_list]
        if any(v.shape != vals[0].shape for v in vals):
            raise ValueError(f"batched plans disagree on the width of "
                             f"param {i}: "
                             f"{sorted({v.shape for v in vals})}")
        leaves.append(np.stack(vals))
    return tuple(leaves)


def run_segment_kernel_batched(padded: int, filter_spec, agg_specs,
                               select_spec, cols: Dict[str, torch.Tensor],
                               params_list, num_docs: int, device=None
                               ) -> Dict[str, torch.Tensor]:
    """N same-spec plans over one segment (the counterpart of
    pinot_tpu/ops/kernels.py:run_segment_kernel_batched, :1713): every
    output of run_segment_kernel gains a leading member axis [N, ...],
    member b's under params_list[b]. Group specs do not batch (their
    plans run one by one, as in the JAX package).

    Each kernel launches once per chunk of up to MAX_BATCH members (the
    JAX server's MAX_BATCH_CHUNK): the lanes are read once per chunk for
    all of its members. The chunks are not padded to a power of two, as
    the JAX package's batch_bucket pads them: that bounds XLA compiles,
    and a CUDA launch compiles nothing. Plans without params are one
    program: run_segment_kernel runs once and every member reads its
    outputs (views, no copies). Members whose params disagree in arity or
    width raise ValueError before any launch (stack_param_leaves)."""
    params_list = [tuple(p) for p in params_list]
    if not params_list:
        raise ValueError("no members")
    stack_param_leaves(params_list)
    n = len(params_list)
    if not params_list[0]:
        outs = run_segment_kernel(padded, filter_spec, agg_specs, None,
                                  select_spec, cols, (), num_docs, device)
        return {k: v.expand((n,) + tuple(v.shape)) for k, v in outs.items()}
    chunks = [_run_batch_chunk(padded, filter_spec, tuple(agg_specs or ()),
                               select_spec, cols, params_list[i:i + MAX_BATCH],
                               num_docs, device)
              for i in range(0, n, MAX_BATCH)]
    if len(chunks) == 1:
        return chunks[0]
    return {k: torch.cat([c[k] for c in chunks]) for k in chunks[0]}


def _run_batch_chunk(padded, filter_spec, agg_specs, select_spec, cols,
                     params_list, num_docs, device):
    """K1, then K2 / K4 / K5 / K7 and K6 (K9 and K8 in front where the
    plan probes or scores vectors), each launched once for the chunk."""
    if cols:
        device = next(iter(cols.values())).device
    split = [_split_params(filter_spec, select_spec, p) for p in params_list]
    masks, _matched = filter_mask_batched(padded, filter_spec, cols,
                                          [f for f, _s in split], num_docs,
                                          device)
    outs: Dict[str, torch.Tensor] = {}
    if agg_specs or select_spec is None:
        outs = _agg_outputs(masks, agg_specs, cols)
    if select_spec is not None:
        sel = masked_select_batched(select_spec, cols, masks,
                                    [sp for _f, sp in split])
        outs.setdefault("stats.num_docs_matched", sel["sel.count"])
        outs.update(sel)
    return outs


def spec_group_key(gcol, cols, params: List, device) -> GroupKey:
    """The K3 / K14 key of one group column of a spec, its runtime
    operands popped from `params` in key order: "mvin" its member table,
    "jcode" its code table, "jraw" its SortedKeys with codes (sorted on
    the lane's device by K12 once), "idoff" its int32 offset and "idrank"
    its int32 [card_pad] rank vector (the adaptive remaps' operands, which
    the executor appends as the JAX one does)."""
    c, gkind, off, card = gcol
    if gkind == "ids":
        return GroupKey("ids", cols[f"{c}.ids"])
    if gkind in ("jcode", "jraw", "idoff", "idrank") and not params:
        raise ValueError(f"no runtime operand for {gkind} key {c}")
    if gkind == "idoff":
        return GroupKey("idoff", cols[f"{c}.ids"],
                        offset=int(np.int32(params.pop(0))))
    if gkind == "idrank":
        rank = torch.as_tensor(np.ascontiguousarray(
            params.pop(0), dtype=np.int32)).to(device)
        return GroupKey("idrank", cols[f"{c}.ids"], table=rank)
    if gkind == "jcode":
        table = torch.as_tensor(np.ascontiguousarray(
            params.pop(0), dtype=np.int32)).to(device)
        return GroupKey("jcode", cols[f"{c}.ids"], table=table)
    if gkind == "jraw":
        lane = cols[f"{c}.raw"]
        probe = params.pop(0)
        sk, codes = probe.on(lane.device)
        return GroupKey("jraw", lane, table=sk, codes=codes, probe=probe)
    if gkind == "rawoff":
        return GroupKey("rawoff", cols[f"{c}.raw"], offset=int(off))
    if gkind in _MV_KEY_KINDS:
        member = None
        if gkind == "mvin":
            if not params:
                raise ValueError(f"no member table for mvin key {c}")
            member = torch.as_tensor(
                np.ascontiguousarray(params.pop(0), dtype=bool)).to(device)
        return GroupKey(gkind, cols[f"{c}.mv"], card=int(card),
                        member=member)
    raise ValueError(f"group key kind {gkind}")


@dataclasses.dataclass
class _GroupLanes:
    """The lanes a group spec's aggregations read, and where each
    aggregation's output comes from."""
    parts: List[torch.Tensor]            # part lanes [n_parts, P]
    slots: Dict[int, Tuple[int, int]]    # agg i -> (first part row, n)
    floats: List[torch.Tensor]           # sum lanes [P] (any raw dtype)
    fslots: Dict[int, int]               # agg i -> float lane
    extremes: List[tuple]                # (kind, lane, which, card_pad)
    eslots: Dict[Tuple[int, str], int]   # (agg i, which) -> extreme


def _group_lanes(gaggs, cols) -> _GroupLanes:
    lanes = _GroupLanes([], {}, [], {}, [], {})
    for i, spec in enumerate(gaggs):
        fname, col, source, extra = spec
        strategy = _strategy(spec)
        if fname == "count":
            continue
        if fname in ("sum", "avg") and strategy == "psums":
            pl = cols[f"{col}.parts"]
            lanes.slots[i] = (sum(p.shape[0] for p in lanes.parts),
                              pl.shape[0])
            lanes.parts.append(pl)
        elif fname in ("sum", "avg") and strategy in ("csums", "vlane") or \
                fname in ("sum", "avg") and source == "raw" and extra is None:
            lanes.fslots[i] = len(lanes.floats)
            lanes.floats.append(cols[f"{col}.vlane" if source == "sv"
                                     else f"{col}.raw"])
        elif _extremes_of(fname) and (
                (source == "sv" and strategy == "ids") or
                (source == "raw" and extra is None)):
            kind = "ids" if source == "sv" else "raw"
            card_pad = extra[1] if kind == "ids" else 0
            for which in _extremes_of(fname):
                lanes.eslots[(i, which)] = len(lanes.extremes)
                lanes.extremes.append((kind, cols[f"{col}.{kind}"], which,
                                       card_pad))
        else:
            raise ValueError(f"group aggregation spec {spec}")
    return lanes


def _group_outputs(mask, group_spec, cols, params: List,
                   n_segs: Optional[int] = None,
                   seg_matched: Optional[torch.Tensor] = None
                   ) -> Dict[str, torch.Tensor]:
    """The group-by outputs of one segment, or of a stack of `n_segs`
    segments (`seg_matched`: K1's matches per segment), under the JAX
    names. kmax = 0: K3's dense table (group.count, gagg{i}.psums / csums
    / min / max; over a stack int64 part sums). kmax > 0: the compacted
    route of pinot_tpu/ops/kernels.py:_group_outputs_compacted."""
    gcols, strides, g_pad, gaggs, kmax = group_spec
    keys = [spec_group_key(g, cols, params, mask.device) for g in gcols]
    lanes = _group_lanes(gaggs, cols)
    if kmax:
        return _group_outputs_compacted(mask, keys, strides, g_pad, kmax,
                                        lanes, n_segs, seg_matched)
    count, psums, csums, matched, tables = dense_group_aggregate(
        mask, keys, strides, g_pad, lanes.parts,
        [f.to(sum_dtype()) for f in lanes.floats], lanes.extremes,
        psums_wide=n_segs is not None)
    outs = {"stats.num_docs_matched": matched, "group.count": count}
    for i, (s0, n_p) in lanes.slots.items():
        outs[f"gagg{i}.psums"] = psums[s0:s0 + n_p]
    for i, j in lanes.fslots.items():
        outs[f"gagg{i}.csums"] = csums[j]
    for (i, which), e in lanes.eslots.items():
        outs[f"gagg{i}.{which}"] = tables[e]
    return outs


def _group_outputs_compacted(mask, keys, strides, g_pad: int, kmax: int,
                             lanes: _GroupLanes, n_segs: Optional[int],
                             seg_matched: Optional[torch.Tensor]
                             ) -> Dict[str, torch.Tensor]:
    """pinot_tpu/ops/kernels.py:_group_outputs_compacted (:1042) on the
    card. A segment's (expanded, for MV keys) rows fall into t blocks of
    CBLOCK; each keeps r = min(max(ceil(kmax / t), 8), CBLOCK) slots. Up
    to SORTED_RUNG_R slots: K14 compacts the matched rows, then K15 folds
    the slots into dense tables addressed by key (g_pad <= DENSE_G_LIMIT)
    or, after K16 ranks the keys, into tables addressed by rank beside
    group.rkeys (the ranked layout). Past it, the JAX kernel's sorted rung
    (_group_outputs_compacted_sorted, :960): its tables, when it does not
    overflow, are the dense direct-keyed tables over every matched row,
    so K3 computes them over the mask, and group.overflow is matched >
    kmax from the match count; when it overflows the escalation ladder
    discards them. Outputs per segment as JAX's; over a stack, dense
    tables combined (part sums in int64), ranked ones [S, ...] with each
    segment's own ranks, group.overflow over the whole stack."""
    segs = n_segs or 1
    w_total = group_combos(keys)
    rows = mask.shape[0] // segs * w_total         # a segment's rows
    kmax = min(kmax * w_total, rows)               # _expand_mv_group's kmax2
    t = rows // CBLOCK
    r = min(max(-(-kmax // t), 8), CBLOCK)
    if r > SORTED_RUNG_R:
        return _group_outputs_sorted(mask, keys, strides, g_pad, kmax, lanes,
                                     n_segs, seg_matched)
    ids_lanes = [e[1] for e in lanes.extremes if e[0] == "ids"]
    value_lanes = lanes.floats + [e[1] for e in lanes.extremes
                                  if e[0] == "raw"]
    kc, parts, vals, ids, overflow, matched = block_compact(
        mask, keys, strides, g_pad, r, lanes.parts, value_lanes, ids_lanes)
    cap = t * r
    extremes, n_id, n_raw = [], 0, len(lanes.floats)
    for kind, _lane, which, card_pad in lanes.extremes:
        if kind == "ids":
            extremes.append(("ids", ids[n_id], which,
                             _ext_init("ids", which, card_pad)))
            n_id += 1
        else:
            extremes.append(("raw", vals[n_raw], which, 0))
            n_raw += 1
    ranked = g_pad > DENSE_G_LIMIT
    outs = {"stats.num_docs_matched": matched, "group.overflow": overflow}
    if ranked:
        gslot, rkeys, _n = rank_slots(kc, cap, g_pad)
        t_slots = segs * cap
        count_route("ranked")
    else:
        gslot, t_slots = kc, g_pad
        count_route("compacted")
    count, psums, csums, tables = slot_tables(
        gslot, t_slots, cap, parts, vals[:len(lanes.floats)], extremes,
        psums_wide=n_segs is not None and not ranked)

    def per_segment(x):              # [..., S * cap] -> [S, ..., cap]
        if not ranked or n_segs is None:
            return x
        return x.reshape(x.shape[:-1] + (segs, cap)).movedim(-2, 0)

    if psums.dim() == 3:
        psums = per_segment(psums)
        if psums.shape[-3] == 1:                  # one chunk: [.., L, t]
            psums = psums.squeeze(-3)
    else:
        psums = per_segment(psums)
    prefix = "r" if ranked else ""
    if ranked:
        outs["group.rkeys"] = rkeys if n_segs is not None else rkeys[0]
        outs["group.rcount"] = per_segment(count)
    else:
        outs["group.count"] = count
    for i, (s0, n_p) in lanes.slots.items():
        outs[f"gagg{i}.{prefix or 'c'}psums"] = psums[..., s0:s0 + n_p, :]
    for i, j in lanes.fslots.items():
        outs[f"gagg{i}.{prefix}sum"] = per_segment(csums[j])
    for (i, which), e in lanes.eslots.items():
        outs[f"gagg{i}.{prefix}{which}"] = per_segment(tables[e])
    return outs


def _group_outputs_sorted(mask, keys, strides, g_pad: int, kmax: int,
                          lanes: _GroupLanes, n_segs: Optional[int],
                          seg_matched: Optional[torch.Tensor]
                          ) -> Dict[str, torch.Tensor]:
    """The sorted rung (r > SORTED_RUNG_R) by K3 over the mask: the
    matched rows (or MV entry combinations) of a segment, the JAX
    kernel's `matched`, decide group.overflow against kmax; a stack with
    MV keys runs K3 once a segment to count them. Part sums come as
    gagg{i}.cpsums, int32 [L, g_pad], or int32 [C, L, g_pad] where K3
    runs on C row slices to stay exact (JAX chunks its sorted rows past
    DENSE_ROWS_LIMIT instead: other chunk bounds, the same sum), and
    int64 [L, g_pad] over a stack; float sums as gagg{i}.sum."""
    count_route("sorted")
    floats = [f.to(sum_dtype()) for f in lanes.floats]
    w_total = group_combos(keys)
    segs = n_segs or 1
    if n_segs is not None and w_total > 1:
        p = mask.shape[0] // segs
        per = [dense_group_aggregate(
            mask[s * p:(s + 1) * p],
            [dataclasses.replace(k, lane=k.lane[s * p:(s + 1) * p])
             for k in keys], strides, g_pad,
            [pl[:, s * p:(s + 1) * p] for pl in lanes.parts],
            [f[s * p:(s + 1) * p] for f in floats],
            [(kind, lane[s * p:(s + 1) * p], which, cp)
             for kind, lane, which, cp in lanes.extremes])
            for s in range(segs)]
        combos = torch.stack([o[0].sum(dtype=torch.int64) for o in per])
        count = sum(o[0].to(torch.int64) for o in per)
        psums = sum(o[1].to(torch.int64) for o in per)
        csums = sum(o[2] for o in per)
        matched = sum(o[3] for o in per)
        tables = []
        for e, (_kind, _lane, which, _cp) in enumerate(lanes.extremes):
            t = per[0][4][e]
            for o in per[1:]:
                t = (torch.minimum if which == "min" else torch.maximum)(
                    t, o[4][e])
            tables.append(t)
    else:
        count, psums, csums, matched, tables = dense_group_aggregate(
            mask, keys, strides, g_pad, lanes.parts, floats, lanes.extremes,
            psums_wide=n_segs is not None, chunk_psums=n_segs is None)
        if w_total > 1:
            combos = count.sum(dtype=torch.int64)
        else:
            combos = matched if seg_matched is None else seg_matched
    outs = {"stats.num_docs_matched": matched, "group.count": count,
            "group.overflow": (combos > kmax).any().to(torch.int32)}
    for i, (s0, n_p) in lanes.slots.items():
        outs[f"gagg{i}.cpsums"] = psums[..., s0:s0 + n_p, :]
    for i, j in lanes.fslots.items():
        outs[f"gagg{i}.sum"] = csums[j]
    for (i, which), e in lanes.eslots.items():
        outs[f"gagg{i}.{which}"] = tables[e]
    return outs


def _reduce_request(spec):
    """(lane key, kind, card_pad, wants block sums, MV card) when K5
    serves `spec`, else None."""
    fname, col, source, extra = spec
    strategy = _strategy(spec)
    if source == "sv" and strategy == "vlane":
        return f"{col}.vlane", "raw", 0, True, None
    if source == "raw" and extra is None and \
            (fname in ("sum", "avg") or _extremes_of(fname)):
        return f"{col}.raw", "raw", 0, fname in ("sum", "avg"), None
    if source == "sv" and strategy == "ids" and _extremes_of(fname):
        return f"{col}.ids", "ids", extra[1], False, None
    if source == "mv" and _extremes_of(fname):
        card_pad, card = extra
        return f"{col}.mv", "ids", card_pad, False, card
    return None


#: MV aggregations K4's entry histogram serves
_MV_HIST_FNAMES = ("sum", "avg", "percentile", "distinctcount", "countmv")


def _agg_outputs(mask, agg_specs, cols, seg_rows: Optional[int] = None
                 ) -> Dict[str, torch.Tensor]:
    # one K5 per lane and one K4 per (lane, card_pad), shared by the
    # aggregations that read them; K2 runs for part lanes, or for the match
    # count when no K5 gives it; K7 runs per HLL aggregation on its K4.
    # seg_rows (a stack of segments of that many rows): K2 writes one row
    # of part sums per segment and K5's block sums take a segment axis,
    # the JAX "stack" outputs; everything else combines over the stack.
    # A [B, P] mask (a batch's members): the batched launches, every
    # output with a leading member axis
    batched = mask.dim() == 2
    reduce_fn = masked_reduce_batched if batched else masked_reduce
    hist_fn = masked_histogram_batched if batched else masked_histogram
    entry_fn = masked_entry_histogram_batched if batched else \
        masked_entry_histogram
    hll_fn = hll_registers_batched if batched else hll_registers
    reduce_args: Dict[str, tuple] = {}
    for spec in agg_specs:
        req = _reduce_request(spec)
        if req is not None:
            key, kind, card_pad, want, card = req
            prev = reduce_args.get(key)
            reduce_args[key] = (kind, card_pad, want or
                                (prev is not None and prev[2]), card)
    reduced = {key: reduce_fn(mask, cols[key], kind, card_pad, want, card)
               for key, (kind, card_pad, want, card) in reduce_args.items()}
    parts = [cols[f"{s[1]}.parts"] for s in agg_specs if _is_parts_agg(s)]
    if parts or not reduced:
        sums = masked_part_sums_batched(mask, parts) if batched else \
            masked_part_sums(mask, parts, seg_rows)
        ranged = sums.dim() == 2 + batched
        if ranged:                       # [(B,) R, L + 1]: add the counts
            count = sums[..., -1].sum(dim=-1, dtype=torch.int32)
            sums = sums.transpose(-1, -2)
        else:
            count = sums[..., -1]
    else:
        count = next(iter(reduced.values()))["count"]
    outs = {"stats.num_docs_matched": count}
    hists: Dict[tuple, torch.Tensor] = {}

    def histogram(col: str, card_pad: int) -> torch.Tensor:
        hk = (col, card_pad)
        if hk not in hists:
            hists[hk] = hist_fn(mask, cols[f"{col}.ids"], card_pad)
        return hists[hk]

    off = 0
    for i, spec in enumerate(agg_specs):
        fname, col, source, extra = spec
        req = _reduce_request(spec)
        if fname == "count":
            outs[f"agg{i}"] = count
        elif _is_parts_agg(spec):
            n_p = cols[f"{col}.parts"].shape[0]
            # [(B,) n_p], or [(B,) R, n_p] rows per segment or row range
            outs[f"agg{i}.parts"] = \
                sums[..., off:off + n_p, :].transpose(-1, -2) if ranged \
                else sums[..., off:off + n_p]
            outs[f"agg{i}.count"] = count
            off += n_p
        elif source == "sv" and _strategy(spec) == "hist":
            outs[f"agg{i}"] = histogram(col, extra[1])
        elif fname == "hll" and source == "sv":
            _strategy_name, card_pad, m = extra
            outs[f"agg{i}.hll"] = hll_fn(
                histogram(col, card_pad), cols[f"{col}.hllidx"],
                cols[f"{col}.hllrank"], m)
        elif source == "mv" and fname in _MV_HIST_FNAMES:
            card_pad, card = extra
            hk = (col, card_pad, "mv")
            if hk not in hists:
                hists[hk] = entry_fn(mask, cols[f"{col}.mv"], card_pad,
                                     card)
            hist, total = hists[hk]
            outs[f"agg{i}"] = total if fname == "countmv" else hist
        elif req is not None:
            r = reduced[req[0]]
            if req[3]:
                outs[f"agg{i}.vsum"] = r["sums"] if seg_rows is None \
                    else r["sums"].reshape(-1, seg_rows // BLOCK)
                outs[f"agg{i}.count"] = r["count"]
            for which in _extremes_of(fname):
                outs[f"agg{i}.{which}"] = r[which]
        else:
            raise ValueError(f"aggregation spec {spec}")
    return outs
