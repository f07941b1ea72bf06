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
  "ids" and "rawoff", `_expand_mv_group` for kinds "mvids" / "mvin",
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
  `_agg_outputs`).

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
  params: flat sequence consumed in depth-first pred order: eq/neq one
          value, range_ids (lo, hi) half-open, range_raw (lo, hi) with
          extra = (lo_inclusive, hi_inclusive), in/notin a [k] list (ids
          padded with -1), member a bool [card_pad] table. Raw constants
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
           kmax=0); kind "ids" ({name}.ids), "rawoff" ({name}.raw minus
          off), "mvids" ({name}.mv entries) or "mvin" (entries in a member
          table popped from the params after the filter's, in key order)
  select: (kind, k, order=((col, asc, card_pad, source), ...),
           gather=((col, source), ...)), kind ∈ {limit, order, ordertk,
           ordermk}, source "sv" ({col}.ids), "raw" ({col}.raw) or, for a
           gathered column, "mv" ({col}.mv) → K6
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

INT32_MAX = 2**31 - 1
BLOCK = 8192                 # row block: padded segment lengths are multiples
DENSE_ROWS_LIMIT = 1 << 24   # 127 * 2^24 < 2^31: int32 part sums stay exact
DENSE_CARD_LIMIT = 32768     # the JAX planner's histogram cap for float SUM


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
        "ivf_probe_select", "pinot_tpu_torch/ops/csrc/vector_scores.cu",
        "pinot_tpu/ops/kernels.py:140"),
    "ivf_assign": KernelInfo(
        "ivf_assign", "pinot_tpu_torch/ops/csrc/ivf_assign.cu",
        "pinot_tpu/ops/ivf_kernels.py:26"),
    "ivf_recenter": KernelInfo(
        "ivf_recenter", "pinot_tpu_torch/ops/csrc/ivf_recenter.cu",
        "pinot_tpu/ops/ivf_kernels.py:51"),
}

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_PP = ctypes.POINTER(_P)
_IP = ctypes.POINTER(_I)
_LLP = ctypes.POINTER(_LL)
_F = ctypes.c_float
_ARGTYPES = {
    "filter_mask": [_PP, _I, _P, _I, _I, _I, _LL, _LL, _P, _LL, _P, _P, _P],
    "masked_part_sums": [_P, _PP, _I, _LL, _LL, _P, _P],
    "dense_group_aggregate": [
        _P, _PP, _IP, _IP, _IP, _IP, _IP, _LLP, _PP, _IP, _I,
        _PP, _I, _PP, _I,
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
    "ivf_recenter": [_P, _P, _LL, _I, _P, _I, _P, _P, _P],
}
_ARGTYPES["masked_select_vector"] = _ARGTYPES["masked_select"]


def reset_launch_counts() -> None:
    for k in KERNELS.values():
        k.launches = 0


def launch_counts() -> Dict[str, int]:
    return {name: k.launches for name, k in KERNELS.items()}


def _c_entry(name: str):
    info = KERNELS[name]
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
    KERNELS[name].launches += 1


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
             "ivf_probe": 15}
#: params each predicate kind takes (an ivf_probe: the query and its norm)
_LEAF_PARAMS = {"range_ids": 2, "range_raw": 2, "ivf_probe": 2}
_RAW_KINDS = ("eq_raw", "neq_raw", "range_raw", "in_raw", "notin_raw")
_NODE_WORDS = 6              # {op, lane, param offset, arg, elem, width}
_MAX_FILTER_LANES = 16
_MAX_STACK = 32


def _leaf(spec) -> Tuple[str, str]:
    """(kind, lane key) of a predicate node K1 evaluates."""
    _, kind, col, source, _extra = spec
    if source == "ivf" and kind == "ivf_probe":
        return kind, f"{col}.ivfa"          # + {col}.ivfc / .ivfv for K9
    if kind not in _LEAF_OPS or source not in ("sv", "mv", "raw") or \
            (source == "raw") != (kind in _RAW_KINDS):
        raise ValueError(f"predicate kind {kind} over {source} is not a "
                         "K1 filter_mask predicate")
    return kind, f"{col}.{'ids' if source == 'sv' else source}"


def _filter_lane_ok(t: torch.Tensor, key: str, padded: int, device) -> None:
    if key.endswith(".raw"):
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
                   probe_lanes: Optional[List[torch.Tensor]] = None
                   ) -> Tuple[np.ndarray, int]:
    """Flatten a filter spec and its params into the K1 program.

    Returns (buffer int32 [6 * n_nodes + n_param_words], n_nodes). Node =
    {op, lane, param offset, arg, elem, width}, lane indexing
    filter_lane_keys(spec), elem the lane's element type code, width its
    values per row; the params follow the nodes, offsets count from their
    start. Raw constants are cast to the lane's dtype. An ivf_probe node
    runs K9 on its codebook lanes here and appends the probe ids and ok
    flags to `probe_lanes` (K1's lane table continues with them); its two
    parameter words are their lane indices.
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
                ids, ok = ivf_select_probes(cols[f"{col}.ivfc"],
                                            cols[f"{col}.ivfv"], q, q_norm,
                                            metric, nprobe)
                first = len(lanes) + len(probe_lanes)
                probe_lanes.extend([ids, ok])
                words.extend([first, first + 1])
                arg = int(nprobe)
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
            emit(_LEAF_OPS[kind], lane, off, arg, _ELEM[lane_t.dtype],
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
                   num_docs: int, matched: Optional[torch.Tensor]
                   ) -> torch.Tensor:
    """K1 over `rows` rows in segments of seg_rows: the uint8 mask, and
    each segment's matches added into `matched` when given."""
    probes: List[torch.Tensor] = []
    buf, n_nodes = compile_filter(filter_spec, params, cols, probes)
    lanes = [cols[k] for k in keys] + probes
    # the one H2D copy, from pinned memory so the host does not wait
    prog = torch.from_numpy(buf).pin_memory().to(device, non_blocking=True)
    out = torch.empty(rows, dtype=torch.uint8, device=device)
    general = any(not k.endswith(".ids") for k in keys)    # raw / MV
    _launch("filter_mask", device, _ptrs(lanes), len(lanes),
            prog.data_ptr(), n_nodes, int(buf.shape[0]), int(general),
            rows, seg_rows, None if seg_docs is None else seg_docs.data_ptr(),
            num_docs, out.data_ptr(),
            None if matched is None else matched.data_ptr())
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
    rows = _part_rows(part_lanes)
    for k, r in enumerate(rows):
        _check_lane(r, f"part lane {k}", padded, device, (torch.int8,))
    if len(rows) > _MAX_PARTS:
        raise ValueError(f"{len(rows)} part lanes > {_MAX_PARTS}")
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
_KEY_KINDS = {"ids": 0, "rawoff": 1, "mvids": 2, "mvin": 3}
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
      is False drop it too."""
    kind: str
    lane: torch.Tensor
    card: int = 0
    offset: int = 0
    member: Optional[torch.Tensor] = None

    @property
    def width(self) -> int:
        return self.lane.shape[1] if self.kind in _MV_KEY_KINDS else 1


def _as_key(k) -> GroupKey:
    return k if isinstance(k, GroupKey) else GroupKey("ids", k)


def _check_key(key: GroupKey, c: int, padded: int, device) -> None:
    what = f"key lane {c} ({key.kind})"
    if key.kind not in _KEY_KINDS:
        raise ValueError(f"group key kind {key.kind}")
    if key.kind == "ids":
        _check_lane(key.lane, what, padded, device, _ID_DTYPES)
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
                          psums_wide: bool = False):
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
    the rows of a launch."""
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
                          extremes, smem_slots, step, psums_wide)
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
    tables = [torch.full((g_pad,), _ext_init(kind, which, cp),
                         dtype=torch.int32 if kind == "ids"
                         else torch.float64, device=device)
              for kind, _lane, which, cp in extremes]
    members = [k.member if k.kind == "mvin" else None for k in keys]
    _launch("dense_group_aggregate", device, mask.data_ptr(),
            _ptrs([k.lane for k in keys]),
            _ints([_ELEM[k.lane.dtype] for k in keys]), _ints(strides),
            _ints([_KEY_KINDS[k.kind] for k in keys]),
            _ints([k.width for k in keys]), _ints([k.card for k in keys]),
            _longs([k.offset for k in keys]),
            (_P * len(keys))(*[None if m is None else m.data_ptr()
                               for m in members]),
            _ints([0 if m is None else m.shape[0] for m in members]),
            len(keys), _ptrs(rows), len(rows),
            _ptrs(float_lanes), len(float_lanes),
            _ptrs([e[1] for e in extremes]),
            _ints([_ELEM[e[1].dtype] for e in extremes]),
            _ints([_EXT_MODES[(e[0], e[2])] for e in extremes]),
            _ints([_ext_init(e[0], e[2], e[3]) if e[0] == "ids" else 0
                   for e in extremes]),
            _ptrs(tables), len(extremes), padded, int(g_pad),
            int(smem_slots), int(psums_wide), count.data_ptr(),
            psums.data_ptr(), csums.data_ptr(), matched.data_ptr())
    return count, psums, csums, matched, tables


def _k3_slices(mask, keys, strides, g_pad, rows, float_lanes, extremes,
               smem_slots, step, psums_wide=False):
    """K3 over row slices of `step` rows, the slices' tables added
    (counts and part sums in int64, min / max tables by min / max)."""
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
    psums = sum(o[1].to(torch.int64) for o in outs)
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
                     strides: Sequence[int], g_pad: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch of K3's key walk, as `_expand_mv_group` and
    `_group_key` compute it: (row index, clipped int32 key) of every
    matched (doc, MV entry combination) that survives, first MV key
    fastest."""
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
        else:
            ids = k.lane[docs].to(torch.int32)[:, None]
        key += ids * int(np.int32(s))
    rows = docs[:, None].expand(n, w_total)[keep]
    return rows, key.clamp(0, g_pad - 1)[keep].long()


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
    from pinot_tpu_torch.ops import build
    fn = build.load("masked_select.cu").pinot_masked_select_scratch_words
    fn.argtypes = [_LL, _I, _I, _I]
    fn.restype = ctypes.c_longlong
    return int(fn(padded, k, n_words, n_segs))


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
                   counter: str = "masked_select"
                   ) -> Dict[str, torch.Tensor]:
    """K6 for kinds limit / order / ordertk / ordermk; the gathered
    columns named in `zero_invalid` hold zeros after the valid rows, and
    the launch counts under `counter`."""
    _kind, k, _order, gather_cols = select_spec
    rows, device = mask.shape[0], mask.device
    segs = 1 if n_segs is None else n_segs
    if segs < 1 or rows % segs:
        raise ValueError(f"{rows} rows do not split into {segs} segments")
    padded = rows // segs
    _check_mask(mask)
    terms = _select_terms(select_spec, cols)
    for lane, mode, *_ in terms:
        _check_lane(lane, "order lane", rows, device,
                    _ID_DTYPES if mode in (_PACK, _ID) else _RAW_DTYPES)
    gathers = []
    for col, source in gather_cols:
        lane = cols[gather_lane_key(col, source)]
        _check_lane(lane, f"gather lane {col}", rows, device,
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
        out = selection_outputs_plain(select_spec, cols, mask, n_segs)
        for col in zero_invalid:
            out[f"sel.{col}"] = torch.where(out["sel.docids"] >= 0,
                                            out[f"sel.{col}"], 0)
        return out
    lead = () if n_segs is None else (n_segs,)
    scratch_words = select_scratch_words(padded, k, n_words, segs)
    scratch = torch.empty(scratch_words, dtype=torch.int32, device=device)
    docids = torch.empty(lead + (k,), dtype=torch.int32, device=device)
    count = torch.zeros(lead, dtype=torch.int32, device=device)
    outs = [torch.empty(lead + (k,) + tuple(g.shape[1:]), dtype=g.dtype,
                        device=device) for g in gathers]
    zero_bits = sum(1 << g for g, (col, _src) in enumerate(gather_cols)
                    if col in zero_invalid)
    _launch(counter, device, mask.data_ptr(), padded, segs, int(k),
            _ptrs([t[0] for t in terms]),
            _ints([_ELEM[t[0].dtype] for t in terms]),
            _ints([t[1] for t in terms]), _ints([t[2] for t in terms]),
            _ints([int(t[3]) for t in terms]), len(terms), n_words,
            _ptrs(gathers),
            _ints([g.element_size() * (g.shape[1] if g.dim() == 2 else 1)
                   for g in gathers]),
            _ptrs(outs), len(gathers), ctypes.c_int32(zero_bits).value,
            scratch.data_ptr(), scratch_words, docids.data_ptr(),
            count.data_ptr())
    res = {"sel.docids": docids, "sel.count": count}
    for (col, _source), o in zip(gather_cols, outs):
        res[f"sel.{col}"] = o
    return res


# ---------------------------------------------------------------------------
# K8 vector_scores, K9 ivf_probe_select
# ---------------------------------------------------------------------------

MAX_VEC_DIM = 4096               # common/schema.py:MAX_VECTOR_DIMENSION
MAX_CENTROIDS = 8192             # vector_scores.cu keeps K9's keys in 32 KB
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


def _query(q, dim_pad: int, device) -> torch.Tensor:
    qt = torch.as_tensor(np.ascontiguousarray(q, dtype=np.float32)) \
        if not isinstance(q, torch.Tensor) else q
    if qt.dtype != torch.float32 or qt.shape != (dim_pad,):
        raise ValueError(f"query vector must be float32 [{dim_pad}], got "
                         f"{qt.dtype} {tuple(qt.shape)}")
    return qt.to(device).contiguous()


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
    q_norm), -inf where that denominator is not > 0."""
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
    """Plain PyTorch K8: the products, the tree, the cosine quotient."""
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
    live count (pinot_tpu/ops/kernels.py:ivf_select_probes)."""
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
    stable sort by key descending (ties keep the lower id)."""
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
        outs = _group_outputs(mask, group_spec, flat, rest, psums_wide=True)
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


def spec_group_key(gcol, cols, params: List, device) -> GroupKey:
    """The K3 key of one group column of a spec; "mvin" pops its member
    table from `params`."""
    c, gkind, off, card = gcol
    if gkind == "ids":
        return GroupKey("ids", cols[f"{c}.ids"])
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


def _group_outputs(mask, group_spec, cols, params: List,
                   psums_wide: bool = False) -> Dict[str, torch.Tensor]:
    gcols, strides, g_pad, gaggs, kmax = group_spec
    if kmax:
        raise ValueError("compacted group specs (kmax > 0) are a TPU "
                         "strategy this port does not take")
    keys = [spec_group_key(g, cols, params, mask.device) for g in gcols]
    parts, slots, floats, fslots, extremes, eslots = [], {}, [], {}, [], {}
    for i, spec in enumerate(gaggs):
        fname, col, source, extra = spec
        strategy = _strategy(spec)
        if fname == "count":
            continue
        if fname in ("sum", "avg") and strategy == "psums":
            pl = cols[f"{col}.parts"]
            slots[i] = (sum(p.shape[0] for p in parts), pl.shape[0])
            parts.append(pl)
        elif fname in ("sum", "avg") and strategy == "csums":
            lane = cols[f"{col}.vlane" if source == "sv" else f"{col}.raw"]
            fslots[i] = len(floats)
            floats.append(lane.to(sum_dtype()))
        elif _extremes_of(fname) and (
                (source == "sv" and strategy == "ids") or
                (source == "raw" and extra is None)):
            kind = "ids" if source == "sv" else "raw"
            card_pad = extra[1] if kind == "ids" else 0
            for which in _extremes_of(fname):
                eslots[(i, which)] = len(extremes)
                extremes.append((kind, cols[f"{col}.{kind}"], which,
                                 card_pad))
        else:
            raise ValueError(f"group aggregation spec {spec}")
    count, psums, csums, matched, tables = dense_group_aggregate(
        mask, keys, strides, g_pad, parts, floats, extremes,
        psums_wide=psums_wide)
    outs = {"stats.num_docs_matched": matched, "group.count": count}
    for i, (s0, n_p) in slots.items():
        outs[f"gagg{i}.psums"] = psums[s0:s0 + n_p]
    for i, j in fslots.items():
        outs[f"gagg{i}.csums"] = csums[j]
    for (i, which), e in eslots.items():
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
    # the JAX "stack" outputs; everything else combines over the stack
    reduce_args: Dict[str, tuple] = {}
    for spec in agg_specs:
        req = _reduce_request(spec)
        if req is not None:
            key, kind, card_pad, want, card = req
            prev = reduce_args.get(key)
            reduce_args[key] = (kind, card_pad, want or
                                (prev is not None and prev[2]), card)
    reduced = {key: masked_reduce(mask, cols[key], kind, card_pad, want,
                                  card)
               for key, (kind, card_pad, want, card) in reduce_args.items()}
    parts = [cols[f"{s[1]}.parts"] for s in agg_specs if _is_parts_agg(s)]
    if parts or not reduced:
        sums = masked_part_sums(mask, parts, seg_rows)
        ranged = sums.dim() == 2
        if ranged:                       # [R, L + 1]: combine the counts
            count = sums[:, -1].sum(dtype=torch.int32)
            sums = sums.T
        else:
            count = sums[-1]
    else:
        count = next(iter(reduced.values()))["count"]
    outs = {"stats.num_docs_matched": count}
    hists: Dict[tuple, torch.Tensor] = {}

    def histogram(col: str, card_pad: int) -> torch.Tensor:
        hk = (col, card_pad)
        if hk not in hists:
            hists[hk] = masked_histogram(mask, cols[f"{col}.ids"], card_pad)
        return hists[hk]

    off = 0
    for i, spec in enumerate(agg_specs):
        fname, col, source, extra = spec
        req = _reduce_request(spec)
        if fname == "count":
            outs[f"agg{i}"] = count
        elif _is_parts_agg(spec):
            n_p = cols[f"{col}.parts"].shape[0]
            # [n_p], or [R, n_p] rows per segment or row range
            outs[f"agg{i}.parts"] = sums[off:off + n_p].T if ranged \
                else sums[off:off + n_p]
            outs[f"agg{i}.count"] = count
            off += n_p
        elif source == "sv" and _strategy(spec) == "hist":
            outs[f"agg{i}"] = histogram(col, extra[1])
        elif fname == "hll" and source == "sv":
            _strategy_name, card_pad, m = extra
            outs[f"agg{i}.hll"] = hll_registers(
                histogram(col, card_pad), cols[f"{col}.hllidx"],
                cols[f"{col}.hllrank"], m)
        elif source == "mv" and fname in _MV_HIST_FNAMES:
            card_pad, card = extra
            hk = (col, card_pad, "mv")
            if hk not in hists:
                hists[hk] = masked_entry_histogram(mask, cols[f"{col}.mv"],
                                                   card_pad, card)
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
