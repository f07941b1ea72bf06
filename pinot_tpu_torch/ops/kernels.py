"""Per-segment query kernels: filter mask, masked part sums, group tables.

Counterpart of pinot_tpu/ops/kernels.py. The JAX package compiles a whole
segment plan into one jitted XLA program; here the same plan runs as a
short fixed sequence of kernels written by hand for Hopper
(ops/csrc/*.cu, built by ops/build.py):

- K1 `filter_mask`: the filter tree → uint8 row mask
  (replaces `_eval_filter` / `_eval_pred`);
- K2 `masked_part_sums`: exact sums of bit-sliced part lanes + the match
  count (replaces `_part_sums` and the masked count);
- K3 `dense_group_aggregate`: mixed-radix group key → per-group count,
  int32 part sums and float64 sums (replaces `_group_key` kind "ids",
  `_dense_group_count`, `_dense_group_part_sums`, `_dense_group_float_sums`
  and the scatter fallback for count / sum / avg).

Every wrapper checks its operands, allocates its outputs, and launches on
the current stream. Beside each kernel is its plain PyTorch version: the
wrapper uses it for a tensor that lies on the CPU, and only then. For a
CUDA tensor the wrapper launches the kernel or raises.

Spec grammar (hashable tuples, the JAX package's own; this slice takes the
subset below, the planner raises UnsupportedOnDevice on the rest):

  filter: ("and", (child, ...)) | ("or", (child, ...)) | ("match_all",)
        | ("empty",) | ("pred", kind, col, "sv", extra)
          kind ∈ {eq_id, neq_id, range_ids, in_ids, notin_ids, member}
  params: flat sequence consumed in depth-first pred order: eq/neq one
          int32, range_ids (lo, hi) half-open, in/notin an int32 [k] list
          padded with -1, member a bool [card_pad] table.
  agg:    (fname, col, source, extra) with ("count", "*", "none", None) and
          ("sum" | "avg", col, "sv", ("parts", card_pad)).
  group:  (cols=((name, "ids", 0, card), ...), strides, g_pad,
           aggs=(count | sum/avg with ("psums", card_pad) over sv parts, or
                 ("csums",) over raw / ("csums", card_pad) over sv vlane),
           kmax=0)
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

INT32_MAX = 2**31 - 1
BLOCK = 8192                 # row block: padded segment lengths are multiples
DENSE_ROWS_LIMIT = 1 << 24   # 127 * 2^24 < 2^31: int32 part sums stay exact


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
}

_P = ctypes.c_void_p
_ARGTYPES = {
    "filter_mask": [ctypes.POINTER(_P), ctypes.POINTER(ctypes.c_int),
                    ctypes.c_int, _P, ctypes.c_int, ctypes.c_int,
                    ctypes.c_longlong, ctypes.c_longlong, _P, _P],
    "masked_part_sums": [_P, ctypes.POINTER(_P), ctypes.c_int,
                         ctypes.c_longlong, _P, _P],
    "dense_group_aggregate": [
        _P, ctypes.POINTER(_P), ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int), ctypes.c_int, ctypes.POINTER(_P),
        ctypes.c_int, ctypes.POINTER(_P), ctypes.c_int, ctypes.c_longlong,
        ctypes.c_int, _P, _P, _P, _P, _P],
}


def reset_launch_counts() -> None:
    for k in KERNELS.values():
        k.launches = 0


def launch_counts() -> Dict[str, int]:
    return {name: k.launches for name, k in KERNELS.items()}


def _c_entry(name: str):
    info = KERNELS[name]
    if info._fn is None:
        from pinot_tpu_torch.ops import build
        fn = getattr(build.load(f"{name}.cu"), f"pinot_{name}")
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


def _check_lane(t: torch.Tensor, what: str, padded: int, device,
                dtypes: Tuple[torch.dtype, ...]) -> None:
    if t.device != device:
        raise ValueError(f"{what} on {t.device}, expected {device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{what} has dtype {t.dtype}, expected one of "
                        f"{dtypes}")
    if t.dim() != 1 or t.shape[0] != padded:
        raise ValueError(f"{what} has shape {tuple(t.shape)}, expected "
                         f"({padded},)")
    if not t.is_contiguous():
        raise ValueError(f"{what} is not contiguous")


_ID_DTYPES = (torch.int8, torch.int16, torch.int32)


# ---------------------------------------------------------------------------
# K1 filter_mask
# ---------------------------------------------------------------------------

_OP_TRUE, _OP_FALSE, _OP_AND, _OP_OR = 0, 1, 8, 9
_LEAF_OPS = {"eq_id": 2, "neq_id": 3, "range_ids": 4, "in_ids": 5,
             "notin_ids": 6, "member": 7}
_MAX_FILTER_LANES = 16
_MAX_STACK = 32


def _leaf(spec) -> Tuple[str, str]:
    _, kind, col, source, _extra = spec
    if source != "sv" or kind not in _LEAF_OPS:
        raise ValueError(f"predicate kind {kind} over {source} is not a "
                         "K1 filter_mask predicate")
    return kind, f"{col}.ids"


def compile_filter(filter_spec, params: Sequence
                   ) -> Tuple[np.ndarray, int]:
    """Flatten a filter spec and its params into the K1 program.

    Returns (buffer int32 [4 * n_nodes + n_param_words], n_nodes). Node =
    {op, lane, param offset, arg}, lane indexing filter_lane_keys(spec);
    the params follow the nodes, offsets count from their start.
    """
    nodes: List[Tuple[int, int, int, int]] = []
    words: List[int] = []
    lanes = filter_lane_keys(filter_spec)
    plist = list(params)
    depth = max_depth = 0

    def emit(op: int, lane: int = 0, off: int = 0, arg: int = 0,
             pops: int = 0) -> None:
        nonlocal depth, max_depth
        nodes.append((op, lane, off, arg))
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
            lane, off, arg = lanes.index(key), len(words), 0
            if kind in ("eq_id", "neq_id"):
                words.append(int(plist.pop(0)))
            elif kind == "range_ids":
                words.append(int(plist.pop(0)))
                words.append(int(plist.pop(0)))
            elif kind in ("in_ids", "notin_ids"):
                vals = np.asarray(plist.pop(0), dtype=np.int64).ravel()
                words.extend(int(v) for v in vals)
                arg = len(vals)
            else:                                      # member
                member = np.asarray(plist.pop(0), dtype=bool).ravel()
                arg = len(member)
                bits = np.packbits(member, bitorder="little")
                bits = np.concatenate(
                    [bits, np.zeros(-len(bits) % 4, np.uint8)])
                words.extend(bits.view("<u4").astype(np.int64).tolist())
            emit(_LEAF_OPS[kind], lane, off, arg)
        else:
            raise ValueError(f"unknown filter node {op}")

    walk(filter_spec)
    if plist:
        raise ValueError(f"{len(plist)} filter params left unconsumed")
    if max_depth > _MAX_STACK:
        raise ValueError(f"filter needs a stack of {max_depth} > "
                         f"{_MAX_STACK}")
    if len(lanes) > _MAX_FILTER_LANES:
        raise ValueError(f"filter reads {len(lanes)} lanes > "
                         f"{_MAX_FILTER_LANES}")
    buf = np.concatenate([np.asarray(nodes, np.int64).reshape(-1),
                          np.asarray(words, np.int64)])
    # member words carry bit 31: wrap to int32 two's complement
    return buf.astype(np.uint32).view(np.int32), len(nodes)


def filter_lane_keys(filter_spec) -> List[str]:
    """Lane keys ({col}.ids) the filter reads, in first-use order."""
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
        _check_lane(cols[key], key, padded, device, _ID_DTYPES)
    if device.type == "cpu":
        return filter_mask_plain(padded, filter_spec, cols, params, num_docs,
                                 device)
    buf, n_nodes = compile_filter(filter_spec, params)
    lanes = [cols[k] for k in keys]
    # the one H2D copy, from pinned memory so the host does not wait
    prog = torch.from_numpy(buf).pin_memory().to(device, non_blocking=True)
    out = torch.empty(padded, dtype=torch.uint8, device=device)
    _launch("filter_mask", device, _ptrs(lanes),
            _ints([t.element_size() for t in lanes]), len(lanes),
            prog.data_ptr(), n_nodes, int(buf.shape[0]), padded,
            int(num_docs), out.data_ptr())
    return out


def filter_mask_plain(padded: int, filter_spec,
                      cols: Dict[str, torch.Tensor], params: Sequence,
                      num_docs: int, device=None) -> torch.Tensor:
    """Plain PyTorch K1: the filter tree evaluated with tensor ops."""
    device = _mask_device(filter_lane_keys(filter_spec), cols, device)
    valid = torch.arange(padded, device=device) < int(num_docs)
    plist = list(params)

    def as_t(v, dtype):
        return torch.as_tensor(np.asarray(v), device=device).to(dtype)

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
        lane = cols[key].to(torch.int32)
        if kind == "eq_id":
            return lane == int(plist.pop(0))
        if kind == "neq_id":
            return lane != int(plist.pop(0))
        if kind == "range_ids":
            lo, hi = int(plist.pop(0)), int(plist.pop(0))
            return (lane >= lo) & (lane < hi)
        if kind in ("in_ids", "notin_ids"):
            vals = as_t(plist.pop(0), torch.int32)
            hit = (lane[:, None] == vals[None, :]).any(-1)
            return hit if kind == "in_ids" else ~hit
        member = as_t(plist.pop(0), torch.bool)
        return member[lane.clamp(0, member.shape[0] - 1).long()]

    mask = walk(filter_spec) & valid
    return mask.to(torch.uint8)


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


def masked_part_sums(mask: torch.Tensor,
                     part_lanes: Sequence[torch.Tensor]) -> torch.Tensor:
    """int32 [L + 1]: the masked sum of each int8 part lane (L = all rows
    of all the [n_parts, P] blocks, in order), then the match count."""
    padded, device = mask.shape[0], mask.device
    _check_lane(mask, "mask", padded, device, (torch.uint8,))
    rows = _part_rows(part_lanes)
    for k, r in enumerate(rows):
        _check_lane(r, f"part lane {k}", padded, device, (torch.int8,))
    if len(rows) > _MAX_PARTS:
        raise ValueError(f"{len(rows)} part lanes > {_MAX_PARTS}")
    if 127 * padded >= 2**31:
        raise ValueError(f"{padded} rows: int32 part sums could overflow "
                         "(127 * P >= 2^31)")
    if device.type == "cpu":
        return masked_part_sums_plain(mask, part_lanes)
    out = torch.zeros(len(rows) + 1, dtype=torch.int32, device=device)
    _launch("masked_part_sums", device, mask.data_ptr(), _ptrs(rows),
            len(rows), padded, out.data_ptr())
    return out


def masked_part_sums_plain(mask: torch.Tensor,
                           part_lanes: Sequence[torch.Tensor]
                           ) -> torch.Tensor:
    """Plain PyTorch K2: where + sum(dtype=int32)."""
    m = mask.bool()
    sums = [torch.where(m[None, :], pl, 0).sum(dim=1, dtype=torch.int32)
            for pl in part_lanes]
    count = m.sum(dtype=torch.int32).reshape(1)
    return torch.cat(sums + [count])


# ---------------------------------------------------------------------------
# K3 dense_group_aggregate
# ---------------------------------------------------------------------------

_MAX_KEYS = 8
_MAX_FLOATS = 8


def dense_group_aggregate(mask: torch.Tensor,
                          key_lanes: Sequence[torch.Tensor],
                          strides: Sequence[int], g_pad: int,
                          part_lanes: Sequence[torch.Tensor] = (),
                          float_lanes: Sequence[torch.Tensor] = ()
                          ) -> Tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor, torch.Tensor]:
    """Dense group table over key = clip(Σ ids_c · stride_c, 0, g_pad-1).

    Returns (count int32 [g_pad], psums int32 [L, g_pad], csums float64
    [J, g_pad], matched int32 scalar), L = all part-lane rows, J = float
    lanes (float64 [P] each)."""
    padded, device = mask.shape[0], mask.device
    _check_lane(mask, "mask", padded, device, (torch.uint8,))
    if not 1 <= len(key_lanes) <= _MAX_KEYS or \
            len(strides) != len(key_lanes):
        raise ValueError(f"{len(key_lanes)} key lanes / {len(strides)} "
                         f"strides (1..{_MAX_KEYS} keys)")
    for c, lane in enumerate(key_lanes):
        _check_lane(lane, f"key lane {c}", padded, device, _ID_DTYPES)
    rows = _part_rows(part_lanes)
    for k, r in enumerate(rows):
        _check_lane(r, f"part lane {k}", padded, device, (torch.int8,))
    for j, f in enumerate(float_lanes):
        _check_lane(f, f"float lane {j}", padded, device, (torch.float64,))
    if len(rows) > _MAX_PARTS or len(float_lanes) > _MAX_FLOATS:
        raise ValueError(f"{len(rows)} part / {len(float_lanes)} float "
                         "lanes over the kernel's limits")
    if not 1 <= g_pad <= INT32_MAX or padded > DENSE_ROWS_LIMIT:
        raise ValueError(f"g_pad {g_pad} / {padded} rows outside the dense "
                         "int32 regime")
    if device.type == "cpu":
        return dense_group_aggregate_plain(mask, key_lanes, strides, g_pad,
                                           part_lanes, float_lanes)
    count = torch.zeros(g_pad, dtype=torch.int32, device=device)
    psums = torch.zeros(len(rows), g_pad, dtype=torch.int32, device=device)
    csums = torch.zeros(len(float_lanes), g_pad, dtype=torch.float64,
                        device=device)
    matched = torch.zeros((), dtype=torch.int32, device=device)
    _launch("dense_group_aggregate", device, mask.data_ptr(),
            _ptrs(key_lanes), _ints([t.element_size() for t in key_lanes]),
            _ints(strides), len(key_lanes), _ptrs(rows), len(rows),
            _ptrs(float_lanes), len(float_lanes), padded, int(g_pad),
            count.data_ptr(), psums.data_ptr(), csums.data_ptr(),
            matched.data_ptr())
    return count, psums, csums, matched


def dense_group_aggregate_plain(mask, key_lanes, strides, g_pad: int,
                                part_lanes=(), float_lanes=()):
    """Plain PyTorch K3: int32 key arithmetic, then index_add_ of the
    matched rows."""
    m = mask.bool()
    device = mask.device
    key = torch.zeros(mask.shape[0], dtype=torch.int32, device=device)
    for lane, s in zip(key_lanes, strides):
        key += lane.to(torch.int32) * int(s)
    key = key.clamp(0, g_pad - 1)[m].long()
    count = torch.zeros(g_pad, dtype=torch.int32, device=device)
    count.index_add_(0, key, torch.ones_like(key, dtype=torch.int32))
    rows = _part_rows(part_lanes)
    psums = torch.zeros(len(rows), g_pad, dtype=torch.int32, device=device)
    for k, r in enumerate(rows):
        psums[k].index_add_(0, key, r[m].to(torch.int32))
    csums = torch.zeros(len(float_lanes), g_pad, dtype=torch.float64,
                        device=device)
    for j, f in enumerate(float_lanes):
        csums[j].index_add_(0, key, f[m].to(torch.float64))
    return count, psums, csums, m.sum(dtype=torch.int32)


# ---------------------------------------------------------------------------
# Whole-plan dispatch
# ---------------------------------------------------------------------------


def _is_parts_agg(spec) -> bool:
    fname, _col, source, extra = spec
    return fname in ("sum", "avg") and source == "sv" and \
        isinstance(extra, tuple) and extra[0] == "parts"


def run_segment_kernel(padded: int, filter_spec, agg_specs, group_spec,
                       select_spec, cols: Dict[str, torch.Tensor], params,
                       num_docs: int, device=None) -> Dict[str, torch.Tensor]:
    """One segment plan: K1, then K2 (aggregation) or K3 (group-by).

    Returns the device outputs under the JAX package's names
    (stats.num_docs_matched, agg{i}, agg{i}.parts, agg{i}.count,
    group.count, gagg{i}.psums, gagg{i}.csums). `device` is used only
    when no lane is read at all."""
    if select_spec is not None:
        raise ValueError("selection is not a kernel of this slice")
    if cols:
        device = next(iter(cols.values())).device
    mask = filter_mask(padded, filter_spec, cols, params, num_docs, device)
    outs: Dict[str, torch.Tensor] = {}
    if group_spec is not None:
        gcols, strides, g_pad, gaggs, kmax = group_spec
        if kmax:
            raise ValueError("compacted group specs (kmax > 0) are a TPU "
                             "strategy this port does not take")
        for _c, gkind, _off, _card in gcols:
            if gkind != "ids":
                raise ValueError(f"group key kind {gkind}")
        parts, slots, floats, fslots = [], {}, [], {}
        for i, (fname, col, source, extra) in enumerate(gaggs):
            if fname == "count":
                continue
            strategy = extra[0] if isinstance(extra, tuple) else None
            if fname not in ("sum", "avg") or strategy not in ("psums",
                                                               "csums"):
                raise ValueError(f"group aggregation {fname}/{strategy}")
            if strategy == "psums":
                pl = cols[f"{col}.parts"]
                slots[i] = (sum(p.shape[0] for p in parts), pl.shape[0])
                parts.append(pl)
            else:
                lane = cols[f"{col}.vlane" if source == "sv"
                            else f"{col}.raw"]
                fslots[i] = len(floats)
                floats.append(lane.to(sum_dtype()))
        keys = [cols[f"{c}.ids"] for c, *_ in gcols]
        count, psums, csums, matched = dense_group_aggregate(
            mask, keys, strides, g_pad, parts, floats)
        outs["stats.num_docs_matched"] = matched
        outs["group.count"] = count
        for i, (s0, n_p) in slots.items():
            outs[f"gagg{i}.psums"] = psums[s0:s0 + n_p]
        for i, j in fslots.items():
            outs[f"gagg{i}.csums"] = csums[j]
        return outs
    parts = []
    for spec in agg_specs:
        if _is_parts_agg(spec):
            parts.append(cols[f"{spec[1]}.parts"])
        elif spec[0] != "count":
            raise ValueError(f"aggregation spec {spec}")
    sums = masked_part_sums(mask, parts)
    count = sums[-1]
    outs["stats.num_docs_matched"] = count
    off = 0
    for i, spec in enumerate(agg_specs):
        if spec[0] == "count":
            outs[f"agg{i}"] = count
        else:
            n_p = cols[f"{spec[1]}.parts"].shape[0]
            outs[f"agg{i}.parts"] = sums[off:off + n_p]
            outs[f"agg{i}.count"] = count
            off += n_p
    return outs
