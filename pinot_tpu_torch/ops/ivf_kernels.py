"""IVF training and assignment kernels: K10 ivf_assign, K11 ivf_recenter.

Counterpart of pinot_tpu/ops/ivf_kernels.py. The JAX module builds three
jitted kernels: assign (`build_ivf_assign_kernel`, :26), one Lloyd step
(`build_ivf_train_kernel`, :51) and the standalone probe select
(`build_ivf_probe_kernel`, :74). Here:

- assign is K10 `ivf_assign` (ops/csrc/ivf_assign.cu): the nearest live
  centroid of every row (ties to the lower id) and the squared distance
  to it, clamped to >= 0, 0 on padding rows; routes (IVF_ASSIGN_ROUTES,
  ivf_assign_route): "tensor" (the cross term in 3xTF32 on the tensor
  cores) or "simt" (f32 on the CUDA cores, the only one below 8 dims);
- the train step is K10 then K11 `ivf_recenter` (ops/csrc/ivf_recenter.cu):
  each centroid becomes the mean of its assigned rows, summed in an order
  the assignments alone fix (pieces of 64 rows in row order, then the
  pieces in order) with no float atomics, or keeps its prior where no row
  is assigned;
- the probe select is K9 (`kernels.ivf_select_probes`).

Beside each kernel is its plain PyTorch version, which the wrapper runs
for a tensor on the CPU, and only then. Training has no cross-backend bit
contract (the JAX module says so): the JAX kernels sum with matmuls in
XLA's order, K10 and K11 in their own. What holds is a per-backend
contract: the same rows and seed give the same codebook bytes on every
run, and on well-separated clusters the assignments equal the JAX
kernel's.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from pinot_tpu_torch.ops import kernels
from pinot_tpu_torch.ops.kernels import _check_vec, _launch, \
    _scratch_words


def _check_block(data: torch.Tensor, centroids: torch.Tensor) -> int:
    dim_pad = _check_vec(data, "rows", (2,))
    if _check_vec(centroids, "centroids", (2,)) != dim_pad or \
            centroids.device != data.device:
        raise ValueError(f"centroids {tuple(centroids.shape)} on "
                         f"{centroids.device} do not match rows "
                         f"{tuple(data.shape)} on {data.device}")
    return dim_pad


#: K10's routes: "tensor" (assign_tc_kernel: mma.sync in 3xTF32) where
#: ivf_assign_route allows it, else "simt" (assign_kernel: f32 FMAs)
IVF_ASSIGN_ROUTES = ("tensor", "simt")
#: the tensor route's k-step: dim_pad below it stays on the simt route
TENSOR_MIN_DIM = 8


def ivf_assign_route(data: torch.Tensor, centroids: torch.Tensor) -> str:
    """K10's route for these operands: "tensor" where dim_pad is at least
    TENSOR_MIN_DIM and both matrices start 16-byte aligned (its cp.async
    copies), else "simt". A host choice by shape, never by a failure."""
    if data.shape[1] < TENSOR_MIN_DIM or data.data_ptr() % 16 or \
            centroids.data_ptr() % 16:
        return "simt"
    return "tensor"


def ivf_assign(data: torch.Tensor, centroids: torch.Tensor, n_rows: int,
               n_centroids: int, route: Optional[str] = None,
               stats: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K10: (assign int32 [n], dist f32 [n]) for data f32 [n, dim_pad]
    against centroids f32 [c_pad, dim_pad], of which the first
    n_centroids are live; rows at or past n_rows are padding (dist 0). On
    the card `route` forces "tensor" or "simt" (None: ivf_assign_route's
    choice); "tensor" raises where that route cannot take the operands.
    `stats`, an int32 [2] on the card, gains what the tensor route's
    settling cost: the rows it settled with a second candidate's dot and
    the rows it settled by a scan of every live centroid."""
    if route not in (None, *IVF_ASSIGN_ROUTES):
        raise ValueError(f"K10 route {route!r}: one of tensor, simt or None")
    if stats is not None and (stats.dtype != torch.int32 or
                              stats.shape != (2,) or
                              stats.device != data.device):
        raise ValueError(f"stats must be an int32 [2] on {data.device}")
    dim_pad = _check_block(data, centroids)
    n, c_pad = data.shape[0], centroids.shape[0]
    if not 0 <= n_centroids <= c_pad or not 0 <= n_rows <= n:
        raise ValueError(f"n_centroids {n_centroids} / n_rows {n_rows}")
    picked = ivf_assign_route(data, centroids)
    if route is None:
        route = picked
    elif route == "tensor" and picked != "tensor":
        raise ValueError(f"K10's tensor route does not take dim_pad "
                         f"{dim_pad} or unaligned operands")
    device = data.device
    if device.type == "cpu":
        return ivf_assign_plain(data, centroids, n_rows, n_centroids)
    assign = torch.empty(n, dtype=torch.int32, device=device)
    dist = torch.empty(n, dtype=torch.float32, device=device)
    scratch = torch.empty(n + c_pad, dtype=torch.float32, device=device)
    _launch("ivf_assign", device, data.data_ptr(), n, dim_pad,
            centroids.data_ptr(), c_pad, int(n_centroids), int(n_rows),
            scratch.data_ptr(), assign.data_ptr(), dist.data_ptr(),
            int(route == "tensor"),
            None if stats is None else stats.data_ptr())
    kernels._count_node("ivf_assign", route)
    return assign, dist


def ivf_assign_plain(data: torch.Tensor, centroids: torch.Tensor,
                     n_rows: int, n_centroids: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch K10: the JAX kernel's formula, (row_n2 - 2 * cross) +
    cen_n2 with tree norms and a matmul cross term, masked to the live
    centroids, argmin (the first minimum), clamped, padding rows 0."""
    row_n2 = kernels.vec_tree_sum_plain(data * data)
    cen_n2 = kernels.vec_tree_sum_plain(centroids * centroids)
    d2 = row_n2[:, None] - 2.0 * (data @ centroids.T) + cen_n2[None, :]
    live = torch.arange(centroids.shape[0], device=data.device) < n_centroids
    d2 = torch.where(live[None, :], d2, float("inf"))
    assign = torch.argmin(d2, dim=1).to(torch.int32)
    rows = torch.arange(data.shape[0], device=data.device) < n_rows
    dist = torch.where(rows, d2.amin(dim=1).clamp_min(0.0),
                       0.0).to(torch.float32)
    return assign, dist


def ivf_recenter(data: torch.Tensor, assign: torch.Tensor, n_rows: int,
                 centroids: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """K11: (centroids f32 [c_pad, dim_pad], counts int32 [c_pad]): each
    centroid the mean of the rows r < n_rows assigned to it, or its prior
    (`centroids`) where none is."""
    dim_pad = _check_block(data, centroids)
    n, c_pad = data.shape[0], centroids.shape[0]
    if assign.dtype != torch.int32 or assign.shape != (n,) or \
            assign.device != data.device or not assign.is_contiguous():
        raise ValueError(f"assign must be a contiguous int32 [{n}] on "
                         f"{data.device}")
    if not 0 <= n_rows <= n:
        raise ValueError(f"n_rows {n_rows} outside [0, {n}]")
    device = data.device
    if device.type == "cpu":
        return ivf_recenter_plain(data, assign, n_rows, centroids)
    out = torch.empty_like(centroids)
    counts = torch.empty(c_pad, dtype=torch.int32, device=device)
    # the row order by centroid, its offsets and the pieces' partial sums
    scratch = torch.empty(_scratch_words(
        "ivf_recenter.cu", "pinot_ivf_recenter_scratch_words",
        [ctypes.c_longlong, ctypes.c_int, ctypes.c_int], int(n_rows),
        dim_pad, c_pad), dtype=torch.int32, device=device)
    _launch("ivf_recenter", device, data.data_ptr(), assign.data_ptr(),
            int(n_rows), dim_pad, centroids.data_ptr(), c_pad,
            out.data_ptr(), counts.data_ptr(), scratch.data_ptr())
    return out, counts


def ivf_recenter_plain(data: torch.Tensor, assign: torch.Tensor, n_rows: int,
                       centroids: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch K11: index_add_ of the live rows by assignment, then
    the means (sums / max(counts, 1)) where a centroid has rows."""
    c_pad = centroids.shape[0]
    a = assign[:n_rows].long()
    counts = torch.bincount(a, minlength=c_pad)[:c_pad]
    sums = torch.zeros_like(centroids).index_add_(0, a, data[:n_rows])
    fc = counts.to(torch.float32)[:, None]
    out = torch.where(fc > 0, sums / fc.clamp_min(1.0), centroids)
    return out, counts.to(torch.int32)


def ivf_train_step(data: torch.Tensor, centroids: torch.Tensor, n_rows: int,
                   n_centroids: int) -> Dict[str, torch.Tensor]:
    """One Lloyd step, K10 then K11, under the JAX kernel's output names:
    {"ivf.centroids": f32 [c_pad, dim_pad], "ivf.counts": int32 [c_pad]}."""
    assign, _dist = ivf_assign(data, centroids, n_rows, n_centroids)
    new_c, counts = ivf_recenter(data, assign, n_rows, centroids)
    return {"ivf.centroids": new_c, "ivf.counts": counts}


def ivf_probe_select(centroids: torch.Tensor, cvalid: torch.Tensor, q,
                     q_norm, metric: str, nprobe: int
                     ) -> Dict[str, torch.Tensor]:
    """The standalone probe select (K9) under the JAX kernel's names:
    {"ivf.probe": int32 [nprobe], "ivf.probe_ok": bool [nprobe]}."""
    probe, ok = kernels.ivf_select_probes(centroids, cvalid, q, q_norm,
                                          metric, nprobe)
    return {"ivf.probe": probe, "ivf.probe_ok": ok}
