"""Bilinear gridding plans and the composed window gather.

Counterpart of `surfh_tpu/core/bilinear.py`.  Host side (NumPy copies of
the reference functions): the 4-corner bilinear plan per pointing and its
composition with the SRF box-sum and the slit windowing into ONE deduped
gather per pointing, with its exact transpose as sorted COO taps.

Device side: the plain torch spellings of that gather and its transpose,
in the reference's ``[..., n]`` layout.  They are the semantics the
row-gather kernel (`core.gather_rows`) is held to; the flagship path runs
the kernel on the row layout instead.

The plan gathers on tensors (reference `apply_plan`, `scatter_plan`,
`apply_transpose_plan`): a plan of ``[C, P]`` taps over planes
``[..., Na, Nb]`` is a row gather (`gather_rows.plan_from_gather_table`)
of the ``[Na·Nb, B]`` source rows, pixel-major with the B leading planes as
columns, so kernel #1 runs it on the card, and through its gradient the
exact adjoint too.  The host transpose plans (`transpose_plan`,
`csr_transpose_plan`) are NumPy copies of the reference's.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from .linop import torch_dtype
from .gather_rows import (RowGatherPlan, build_row_gather_plan, gather_rows_op,
                          gather_rows_reference, plan_from_gather_table)


@dataclass(frozen=True)
class BilinearPlan:
    """4 corner flat indices + weights for P target points.

    idx: int32 [4, P] flat indices into the raveled source grid (Na·Nb).
    w:   float [4, P] corner weights.
    shape: source grid shape (Na, Nb).
    """

    idx: np.ndarray
    w: np.ndarray
    shape: Tuple[int, int]

    @property
    def npoints(self) -> int:
        return self.idx.shape[1]


def _find_interval(grid: np.ndarray, values: np.ndarray):
    """Clamped interval search: i with grid[i] <= v < grid[i+1], i ∈ [0, n-2]
    (outside values extrapolate linearly)."""
    n = grid.shape[0]
    i = np.searchsorted(grid, values, side="right") - 1
    i = np.clip(i, 0, n - 2)
    t = (values - grid[i]) / (grid[i + 1] - grid[i])
    return i.astype(np.int64), t


def bilinear_plan(alpha_axis, beta_axis, points, fill_out_of_bounds: bool = False) -> BilinearPlan:
    """Plan interpolating the (α, β) grid at ``points`` [P, 2]; outside points
    extrapolate linearly, or with `fill_out_of_bounds` get zero weights (the
    local → cube direction of the data re-projections)."""
    alpha_axis = np.asarray(alpha_axis, np.float64)
    beta_axis = np.asarray(beta_axis, np.float64)
    pa = np.asarray(points[:, 0], np.float64)
    pb = np.asarray(points[:, 1], np.float64)
    ia, ta = _find_interval(alpha_axis, pa)
    ib, tb = _find_interval(beta_axis, pb)
    nb = beta_axis.shape[0]
    base = ia * nb + ib
    idx = np.stack([base, base + 1, base + nb, base + nb + 1])
    w = np.stack([(1 - ta) * (1 - tb), (1 - ta) * tb, ta * (1 - tb), ta * tb])
    if fill_out_of_bounds:
        oob = ((pa < alpha_axis[0]) | (pa > alpha_axis[-1])
               | (pb < beta_axis[0]) | (pb > beta_axis[-1]))
        w = np.where(oob[np.newaxis, :], 0.0, w)
    return BilinearPlan(idx.astype(np.int32), w, (alpha_axis.shape[0], nb))


def grid_points(alpha_coords: np.ndarray, beta_coords: np.ndarray) -> np.ndarray:
    """Stack 2-D coordinate fields into an [P, 2] point list (row-major)."""
    return np.vstack([alpha_coords.ravel(), beta_coords.ravel()]).T


@dataclass(frozen=True)
class ComposedWindowPlan:
    """Gridding → SRF box-sum → slit-window as one gather, for one pointing.

    idx / w: int32 / float [C, S·A·sb] taps into the FOV-bbox patch [ha·wb].
    csrc / cw / cdst: the exact transpose as sorted COO taps (destination
    ascending), cdst into the same patch.
    """

    idx: np.ndarray
    w: np.ndarray
    csrc: np.ndarray
    cw: np.ndarray
    cdst: np.ndarray
    out_shape: Tuple[int, int, int]
    patch_shape: Tuple[int, int]


def compose_window_plan(
    plan: BilinearPlan,
    a_starts,
    b_starts,
    box_offset: int,
    srf: int,
    n_aout: int,
    sb: int,
    local_shape: Tuple[int, int],
    bbox: Tuple[int, int, int, int],
    dtype=np.float64,
) -> ComposedWindowPlan:
    """window[s, a, b] = Σ_{j<srf} local[a0_s+off + a·srf + j, b0_s + b] with
    local[q] = Σ_c plan.w[c, q]·blurred[plan.idx[c, q]]; taps sharing a source
    pixel are merged and indices rebased to the bbox patch."""
    nla, nlb = local_shape
    a0_bb, b0_bb, ha, wb = bbox
    nb_g = plan.shape[1]
    S = len(a_starts)
    a_starts = np.asarray(a_starts, np.int64)
    b_starts = np.asarray(b_starts, np.int64)
    a_idx = (
        a_starts[:, None, None, None]
        + box_offset
        + np.arange(n_aout)[None, :, None, None] * srf
        + np.arange(srf)[None, None, None, :]
    )  # [S, A, 1, srf]
    b_idx = b_starts[:, None, None, None] + np.arange(sb)[None, None, :, None]
    q = (a_idx * nlb + b_idx).reshape(-1)  # [S·A·sb·srf] local flat indices
    C0 = plan.idx.shape[0]
    gidx = plan.idx[:, q].astype(np.int64)
    gw = plan.w[:, q].astype(dtype)
    # rebase to the bbox patch (zero-weight taps may fall outside — clip)
    rows = np.clip(gidx // nb_g - a0_bb, 0, ha - 1)
    cols = np.clip(gidx % nb_g - b0_bb, 0, wb - 1)
    pidx = rows * wb + cols
    n_out = S * n_aout * sb
    idx = pidx.reshape(C0, n_out, srf).transpose(0, 2, 1).reshape(C0 * srf, n_out)
    w = gw.reshape(C0, n_out, srf).transpose(0, 2, 1).reshape(C0 * srf, n_out)
    # merge duplicate taps per output, then compact to the max unique count
    order = np.argsort(idx, axis=0, kind="stable")
    si = np.take_along_axis(idx, order, axis=0)
    sw = np.take_along_axis(w, order, axis=0).copy()
    for k in range(si.shape[0] - 1):
        dup = si[k + 1] == si[k]
        sw[k + 1] = np.where(dup, sw[k + 1] + sw[k], sw[k + 1])
        sw[k] = np.where(dup, 0, sw[k])
    compact = np.argsort(sw == 0, axis=0, kind="stable")  # nonzero first
    si = np.take_along_axis(si, compact, axis=0)
    sw = np.take_along_axis(sw, compact, axis=0)
    c_max = max(1, int((sw != 0).sum(axis=0).max()))
    idx = np.where(sw[:c_max] != 0, si[:c_max], 0)
    w = sw[:c_max]
    # exact transpose as sorted COO over the same taps
    src = np.tile(np.arange(n_out, dtype=np.int64), idx.shape[0])
    dst = idx.reshape(-1)
    ww = w.reshape(-1)
    keep = ww != 0
    src, dst, ww = src[keep], dst[keep], ww[keep]
    order = np.argsort(dst, kind="stable")
    return ComposedWindowPlan(
        idx=idx.astype(np.int32),
        w=np.ascontiguousarray(w),
        csrc=src[order].astype(np.int32),
        cw=np.ascontiguousarray(ww[order]),
        cdst=dst[order].astype(np.int32),
        out_shape=(S, n_aout, sb),
        patch_shape=(ha, wb),
    )


def apply_composed_plan(cidx: torch.Tensor, cw: torch.Tensor, patch_flat: torch.Tensor) -> torch.Tensor:
    """patch_flat [..., ha·wb] → windows [..., S·A·sb]: gather all C taps,
    then the weighted sum over them."""
    g = patch_flat[..., cidx.long()]  # [..., C, n_out]
    return (g * cw).sum(dim=-2)


def apply_composed_plan_t(csrc, cw, cdst, values: torch.Tensor, patch_pixels: int) -> torch.Tensor:
    """Exact transpose: values [..., S·A·sb] → patch [..., ha·wb] (index_add_
    over the COO taps)."""
    contrib = values[..., csrc.long()] * cw
    out = values.new_zeros(values.shape[:-1] + (patch_pixels,))
    return out.index_add_(-1, cdst.long(), contrib)


# ---------------------------------------------------------------------------
# plan gathers on tensors (reference bilinear.py:138-280)


def row_plan(plan_idx, plan_w, n_src: int, device, dtype) -> RowGatherPlan:
    """Gather table [C, P] (host arrays) over `n_src` source pixels → the
    row gather's CSR plan on `device` (weights in `dtype`)."""
    return plan_from_gather_table(np.asarray(plan_idx), np.asarray(plan_w), n_src).to(device, dtype)


def gather_planes(plan: RowGatherPlan, planes: torch.Tensor, plain: bool = False) -> torch.Tensor:
    """planes [..., Na, Nb] (Na·Nb = plan.n_src) → [..., plan.n_rows]
    through the row gather, differentiable; `plain` takes the plain torch
    version (autograd differentiates it) instead of kernel #1."""
    lead = planes.shape[:-2]
    src = planes.reshape(-1, plan.n_src).T.contiguous()  # [Na·Nb, B]
    out = gather_rows_reference(src, plan) if plain else gather_rows_op(src, plan)
    return out.T.reshape(lead + (plan.n_rows,))


def apply_plan(plan_idx, plan_w, cube: torch.Tensor) -> torch.Tensor:
    """Gather-interpolate every plane of `cube` [..., Na, Nb] at the plan's
    points → [..., P]; the gradient is the exact scatter-add adjoint."""
    n_src = int(cube.shape[-2] * cube.shape[-1])
    return gather_planes(row_plan(plan_idx, plan_w, n_src, cube.device, cube.dtype), cube)


def scatter_plan(plan_idx, plan_w, values: torch.Tensor, grid_shape: Tuple[int, int]) -> torch.Tensor:
    """Exact adjoint of :func:`apply_plan`: values [..., P] → [..., Na, Nb]
    (the gather on the transposed plan)."""
    na, nb = grid_shape
    plan = row_plan(plan_idx, plan_w, na * nb, values.device, values.dtype).t
    lead = values.shape[:-1]
    return gather_planes(plan, values.reshape(lead + (1, -1))).reshape(lead + (na, nb))


@dataclass(frozen=True)
class TransposePlan:
    """Padded gather form of a plan's adjoint: per grid pixel up to C
    (target point, weight) pairs, zero-padded.

    idx: int32 [C, Na·Nb] indices into the P target points; w: float
    [C, Na·Nb] weights (0 padding); shape: the grid (Na, Nb)."""

    idx: np.ndarray
    w: np.ndarray
    shape: Tuple[int, int]


def transpose_plan(plan: BilinearPlan) -> TransposePlan:
    """Build the padded gather-form transpose of a plan (host, once)."""
    ncorner, P = plan.idx.shape
    N = plan.shape[0] * plan.shape[1]
    src = np.tile(np.arange(P, dtype=np.int64), ncorner)
    dst = plan.idx.reshape(-1).astype(np.int64)
    w = plan.w.reshape(-1)
    keep = w != 0
    src, dst, w = src[keep], dst[keep], w[keep]
    order = np.argsort(dst, kind="stable")
    src, dst, w = src[order], dst[order], w[order]
    counts = np.bincount(dst, minlength=N)
    C = int(counts.max()) if counts.size else 1
    starts = np.concatenate([[0], np.cumsum(counts)])[:-1]
    idx_arr = np.zeros((C, N), np.int32)
    w_arr = np.zeros((C, N), plan.w.dtype)
    present = np.flatnonzero(counts)
    for c in range(C):
        sel = present[counts[present] > c]
        idx_arr[c, sel] = src[starts[sel] + c]
        w_arr[c, sel] = w[starts[sel] + c]
    return TransposePlan(idx_arr, w_arr, plan.shape)


@dataclass(frozen=True)
class CSRTransposePlan:
    """Sorted-COO form of a plan's adjoint: per (corner, point) tap a
    (source point, weight, destination pixel) triple, destination ascending.

    src: int32 [M]; w: float [M]; dst: int32 [M]; shape: the grid (Na, Nb)."""

    src: np.ndarray
    w: np.ndarray
    dst: np.ndarray
    shape: Tuple[int, int]


def csr_transpose_plan(plan: BilinearPlan) -> CSRTransposePlan:
    """Build the sorted-COO transpose of a plan (host, once)."""
    ncorner, P = plan.idx.shape
    src = np.tile(np.arange(P, dtype=np.int64), ncorner)
    dst = plan.idx.reshape(-1).astype(np.int64)
    w = plan.w.reshape(-1)
    keep = w != 0
    src, dst, w = src[keep], dst[keep], w[keep]
    order = np.argsort(dst, kind="stable")
    return CSRTransposePlan(src[order].astype(np.int32), w[order], dst[order].astype(np.int32),
                            plan.shape)


def apply_transpose_plan(tplan, values: torch.Tensor, dtype=None) -> torch.Tensor:
    """Exact adjoint of :func:`apply_plan` from either transpose-plan form:
    values [..., P] → [..., Na, Nb], one row gather, in `dtype` (NumPy or
    torch; None: the values' own)."""
    if dtype is not None:
        values = values.to(torch_dtype(dtype))
    na, nb = tplan.shape
    n_pts = int(values.shape[-1])
    if isinstance(tplan, CSRTransposePlan):
        plan = build_row_gather_plan(tplan.src, tplan.w, tplan.dst, na * nb, n_pts)
    else:
        plan = plan_from_gather_table(tplan.idx, tplan.w, n_pts)
    plan = plan.to(values.device, values.dtype)
    lead = values.shape[:-1]
    return gather_planes(plan, values.reshape(lead + (1, -1))).reshape(lead + (na, nb))
