"""CSR row gather: the port of `surfh_tpu/core/scatter_pallas.py`.

    out[r, :] = Σ_{k ∈ [row_ptr[r], row_ptr[r+1])} w[k] · src[idx[k], :]

One op carries both directions of the composed window stage: the forward
gather (patch pixels → slit-window outputs, C taps per output) and its
exact transpose (window outputs → patch pixels).  Rows are ``Q`` floats,
contiguous: ``src [n_src, Q]`` → ``out [n_rows, Q]``.

* `build_row_gather_plan` — host prep, as the reference's: drop zero-weight
  taps, stable-sort by destination, then CSR row pointers (variable tap
  count per row; no padded fan-in).
* `gather_rows_reference` — the plain torch version (gather + index_add_).
* `gather_rows_cuda` — the hand-written kernel (``csrc/gather_rows.cu``),
  built with nvcc at first use; counts its launches in `launches`.
  `gather_launch_shape` picks the kernel (narrow rows: a lane per column;
  wide rows: a group of lanes per row) and its shape from Q and the plan.
* `gather_rows` — the dispatch: a CPU tensor takes the plain version, a
  CUDA tensor launches the kernel or raises.  Never a fallback.  A source
  that autograd tracks (a derived adjoint's forward, under `torch.func.vjp`
  or `backward`) goes through `GatherRows`: the kernel writes a tensor
  autograd knows nothing of, which would give a zero or missing transpose.
* `gather_rows_op` — the same with a gradient (`GatherRows`): its backward
  is `gather_rows` on the transposed plan (`RowGatherPlan.t`, built once
  per plan and kept), so a derived adjoint runs the kernel both ways.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

launches = 0  # kernel launches since the last reset_launches()


def reset_launches() -> None:
    global launches
    launches = 0


# the wide-row kernel's instances (csrc/gather_rows.cu): floats of a row that
# one lane holds -> taps it loads before their FMAs, for rows of few taps;
# rows of many taps take _MANY_TAPS_SHAPE
_LANE_FLOATS = {8: 2, 16: 1, 24: 1}
_MANY_TAPS = 4.0  # taps per row from which taps in flight matter more than a row in one chunk
_MANY_TAPS_SHAPE = (4, 4)
_NARROW_TAPS = 4  # the narrow kernel's taps in flight


def gather_launch_shape(q: int, aligned: bool = True, taps_per_row: float = 1.0) -> tuple:
    """(vec, cols, taps, group) of a launch at row width `q`.

    vec: float4 columns (4) where `q` is a multiple of 4 and both base
    pointers are 16-byte `aligned`, else single floats (1).  Rows of at
    most 32 columns (the rank path's Q = 4R) go to the narrow kernel: a lane
    per column, group = q / vec, whole rows packed densely into warps.
    Wider rows (the W-plane path's Q = W) are owned by a group of lanes, the
    power of two ≤ 32 that covers the row.  cols is what one lane holds, 8,
    16 or 24 floats — the least with which 32 lanes cover the row in one
    chunk (the most for rows wider than 768), so that a row's fixed chain
    of loads is paid once — and taps how many taps it loads at a time.
    Wide rows of many taps (the forward gathers: few rows, `taps_per_row`
    ≥ 4) take 4 floats and 4 taps, in chunks of 128 floats: they need taps
    and warps in flight more."""
    if q < 1:
        raise ValueError(f"row width {q} < 1")
    vec = 4 if q % 4 == 0 and aligned else 1
    nvec = q // vec
    if nvec <= 32:
        return vec, 1, _NARROW_TAPS, nvec
    if taps_per_row >= _MANY_TAPS:
        floats, taps = _MANY_TAPS_SHAPE
    else:
        floats = next((f for f in _LANE_FLOATS if f // vec * 32 >= nvec), max(_LANE_FLOATS))
        taps = _LANE_FLOATS[floats]
    cols = floats // vec
    group = 1
    while group < min(-(-nvec // cols), 32):
        group *= 2
    return vec, cols, taps, group


@dataclass(frozen=True)
class RowGatherPlan:
    """CSR taps of a row gather, as NumPy arrays (host) or tensors (device).

    row_ptr: int32 [n_rows + 1]; idx: int32 [nnz] source rows; w: float [nnz];
    dst: int32 [nnz] the destination row of each tap (the plain version's
    index_add_ target); n_src: source row count."""

    row_ptr: Any
    idx: Any
    w: Any
    dst: Any
    n_src: int

    @property
    def n_rows(self) -> int:
        return int(self.row_ptr.shape[0]) - 1

    @property
    def nnz(self) -> int:
        return int(self.idx.shape[0])

    @functools.cached_property
    def t(self) -> "RowGatherPlan":
        """The transposed plan (n_src rows reading these n_rows): every tap
        (source i → row r, weight w) as (r → i, w), stable-sorted by its new
        row; NumPy or tensors as this plan's, built at first use and kept."""
        if isinstance(self.idx, torch.Tensor):
            order = torch.sort(self.idx.long(), stable=True).indices
            dst = self.idx[order]
            counts = torch.bincount(dst.long(), minlength=self.n_src)
            row_ptr = torch.zeros(self.n_src + 1, dtype=torch.int64, device=self.idx.device)
            row_ptr[1:] = torch.cumsum(counts, 0)
            return RowGatherPlan(row_ptr.to(torch.int32), self.dst[order].contiguous(),
                                 self.w[order].contiguous(), dst.contiguous(), self.n_rows)
        return build_row_gather_plan(self.dst, self.w, self.idx, self.n_src, self.n_rows)

    def to(self, device, dtype) -> "RowGatherPlan":
        """Tensors on `device`; weights in `dtype`, indices int32."""
        def t(a, dt):
            return torch.as_tensor(a).to(device=device, dtype=dt).contiguous()

        return RowGatherPlan(t(self.row_ptr, torch.int32), t(self.idx, torch.int32),
                             t(self.w, dtype), t(self.dst, torch.int32), int(self.n_src))


def build_row_gather_plan(csrc, cw, cdst, n_dst: int, n_src: int) -> RowGatherPlan:
    """COO taps (source row, weight, destination row) → CSR plan (host)."""
    csrc = np.asarray(csrc, np.int64).reshape(-1)
    cw = np.asarray(cw).reshape(-1)
    cdst = np.asarray(cdst, np.int64).reshape(-1)
    nz = cw != 0
    csrc, cw, cdst = csrc[nz], cw[nz], cdst[nz]
    order = np.argsort(cdst, kind="stable")
    csrc, cw, cdst = csrc[order], cw[order], cdst[order]
    if csrc.size and (csrc.min() < 0 or csrc.max() >= n_src or cdst.max() >= n_dst):
        raise ValueError("row gather taps out of bounds")
    row_ptr = np.concatenate([[0], np.cumsum(np.bincount(cdst, minlength=n_dst))])
    return RowGatherPlan(row_ptr.astype(np.int32), csrc.astype(np.int32),
                         np.ascontiguousarray(cw), cdst.astype(np.int32), int(n_src))


def plan_from_gather_table(cidx, cw, n_src: int) -> RowGatherPlan:
    """Fixed-fan-in gather table cidx / cw [C, n_out] (output p reads
    cidx[c, p]) → CSR plan with n_out rows."""
    cidx = np.asarray(cidx)
    C, n_out = cidx.shape
    dst = np.tile(np.arange(n_out, dtype=np.int64), C)
    return build_row_gather_plan(cidx.reshape(-1), np.asarray(cw).reshape(-1), dst, n_out, n_src)


def gather_rows_reference(src: torch.Tensor, plan: RowGatherPlan) -> torch.Tensor:
    """Plain torch version: out = zeros.index_add_(dst, w · src[idx])."""
    contrib = src.index_select(0, plan.idx) * plan.w[:, None]
    out = src.new_zeros((plan.n_rows, src.shape[1]))
    return out.index_add_(0, plan.dst, contrib)


_fn = None


def load_kernel():
    """Build (first call) and bind the CUDA kernel's C entry point."""
    global _fn
    if _fn is None:
        from ._build import build_library

        lib = build_library("gather_rows", ["gather_rows.cu"])
        fn = lib.surfh_gather_rows_f32
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def gather_rows_cuda(src: torch.Tensor, plan: RowGatherPlan) -> torch.Tensor:
    """The CUDA kernel: f32 [n_src, Q] → [n_rows, Q] on the current stream."""
    if not src.is_cuda:
        raise ValueError("gather_rows_cuda needs a CUDA tensor")
    if src.dtype != torch.float32 or plan.w.dtype != torch.float32:
        raise TypeError(f"gather_rows kernel is f32 only (src {src.dtype}, w {plan.w.dtype})")
    if src.dim() != 2 or src.shape[0] != plan.n_src:
        raise ValueError(f"src shape {tuple(src.shape)} is not [n_src={plan.n_src}, Q]")
    if not src.is_contiguous():
        raise ValueError("gather_rows kernel needs a contiguous src")
    for name in ("row_ptr", "idx", "w"):
        a = getattr(plan, name)
        if a.device != src.device or not a.is_contiguous():
            raise ValueError(f"plan.{name} must be contiguous on {src.device}")
    if plan.row_ptr.dtype != torch.int32 or plan.idx.dtype != torch.int32:
        raise TypeError("plan indices must be int32")
    out = torch.empty((plan.n_rows, src.shape[1]), device=src.device, dtype=torch.float32)
    aligned = src.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0
    _launch(src, plan, out,
            *gather_launch_shape(int(src.shape[1]), aligned, plan.nnz / max(plan.n_rows, 1)))
    return out


def _launch(src, plan, out, vec: int, cols: int, taps: int, group: int) -> None:
    """Launch the kernel on checked operands in the shape `gather_launch_shape` gives."""
    fn = load_kernel()
    with torch.cuda.device(src.device):
        stream = torch.cuda.current_stream(src.device).cuda_stream
        err = fn(src.data_ptr(), plan.row_ptr.data_ptr(), plan.idx.data_ptr(), plan.w.data_ptr(),
                 out.data_ptr(), plan.n_rows, int(src.shape[1]), vec, cols, taps, group, stream)
    if err != 0:
        raise RuntimeError(f"gather_rows kernel launch failed: cudaError {err}")
    global launches
    launches += 1


def gather_rows(src: torch.Tensor, plan: RowGatherPlan) -> torch.Tensor:
    """Dispatch: plain version for a CPU tensor, the kernel for a CUDA one;
    a `src` that needs a gradient takes `GatherRows` (the same launch)."""
    if src.requires_grad and torch.is_grad_enabled():
        return GatherRows.apply(src, plan)
    if src.is_cuda:
        return gather_rows_cuda(src, plan)
    if src.device.type == "cpu":
        return gather_rows_reference(src, plan)
    raise ValueError(f"gather_rows: unsupported device {src.device}")


class GatherRows(torch.autograd.Function):
    """`gather_rows` with a gradient: the backward is the gather on the
    transposed plan (itself a `GatherRows`, so twice differentiable)."""

    @staticmethod
    def forward(src, plan):
        return gather_rows(src, plan)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.plan = inputs[1]

    @staticmethod
    def backward(ctx, grad):
        return GatherRows.apply(grad.contiguous(), ctx.plan.t), None


def gather_rows_op(src: torch.Tensor, plan: RowGatherPlan) -> torch.Tensor:
    """`gather_rows` through autograd (see `GatherRows`)."""
    return GatherRows.apply(src, plan)
