"""Fixed-fan-in row gather: the port of the K1–K3 prototypes of
`scripts/scatter_pallas_proto.py`.

    out[p, :] = Σ_{l < L} tw[p, l] · src[tsrc[p, l], :]

The same op as `core.gather_rows` (the composed transpose of one pointing,
window rows → patch rows), read from a padded fixed-fan-in table
``tsrc / tw [Pp, L]`` (every row padded to the largest tap count L, padded
taps ``tsrc = 0``, ``tw = 0``) instead of CSR row pointers.  Rows are
``W`` floats, contiguous: ``src [n_src, W]`` → ``out [P, W]``.

* `build_fixed_fanin_plan` — the prototype's host prep
  (`scatter_pallas_proto.py:74-93`): zero-weight taps dropped, taps in COO
  order within a row, P padded to a multiple of `tp` with zero-weight rows,
  the per-row tap count `cnt` (K2) and the pre-scaled source offsets
  ``tsrc · ld`` (K3).
* `gather_fixed_{k1,k2,k3}_reference` — plain torch versions: a loop over
  the taps in table order (no ``[P, L, W]`` temporary).
* `gather_fixed_{k1,k2,k3}_cuda` — the hand-written kernels
  (``csrc/gather_fixed.cu``), built with nvcc at first use; each counts its
  launches in `launches_k1` / `launches_k2` / `launches_k3`.
* `gather_fixed_{k1,k2,k3}` — the dispatch: a CPU tensor takes the plain
  version, a CUDA tensor launches the kernel or raises.  Never a fallback.

K1 sums all L taps of every row (zero taps included), K2 exactly ``cnt[p]``
taps, K3 all L taps of four rows at a time from the pre-scaled offsets.
K1 and K3 multiply the padded taps by ``src[0]``: a non-finite ``src[0]``
turns their rows to NaN, as the TPU prototypes' do.  None of the three is
on a solve path of the port (the CSR kernel of `core.gather_rows` is); the
entry point that runs them is `scripts/torch_scatter_proto.py`.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

MAX_L = 8  # K1 / K3's static fan-in instances (every flagship band has L = 7)
UNROLL = 4  # rows per thread in K3

launches_k1 = 0  # kernel launches since the last reset_launches()
launches_k2 = 0
launches_k3 = 0


def reset_launches() -> None:
    global launches_k1, launches_k2, launches_k3
    launches_k1 = launches_k2 = launches_k3 = 0


@dataclass(frozen=True)
class FixedFaninPlan:
    """Padded taps of a row gather, as NumPy arrays (host) or tensors (device).

    tsrc: int32 [Pp, L] source rows; tw: float [Pp, L] weights (0 on padded
    taps and rows); cnt: int32 [Pp] taps per row; tsrc_s: int32 [Pp, L] the
    source offsets ``tsrc · ld`` in floats (K3); n_rows: P, the rows of the
    output; n_src: source row count; ld: the source's row stride in floats."""

    tsrc: Any
    tw: Any
    cnt: Any
    tsrc_s: Any
    n_rows: int
    n_src: int
    ld: int

    @property
    def L(self) -> int:
        return int(self.tsrc.shape[1])

    @property
    def n_padded(self) -> int:
        return int(self.tsrc.shape[0])

    @property
    def nnz(self) -> int:
        return int(self.cnt.sum())

    def to(self, device, dtype) -> "FixedFaninPlan":
        """Tensors on `device`; weights in `dtype`, indices int32."""
        def t(a, dt):
            return torch.as_tensor(a).to(device=device, dtype=dt).contiguous()

        return FixedFaninPlan(t(self.tsrc, torch.int32), t(self.tw, dtype),
                              t(self.cnt, torch.int32), t(self.tsrc_s, torch.int32),
                              int(self.n_rows), int(self.n_src), int(self.ld))


def build_fixed_fanin_plan(csrc, cw, cdst, n_rows: int, n_src: int, tp: int = 512,
                           *, ld: int) -> FixedFaninPlan:
    """COO taps (source row, weight, destination row) → padded [Pp, L] plan.

    `ld` is the row stride of the source in floats (its width W for a
    contiguous ``[n_src, W]``); K3 reads ``tsrc · ld`` as int32, so
    ``n_src · ld`` must stay below 2³¹."""
    if tp <= 0 or tp % UNROLL:
        raise ValueError(f"tp={tp} must be a positive multiple of {UNROLL} (K3's row groups)")
    if n_src * ld >= 2**31:
        raise ValueError(f"n_src·ld = {n_src}·{ld} overflows K3's int32 offsets")
    csrc = np.asarray(csrc, np.int64).reshape(-1)
    cw = np.asarray(cw).reshape(-1)
    cdst = np.asarray(cdst, np.int64).reshape(-1)
    nz = cw != 0
    csrc, cw, cdst = csrc[nz], cw[nz], cdst[nz]
    if csrc.size and (csrc.min() < 0 or csrc.max() >= n_src or cdst.min() < 0
                      or cdst.max() >= n_rows):
        raise ValueError("fixed-fan-in taps out of bounds")
    order = np.argsort(cdst, kind="stable")  # COO order kept within a row
    csrc, cw, cdst = csrc[order], cw[order], cdst[order]
    seg = np.bincount(cdst, minlength=n_rows)
    L = max(1, int(seg.max())) if seg.size else 1
    starts = np.concatenate([[0], np.cumsum(seg)])
    k = np.arange(cdst.size) - starts[cdst]  # tap position within its row
    n_padded = -(-n_rows // tp) * tp
    tsrc = np.zeros((n_padded, L), np.int32)
    tw = np.zeros((n_padded, L), cw.dtype)
    tsrc[cdst, k] = csrc
    tw[cdst, k] = cw
    cnt = np.zeros((n_padded,), np.int32)
    cnt[:n_rows] = seg
    return FixedFaninPlan(tsrc, tw, cnt, (tsrc.astype(np.int64) * ld).astype(np.int32),
                          int(n_rows), int(n_src), int(ld))


# ---------------------------------------------------------------------------
# plain versions


def gather_fixed_k1_reference(src: torch.Tensor, plan: FixedFaninPlan) -> torch.Tensor:
    """All L taps of every row, in table order (zero taps included)."""
    n = plan.n_rows
    tsrc, tw = plan.tsrc[:n].long(), plan.tw[:n]
    acc = tw[:, 0, None] * src.index_select(0, tsrc[:, 0])
    for l in range(1, plan.L):
        acc = acc + tw[:, l, None] * src.index_select(0, tsrc[:, l])
    return acc


def gather_fixed_k2_reference(src: torch.Tensor, plan: FixedFaninPlan) -> torch.Tensor:
    """Exactly ``cnt[p]`` taps of row p, in table order."""
    n = plan.n_rows
    tsrc, tw, cnt = plan.tsrc[:n].long(), plan.tw[:n], plan.cnt[:n]
    acc = src.new_zeros((n, src.shape[1]))
    for l in range(plan.L):
        r = torch.nonzero(cnt > l).squeeze(1)
        acc.index_add_(0, r, tw[r, l, None] * src.index_select(0, tsrc[r, l]))
    return acc


def gather_fixed_k3_reference(src: torch.Tensor, plan: FixedFaninPlan) -> torch.Tensor:
    """K1's sum, read through the pre-scaled offsets ``tsrc · ld``."""
    if src.dim() != 2 or not src.is_contiguous() or src.shape[1] != plan.ld:
        raise ValueError(f"src {tuple(src.shape)} is not a contiguous [n_src, ld={plan.ld}]")
    n = plan.n_rows
    off, tw = plan.tsrc_s[:n].long(), plan.tw[:n]
    flat = src.reshape(-1)
    cols = torch.arange(src.shape[1], device=src.device)
    acc = tw[:, 0, None] * flat[off[:, 0, None] + cols]
    for l in range(1, plan.L):
        acc = acc + tw[:, l, None] * flat[off[:, l, None] + cols]
    return acc


# ---------------------------------------------------------------------------
# the kernels

_fns = None


def load_kernels():
    """Build (first call) and bind the three kernels' C entry points."""
    global _fns
    if _fns is None:
        from ._build import build_library

        lib = build_library("gather_fixed", ["gather_fixed.cu"])
        k1, k2, k3 = lib.surfh_gather_fixed_k1_f32, lib.surfh_gather_fixed_k2_f32, lib.surfh_gather_fixed_k3_f32
        k1.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        k2.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        k3.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        for fn in (k1, k2, k3):
            fn.restype = ctypes.c_int
        _fns = (k1, k2, k3)
    return _fns


def _check(src: torch.Tensor, plan: FixedFaninPlan, what: str, static_l: bool = True) -> None:
    if not src.is_cuda:
        raise ValueError(f"{what} needs a CUDA tensor")
    if src.dtype != torch.float32 or plan.tw.dtype != torch.float32:
        raise TypeError(f"{what} is f32 only (src {src.dtype}, tw {plan.tw.dtype})")
    if src.dim() != 2 or src.shape[0] != plan.n_src:
        raise ValueError(f"{what}: src {tuple(src.shape)} is not [n_src={plan.n_src}, W]")
    if not src.is_contiguous():
        raise ValueError(f"{what} needs a contiguous src")
    for name in ("tsrc", "tw", "cnt", "tsrc_s"):
        a = getattr(plan, name)
        if a.device != src.device or not a.is_contiguous():
            raise ValueError(f"plan.{name} must be contiguous on {src.device}")
    if plan.tsrc.dtype != torch.int32 or plan.cnt.dtype != torch.int32 or plan.tsrc_s.dtype != torch.int32:
        raise TypeError("plan indices must be int32")
    if static_l and plan.L > MAX_L:
        raise ValueError(f"{what}: fan-in L={plan.L} > {MAX_L}, the kernel's largest static L")


def _launch(fn, args, src: torch.Tensor, what: str) -> None:
    with torch.cuda.device(src.device):
        stream = torch.cuda.current_stream(src.device).cuda_stream
        err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"{what} launch failed: cudaError {err}")


def gather_fixed_k1_cuda(src: torch.Tensor, plan: FixedFaninPlan) -> torch.Tensor:
    """K1: f32 src [n_src, W] → [P, W], all L taps per row, on the current stream."""
    _check(src, plan, "gather_fixed K1 kernel")
    out = torch.empty((plan.n_rows, src.shape[1]), device=src.device, dtype=torch.float32)
    _launch(load_kernels()[0], (src.data_ptr(), plan.tsrc.data_ptr(), plan.tw.data_ptr(),
                                out.data_ptr(), plan.n_rows, plan.L, int(src.shape[1])),
            src, "gather_fixed K1 kernel")
    global launches_k1
    launches_k1 += 1
    return out


def gather_fixed_k2_cuda(src: torch.Tensor, plan: FixedFaninPlan) -> torch.Tensor:
    """K2: f32 src [n_src, W] → [P, W], ``cnt[p]`` taps per row, on the current stream."""
    _check(src, plan, "gather_fixed K2 kernel", static_l=False)
    out = torch.empty((plan.n_rows, src.shape[1]), device=src.device, dtype=torch.float32)
    _launch(load_kernels()[1], (src.data_ptr(), plan.tsrc.data_ptr(), plan.tw.data_ptr(),
                                plan.cnt.data_ptr(), out.data_ptr(), plan.n_rows, plan.L,
                                int(src.shape[1])),
            src, "gather_fixed K2 kernel")
    global launches_k2
    launches_k2 += 1
    return out


def gather_fixed_k3_cuda(src: torch.Tensor, plan: FixedFaninPlan) -> torch.Tensor:
    """K3: f32 src [n_src, W] → [P, W], four rows per thread from the
    offsets ``tsrc · ld`` (``ld`` must be W), on the current stream."""
    _check(src, plan, "gather_fixed K3 kernel")
    if src.shape[1] != plan.ld:
        raise ValueError(f"gather_fixed K3 kernel: src width {src.shape[1]} is not the plan's ld={plan.ld}")
    if plan.n_padded % UNROLL or plan.n_padded < plan.n_rows:
        raise ValueError(f"gather_fixed K3 kernel: {plan.n_padded} padded rows are not "
                         f"a multiple of {UNROLL} covering P={plan.n_rows}")
    out = torch.empty((plan.n_rows, src.shape[1]), device=src.device, dtype=torch.float32)
    _launch(load_kernels()[2], (src.data_ptr(), plan.tsrc_s.data_ptr(), plan.tw.data_ptr(),
                                out.data_ptr(), plan.n_rows, plan.L, int(src.shape[1])),
            src, "gather_fixed K3 kernel")
    global launches_k3
    launches_k3 += 1
    return out


def _dispatch(kernel, plain, src: torch.Tensor, plan: FixedFaninPlan, what: str) -> torch.Tensor:
    if src.is_cuda:
        return kernel(src, plan)
    if src.device.type == "cpu":
        return plain(src, plan)
    raise ValueError(f"{what}: unsupported device {src.device}")


def gather_fixed_k1(src: torch.Tensor, plan: FixedFaninPlan) -> torch.Tensor:
    """Dispatch: plain version for a CPU tensor, the kernel for a CUDA one."""
    return _dispatch(gather_fixed_k1_cuda, gather_fixed_k1_reference, src, plan, "gather_fixed_k1")


def gather_fixed_k2(src: torch.Tensor, plan: FixedFaninPlan) -> torch.Tensor:
    """Dispatch: plain version for a CPU tensor, the kernel for a CUDA one."""
    return _dispatch(gather_fixed_k2_cuda, gather_fixed_k2_reference, src, plan, "gather_fixed_k2")


def gather_fixed_k3(src: torch.Tensor, plan: FixedFaninPlan) -> torch.Tensor:
    """Dispatch: plain version for a CPU tensor, the kernel for a CUDA one."""
    return _dispatch(gather_fixed_k3_cuda, gather_fixed_k3_reference, src, plan, "gather_fixed_k3")
