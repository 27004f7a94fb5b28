"""The criterion's normal with the separated prior, in one pass:

    out = µ_s·h + µ_r·((((4·x − x[i−1]) − x[i+1]) − x[j−1]) − x[j+1])

over [B, H, W] maps or cubes, the indices circular within each [H, W]
plane: Q x = µ_s·HᵗH x + µ_r·DᵀD x given h = HᵗH x
(`solvers.criterion.QuadCriterion_MRS.normal_op`, which sends every
float32 x on the card here).

`normal_prior_cuda` is the hand-written kernel (``csrc/normal_prior.cu``),
built with nvcc at first use and counted in `launches`: the same float32
operations in the same order as the plain spelling,
``mu_s * h + mu_r * solvers.criterion.dtd_separated(x)`` (twelve kernels or
more on the card), so it equals it bit for bit; the µ's are 0-d tensors on
the card, read there (no host read).  It launches or raises: on the CPU,
float64, strided tensors, and rows wider than `launch_rows` fits (3972).
"""

from __future__ import annotations

import ctypes

import torch

THREADS, GROUPS = 256, 8  # a block's threads and the float4 groups each owns (csrc/normal_prior.cu)
STRIP_FLOATS = THREADS * GROUPS * 4 - 3  # a block's strip of rows, with its ragged ends
SMEM_FLOATS = 48 * 1024 // 4  # the x window of rows + 2 rows, skewed one float in 32

launches = 0  # kernel launches since the last reset_launches()


def reset_launches() -> None:
    global launches
    launches = 0


def launch_rows(h: int, w: int) -> int:
    """The most rows of an [h, w] plane one block takes: at most h, its
    strip at most `STRIP_FLOATS` floats and its window (the strip and a row
    above and below, one float in 32 of skew) within `SMEM_FLOATS`; 0 where
    not even one row fits (w above 3972)."""
    if h < 1 or w < 1:
        return 0
    rows = min(h, STRIP_FLOATS // w)
    while rows >= 1 and (rows + 2) * w + (rows + 2) * w // 32 > SMEM_FLOATS:
        rows -= 1
    return max(rows, 0)


_fn = None


def load_kernel():
    """Build (first call) and bind the kernel's C entry point."""
    global _fn
    if _fn is None:
        from ._build import build_library

        fn = build_library("normal_prior", ["normal_prior.cu"]).surfh_normal_prior_f32
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_longlong] + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def normal_prior_cuda(x: torch.Tensor, h: torch.Tensor, mu_s: torch.Tensor,
                      mu_r: torch.Tensor) -> torch.Tensor:
    """The kernel on the current stream: a new [B, H, W] float32 tensor,
    each block on `launch_rows` rows of a plane."""
    if not x.is_cuda:
        raise ValueError("normal_prior kernel needs CUDA tensors")
    for name, t in (("x", x), ("h", h), ("mu_s", mu_s), ("mu_r", mu_r)):
        if not isinstance(t, torch.Tensor) or t.device != x.device:
            raise ValueError(f"normal_prior kernel: {name} must be a tensor on {x.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"normal_prior kernel is f32 only ({name} is {t.dtype})")
    if x.dim() != 3 or h.shape != x.shape:
        raise ValueError(f"normal_prior kernel: x {tuple(x.shape)} and h {tuple(h.shape)} "
                         "are not one [B, H, W] shape")
    if not (x.is_contiguous() and h.is_contiguous()):
        raise ValueError("normal_prior kernel needs contiguous x and h")
    if mu_s.dim() != 0 or mu_r.dim() != 0:
        raise ValueError("normal_prior kernel takes the µ's as 0-d tensors")
    nb, hgt, w = (int(s) for s in x.shape)
    rows = launch_rows(hgt, w)
    if rows < 1 and x.numel():
        raise ValueError(f"normal_prior kernel: a row of {w} floats does not fit a block's window")
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = load_kernel()(x.data_ptr(), h.data_ptr(), mu_s.data_ptr(), mu_r.data_ptr(),
                            out.data_ptr(), nb, hgt, w, rows, stream)
    if err != 0:
        raise RuntimeError(f"normal_prior kernel launch failed: cudaError {err}")
    global launches
    launches += 1
    return out

