"""Spectral blur + β-sum (the Sig·R operator) as plain GEMMs.

Counterpart of `surfh_tpu/core/wblur.py` (`wblur_sum_beta_batched`) and of
the channel adjoint's wblur_t GEMM (`surfh_tpu/models/channel.py:1153-1159`).
These are large plain products outside any kernel of the reference, so
they stay `torch.matmul` (full FP32 cuBLAS, see `core.precision`).

The flagship path runs the row-layout pair: windows as ``[S·A, sb·Q]`` rows
(the row-gather output viewed flat, β-major then basis plane) against the
folded table re-laid as ``[K, sb·Q]`` (`rows_table`), so neither direction
transposes the windows.  The reference-layout pair (windows ``[S, λ, α, β]``)
is a thin permute around it, for parity with the reference.
"""

from __future__ import annotations

import torch


def rows_table(wpsf_q: torch.Tensor) -> torch.Tensor:
    """Folded table [K, Q, sb] → contiguous [K, sb·Q] for the row layout."""
    k = wpsf_q.shape[0]
    return wpsf_q.permute(0, 2, 1).reshape(k, -1).contiguous()


def wblur_rows(win: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """win [S·A, sb·Q] → [S·A, K]."""
    return win @ wq.T


def wblur_rows_t(y2d: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """y2d [S·A, K] → [S·A, sb·Q] (exact transpose of :func:`wblur_rows`)."""
    return y2d @ wq


def wblur_sum_beta_batched(arr: torch.Tensor, wpsf: torch.Tensor) -> torch.Tensor:
    """[s, λ', α] = Σ_{λ,β} arr[s, λ, α, β] · wpsf[λ', λ, β], via :func:`wblur_rows`."""
    s, l, a, b = arr.shape
    win = arr.permute(0, 2, 3, 1).reshape(s * a, b * l)
    return wblur_rows(win, rows_table(wpsf)).reshape(s, a, -1).permute(0, 2, 1)


def wblur_sum_beta_batched_t(y: torch.Tensor, wpsf: torch.Tensor) -> torch.Tensor:
    """Exact transpose: y [s, λ', α] → [s, λ, α, β], via :func:`wblur_rows_t`."""
    s, k, a = y.shape
    _, l, b = wpsf.shape
    y2d = y.permute(0, 2, 1).reshape(s * a, k)
    return wblur_rows_t(y2d, rows_table(wpsf)).reshape(s, a, b, l).permute(0, 3, 1, 2)
