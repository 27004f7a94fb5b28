"""Spectral blur (the R operator) and blur + β-sum (Sig·R) as plain GEMMs.

Counterpart of `surfh_tpu/core/wblur.py` and of the channel adjoint's
wblur_t GEMM (`surfh_tpu/models/channel.py:1153-1159`).  These are large
plain products outside any kernel of the reference, so they stay
`torch.matmul` (full FP32 cuBLAS, see `core.precision`): `wblur` /
`wblur_t` one batched GEMM over β, the β-summed forms one GEMM over the
joint (λ, β) axis.

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


def wblur(arr: torch.Tensor, wpsf: torch.Tensor) -> torch.Tensor:
    """[..., λ', α, β] = Σ_λ arr[..., λ, α, β] · wpsf[λ', λ, β]: per β one
    GEMM [λ', λ] @ [λ, (... α)], batched over β."""
    *lead, l, a, b = arr.shape
    rhs = arr.reshape(-1, l, a, b).permute(3, 1, 0, 2).reshape(b, l, -1)  # [β, λ, (...)·α]
    out = torch.bmm(wpsf.permute(2, 0, 1), rhs)  # [β, λ', (...)·α]
    k = wpsf.shape[0]
    return out.reshape(b, k, -1, a).permute(2, 1, 3, 0).reshape(*lead, k, a, b)


def wblur_t(arr: torch.Tensor, wpsf: torch.Tensor) -> torch.Tensor:
    """Exact transpose of :func:`wblur`: [..., λ, α, β] = Σ_λ' arr[..., λ', α, β] · wpsf[λ', λ, β]."""
    *lead, k, a, b = arr.shape
    rhs = arr.reshape(-1, k, a, b).permute(3, 1, 0, 2).reshape(b, k, -1)
    out = torch.bmm(wpsf.permute(2, 1, 0), rhs)  # [β, λ, (...)·α]
    l = wpsf.shape[1]
    return out.reshape(b, l, -1, a).permute(2, 1, 3, 0).reshape(*lead, l, a, b)


def wblur_sum_beta(arr: torch.Tensor, wpsf: torch.Tensor) -> torch.Tensor:
    """Fused blur + β-sum: [λ', α] = Σ_λ Σ_β arr[λ, α, β] · wpsf[λ', λ, β],
    one GEMM [λ', λ·β] @ [λ·β, α] (reference `wblur_sum_beta`)."""
    l, a, b = arr.shape
    k = wpsf.shape[0]
    return wpsf.reshape(k, l * b) @ arr.permute(0, 2, 1).reshape(l * b, a)


def wblur_sum_beta_t(y: torch.Tensor, wpsf: torch.Tensor) -> torch.Tensor:
    """Exact transpose of :func:`wblur_sum_beta`: y [λ', α] → [λ, α, β]."""
    k, a = y.shape
    _, l, b = wpsf.shape
    return (wpsf.reshape(k, l * b).T @ y).reshape(l, b, a).permute(0, 2, 1)


def wblur_sum_beta_pointings(arr: torch.Tensor, wpsf: torch.Tensor) -> torch.Tensor:
    """Pointing-batched :func:`wblur_sum_beta_batched`: arr [λ, p, s, α, β]
    → [p, s, λ', α], one GEMM [λ', λ·β] @ [λ·β, p·s·α]."""
    l, p, s, a, b = arr.shape
    k = wpsf.shape[0]
    rhs = arr.permute(0, 4, 1, 2, 3).reshape(l * b, p * s * a)
    return (wpsf.reshape(k, l * b) @ rhs).reshape(k, p, s, a).permute(1, 2, 0, 3)


# Reference-name alias (`wblur_subSampling`).
wblur_subSampling = wblur_sum_beta
