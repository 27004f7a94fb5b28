"""Block-Fourier Hessian algebra for decimated convolution operators.

Counterpart of `surfh_tpu/core/blockfourier.py`.  A convolution followed by
(di, dj) decimation has a Hessian HᵗH that is block-diagonal in Fourier
space: the frequencies that alias onto each other under decimation couple
in (di·dj)-sized blocks, and the LMM adds an n_spec-sized template
dimension, so each frequency holds one (n_spec·di·dj)² block.  Closed-form
solves invert each block on its own: one batched `torch.linalg.inv` over
all frequencies.  Batched torch on whatever device the tensors are on.
"""

from __future__ import annotations

from typing import Tuple

import torch


def dft2(x: torch.Tensor) -> torch.Tensor:
    """Unitary full-spectrum 2-D FFT over the last two axes."""
    return torch.fft.fftn(x, dim=(-2, -1), norm="ortho")


def idft2(x: torch.Tensor) -> torch.Tensor:
    """Unitary full-spectrum 2-D inverse FFT over the last two axes."""
    return torch.fft.ifftn(x, dim=(-2, -1), norm="ortho")


def partition(cubef: torch.Tensor, di: int, dj: int) -> torch.Tensor:
    """[λ, H, W] → [λ, di·dj, H/di, W/dj] decimation-block partition."""
    wl, H, W = cubef.shape
    bx, by = H // di, W // dj
    return cubef.reshape(wl, di, bx, dj, by).permute(0, 1, 3, 2, 4).reshape(wl, di * dj, bx, by)


def unpartition(part: torch.Tensor, shape_target: Tuple[int, int], di: int, dj: int) -> torch.Tensor:
    """Inverse of :func:`partition`."""
    n, _, bx, by = part.shape
    return (part.reshape(n, di, dj, bx, by).permute(0, 1, 3, 2, 4)
            .reshape(n, shape_target[0], shape_target[1]))


def make_iHtH(hess: torch.Tensor) -> torch.Tensor:
    """Per-frequency block inversion of a [S, S, D, D, h, w] block Hessian:
    one batched inverse over the h·w frequencies, rows and columns ordered
    (spec, block) as the reference's."""
    S, _, D, _, h, w = hess.shape
    M = hess.permute(4, 5, 0, 2, 1, 3).reshape(h * w, S * D, S * D)
    iM = torch.linalg.inv(M)
    return iM.reshape(h, w, S, D, S, D).permute(2, 4, 3, 5, 0, 1)


def apply_hessian_freq(hess: torch.Tensor, di: int, dj: int, shape_target,
                       x_freq: torch.Tensor) -> torch.Tensor:
    """A block Hessian on partitioned full-spectrum maps x_freq [S, H, W]
    → [S, H, W] full spectrum."""
    out = torch.einsum("abijhw,bjhw->aihw", hess, partition(x_freq, di, dj))
    return unpartition(out, shape_target, di, dj)


def apply_hessian(hess: torch.Tensor, di: int, dj: int, shape_target, x: torch.Tensor) -> torch.Tensor:
    """Real-domain wrapper of :func:`apply_hessian_freq`."""
    return idft2(apply_hessian_freq(hess, di, dj, shape_target, dft2(x))).real
