"""Exponential modified-Shepard scattered-data interpolation, in torch.

Counterpart of `surfh_tpu/preprocessing/shepard.py` (the JAX path,
``backend="jax"``): per chunk of grid rows the weights are one masked
float32 computation and the weighted sums one matrix-vector product, with
the reference's arithmetic for every (grid row, sample) pair it evaluates.

The reference evaluates every sample for every grid row (64-row chunks
under `lax.map`).  Here the samples are sorted by λ once, and a chunk of
grid rows evaluates only the samples whose λ lies within (cutoff + 1)
resolution units of the chunk's λ range: every other sample is farther
than the cutoff and weighs exactly 0 there, so the same weights survive.
On a λ-major mesh (the distortion correction's) that keeps a chunk's work
near its own λ lines instead of the whole slit.  Chunks of `row_chunk`
grid rows (None: 4096 on the card, few launches; 512 on the host).

One backend: torch on the given device.  The reference's `backend`
argument is taken: "auto" and "jax" both run it; "native", the
reference's OpenMP C++ kernel (`native/`), is refused (ROADMAP "Do not
port").
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..core.precision import pick_device

ROW_CHUNK = {"cuda": 4096, "cpu": 512}  # grid rows per chunk, by device type


def exponential_modified_shepard(
    alpha_coord,
    lambda_coord,
    values,
    alpha_mesh,
    lambda_mesh,
    p: float = 2.0,
    alpha: float = 2.0,
    pixel_cutoff: float = 1.0,
    alpha_res: float = 1.0,
    lambda_res: float = 1.0,
    epsilon: float = 1e-6,
    row_chunk: Optional[int] = None,
    backend: str = "auto",
    device=None,
) -> np.ndarray:
    """Interpolate scattered (α, λ, value) samples onto a regular mesh.

    The reference's semantics in float32: pixel-unit distances (axes scaled
    by their resolutions) plus `epsilon`, weights exp(−alpha·dist^p) for
    dist ≤ pixel_cutoff, zero where no sample is in range.  Returns a host
    float32 array shaped like the mesh.  `backend` is the reference's:
    "auto" or "jax" run the one torch path, "native" raises.  `device`
    None means the card (raise without one); pass "cpu" for the host."""
    if backend not in ("auto", "jax", "native"):
        raise ValueError(f"unknown backend {backend!r}")
    if backend == "native":
        raise NotImplementedError(
            "backend='native': the reference's OpenMP C++ Shepard kernel is not ported "
            "(ROADMAP 'Do not port'); 'auto' and 'jax' run the torch path")
    device = pick_device(device)
    chunk = int(row_chunk or ROW_CHUNK.get(device.type, 512))

    order = np.argsort(np.asarray(lambda_coord, np.float32).ravel(), kind="stable")
    pa_h = np.asarray(alpha_coord, np.float32).ravel()[order]
    pl_h = np.asarray(lambda_coord, np.float32).ravel()[order]
    vals_h = np.asarray(values, np.float32).ravel()[order]
    shape = np.shape(alpha_mesh)
    ga_h = np.asarray(alpha_mesh, np.float32).ravel()
    gl_h = np.asarray(lambda_mesh, np.float32).ravel()

    inv_ar = float(np.float32(1.0 / alpha_res))
    inv_lr = float(np.float32(1.0 / lambda_res))
    eps = float(np.float32(epsilon))
    # beyond this λ distance |dl| > cutoff + 1 - rounding, so dist > cutoff
    halo = (float(pixel_cutoff) + 1.0) / inv_lr
    pl64 = pl_h.astype(np.float64)

    def dev(a):
        return torch.as_tensor(a).to(device)

    pa, pl, vals, ga, gl = dev(pa_h), dev(pl_h), dev(vals_h), dev(ga_h), dev(gl_h)
    n = ga_h.size
    out = torch.zeros(n, dtype=torch.float32, device=device)
    for i in range(0, n, chunk):
        cl_h = gl_h[i : i + chunk]
        if np.isnan(cl_h).all():
            continue
        lo = int(np.searchsorted(pl64, float(np.nanmin(cl_h)) - halo, side="left"))
        hi = int(np.searchsorted(pl64, float(np.nanmax(cl_h)) + halo, side="right"))
        if hi <= lo:
            continue  # no sample in range: zero, as the reference
        # the reference's expression, in place on two [chunk, window] buffers:
        # dist = sqrt(da² + dl²) + ε, w = where(dist ≤ cutoff, exp(−alpha·dist^p), 0)
        da = (pa[None, lo:hi] - ga[i : i + chunk, None]).mul_(inv_ar)
        dl = (pl[None, lo:hi] - gl[i : i + chunk, None]).mul_(inv_lr)
        dist = da.mul_(da).add_(dl.mul_(dl)).sqrt_().add_(eps)
        far = dist.le(pixel_cutoff).logical_not_()  # a NaN distance weighs 0, as there
        w = dist.pow_(p).mul_(-alpha).exp_().masked_fill_(far, 0.0)
        num = w @ vals[lo:hi]
        den = w.sum(dim=1)
        nz = den != 0
        out[i : i + chunk] = torch.where(nz, num / torch.where(nz, den, 1.0), 0.0)
    return out.cpu().numpy().reshape(shape)
