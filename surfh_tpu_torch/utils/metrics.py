"""Reconstruction quality metrics.

The port's own copy of `surfh_tpu/utils/metrics.py` (same code).

Reference: surfh/ToolsDir/metrics.py:30-109.  SSIM is
implemented directly (gaussian-windowed, standard constants) instead of
delegating to scikit-image, so the metric set is dependency-free.
"""

from __future__ import annotations

import numpy as np


def mse(ref, cmp):
    ref, cmp = np.asarray(ref), np.asarray(cmp)
    return float(np.mean((ref.ravel() - cmp.ravel()) ** 2))


def relative_error(ref, cmp):
    """Percent relative squared error (reference metrics.py:38-44)."""
    ref, cmp = np.asarray(ref), np.asarray(cmp)
    return float(
        100 * np.sum(np.abs(ref.ravel() - cmp.ravel()) ** 2) / np.sum(np.abs(ref.ravel()) ** 2)
    )


def psnr(vref, vcmp, dyn=None):
    """Peak SNR using the actual range of the reference by default."""
    vref, vcmp = np.asarray(vref), np.asarray(vcmp)
    if dyn is None:
        dyn = float(vref.max() - vref.min())
    msev = mse(vref, vcmp)
    if msev == 0:
        return float("inf")
    return float(20.0 * np.log10(dyn / np.sqrt(msev)))


def sam(vref, vcmp):
    """Spectral angle measure."""
    vref, vcmp = np.asarray(vref), np.asarray(vcmp)
    denom = np.sqrt(np.sum(vref**2)) * np.sqrt(np.sum(vcmp**2))
    if denom == 0:
        return 0.0
    return float(np.arccos(np.clip(np.sum(vref * vcmp) / denom, -1.0, 1.0)))


def snr(data, data_wo_noise):
    """SNR of noisy vs clean data lists (reference metrics.py:96-109)."""
    flat = np.concatenate([np.asarray(d).ravel() for d in data])
    clean = np.concatenate([np.asarray(d).ravel() for d in data_wo_noise])
    denom = np.sum((flat - clean) ** 2)
    if denom == 0:
        return float("inf")
    return float(10 * np.log10(np.sum(flat**2) / denom))


def _gaussian_window(size=11, sigma=1.5):
    ax = np.arange(size) - size // 2
    g = np.exp(-0.5 * (ax / sigma) ** 2)
    w = np.outer(g, g)
    return w / w.sum()


def ssim(vref, vcmp, dyn=None):
    """Mean structural similarity of two 2-D images (standard Wang et al.
    constants, gaussian 11×11 window)."""
    from scipy.signal import fftconvolve

    x = np.asarray(vref, np.float64)
    y = np.asarray(vcmp, np.float64)
    if dyn is None:
        dyn = float(x.max() - x.min())
        if dyn == 0:
            dyn = 1.0
    C1, C2 = (0.01 * dyn) ** 2, (0.03 * dyn) ** 2
    w = _gaussian_window()

    def f(a):
        return fftconvolve(a, w, mode="valid")

    mx, my = f(x), f(y)
    mx2, my2, mxy = mx * mx, my * my, mx * my
    sx = f(x * x) - mx2
    sy = f(y * y) - my2
    sxy = f(x * y) - mxy
    s = ((2 * mxy + C1) * (2 * sxy + C2)) / ((mx2 + my2 + C1) * (sx + sy + C2))
    return float(np.mean(s))


def nonzero_mean_per_slice(cube):
    """Mean of the non-zero pixels of each λ-slice of a (λ, y, x) cube —
    the per-wavelength flux curve the reference compares between fused and
    real cubes (scripts/compare_mean_flux_fusion_vs_real_data.py:64-72).
    Slices with no non-zero pixel map to 0."""
    cube = np.asarray(cube)
    flat = cube.reshape(cube.shape[0], -1)
    nz = flat != 0
    counts = nz.sum(axis=1)
    sums = np.where(nz, flat, 0.0).sum(axis=1)
    return np.where(counts > 0, sums / np.maximum(counts, 1), 0.0)


def points_in_polygon(points_yx, polygon):
    """Even-odd-rule point-in-polygon test (ray casting), vectorized over
    an (N, 2) array of (row, col) points against an (M, 2) polygon.
    Dependency-free stand-in for matplotlib.path.Path.contains_point as
    used by compare_mean_flux_fusion_vs_real_data.py:94-110."""
    pts = np.asarray(points_yx, np.float64)
    poly = np.asarray(polygon, np.float64)
    x, y = pts[:, 1], pts[:, 0]
    inside = np.zeros(len(pts), dtype=bool)
    n = len(poly)
    for i in range(n):
        y0, x0 = poly[i - 1, 0], poly[i - 1, 1]
        y1, x1 = poly[i, 0], poly[i, 1]
        crosses = (y0 > y) != (y1 > y)
        with np.errstate(divide="ignore", invalid="ignore"):
            xint = x0 + (y - y0) * (x1 - x0) / (y1 - y0)
        inside ^= crosses & (x < np.where(crosses, xint, np.inf))
    return inside


def region_mean_spectrum(cube, polygon):
    """Mean spectrum over the pixels of a (λ, y, x) cube inside an oriented
    polygon given as (row, col) vertices — the reference's rectangle-region
    flux comparison (compare_mean_flux_fusion_vs_real_data.py:84-117).
    Returns a length-λ array; raises if the polygon contains no pixel."""
    cube = np.asarray(cube)
    poly = np.asarray(polygon, np.float64)
    rmin, rmax = int(np.floor(poly[:, 0].min())), int(np.ceil(poly[:, 0].max()))
    cmin, cmax = int(np.floor(poly[:, 1].min())), int(np.ceil(poly[:, 1].max()))
    rr, cc = np.mgrid[rmin : rmax + 1, cmin : cmax + 1]
    pts = np.stack([rr.ravel(), cc.ravel()], axis=1)
    mask = points_in_polygon(pts, poly)
    rows, cols = pts[mask, 0].astype(int), pts[mask, 1].astype(int)
    keep = (rows >= 0) & (rows < cube.shape[1]) & (cols >= 0) & (cols < cube.shape[2])
    if not keep.any():
        raise ValueError("polygon contains no pixel inside the cube")
    return cube[:, rows[keep], cols[keep]].mean(axis=1)
