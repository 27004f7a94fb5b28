"""PSF helpers (NumPy copies of `surfh_tpu/utils/psf.py`: `gaussian_psf`, `otf`)."""

from __future__ import annotations

import numpy as np

from ..core.fft import ir2fr


def gaussian_psf(wavel_axis, step: float, D: float = 6.5) -> np.ndarray:
    """λ-dependent Gaussian approximation of a diffraction-limited PSF.

    FWHM(λ) = (λ/D)·206265 arcsec on a 40×40 pixel stamp; normalized per plane.
    """
    x = np.linspace(-30, 30, 40).reshape((1, -1))
    y = x.reshape((-1, 1))
    psf = np.empty((len(wavel_axis), 40, 40))
    for w_idx, wavel in enumerate(np.asarray(wavel_axis)):
        fwhm_arcsec = (wavel * 1e-6 / D) * 206265
        sigma = fwhm_arcsec / (step * 2.354)
        psf[w_idx] = np.exp(-(x**2 + y**2) / (2 * sigma**2))
    return psf / np.sum(psf, axis=(1, 2), keepdims=True)


def otf(psf, shape, components) -> np.ndarray:
    """Template-weighted OTF stack: ir2fr(psf ⊗ components)."""
    return ir2fr(psf[np.newaxis, ...] * components[:, :, np.newaxis, np.newaxis], tuple(shape))
