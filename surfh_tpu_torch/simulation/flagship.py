"""The flagship and all-band fusion problems at full scale (NumPy copy of
`surfh_tpu/simulation/flagship.py`).

12 MIRI MRS bands × 4 dither pointings, a 501² sky grid at 0.025″,
Gaussian PSF stamps [Nλ, 40, 40] and M = 4 smooth templates with random
abundance maps.  The flagship's global λ axis is the union of the detector
tables subsampled ×3 (≈3879 samples); the all-band problem's (BASELINE
config 5) the union of the PCE calibration grids (12 × 201 = 2412 samples
at λ-subsample 1).  Everything comes from the seed; nothing is loaded
beyond the bundled MIRI calibration tables.  `build_sotf=True` builds the
materialized OTF [Nλ, 501, 251] (complex64) from the stamps on the card, or
on the device asked for (`fft.ir2fr_device`), for the materialized-OTF
model.  Not ported: the reference's on-disk sotf cache and the diffraction
PSF (``SURFH_SIM_PSF=diffraction`` raises, ROADMAP A9).
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Optional

import numpy as np

from ..core.fft import ir2fr_device
from ..instrument import miri, wavelength_mrs
from ..instrument.geometry import CoordList
from ..utils.psf import gaussian_psf

FLAGSHIP_STEP_ARCSEC = 0.025


def flagship_instruments(bands: Optional[List[str]] = None) -> list:
    """The bands with their full detector wavelength tables (pce=None)."""
    if bands is None:
        bands = list(miri.BANDS)
    return [
        dataclasses.replace(ifu, wavel_axis=wavelength_mrs.get_mrs_wavelength(b), pce=None)
        for b, ifu in zip(bands, miri.fusion_bands(bands))
    ]


def make_flagship_setup(
    npix: int = 501,
    bands: Optional[List[str]] = None,
    n_pointings: int = 4,
    n_tpl: int = 4,
    lambda_subsample: int = 3,
    seed: int = 19940407,
    build_sotf: bool = False,
    device=None,
):
    """Flagship-scale inputs, same keys and values as the reference's
    `make_flagship_setup`: host arrays, and with `build_sotf` the OTF as a
    complex64 tensor on `device` (else `sotf` is None).  `device` None means
    the card (raise without one); pass ``device="cpu"`` for the host."""
    if bands is None:
        bands = list(miri.BANDS)
    return _make_setup_from_instrs(flagship_instruments(bands), bands, npix, n_pointings, n_tpl,
                                   lambda_subsample, seed, build_sotf=build_sotf, device=device)


def make_allband_setup(
    npix: int = 101,
    bands: Optional[List[str]] = None,
    n_pointings: int = 4,
    n_tpl: int = 4,
    lambda_subsample: int = 1,
    seed: int = 19940407,
    build_sotf: bool = True,
    device=None,
):
    """The all-band problem (BASELINE config 5) on the PCE calibration λ
    grids of `miri.fusion_bands` (201 samples a band, ~5× coarser than the
    detector tables): same keys and values as the reference's
    `make_allband_setup`; `device` as in :func:`make_flagship_setup`."""
    if bands is None:
        bands = list(miri.BANDS)
    return _make_setup_from_instrs(miri.fusion_bands(bands), bands, npix, n_pointings, n_tpl,
                                   lambda_subsample, seed, build_sotf=build_sotf, device=device)


def _make_setup_from_instrs(instrs, bands, npix, n_pointings, n_tpl, lambda_subsample, seed,
                            build_sotf: bool = True, device=None) -> dict:
    """The setup dict of `instrs` (reference `_make_setup_from_instrs`):
    the sorted union of their λ tables subsampled, smooth positive
    templates and random maps from `seed`, Gaussian PSF stamps, the
    dithers, and with `build_sotf` the OTF on `device`."""
    if os.environ.get("SURFH_SIM_PSF", "gaussian") == "diffraction":
        raise NotImplementedError("SURFH_SIM_PSF=diffraction: the diffraction PSF "
                                  "(utils/jwst_psf.py) is ROADMAP A9, not ported yet")
    rng = np.random.default_rng(seed)
    step_degree = FLAGSHIP_STEP_ARCSEC / 3600.0
    alpha_axis = (np.arange(npix) - npix / 2) * step_degree
    beta_axis = (np.arange(npix) - npix / 2) * step_degree
    wavelength_axis = np.sort(
        np.concatenate([np.asarray(ifu.wavel_axis) for ifu in instrs])
    )[::lambda_subsample].copy()
    n_lambda = len(wavelength_axis)

    lam01 = (wavelength_axis - wavelength_axis[0]) / (wavelength_axis[-1] - wavelength_axis[0])
    templates = np.empty((n_tpl, n_lambda))
    for m in range(n_tpl):
        t = 0.5 + 0.5 * (m + 1) / n_tpl * lam01
        for _ in range(3):
            c, w, a = rng.uniform(0.05, 0.95), rng.uniform(0.01, 0.1), rng.uniform(0.5, 2.0)
            t = t + a * np.exp(-((lam01 - c) ** 2) / (2 * w**2))
        templates[m] = t
    maps = rng.random((n_tpl, npix, npix))

    psf_stack = gaussian_psf(wavelength_axis, FLAGSHIP_STEP_ARCSEC).astype(np.float32)
    if psf_stack.shape[1] > npix or psf_stack.shape[2] > npix:
        ca = max(0, (psf_stack.shape[1] - npix) // 2)
        cb = max(0, (psf_stack.shape[2] - npix) // 2)
        psf_stack = psf_stack[:, ca : ca + npix, cb : cb + npix]
        psf_stack = psf_stack / psf_stack.sum(axis=(1, 2), keepdims=True)

    pts = CoordList.from_array(np.asarray(miri.dithering)[:n_pointings] / 3600.0)
    return dict(
        maps=maps,
        templates=templates,
        wavelength_axis=wavelength_axis,
        alpha_axis=alpha_axis,
        beta_axis=beta_axis,
        sotf=ir2fr_device(psf_stack, (npix, npix), device) if build_sotf else None,
        psf_stack=psf_stack,
        instrs=instrs,
        pointings=[pts for _ in instrs],
        step_degree=step_degree,
        im_shape=(npix, npix),
        bands=bands,
    )


def make_flagship_model(setup: Optional[dict] = None, dtype=np.float32,
                        conv_freq_rtol: float = 1e-6, conv_rank_rtol: float = 1e-7,
                        workers: int = 1, window_local: bool = True, wblur_impl: str = "dense",
                        wblur_band_rtol: float = 0.0, channels=None, **kwargs):
    """The flagship `SpectroSigRLSCT`: the rank mode by default (as the
    reference's `make_flagship_model`: conv_freq_rtol=1e-6,
    conv_rank_rtol=1e-7), or with ``window_local=False`` the
    materialized-OTF mode, which needs a setup built with
    ``build_sotf=True``.  `channels` reuses another flagship model's.
    Without a `setup`, one is built from `kwargs` (the OTF on the card
    unless ``device="cpu"``); the model's tables stay on the host until
    ``.to(device, dtype)``."""
    from ..models.spectro import SpectroSigRLSCT

    if setup is None:
        setup = make_flagship_setup(build_sotf=not window_local, **kwargs)
    if not window_local and setup.get("sotf") is None:
        raise ValueError("the materialized-OTF model needs the sotf — rebuild the setup "
                         "with make_flagship_setup(build_sotf=True)")
    model = SpectroSigRLSCT(
        None if window_local else setup["sotf"], setup["templates"], setup["alpha_axis"],
        setup["beta_axis"], setup["wavelength_axis"], setup["instrs"], setup["step_degree"],
        setup["pointings"], dtype=dtype, wblur_impl=wblur_impl,
        wblur_band_rtol=wblur_band_rtol, window_local=window_local,
        conv_freq_rtol=conv_freq_rtol, psf_stack=setup["psf_stack"] if window_local else None,
        conv_rank_rtol=conv_rank_rtol, workers=workers, channels=channels,
    )
    return model, setup
