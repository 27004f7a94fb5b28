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
model.  ``SURFH_SIM_PSF=diffraction`` swaps the Gaussian stamps for the
JWST diffraction PSF (`utils.jwst_psf`, 40 × 40 at the sky step), built on
the setup's device.  Not ported: the reference's on-disk sotf cache
(ROADMAP A9).
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Optional

import numpy as np

from ..core.fft import ir2fr_device
from ..core.precision import pick_device
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


def flagship_wavel_axis(bands: Optional[List[str]] = None, subsample: int = 3) -> np.ndarray:
    """The flagship's global cube λ axis: the sorted union of the bands'
    detector tables, every `subsample`-th sample (reference
    `flagship_wavel_axis`)."""
    if bands is None:
        bands = miri.BANDS
    wavel = np.sort(np.concatenate([wavelength_mrs.get_mrs_wavelength(b) for b in bands]))
    return wavel[::subsample].copy()


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
    the card (raise without one); pass ``device="cpu"`` for the host.  The
    device builds the OTF, and the diffraction stamps under
    ``SURFH_SIM_PSF=diffraction``."""
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
    templates and random maps from `seed`, Gaussian PSF stamps (the
    diffraction PSF under ``SURFH_SIM_PSF=diffraction``, built on
    `device`), the dithers, and with `build_sotf` the OTF on `device`."""
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

    if os.environ.get("SURFH_SIM_PSF", "gaussian") == "diffraction":
        from ..utils.jwst_psf import psf_stack as host_stack
        from ..utils.jwst_psf import psf_stack_device

        dev = pick_device(device)
        if dev.type == "cpu":
            psf_stack = host_stack(wavelength_axis, FLAGSHIP_STEP_ARCSEC, npix=40)
        else:
            psf_stack = psf_stack_device(wavelength_axis, FLAGSHIP_STEP_ARCSEC, npix=40, device=dev)
        psf_stack = (psf_stack / psf_stack.sum(axis=(1, 2), keepdims=True)).astype(np.float32)
    else:
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


def make_flagship_model(setup: Optional[dict] = None, dtype=None, wblur_impl: str = "dense",
                        window_local: bool = True, conv_impl: str = "auto",
                        conv_freq_rtol: Optional[float] = None,
                        conv_precision: Optional[str] = None,
                        conv_rank_rtol: Optional[float] = None, wblur_band_rtol: float = 0.0,
                        workers: int = 1, channels=None, **kwargs):
    """The flagship `SpectroSigRLSCT` (reference `make_flagship_model`: its
    parameters, order, defaults and environment overrides, then the port's
    `wblur_band_rtol`, `workers` and `channels`); `dtype` None is float32.

    Window-local by default: `conv_freq_rtol` 1e-6 (``SURFH_CONV_FREQ_RTOL``
    overrides), `conv_precision` "highest" (``SURFH_CONV_PRECISION``),
    `conv_rank_rtol` 1e-7 (``SURFH_CONV_RANK_RTOL``; 0 runs the dense
    window-local conv).  ``conv_impl="auto"`` resolves to "matmul" there,
    as on the reference's TPU, and the PSF stamps are used unless
    ``SURFH_PSF_STAMPS=0``, which builds the OTF-window tables from the
    setup's materialized sotf.  ``window_local=False`` is the
    materialized-OTF W-plane model.  The sotf-reading configurations need
    a setup built with ``build_sotf=True``.  Without a `setup`, one is
    built from `kwargs` (the OTF on the card unless ``device="cpu"``); the
    model's tables stay on the host until ``.to(device, dtype)``."""
    from ..models.spectro import SpectroSigRLSCT

    resolved = conv_impl
    if resolved == "auto":
        resolved = "matmul" if window_local else "fft"
    stamps_ok = os.environ.get("SURFH_PSF_STAMPS", "1") != "0"
    if setup is None:
        setup = make_flagship_setup(build_sotf=not (window_local and resolved == "matmul"
                                                    and stamps_ok), **kwargs)
    if dtype is None:
        dtype = np.float32
    if conv_freq_rtol is None:
        conv_freq_rtol = float(os.environ.get("SURFH_CONV_FREQ_RTOL", "1e-6"))
    if conv_precision is None:
        conv_precision = os.environ.get("SURFH_CONV_PRECISION", "highest")
    if conv_rank_rtol is None:
        conv_rank_rtol = float(os.environ.get("SURFH_CONV_RANK_RTOL", "1e-7"))
    use_stamps = (resolved == "matmul" and window_local and stamps_ok
                  and setup.get("psf_stack") is not None)
    if not use_stamps and setup.get("sotf") is None:
        raise ValueError("this conv configuration needs the materialized sotf — rebuild the "
                         "setup with make_flagship_setup(build_sotf=True)")
    model = SpectroSigRLSCT(
        None if use_stamps else setup["sotf"], setup["templates"], setup["alpha_axis"],
        setup["beta_axis"], setup["wavelength_axis"], setup["instrs"], setup["step_degree"],
        setup["pointings"], dtype=dtype, wblur_impl=wblur_impl,
        wblur_band_rtol=wblur_band_rtol, window_local=window_local, conv_impl=conv_impl,
        conv_freq_rtol=conv_freq_rtol, psf_stack=setup["psf_stack"] if use_stamps else None,
        conv_precision=conv_precision, conv_rank_rtol=conv_rank_rtol, workers=workers,
        channels=channels,
    )
    return model, setup
