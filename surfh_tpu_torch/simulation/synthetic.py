"""Hermetic synthetic problem generator (NumPy copy of
`surfh_tpu/simulation/synthetic.py::make_setup`, same seeds and arrays)."""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..core.fft import ir2fr
from ..instrument.geometry import FOV, Coord, CoordList
from ..instrument.ifu import IFU
from ..instrument.spectral import SpectralBlur
from ..utils.psf import gaussian_psf

GRATING_RESOLUTION = float(np.mean([2990, 3110]))
STEP_ARCSEC = 0.025
_DET_PIX_SIZES = (0.196, 0.245, 0.273)


def make_setup(
    im_size: int = 81,
    n_lambda: int = 60,
    n_tpl: int = 4,
    n_channels: int = 1,
    n_pointings: int = 2,
    n_slit: int = 5,
    detector_oversample: int = 2,
    step_arcsec: float = STEP_ARCSEC,
    seed: int = 19940407,
    band_overlap: float = 0.12,
):
    """A synthetic multi-channel MRS-like fusion problem: maps, templates,
    axes, PSF stamps (`spsf`) and OTF (`sotf`), IFU bands, dither pointings."""
    rng = np.random.default_rng(seed)
    step_degree = step_arcsec / 3600.0
    im_shape = (im_size, im_size)

    wavelength_axis = np.linspace(7.51115, 8.75292, n_lambda)
    cube_step = wavelength_axis[1] - wavelength_axis[0]
    det_step = cube_step / detector_oversample

    templates = np.asarray(
        [[(0.1 * (m + 2)) * x + 11 + 2 * m for x in range(n_lambda)] for m in range(n_tpl)],
        dtype=np.float64,
    )
    maps = rng.random((n_tpl, im_size, im_size))

    spsf = gaussian_psf(wavelength_axis, step_arcsec)
    if spsf.shape[1] > im_size or spsf.shape[2] > im_size:
        ca = max(0, (spsf.shape[1] - im_size) // 2)
        cb = max(0, (spsf.shape[2] - im_size) // 2)
        spsf = spsf[:, ca : ca + im_size, cb : cb + im_size]
        spsf = spsf / spsf.sum(axis=(1, 2), keepdims=True)
    sotf = ir2fr(spsf, im_shape)

    alpha_axis = np.arange(im_size) * step_degree
    beta_axis = np.arange(im_size) * step_degree
    alpha_axis -= np.mean(alpha_axis)
    beta_axis -= np.mean(beta_axis)

    spec_blur = SpectralBlur(GRATING_RESOLUTION)
    fov_width = im_size * step_arcsec
    edges = np.linspace(wavelength_axis[0], wavelength_axis[-1], n_channels + 1)
    span = (wavelength_axis[-1] - wavelength_axis[0]) / n_channels
    instrs = []
    for c in range(n_channels):
        w0 = max(wavelength_axis[0], edges[c] - band_overlap * span)
        w1 = min(wavelength_axis[-1], edges[c + 1] + band_overlap * span)
        chan_axis = np.arange(w0 - 0.0005, w1 + 0.0005, det_step)
        instrs.append(
            IFU(
                fov=FOV(0.35 * fov_width / 3600, 0.45 * fov_width / 3600,
                        origin=Coord(0, 0), angle=8.1 + 7.0 * c),
                det_pix_size=_DET_PIX_SIZES[c % len(_DET_PIX_SIZES)],
                n_slit=n_slit + (c % 2),
                w_blur=spec_blur,
                pce=None,
                wavel_axis=chan_axis,
                name=f"SYN{c}",
            )
        )
    base = [
        Coord(0, 0),
        Coord(5 * step_degree, -3 * step_degree),
        Coord(-4 * step_degree, 2 * step_degree),
        Coord(2 * step_degree, 4 * step_degree),
    ]
    pts = CoordList(base[:n_pointings])
    return dict(
        im_shape=im_shape,
        wavelength_axis=wavelength_axis,
        templates=templates,
        maps=maps,
        spsf=spsf,
        sotf=sotf,
        alpha_axis=alpha_axis,
        beta_axis=beta_axis,
        spec_blur=spec_blur,
        instrs=instrs,
        pointings=[pts for _ in range(n_channels)],
        step_degree=step_degree,
        step_arcsec=step_arcsec,
    )


def make_model(setup: Optional[dict] = None, dtype=np.float64, conv_freq_rtol: float = 1e-6,
               conv_rank_rtol: float = 1e-7, workers: int = 1, window_local: bool = True,
               wblur_impl: str = "dense", wblur_band_rtol: float = 0.0, **kwargs):
    """The `SpectroSigRLSCT` of a synthetic setup (host tables in `dtype`;
    call `.to(device, dtype)` before applying it).

    ``window_local=True`` (the default here) builds the rank mode from the
    PSF stamps (`spsf`); ``window_local=False`` the materialized-OTF mode
    from the setup's `sotf`, with the spectral blur `wblur_impl` and
    `wblur_band_rtol` at the reference's defaults (dense, 0)."""
    from ..models.spectro import SpectroSigRLSCT

    if setup is None:
        setup = make_setup(**kwargs)
    model = SpectroSigRLSCT(
        setup["templates"], setup["alpha_axis"], setup["beta_axis"],
        setup["wavelength_axis"], setup["instrs"], setup["step_degree"],
        setup["pointings"], setup["spsf"] if window_local else None, dtype=dtype,
        conv_freq_rtol=conv_freq_rtol, conv_rank_rtol=conv_rank_rtol, workers=workers,
        sotf=None if window_local else setup["sotf"], window_local=window_local,
        wblur_impl=wblur_impl, wblur_band_rtol=wblur_band_rtol,
    )
    return model, setup
