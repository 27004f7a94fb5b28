"""Simulated ground-truth generation (the Orion-bar fixture).

The port's own copy of `surfh_tpu/simulation/data.py` (host NumPy, the
same code, over the port's `utils.psf` and `preprocessing.fits_io`).

Reference: `get_simulation_data`
(surfh/Simulation/simulation_data.py:12-133), which loads
Orion-bar abundance maps + spectra from FITS at hard-coded absolute paths and
box-downsamples them.  Here the same pipeline (box downsampling, margin
windowing, template λ-smoothing, PSF shape alignment) runs on either

* real data files when a directory is provided (`abundances_orion.fits`,
  `spectra_mir_orion.fits`, a PSF `.npy`), or
* a hermetic synthetic Orion-like scene (smooth abundance blobs + continuum
  plus emission-line spectra) when no data is available — the default, so
  the whole simulation path needs no external files.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np

from ..utils.psf import gaussian_psf

STEP_ARCSEC = 0.025


def _box_downsample(arr: np.ndarray, k: int) -> np.ndarray:
    """Valid-mode k×k box filter + k-decimation (the reference's conv2 +
    slicing, simulation_data.py:53-55)."""
    if k <= 1:
        return arr
    out_shape = tuple(s - k + 1 for s in arr.shape[-2:])
    cum = np.cumsum(np.cumsum(arr, axis=-2), axis=-1)
    cum = np.pad(cum, [(0, 0)] * (arr.ndim - 2) + [(1, 0), (1, 0)])
    box = (
        cum[..., k:, k:] - cum[..., :-k, k:] - cum[..., k:, :-k] + cum[..., :-k, :-k]
    ) / (k * k)
    return box[..., ::k, ::k]


def synthetic_orion(
    n_maps: int = 4, size: int = 251, n_wavel: int = 900, seed: int = 7
) -> Tuple[np.ndarray, np.ndarray, float, np.ndarray]:
    """Orion-bar-like scene: smooth abundance fronts + line-rich spectra."""
    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.linspace(-1, 1, size), np.linspace(-1, 1, size), indexing="ij")
    maps = []
    for m in range(n_maps):
        # a diagonal ionization-front-like ramp plus smooth blobs
        angle = 0.6 + 0.5 * m
        front = 1.0 / (1.0 + np.exp(8 * (np.cos(angle) * xx + np.sin(angle) * yy - 0.3 + 0.2 * m)))
        blobs = np.zeros_like(xx)
        for _ in range(3):
            cx, cy = rng.uniform(-0.7, 0.7, 2)
            s = rng.uniform(0.1, 0.35)
            blobs += rng.uniform(0.3, 1.0) * np.exp(-((xx - cx) ** 2 + (yy - cy) ** 2) / (2 * s * s))
        maps.append(front * (0.5 + blobs))
    maps = np.asarray(maps)

    wavel_axis = np.linspace(4.9, 28.3, n_wavel)
    tpl = []
    for m in range(n_maps):
        cont = 50 * (wavel_axis / wavel_axis[0]) ** (1.5 - 0.5 * m)
        lines = np.zeros_like(wavel_axis)
        for _ in range(12):
            c = rng.uniform(wavel_axis[0], wavel_axis[-1])
            wdt = rng.uniform(0.01, 0.05)
            lines += rng.uniform(50, 400) * np.exp(-0.5 * ((wavel_axis - c) / wdt) ** 2)
        tpl.append(cont + lines)
    return maps, np.asarray(tpl), STEP_ARCSEC, wavel_axis


def synthetic_ngc7023(
    n_maps: int = 4, size: int = 251, n_wavel: int = 900, seed: int = 11
) -> Tuple[np.ndarray, np.ndarray, float, np.ndarray]:
    """NGC 7023-like reflection-nebula scene (the second target the
    BASELINE north star names): bright point sources (the illuminating
    star + field stars) over narrow curved PDR filaments and a diffuse
    cavity — a morphology with sharp small-scale structure, unlike the
    smooth Orion-bar fronts, so it stresses the reconstruction rather
    than flattering the smoothness prior."""
    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(
        np.linspace(-1, 1, size), np.linspace(-1, 1, size), indexing="ij"
    )
    rr = np.sqrt(xx**2 + yy**2)
    theta = np.arctan2(yy, xx)
    psf_sig = 2.5 / size  # marginally-resolved stars (~2.5 px sigma)

    def star(cx, cy, amp):
        return amp * np.exp(
            -((xx - cx) ** 2 + (yy - cy) ** 2) / (2 * psf_sig**2)
        )

    maps = []
    for m in range(n_maps):
        img = np.zeros_like(xx)
        # curved filaments: Gaussian ridges along spiral-ish arcs
        for k in range(4):
            r0 = 0.25 + 0.17 * k + 0.05 * m
            phase = rng.uniform(0, 2 * np.pi)
            ridge = rr - r0 * (1 + 0.15 * np.sin(3 * theta + phase))
            wdt = rng.uniform(0.015, 0.04)
            img += rng.uniform(0.4, 1.0) * np.exp(-0.5 * (ridge / wdt) ** 2)
        # diffuse cavity glow around the central star
        img += 0.3 * np.exp(-(rr**2) / (2 * 0.45**2))
        # point sources: the illuminating star (map-dependent weight) +
        # a handful of field stars
        img += star(0.0, 0.0, 3.0 * (1.0 + 0.5 * m))
        for _ in range(6):
            cx, cy = rng.uniform(-0.85, 0.85, 2)
            img += star(cx, cy, rng.uniform(0.5, 2.0))
        maps.append(img)
    maps = np.asarray(maps)

    wavel_axis = np.linspace(4.9, 28.3, n_wavel)
    tpl = []
    for m in range(n_maps):
        # PDR-like spectra: cooler continuum + strong PAH-band-like bumps
        cont = 30 * (wavel_axis / wavel_axis[0]) ** (1.2 - 0.3 * m)
        bands = np.zeros_like(wavel_axis)
        for c, wdt, amp in ((6.2, 0.12, 300), (7.7, 0.25, 500),
                            (8.6, 0.12, 250), (11.3, 0.15, 400),
                            (12.7, 0.2, 200)):
            bands += amp * (0.4 + 0.6 * rng.random()) * np.exp(
                -0.5 * ((wavel_axis - c) / wdt) ** 2
            )
        lines = np.zeros_like(wavel_axis)
        for _ in range(8):
            c = rng.uniform(wavel_axis[0], wavel_axis[-1])
            wdt = rng.uniform(0.01, 0.04)
            lines += rng.uniform(30, 250) * np.exp(
                -0.5 * ((wavel_axis - c) / wdt) ** 2
            )
        tpl.append(cont + bands + lines)
    return maps, np.asarray(tpl), STEP_ARCSEC, wavel_axis


def get_simulation_data(
    spatial_subsampling: int = 4,
    margin: int = 0,
    path_cube_orion: Optional[str] = None,
    path_spsf: Optional[str] = None,
    synthetic_kwargs: Optional[dict] = None,
):
    """Return (alpha_axis, beta_axis, wavel_axis, spsf, maps, templates).

    Mirrors the reference's processing chain: ×`spatial_subsampling` box
    downsampling of the maps (with the margin adjustment), ×3 λ-smoothing +
    subsampling of the templates, center-crop alignment of maps to the PSF.
    """
    if path_cube_orion is not None and os.path.isdir(path_cube_orion):
        maps, tpl, step, wavel_axis = _load_orion_files(path_cube_orion)
    else:
        maps, tpl, step, wavel_axis = synthetic_orion(**(synthetic_kwargs or {}))

    origin_size_axe = 0
    if margin != 0:
        origin_size_axe = maps[0, ::spatial_subsampling, ::spatial_subsampling].shape[1]
        spatial_subsampling = spatial_subsampling - 1
    if origin_size_axe + 2 * margin > maps.shape[1]:
        raise ValueError("The margin is too large")

    maps = _box_downsample(maps, spatial_subsampling)

    if margin != 0:
        idx = maps.shape[1] // 2
        N = origin_size_axe + margin * 2
        stepidx = N // 2 if N % 2 else int(N / 2) - 1
        start = min(max(idx - stepidx, 0), maps.shape[1] - N)
        maps = maps[:, start : start + N, start : start + N]

    # template λ-smoothing ×3 (reference :77-81)
    tpl_ss = 3
    k = np.ones((1, tpl_ss)) / tpl_ss
    tpl_s = np.stack(
        [np.convolve(t, k[0], mode="same") for t in tpl]
    )[:, ::tpl_ss]
    wavel_axis = wavel_axis[::tpl_ss]

    # PSF: from file or generated per-λ Airy-like gaussian
    if path_spsf is not None and os.path.isfile(path_spsf):
        spsf = np.load(path_spsf)
    else:
        spsf = gaussian_psf(wavel_axis, STEP_ARCSEC * spatial_subsampling)

    # center-crop maps to the PSF grid if larger (reference :85-103)
    for ax in (1, 2):
        if maps.shape[ax] > spsf.shape[ax]:
            diff = maps.shape[ax] - spsf.shape[ax]
            lo = diff // 2 + (diff % 2)
            hi = maps.shape[ax] - diff // 2
            maps = maps[:, lo:hi, :] if ax == 1 else maps[:, :, lo:hi]

    step_degree = STEP_ARCSEC / 3600.0
    alpha_axis = np.arange(maps.shape[1]) * step_degree
    beta_axis = np.arange(maps.shape[2]) * step_degree
    alpha_axis -= np.mean(alpha_axis)
    beta_axis -= np.mean(beta_axis)

    return alpha_axis, beta_axis, wavel_axis, spsf, maps, tpl_s


def _load_orion_files(path_cube_orion: str):
    """Load the Orion abundance maps + spectra FITS pair (reference :17-40)."""
    from ..preprocessing.fits_io import fits_open

    hdus = fits_open(os.path.join(path_cube_orion, "abundances_orion.fits"))
    maps = np.asarray(hdus[0].data)
    spec_hdus = fits_open(os.path.join(path_cube_orion, "spectra_mir_orion.fits"))
    table = spec_hdus[1].columns  # a BINTABLE HDU holds its columns, not `data`
    wavel_axis = np.asarray(table["wavelength"])
    tpl = np.asarray(
        [
            table["spectrum_h2"][: len(wavel_axis)],
            table["spectrum_if"][: len(wavel_axis)],
            table["spectrum_df"][: len(wavel_axis)],
            table["spectrum_mc"][: len(wavel_axis)],
        ]
    )
    return maps, tpl, STEP_ARCSEC, wavel_axis
