"""JWST MIRI MRS band tables (idealized instrument models).

Twelve bands (channels 1-4 × A/B/C) with FOV geometry, slit counts, detector
pixel sizes, grating resolutions, and the bundled PCE / wavelength calibration
tables.  Constants follow the public MIRI MRS documentation
(jwst-docs.stsci.edu) as used by surfh (`miri.py:104-226`); calibration
curves are loaded from `data/miri_calibration.npz` (extracted instrument
data), a copy of the JAX package's file.  The port's own copy of
`surfh_tpu/instrument/miri.py` (same code).
"""

from __future__ import annotations

import os
from functools import lru_cache

import numpy as np

from .geometry import Coord, CoordList, FOV
from .ifu import IFU
from .spectral import SpectralBlur

_DATA_PATH = os.path.join(os.path.dirname(__file__), "data", "miri_calibration.npz")

BANDS = ["1a", "1b", "1c", "2a", "2b", "2c", "3a", "3b", "3c", "4a", "4b", "4c"]

# Per-channel geometry: (alpha_width, beta_width, origin_alpha, origin_beta,
# angle_deg, det_pix_size_arcsec, n_slit) — identical across the A/B/C bands
# of a channel.
CHANNEL_GEOMETRY = {
    "1": (3.2, 3.7, -503.654, -318.742, 8.4, 0.196, 21),
    "2": (4.0, 4.8, -503.636, -319.091, 8.1, 0.196, 17),
    "3": (5.5, 6.2, -504.372, -318.798, 7.7, 0.245, 16),
    "4": (6.9, 7.9, -503.129, -319.488, 8.3, 0.273, 12),
}

# Grating resolving power ranges per band; the model uses the mid-point.
RESOLUTIONS = {
    "1a": (3320, 3710),
    "1b": (3190, 3750),
    "1c": (3100, 3610),
    "2a": (2990, 3110),
    "2b": (2750, 3170),
    "2c": (2860, 3300),
    "3a": (2530, 2880),
    "3b": (1790, 2640),
    "3c": (1980, 2790),
    "4a": (1460, 1930),
    "4b": (1680, 1760),
    "4c": (1630, 1330),
}


@lru_cache(maxsize=1)
def _calibration():
    if not os.path.exists(_DATA_PATH):
        raise FileNotFoundError(
            f"{_DATA_PATH} missing — copy surfh_tpu/instrument/data/miri_calibration.npz "
            "beside this module."
        )
    return np.load(_DATA_PATH)


def mrs_pce(band: str) -> np.ndarray:
    """PCE curve of a band from the bundled calibration tables."""
    return np.asarray(_calibration()[f"pce_{band.lower()}"])


def mrs_wavel_axis(band: str) -> np.ndarray:
    """Idealized detector wavelength axis of a band (from the PCE tables)."""
    return np.asarray(_calibration()[f"wavel_{band.lower()}"])


def mean_resolution(band: str) -> float:
    lo, hi = RESOLUTIONS[band.lower()]
    return float(np.mean([lo, hi]))


def build_ifu(
    band: str,
    resolution_scale: float = 1.0,
    degree: bool = False,
    centered: bool = False,
) -> IFU:
    """Build the IFU model of one band.

    resolution_scale < 1 produces the scaled-down test instrument family
    (the reference's `smallmiri`, resolutions ÷ 4).  The bundled tables use
    the reference miri.py arcsec convention (FOV widths/origins in arcsec,
    reference miri.py:104-226); `degree=True` converts the FOV to degrees —
    the convention of the fusion model and the reference's own fusion
    scripts (scripts/fusion/*.py build FOVs as width/3600).  `centered=True`
    zeroes the detector-frame origin (fusion pointing is relative).
    """
    band = band.lower()
    aw, bw, oa, ob, angle, pix, n_slit = CHANNEL_GEOMETRY[band[0]]
    if centered:
        oa = ob = 0.0
    if degree:
        aw, bw, oa, ob = aw / 3600, bw / 3600, oa / 3600, ob / 3600
    return IFU(
        fov=FOV(aw, bw, origin=Coord(oa, ob), angle=angle),
        det_pix_size=pix,
        n_slit=n_slit,
        w_blur=SpectralBlur(mean_resolution(band) * resolution_scale),
        pce=mrs_pce(band),
        wavel_axis=mrs_wavel_axis(band),
        name=band.upper(),
    )


def fusion_bands(bands=None, resolution_scale: float = 1.0):
    """Degree-unit centered IFU list ready for the fusion model."""
    if bands is None:
        bands = BANDS
    return [
        build_ifu(b, resolution_scale, degree=True, centered=True) for b in bands
    ]


def __getattr__(name: str):
    # Lazy attributes: ch1a … ch4c, all_chan, dithering, chN_dither.
    if name.startswith("ch") and name[2:] in BANDS:
        return build_ifu(name[2:])
    if name == "all_chan":
        return [build_ifu(b) for b in BANDS]
    if name == "dithering":
        return np.asarray(_calibration()["dither"])
    if name.endswith("_dither") and name[:3] in ("ch1", "ch2", "ch3", "ch4"):
        dither = np.asarray(_calibration()["dither"])
        idx = int(name[2]) - 1
        return CoordList.from_array(dither[idx * 8 : (idx + 1) * 8, :])
    raise AttributeError(name)
