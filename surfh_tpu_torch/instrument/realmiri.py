"""Real-data instrument factory: build an `IFU` from JWST FITS metadata.

The port's own copy of `surfh_tpu/instrument/realmiri.py` (same code).

Behavioural reference: `realmiri.get_IFU` / `get_IFU_from_corrected_data`
(surfh/Models/realmiri.py:42-231).  Differences by design:

* FITS headers are read with the in-tree dependency-free reader
  (`preprocessing.fits_io`) instead of astropy;
* the PCE comes from the bundled calibration tables (`miri.mrs_pce`) instead
  of the reference's random placeholder (realmiri.py:124-128) — pass
  ``pce="random"`` to reproduce the placeholder behaviour bit-for-bit.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from ..preprocessing.fits_io import fits_open
from .geometry import FOV, Coord
from .ifu import IFU
from .spectral import SpectralBlur
from .wavelength_mrs import get_mrs_wavelength

ARCSEC_TO_DEGREE = 3600

# Per-band grating resolutions (reference realmiri.py:25-39, row-major
# ch1a…ch4c).
GRATING_RES = [
    np.mean([3320, 3710]), np.mean([3190, 3750]), np.mean([3100, 3610]),
    np.mean([2990, 3110]), np.mean([2750, 3170]), np.mean([2860, 3300]),
    np.mean([2530, 2880]), np.mean([1790, 2640]), np.mean([1980, 2790]),
    np.mean([1460, 1930]), np.mean([1680, 1760]), np.mean([1630, 1330]),
]

# (n_slit, det_pix_size [arcsec], α width [″], β width [″], rotation offset [°])
_CHANNEL_SPECS = {
    1: (21, 0.196, 3.2, 3.7, 8.4),
    2: (17, 0.196, 4.0, 4.8, 8.2),
    3: (16, 0.245, 5.2, 6.2, 7.5),
    4: (12, 0.273, 6.6, 7.7, 8.3),
}

_rng = np.random.default_rng(150)
_pce_cache: dict = {}


def _parse_channel(chan_name: Optional[str], header) -> int:
    if chan_name is None:
        ch = int(header["CHANNEL"])
        if ch not in (1, 2, 3, 4):
            # genuine MRS products carry BOTH channels of a detector in the
            # keyword (e.g. CHANNEL='12' on MIRIFUSHORT) — the caller must
            # disambiguate, as the reference flow does with its chan_name
            # argument (correction_mrs_data.py)
            raise ValueError(
                f"CHANNEL={header['CHANNEL']!r} covers two MRS channels; "
                "pass chan_name (e.g. '1a') to select one"
            )
        return ch
    for c in "1234":
        if c in chan_name:
            return int(c)
    raise NameError(f"Wrong channel name : {chan_name}")


def _band_index(chan_name: Optional[str], header) -> int:
    if chan_name is not None:
        for b, letter in enumerate("abc"):
            if letter in chan_name.lower():
                return b
        raise NameError(f"Wrong channel name : {chan_name}. No band specified.")
    band = str(header.get("BAND", "")).upper()
    return {"SHORT": 0, "MEDIUM": 1}.get(band, 2)


def _make_pce(chan_str: str, wavel: np.ndarray, pce) -> np.ndarray:
    if pce == "random":
        # the reference's seeded placeholder (realmiri.py:124-128)
        key = chan_str.upper()
        if key not in _pce_cache:
            _pce_cache[key] = _rng.random(wavel.size) / 10 + 0.5
        return _pce_cache[key]
    if pce is None:
        from .miri import mrs_pce

        try:
            table = mrs_pce(chan_str)
            if table.shape[0] == wavel.size:
                return table
        except Exception:
            pass
        return np.ones(wavel.size)
    return np.asarray(pce)


def get_IFU(
    filename: str,
    chan_name: Optional[str] = None,
    wavel_from_file: bool = False,
    pce=None,
) -> Tuple[IFU, float, float]:
    """IFU from a stage-2 `cal.fits` (reference realmiri.get_IFU:42-141).

    Returns (ifu, targ_ra, targ_dec)."""
    hdus = fits_open(filename)
    hdr0, hdr1 = hdus[0].header, hdus[1].header
    targ_ra, targ_dec = float(hdr1["RA_V1"]), float(hdr1["DEC_V1"])
    rotation_ref = float(hdr1["PA_V3"])

    channel = _parse_channel(chan_name, hdr0)
    band = _band_index(chan_name, hdr0)
    chan_str = f"{channel}{'abc'[band]}"

    n_slit, pix_size, aw, bw, rot_off = _CHANNEL_SPECS[channel]
    spec_blur = SpectralBlur(GRATING_RES[(channel - 1) * 3 + band])

    if wavel_from_file:
        wavel = (
            np.arange(int(hdr1["NAXIS3"])) + float(hdr1["CRPIX3"]) - 1
        ) * float(hdr1["CDELT3"]) + float(hdr1["CRVAL3"])
    else:
        wavel = get_mrs_wavelength(chan_str)

    ifu = IFU(
        FOV(
            aw / ARCSEC_TO_DEGREE,
            bw / ARCSEC_TO_DEGREE,
            origin=Coord(0, 0),
            angle=rot_off + rotation_ref,
        ),
        pix_size,
        n_slit,
        spec_blur,
        _make_pce(chan_str, wavel, pce),
        wavel,
        chan_str.upper(),
    )
    return ifu, targ_ra, targ_dec


def get_IFU_from_corrected_data(
    filename: str, channel: Optional[str] = None, pce=None
) -> Tuple[IFU, float, float]:
    """IFU from a corrected-slices FITS written by
    `preprocessing.fits_io.fits_write` (reference realmiri.py:143-231)."""
    hdus = fits_open(filename)
    hdr = hdus[0].header
    targ_ra, targ_dec = float(hdr["TARG_RA"]), float(hdr["TARG_DEC"])
    rotation_ref = float(hdr["PA_V3"])

    chan = _parse_channel(channel, hdr)
    band = _band_index(channel, hdr)
    chan_str = f"{chan}{'abc'[band]}"

    n_slit, pix_size, aw, bw, rot_off = _CHANNEL_SPECS[chan]
    # the corrected-data variant widens two FOVs (reference :185,192)
    if chan == 3:
        aw = 5.5
    if chan == 4:
        aw, bw = 6.9, 7.9
    spec_blur = SpectralBlur(GRATING_RES[(chan - 1) * 3 + band])
    wavel = get_mrs_wavelength(chan_str)

    ifu = IFU(
        FOV(
            aw / ARCSEC_TO_DEGREE,
            bw / ARCSEC_TO_DEGREE,
            origin=Coord(0, 0),
            angle=rot_off + rotation_ref,
        ),
        pix_size,
        n_slit,
        spec_blur,
        _make_pce(chan_str, wavel, pce),
        wavel,
        chan_str.upper(),
    )
    return ifu, targ_ra, targ_dec
