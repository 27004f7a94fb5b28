"""Synthetic JWST stage-2 files: the rehearsal stand-in for real cal.fits.

The port's own copy of `surfh_tpu/simulation/stage2.py` (same code).

The production chain (reference scripts/correction_mrs_data.py:92-199 →
filter_corrected_mrs_data.py:34 → main_fusion.py:215-273) starts from
stage-2 detector frames whose WCS comes from the `jwst` package — absent
from this image, like real MRS data.  This module synthesizes the same
inputs: detector frames with per-slit strips of scene intensity, plus the
detector→world maps written as FITS image extensions (ALPHA/BETA/LAM), so
`stage2_wcs_loader` can stand in for `jwst.datamodels`' WCS transform and
the ENTIRE downstream chain runs unmodified (`cli rehearse`).
"""

from __future__ import annotations

import os
from typing import Callable, Optional

import numpy as np

from ..instrument.realmiri import _CHANNEL_SPECS
from ..preprocessing.fits_io import CARD, _format_card, _pad_block, fits_open


def _header_block(cards) -> bytes:
    out = [_format_card(k, v) for k, v in cards]
    out.append(b"END".ljust(CARD))
    return _pad_block(b"".join(out))


def _image_ext(name: str, data: np.ndarray, extra_cards=()) -> bytes:
    data = np.asarray(data, np.float32)
    cards = [
        ("XTENSION", "IMAGE"), ("BITPIX", -32), ("NAXIS", 2),
        ("NAXIS1", data.shape[1]), ("NAXIS2", data.shape[0]),
        ("EXTNAME", name),
    ] + list(extra_cards)
    return _header_block(cards) + _pad_block(data.astype(">f4").tobytes(), b"\x00")


def default_scene(alpha_deg, beta_deg, lam_um, targ_ra, targ_dec):
    """Smooth positive scene: continuum + a compact gaussian source with an
    emission-line spectrum (qualitatively an Orion-like field)."""
    da = (np.asarray(alpha_deg) - targ_ra) * 3600.0  # arcsec offsets
    db = (np.asarray(beta_deg) - targ_dec) * 3600.0
    lam = np.asarray(lam_um)
    lam01 = (lam - lam.min()) / max(lam.max() - lam.min(), 1e-9)
    blob = np.exp(-(da**2 + db**2) / (2 * 1.2**2))
    line = 1.0 + 2.0 * np.exp(-((lam01 - 0.4) ** 2) / (2 * 0.08**2))
    return (1.0 + 4.0 * blob) * line


def write_synthetic_stage2(
    path: str,
    band: str,
    targ_ra: float,
    targ_dec: float,
    pa_v3: float = 0.0,
    lam_table: Optional[np.ndarray] = None,
    n_rows: Optional[int] = None,
    strip_w: int = 24,
    gap_w: int = 3,
    scene: Optional[Callable] = None,
    scene_ra: Optional[float] = None,
    scene_dec: Optional[float] = None,
    noise_rms: float = 0.0,
    seed: int = 0,
) -> str:
    """One synthetic stage-2 cal.fits for `band` ("1a".."4c").

    Detector layout: n_slit vertical strips (strip_w columns each) separated
    by NaN gaps; λ runs along rows over the band's detector table; each
    strip's α samples span the slit's sky footprint, β is the slit center.
    Intensity = scene(α, β, λ) (+ optional gaussian noise).  The ALPHA/BETA/
    LAM maps ship as image extensions for `stage2_wcs_loader`.
    """
    from ..instrument.wavelength_mrs import get_mrs_wavelength

    chan = int(band[0])
    n_slit, _pix, aw, bw, _rot = _CHANNEL_SPECS[chan]
    if lam_table is None:
        lam_table = get_mrs_wavelength(band)
    lam_lo, lam_hi = float(np.min(lam_table)), float(np.max(lam_table))
    if n_rows is None:
        # the detector's λ grid IS the band table (one row per detector λ)
        n_rows = len(lam_table)

    n_cols = n_slit * (strip_w + gap_w)
    alpha_map = np.full((n_rows, n_cols), np.nan, np.float64)
    beta_map = np.full((n_rows, n_cols), np.nan, np.float64)
    lam_col = np.linspace(lam_lo, lam_hi, n_rows)
    lam_map = np.broadcast_to(lam_col[:, None], (n_rows, n_cols)).copy()

    deg = 1.0 / 3600.0
    # Detector strip s is SKY slit order[s] (+roll) — the WCS carries sky
    # coordinates, and the correction driver's reorder_slits undoes exactly
    # this permutation (correction_mrs_data.py:150-186).  Strip coordinates
    # come from the SAME FOV geometry the downstream fusion model builds:
    # the corrected header carries PA_V3 = rot_off + pa_v3 (the reference
    # writes ifu.fov.angle, correction_mrs_data.py:197) and
    # create_instruments rotates by its negative, so the sky footprint is
    # the FOV at angle −(rot_off + pa_v3) shifted to the target.
    from ..instrument.geometry import FOV, Coord
    from ..preprocessing.correction_driver import SLIT_ORDERS

    order, roll = SLIT_ORDERS[f"ch{chan}"]
    fov = FOV(aw * deg, bw * deg, origin=Coord(0, 0),
              angle=-(_rot + pa_v3)) + Coord(targ_ra, targ_dec)
    a_loc = (np.arange(strip_w) / max(strip_w - 1, 1) - 0.5) * aw * deg
    for s in range(n_slit):
        x0 = s * (strip_w + gap_w)
        sky = (order[s] + roll) % n_slit
        b_loc = np.array([((sky + 0.5) / n_slit - 0.5) * bw * deg])
        ga, gb = fov.local2global(a_loc, b_loc)
        ga = np.asarray(ga).reshape(strip_w)
        gb = np.asarray(gb).reshape(strip_w)
        alpha_map[:, x0 : x0 + strip_w] = ga[np.newaxis, :]
        beta_map[:, x0 : x0 + strip_w] = gb[np.newaxis, :]

    # the SKY is fixed: dither pointings move the FOV (targ_*), not the
    # source — scene coordinates anchor at scene_ra/dec (default: targ)
    scene = scene or default_scene
    sra = targ_ra if scene_ra is None else scene_ra
    sdec = targ_dec if scene_dec is None else scene_dec
    data = np.full((n_rows, n_cols), np.nan, np.float32)
    valid = ~np.isnan(alpha_map)
    data[valid] = scene(
        alpha_map[valid], beta_map[valid], lam_map[valid], sra, sdec
    )
    if noise_rms:
        rng = np.random.default_rng(seed)
        data[valid] += rng.normal(0.0, noise_rms, int(valid.sum())).astype(np.float32)

    band_word = {"a": "SHORT", "b": "MEDIUM", "c": "LONG"}[band[1].lower()]
    buf = _header_block([
        ("SIMPLE", True), ("BITPIX", 8), ("NAXIS", 0),
        ("CHANNEL", chan), ("BAND", band_word),
    ])
    buf += _image_ext(
        "SCI", data,
        extra_cards=[("RA_V1", float(targ_ra)), ("DEC_V1", float(targ_dec)),
                     ("PA_V3", float(pa_v3))],
    )
    buf += _image_ext("ALPHA", alpha_map)
    buf += _image_ext("BETA", beta_map)
    buf += _image_ext("LAM", lam_map)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as fh:
        fh.write(buf)
    return path


def stage2_wcs_loader(path: str):
    """(data, detector2world) from a synthetic stage-2 file — the drop-in
    for `jwst.datamodels`' `meta.wcs.get_transform('detector','world')`."""
    hdus = fits_open(path)
    by_name = {str(h.header.get("EXTNAME", "")).strip(): h for h in hdus}
    data = np.asarray(by_name["SCI"].data, np.float64)
    am = np.asarray(by_name["ALPHA"].data, np.float64)
    bm = np.asarray(by_name["BETA"].data, np.float64)
    lm = np.asarray(by_name["LAM"].data, np.float64)

    def detector2world(xs, ys):
        xs = np.asarray(xs, int)
        ys = np.asarray(ys, int)
        return am[ys, xs], bm[ys, xs], lm[ys, xs]

    return data, detector2world
