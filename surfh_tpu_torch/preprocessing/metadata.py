"""Header-metadata utilities for the real-data correction chain.

The port's own copy of `surfh_tpu/preprocessing/metadata.py` (same code).

The reference carries pointing metadata through its Raw → Corrected →
Filtered slice directories with a handful of one-off scripts; these are the
parametrized equivalents:

- ``propagate_target_coords`` ≙ scripts/correct_RA_DEC_corrected_slices.py
  (copy RA_V1/DEC_V1 of each raw exposure into TARG_RA/TARG_DEC of the
  matching corrected/filtered slice products, matched by channel + dither
  tokens, :22-107).
- ``propagate_rotation`` ≙ scripts/correct_rotation_slices.py (copy the raw
  PA_V3 plus a per-channel angular offset into the filtered products,
  :26-50 — ch3 gets +7.5°, ch4 gets +8.3°).
- ``swap_slit_blocks`` ≙ scripts/swipe_filter_corrected_mrs_data.py
  (reverse the left-to-right slit-block order of a corrected detector
  image, 17 blocks × 24 px for ch2, preserving the pointing headers,
  :33-55).
- ``rank_files_by_target_distance`` ≙
  scripts/compare_fits_target_regarding_position.py (order exposures by
  Euclidean RA/DEC distance from a reference target, :48-62).
- ``mean_slit_world_coords`` ≙ scripts/find_target_from_cal_file.py
  (label + centroid-sort the detector slits of a cal exposure, map each
  slit's pixels to world coordinates, skip slits outside the channel's
  wavelength range, report the mean α/β — the effective pointing of the
  exposure, :94-137).

Everything here is host-side NumPy + our dependency-free ``fits_io`` —
metadata plumbing, not compute.
"""

from __future__ import annotations

import math
import os
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from .fits_io import fits_open, fits_write

__all__ = [
    "parse_raw_name",
    "header_geometry",
    "propagate_target_coords",
    "propagate_rotation",
    "swap_slit_blocks",
    "swap_slit_blocks_in_files",
    "rank_files_by_target_distance",
    "mean_slit_world_coords",
]

# Headers the correction/filter drivers carry on slice products
# (scripts/correct_mrs_data.py, scripts/filter_slices.py).
_CARRIED_KEYS = ("PA_V3", "TARG_RA", "TARG_DEC", "BAND")


def parse_raw_name(filename: str) -> Tuple[str, str, str, str]:
    """Split a raw-exposure filename into (chan_a, chan_b, obs, dither).

    Raw MIRIFU exposures cover two channels at once and the reference names
    its raw slices ``<ch1>_<ch2>_<obs>_<dither>_...`` (reference
    ``extract_name_raw``, correct_RA_DEC_corrected_slices.py:22-24).
    """
    parts = os.path.basename(filename).split("_")
    if len(parts) < 4:
        raise ValueError(f"raw slice name needs >=4 '_' tokens: {filename!r}")
    return parts[0], parts[1], parts[2], parts[3]


def header_geometry(path: str, chan: Optional[int] = None) -> Dict:
    """Pointing geometry of a real stage-2 MRS product: TARG_RA / TARG_DEC
    / PA_V3 and the band name, from either a FITS file or a header card
    dump (text, one 80-column card per line — the vendored-fixture format).

    The reference reads exactly these keywords to build its real-data
    models (realmiri.get_IFU, realmiri.py:42-141; correction driver,
    scripts/correction_mrs_data.py:122-131).  CHANNEL on a MIRIFU detector
    names TWO channels (e.g. '12'); pass ``chan`` to pick one, else the
    first digit is used.  BAND SHORT/MEDIUM/LONG maps to sub-band a/b/c;
    a missing or unrecognized BAND leaves ``band`` as None rather than
    silently guessing a wavelength table.
    """
    from .fits_io import _parse_card

    cards: Dict = {}
    with open(path, "rb") as fh:
        head = fh.read(2880)
    if b"\n" in head:  # header card dump — one FITS card per line
        for line in open(path, encoding="ascii", errors="replace"):
            card = line.rstrip("\n").ljust(80)[:80]
            key, value, _ = _parse_card(card.encode("ascii", "replace"))
            if key and value is not None:
                cards.setdefault(key, value)
    else:
        for hdu in fits_open(path):
            for k, v in hdu.header.items():
                cards.setdefault(k, v)

    missing = [k for k in ("TARG_RA", "TARG_DEC") if k not in cards]
    if missing:
        raise KeyError(f"{path}: header lacks {missing}")
    chan_str = str(cards.get("CHANNEL", "")).strip()
    if chan is None and chan_str:
        chan = int(chan_str[0])
    sub = {"SHORT": "a", "MEDIUM": "b", "LONG": "c"}.get(
        str(cards.get("BAND", "")).strip().upper()
    )
    return {
        "targ_ra": float(cards["TARG_RA"]),
        "targ_dec": float(cards["TARG_DEC"]),
        "pa_v3": float(cards.get("PA_V3", 0.0)),
        "band": f"{chan}{sub}" if (chan is not None and sub) else None,
    }


def _pointing_header(path: str, key: str = "RA_V1") -> Dict:
    """Header that carries the requested pointing keyword: HDU 1 of a
    multi-HDU raw product when it has it, else the primary header."""
    hdus = fits_open(path)
    if len(hdus) > 1 and key in hdus[1].header:
        return hdus[1].header
    return hdus[0].header


def _rewrite_with_header(path: str, updates: Dict) -> None:
    """Rewrite a single-HDU slice product with updated header cards."""
    hdus = fits_open(path)
    hdr = dict(hdus[0].header)
    hdr.update(updates)
    # Drop structural cards; fits_write re-derives them from the data.
    for k in list(hdr):
        if k in ("SIMPLE", "BITPIX", "NAXIS", "EXTEND") or k.startswith("NAXIS"):
            del hdr[k]
    keep = {k: v for k, v in hdr.items() if isinstance(v, (str, int, float, bool))}
    fits_write(path, np.asarray(hdus[0].data), header=keep)


def propagate_target_coords(
    raw_dir: str,
    slice_dirs: Sequence[str],
    verbose: bool = False,
) -> int:
    """Copy each raw exposure's RA_V1/DEC_V1 into TARG_RA/TARG_DEC of every
    matching slice product (channel token in the name AND same dither token).

    Returns the number of files updated. Reference:
    correct_RA_DEC_corrected_slices.py:37-107 (the same loop body repeated
    for {ch_a, ch_b} × {corrected, filtered}).
    """
    n_updated = 0
    listings = {d: sorted(os.listdir(d)) for d in slice_dirs}
    for raw_name in sorted(os.listdir(raw_dir)):
        if not raw_name.endswith(".fits"):
            continue
        ch_a, ch_b, _obs, dith = parse_raw_name(raw_name)
        hdr = _pointing_header(os.path.join(raw_dir, raw_name))
        if "RA_V1" not in hdr or "DEC_V1" not in hdr:
            continue
        updates = {"TARG_RA": float(hdr["RA_V1"]), "TARG_DEC": float(hdr["DEC_V1"])}
        for d in slice_dirs:
            for chan in (ch_a, ch_b):
                for slice_name in listings[d]:
                    if chan in slice_name and dith in slice_name:
                        _rewrite_with_header(os.path.join(d, slice_name), updates)
                        n_updated += 1
                        if verbose:
                            print(f"{raw_name} -> {slice_name}: TARG_RA/DEC")
    return n_updated


# The reference's hard-coded rotation fix-ups (correct_rotation_slices.py:37,49):
# the filtered ch3/ch4 products need the raw V3 position angle plus a
# channel-dependent offset.
DEFAULT_ROTATION_OFFSETS = {"ch3": 7.5, "ch4": 8.3}


def propagate_rotation(
    raw_dir: str,
    filtered_dir: str,
    offsets: Optional[Dict[str, float]] = None,
    verbose: bool = False,
) -> int:
    """Copy PA_V3 from each channel's raw 'a'-band exposure (+offset) into
    every filtered product of that channel. Returns files updated.

    Reference: correct_rotation_slices.py:26-50 (reads the raw ``ch3a`` /
    ``ch4a`` PA_V3, writes PA_V3+7.5 / +8.3 into all filtered ch3*/ch4*).
    """
    offsets = DEFAULT_ROTATION_OFFSETS if offsets is None else offsets
    filtered = sorted(os.listdir(filtered_dir))
    n_updated = 0
    for raw_name in sorted(os.listdir(raw_dir)):
        if not raw_name.endswith(".fits"):
            continue
        for chan, off in offsets.items():
            if f"{chan}a" not in raw_name:
                continue
            hdr = _pointing_header(os.path.join(raw_dir, raw_name), key="PA_V3")
            if "PA_V3" not in hdr:
                continue
            pa = float(hdr["PA_V3"]) + float(off)
            for f in filtered:
                if chan in f and f.endswith(".fits"):
                    _rewrite_with_header(os.path.join(filtered_dir, f), {"PA_V3": pa})
                    n_updated += 1
                    if verbose:
                        print(f"{raw_name} -> {f}: PA_V3={pa}")
    return n_updated


def swap_slit_blocks(
    data: np.ndarray, n_slit: int = 17, block_width: int = 24
) -> np.ndarray:
    """Reverse the left-to-right order of the ``n_slit`` detector blocks of
    width ``block_width`` (the reference's ch2 slit-order 'swipe',
    swipe_filter_corrected_mrs_data.py:33-39)."""
    data = np.asarray(data)
    if data.shape[-1] != n_slit * block_width:
        raise ValueError(
            f"detector width {data.shape[-1]} != n_slit*block_width "
            f"({n_slit}*{block_width}) — refusing to silently drop columns"
        )
    blocks = [data[..., i * block_width : (i + 1) * block_width] for i in range(n_slit)]
    return np.concatenate(blocks[::-1], axis=-1)


def swap_slit_blocks_in_files(
    directory: str,
    match: str = "ch2",
    n_slit: int = 17,
    block_width: int = 24,
    verbose: bool = False,
) -> int:
    """Apply ``swap_slit_blocks`` in place to every matching file, keeping
    the carried pointing headers (PA_V3/TARG_RA/TARG_DEC/BAND) — the file
    loop of swipe_filter_corrected_mrs_data.py:19-55."""
    n_updated = 0
    for fname in sorted(os.listdir(directory)):
        if not fname.endswith(".fits") or match not in fname:
            continue
        path = os.path.join(directory, fname)
        hdus = fits_open(path)
        hdr = hdus[0].header
        swapped = swap_slit_blocks(np.asarray(hdus[0].data), n_slit, block_width)
        fits_write(
            path,
            swapped,
            header={k: hdr[k] for k in _CARRIED_KEYS if k in hdr},
        )
        n_updated += 1
        if verbose:
            print(f"swapped slit blocks: {fname}")
    return n_updated


def rank_files_by_target_distance(
    paths: Iterable[str], ref_ra: float, ref_dec: float
) -> List[Tuple[str, float]]:
    """Rank exposures by Euclidean (RA, DEC) distance of their RA_V1/DEC_V1
    pointing from a reference target — closest first.

    Reference: compare_fits_target_regarding_position.py:48-62 (builds a
    {path: (targ_ra, targ_dec)} dict then repeatedly pops the closest).
    """
    ranked = []
    for p in paths:
        hdr = _pointing_header(p)
        if "RA_V1" not in hdr or "DEC_V1" not in hdr:
            continue
        d = math.sqrt(
            (float(hdr["DEC_V1"]) - ref_dec) ** 2 + (float(hdr["RA_V1"]) - ref_ra) ** 2
        )
        ranked.append((p, d))
    ranked.sort(key=lambda t: t[1])
    return ranked


def mean_slit_world_coords(
    path: str,
    wavel_axis: np.ndarray,
    mode: int = 0,
    wcs_loader: Optional[Callable] = None,
    wavelength_margin: float = 1.0,
) -> Tuple[float, float]:
    """Mean world (α, β) over the slits of a cal exposure that fall inside
    the channel's wavelength range — the exposure's effective pointing.

    ``mode`` selects which co-observed channel the range test guards
    (0 = first/short channel: skip slits with λ above max+margin;
    1 = second/long channel: skip slits with λ below min−margin), matching
    find_target_from_cal_file.py:115-137. ``wcs_loader(path)`` must return
    ``(data, detector2world)`` like the correction driver's injectable
    loader (scripts/correct_mrs_data.py); the jwst package is not required.
    """
    from .distortion import generate_label_image, sort_labels_by_centroid

    if wcs_loader is None:
        raise ValueError(
            "mean_slit_world_coords needs a wcs_loader(path) -> (data, det2world); "
            "pass scripts/correct_mrs_data._jwst_wcs_loader when jwst is available"
        )
    data, det2world = wcs_loader(path)
    # Same loader convention as scripts/correct_mrs_data.correct_file
    # (the reference builds the identical mask through a transposed
    # meshgrid, find_target_from_cal_file.py:97-104).
    xx, yy = np.meshgrid(np.arange(data.shape[1]), np.arange(data.shape[0]))
    alpha_grid = np.asarray(det2world(xx, yy)[0])
    binary_grid = np.zeros_like(data)
    binary_grid[~np.isnan(alpha_grid)] = 1

    labels = sort_labels_by_centroid(generate_label_image(binary_grid))
    wmin, wmax = float(np.min(wavel_axis)), float(np.max(wavel_axis))
    alphas: List[float] = []
    betas: List[float] = []
    for slit in np.unique(labels):
        if slit == 0:
            continue
        rows, cols = np.where(labels == slit)
        alpha, beta, lam = det2world(cols, rows)
        lam = np.asarray(lam)
        if mode == 0 and np.any(lam > wmax + wavelength_margin):
            continue
        if mode == 1 and np.any(lam < wmin - wavelength_margin):
            continue
        alphas.append(float(np.mean(alpha)))
        betas.append(float(np.mean(beta)))
    if not alphas:
        raise ValueError("no slit fell inside the wavelength range")
    return float(np.mean(alphas)), float(np.mean(betas))
