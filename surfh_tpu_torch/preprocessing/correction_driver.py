"""Stage-2 → corrected-slice driver: the production correction flow.

Counterpart of `surfh_tpu/preprocessing/correction_driver.py` (reference
scripts/correction_mrs_data.py:60-201: channel model setup :60-88, WCS
transform :122-131, channel-specific slit reorders and rolls :150-186).  The
channel model is the port's `Channel`; the Shepard regrid runs on `device`.
The JWST WCS (`jwst.datamodels`) is only imported when available; the
`wcs_loader` hook makes the WCS source injectable (tests and the `cli
rehearse` command use a synthetic transform).
"""

from __future__ import annotations

import numpy as np

from ..core.precision import pick_device

# Reference slit orders (correction_mrs_data.py:150-186).
SLIT_ORDERS = {
    "ch1": ([0, 11, 1, 12, 2, 13, 3, 14, 4, 15, 5, 16, 6, 17, 7, 18, 8, 19, 9, 20, 10], 10),
    "ch2": ([8, 0, 9, 1, 10, 2, 11, 3, 12, 4, 13, 5, 14, 6, 15, 7, 16], 9),
    "ch3": ([0, 8, 1, 9, 2, 10, 3, 11, 4, 12, 5, 13, 6, 14, 7, 15], 0),
    "ch4": ([0, 6, 1, 7, 2, 8, 3, 9, 4, 10, 5, 11], 0),
}


def reorder_slits(corrected_slices: np.ndarray, chan_name: str) -> np.ndarray:
    """Apply the channel-specific detector→sky slit permutation and roll."""
    for key, (order, roll) in SLIT_ORDERS.items():
        if key in chan_name:
            out = np.zeros_like(corrected_slices)
            for i in range(corrected_slices.shape[0]):
                out[order[i]] = corrected_slices[i]
            if roll:
                out = np.roll(out, roll, 0)
            return out
    raise NameError(f"unknown channel name {chan_name!r}")


def setup_channel_model(npix, targ_ra, targ_dec, ifu, wavelength_cube,
                        step_arcsec: float = 0.025):
    """The single-pointing Channel whose local grid defines the corrected
    slice layout (reference setup_channel_model, correction_mrs_data.py:60-88)."""
    from ..instrument.geometry import Coord, CoordList, get_srf
    from ..models.channel import Channel

    step_degree = step_arcsec / 3600.0
    alpha_axis = np.arange(npix) * step_degree
    beta_axis = np.arange(npix) * step_degree
    alpha_axis += targ_ra - np.mean(alpha_axis)
    beta_axis += targ_dec - np.mean(beta_axis)
    srf = get_srf([ifu.det_pix_size], step_arcsec)[0]
    pointings = CoordList([Coord(0, 0)]).pix(step_degree)
    return Channel(
        ifu, alpha_axis, beta_axis, np.asarray(wavelength_cube), srf, pointings, step_degree
    )


def _jwst_wcs_loader(path):
    """Default stage-2 loader: (data, detector2world) via jwst.datamodels."""
    try:
        from jwst import datamodels
    except ImportError as exc:  # pragma: no cover - jwst not in the image
        raise RuntimeError(
            "the jwst package is required to read stage-2 WCS transforms"
        ) from exc

    jwst_model = datamodels.open(path)
    return jwst_model.data, jwst_model.meta.wcs.get_transform("detector", "world")


def correct_file(path, chan_name, npix, wavelength_cube, mode,
                 wcs_loader=None, step_arcsec: float = 0.025, device=None):
    """One stage-2 file, one channel: label slits, Shepard-correct, reorder.

    `wcs_loader(path) -> (data, detector2world)` makes the WCS source
    injectable (tests use a synthetic transform; production uses the jwst
    package's stage-2 datamodel — reference correction_mrs_data.py:122-131).
    `device` runs the Shepard regrid: None means the card (raise without
    one), "cpu" the host.
    """
    device = pick_device(device)
    from ..instrument import realmiri
    from .distortion import (
        generate_label_image,
        mrs_slices_distortion_correction,
        sort_labels_by_centroid,
    )

    ifu, targ_ra, targ_dec = realmiri.get_IFU(path, chan_name=chan_name)
    model_channel = setup_channel_model(
        npix, targ_ra, targ_dec, ifu, wavelength_cube, step_arcsec=step_arcsec
    )

    data, detector2world = (wcs_loader or _jwst_wcs_loader)(path)
    xx, yy = np.meshgrid(np.arange(data.shape[1]), np.arange(data.shape[0]))
    coords = detector2world(xx, yy)
    binary = np.zeros_like(data)
    binary[~np.isnan(coords[0])] = 1

    labels = sort_labels_by_centroid(generate_label_image(binary))
    corrected = mrs_slices_distortion_correction(
        model_channel, labels, detector2world, data, ifu.wavel_axis, mode,
        device=device,
    )
    return reorder_slits(corrected, chan_name), ifu, targ_ra, targ_dec


def corrected_to_fits(path, corrected, ifu, targ_ra, targ_dec, extra_header=None):
    """Write corrected slices in the driver's flat layout
    ([n_λ, n_slit·n_α] + PA_V3/TARG headers — fits_toolbox.py:5-36)."""
    from .fits_io import fits_write

    flat = corrected.transpose(1, 0, 2).reshape(
        corrected.shape[1], corrected.shape[0] * corrected.shape[2]
    )
    header = {
        "PA_V3": float(ifu.fov.angle),
        "TARG_RA": float(targ_ra),
        "TARG_DEC": float(targ_dec),
        "BAND": ifu.name,
    }
    if extra_header:
        header.update(extra_header)
    fits_write(path, flat.astype(np.float32), header=header)
    return flat.shape
