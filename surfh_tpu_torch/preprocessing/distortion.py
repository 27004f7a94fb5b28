"""Real-data distortion correction: stage-2 detector frames → model-aligned
per-slit (λ, α) grids.

Counterpart of `surfh_tpu/preprocessing/distortion.py` (reference
surfh/Preprocessing/distorsion_correction.py:26-178 and its driver
scripts/correction_mrs_data.py:60-201).  The labels and the centroid sort
stay on the host (`scipy.ndimage`); the Shepard re-interpolation runs in
torch on `device` (`preprocessing.shepard`; None: the card, or raise).  The
JWST WCS transform is injected as a callable (`detector2world`) so the
pipeline works with or without the `jwst` package installed.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np

from .shepard import exponential_modified_shepard


def generate_label_image(binary_grid: np.ndarray) -> np.ndarray:
    """Label connected components of a binary detector-coverage mask."""
    from scipy import ndimage

    label_image, _ = ndimage.label(np.asarray(binary_grid) > 0)
    return label_image


def sort_labels_by_centroid(label_image: np.ndarray) -> np.ndarray:
    """Renumber labels by the x-coordinate of their centroids (slit order)."""
    from scipy import ndimage

    num = int(label_image.max())
    if num == 0:
        return label_image
    centroids = ndimage.center_of_mass(
        label_image > 0, label_image, range(1, num + 1)
    )
    order = np.argsort([c[1] for c in centroids]) + 1
    out = np.zeros_like(label_image)
    for new, old in enumerate(order, start=1):
        out[label_image == old] = new
    return out


def mrs_slices_distortion_correction(
    model_channel,
    sorted_labeled_image: np.ndarray,
    detector2world: Callable,
    data: np.ndarray,
    chan_wavelength: np.ndarray,
    mode: int = 0,
    p: float = 2.0,
    alpha_exp: float = 2.0,
    pixel_cutoff: float = 2.0,
    device=None,
) -> np.ndarray:
    """Re-interpolate every labeled slit onto the model's (λ, α) grid.

    Parameters mirror the reference (`mrs_slices_distrorsion_correction`,
    distorsion_correction.py:106-178): `model_channel` provides the output
    shape `oshape[1:]` = (n_slit, n_λ, n_α); `detector2world(x, y)` maps
    detector pixels to (α, β, λ); `mode` selects which wavelength-limit
    violation discards a slit (0: above max, 1: below min); `device` runs
    the Shepard regrid (None: the card).
    """
    corrected = np.zeros(model_channel.oshape[1:])
    chan_wavelength = np.asarray(chan_wavelength)
    i = 0
    for slit in np.unique(sorted_labeled_image):
        if slit == 0:
            continue
        ys, xs = np.where(sorted_labeled_image == slit)
        alpha, beta, lam = detector2world(xs, ys)
        if mode == 0 and np.any(lam > np.max(chan_wavelength) + 1):
            continue
        if mode == 1 and np.any(lam < np.min(chan_wavelength) - 1):
            continue

        intensity = np.asarray(data)[ys, xs]
        valid = ~np.isnan(intensity)
        a_v, l_v, v_v = alpha[valid], lam[valid], intensity[valid]

        a_grid = np.linspace(np.min(alpha), np.max(alpha), model_channel.oshape[-1])
        a_mesh, l_mesh = np.meshgrid(a_grid, chan_wavelength)
        a_res = (a_grid.max() - a_grid.min()) / a_mesh.shape[1]
        l_res = (chan_wavelength.max() - chan_wavelength.min()) / l_mesh.shape[0]

        corrected[i] = exponential_modified_shepard(
            a_v,
            l_v,
            v_v,
            a_mesh,
            l_mesh,
            p=p,
            alpha=alpha_exp,
            pixel_cutoff=pixel_cutoff,
            alpha_res=a_res,
            lambda_res=l_res,
            device=device,
        )
        i += 1
    return corrected


def median_filter_slices(slices: np.ndarray, size: int = 11) -> np.ndarray:
    """Median filter along the λ axis of corrected slices (the reference's
    spectral-line filter, scripts/filter_corrected_mrs_data.py:34).

    Accepts either the flat 2-D detector layout (n_λ, n_slit·n_α) the
    reference script consumes (λ = axis 0) or the 3-D stacked layout
    (n_slit, n_λ, n_α) produced by `mrs_slices_distortion_correction`
    (λ = axis 1)."""
    from scipy import ndimage

    arr = np.asarray(slices).copy()
    lam_axis = 1 if arr.ndim == 3 else 0
    return ndimage.median_filter(arr, size=size, axes=[lam_axis])
