"""JWST diffraction PSF generation (the port's own copy of
`surfh_tpu/utils/jwst_psf.py`, without JAX).

The reference's physical-optics replacement for webbpsf's monochromatic
MIRI PSFs: the segmented JWST aperture (`jwst_pupil`: 18 hexagonal
segments, 7 mm gaps, no centre segment, three 0.1 m struts) propagated by a
matrix Fourier transform (Soummer et al. 2007, Opt. Express 15, 15935) —
the Fraunhofer integral evaluated on the detector grid as dense matmuls per
axis, complex arithmetic in planar real / imaginary parts.  A wavefront map
(OPD: a Zernike decomposition, a recorded per-segment decomposition such as
the bundled ``instrument/data/jwst_opd_commissioning.json``, or a FITS /
.npy map) enters as a pupil phase screen.

Host (NumPy, float32 products, kernels from float64 phases): `jwst_pupil`,
`monochromatic_psf`, `psf_stack`.  Card (torch): `psf_stack_device`, the
stack in λ-chunks of batched FP32 GEMMs (TF32 off, `core.precision`), the
MFT kernels built on the device from float64 phases.  Normalization as
webbpsf's ``normalize='last'``: the PSF over the infinite focal plane sums
to 1, so a finite field sums to slightly less.
"""

from __future__ import annotations

import json
import math
from typing import Optional

import numpy as np
import torch

from ..core.precision import pick_device

# ---------------------------------------------------------------------------
# JWST aperture geometry (public values, metres)

SEGMENT_FLAT_TO_FLAT = 1.32  # per-segment flat-to-flat
SEGMENT_GAP = 0.007  # edge-to-edge gap between segments
STRUT_WIDTH = 0.1  # secondary-support vane width
PUPIL_DIAMETER = 6.603464  # circumscribing diameter used by webbpsf
ARCSEC_TO_RAD = np.pi / (180.0 * 3600.0)


def _hex_mask(x: np.ndarray, y: np.ndarray, cx: float, cy: float, f2f: float) -> np.ndarray:
    """Inside-test for a vertex-up hexagon of flat-to-flat `f2f` (flats face
    the 0/60/120-degree axes, so neighbours abut across flats)."""
    dx = x - cx
    dy = y - cy
    r = f2f / 2.0
    inside = np.abs(dx) <= r
    for ang in (np.pi / 3.0, 2.0 * np.pi / 3.0):
        u = dx * math.cos(ang) + dy * math.sin(ang)
        inside &= np.abs(u) <= r
    return inside


def segment_centers() -> list:
    """(cx, cy) of the 18 primary segments in metres: ring 1 (A1-A6), then
    the alternating B / C segments of ring 2 (the order of per-segment
    terms in a recorded OPD)."""
    pitch = SEGMENT_FLAT_TO_FLAT + SEGMENT_GAP
    centers = []
    for k in range(6):
        ang = k * np.pi / 3.0
        centers.append((pitch * math.cos(ang), pitch * math.sin(ang)))
    for k in range(6):
        ang = k * np.pi / 3.0
        centers.append((2.0 * pitch * math.cos(ang), 2.0 * pitch * math.sin(ang)))
        ang2 = ang + np.pi / 6.0
        d2 = math.sqrt(3.0) * pitch
        centers.append((d2 * math.cos(ang2), d2 * math.sin(ang2)))
    return centers


def jwst_pupil(n: int = 512, diameter: float = PUPIL_DIAMETER) -> np.ndarray:
    """The aperture transmission mask on an n × n grid of width `diameter`
    (float32 in {0, 1}): the 18 segments minus the three struts (one along
    +y, two at ±120°)."""
    ax = (np.arange(n) - (n - 1) / 2.0) * (diameter / n)
    x, y = np.meshgrid(ax, ax, indexing="xy")
    mask = np.zeros((n, n), dtype=bool)
    for cx, cy in segment_centers():
        mask |= _hex_mask(x, y, cx, cy, SEGMENT_FLAT_TO_FLAT)
    for ang in (np.pi / 2.0, np.pi / 2.0 + 2.0 * np.pi / 3.0, np.pi / 2.0 - 2.0 * np.pi / 3.0):
        ux, uy = math.cos(ang), math.sin(ang)
        along = x * ux + y * uy
        across = -x * uy + y * ux
        mask &= ~((np.abs(across) <= STRUT_WIDTH / 2.0) & (along >= 0.0))
    return mask.astype(np.float32)


# ---------------------------------------------------------------------------
# matrix Fourier transform (planar complex)


def _mft_kernels(n_pup: int, diameter: float, npix: int, pixelscale_arcsec: float,
                 wavelength_m: float):
    """cos / sin planes [npix, n_pup] (float32) of K[k, j] = exp(−2πi θ_k x_j / λ):
    x the pupil samples, θ the detector pixel angles."""
    x = (np.arange(n_pup) - (n_pup - 1) / 2.0) * (diameter / n_pup)
    theta = (np.arange(npix) - (npix - 1) / 2.0) * (pixelscale_arcsec * ARCSEC_TO_RAD)
    phase = -2.0 * np.pi * np.outer(theta, x) / wavelength_m
    return np.cos(phase).astype(np.float32), np.sin(phase).astype(np.float32)


def _psf_from_kernels(pupil, kc, ks, norm, pupil_im=None):
    """|K P Kᵀ|² · norm with planar complex products (NumPy arrays or torch
    tensors; a leading batch axis on the kernels is broadcast).  `pupil` is
    the real part of the pupil function, `pupil_im` its imaginary part when
    a wavefront error is folded in (P = mask·e^{2πi·OPD/λ})."""
    kct, kst = (kc.transpose(-1, -2), ks.transpose(-1, -2)) if isinstance(kc, torch.Tensor) else (
        np.swapaxes(kc, -1, -2), np.swapaxes(ks, -1, -2))
    if pupil_im is None:
        a_re = kc @ pupil
        a_im = ks @ pupil
    else:
        a_re = kc @ pupil - ks @ pupil_im
        a_im = ks @ pupil + kc @ pupil_im
    e_re = a_re @ kct - a_im @ kst
    e_im = a_re @ kst + a_im @ kct
    return (e_re * e_re + e_im * e_im) * norm


# ---------------------------------------------------------------------------
# wavefront error (OPD) as a pupil phase screen

# (n, m) for Noll indices 1..15
_NOLL_NM = {
    1: (0, 0), 2: (1, 1), 3: (1, -1), 4: (2, 0), 5: (2, -2), 6: (2, 2),
    7: (3, -1), 8: (3, 1), 9: (3, -3), 10: (3, 3), 11: (4, 0),
    12: (4, 2), 13: (4, -2), 14: (4, 4), 15: (4, -4),
}


def _zernike_nm(n: int, m: int, rho: np.ndarray, theta: np.ndarray) -> np.ndarray:
    """Zernike polynomial Z_n^m on the unit disk (unnormalized, Z ∈ [−1, 1])."""
    am = abs(m)
    r = np.zeros_like(rho)
    for k in range((n - am) // 2 + 1):
        c = ((-1.0) ** k * math.factorial(n - k)
             / (math.factorial(k) * math.factorial((n + am) // 2 - k)
                * math.factorial((n - am) // 2 - k)))
        r = r + c * rho ** (n - 2 * k)
    if m > 0:
        return r * np.cos(am * theta)
    if m < 0:
        return r * np.sin(am * theta)
    return r


def zernike_opd(n_pupil: int, coeffs: dict, diameter: float = PUPIL_DIAMETER) -> np.ndarray:
    """OPD map [n_pupil, n_pupil] in metres from Zernike terms: `coeffs` maps
    a Noll index (1..15) to the peak amplitude (m) of the unnormalized
    polynomial over the circumscribed disk; zero outside it."""
    ax = (np.arange(n_pupil) - (n_pupil - 1) / 2.0) * (diameter / n_pupil)
    x, y = np.meshgrid(ax, ax, indexing="xy")
    rho = np.hypot(x, y) / (diameter / 2.0)
    theta = np.arctan2(y, x)
    opd = np.zeros((n_pupil, n_pupil), np.float64)
    for noll, c in coeffs.items():
        n, m = _NOLL_NM[int(noll)]
        opd += float(c) * _zernike_nm(n, m, np.clip(rho, 0.0, 1.0), theta)
    opd[rho > 1.0] = 0.0
    return opd


def load_opd(path: str, n_pupil: int, unit: str = "m") -> np.ndarray:
    """A wavefront map (.fits through the port's `preprocessing.fits_io`, or
    .npy) spanning the full pupil, bilinearly resampled to the pupil grid,
    in metres (`unit`: m | um | nm)."""
    if path.endswith(".npy"):
        opd = np.load(path)
    else:
        from ..preprocessing.fits_io import fits_open

        opd = next(h.data for h in fits_open(path) if h.data is not None and np.ndim(h.data) == 2)
    opd = np.asarray(opd, np.float64) * {"m": 1.0, "um": 1e-6, "nm": 1e-9}[unit]
    n_in = opd.shape[0]
    if opd.shape != (n_pupil, n_pupil):
        t = np.linspace(0.0, n_in - 1.0, n_pupil)
        i0 = np.clip(np.floor(t).astype(int), 0, n_in - 2)
        f = t - i0
        rows = opd[i0] * (1 - f)[:, None] + opd[i0 + 1] * f[:, None]
        opd = rows[:, i0] * (1 - f)[None, :] + rows[:, i0 + 1] * f[None, :]
    return opd


def recorded_opd(path_or_dict, n_pupil: int, diameter: float = PUPIL_DIAMETER) -> np.ndarray:
    """OPD map [n_pupil, n_pupil] in metres from a recorded decomposition (a
    JSON file or a dict): ``zernike_noll_nm`` {Noll index: nm} over the full
    pupil, ``segment_piston_nm`` (18 pistons, in :func:`segment_centers`
    order) and optionally ``segment_tilt_nm`` (18 [tx, ty] peak-to-edge
    ramps, nm)."""
    if isinstance(path_or_dict, dict):
        rec = path_or_dict
    else:
        with open(path_or_dict) as fh:
            rec = json.load(fh)
    zern = {int(k): float(v) * 1e-9 for k, v in rec.get("zernike_noll_nm", {}).items()}
    opd = zernike_opd(n_pupil, zern, diameter)
    pistons = rec.get("segment_piston_nm")
    tilts = rec.get("segment_tilt_nm")
    if pistons is not None or tilts is not None:
        ax = (np.arange(n_pupil) - (n_pupil - 1) / 2.0) * (diameter / n_pupil)
        x, y = np.meshgrid(ax, ax, indexing="xy")
        half_f2f = SEGMENT_FLAT_TO_FLAT / 2.0
        for i, (cx, cy) in enumerate(segment_centers()):
            seg = _hex_mask(x, y, cx, cy, SEGMENT_FLAT_TO_FLAT)
            term = np.zeros_like(opd)
            if pistons is not None:
                term += float(pistons[i]) * 1e-9
            if tilts is not None:
                tx, ty = tilts[i]
                term += (float(tx) * 1e-9 * (x - cx) + float(ty) * 1e-9 * (y - cy)) / half_f2f
            opd[seg] += term[seg]
    return opd


def _pupil_planes(pupil: np.ndarray, opd_m, lam_m: float):
    """(Re, Im) of mask·e^{2πi·OPD/λ}; Im is None without an OPD."""
    if opd_m is None:
        return pupil, None
    ph = (2.0 * np.pi / lam_m) * np.asarray(opd_m, np.float64)
    return (pupil * np.cos(ph)).astype(np.float32), (pupil * np.sin(ph)).astype(np.float32)


def monochromatic_psf(pupil: np.ndarray, wavelength_um: float, pixelscale_arcsec: float,
                      npix: int, diameter: float = PUPIL_DIAMETER,
                      opd: Optional[np.ndarray] = None) -> np.ndarray:
    """One diffraction PSF [npix, npix] (host), unit energy over the full
    plane: E(θ) = (dx²/λ)·Σ P e^{−2πi x·θ/λ}, pixel = |E|²·dθ²/A with A the
    pupil area, so Parseval gives Σ_infinite psf = 1; a pure-phase OPD
    (metres, pupil-grid shape) leaves the energy unchanged."""
    n_pup = pupil.shape[0]
    lam_m = wavelength_um * 1e-6
    kc, ks = _mft_kernels(n_pup, diameter, npix, pixelscale_arcsec, lam_m)
    dx = diameter / n_pup
    dtheta = pixelscale_arcsec * ARCSEC_TO_RAD
    area = float(pupil.sum()) * dx * dx
    norm = (dx * dx / lam_m) ** 2 * dtheta * dtheta / area
    pr, pi = _pupil_planes(np.asarray(pupil, np.float32), opd, lam_m)
    return np.asarray(_psf_from_kernels(pr, kc, ks, norm, pupil_im=pi))


def _bin(psf, npix: int, oversample: int):
    """Box-bin an oversampled plane (or a batch of them) to the detector grid."""
    if oversample == 1:
        return psf
    blocks = psf.reshape(tuple(psf.shape[:-2]) + (npix, oversample, npix, oversample))
    return blocks.sum(dim=(-3, -1)) if isinstance(blocks, torch.Tensor) else blocks.sum(axis=(-3, -1))


def psf_stack(wavel_axis, pixelscale_arcsec: float = 0.025, npix: int = 501,
              oversample: int = 1, n_pupil: int = 256, diameter: float = PUPIL_DIAMETER,
              use_jax: Optional[bool] = None, opd: Optional[np.ndarray] = None) -> np.ndarray:
    """Monochromatic PSF stack [Nλ, npix, npix] float32 on the host (NumPy,
    one λ at a time).  `oversample` computes on a finer grid and box-bins
    it to the detector sampling.  `use_jax` is the reference's switch and
    is not read: the port's host stack is NumPy, its card stack
    :func:`psf_stack_device`."""
    del use_jax
    wavel_axis = np.asarray(wavel_axis, dtype=np.float64)
    pupil = jwst_pupil(n_pupil, diameter)
    fine_n = npix * oversample
    fine_scale = pixelscale_arcsec / oversample
    dx = diameter / n_pupil
    dtheta = fine_scale * ARCSEC_TO_RAD
    area = float(pupil.sum()) * dx * dx
    out = np.empty((len(wavel_axis), npix, npix), dtype=np.float32)
    for i, lam_um in enumerate(wavel_axis):
        lam_m = float(lam_um) * 1e-6
        kc, ks = _mft_kernels(n_pupil, diameter, fine_n, fine_scale, lam_m)
        norm = (dx * dx / lam_m) ** 2 * dtheta * dtheta / area
        pr, pi = _pupil_planes(pupil, opd, lam_m)
        out[i] = _bin(_psf_from_kernels(pr, kc, ks, norm, pupil_im=pi), npix, oversample)
    return out


def psf_stack_device(wavel_axis, pixelscale_arcsec: float = 0.025, npix: int = 501,
                     oversample: int = 1, n_pupil: int = 256, diameter: float = PUPIL_DIAMETER,
                     chunk: int = 64, opd: Optional[np.ndarray] = None,
                     device=None) -> np.ndarray:
    """:func:`psf_stack` on `device` (None: the card, or raise): `chunk`
    λ-planes at a time, the MFT kernels (and the OPD's pupil planes) built
    there from float64 phases and rounded to float32, then six batched FP32
    GEMMs a chunk (ten with an OPD).  Only the pupil, the OPD and the λ
    values go to the device; returns the host float32 stack."""
    dev = pick_device(device)
    wavels = np.asarray(wavel_axis, dtype=np.float64)
    pupil = jwst_pupil(n_pupil, diameter)
    fine_n = npix * oversample
    fine_scale = pixelscale_arcsec / oversample
    dx = diameter / n_pupil
    dtheta = fine_scale * ARCSEC_TO_RAD
    area = float(pupil.sum()) * dx * dx

    def f64(a):
        return torch.as_tensor(np.asarray(a, np.float64), device=dev)

    x = f64((np.arange(n_pupil) - (n_pupil - 1) / 2.0) * (diameter / n_pupil))
    theta = f64((np.arange(fine_n) - (fine_n - 1) / 2.0) * (fine_scale * ARCSEC_TO_RAD))
    outer = -2.0 * np.pi * torch.outer(theta, x)  # the host kernels' phase before the 1/λ
    pup = f64(pupil)
    opd_d = None if opd is None else f64(opd)
    out = np.empty((len(wavels), npix, npix), dtype=np.float32)
    for i in range(0, len(wavels), chunk):
        lam = f64(wavels[i : i + chunk] * 1e-6)
        phase = outer / lam[:, None, None]
        kc, ks = torch.cos(phase).float(), torch.sin(phase).float()
        norm = ((dx * dx / lam) ** 2 * dtheta * dtheta / area).float()[:, None, None]
        if opd_d is None:
            pr, pi = pup.float(), None
        else:
            ph = (2.0 * np.pi / lam)[:, None, None] * opd_d
            pr, pi = (pup * torch.cos(ph)).float(), (pup * torch.sin(ph)).float()
        psf = _bin(_psf_from_kernels(pr, kc, ks, norm, pupil_im=pi), npix, oversample)
        out[i : i + chunk] = psf.cpu().numpy()
    return out
