"""IFU channel specification: FOV + slits + spectral blur + PCE + λ axis.

The port's own copy of `surfh_tpu/instrument/ifu.py` (same code): `IFU`
(surfh `instru.py:575-697`) plus the unused multispectral-imager stubs
(`instru.py:700-748`).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from .geometry import FOV, Coord
from .spectral import SpectralBlur


@dataclass
class IFU:
    """One MRS band: field of view, detector sampling, slits, spectral response.

    Attributes
    ----------
    fov: the channel's field of view.
    det_pix_size: detector (spatial) pixel size in arcsec.
    n_slit: number of slits across the FOV (β direction).
    w_blur: spectral blur model (may be None for spatial-only operators).
    pce: photo-conversion efficiency sampled on `wavel_axis` (may be None).
    wavel_axis: detector wavelength axis in μm (may be None).
    name: band label, e.g. "2A".
    """

    fov: FOV
    det_pix_size: float
    n_slit: int
    w_blur: Optional[SpectralBlur]
    pce: Optional[np.ndarray]
    wavel_axis: Optional[np.ndarray]
    name: str = "_"

    def __post_init__(self):
        # β-shift of each slit center in the local referential, and the
        # resulting per-slit FOVs in the global referential.
        self.slit_shift = [
            Coord(0, -self.fov.beta_width / 2 + self.slit_beta_width / 2)
            + Coord(0, idx * self.slit_beta_width)
            for idx in range(self.n_slit)
        ]
        self.slit_fov = [
            FOV(
                alpha_width=self.fov.alpha_width,
                beta_width=self.slit_beta_width,
                origin=self.fov.origin + shift.rotate(self.fov.angle),
                angle=self.fov.angle,
            )
            for shift in self.slit_shift
        ]

    @property
    def slit_beta_width(self) -> float:
        return self.fov.beta_width / self.n_slit

    @property
    def wavel_min(self):
        return self.wavel_axis[0]

    @property
    def wavel_max(self):
        return self.wavel_axis[-1]

    @property
    def wavel_step(self):
        return self.wavel_axis[1] - self.wavel_axis[0]

    @property
    def n_wavel(self) -> int:
        return len(self.wavel_axis)

    def wslice(self, wavel_input_axis: np.ndarray, margin: float = 0.0) -> slice:
        """Slice of the input λ axis covered by this channel (± margin in μm)."""
        lo = np.flatnonzero(
            wavel_input_axis <= max(self.wavel_min - margin, wavel_input_axis.min())
        )[-1]
        hi = np.flatnonzero(
            wavel_input_axis >= min(self.wavel_max + margin, wavel_input_axis.max())
        )[0]
        return slice(int(lo), int(hi))

    def spectral_psf(self, beta, wavel_input_axis, arcsec2micron, type="mrs"):
        """wpsf [λ_det, λ_in, β] for monochromatic point sources."""
        return self.w_blur.psfs(self.wavel_axis, beta, wavel_input_axis, arcsec2micron, type)

    def pix(self, step: float) -> "IFU":
        """Same channel with the FOV origin rounded to the `step` grid."""
        return IFU(
            FOV(
                self.fov.alpha_width,
                self.fov.beta_width,
                self.fov.origin.pix(step),
                self.fov.angle,
            ),
            self.det_pix_size,
            self.n_slit,
            self.w_blur,
            self.pce,
            self.wavel_axis,
            self.name if self.name.endswith("_pix") else self.name + "_pix",
        )

    def get_name_pix(self) -> str:
        return self.name if self.name.endswith("pix") else self.name + "_pix"


class WavelFilter:
    """A wavelength filter with measured transmittance (imager stub)."""

    def __init__(self, measured_wavelength, measured_values, name: str = ""):
        self.measured_wavelength = measured_wavelength
        self.measured_values = measured_values
        self.name = name

    def transmittance(self, wavelengths, normalized: bool = False):
        spectrum = np.interp(
            wavelengths, self.measured_wavelength, self.measured_values, left=0, right=0
        )
        return spectrum / np.sum(spectrum) if normalized else spectrum

    def integrate_hsi(self, cube, wavelength):
        """im[α, β] = Σ_λ cube[λ, α, β] · filter[λ] (normalized filter)."""
        weights = self.transmittance(wavelength, True)
        return np.tensordot(weights, cube, axes=(0, 0))

    def integrate_spectrum(self, spectrum, wavelength) -> float:
        return float(np.sum(spectrum * self.transmittance(wavelength, True)))


@dataclass
class MSImager:
    """Multi-spectral imager stub (parity with instru.py:740-748)."""

    sotf: np.ndarray
    fov: FOV
    wfilters: List[WavelFilter]
    det_pix_size: float
