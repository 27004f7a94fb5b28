"""Slit extraction (the L operator): static slice/weight tables per slit.

NumPy copy of `surfh_tpu/models/slicer.py` (host side: the per-slit
(α, β) window starts and fractional-pixel edge weights, with the
reference's trimming fix-ups and edge-weight sharing rule, and the
weighted slit window `slicing` / `slicing_t` of the data re-projections).
Copied rather than imported: the port imports nothing of `surfh_tpu`.
"""

from __future__ import annotations

from math import ceil, floor
from typing import Tuple

import numpy as np

from ..instrument.geometry import LocalFOV
from ..instrument.ifu import IFU


class Slicer:
    def __init__(
        self,
        instr: IFU,
        wavelength_axis: np.ndarray,
        alpha_axis: np.ndarray,
        beta_axis: np.ndarray,
        local_alpha_axis: np.ndarray,
        local_beta_axis: np.ndarray,
        srf: int,
    ):
        self.instr = instr
        self.wavelength_axis = wavelength_axis
        self.alpha_axis = alpha_axis
        self.beta_axis = beta_axis
        self.local_alpha_axis = local_alpha_axis
        self.local_beta_axis = local_beta_axis
        self.srf = srf
        self.slices_shape = (
            instr.n_slit,
            ceil(self.npix_slit_alpha_width / self.srf),
        )

    # -- geometry-derived sizes -----------------------------------------
    @property
    def wslice(self) -> slice:
        """λ-slice of the input axis matching the channel (0.1 μm margin)."""
        return self.instr.wslice(self.wavelength_axis, 0.1)

    @property
    def slit_beta_width(self) -> float:
        return self.instr.fov.beta_width / self.instr.n_slit

    @property
    def npix_slit_beta_width(self) -> int:
        """β pixels per slit, at the *global* grid step."""
        return int(ceil(self.slit_beta_width / (self.beta_axis[1] - self.beta_axis[0])))

    @property
    def slit_alpha_width(self) -> float:
        return self.instr.fov.alpha_width

    @property
    def npix_slit_alpha_width(self) -> int:
        """Oversampled α pixels along a slit, at the local grid step."""
        step = self.local_alpha_axis[1] - self.local_alpha_axis[0]
        return int(ceil(self.slit_alpha_width / 2 / step)) - int(
            floor(-self.slit_alpha_width / 2 / step)
        )

    # -- per-slit tables --------------------------------------------------
    def slit_local_fov(self, slit_idx: int) -> LocalFOV:
        """The slit FOV re-centered in the channel's local referential."""
        return self.instr.slit_fov[slit_idx].local + self.instr.slit_shift[slit_idx]

    def get_slit_slices(self, slit_idx: int) -> Tuple[slice, slice]:
        """(α, β) slices of the local axes covered by slit `slit_idx`.

        Includes the reference's trimming fix-ups (slicer.py:126-143): drop the
        β pixel farther from the slit edge when one too many is caught, and
        the even-width α adjustment.
        """
        slices = self.slit_local_fov(slit_idx).to_slices(
            self.local_alpha_axis, self.local_beta_axis
        )
        if (slices[1].stop - slices[1].start) > self.npix_slit_beta_width:
            fov = self.slit_local_fov(slit_idx)
            if abs(self.local_beta_axis[slices[1].stop] - fov.beta_end) > abs(
                self.local_beta_axis[slices[1].start] - fov.beta_start
            ):
                slices = (slices[0], slice(slices[1].start, slices[1].stop - 1))
            else:
                slices = (slices[0], slice(slices[1].start + 1, slices[1].stop))

        if self.slices_shape[1] % 2 == 0 and self.slices_shape[1] < 28:
            if (slices[0].stop - slices[0].start) > self.npix_slit_alpha_width:
                slices = (slice(slices[0].start, slices[0].stop - 1), slices[1])
            elif (slices[0].stop - slices[0].start) < self.npix_slit_alpha_width:
                slices = (slice(slices[0].start - 2, slices[0].stop), slices[1])

        return slices

    def fov_weight(
        self,
        fov: LocalFOV,
        slices: Tuple[slice, slice],
        alpha_axis: np.ndarray,
        beta_axis: np.ndarray,
    ) -> np.ndarray:
        """Fractional-pixel weights of the β-edge columns of a slit window."""
        beta_step = beta_axis[1] - beta_axis[0]
        slice_alpha, slice_beta = slices
        selected_beta = beta_axis[slice_beta]

        weights = np.ones(
            (slice_alpha.stop - slice_alpha.start, slice_beta.stop - slice_beta.start)
        )

        if selected_beta[0] - beta_step / 2 < fov.beta_start:
            wght = 1 - abs(selected_beta[0] - beta_step / 2 - fov.beta_start) / beta_step
            assert 0 <= wght <= 1, f"first-β weight must be in [0, 1] ({wght:.2f})"
            weights[:, 0] = wght

        if selected_beta[-1] + beta_step / 2 > fov.beta_end:
            wght = 1 - abs(selected_beta[-1] + beta_step / 2 - fov.beta_end) / beta_step
            assert 0 <= wght <= 1, f"last-β weight must be in [0, 1] ({wght:.2f})"
            weights[:, -1] = wght

        return weights

    def get_slit_weights(self, slit_idx: int, slices: Tuple[slice, slice]) -> np.ndarray:
        """Slit weights [1, nα, nβ]; edge weight is 1 when not shared with a
        neighbouring slit (reference slicer.py:148-168)."""
        weights = self.fov_weight(
            self.slit_local_fov(slit_idx), slices, self.local_alpha_axis, self.local_beta_axis
        )

        if slit_idx > 0:
            if self.get_slit_slices(slit_idx - 1)[1].stop - 1 != slices[1].start:
                weights[:, 0] = 1

        if slit_idx < self.slices_shape[0] - 1:
            if slices[1].stop - 1 != self.get_slit_slices(slit_idx + 1)[1].start:
                weights[:, -1] = 1

        return weights[np.newaxis, ...]

    def get_slit_shape(self) -> Tuple[int, int, int]:
        slices = self.get_slit_slices(0)
        return (
            self.wslice.stop - self.wslice.start,
            slices[0].stop - slices[0].start,
            slices[1].stop - slices[1].start,
        )

    get_slit_shape_t = get_slit_shape

    # -- dense tables for the channel pipeline ---------------------------
    def slit_tables(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Stacked per-slit tables: α starts [S], β starts [S], weights [S, nα, nβ].

        All slits share one window shape (guaranteed by the trimming rules);
        the starts plus the common shape encode the static gather.
        """
        shape = self.get_slit_shape()[1:]
        a_starts, b_starts, weights = [], [], []
        for s in range(self.instr.n_slit):
            slices = self.get_slit_slices(s)
            got = (slices[0].stop - slices[0].start, slices[1].stop - slices[1].start)
            if got != shape:
                raise ValueError(
                    f"slit {s} window {got} differs from slit 0 window {shape}"
                )
            a_starts.append(slices[0].start)
            b_starts.append(slices[1].start)
            weights.append(self.get_slit_weights(s, slices)[0])
        return (
            np.asarray(a_starts, np.int32),
            np.asarray(b_starts, np.int32),
            np.asarray(weights),
        )

    # -- NumPy re-projection path (the data-side methods of `Channel`) ----
    def slicing(self, gridded_cube: np.ndarray, slit_idx: int) -> np.ndarray:
        """Weighted slit window of a local cube [λ, nα, nβ]."""
        slices = self.get_slit_slices(slit_idx)
        weights = self.get_slit_weights(slit_idx, slices)
        return gridded_cube[:, slices[0], slices[1]] * weights

    def slicing_t(
        self, slit: np.ndarray, slit_idx: int, local_shape: Tuple[int, int, int]
    ) -> np.ndarray:
        """Transpose of :meth:`slicing`: weighted scatter into a zero cube."""
        out = np.zeros(local_shape)
        slices = self.get_slit_slices(slit_idx)
        weights = self.get_slit_weights(slit_idx, slices)
        out[:, slices[0], slices[1]] = slit * weights
        return out
