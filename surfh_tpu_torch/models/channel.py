"""One MRS band over its dither pointings: the composed-gather path.

Counterpart of `surfh_tpu/models/channel.py`, for the composed window
gather (the rank-basis and the W-plane modes).

Host side (NumPy, at construction): the parts of the reference
`Channel.__init__` that the composed path reads — the Slicer, the
per-pointing bilinear plans, the FOV bbox of the footprint, the slit
tables, the calibrated direct box-sum offset and the composed window
plans (gather + sorted-COO transpose).  The spectral PSF `wpsf`, the CSR
gather plans and the banded-blur plans are built once, at first use.

Device side: the per-pointing forward (composed gather → slit weights →
spectral blur, reference `_forward_one_pointing` with `cgrid`) and its
transpose (blur transpose → slit weights → composed transpose, reference
`one_pointing` with the COO transpose), pointings unrolled in Python.
Both composed stages run the row-gather kernel on ``[n, Q]`` rows; the
blur is the dense GEMM or the banded kernel pair (`core.wblur_banded`).

Not ported yet (raise NotImplementedError): the staged gridding path and
the FFT box-sum fallback, used when the direct box-sum is not exact.
"""

from __future__ import annotations

from math import ceil

import numpy as np
import torch

from ..core import bilinear, fft
from ..core.gather_rows import (build_row_gather_plan, gather_rows, gather_rows_reference,
                                plan_from_gather_table)
from ..core.wblur import wblur_rows, wblur_rows_t
from ..core.wblur_banded import (BandPlan, BandPlanT, build_band_plan, build_band_plan_t,
                                 wblur_banded, wblur_banded_reference, wblur_banded_t,
                                 wblur_banded_t_reference)
from ..instrument.geometry import CoordList
from ..instrument.ifu import IFU
from .slicer import Slicer


def gather_plans_from_composed(stack, n_patch: int, n_out: int):
    """Per-pointing CSR plans from a composed stack (idx, w, csrc, cw, cdst),
    each stacked over pointings as the reference `Channel._composed_stack`:
    forward plans read the [n_patch] patch rows into [n_out] window rows,
    transpose plans the reverse."""
    idx, w, csrc, cw, cdst = stack
    fwd = [plan_from_gather_table(idx[p], w[p], n_patch) for p in range(idx.shape[0])]
    adj = [build_row_gather_plan(csrc[p], cw[p], cdst[p], n_patch, n_out)
           for p in range(csrc.shape[0])]
    return fwd, adj


class Channel:
    """Forward model of one IFU band across its dither pointings.

    `dtype` is the NumPy dtype of the host tables (float32 or float64)."""

    def __init__(
        self,
        instr: IFU,
        alpha_axis: np.ndarray,
        beta_axis: np.ndarray,
        wavel_axis: np.ndarray,
        srf: int,
        pointings: CoordList,
        step_degree: float,
        dtype=np.float32,
    ):
        self.alpha_axis = np.asarray(alpha_axis, np.float64)
        self.beta_axis = np.asarray(beta_axis, np.float64)
        self.step_degree = float(step_degree)
        self.global_wavelength_axis = np.asarray(wavel_axis, np.float64)
        self.srf = int(srf)
        self.npdtype = np.dtype(dtype)
        self.instr = instr.pix(self.step_degree)
        self.pointings = pointings.pix(self.step_degree)

        local_alpha_axis, local_beta_axis = self.instr.fov.local_coords(
            step_degree, alpha_margin=5 * step_degree, beta_margin=5 * step_degree
        )
        self.slicer = Slicer(
            self.instr,
            wavelength_axis=self.global_wavelength_axis,
            alpha_axis=self.alpha_axis,
            beta_axis=self.beta_axis,
            local_alpha_axis=local_alpha_axis,
            local_beta_axis=local_beta_axis,
            srf=self.srf,
        )
        self.oshape = (
            len(self.pointings),
            self.instr.n_slit,
            len(self.instr.wavel_axis),
            ceil(self.slicer.npix_slit_alpha_width / self.srf),
        )
        self.local_im_shape = (len(local_alpha_axis), len(local_beta_axis))
        self.imshape = (len(self.alpha_axis), len(self.beta_axis))

        # per-pointing bilinear plans (cube grid → rotated local grid)
        plans = []
        for pointing in self.pointings:
            fov = self.instr.fov + pointing
            ga, gb = fov.local2global(local_alpha_axis, local_beta_axis)
            plans.append(bilinear.bilinear_plan(
                self.alpha_axis, self.beta_axis, bilinear.grid_points(ga, gb)))
        # FOV bbox: union over pointings of every nonzero-weight source pixel
        nb_g = self.imshape[1]
        nz = [p.idx[p.w != 0] for p in plans]
        nz = [i for i in nz if i.size]
        if nz:
            flat = np.concatenate([i.reshape(-1) for i in nz])
            a0, a1 = int((flat // nb_g).min()), int((flat // nb_g).max()) + 1
            b0, b1 = int((flat % nb_g).min()), int((flat % nb_g).max()) + 1
        else:
            a0, a1, b0, b1 = 0, 1, 0, 1
        self.tbbox = (a0, b0, a1 - a0, b1 - b0)

        a_starts, b_starts, weights = self.slicer.slit_tables()
        self.slit_a_starts = a_starts
        self.slit_b_starts = b_starts
        n_aout = self.oshape[3]
        self.slit_weights_sub = np.asarray(weights[:, : n_aout * self.srf : self.srf, :], self.npdtype)
        self.slit_shape = self.slicer.get_slit_shape()

        self.box_offset = self._calibrate_box_offset()
        if self.box_offset is None:
            raise NotImplementedError(
                f"channel {self.instr.name}: the slit windows touch the local grid "
                "edge, so the composed gather is unavailable; the staged gridding "
                "path with the FFT box-sum is not ported yet"
            )
        sb = self.slit_shape[2]
        cplans = [
            bilinear.compose_window_plan(
                p, a_starts, b_starts, self.box_offset, self.srf, n_aout, sb,
                self.local_im_shape, self.tbbox, self.npdtype,
            )
            for p in plans
        ]
        n_patch = self.tbbox[2] * self.tbbox[3]
        mmax = max(c.csrc.shape[0] for c in cplans)

        def padc(a, fill):
            return np.pad(a, (0, mmax - a.shape[0]), constant_values=fill)

        # same stacking / padding as the reference `Channel._composed_stack`
        self.composed_stack = (
            np.stack([c.idx for c in cplans]),
            np.stack([c.w for c in cplans]),
            np.stack([padc(c.csrc, 0) for c in cplans]),
            np.stack([padc(c.cw, 0) for c in cplans]),
            np.stack([padc(c.cdst, n_patch - 1) for c in cplans]),
        )
        self._wpsf = None
        self._gather_plans = None
        self._band_plans = {}

    # ------------------------------------------------------------------
    @property
    def wslice(self) -> slice:
        """λ window of the global axis covered by this channel (0.1 μm margin)."""
        return self.instr.wslice(self.global_wavelength_axis, 0.1)

    @property
    def n_wslice(self) -> int:
        return self.wslice.stop - self.wslice.start

    @property
    def n_out(self) -> int:
        """Slit-window values per pointing, S·A·sb."""
        return self.oshape[1] * self.oshape[3] * self.slit_shape[2]

    def _calibrate_box_offset(self):
        """Row offset making the strided slit windows of the SRF FFT
        convolution a direct reshape-sum of srf consecutive rows, or None."""
        nla, nlb = self.local_im_shape
        srf = self.srf
        n_aout = self.oshape[3]
        sb = self.slit_shape[2]
        a0 = int(self.slit_a_starts[0])
        b0 = int(self.slit_b_starts[0])
        rng = np.random.default_rng(0)
        g = rng.standard_normal((2, nla, nlb))
        otf = (fft.box_otf_sr(srf, self.local_im_shape, np.complex128)
               * fft.half_srf_shift_otf(srf, self.local_im_shape, np.complex128))
        summed = np.fft.irfftn(
            np.fft.rfftn(g, axes=(-2, -1), norm="ortho") * otf,
            s=(nla, nlb), axes=(-2, -1), norm="ortho",
        )
        ref = summed[:, a0 : a0 + n_aout * srf : srf, b0 : b0 + sb]
        for off in range(-2 * srf, 2 * srf + 1):
            start = a0 + off
            if start < 0 or start + n_aout * srf > nla:
                continue
            direct = (
                g[:, start : start + n_aout * srf, b0 : b0 + sb]
                .reshape(2, n_aout, srf, sb)
                .sum(axis=2)
            )
            if np.allclose(direct, ref, rtol=1e-9, atol=1e-9):
                if all(
                    0 <= int(a) + off and int(a) + off + n_aout * srf <= nla
                    for a in self.slit_a_starts
                ):
                    return off
        return None

    def _build_wpsf(self) -> np.ndarray:
        """wpsf [λ_det, λ_window, β_slit] of the band's spectral response."""
        length = self.slicer.npix_slit_beta_width
        beta_in_slit = np.arange(0, length) * (self.beta_axis[1] - self.beta_axis[0])
        return self.instr.spectral_psf(
            beta_in_slit - np.mean(beta_in_slit),
            self.global_wavelength_axis[self.wslice],
            arcsec2micron=self.instr.wavel_step / self.instr.det_pix_size,
            type="mrs",
        )

    @property
    def wpsf(self) -> np.ndarray:
        """wpsf [K, W, sb] in the table dtype, built once (the costliest
        host stage of a channel) and kept, so a second model over the same
        channels reuses it."""
        if self._wpsf is None:
            self._wpsf = np.asarray(self._build_wpsf(), self.npdtype)
        return self._wpsf

    def gather_plans(self):
        """(forward, transpose) per-pointing CSR plans of the composed stack,
        built once."""
        if self._gather_plans is None:
            n_patch = self.tbbox[2] * self.tbbox[3]
            self._gather_plans = gather_plans_from_composed(self.composed_stack, n_patch, self.n_out)
        return self._gather_plans

    def band_plan(self, rtol: float) -> BandPlan:
        """Forward banded plan of the wpsf at `rtol` (reference
        `Channel.band_plan`, channel.py:752-760), built at first use."""
        key = ("fwd", float(rtol))
        if key not in self._band_plans:
            self._band_plans[key] = build_band_plan(self.wpsf, rel_eps=float(rtol))
        return self._band_plans[key]

    def band_plan_t(self, rtol: float) -> BandPlanT:
        """Transpose banded plan of the wpsf at `rtol` (reference
        `Channel.band_plan_t`, channel.py:762-770), built at first use."""
        key = ("t", float(rtol))
        if key not in self._band_plans:
            self._band_plans[key] = build_band_plan_t(self.wpsf, rel_eps=float(rtol))
        return self._band_plans[key]

    def host_tables(self) -> dict:
        """The channel's host tables: wpsf [K, W, sb], slit weights [S, A, sb]
        and the per-pointing forward / transpose gather plans."""
        fwd, adj = self.gather_plans()
        return {
            "wpsf": self.wpsf,
            "slit_w": self.slit_weights_sub,
            "gather_fwd": fwd,
            "gather_t": adj,
        }

    # ------------------------------------------------------------------
    # device side (tables from `models.spectro`): one pipeline for both
    # modes, on rows of Q planes — Q = M·R rank-basis planes (rank mode) or
    # Q = W λ-planes (W-plane mode).  The blur is the dense GEMM against
    # t["wq"] [K, sb·Q], or with `banded` the banded kernel pair on
    # t["band"] (W-plane mode only).  `plain=True` runs every kernel's plain
    # version instead (the comparison on the card).
    def forward_rows(self, src: torch.Tensor, t: dict, plain: bool = False,
                     banded: bool = False) -> torch.Tensor:
        """Patch rows src [ha·wb, Q] → detector blocks [P, S, K, A]: per
        pointing the composed gather, the slit weights, the spectral blur."""
        P, S, K, A = self.oshape
        sb = self.slit_shape[2]
        q = src.shape[1]
        gather = gather_rows_reference if plain else gather_rows
        blur = wblur_banded_reference if plain else wblur_banded
        outs = []
        for p in range(P):
            win = gather(src, t["gather_fwd"][p])  # [S·A·sb, Q]
            win = (win.view(S * A, sb, q) * t["slit_w"]).view(S * A, sb * q)
            y2d = blur(win, t["band"]) if banded else wblur_rows(win, t["wq"])
            outs.append(y2d.view(S, A, K).transpose(1, 2))
        return torch.stack(outs)

    def adjoint_rows(self, yc: torch.Tensor, t: dict, plain: bool = False,
                     banded: bool = False) -> torch.Tensor:
        """Transpose of :meth:`forward_rows`, [P, S, K, A] → [ha·wb, Q]
        summed over pointings: exact with the dense table; the banded pair
        keeps the transpose plan's mask, as the reference's does."""
        P, S, K, A = self.oshape
        sb = self.slit_shape[2]
        gather = gather_rows_reference if plain else gather_rows
        blur_t = wblur_banded_t_reference if plain else wblur_banded_t
        acc = None
        for p in range(P):
            y2d = yc[p].transpose(1, 2).reshape(S * A, K)
            win = blur_t(y2d, t["band"]) if banded else wblur_rows_t(y2d, t["wq"])
            q = win.shape[1] // sb
            win = win.view(S * A, sb, q) * t["slit_w"]
            patch = gather(win.view(S * A * sb, q), t["gather_t"][p])
            acc = patch if acc is None else acc.add_(patch)
        return acc
