"""One MRS band over its dither pointings: the channel pipeline.

Counterpart of `surfh_tpu/models/channel.py`.

Host side (NumPy, at construction): the parts of the reference
`Channel.__init__` that the port's paths read — the Slicer, the
per-pointing gridding plans (bilinear, or nearest-neighbour with
``gridding="nn"``), the FOV bbox of the footprint, the slit tables, the
calibrated direct box-sum offset and, where that offset exists and
``SURFH_COMPOSED_GRIDDING`` (read at construction, as the reference reads
it) is not ``0``, the composed window plans (gather + sorted-COO
transpose).  Otherwise the channel is staged: the gather of the plans onto
the local grid, then the direct box-sum (a reshape-sum of srf rows at the
calibrated offset) or, with no offset, the FFT × `otf_combined` box-sum
with the strided slit read (reference `_forward_one_pointing`).  The
spectral PSF `wpsf`, the CSR gather plans and the banded-blur plans are
built once, at first use; `regrid` gives the same band with its gridding
tables built anew and its spectral tables shared.

Device side, on ``[n, Q]`` rows: the per-pointing forward (gather, the
staged box-sum and slit read where staged, slit weights, spectral blur)
and its exact transpose, pointings unrolled in Python; the gathers run the
row-gather kernel (kernel #1) and the blur is the dense GEMM or the banded
kernel pair (`core.wblur_banded`).  After `to(device, dtype)` the channel
applies itself to cubes as the reference does: `forward(cube)` →
``[P, S, λ_det, α_out]`` (with ``wblur_impl="banded"`` through kernel #2),
the exact transpose of the dense forward `adjoint` (the whole λ axis) and
`adjoint_windowed` (its band's λ window), and `adjoint_interp`, the
reference's approximate adjoint through the reverse plans `plans_rev`.

Data side (float64, as in the reference): `sliceToCube` (host) and
`sliceToWindow` (its band's λ window alone, in torch on a device),
`realData_cubeToSlice` and `realData_sliceToCube` re-project detector
slices and cubes through the SRF-box OTF (`_otf_sr`, `decalf`), the dirac
spectral response (`wpsf_dirac`) and the per-pointing plans (`plans_fwd`,
and `plans_rev` local → cube, built at first use).
"""

from __future__ import annotations

import copy
import os
from math import ceil

import numpy as np
import torch

from ..core import bilinear, fft, numpy_ref
from ..core.gather_rows import (build_row_gather_plan, gather_rows, gather_rows_reference,
                                plan_from_gather_table)
from ..core.linop import complex_dtype
from ..core.nearest import nearest_plan
from ..core.wblur import rows_table, wblur_rows, wblur_rows_t
from ..core.wblur_banded import (BandPlan, BandPlanT, banded_tables, build_band_plan,
                                 build_band_plan_t, wblur_banded, wblur_banded_reference,
                                 wblur_banded_t, wblur_banded_t_reference)
from ..instrument.geometry import Coord, CoordList
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


def gather_device_tables(t: dict, device, dtype) -> dict:
    """A channel's host tables → its device gather tables: slit weights
    [S·A, sb, 1], the CSR gather plans and, for a staged channel, the
    box-sum OTF [nla, nlb//2+1]."""
    sw = torch.as_tensor(np.asarray(t["slit_w"])).to(device=device, dtype=dtype)
    out = {
        "slit_w": sw.reshape(-1, sw.shape[-1], 1).contiguous(),
        "gather_fwd": [p.to(device, dtype) for p in t["gather_fwd"]],
        "gather_t": [p.to(device, dtype) for p in t["gather_t"]],
    }
    if "otf_box" in t:
        out["otf_box"] = torch.as_tensor(t["otf_box"]).to(device=device, dtype=complex_dtype(dtype))
    return out


class Channel:
    """Forward model of one IFU band across its dither pointings.

    The reference's parameters in its order.  `dtype` is the NumPy dtype of
    the host tables (float32 or float64); `gridding` is "bilinear" or "nn"
    (the reference's `nearest_plan`).  `wblur_impl` is the spectral blur of
    :meth:`forward`: "dense" (the GEMM) or "banded" (kernel #2 on the band
    plan at `wblur_band_rtol`).  The public adjoints stay the exact
    transpose of the *dense* forward, as the reference's (a Pallas call has
    no transpose rule there), so at ``wblur_band_rtol > 0`` a banded
    channel's forward / adjoint pair is not an exact transpose pair; the
    banded transpose (kernel #3) runs in `SpectroSigRLSCT`'s adjoint.

    `slit_unroll` and `pointing_scan` shape the reference's XLA graph
    (unrolled slit slices, a scan over pointings).  They are kept and
    resolved as the reference resolves them (`pointing_scan=None`: the
    ``SURFH_POINTING_SCAN`` 0 / 1, else more than 4 pointings, the count
    the reference unrolls on its accelerator), but change nothing here:
    slits and pointings are Python loops over eager kernels."""

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
        gridding: str = "bilinear",
        wblur_impl: str = "dense",
        wblur_band_rtol: float = 0.0,
        slit_unroll: bool = True,
        pointing_scan: bool | None = None,
    ):
        if wblur_impl not in ("dense", "banded"):
            raise ValueError(f"unknown wblur_impl {wblur_impl!r}")
        self.wblur_impl = wblur_impl
        self.wblur_band_rtol = float(wblur_band_rtol)
        self.slit_unroll = bool(slit_unroll)
        self.alpha_axis = np.asarray(alpha_axis, np.float64)
        self.beta_axis = np.asarray(beta_axis, np.float64)
        self.step_degree = float(step_degree)
        self.global_wavelength_axis = np.asarray(wavel_axis, np.float64)
        self.srf = int(srf)
        self.npdtype = np.dtype(dtype)
        self.instr = instr.pix(self.step_degree)
        self.pointings = pointings.pix(self.step_degree)
        if pointing_scan is None:
            env = os.environ.get("SURFH_POINTING_SCAN")
            pointing_scan = env != "0" if env else len(self.pointings) > 4
        self.pointing_scan = bool(pointing_scan)

        local_alpha_axis, local_beta_axis = self.instr.fov.local_coords(
            step_degree, alpha_margin=5 * step_degree, beta_margin=5 * step_degree
        )
        self.local_alpha_axis = local_alpha_axis
        self.local_beta_axis = local_beta_axis
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
        self.ishape = (len(self.global_wavelength_axis),) + self.imshape
        self.instr_cube_shape = (self.n_wslice,) + self.imshape
        self.local_cube_shape = (len(self.global_wavelength_axis),) + self.local_im_shape
        self.slices_shape = (len(self.pointings), self.instr.n_slit, self.oshape[3])
        # SRF box-sum OTF and the half-SRF phase shift, on the local grid
        self._otf_sr = fft.box_otf_sr(self.srf, self.local_im_shape, np.complex128)
        self.decalf = fft.half_srf_shift_otf(self.srf, self.local_im_shape, np.complex128)
        ctype = np.complex64 if self.npdtype == np.float32 else np.complex128
        self.otf_combined = np.asarray(self._otf_sr * self.decalf, ctype)
        self.otf_combined_conj = np.asarray((self._otf_sr * self.decalf).conj(), ctype)

        a_starts, b_starts, weights = self.slicer.slit_tables()
        self.slit_a_starts = a_starts
        self.slit_b_starts = b_starts
        n_aout = self.oshape[3]
        self.slit_weights_sub = np.asarray(weights[:, : n_aout * self.srf : self.srf, :], self.npdtype)
        self.slit_shape = self.slicer.get_slit_shape()
        self.box_offset = self._calibrate_box_offset()

        self._wpsf = None
        self._wpsf_dirac = None
        self._band_plans = {}
        self.device = None
        self.dtype = None
        self._build_gridding(gridding)

    def _build_gridding(self, gridding: str) -> None:
        """The per-pointing plans (cube grid → rotated local grid), the FOV
        bbox and, where the channel is composed, the composed window plans;
        reads SURFH_COMPOSED_GRIDDING."""
        if gridding not in ("bilinear", "nn"):
            raise ValueError(f"unknown gridding mode {gridding!r}")
        self.gridding = gridding
        self._plan_builder = nearest_plan if gridding == "nn" else bilinear.bilinear_plan
        plans = []
        for pointing in self.pointings:
            fov = self.instr.fov + pointing
            ga, gb = fov.local2global(self.local_alpha_axis, self.local_beta_axis)
            plans.append(self._plan_builder(self.alpha_axis, self.beta_axis,
                                            bilinear.grid_points(ga, gb)))
        self.plans_fwd = plans
        self._plans_rev = None
        self._rev_dev = None
        self._gather_plans = None
        self.tables = None
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

        self.composed_stack = None
        if self.box_offset is None or os.environ.get("SURFH_COMPOSED_GRIDDING", "1") == "0":
            return  # staged
        n_aout = self.oshape[3]
        sb = self.slit_shape[2]
        cplans = [
            bilinear.compose_window_plan(
                p, self.slit_a_starts, self.slit_b_starts, self.box_offset, self.srf, n_aout, sb,
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

    def regrid(self, gridding: str) -> "Channel":
        """The same band with its gridding tables built anew (`gridding`,
        and SURFH_COMPOSED_GRIDDING read now) and its spectral tables (wpsf,
        band plans) shared: they depend on the band and the axes alone."""
        new = copy.copy(self)
        new._build_gridding(gridding)
        new.device = new.dtype = None
        return new

    @property
    def staged(self) -> bool:
        """True where the gridding is the staged pipeline (no composed plans)."""
        return self.composed_stack is None

    # ------------------------------------------------------------------
    @property
    def wslice(self) -> slice:
        """λ window of the global axis covered by this channel (0.1 μm margin)."""
        return self.instr.wslice(self.global_wavelength_axis, 0.1)

    @property
    def beta_step(self) -> float:
        return self.beta_axis[1] - self.beta_axis[0]

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
        otf = self._otf_sr * self.decalf
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

    def _build_wpsf(self, kind: str = "mrs") -> np.ndarray:
        """wpsf [λ_det, λ_window, β_slit] of the band's spectral response
        ("mrs"), or its nearest-sample indicator ("dirac")."""
        length = self.slicer.npix_slit_beta_width
        beta_in_slit = np.arange(0, length) * (self.beta_axis[1] - self.beta_axis[0])
        return self.instr.spectral_psf(
            beta_in_slit - np.mean(beta_in_slit),
            self.global_wavelength_axis[self.wslice],
            arcsec2micron=self.instr.wavel_step / self.instr.det_pix_size,
            type=kind,
        )

    @property
    def wpsf_dirac(self) -> np.ndarray:
        """Nearest-sample re-projection response (float64, built on first use)."""
        if self._wpsf_dirac is None:
            self._wpsf_dirac = self._build_wpsf("dirac")
        return self._wpsf_dirac

    @property
    def plans_rev(self):
        """Reverse (local → cube grid) plans per pointing, of the gridding's kind,
        zero outside the local grid; built on first use (they evaluate at
        every cube pixel) for the data re-projections."""
        if self._plans_rev is None:
            self._plans_rev = []
            for pointing in self.pointings:
                fov = self.instr.fov + pointing
                la, lb = fov.global2local(self.alpha_axis, self.beta_axis)
                self._plans_rev.append(self._plan_builder(
                    self.local_alpha_axis, self.local_beta_axis,
                    bilinear.grid_points(la, lb), fill_out_of_bounds=True))
        return self._plans_rev

    @property
    def wpsf(self) -> np.ndarray:
        """wpsf [K, W, sb] in the table dtype, built once (the costliest
        host stage of a channel) and kept, so a second model over the same
        channels reuses it."""
        if self._wpsf is None:
            self._wpsf = np.asarray(self._build_wpsf(), self.npdtype)
        return self._wpsf

    def gather_plans(self):
        """(forward, transpose) per-pointing CSR plans, built once: of the
        composed stack (patch rows → window rows), or staged, of the plans
        rebased to the FOV-bbox patch (patch rows → local-grid rows)."""
        if self._gather_plans is None:
            a0, b0, ha, wb = self.tbbox
            n_patch = ha * wb
            if not self.staged:
                self._gather_plans = gather_plans_from_composed(self.composed_stack, n_patch,
                                                                self.n_out)
            else:
                nb_g = self.imshape[1]
                nloc = self.local_im_shape[0] * self.local_im_shape[1]
                fwd = []
                for p in self.plans_fwd:
                    idx = p.idx.astype(np.int64)
                    pidx = (np.clip(idx // nb_g - a0, 0, ha - 1) * wb
                            + np.clip(idx % nb_g - b0, 0, wb - 1))  # zero-weight taps may fall outside
                    dst = np.broadcast_to(np.arange(p.npoints), idx.shape)
                    fwd.append(build_row_gather_plan(pidx, np.asarray(p.w, self.npdtype), dst, nloc,
                                                     n_patch))
                self._gather_plans = fwd, [f.t for f in fwd]
        return self._gather_plans

    def band_plan(self, rtol: float | None = None) -> BandPlan:
        """Forward banded plan of the wpsf at `rtol` (None: the channel's
        `wblur_band_rtol`, as the reference's `Channel.band_plan()`), built
        at first use and kept per rtol."""
        key = ("fwd", self.wblur_band_rtol if rtol is None else float(rtol))
        if key not in self._band_plans:
            self._band_plans[key] = build_band_plan(self.wpsf, rel_eps=key[1])
        return self._band_plans[key]

    def band_plan_t(self, rtol: float | None = None) -> BandPlanT:
        """Transpose banded plan of the wpsf at `rtol` (None: the channel's
        `wblur_band_rtol`), built at first use and kept per rtol."""
        key = ("t", self.wblur_band_rtol if rtol is None else float(rtol))
        if key not in self._band_plans:
            self._band_plans[key] = build_band_plan_t(self.wpsf, rel_eps=key[1])
        return self._band_plans[key]

    def host_tables(self) -> dict:
        """The channel's host tables: wpsf [K, W, sb], slit weights [S, A, sb],
        the per-pointing forward / transpose gather plans and, staged, the
        box-sum OTF `otf_box` [nla, nlb//2+1]."""
        fwd, adj = self.gather_plans()
        t = {
            "wpsf": self.wpsf,
            "slit_w": self.slit_weights_sub,
            "gather_fwd": fwd,
            "gather_t": adj,
        }
        if self.staged:
            t["otf_box"] = self.otf_combined[0]
        return t

    # ------------------------------------------------------------------
    # data ↔ cube re-projections (host NumPy float64, reference :1326-1410)
    def sliceToCube(self, data) -> np.ndarray:
        """Re-project detector data of pointing 0 into a full-axis cube using
        the dirac spectral response (visualization / initialization aid):
        :meth:`sliceToWindow` on the host, zero outside the band's λ window."""
        out = np.zeros((len(self.global_wavelength_axis),) + self.imshape)
        out[self.wslice] = self.sliceToWindow(data, "cpu").numpy()
        return out

    def sliceToWindow(self, data, device) -> torch.Tensor:
        """:meth:`sliceToCube` on the band's λ window only, [W, Na, Nb]
        float64 on `device`.

        The reference's arithmetic in float64, in three cheaper spellings
        that give its numbers for finite data: the per-slit β-repeat and
        einsum as one contraction over λ_det for all slits, the slit
        scatter added in place, and the reverse bilinear gather over the
        cube pixels the local grid reaches (the others get zero weights)."""
        dev = torch.device(device)
        if isinstance(data, torch.Tensor):
            y = data.to(dev, torch.float64)
        else:
            y = torch.tensor(np.asarray(data), dtype=torch.float64, device=dev)
        y = y.reshape(self.oshape)
        n_aout = self.oshape[3]
        srf = self.srf
        nla, nlb = self.local_im_shape
        W = self.n_wslice
        sa, sb = self.slit_shape[1], self.slit_shape[2]
        # Σ_k y[0, s, k, a]·wpsf[k, l, b] → [S, A, W, sb]
        blurred_t = torch.tensordot(y[0], torch.as_tensor(self.wpsf_dirac, device=dev), dims=([1], [0]))
        local_cube = torch.zeros((W, nla, nlb), dtype=torch.float64, device=dev)
        for s in range(self.instr.n_slit):
            full = torch.zeros((W, sa, sb), dtype=torch.float64, device=dev)
            full[:, : n_aout * srf : srf, :] = blurred_t[s].permute(1, 0, 2)
            sl = self.slicer.get_slit_slices(s)
            local_cube[:, sl[0], sl[1]] += full * torch.as_tensor(self.slicer.get_slit_weights(s, sl),
                                                                  device=dev)
        otf = torch.as_tensor(self._otf_sr.conj() * self.decalf.conj(), device=dev)
        sum_t = torch.fft.irfftn(torch.fft.rfftn(local_cube, dim=(-2, -1), norm="ortho") * otf,
                                 s=(nla, nlb), dim=(-2, -1), norm="ortho").reshape(W, -1)
        plan = self.plans_rev[0]
        keep = np.flatnonzero((plan.w != 0).any(axis=0))
        idx = torch.as_tensor(plan.idx[:, keep], device=dev)
        w = torch.as_tensor(plan.w[:, keep], device=dev)
        reached = torch.zeros((W, keep.size), dtype=torch.float64, device=dev)
        for c in range(idx.shape[0]):  # numpy_ref.apply_plan's corner order
            reached += w[c] * sum_t[:, idx[c]]
        out = torch.zeros((W, self.imshape[0] * self.imshape[1]), dtype=torch.float64, device=dev)
        out[:, torch.as_tensor(keep, device=dev)] = reached
        return out.reshape((W,) + self.imshape)

    def realData_cubeToSlice(self, cube) -> np.ndarray:
        """Project a λ-window cube to detector slices without spectral blur
        (β-sum only, at the unshifted FOV; reference :303-309)."""
        cube = np.asarray(cube)
        n_aout = self.oshape[3]
        fov = self.instr.fov + Coord(0, 0)
        ga, gb = fov.local2global(self.local_alpha_axis, self.local_beta_axis)
        plan0 = bilinear.bilinear_plan(self.alpha_axis, self.beta_axis, bilinear.grid_points(ga, gb))
        gridded = numpy_ref.apply_plan(plan0, cube).reshape(cube.shape[0], *self.local_im_shape)
        slices = np.zeros(self.oshape[1:])
        for s in range(self.instr.n_slit):
            sliced = self.slicer.slicing(gridded, s)[:, : n_aout * self.srf : self.srf, :]
            slices[s] = sliced.sum(axis=2)
        return slices

    def realData_sliceToCube(self, slices, cube_dim) -> np.ndarray:
        """β-duplicate detector slices back to a cube (reference :311-336)."""
        slices = np.asarray(slices)
        nla, nlb = self.local_im_shape
        W = cube_dim[0]
        nbw = self.slicer.npix_slit_beta_width
        gridded = np.zeros((W, nla, nlb))
        for s in range(self.instr.n_slit):
            sl = self.slicer.get_slit_slices(s)
            sa = sl[0].stop - sl[0].start
            sb = sl[1].stop - sl[1].start
            tmp = np.repeat(slices[s][:, :, np.newaxis], nbw, axis=2) / nbw
            sliced = np.zeros((W, sa, sb))
            sliced[:, : W * self.srf : self.srf] = tmp[:, : sliced[:, :: self.srf].shape[1]]
            gridded += self.slicer.slicing_t(sliced, s, (W, nla, nlb))
        sum_t = np.fft.irfftn(
            np.fft.rfftn(gridded, axes=(-2, -1), norm="ortho") * self._otf_sr.conj(),
            s=(nla, nlb), axes=(-2, -1), norm="ortho",
        )
        fov = self.instr.fov + Coord(0, 0)
        la, lb = fov.global2local(self.alpha_axis, self.beta_axis)
        plan0 = bilinear.bilinear_plan(self.local_alpha_axis, self.local_beta_axis,
                                       bilinear.grid_points(la, lb), fill_out_of_bounds=True)
        return numpy_ref.apply_plan(plan0, sum_t).reshape(W, *self.imshape)

    # ------------------------------------------------------------------
    # device side (tables from `models.spectro`, or the channel's own from
    # `to`): one pipeline for every mode, on rows of Q planes — Q = M·R
    # rank-basis planes (rank mode) or Q = W λ-planes (W-plane mode).  The
    # blur is the dense GEMM against t["wq"] [K, sb·Q], or with `banded`
    # the banded kernel pair on t["band"] (W-plane mode only).  `plain=True`
    # runs every kernel's plain version instead (the comparison on the card).
    def bbox_rows(self, planes) -> torch.Tensor:
        """The FOV-bbox patch of λ-planes [W, Na, Nb], or of a list of
        consecutive pieces of them (the λ-chunks of
        `fft.conv_otf_chunks`, cut by `fft.cube_planes`), laid out
        pixel-major for the gather: [ha·wb, W] (a copy)."""
        a0, b0, ha, wb = self.tbbox
        if not isinstance(planes, torch.Tensor):
            return torch.cat([p[:, a0 : a0 + ha, b0 : b0 + wb].permute(1, 2, 0) for p in planes],
                             dim=2).view(ha * wb, -1)
        patch = planes[:, a0 : a0 + ha, b0 : b0 + wb]
        # a bbox of whole planes would reshape to a strided view: force the copy
        return patch.permute(1, 2, 0).reshape(ha * wb, -1).contiguous()

    def add_bbox_rows_(self, planes: torch.Tensor, rows: torch.Tensor) -> None:
        """Transpose of :meth:`bbox_rows`: add rows [ha·wb, W] into `planes`."""
        a0, b0, ha, wb = self.tbbox
        planes[:, a0 : a0 + ha, b0 : b0 + wb].add_(rows.view(ha, wb, -1).permute(2, 0, 1))

    def _slit_windows(self, loc: torch.Tensor, t: dict, fft_box: bool = False) -> torch.Tensor:
        """Staged box-sum and slit read: local-grid rows [nla·nlb, Q] →
        window rows [S·A·sb, Q] (reference `_forward_one_pointing`): the
        direct reshape-sum of srf rows at the calibrated offset, or with no
        offset (or `fft_box`) the FFT × otf_combined box-sum read every
        srf-th row."""
        nla, nlb = self.local_im_shape
        _, S, _, A = self.oshape
        sb, srf = self.slit_shape[2], self.srf
        q = loc.shape[1]
        img = loc.view(nla, nlb, q)
        starts = zip(self.slit_a_starts.tolist(), self.slit_b_starts.tolist())
        off = None if fft_box else self.box_offset
        if off is None:
            spec = torch.fft.rfftn(img, dim=(0, 1), norm="ortho") * t["otf_box"][:, :, None]
            img = torch.fft.irfftn(spec, s=(nla, nlb), dim=(0, 1), norm="ortho")
            wins = [img[a0 : a0 + (A - 1) * srf + 1 : srf, b0 : b0 + sb] for a0, b0 in starts]
        else:
            wins = [img[a0 + off : a0 + off + A * srf, b0 : b0 + sb].reshape(A, srf, sb, q).sum(1)
                    for a0, b0 in starts]
        return torch.stack(wins).reshape(S * A * sb, q)

    def _slit_windows_t(self, win: torch.Tensor, t: dict, fft_box: bool = False) -> torch.Tensor:
        """Exact transpose of :meth:`_slit_windows`: window rows → local-grid
        rows (adjacent slits share a β edge column: the adds accumulate)."""
        nla, nlb = self.local_im_shape
        _, S, _, A = self.oshape
        sb, srf = self.slit_shape[2], self.srf
        q = win.shape[1]
        w4 = win.view(S, A, sb, q)
        img = win.new_zeros((nla, nlb, q))
        starts = zip(self.slit_a_starts.tolist(), self.slit_b_starts.tolist())
        off = None if fft_box else self.box_offset
        if off is None:
            for s, (a0, b0) in enumerate(starts):
                img[a0 : a0 + (A - 1) * srf + 1 : srf, b0 : b0 + sb] += w4[s]
            spec = torch.fft.rfftn(img, dim=(0, 1), norm="ortho") * t["otf_box"].conj()[:, :, None]
            img = torch.fft.irfftn(spec, s=(nla, nlb), dim=(0, 1), norm="ortho")
        else:
            for s, (a0, b0) in enumerate(starts):
                img[a0 + off : a0 + off + A * srf, b0 : b0 + sb].view(A, srf, sb, q).add_(
                    w4[s][:, None])
        return img.reshape(nla * nlb, q).contiguous()  # the FFT's output is strided

    def forward_rows(self, src: torch.Tensor, t: dict, plain: bool = False,
                     banded: bool = False) -> torch.Tensor:
        """Patch rows src [ha·wb, Q] → detector blocks [P, S, K, A]: per
        pointing the composed gather (or the staged gather, box-sum and slit
        read), the slit weights, the spectral blur."""
        P, S, K, A = self.oshape
        sb = self.slit_shape[2]
        q = src.shape[1]
        gather = gather_rows_reference if plain else gather_rows
        blur = wblur_banded_reference if plain else wblur_banded
        outs = []
        for p in range(P):
            win = gather(src, t["gather_fwd"][p])  # [S·A·sb, Q], staged: [nla·nlb, Q]
            if self.staged:
                win = self._slit_windows(win, t)
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
            win = (win.view(S * A, sb, q) * t["slit_w"]).view(S * A * sb, q)
            if self.staged:
                win = self._slit_windows_t(win, t)
            patch = gather(win, t["gather_t"][p])
            acc = patch if acc is None else acc.add_(patch)
        return acc

    # ------------------------------------------------------------------
    # the channel on cubes (reference `forward` / `adjoint` /
    # `adjoint_windowed` / `adjoint_interp`), after `to`
    def to(self, device, dtype=torch.float32) -> "Channel":
        """Put the channel's own tables (gather plans, slit weights, the
        dense wpsf table, staged: the box-sum OTF; banded: the band tables
        of both plans) on `device` in `dtype`."""
        self.device = torch.device(device)
        self.dtype = dtype
        t = self.host_tables()
        wpsf = torch.as_tensor(np.asarray(t["wpsf"])).to(device=self.device, dtype=dtype)
        self.tables = {**gather_device_tables(t, self.device, dtype), "wq": rows_table(wpsf)}
        if self.wblur_impl == "banded":
            self.tables["band"] = banded_tables(wpsf, self.band_plan(), self.band_plan_t())
        self._rev_dev = None
        return self

    def _tensor(self, a, shape) -> torch.Tensor:
        if self.tables is None:
            raise RuntimeError("call .to(device, dtype) before applying the channel")
        return torch.as_tensor(a).to(device=self.device, dtype=self.dtype).reshape(shape)

    def forward(self, cube, plain: bool = False) -> torch.Tensor:
        """cube [L, Na, Nb] → detector blocks [P, S, λ_det, α_out]; a banded
        channel's blur is kernel #2 (`plain`: its masked-GEMM version)."""
        x = self._tensor(cube, self.ishape)
        ws = self.wslice
        return self.forward_rows(self.bbox_rows(x[ws.start : ws.stop]), self.tables, plain,
                                 banded=self.wblur_impl == "banded")

    def adjoint_windowed(self, y, plain: bool = False) -> torch.Tensor:
        """Exact transpose of the dense :meth:`forward` restricted to the λ
        window (on a banded channel too, as the reference's):
        [P, S, λ_det, α_out] → [W, Na, Nb]."""
        rows = self.adjoint_rows(self._tensor(y, self.oshape), self.tables, plain)
        out = torch.zeros((self.n_wslice,) + self.imshape, device=self.device, dtype=self.dtype)
        self.add_bbox_rows_(out, rows)
        return out

    def adjoint(self, y, plain: bool = False) -> torch.Tensor:
        """Exact transpose of the dense :meth:`forward`: → cube [L, Na, Nb],
        zero outside the band's λ window."""
        out = torch.zeros(self.ishape, device=self.device, dtype=self.dtype)
        ws = self.wslice
        out[ws.start : ws.stop] = self.adjoint_windowed(y, plain)
        return out

    def adjoint_interp(self, y, plain: bool = False) -> torch.Tensor:
        """The reference's approximate adjoint (reference
        `_adjoint_interp_fn`): per pointing and slit the β-repeat and wblur_t,
        the α upsample and β weights, the conj box-sum OTF, then the reverse
        plans onto the cube grid (kernel #1) → the λ-window cube [W, Na, Nb]."""
        y = self._tensor(y, self.oshape)
        P, S, K, A = self.oshape
        nla, nlb = self.local_im_shape
        sb, srf = self.slit_shape[2], self.srf
        W = self.n_wslice
        if self._rev_dev is None:
            n_loc = nla * nlb
            self._rev_dev = [plan_from_gather_table(p.idx, p.w, n_loc).to(self.device, self.dtype)
                             for p in self.plans_rev]
        otf_c = torch.as_tensor(self.otf_combined_conj[0]).to(self.device, complex_dtype(self.dtype))
        wrow = torch.as_tensor(self.slit_weights_sub[:, 0, :]).to(self.device, self.dtype)  # [S, sb]
        gather = gather_rows_reference if plain else gather_rows
        out = None
        for p in range(P):
            local = torch.zeros((nla, nlb, W), device=self.device, dtype=self.dtype)
            for s, (a0, b0) in enumerate(zip(self.slit_a_starts.tolist(),
                                             self.slit_b_starts.tolist())):
                bt = wblur_rows_t(y[p, s].T, self.tables["wq"]).view(A, sb, W)
                local[a0 : a0 + A * srf : srf, b0 : b0 + sb] += bt * wrow[s][None, :, None]
            spec = torch.fft.rfftn(local, dim=(0, 1), norm="ortho") * otf_c[:, :, None]
            sum_t = torch.fft.irfftn(spec, s=(nla, nlb), dim=(0, 1), norm="ortho")
            rows = gather(sum_t.reshape(nla * nlb, W).contiguous(), self._rev_dev[p])
            out = rows if out is None else out.add_(rows)
        return out.T.reshape((W,) + self.imshape)
