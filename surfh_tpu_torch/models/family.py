"""The single-stage operator ladder (the reference's `surfh.DottestModels`).

Counterpart of `surfh_tpu/models/family.py`: the same 17 exported
operators plus `SpectroSCT`, `SpectroLST` and `SpectroMO_ST`, with the
reference's constructors (then `device`, None: the card) and its
reference-name aliases.  Operator letters: T = LMM template mixing, C =
spatial convolution (λ-dependent PSF via FFT), S = cube → local-FOV
gridding, L = slit extraction with edge weights, R = spectral blur, Sig =
β-integration + α-subsampling onto detector pixels, MO = multi-pointing,
MC = multi-channel.

Each operator is a `core.linop.LinOp`: the host tables (NumPy, as the
reference builds them) go to `device` once, at construction, and the
forward is plain torch on them; the adjoint is the forward's exact
transpose, derived (`LinOp.derived_adjoint`), as the reference derives it
with `jax.linear_transpose`.  The gridding operators hold each plan as a
`RowGatherPlan` built at construction and gather through
`bilinear.gather_planes`: kernel #1 on the card in both directions (its
backward is the gather on the plan's cached transpose).  The channel
operators run the port's `Channel` on the λ-window's FOV-bbox rows; their
gathers go through `GatherRows` under the derived adjoint.  The kernel is
float32: a float64 operator on the card takes the plain gather
(``plain=True`` on `forward` / `adjoint` / `normal`), as the card's
comparisons do.

`MCMO_SigRLSCT` is the flagship `models.spectro.SpectroSigRLSCT` itself
(call ``.to(device, dtype)`` before applying it), `MCMO_SigRLSCT_NN` the
same with ``gridding="nn"``.
"""

from __future__ import annotations

from math import ceil
from typing import List, Optional

import numpy as np
import torch

from ..core import bilinear, fft, lmm, wblur
from ..core.linop import LinOp, complex_dtype, torch_dtype
from ..core.nearest import nearest_plan
from ..instrument.geometry import Coord, CoordList, get_srf
from ..instrument.ifu import IFU
from .channel import Channel
from .slicer import Slicer
from .spectro import SpectroSigRLSCT as MCMO_SigRLSCT


def _npdtypes(dtype):
    if torch_dtype(dtype) == torch.float32:
        return np.float32, np.complex64
    return np.float64, np.complex128


class _FamilyOp(LinOp):
    """Shared body: `_fwd(x, plain)` on a device tensor of `ishape`, the
    derived adjoint, and the table uploads."""

    def _fwd(self, x: torch.Tensor, plain: bool) -> torch.Tensor:
        raise NotImplementedError

    def _real(self, a) -> torch.Tensor:
        return torch.as_tensor(a).to(device=self.device, dtype=self.dtype)

    def _complex(self, a) -> torch.Tensor:
        return torch.as_tensor(a).to(device=self.device, dtype=complex_dtype(self.dtype))

    def forward(self, x, plain: bool = False) -> torch.Tensor:
        return self._fwd(self._x(x), plain)

    def adjoint(self, y, plain: bool = False) -> torch.Tensor:
        """Exact transpose of :meth:`forward` (derived)."""
        return self.derived_adjoint(lambda x: self._fwd(x, plain), ("forward", plain), self._y(y))

    def normal(self, x, plain: bool = False) -> torch.Tensor:
        return self.adjoint(self.forward(x, plain), plain)


class _MapsCubeMixin:
    """mapsToCube / cubeTomaps (the reference's fusion demo scripts call
    them on every family model)."""

    def _tpl64(self) -> torch.Tensor:
        return torch.as_tensor(np.asarray(self.templates, np.float64)).to(self.device, self.dtype)

    def mapsToCube(self, maps) -> torch.Tensor:
        return lmm.lmm_maps2cube(torch.as_tensor(maps).to(self.device, self.dtype), self._tpl64())

    def cubeTomaps(self, cube) -> torch.Tensor:
        return lmm.lmm_cube2maps(torch.as_tensor(cube).to(self.device, self.dtype), self._tpl64())


class SpectroT(_FamilyOp):
    """y = T a — LMM template mixing (reference T_Model.spectroT)."""

    def __init__(self, maps, templates, wavelength_axis, dtype=torch.float32, device=None):
        maps = np.asarray(maps)
        self.templates = np.asarray(templates)
        self.wavelength_axis = np.asarray(wavelength_axis)
        super().__init__(maps.shape, (len(wavelength_axis), maps.shape[1], maps.shape[2]), dtype,
                         device)
        self._tpl = self._real(templates)

    def _fwd(self, x, plain):
        return lmm.lmm_maps2cube(x, self._tpl)


class SpectroC(_FamilyOp):
    """y = C x — spatial convolution of a cube (reference C_Model.spectroC).
    `sotf` may be a tensor (e.g. the flagship OTF on the card): it is used
    where it lies when it is already in the complex type.  The attribute
    `sotf` is the OTF as given: a host array as the reference keeps it, or
    that tensor (not copied to the host)."""

    def __init__(self, sotf, maps, templates, wavelength_axis, dtype=torch.float32, device=None):
        maps = np.asarray(maps)
        self.sotf = sotf if isinstance(sotf, torch.Tensor) else np.asarray(sotf)
        shape = (len(wavelength_axis), maps.shape[1], maps.shape[2])
        super().__init__(shape, shape, dtype, device)
        self._sotf = self._complex(sotf)
        self._imshape = shape[1:]

    def _fwd(self, x, plain):
        return fft.convolve_freq(x, self._sotf, self._imshape)


class SpectroCT(_FamilyOp):
    """y = C T a (reference CT_Model.spectroCT)."""

    def __init__(self, sotf, templates, alpha_axis, beta_axis, wavelength_axis,
                 dtype=torch.float32, device=None):
        templates = np.asarray(templates)
        ishape = (templates.shape[0], len(alpha_axis), len(beta_axis))
        oshape = (len(wavelength_axis), len(alpha_axis), len(beta_axis))
        super().__init__(ishape, oshape, dtype, device)
        self._tpl = self._real(templates)
        self._sotf = self._complex(sotf)
        self._imshape = oshape[1:]

    def _fwd(self, x, plain):
        return fft.convolve_freq(lmm.lmm_maps2cube(x, self._tpl), self._sotf, self._imshape)


def _origin_plan(instr, alpha_axis, beta_axis, step_degree, mode="bilinear", margin=0.0):
    """Gather plan from the global grid onto the instrument's local grid
    (one pointing at the FOV origin), plus the local axes (host)."""
    local_a, local_b = instr.fov.local_coords(step_degree, margin, margin)
    ga, gb = instr.fov.local2global(local_a, local_b)
    pts = bilinear.grid_points(ga, gb)
    if mode == "nn":
        plan = nearest_plan(alpha_axis, beta_axis, pts)
    else:
        plan = bilinear.bilinear_plan(alpha_axis, beta_axis, pts)
    return local_a, local_b, plan


class _GridOp(_FamilyOp):
    """A family operator whose gridding plans are row gathers on `device`."""

    def _row_plan(self, plan, n_src: int):
        return bilinear.row_plan(plan.idx, plan.w, n_src, self.device, self.dtype)

    def _grid(self, rplan, cube, plain, local_shape):
        """cube [W, Na, Nb] → its local grid [W, nla, nlb] (kernel #1)."""
        return bilinear.gather_planes(rplan, cube, plain).reshape((cube.shape[0],) + local_shape)


class SpectroST(_GridOp):
    """y = S T a — LMM then gridding onto the rotated local FOV grid
    (reference ST_Model.spectroST)."""

    _gridding = "bilinear"

    def __init__(self, sotf, templates, alpha_axis, beta_axis, wavelength_axis, instr: IFU,
                 step_degree: float, dtype=torch.float32, device=None):
        templates = np.asarray(templates)
        self.instr = instr.pix(step_degree)
        local_a, local_b, plan = _origin_plan(self.instr, alpha_axis, beta_axis, step_degree,
                                              self._gridding)
        self.local_alpha_axis, self.local_beta_axis = local_a, local_b
        ishape = (templates.shape[0], len(alpha_axis), len(beta_axis))
        oshape = (len(wavelength_axis), len(local_a), len(local_b))
        super().__init__(ishape, oshape, dtype, device)
        self._tpl = self._real(templates)
        self._plan = self._row_plan(plan, ishape[1] * ishape[2])

    def _fwd(self, x, plain):
        return self._grid(self._plan, lmm.lmm_maps2cube(x, self._tpl), plain, self.oshape[1:])


class SpectroSnearestT(SpectroST):
    """y = S_NN T a — nearest-neighbor gridding variant
    (reference ST_Model.spectroSnearestT)."""

    _gridding = "nn"


class SpectroSCT(_MapsCubeMixin, _GridOp):
    """y = S C T a — LMM, λ-dependent PSF convolution, then gridding onto
    the rotated local FOV grid (reference SCT_Model.SCT_spectro)."""

    _gridding = "bilinear"

    def __init__(self, sotf, templates, alpha_axis, beta_axis, wavelength_axis, instr: IFU,
                 step_degree: float, dtype=torch.float32, device=None):
        templates = np.asarray(templates)
        self.templates = templates
        self.instr = instr.pix(step_degree)
        local_a, local_b, plan = _origin_plan(self.instr, alpha_axis, beta_axis, step_degree,
                                              self._gridding)
        self.local_alpha_axis, self.local_beta_axis = local_a, local_b
        ishape = (templates.shape[0], len(alpha_axis), len(beta_axis))
        oshape = (len(wavelength_axis), len(local_a), len(local_b))
        super().__init__(ishape, oshape, dtype, device)
        self._tpl = self._real(templates)
        self._sotf = self._complex(sotf)
        self._plan = self._row_plan(plan, ishape[1] * ishape[2])

    def _fwd(self, x, plain):
        blurred = fft.convolve_freq(lmm.lmm_maps2cube(x, self._tpl), self._sotf, self.ishape[1:])
        return self._grid(self._plan, blurred, plain, self.oshape[1:])


class SpectroLT(_GridOp):
    """y = L T a — LMM, gridding, then slit extraction
    (reference LT_Model.spectroLT)."""

    def __init__(self, sotf, templates, alpha_axis, beta_axis, wavelength_axis, instr: IFU,
                 step_degree: float, dtype=torch.float32, device=None):
        templates = np.asarray(templates)
        self.instr = instr.pix(step_degree)
        local_a, local_b, plan = _origin_plan(self.instr, alpha_axis, beta_axis, step_degree,
                                              margin=5 * step_degree)
        self.slicer = Slicer(self.instr, wavelength_axis=np.asarray(wavelength_axis),
                             alpha_axis=np.asarray(alpha_axis), beta_axis=np.asarray(beta_axis),
                             local_alpha_axis=local_a, local_beta_axis=local_b, srf=1)
        a0s, b0s, weights = self.slicer.slit_tables()
        _, sa, sb = self.slicer.get_slit_shape()
        ishape = (templates.shape[0], len(alpha_axis), len(beta_axis))
        oshape = (self.instr.n_slit, len(wavelength_axis), sa, sb)
        super().__init__(ishape, oshape, dtype, device)
        self._tpl = self._real(templates)
        self._plan = self._row_plan(plan, ishape[1] * ishape[2])
        self._wts = self._real(weights)
        self._starts = list(zip(np.asarray(a0s).tolist(), np.asarray(b0s).tolist()))
        self._local_shape = (len(local_a), len(local_b))

    def _fwd(self, x, plain):
        local = self._grid(self._plan, lmm.lmm_maps2cube(x, self._tpl), plain, self._local_shape)
        _, _, sa, sb = self.oshape
        return torch.stack([local[:, a0 : a0 + sa, b0 : b0 + sb] * self._wts[s]
                            for s, (a0, b0) in enumerate(self._starts)])


class SpectroLST(_MapsCubeMixin, SpectroLT):
    """y = L S T a — LMM, explicit rotated-FOV gridding, then slit
    extraction (reference LST_Model.spectroLST): the :class:`SpectroLT`
    pipeline, kept distinct as the reference keeps it."""

    def __init__(self, sotf, templates, alpha_axis, beta_axis, wavelength_axis, instr: IFU,
                 step_degree: float, dtype=torch.float32, device=None):
        super().__init__(sotf, templates, alpha_axis, beta_axis, wavelength_axis, instr,
                         step_degree, dtype=dtype, device=device)
        self.templates = np.asarray(templates)


class SpectroMO_ST(_MapsCubeMixin, _GridOp):
    """y[p] = S_p T a — multi-pointing gridding of the mixed cube, one
    rotated-local-FOV resampling per dither pointing (reference
    MO_ST_Model.spectroST): shared local axes from the unshifted FOV,
    gather points from `(fov + pointing).local2global`."""

    def __init__(self, sotf, templates, alpha_axis, beta_axis, wavelength_axis, instr: IFU,
                 step_degree: float, pointings, dtype=torch.float32, device=None):
        templates = np.asarray(templates)
        self.templates = templates
        self.instr = instr.pix(step_degree)
        self.pointings = CoordList(pointings).pix(step_degree)
        local_a, local_b = self.instr.fov.local_coords(step_degree, 0.0, 0.0)
        self.local_alpha_axis, self.local_beta_axis = local_a, local_b
        plans = []
        for p in self.pointings:
            ga, gb = (self.instr.fov + p).local2global(local_a, local_b)
            plans.append(bilinear.bilinear_plan(np.asarray(alpha_axis), np.asarray(beta_axis),
                                                bilinear.grid_points(ga, gb)))
        ishape = (templates.shape[0], len(alpha_axis), len(beta_axis))
        oshape = (len(self.pointings), len(wavelength_axis), len(local_a), len(local_b))
        super().__init__(ishape, oshape, dtype, device)
        self._tpl = self._real(templates)
        self._plans = [self._row_plan(p, ishape[1] * ishape[2]) for p in plans]

    def _fwd(self, x, plain):
        cube = lmm.lmm_maps2cube(x, self._tpl)
        return torch.stack([self._grid(p, cube, plain, self.oshape[2:]) for p in self._plans])


def _full_image_wpsf(instr, wavelength_axis, beta_axis):
    """wpsf [λ_det, λ_cube, Nβ] over the full image β extent."""
    beta_step = beta_axis[1] - beta_axis[0]
    beta = np.arange(len(beta_axis)) * beta_step
    return instr.spectral_psf(beta - np.mean(beta), np.asarray(wavelength_axis),
                              arcsec2micron=instr.wavel_step / instr.det_pix_size, type="mrs")


def _slit_wpsf(instr, wavelength_axis, beta_axis, sb: int):
    """wpsf [λ_det, λ_cube, sb] over one slit's β extent (channel convention)."""
    beta_in_slit = np.arange(sb) * (beta_axis[1] - beta_axis[0])
    return instr.spectral_psf(beta_in_slit - np.mean(beta_in_slit), wavelength_axis,
                              arcsec2micron=instr.wavel_step / instr.det_pix_size, type="mrs")


class SpectroR(_MapsCubeMixin, _FamilyOp):
    """y = R x — spectral blur of a cube (reference R_Model.spectroR): the
    full-image wpsf [λ_det, λ, Nβ], one GEMM per β."""

    def __init__(self, sotf, templates, alpha_axis, beta_axis, wavelength_axis, instr: IFU,
                 step_degree: float, dtype=torch.float32, device=None):
        self.templates = np.asarray(templates)
        self.instr = instr.pix(step_degree)
        self.wavelength_axis = np.asarray(wavelength_axis)
        wpsf = _full_image_wpsf(self.instr, wavelength_axis, beta_axis)
        ishape = (len(wavelength_axis), len(alpha_axis), len(beta_axis))
        oshape = (wpsf.shape[0], len(alpha_axis), len(beta_axis))
        super().__init__(ishape, oshape, dtype, device)
        self._wpsf = self._real(wpsf)

    def _fwd(self, x, plain):
        return wblur.wblur(x, self._wpsf)


class _RLBase(_GridOp):
    """Shared R∘L pipeline: gridding → slit windows → per-slit spectral blur."""

    _with_lmm = False

    def __init__(self, sotf, templates, alpha_axis, beta_axis, wavelength_axis, instr: IFU,
                 step_degree: float, dtype=torch.float32, device=None):
        templates = np.asarray(templates)
        self.instr = instr.pix(step_degree)
        self.wavelength_axis = np.asarray(wavelength_axis)
        local_a, local_b, plan = _origin_plan(self.instr, alpha_axis, beta_axis, step_degree,
                                              margin=5 * step_degree)
        self.slicer = Slicer(self.instr, wavelength_axis=self.wavelength_axis,
                             alpha_axis=np.asarray(alpha_axis), beta_axis=np.asarray(beta_axis),
                             local_alpha_axis=local_a, local_beta_axis=local_b, srf=1)
        a0s, b0s, weights = self.slicer.slit_tables()
        _, sa, sb = self.slicer.get_slit_shape()
        wpsf = _slit_wpsf(self.instr, self.wavelength_axis, beta_axis, sb)
        if self._with_lmm:
            ishape = (templates.shape[0], len(alpha_axis), len(beta_axis))
        else:
            ishape = (len(wavelength_axis), len(alpha_axis), len(beta_axis))
        oshape = (self.instr.n_slit, wpsf.shape[0], sa, sb)
        super().__init__(ishape, oshape, dtype, device)
        self._tpl = self._real(templates)
        self._plan = self._row_plan(plan, len(alpha_axis) * len(beta_axis))
        self._wts = self._real(weights)
        self._wpsf = self._real(wpsf)
        self._starts = list(zip(np.asarray(a0s).tolist(), np.asarray(b0s).tolist()))
        self._local_shape = (len(local_a), len(local_b))

    def _fwd(self, x, plain):
        cube = lmm.lmm_maps2cube(x, self._tpl) if self._with_lmm else x
        local = self._grid(self._plan, cube, plain, self._local_shape)
        _, _, sa, sb = self.oshape
        slits = torch.stack([local[:, a0 : a0 + sa, b0 : b0 + sb] * self._wts[s]
                             for s, (a0, b0) in enumerate(self._starts)])  # [S, λ, sa, sb]
        return wblur.wblur(slits, self._wpsf)


class SpectroRL(_RLBase):
    """y = R L x on a cube (reference RL_Model.spectroRL)."""

    _with_lmm = False


class SpectroRLT(_RLBase):
    """y = R L T a on abundance maps (reference RLT_Model.spectroRLT)."""

    _with_lmm = True


class _SigRLBase(_GridOp):
    """Shared Sig∘R∘L(∘C)∘T pipeline: LMM (+conv), gridding, slits,
    β-integrating spectral blur, α subsampling."""

    _with_conv = False

    def __init__(self, sotf, templates, alpha_axis, beta_axis, wavelength_axis, instr: IFU,
                 step_degree: float, dtype=torch.float32, device=None):
        templates = np.asarray(templates)
        self.instr = instr.pix(step_degree)
        self.wavelength_axis = np.asarray(wavelength_axis)
        self.srf = get_srf([instr.det_pix_size], step_degree * 3600)[0]
        local_a, local_b, plan = _origin_plan(self.instr, alpha_axis, beta_axis, step_degree,
                                              margin=5 * step_degree)
        self.slicer = Slicer(self.instr, wavelength_axis=self.wavelength_axis,
                             alpha_axis=np.asarray(alpha_axis), beta_axis=np.asarray(beta_axis),
                             local_alpha_axis=local_a, local_beta_axis=local_b, srf=self.srf)
        a0s, b0s, weights = self.slicer.slit_tables()
        _, sa, sb = self.slicer.get_slit_shape()
        n_aout = ceil(self.slicer.npix_slit_alpha_width / self.srf)
        wpsf = _slit_wpsf(self.instr, self.wavelength_axis, beta_axis, sb)
        ishape = (templates.shape[0], len(alpha_axis), len(beta_axis))
        oshape = (self.instr.n_slit, wpsf.shape[0], n_aout)
        super().__init__(ishape, oshape, dtype, device)
        self._tpl = self._real(templates)
        self._sotf = self._complex(sotf) if self._with_conv else None
        self._plan = self._row_plan(plan, len(alpha_axis) * len(beta_axis))
        self._wts = self._real(weights[:, : n_aout * self.srf : self.srf, :])
        self._wpsf = self._real(wpsf)
        self._starts = list(zip(np.asarray(a0s).tolist(), np.asarray(b0s).tolist()))
        self._local_shape = (len(local_a), len(local_b))
        self._sb = sb

    def _fwd(self, x, plain):
        cube = lmm.lmm_maps2cube(x, self._tpl)
        if self._with_conv:
            cube = fft.convolve_freq(cube, self._sotf, self.ishape[1:])
        local = self._grid(self._plan, cube, plain, self._local_shape)
        n_aout, srf, sb = self.oshape[2], self.srf, self._sb
        windows = torch.stack([local[:, a0 : a0 + n_aout * srf : srf, b0 : b0 + sb]
                               for a0, b0 in self._starts])
        return wblur.wblur_sum_beta_batched(windows * self._wts[:, None], self._wpsf)


class SpectroSigRLT(_SigRLBase):
    """y = Sig R L T a (reference SigRLT_Model.spectroSigRLT)."""

    _with_conv = False


class SpectroSigRLCT(_SigRLBase):
    """y = Sig R L C T a (reference SigRLCT_Model.spectroSigRLCT)."""

    _with_conv = True


class _ChannelModel(_FamilyOp):
    """Shared wrapper: the full Sig·R·L·S·C·T pipeline of one channel — T,
    the FFT conv, then the port's `Channel` on the λ-window's FOV-bbox
    rows (`Channel.forward_rows`: per pointing the composed gather, slit
    weights, dense spectral blur)."""

    _gridding = "bilinear"

    def __init__(self, sotf, templates, alpha_axis, beta_axis, wavelength_axis, instr: IFU,
                 step_degree: float, pointings: Optional[CoordList] = None, dtype=torch.float32,
                 device=None):
        templates = np.asarray(templates)
        self.multi_pointing = pointings is not None
        if pointings is None:
            pointings = CoordList([Coord(0, 0)])
        npdt, _ = _npdtypes(dtype)
        srf = get_srf([instr.det_pix_size], step_degree * 3600)[0]
        self.channel = Channel(instr, np.asarray(alpha_axis), np.asarray(beta_axis),
                               np.asarray(wavelength_axis), srf, CoordList(pointings), step_degree,
                               dtype=npdt, gridding=self._gridding)
        chan = self.channel
        ishape = (templates.shape[0], len(alpha_axis), len(beta_axis))
        oshape = chan.oshape if self.multi_pointing else chan.oshape[1:]
        super().__init__(ishape, oshape, dtype, device)
        self._tpl = self._real(templates)
        self._sotf = self._complex(sotf)
        chan.to(self.device, self.dtype)

    def _fwd(self, x, plain):
        chan = self.channel
        blurred = fft.convolve_freq(lmm.lmm_maps2cube(x, self._tpl), self._sotf, self.ishape[1:])
        ws = chan.wslice
        out = chan.forward_rows(chan.bbox_rows(blurred[ws.start : ws.stop]), chan.tables, plain)
        return out if self.multi_pointing else out[0]


class SpectroSigRLSCT1C(_ChannelModel):
    """Single-channel single-pointing y = Sig R L S C T a
    (reference SigRLSCT_Model.spectroSigRLSCT)."""


class SpectroSigRLSCT1C_NN(_ChannelModel):
    """NN-gridding variant (reference SigRLSCT_Model.spectroSigRLSCT_NN)."""

    _gridding = "nn"


class MO_SigRLSCT(_ChannelModel):
    """Multi-pointing single-channel model
    (reference MO_SigRLSCT_Model.spectroSigRLSCT)."""

    def __init__(self, sotf, templates, alpha_axis, beta_axis, wavelength_axis, instr,
                 step_degree, pointings, dtype=torch.float32, device=None):
        super().__init__(sotf, templates, alpha_axis, beta_axis, wavelength_axis, instr,
                         step_degree, pointings=CoordList(pointings), dtype=dtype, device=device)


class MO_SigRLSCT_shiftConv(_GridOp):
    """Multi-pointing variant with the dither applied as a Fourier phase
    ramp on one gridded FOV instead of per-pointing regridding (reference
    MO_SigRLSCT_Model.spectroSigRLSCT_corrected): pointing 0's plan onto
    the local grid (kernel #1), the FFT there, one shift OTF per pointing,
    then the strided slit read, the slit weights and the β-summed blur."""

    def __init__(self, sotf, templates, alpha_axis, beta_axis, wavelength_axis, instr: IFU,
                 step_degree: float, pointings, dtype=torch.float32, device=None):
        templates = np.asarray(templates)
        pointings = CoordList(pointings).pix(step_degree)
        npdt, npct = _npdtypes(dtype)
        srf = get_srf([instr.det_pix_size], step_degree * 3600)[0]
        # the channel at the origin pointing provides all static tables
        self.channel = Channel(instr, np.asarray(alpha_axis), np.asarray(beta_axis),
                               np.asarray(wavelength_axis), srf, CoordList([Coord(0, 0)]),
                               step_degree, dtype=npdt)
        chan = self.channel
        ishape = (templates.shape[0], len(alpha_axis), len(beta_axis))
        oshape = (len(pointings),) + chan.oshape[1:]
        super().__init__(ishape, oshape, dtype, device)
        nla, nlb = chan.local_im_shape
        # per-pointing shift OTF on the local grid (cycle/step units)
        fa = np.fft.fftfreq(nla)[:, None]
        fb = np.fft.rfftfreq(nlb)[None, :]
        otfs = []
        for p in pointings:
            shift = np.exp(-2j * np.pi * (fa * (p.alpha / step_degree) + fb * (p.beta / step_degree)))
            otfs.append(self._complex(np.asarray(chan.otf_combined * shift, npct)))
        self._otfs = otfs
        self._tpl = self._real(templates)
        self._sotf = self._complex(sotf)
        self._plan = self._row_plan(chan.plans_fwd[0], ishape[1] * ishape[2])
        self._wts = self._real(chan.slit_weights_sub)
        self._wpsf = self._real(chan.wpsf)
        self._srf = srf

    def _fwd(self, x, plain):
        chan = self.channel
        nla, nlb = chan.local_im_shape
        n_aout, sb, srf = chan.oshape[3], chan.slit_shape[2], self._srf
        blurred = fft.convolve_freq(lmm.lmm_maps2cube(x, self._tpl), self._sotf, self.ishape[1:])
        ws = chan.wslice
        spec = fft.dft(self._grid(self._plan, blurred[ws.start : ws.stop], plain, (nla, nlb)))
        starts = list(zip(chan.slit_a_starts.tolist(), chan.slit_b_starts.tolist()))
        outs = []
        for otf in self._otfs:
            summed = fft.idft(spec * otf, (nla, nlb))
            windows = torch.stack([summed[:, a0 : a0 + n_aout * srf : srf, b0 : b0 + sb]
                                   for a0, b0 in starts])
            outs.append(wblur.wblur_sum_beta_batched(windows * self._wts[:, None], self._wpsf))
        return torch.stack(outs)


def MCMO_SigRLSCT_NN(sotf, templates, alpha_axis, beta_axis, wavelength_axis, instrs: List[IFU],
                     step_degree: float, pointings, dtype=np.float32):
    """NN-gridding flagship (reference MCMO_SigRLSCT_Model.spectroSigRLSCT_NN)."""
    return MCMO_SigRLSCT(sotf, templates, alpha_axis, beta_axis, wavelength_axis, instrs,
                         step_degree, pointings, dtype=dtype, gridding="nn")


# Reference-name aliases (migration aid): the reference instantiates each
# variant as `<X>_Model.spectro<X>(...)`; the module-qualified reference
# name is noted where the bare name repeats.
spectroT = SpectroT
spectroC = SpectroC
spectroCT = SpectroCT
spectroST = SpectroST
spectroSnearestT = SpectroSnearestT
spectroSCT = SpectroSCT
spectroLT = SpectroLT
spectroLST = SpectroLST
spectroMO_ST = SpectroMO_ST
spectroR = SpectroR
spectroRL = SpectroRL
spectroRLT = SpectroRLT
spectroSigRLT = SpectroSigRLT
spectroSigRLCT = SpectroSigRLCT
spectroSigRLSCT_1C = SpectroSigRLSCT1C        # SigRLSCT_Model.spectroSigRLSCT
spectroSigRLSCT_1C_NN = SpectroSigRLSCT1C_NN  # SigRLSCT_Model.spectroSigRLSCT_NN
spectroSigRLSCT_MO = MO_SigRLSCT              # MO_SigRLSCT_Model.spectroSigRLSCT
spectroSigRLSCT_corrected = MO_SigRLSCT_shiftConv  # ….spectroSigRLSCT_corrected
spectroSigRLSCT_MCMO = MCMO_SigRLSCT          # MCMO_SigRLSCT_Model.spectroSigRLSCT
spectroSigRLSCT_MCMO_NN = MCMO_SigRLSCT_NN    # ….spectroSigRLSCT_NN
