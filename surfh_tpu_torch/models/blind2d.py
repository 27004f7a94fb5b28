"""Single-wavelength 2-D MRS models and the λ-stack cube deconvolution.

Counterpart of `surfh_tpu/models/blind2d.py`: the SigLSC pipeline of one λ
plane without the spectral blur — C (FFT PSF) → per-pointing S → SRF
box-sum (FFT × `otf_combined`) → per-slit windows read every srf-th row →
slit weights → β sum.

* `MRSBlurred` — the rotated FOV: S is a bilinear plan per pointing, run as
  a row gather (`core.bilinear.gather_planes`, kernel #1 on the card);
* `MRSBlurredRectangle` — the unrotated FOV: S is a nearest-index crop of
  the sky grid (no gather);
* `DeconvCube` — the λ stack (BASELINE config 2): the reference `vmap`s the
  2-D forward over (plane, OTF) pairs; here the W planes are the leading
  batch axis of the FFTs and the columns of the gathered rows (Q = W).

Host tables (slit starts and weights, plans or windows, OTFs) are NumPy
copies of the reference's; the device tensors are made once, at
construction, on `device` (None: the card).  Every adjoint is derived
(`core.linop.LinOp.derived_adjoint`, `torch.func.vjp`), the reference's
structure; through the gather's gradient it runs kernel #1 on the
transposed plan.  `plain=True` on `forward` / `adjoint` / `normal` runs the
gather's plain torch version instead (the card's comparison, and a float64
model on the card: the kernel is float32).
"""

from __future__ import annotations

from math import ceil, floor
from typing import Tuple

import numpy as np
import torch

from ..core import bilinear, fft
from ..core.linop import LinOp, complex_dtype
from ..instrument.geometry import LocalFOV, get_srf
from ..instrument.ifu import IFU


class _Blind2DBase(LinOp):
    """Shared slit geometry for the 2-D models (no Slicer: one λ plane)."""

    def __init__(self, sotf, alpha_axis, beta_axis, instr: IFU, step_degree, pointings,
                 dtype=np.float32, device=None):
        self.sotf_host = np.asarray(sotf)
        self.alpha_axis = np.asarray(alpha_axis, np.float64)
        self.beta_axis = np.asarray(beta_axis, np.float64)
        self.step_degree = float(step_degree)
        self.instr = instr
        self.pointings = pointings

        self.srf = get_srf([instr.det_pix_size], self.step_degree * 3600)[0]
        la, lb = instr.fov.local_coords(step_degree, 5 * step_degree, 5 * step_degree)
        self.local_alpha_axis, self.local_beta_axis = la, lb
        self.local_im_shape = (len(la), len(lb))

        ishape = (len(self.alpha_axis), len(self.beta_axis))
        self.slices_shape = (len(pointings), instr.n_slit,
                             ceil(self.npix_slit_alpha_width / self.srf))
        super().__init__(ishape, (int(np.prod(self.slices_shape)),), dtype, device)
        self.imshape = self.ishape
        self.npdtype = torch.empty((), dtype=self.dtype).numpy().dtype

        ctype = np.complex64 if self.npdtype == np.float32 else np.complex128
        otf_sr = fft.box_otf_sr(self.srf, self.local_im_shape, np.complex128)[0]
        decalf = fft.half_srf_shift_otf(self.srf, self.local_im_shape, np.complex128)
        self._otf_sr = otf_sr
        self.decalf = decalf
        self.otf_combined = np.asarray(otf_sr * decalf, ctype)
        self.sotf = np.asarray(self.sotf_host, ctype)
        self._build_slit_tables()

        cdt = complex_dtype(self.dtype)
        self._sotf_t = torch.as_tensor(self.sotf).to(self.device, cdt)
        self._otf_t = torch.as_tensor(self.otf_combined).to(self.device, cdt)
        self._slit_w_t = torch.as_tensor(self.slit_weights_sub).to(self.device, self.dtype)

    # slit geometry (reference blind2d.py:73-170)
    @property
    def slit_alpha_width(self):
        return self.instr.fov.alpha_width

    @property
    def npix_slit_alpha_width(self) -> int:
        step = self.local_alpha_axis[1] - self.local_alpha_axis[0]
        return int(ceil(self.slit_alpha_width / 2 / step)) - int(floor(-self.slit_alpha_width / 2 / step))

    @property
    def slit_beta_width(self):
        return self.instr.fov.beta_width / self.instr.n_slit

    @property
    def npix_slit_beta_width(self) -> int:
        return int(ceil(self.slit_beta_width / (self.beta_axis[1] - self.beta_axis[0])))

    def slit_local_fov(self, slit_idx: int) -> LocalFOV:
        return self.instr.slit_fov[slit_idx].local + self.instr.slit_shift[slit_idx]

    def get_slit_slices(self, slit_idx: int) -> Tuple[slice, slice]:
        slices = self.slit_local_fov(slit_idx).to_slices(self.local_alpha_axis, self.local_beta_axis)
        if (slices[1].stop - slices[1].start) > self.npix_slit_beta_width:
            fov = self.slit_local_fov(slit_idx)
            if abs(self.local_beta_axis[slices[1].stop] - fov.beta_end) > abs(
                self.local_beta_axis[slices[1].start] - fov.beta_start
            ):
                slices = (slices[0], slice(slices[1].start, slices[1].stop - 1))
            else:
                slices = (slices[0], slice(slices[1].start + 1, slices[1].stop))
        return slices

    def get_slit_weights(self, slit_idx: int, slices) -> np.ndarray:
        beta_step = self.local_beta_axis[1] - self.local_beta_axis[0]
        fov = self.slit_local_fov(slit_idx)
        sa = slices[0].stop - slices[0].start
        sb = slices[1].stop - slices[1].start
        weights = np.ones((sa, sb))
        sel = self.local_beta_axis[slices[1]]
        if sel[0] - beta_step / 2 < fov.beta_start:
            weights[:, 0] = 1 - abs(sel[0] - beta_step / 2 - fov.beta_start) / beta_step
        if sel[-1] + beta_step / 2 > fov.beta_end:
            weights[:, -1] = 1 - abs(sel[-1] + beta_step / 2 - fov.beta_end) / beta_step
        # neighbour-share rule (the reference compares against
        # npix_slit_beta_width here, not n_slit: kept as it is)
        if slit_idx > 0:
            if self.get_slit_slices(slit_idx - 1)[1].stop - 1 != slices[1].start:
                weights[:, 0] = 1
        if slit_idx < self.npix_slit_beta_width - 1 and slit_idx < self.instr.n_slit - 1:
            if slices[1].stop - 1 != self.get_slit_slices(slit_idx + 1)[1].start:
                weights[:, -1] = 1
        return weights

    def _build_slit_tables(self) -> None:
        shape0 = None
        a_starts, b_starts, weights = [], [], []
        for s in range(self.instr.n_slit):
            sl = self.get_slit_slices(s)
            shp = (sl[0].stop - sl[0].start, sl[1].stop - sl[1].start)
            if shape0 is None:
                shape0 = shp
            elif shp != shape0:
                raise ValueError(f"slit {s} window {shp} != {shape0}")
            a_starts.append(sl[0].start)
            b_starts.append(sl[1].start)
            weights.append(self.get_slit_weights(s, sl))
        self.slit_shape = shape0
        self.slit_a_starts = np.asarray(a_starts, np.int32)
        self.slit_b_starts = np.asarray(b_starts, np.int32)
        n_aout = self.slices_shape[2]
        w = np.stack(weights)
        self.slit_weights_sub = np.asarray(w[:, : n_aout * self.srf : self.srf, :], self.npdtype)

    # pipeline pieces ---------------------------------------------------
    def _grid(self, blurred: torch.Tensor, p_idx: int, plain: bool) -> torch.Tensor:
        """Pointing `p_idx`'s local grid of the sky planes [..., Na, Nb]."""
        raise NotImplementedError

    def _slit_sums(self, gridded: torch.Tensor) -> torch.Tensor:
        """SRF box-sum, slit windows read every srf-th row, slit weights, β
        sum: local planes [..., nla, nlb] → [..., S, A]."""
        n_aout, srf, sb = self.slices_shape[2], self.srf, self.slit_shape[1]
        summed = fft.idft(fft.dft(gridded) * self._otf_t, self.local_im_shape)
        windows = torch.stack(
            [summed[..., a0 : a0 + n_aout * srf : srf, b0 : b0 + sb]
             for a0, b0 in zip(self.slit_a_starts.tolist(), self.slit_b_starts.tolist())],
            dim=-3,
        )
        return (windows * self._slit_w_t).sum(-1)

    def _forward_fn(self, x: torch.Tensor, sotf=None, plain: bool = False) -> torch.Tensor:
        """The SigLSC forward of sky planes x [..., Na, Nb] → [..., P, S, A];
        `sotf` overrides the plane's OTF (a stack of them: one per plane)."""
        blurred = fft.idft(fft.dft(x) * (self._sotf_t if sotf is None else sotf), self.ishape)
        return torch.stack([self._slit_sums(self._grid(blurred, p, plain))
                            for p in range(len(self.pointings))], dim=-3)

    def forward_fn(self, x: torch.Tensor) -> torch.Tensor:
        return self._forward_fn(x)

    def forward(self, x, plain: bool = False) -> torch.Tensor:
        return self._forward_fn(self._x(x), plain=plain).reshape(-1)

    def adjoint(self, y, plain: bool = False) -> torch.Tensor:
        """Exact transpose of :meth:`forward` (derived)."""
        return self.derived_adjoint(lambda x: self._forward_fn(x, plain=plain).reshape(-1),
                                    ("forward", plain), self._y(y))

    def normal(self, x, plain: bool = False) -> torch.Tensor:
        return self.adjoint(self.forward(x, plain), plain)

    def data_to_img(self, data) -> np.ndarray:
        """Weighted co-add of the detector data back to the sky (reference
        `data_to_img`): per pointing the transpose of S → SRF sum → L → β
        sum (no C) of the data over npix_slit_beta_width·srf, then the mean
        over the pointings that cover each pixel."""
        y = torch.as_tensor(np.array(data)).reshape(self.slices_shape).to(self.device, self.dtype)
        scale = self.npix_slit_beta_width * self.srf
        cum = torch.stack([
            self.derived_adjoint(lambda x, p=p: self._slit_sums(self._grid(x, p, False)),
                                 ("data_to_img", p), y[p] / scale)
            for p in range(len(self.pointings))
        ]).double().cpu().numpy()
        counts = np.sum(cum != 0, axis=0)
        total = np.sum(cum, axis=0)
        return np.divide(total, counts, out=np.zeros_like(total), where=counts != 0)


class MRSBlurred(_Blind2DBase):
    """Rotated-FOV variant: bilinear gridding per pointing (kernel #1)."""

    def __init__(self, sotf, alpha_axis, beta_axis, instr: IFU, step_degree, pointings,
                 dtype=np.float32, device=None):
        super().__init__(sotf, alpha_axis, beta_axis, instr, step_degree, pointings, dtype, device)
        self.plans = []
        for pointing in self.pointings:
            fov = self.instr.fov + pointing
            ga, gb = fov.local2global(self.local_alpha_axis, self.local_beta_axis)
            self.plans.append(bilinear.bilinear_plan(self.alpha_axis, self.beta_axis,
                                                     bilinear.grid_points(ga, gb)))
        n_src = self.ishape[0] * self.ishape[1]
        self.row_plans = [bilinear.row_plan(p.idx, p.w, n_src, self.device, self.dtype)
                          for p in self.plans]

    def _grid(self, blurred, p_idx, plain):
        out = bilinear.gather_planes(self.row_plans[p_idx], blurred, plain)
        return out.reshape(out.shape[:-1] + self.local_im_shape)


class MRSBlurredRectangle(_Blind2DBase):
    """Unrotated variant: the local window is a nearest-index crop of the
    sky grid centred on the pointing (reference blind2d.py:268-287)."""

    def __init__(self, sotf, alpha_axis, beta_axis, instr: IFU, step_degree, pointings,
                 dtype=np.float32, device=None):
        super().__init__(sotf, alpha_axis, beta_axis, instr, step_degree, pointings, dtype, device)
        self.windows = []
        aw, bw = self.local_im_shape
        for pointing in self.pointings:
            ia = int(np.abs(self.alpha_axis - pointing.alpha).argmin())
            ib = int(np.abs(self.beta_axis - pointing.beta).argmin())
            self.windows.append((slice(ia - aw // 2, ia + aw // 2 + 1),
                                 slice(ib - bw // 2, ib + bw // 2 + 1)))

    def _grid(self, blurred, p_idx, plain):
        sa, sb = self.windows[p_idx]
        return blurred[..., sa, sb]


class DeconvCube(LinOp):
    """λ-stack no-rotation cube deconvolution (BASELINE config 2): the
    2-D model of `base` (its slit and pointing geometry, rectangle or
    rotated) on W planes [W, Na, Nb], each with its own OTF from
    `sotf_stack` [W, Na, Nb//2+1], in one batched program."""

    def __init__(self, base: _Blind2DBase, sotf_stack):
        self.base = base
        ctype = np.complex64 if base.npdtype == np.float32 else np.complex128
        self.sotf_stack = np.asarray(sotf_stack, ctype)
        w = int(self.sotf_stack.shape[0])
        self.n_lambda = w
        self.cube_oshape = (w,) + base.slices_shape
        super().__init__((w,) + tuple(base.ishape), (w * int(np.prod(base.slices_shape)),),
                         base.dtype, base.device)
        self._stack_t = torch.as_tensor(self.sotf_stack).to(self.device, complex_dtype(self.dtype))

    def _forward_fn(self, x: torch.Tensor, plain: bool = False) -> torch.Tensor:
        return self.base._forward_fn(x, self._stack_t, plain)

    def forward_fn(self, x: torch.Tensor) -> torch.Tensor:
        return self._forward_fn(x)

    def forward(self, x, plain: bool = False) -> torch.Tensor:
        return self._forward_fn(self._x(x), plain).reshape(-1)

    def adjoint(self, y, plain: bool = False) -> torch.Tensor:
        """Exact transpose of :meth:`forward` (derived)."""
        return self.derived_adjoint(lambda x: self._forward_fn(x, plain).reshape(-1),
                                    ("forward", plain), self._y(y))

    def normal(self, x, plain: bool = False) -> torch.Tensor:
        return self.adjoint(self.forward(x, plain), plain)

