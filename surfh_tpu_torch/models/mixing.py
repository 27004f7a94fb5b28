"""Mixing-model operators: λ-dependent PSF convolution + LMM + decimation
(`Model_WCT`) and the masked LMM (`MixingST`).

Counterpart of `surfh_tpu/models/mixing.py`.  `Model_WCT` keeps the
block-Fourier Hessian of its forward, so HᵗH (`fwadj`) and the regularized
inverse (`solvers.expsol`) are per-frequency block products.  Its tables
are built on the operator's device in float64 / complex128 (the FFTs of
the PSF stamps, the box-sum and phase-shift spectra from the host), then
held in the operator's type:

* the forward's transfer functions as ONE table G [L, H, W//2+1] with
  ``H_spec_freq[s, l] = L_specs[s, l] · G[l]`` (the reference holds the
  product [S, L, H, W//2+1], S× larger: 3.2 GB in complex128 at 501² and
  ~400 planes); the forward mixes the map spectra by `L_specs` first, then
  multiplies by G — the same linear map, summed in another order.
  :attr:`Model_WCT.H_spec_freq` builds the reference's table on demand;
* the block Hessian [S, S, D, D, H/di, W/dj] (D = di·dj), accumulated over
  λ in chunks, so no [L, H, W] full spectrum is held whole.

`MixingST`'s Gram matrix TST and mask are dense tensors (the reference's
Cython sparse-selection kernels became dense masked einsums there too).
Both adjoints are derived (`LinOp.derived_adjoint`).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..core import blockfourier as bf
from ..core.fft import ir2fr
from ..core.linop import LinOp, complex_dtype

HESS_CHUNK = 64  # λ planes per full-spectrum chunk of the Hessian build


def _ir2fr_planes(psf: torch.Tensor, shape: Tuple[int, int], real: bool) -> torch.Tensor:
    """`core.fft.ir2fr` of a stamp stack [n, sx, sy] (float64 tensor) on its
    device: pad to `shape`, roll the stamp's middle to (0, 0), non-normalized
    rfft2 (or fft2 with ``real=False``)."""
    n, sx, sy = psf.shape
    padded = psf.new_zeros((n,) + tuple(shape))
    padded[:, :sx, :sy] = psf
    padded = torch.roll(padded, shifts=(-(sx // 2), -(sy // 2)), dims=(1, 2))
    return torch.fft.rfftn(padded, dim=(1, 2)) if real else torch.fft.fftn(padded, dim=(1, 2))


class Model_WCT(LinOp):
    """maps [S, H, W] → decimated weighted-convolution cube [L, H/di, W/dj].

    forward: cube[λ] = decimate( psf[λ]·pce[λ] ⊛ Σ_s spec[s,λ]·maps[s] ),
    with the box sum over the (di, dj) decimated pixel and its phase shift
    (the reference's `decal`).  `fwadj` is HᵗH through the block Hessian."""

    def __init__(self, psfs_monoch: np.ndarray, L_specs: np.ndarray, shape_target: Tuple[int, int],
                 L_pce: Optional[np.ndarray] = None, di: int = 1, dj: int = 1,
                 dtype=torch.float32, device=None):
        psfs_monoch = np.asarray(psfs_monoch, np.float64)
        L_specs = np.asarray(L_specs, np.float64)
        n_spec, n_lamb = L_specs.shape
        if psfs_monoch.shape[0] != n_lamb:
            raise ValueError(f"{psfs_monoch.shape[0]} PSF planes for {n_lamb} wavelengths")
        if psfs_monoch.shape[1] > shape_target[0] or psfs_monoch.shape[2] > shape_target[1]:
            raise ValueError(f"PSF {psfs_monoch.shape[1:]} larger than the image {shape_target}")
        L_pce = np.ones(n_lamb) if L_pce is None else np.asarray(L_pce, np.float64)
        H, W = shape_target
        self.di, self.dj = int(di), int(dj)
        self.shape_target = (int(H), int(W))
        self.n_lamb, self.n_spec = n_lamb, n_spec
        super().__init__((n_spec, H, W), (n_lamb, H // di, W // dj), dtype, device)
        dev, f64, c128 = self.device, torch.float64, torch.complex128

        # box sum over the decimated pixel and the shift anchoring it on the
        # decimation grid (reference mixing.py:154-161), host complex128
        ksum_r = ir2fr(np.ones((di, dj)), shape_target)
        ksum_f = ir2fr(np.ones((di, dj)), shape_target, real=False)
        decal = np.zeros(shape_target)
        dsi, dsj = int((di - 1) / 2), int((dj - 1) / 2)
        decal[-dsi if dsi else 0, -dsj if dsj else 0] = np.sqrt(H * W)
        shift_r = torch.as_tensor(ksum_r * np.fft.rfftn(decal, axes=(-2, -1), norm="ortho")).to(dev, c128)
        shift_f = torch.as_tensor(ksum_f * np.fft.fftn(decal, axes=(-2, -1), norm="ortho")).to(dev, c128)

        psf = torch.as_tensor(psfs_monoch * L_pce[:, None, None]).to(dev, f64)
        self._specs64 = torch.as_tensor(L_specs).to(dev, f64)
        g = _ir2fr_planes(psf, shape_target, real=True)
        g.mul_(shift_r)
        self._g64 = g  # [L, H, W//2+1]: H_spec_freq[s, l] = L_specs[s, l]·G[l]

        # block Hessian [S, S, D, D, h, w] (reference mixing.py:166-212),
        # accumulated over λ chunks of the full spectrum
        D = di * dj
        hess = torch.zeros((n_spec, n_spec, D, D, H // di, W // dj), dtype=c128, device=dev)
        for i in range(0, n_lamb, HESS_CHUNK):
            part = bf.partition(_ir2fr_planes(psf[i : i + HESS_CHUNK], shape_target, real=False)
                                * shift_f, di, dj)  # [l, D, h, w]
            mat = torch.einsum("lbhw,lahw->labhw", part, part.conj()) / (di * dj)
            s = self._specs64[:, i : i + HESS_CHUNK].to(c128)
            hess += torch.einsum("al,bl,lxyhw->abxyhw", s, s, mat)
        self.hess_spec_freq = hess

        ctype = complex_dtype(self.dtype)
        self._g = g.to(ctype)
        self._specs = self._specs64.to(ctype)
        self._hess = hess.to(ctype)

    @property
    def H_spec_freq(self) -> torch.Tensor:
        """The reference's transfer-function table [S, L, H, W//2+1]
        (complex128, on the operator's device), built on demand."""
        return self._specs64.to(torch.complex128)[:, :, None, None] * self._g64[None]

    def forward(self, x) -> torch.Tensor:
        xf = torch.fft.rfftn(self._x(x), dim=(-2, -1), norm="ortho")  # [S, H, W//2+1]
        s, h, w = xf.shape
        yf = (self._specs.T @ xf.reshape(s, -1)).reshape(-1, h, w) * self._g
        cube = torch.fft.irfftn(yf, s=self.shape_target, dim=(-2, -1), norm="ortho")
        return cube[:, :: self.di, :: self.dj]

    def fwadj(self, x) -> torch.Tensor:
        """HᵗH x through the block Hessian."""
        return bf.apply_hessian(self._hess, self.di, self.dj, self.shape_target, self._x(x))


class MixingST(LinOp):
    """Masked LMM: cube = S ⊙ (T maps) with a static voxel selection
    (`selection_arr` marks the voxels set to 0); `fwadj` is the per-pixel
    Gram matrix TST[m, n, i, j] = Σ_λ S·t_m·t_n applied to the maps."""

    def __init__(self, templates: np.ndarray, alpha_axis: np.ndarray, beta_axis: np.ndarray,
                 wavel_axis: np.ndarray, selection_arr: Optional[np.ndarray] = None,
                 dtype=torch.float32, device=None):
        self.templates = np.asarray(templates, np.float64)
        ishape = (self.templates.shape[0], len(alpha_axis), len(beta_axis))
        oshape = (len(wavel_axis), len(alpha_axis), len(beta_axis))
        super().__init__(ishape, oshape, dtype, device)
        S = np.ones(oshape)
        if selection_arr is not None:
            S[np.asarray(selection_arr)] = 0.0
        self._S = torch.as_tensor(S).to(self.device, self.dtype)
        self._tpl = torch.as_tensor(self.templates).to(self.device, self.dtype)
        self.TST = torch.einsum("lij,ml,nl->mnij", self._S, self._tpl, self._tpl)

    def forward(self, x) -> torch.Tensor:
        return self._S * torch.einsum("ml,mij->lij", self._tpl, self._x(x))

    def fwadj(self, x) -> torch.Tensor:
        return torch.einsum("mnij,nij->mij", self.TST, self._x(x))

    def mapsToCube(self, maps) -> np.ndarray:
        return np.sum(np.expand_dims(np.asarray(maps), 1)
                      * self.templates[..., np.newaxis, np.newaxis], axis=0)
