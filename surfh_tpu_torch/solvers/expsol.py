"""Closed-form Fourier solver for block-Fourier mixing models.

Counterpart of `surfh_tpu/solvers/expsol.py`.  Solves
min_x ‖y − Hx‖² + Σ_k µ_k‖D x_k‖² exactly: x̂ = (HᵗH + µ DᵗD)⁻¹ Hᵗ y, the
regularized block Hessian inverted per frequency block (one batched
`torch.linalg.inv`, complex128, on the model's device).  The inverse is
applied in float64 whatever the model's type, and x̂ returned in it.
"""

from __future__ import annotations

import time
from typing import Union

import numpy as np
import torch

from ..core import blockfourier as bf
from ..core.fft import ir2fr, laplacian


class Regul_Fusion_Model:
    """Block Hessian of the data term plus the smoothness prior on its
    diagonal (reference Regul_Fusion_Model3); `gradient` is "separated"
    (row and column differences) or "joint" (the Laplacian)."""

    def __init__(self, model, L_mu_reg, gradient: str = "separated"):
        hess = model.hess_spec_freq
        shape_target = model.shape_target
        di, dj = model.di, model.dj
        L_mu_reg = np.asarray(L_mu_reg, np.float64)

        def part(freq):
            return bf.partition(torch.as_tensor(freq[np.newaxis]), di, dj)[0].numpy()

        if gradient == "joint":
            diag = np.abs(part(ir2fr(laplacian(2), shape=shape_target, real=False))) ** 2
        elif gradient == "separated":
            f_row = ir2fr(np.array([-1.0, 1.0])[..., np.newaxis], shape=shape_target, real=False)
            f_col = ir2fr(np.array([-1.0, 1.0])[np.newaxis, ...], shape=shape_target, real=False)
            diag = np.abs(part(f_row)) ** 2 + np.abs(part(f_col)) ** 2
        else:
            raise ValueError(f"unknown gradient mode {gradient!r}")

        regul = hess.clone()
        diag = torch.as_tensor(diag).to(hess.device, hess.dtype)  # [D, h, w]
        for k in range(regul.shape[0]):
            for i in range(regul.shape[2]):
                regul[k, k, i, i] += L_mu_reg[k] * diag[i]
        self.regul_hess_fusion = regul
        self.di, self.dj = di, dj
        self.shape_target = shape_target
        self.model = model


class Inv_Regul_Fusion_Model:
    """Per-frequency block inverse of the regularized Hessian and the
    reconstruction x̂ = Q⁻¹ Hᵗ y (reference Inv_Regul_Fusion_Model3)."""

    def __init__(self, regul_fusion_model: Regul_Fusion_Model):
        self.inv_hess_fusion = bf.make_iHtH(regul_fusion_model.regul_hess_fusion)
        self.model = regul_fusion_model.model
        self.di = regul_fusion_model.di
        self.dj = regul_fusion_model.dj
        self.shape_target = regul_fusion_model.shape_target

    def map_reconstruction(self, data) -> torch.Tensor:
        """x̂ [S, H, W] in the model's type, on its device."""
        b = self.model.adjoint(data).to(torch.float64)
        xf = bf.apply_hessian_freq(self.inv_hess_fusion, self.di, self.dj, self.shape_target,
                                   bf.dft2(b))
        return bf.idft2(xf).real.to(self.model.dtype)


class QuadCriterion3:
    """Entry point of the closed-form solve (reference fusion_mixing.QuadCriterion3):
    `mu_reg` one value or one per template."""

    def __init__(self, data, model, mu_reg: Union[float, int, list, np.ndarray],
                 printing: bool = False, gradient: str = "separated"):
        self.data = data
        self.model = model
        self.n_spec = model.n_spec
        self.mu_reg = mu_reg
        self.printing = printing
        self.gradient = gradient
        if isinstance(mu_reg, (list, np.ndarray)):
            if len(mu_reg) != self.n_spec:
                raise ValueError(f"{len(mu_reg)} regularization weights for {self.n_spec} templates")
            self.L_mu = np.asarray(mu_reg, np.float64)
        else:
            self.L_mu = np.ones(self.n_spec) * float(mu_reg)

    def run_expsol(self) -> torch.Tensor:
        """x̂ (a tensor on the model's device)."""
        t0 = time.perf_counter()
        inv = Inv_Regul_Fusion_Model(Regul_Fusion_Model(self.model, self.L_mu, gradient=self.gradient))
        t1 = time.perf_counter()
        res = inv.map_reconstruction(self.data)
        if self.printing:
            print(f"expsol: preprocess {t1 - t0:.3f}s + solve {time.perf_counter() - t1:.3f}s")
        return res
