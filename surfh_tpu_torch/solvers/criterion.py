"""Regularized least squares for MRS fusion (counterpart of
`surfh_tpu/solvers/criterion.py::QuadCriterion_MRS`, separated prior).

J(x) = µ_s/2·‖Hx − y‖² + µ_r/2·(‖D_r x‖² + ‖D_c x‖²) with circular first
differences over the two spatial axes of each map.  The normal operator
Q = µ_s·HᵗH + µ_r·DᵀD uses the model's fused `normal`; the µ's ride as
tensors in `op_args`, so one `normal_op` serves every µ.  Nothing is
cached per model: eager PyTorch has no compiled program to reuse.
"""

from __future__ import annotations

from typing import Union

import numpy as np
import torch

from .cg import SolverResult, lcg


def diff_rows(x):
    """Circular first difference over axis 1: (Dx)[i] = x[i-1] − x[i]."""
    return torch.roll(x, 1, dims=1) - x


def diff_cols(x):
    """Circular first difference over axis 2."""
    return torch.roll(x, 1, dims=2) - x


def dtd_separated(x):
    """(D_rᵀD_r + D_cᵀD_c) x — the circular 2-D Laplacian per map."""
    return (
        4 * x
        - torch.roll(x, 1, dims=1)
        - torch.roll(x, -1, dims=1)
        - torch.roll(x, 1, dims=2)
        - torch.roll(x, -1, dims=2)
    )


class QuadCriterion_MRS:
    """J(x) = µ_s/2‖Hx−y‖² + µ_r/2‖Dx‖², minimized by `lcg`.

    `model_spectro` exposes `forward`, `adjoint`, `normal`, `ishape`,
    `device` and `dtype` (the port's `SpectroSigRLSCT` after `.to()`)."""

    def __init__(self, mu_spectro, y_spectro, model_spectro, mu_reg):
        self.model = model_spectro
        self.shape_of_output = tuple(model_spectro.ishape)
        dev, dt = model_spectro.device, model_spectro.dtype
        self.mu_spectro = torch.as_tensor(mu_spectro, device=dev, dtype=dt)
        self.mu_reg = torch.as_tensor(mu_reg, device=dev, dtype=dt)
        self.y_spectro = torch.as_tensor(y_spectro).to(device=dev, dtype=dt).reshape(-1)
        self._b = None

    def normal_op(self, x, mu_s, mu_r):
        return mu_s * self.model.normal(x) + mu_r * dtd_separated(x)

    @property
    def b(self) -> torch.Tensor:
        """µ_s·Hᵗy, computed once."""
        if self._b is None:
            self._b = self.mu_spectro * self.model.adjoint(self.y_spectro)
        return self._b

    def run_method(
        self,
        method: str = "lcg",
        maximum_iterations: int = 10,
        tolerance: float = 1e-12,
        value_init: Union[float, np.ndarray, torch.Tensor] = 0.5,
        solver_state=None,
        return_state: bool = False,
    ) -> SolverResult:
        if method != "lcg":
            raise NotImplementedError(f"method={method!r}: only lcg is ported")
        dev, dt = self.model.device, self.model.dtype
        if isinstance(value_init, (int, float)):
            init = torch.full(self.shape_of_output, float(value_init), device=dev, dtype=dt)
        else:
            init = torch.as_tensor(value_init).to(device=dev, dtype=dt).reshape(self.shape_of_output)
        return lcg(self.normal_op, self.b, init, max_iter=maximum_iterations,
                   tol=tolerance, state=solver_state, return_state=return_state,
                   op_args=(self.mu_spectro, self.mu_reg))

    def get_crit_val(self, x_hat) -> float:
        x_hat = torch.as_tensor(x_hat).to(device=self.model.device, dtype=self.model.dtype)
        x_hat = x_hat.reshape(self.shape_of_output)
        data_term = self.mu_spectro * torch.sum((self.y_spectro - self.model.forward(x_hat)) ** 2)
        reg = self.mu_reg * torch.sum(diff_rows(x_hat) ** 2 + diff_cols(x_hat) ** 2)
        return float((data_term + reg) / 2)
