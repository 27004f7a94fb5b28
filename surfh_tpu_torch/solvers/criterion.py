"""Regularized least squares for MRS fusion (counterpart of
`surfh_tpu/solvers/criterion.py::QuadCriterion_MRS`).

J(x) = µ_s/2·‖Hx − y‖² + µ_r/2·‖Dx‖², D the circular first differences over
the two spatial axes of each map (``gradient="separated"``) or the joint
Fourier Laplacian (``"joint"``).  `QuadCriterion_MRS_2D` is the same over
one [Nx, Ny] image (the differences on axes 0 and 1).  The normal operator Q = µ_s·HᵗH + µ_r·DᵀD
uses the model's fused `normal`; the µ's ride as tensors in `op_args`, so
one `normal_op` serves every µ.  Nothing is cached per model: eager
PyTorch has no compiled program to reuse.
"""

from __future__ import annotations

import time
from typing import Union

import numpy as np
import torch

from ..core import fft
from ..core.linop import complex_dtype
from ..core.precision import pick_device
from .cg import SolverResult, lcg, mmmg


def diff_rows(x):
    """Circular first difference over axis 1: (Dx)[i] = x[i-1] − x[i]."""
    return torch.roll(x, 1, dims=1) - x


def diff_rows_t(y):
    """Transpose of :func:`diff_rows`."""
    return torch.roll(y, -1, dims=1) - y


def diff_cols(x):
    """Circular first difference over axis 2."""
    return torch.roll(x, 1, dims=2) - x


def diff_cols_t(y):
    """Transpose of :func:`diff_cols`."""
    return torch.roll(y, -1, dims=2) - y


def dtd_separated(x):
    """(D_rᵀD_r + D_cᵀD_c) x — the circular 2-D Laplacian per map."""
    return (
        4 * x
        - torch.roll(x, 1, dims=1)
        - torch.roll(x, -1, dims=1)
        - torch.roll(x, 1, dims=2)
        - torch.roll(x, -1, dims=2)
    )


class DifferenceOperatorJoint:
    """Joint Laplacian prior in Fourier (reference
    `criterion.py::DifferenceOperatorJoint`): D x = idft(dft(x)·d̂) per map,
    d̂ the non-unitary transfer function of the 2-D Laplacian.  `dtype`
    (NumPy or torch) is the maps' type; `device` None means the card."""

    def __init__(self, shape_target, dtype=torch.float32, device=None):
        self.shape_target = tuple(shape_target)
        d_freq = fft.ir2fr(fft.laplacian(2), self.shape_target)[np.newaxis]
        self.d_freq = torch.as_tensor(d_freq).to(device=pick_device(device), dtype=complex_dtype(dtype))

    def D(self, x):
        return fft.idft(fft.dft(x) * self.d_freq, self.shape_target)

    def D_t(self, x):
        return fft.idft(fft.dft(x) * self.d_freq.conj(), self.shape_target)

    def DtD(self, x):
        return fft.idft(fft.dft(x) * self.d_freq.abs() ** 2, self.shape_target)


class QuadCriterion_MRS:
    """J(x) = µ_s/2‖Hx−y‖² + µ_r/2‖Dx‖², minimized by `lcg` or `mmmg`.

    `model_spectro` exposes `forward`, `adjoint`, `normal`, `ishape`,
    `device` and `dtype` (the port's `SpectroSigRLSCT` after `.to()`, or
    any `core.linop.LinOp`).
    `printing` prints the solve's time; `gradient` is "separated" or
    "joint".  `use_fwadj=True` applies HᵗH through the model's own `fwadj`
    (e.g. `Model_WCT`'s block-Fourier Hessian) instead of `normal`, the
    reference's ``hessp=model.fwadj``; a model without one raises."""

    def __init__(self, mu_spectro, y_spectro, model_spectro, mu_reg, printing: bool = False,
                 gradient: str = "separated", use_fwadj: bool = False):
        if gradient not in ("separated", "joint"):
            raise ValueError(f"unknown gradient mode {gradient!r}")
        if use_fwadj and not hasattr(model_spectro, "fwadj"):
            raise ValueError("use_fwadj=True requires the model to define fwadj")
        self.model = model_spectro
        self._hess = model_spectro.fwadj if use_fwadj else model_spectro.normal
        self.printing = printing
        self.gradient = gradient
        self.shape_of_output = tuple(model_spectro.ishape)
        dev, dt = model_spectro.device, model_spectro.dtype
        self.dtype = dt
        self.mu_spectro = torch.as_tensor(mu_spectro, device=dev, dtype=dt)
        self.mu_reg = torch.as_tensor(mu_reg, device=dev, dtype=dt)
        self.y_spectro = torch.as_tensor(y_spectro).to(device=dev, dtype=dt).reshape(-1)
        self._joint = (DifferenceOperatorJoint(self.shape_of_output[1:], dt, dev)
                       if gradient == "joint" else None)
        self._b = None
        self.L_crit_val: list = []

    def _dtd(self, x):
        return dtd_separated(x) if self._joint is None else self._joint.DtD(x)

    def normal_op(self, x, mu_s, mu_r):
        return mu_s * self._hess(x) + mu_r * self._dtd(x)

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
        calc_crit: bool = False,
        perf_crit=None,
        value_init: Union[float, np.ndarray, torch.Tensor] = 0.5,
        solver_state=None,
        return_state: bool = False,
        solver_loop: str = "graph",
        solver_chain: int = 1,
    ) -> SolverResult:
        """Solve with `method` ("lcg" or "mmmg") from `value_init` (or, for
        `lcg`, resume `solver_state`); `calc_crit` appends J(x̂) to
        `L_crit_val` and sets the result's `crit_val` to all values so far.
        `solver_loop` is the solver's `loop`, `solver_chain` `lcg`'s
        `chain_steps`; `mmmg` reads neither the state arguments nor
        `solver_chain`, and `perf_crit` is accepted and not read, as in the
        reference."""
        if method not in ("lcg", "mmmg"):
            raise ValueError(f"unknown method {method!r}")
        dev, dt = self.model.device, self.model.dtype
        if isinstance(value_init, (int, float)):
            init = torch.full(self.shape_of_output, float(value_init), device=dev, dtype=dt)
        else:
            init = torch.as_tensor(value_init).to(device=dev, dtype=dt).reshape(self.shape_of_output)
        t0 = time.perf_counter()
        op_args = (self.mu_spectro, self.mu_reg)
        if method == "lcg":
            res = lcg(self.normal_op, self.b, init, max_iter=maximum_iterations, tol=tolerance,
                      state=solver_state, return_state=return_state,
                      op_args=op_args, loop=solver_loop, chain_steps=solver_chain)
        else:
            res = mmmg(self.normal_op, self.b, init, max_iter=maximum_iterations, tol=tolerance,
                       op_args=op_args, loop=solver_loop)
        if self.printing:
            print(f"Total time needed for {method}: {time.perf_counter() - t0:.3f}s")
        if calc_crit:
            self.L_crit_val.append(self.get_crit_val(res.x))
            res.crit_val = np.asarray(self.L_crit_val)
        return res

    def get_crit_val(self, x_hat) -> float:
        x_hat = torch.as_tensor(x_hat).to(device=self.model.device, dtype=self.model.dtype)
        x_hat = x_hat.reshape(self.shape_of_output)
        data_term = self.mu_spectro * torch.sum((self.y_spectro - self.model.forward(x_hat)) ** 2)
        if self._joint is None:
            reg = self.mu_reg * torch.sum(diff_rows(x_hat) ** 2 + diff_cols(x_hat) ** 2)
        else:
            reg = self.mu_reg * torch.sum(self._joint.D(x_hat) ** 2)
        return float((data_term + reg) / 2)


class QuadCriterion_MRS_2D(QuadCriterion_MRS):
    """The 2-D single-λ deconvolution criterion (reference
    `criterion.py::QuadCriterion_MRS_2D`): the separated prior over one
    image [Nx, Ny], circular differences on axes 0 and 1."""

    def __init__(self, mu_spectro, y_spectro, model_spectro, mu_reg, printing: bool = False,
                 gradient: str = "separated"):
        if gradient != "separated":
            raise NotImplementedError("2-D criterion supports the separated prior")
        super().__init__(mu_spectro, y_spectro, model_spectro, mu_reg, printing, "separated")

    def _dtd(self, x):
        return (4 * x - torch.roll(x, 1, dims=0) - torch.roll(x, -1, dims=0)
                - torch.roll(x, 1, dims=1) - torch.roll(x, -1, dims=1))

    def get_crit_val(self, x_hat) -> float:
        x_hat = torch.as_tensor(x_hat).to(device=self.model.device, dtype=self.model.dtype)
        x_hat = x_hat.reshape(self.shape_of_output)
        data_term = self.mu_spectro * torch.sum((self.y_spectro - self.model.forward(x_hat)) ** 2)
        dr = torch.roll(x_hat, 1, dims=0) - x_hat
        dc = torch.roll(x_hat, 1, dims=1) - x_hat
        reg = self.mu_reg * torch.sum(dr**2 + dc**2)
        return float((data_term + reg) / 2)
