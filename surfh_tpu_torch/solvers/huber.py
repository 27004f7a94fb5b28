"""Huber-prior MM memory-gradient solvers (the reference's semi-quadratic
legacy reconstructions).

Counterpart of `surfh_tpu/solvers/huber.py`: `mmmg_huber` minimizes a
quadratic data term plus Huber finite-difference priors; each step builds
the Geman–Reynolds half-quadratic majorant at the current point and
minimizes it exactly over span{−∇J, x − x_prev} (a 2×2 solve).  H·x and
H·x_prev are carried across iterations, so an iteration costs one forward
and one adjoint.  The loop is eager Python over device tensors; every
scalar stays on the device and the gradient-norm history is read once, at
the end.

Under `torch.profiler` `mmmg_huber` records host-lane spans
(`utils.profiling.span`), as the CG solvers do: ``surfh.solver.solve``
around the call, ``surfh.solver.iter`` around each step (the first
included), ``surfh.solver.prior`` around each pass over the priors (two a
step: the gradient's and the majorant's Gram entries) and
``surfh.solver.host_read`` around the history's read.
"""

from __future__ import annotations

from typing import Callable, Sequence, Tuple

import numpy as np
import torch

from ..utils.profiling import span
from .cg import SPAN_ITER, SolverResult, _read_history, _solve_span

SPAN_PRIOR = "surfh.solver.prior"


def huber_value(u, delta):
    a = u.abs()
    return torch.where(a <= delta, 0.5 * u * u, delta * a - 0.5 * delta * delta)


def huber_grad(u, delta):
    return u.clamp(-delta, delta)


def huber_weight(u, delta):
    """Geman–Reynolds weights φ'(u)/u ∈ (0, 1]."""
    a = u.abs()
    return torch.where(a <= delta, torch.ones_like(a), delta / a.clamp_min(1e-30))


def diff_axis(x: torch.Tensor, axis: int) -> torch.Tensor:
    """Non-circular forward difference along `axis` (the reference's `aljabr.Diff`)."""
    n = x.shape[axis]
    return x.narrow(axis, 1, n - 1) - x.narrow(axis, 0, n - 1)


def diff_axis_t(y: torch.Tensor, axis: int, n: int) -> torch.Tensor:
    """Exact adjoint of :func:`diff_axis` (`n` the differenced axis' length)."""
    zero_shape = list(y.shape)
    zero_shape[axis] = 1
    zero = y.new_zeros(zero_shape)
    return torch.cat([zero, y], axis) - torch.cat([y, zero], axis)


def _vdot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.dot(a.reshape(-1), b.reshape(-1))


@_solve_span
def mmmg_huber(data_fwd: Callable, data_adj: Callable, y,
               priors: Sequence[Tuple[Callable, Callable, float, float]], x0, max_iter: int = 500,
               loop: str = "graph") -> SolverResult:
    """MM memory-gradient for J(x) = ½‖Hx−y‖² + Σ_k µ_k Σ Huber_δk(D_k x).

    priors: a sequence of (D_fwd, D_adj, delta, mu).  The majorant at x uses
    Huber weights w = φ'(u)/u; the directions are d0 = −∇J and d1 = x −
    x_prev, the step from the 2×2 majorant system; the first step is
    steepest descent.  `max_iter` counts the first step: `grad_norm` holds
    ‖∇J‖ at each of the other max_iter − 1.  `loop` is the reference's
    argument and both run this loop; "dispatch" keeps the history in float32
    (the reference's telemetry), "graph" in the iterate's type.

    The steepest direction is −∇J over the previous step's ‖∇J‖ (the
    first step's over max|∇J|) and the 2×2 system is solved in float64, the
    step coefficients taking the scale: the same step, with no pass more
    than the plain one, but no float32 inner product overflows where ∇J is
    large (from Hᵗy on a small MIRI operator ‖∇J‖² passes 1e38)."""
    if loop not in ("graph", "dispatch"):
        raise ValueError(f"unknown loop {loop!r}")
    x0 = torch.as_tensor(x0)
    y = torch.as_tensor(y).to(device=x0.device, dtype=x0.dtype)

    def grad_from(hx, x):
        g = data_adj(hx - y)
        with span(SPAN_PRIOR):
            for D, Dt, delta, mu in priors:
                g = g + mu * Dt(huber_grad(D(x), delta))
        return g

    def quad_entries(x, d0, h0, d1, h1):
        """Majorant Gram entries over {d0, d1}; data parts from the carried H-images."""
        a00, a01, a11 = _vdot(h0, h0), _vdot(h0, h1), _vdot(h1, h1)
        with span(SPAN_PRIOR):
            for D, Dt, delta, mu in priors:
                w = huber_weight(D(x), delta)
                dd0, dd1 = D(d0), D(d1)
                a00 = a00 + mu * _vdot(w * dd0, dd0)
                a01 = a01 + mu * _vdot(w * dd0, dd1)
                a11 = a11 + mu * _vdot(w * dd1, dd1)
        return a00, a01, a11

    # first step: steepest descent on the majorant; H·x1 = H·x0 + α·h0
    with span(SPAN_ITER):
        hx_prev = data_fwd(x0)
        g0 = grad_from(hx_prev, x0)
        gn = torch.linalg.vector_norm(g0.reshape(-1), ord=float("inf"))  # the first divisor
        d0 = g0 * (-1 / gn.clamp_min(1e-30))
        h0 = data_fwd(d0)
        a00, _, _ = quad_entries(x0, d0, h0, d0, h0)
        alpha = (-_vdot(g0, d0).double() / a00.double().clamp_min(1e-30)).to(x0.dtype)
        x, x_prev = x0 + alpha * d0, x0
        hx = hx_prev + alpha * h0
        gn = gn * torch.linalg.vector_norm(d0.reshape(-1))  # ‖∇J(x0)‖

    norms = []
    for _ in range(1, max_iter):
        with span(SPAN_ITER):
            g = grad_from(hx, x)
            d0 = g * (-1 / gn.clamp_min(1e-30))  # −∇J over the last step's ‖∇J‖
            h0 = data_fwd(d0)
            d1 = x - x_prev
            h1 = hx - hx_prev
            a00, a01, a11 = (a.double() for a in quad_entries(x, d0, h0, d1, h1))
            b0, b1 = -_vdot(g, d0).double(), -_vdot(g, d1).double()
            det = a00 * a11 - a01 * a01
            safe = det.abs() > 1e-30
            den = torch.where(safe, det, torch.ones_like(det))
            s = torch.where(safe, (b0 * a11 - b1 * a01) / den, b0 / a00.clamp_min(1e-30)).to(x.dtype)
            t = torch.where(safe, (b1 * a00 - b0 * a01) / den, torch.zeros_like(det)).to(x.dtype)
            x, x_prev = x + s * d0 + t * d1, x
            hx, hx_prev = hx + s * h0 + t * h1, hx
            gn = gn.clamp_min(1e-30) * torch.linalg.vector_norm(d0.reshape(-1))  # ‖∇J(x)‖
            norms.append(gn.float() if loop == "dispatch" else gn)
    hist = _read_history(norms) if norms else np.zeros(0)
    return SolverResult(x=x, grad_norm=hist, n_iter=max_iter, converged=True)


def _spatial_priors(ishape, reg: float, th: float) -> list:
    return [(lambda x: diff_axis(x, 1), lambda u: diff_axis_t(u, 1, ishape[1]), th, reg),
            (lambda x: diff_axis(x, 2), lambda u: diff_axis_t(u, 2, ishape[2]), th, reg)]


def vox_reconstruction(data, data_model, spat_reg: float = 1.0, spat_th: float = 1.0,
                       spec_reg: float = 1.0, spec_th: float = 1.0, init=None, max_iter: int = 500,
                       loop: str = "graph") -> SolverResult:
    """Voxel-cube reconstruction with Huber spatial row / column and
    spectral priors (reference algorithms.vox_reconstruction): `data_model`
    maps a cube [λ, Nα, Nβ] to data."""
    ishape = data_model.ishape
    priors = _spatial_priors(ishape, spat_reg, spat_th) + [
        (lambda x: diff_axis(x, 0), lambda u: diff_axis_t(u, 0, ishape[0]), spec_th, spec_reg)]
    if init is None:
        init = data_adj_init(data_model, data)
    return mmmg_huber(data_model.forward, data_model.adjoint, data, priors, init,
                      max_iter=max_iter, loop=loop)


def lmm_reconstruction(data, data_model, spat_reg: float = 1.0, spat_th: float = 1.0, init=None,
                       max_iter: int = 500, loop: str = "graph") -> SolverResult:
    """Abundance-maps reconstruction with Huber spatial priors (reference
    algorithms.lmm_reconstruction)."""
    if init is None:
        init = data_adj_init(data_model, data)
    return mmmg_huber(data_model.forward, data_model.adjoint, data,
                      _spatial_priors(data_model.ishape, spat_reg, spat_th), init,
                      max_iter=max_iter, loop=loop)


def data_adj_init(data_model, data) -> torch.Tensor:
    """Hᵗy warm start (the reference's `data_adeq.ht_data` default)."""
    return data_model.adjoint(data)
