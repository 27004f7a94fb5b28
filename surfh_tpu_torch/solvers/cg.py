"""Linear conjugate gradient (counterpart of `surfh_tpu/solvers/cg.py::lcg`).

The reference compiles the loop (a `lax.while_loop`, or one dispatched
program per iteration at flagship scale); PyTorch runs eagerly, so here
the loop is plain Python over device tensors, one residual-norm read per
iteration for the stopping test.  Same update formulas and the same
`(x, r, z, p, rz)` state, so a run resumes exactly where it stopped.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch


@dataclass
class SolverResult:
    """The fields of the reference's result the slice consumes."""

    x: torch.Tensor
    grad_norm: np.ndarray  # ‖r‖ before the first and after each iteration
    n_iter: int
    converged: bool
    state: Optional[tuple] = None  # (x, r, z, p, rz) for an exact resume


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.dot(a.reshape(-1), b.reshape(-1))


def lcg(
    normal_op: Callable,
    b: torch.Tensor,
    x0: torch.Tensor,
    max_iter: int = 100,
    tol: float = 1e-12,
    state=None,
    return_state: bool = False,
    op_args: tuple = (),
) -> SolverResult:
    """CG for Q x = b with Q = `normal_op(x, *op_args)` (SPD); stops when
    ‖Qx − b‖ ≤ tol·‖b‖ or after `max_iter` iterations.  Pass a previous
    result's `state` to resume with the conjugate directions intact."""
    if state is None:
        x = x0
        r = b - normal_op(x, *op_args)
        z = r
        p = z
        rz = _dot(r, z)
    else:
        x, r, z, p, rz = state
    bnorm = float(torch.linalg.vector_norm(b))
    norms = [float(torch.linalg.vector_norm(r))]
    it = 0
    while it < max_iter and norms[-1] > tol * bnorm:
        qp = normal_op(p, *op_args)
        alpha = rz / _dot(p, qp)
        x = x + alpha * p
        r = r - alpha * qp
        z = r  # no preconditioner: z = M⁻¹r with M = I
        rz_new = _dot(r, z)
        beta = rz_new / rz
        p = z + beta * p
        rz = rz_new
        norms.append(float(torch.linalg.vector_norm(r)))
        it += 1
    return SolverResult(
        x=x,
        grad_norm=np.asarray(norms, np.float64),
        n_iter=it,
        converged=bool(norms[-1] <= tol * bnorm),
        state=(x, r, z, p, rz) if return_state else None,
    )
