"""Linear conjugate gradient (counterpart of `surfh_tpu/solvers/cg.py::lcg`).

The reference compiles the loop (a `lax.while_loop`, or one dispatched
program per iteration at flagship scale); PyTorch runs eagerly, so here
the loop is plain Python over device tensors.  Same parameters, update
formulas, stopping rules and `(x, r, z, p, rz)` state as the reference, so
a caller written for it gets its iterates, and a run resumes exactly where
it stopped.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

CHECK_EVERY = 25  # dispatch mode: iterations between two reads of ‖r‖ (the reference's check_every)


@dataclass
class SolverResult:
    """The reference's result fields."""

    x: torch.Tensor
    grad_norm: np.ndarray  # ‖r‖ before the first and after each iteration
    n_iter: int
    converged: bool
    crit_val: Optional[np.ndarray] = None  # criterion values (QuadCriterion_MRS, calc_crit)
    state: Optional[tuple] = None  # (x, r, z, p, rz) for an exact resume


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.dot(a.reshape(-1), b.reshape(-1))


def _norm(a: torch.Tensor) -> torch.Tensor:
    return torch.linalg.vector_norm(a.reshape(-1))


def lcg(
    normal_op: Callable,
    b: torch.Tensor,
    x0: torch.Tensor,
    max_iter: int = 100,
    tol: float = 1e-12,
    precond: Optional[Callable] = None,
    callback: Optional[Callable] = None,
    state=None,
    return_state: bool = False,
    op_args: tuple = (),
    loop: str = "graph",
    chain_steps: int = 1,
) -> SolverResult:
    """CG for Q x = b with Q = `normal_op(x, *op_args)` (SPD), z = `precond(r)`
    (identity when None); `callback(result)` is called once, at the end.
    Pass a previous result's `state` (``return_state=True``) to resume with
    the conjugate directions intact.

    ``loop="graph"`` (the reference's `lax.while_loop`): stops at the first
    iteration where ‖Qx − b‖ ≤ tol·‖b‖, and `converged` is
    ``n_iter < max_iter``, as the reference reports it.  Eager PyTorch
    reads ‖r‖ on the host once per iteration for that test; capturing the
    step in a CUDA graph is ROADMAP A7 and is not done here.

    ``loop="dispatch"`` (the reference's `_lcg_dispatch`): reads ‖r‖ once
    every `CHECK_EVERY` iterations, and when the iterations run out, so it
    may run past the crossing by as many iterations as the reference does;
    the norm history stays on the device in float32 (the reference's
    stopping test compares float32 norms) and is read once at the end;
    `converged` comes from the final norm.  `chain_steps` groups the
    iterations as the reference's chained programs do: the checks fall on
    the groups' ends; no iterate changes."""
    if loop not in ("graph", "dispatch"):
        raise ValueError(f"unknown loop {loop!r}")
    prec = precond if precond is not None else (lambda r: r)
    if state is None:
        x = x0
        r = b - normal_op(x, *op_args)
        z = prec(r)
        p = z
        rz = _dot(r, z)
    else:
        x, r, z, p, rz = state

    def step(x, r, z, p, rz):
        qp = normal_op(p, *op_args)
        alpha = rz / _dot(p, qp)
        x = x + alpha * p
        r = r - alpha * qp
        z = prec(r)
        rz_new = _dot(r, z)
        p = z + (rz_new / rz) * p
        return x, r, z, p, rz_new

    if loop == "graph":
        limit = float(tol * _norm(b))  # in the working dtype, as the reference compares
        norms = [float(_norm(r))]
        it = 0
        while it < max_iter and norms[-1] > limit:
            x, r, z, p, rz = step(x, r, z, p, rz)
            norms.append(float(_norm(r)))
            it += 1
        converged = it < max_iter
        grad_norm = np.asarray(norms, np.float64)
    else:
        limit = tol * float(_norm(b).float())
        hist = [_norm(r).float()]
        k_chain = max(1, min(int(chain_steps), max_iter))
        it, next_check = 0, CHECK_EVERY
        while it < max_iter:
            for _ in range(min(k_chain, max_iter - it)):
                x, r, z, p, rz = step(x, r, z, p, rz)
                hist.append(_norm(r).float())
                it += 1
            if it >= next_check or it >= max_iter:
                next_check = it + CHECK_EVERY
                if float(hist[-1]) <= limit:
                    break
        grad_norm = torch.stack(hist).cpu().numpy().astype(np.float64)
        converged = bool(grad_norm[-1] <= limit)
    res = SolverResult(x=x, grad_norm=grad_norm, n_iter=it, converged=converged,
                       state=(x, r, z, p, rz) if return_state else None)
    if callback is not None:
        callback(res)
    return res
