"""Linear conjugate gradient and MM memory gradient (counterparts of
`surfh_tpu/solvers/cg.py::lcg` and `::mmmg`).

The reference compiles the loop (a `lax.while_loop`, or one dispatched
program per iteration at flagship scale); PyTorch runs eagerly, so here
the loop is plain Python over device tensors.  Same parameters, update
formulas, stopping rules and (for `lcg`) `(x, r, z, p, rz)` state as the
reference, so a caller written for it gets its iterates, and an `lcg` run
resumes exactly where it stopped.

Under `torch.profiler` each solve records host-lane spans
(`utils.profiling.span`): ``surfh.solver.solve`` around the whole call,
``surfh.solver.iter`` around each step with its norm, and
``surfh.solver.host_read`` around each read of a device value on the host.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from ..utils.profiling import span

SPAN_SOLVE, SPAN_ITER, SPAN_READ = "surfh.solver.solve", "surfh.solver.iter", "surfh.solver.host_read"
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


def _read(a: torch.Tensor) -> float:
    """`a` (one element) on the host: the host waits for the device."""
    with span(SPAN_READ):
        return float(a)


def _read_history(hist: list) -> np.ndarray:
    """The norm history kept on the device, on the host in float64."""
    with span(SPAN_READ):
        return torch.stack(hist).cpu().numpy().astype(np.float64)


def _solve_span(solver: Callable) -> Callable:
    """`solver` with its whole call inside a ``surfh.solver.solve`` span."""
    @functools.wraps(solver)
    def spanned(*args, **kwargs):
        with span(SPAN_SOLVE):
            return solver(*args, **kwargs)
    return spanned


@_solve_span
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
        limit = _read(tol * _norm(b))  # in the working dtype, as the reference compares
        norms = [_read(_norm(r))]
        it = 0
        while it < max_iter and norms[-1] > limit:
            with span(SPAN_ITER):
                x, r, z, p, rz = step(x, r, z, p, rz)
                norms.append(_read(_norm(r)))
            it += 1
        converged = it < max_iter
        grad_norm = np.asarray(norms, np.float64)
    else:
        limit = tol * _read(_norm(b).float())
        hist = [_norm(r).float()]
        k_chain = max(1, min(int(chain_steps), max_iter))
        it, next_check = 0, CHECK_EVERY
        while it < max_iter:
            for _ in range(min(k_chain, max_iter - it)):
                with span(SPAN_ITER):
                    x, r, z, p, rz = step(x, r, z, p, rz)
                    hist.append(_norm(r).float())
                it += 1
            if it >= next_check or it >= max_iter:
                next_check = it + CHECK_EVERY
                if _read(hist[-1]) <= limit:
                    break
        grad_norm = _read_history(hist)
        converged = bool(grad_norm[-1] <= limit)
    res = SolverResult(x=x, grad_norm=grad_norm, n_iter=it, converged=converged,
                       state=(x, r, z, p, rz) if return_state else None)
    if callback is not None:
        callback(res)
    return res


def _mmmg_body(normal_op, x, g, d_prev, q_prev, *op_args):
    """One MM memory-gradient iteration: minimize J(x + a·d0 + c·d_prev),
    d0 = −g, by the 2×2 Gram solve (steepest descent where |det| ≤ 1e-30).
    `q_prev` = Q·d_prev is carried by linearity, so one normal application
    an iteration; a and c stay on the device."""
    d0 = -g
    q0 = normal_op(d0, *op_args)
    q1 = q_prev
    a00, a01, a11 = _dot(d0, q0), _dot(d0, q1), _dot(d_prev, q1)
    g0d, g1d = _dot(g, d0), _dot(g, d_prev)
    det = a00 * a11 - a01 * a01
    safe = det.abs() > 1e-30
    den = torch.where(safe, det, torch.ones_like(det))
    a = torch.where(safe, (-g0d * a11 + g1d * a01) / den, -g0d / a00)
    c = torch.where(safe, (g0d * a01 - g1d * a00) / den, torch.zeros_like(det))
    step = a * d0 + c * d_prev
    x = x + step
    g = g + a * q0 + c * q1  # not g + q_new: the reference's order of additions
    q_new = a * q0 + c * q1
    return x, g, step, q_new


def _mmmg_first(normal_op, x0, g0, *op_args):
    """The first MM iteration, a steepest-descent step from x0 (no memory
    direction yet); the state `_mmmg_body` continues from."""
    q0 = normal_op(-g0, *op_args)
    alpha = _dot(g0, g0) / _dot(-g0, q0)
    x = x0 + alpha * (-g0)
    g = g0 + alpha * q0
    return x, g, alpha * (-g0), alpha * q0


@_solve_span
def mmmg(
    normal_op: Callable,
    b: torch.Tensor,
    x0: torch.Tensor,
    max_iter: int = 100,
    tol: float = 1e-12,
    callback: Optional[Callable] = None,
    op_args: tuple = (),
    loop: str = "graph",
) -> SolverResult:
    """MM memory gradient for J(x) = ½xᵀQx − bᵀx, Q = `normal_op(x, *op_args)`:
    each step minimizes J exactly over span{−∇J, x − x_prev}.  The first
    iteration is a steepest-descent step (no memory direction yet) and
    always runs.

    ``loop="graph"``: stops before a step where ‖g‖ ≤ tol·‖b‖;
    `grad_norm` is ‖g₀‖ then ‖g‖ after each iteration, `converged` is
    ``n_iter < max_iter``.  ``loop="dispatch"``: reads ‖g‖ at every
    `CHECK_EVERY`-th iteration count and at `max_iter` (so it may run past
    the crossing, as the reference does), keeps the float32 norm history on
    the device, and takes `converged` from the final norm.  Both loops run
    the same steps, so equal iteration counts give equal iterates."""
    if loop not in ("graph", "dispatch"):
        raise ValueError(f"unknown loop {loop!r}")
    g0 = normal_op(x0, *op_args) - b
    it = 1
    if loop == "graph":
        limit = _read(tol * _norm(b))
        norms = [_read(_norm(g0))]
        with span(SPAN_ITER):
            x, g, d, q = _mmmg_first(normal_op, x0, g0, *op_args)
            norms.append(_read(_norm(g)))
        while it < max_iter and norms[-1] > limit:
            with span(SPAN_ITER):
                x, g, d, q = _mmmg_body(normal_op, x, g, d, q, *op_args)
                norms.append(_read(_norm(g)))
            it += 1
        grad_norm = np.asarray(norms, np.float64)
        converged = it < max_iter
    else:
        limit = tol * _read(_norm(b).float())
        hist = [_norm(g0).float()]
        with span(SPAN_ITER):
            x, g, d, q = _mmmg_first(normal_op, x0, g0, *op_args)
            hist.append(_norm(g).float())
        while it < max_iter:
            with span(SPAN_ITER):
                x, g, d, q = _mmmg_body(normal_op, x, g, d, q, *op_args)
                hist.append(_norm(g).float())
            it += 1
            if (it % CHECK_EVERY == 0 or it == max_iter) and _read(hist[-1]) <= limit:
                break
        grad_norm = _read_history(hist)
        converged = bool(grad_norm[-1] <= limit)
    res = SolverResult(x=x, grad_norm=grad_norm, n_iter=it, converged=converged)
    if callback is not None:
        callback(res)
    return res
