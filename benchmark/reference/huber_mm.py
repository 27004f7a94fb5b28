"""The plain reference of the voxel reconstruction with Huber priors: an MM
memory-gradient minimisation of

    J(x) = ½ ‖H x − y‖² + Σ_k µ_k Σ_i huber_δk((D_k x)_i)

over the cube x [L, N, N], written in plain PyTorch from the published
description of upstream's ``algorithms.vox_reconstruction`` (sidiso/surfh
``surfh/ToolsDir/algorithms.py:27-71``), which hands this criterion to the
``qmm`` library's MM memory-gradient solver.

* The priors: the non-circular forward differences along the two sky axes
  (µ = ``spat_reg``, δ = ``spat_th``) and along λ (``spec_reg``,
  ``spec_th``), (D x)_i = x_{i+1} − x_i, and their exact transposes.
  huber_δ(u) is u²/2 for |u| ≤ δ and δ|u| − δ²/2 beyond; its derivative
  φ'(u) is u clipped to [−δ, δ].
* The majorant: at the iterate x, Geman–Reynolds' half-quadratic
  majorant of each Huber term, with weights w = φ'(u)/u (1 inside the
  threshold, δ/|u| outside); the data term is its own majorant.
* The step: the majorant minimised exactly over the span of the memory
  directions d0 = −∇J(x) and d1 = x − x_prev (a 2 × 2 linear system of the
  majorant's curvature on them); the first step has no memory and moves
  along d0 alone.  Where the 2 × 2 system is singular (|det| ≤ 1e-30) the
  step falls back to d0 alone.
* The start: Hᵗy, upstream's default.

Departures from upstream, all of the benchmark's making: a fixed number
of steps (the first counted) with no stopping test on ‖∇J‖; no criterion
values or norms recorded; everything in the operator's precision (float64
for the reference).  The images H d0, H x are carried from step to step (H
is linear, so H(x + s d0 + t d1) = Hx + s H d0 + t H d1): an iteration costs
one forward and one transpose, and H d0 is −H(∇J), the negation being exact.

Every inner product and the 2 × 2 system are in float64 whatever the
operator's precision (the control runs this in float32): from Hᵗy on the
12-band operator ‖∇J‖² passes float32's range.

`op` is any operator with ``forward(x) -> [per-band data]``,
``adjoint([per-band data]) -> x``, `x_shape`, `dtype` and `device`
(`operator.Reference`, or the control's stand-ins in its place); inner
products on the data run over the bands' list.  The priors, their
gradient and their Gram entries are evaluated in blocks of `planes`
λ-planes, each block owning the differences that start in it (the
spectral one reads one plane past the block), so that besides the
operator only three cubes are held: x, x_prev and ∇J.  Nothing of the
program is imported.
"""

from __future__ import annotations

import torch

PLANES = 128  # λ-planes a block


def priors(spat_reg: float, spat_th: float, spec_reg: float, spec_th: float) -> list:
    """(axis, δ, µ) of the three priors: the two sky axes, then λ."""
    return [(1, float(spat_th), float(spat_reg)), (2, float(spat_th), float(spat_reg)),
            (0, float(spec_th), float(spec_reg))]


def _pair(z: torch.Tensor, l0: int, l1: int, axis: int):
    """The (lower, upper) views of `z` [L, N, N] whose difference is the
    block l0..l1's share of D_axis z: the differences that start in planes
    l0..l1 (along λ: upper planes l0 + 1 .. min(l1, L − 1) + 1)."""
    if axis == 0:
        e = min(l1, z.shape[0] - 1)
        return z[l0:e], z[l0 + 1 : e + 1]
    block = z[l0:l1]
    n = block.shape[axis]
    return block.narrow(axis, 0, n - 1), block.narrow(axis, 1, n - 1)


def diff(z: torch.Tensor, l0: int, l1: int, axis: int) -> torch.Tensor:
    lo, hi = _pair(z, l0, l1, axis)
    return hi - lo


def add_diff_t_(out: torch.Tensor, v: torch.Tensor, l0: int, l1: int, axis: int, scale: float) -> None:
    """out += scale · D_axisᵀ v, v the block l0..l1's differences: each
    difference x_{i+1} − x_i gives +v to i + 1 and −v to i."""
    lo, hi = _pair(out, l0, l1, axis)
    sv = scale * v
    lo.sub_(sv)
    hi.add_(sv)


def _blocks(n: int, planes: int):
    return [(l0, min(l0 + planes, n)) for l0 in range(0, n, planes)]


def _vdot(a: list, b: list) -> torch.Tensor:
    """⟨a, b⟩ over the bands' list, in float64."""
    return sum(torch.sum(u.double() * v.double()) for u, v in zip(a, b))


def _sq(z: torch.Tensor, planes: int) -> torch.Tensor:
    """⟨z, z⟩ in float64, block by block."""
    return sum(torch.sum(z[l0:l1].double() ** 2) for l0, l1 in _blocks(z.shape[0], planes))


def huber(u: torch.Tensor, delta: float) -> torch.Tensor:
    a = u.abs()
    return torch.where(a <= delta, 0.5 * u * u, delta * a - 0.5 * delta * delta)


def objective(op, y: list, x: torch.Tensor, prior_list: list, planes: int = PLANES) -> torch.Tensor:
    """J(x)."""
    r = [h - d for h, d in zip(op.forward(x), y)]
    out = 0.5 * _vdot(r, r)
    for l0, l1 in _blocks(x.shape[0], planes):
        for axis, delta, mu in prior_list:
            out = out + mu * torch.sum(huber(diff(x, l0, l1, axis), delta))
    return out


def gradient(op, y: list, hx: list, x: torch.Tensor, prior_list: list, planes: int = PLANES) -> torch.Tensor:
    """∇J(x) = Hᵗ(Hx − y) + Σ_k µ_k D_kᵀ φ'_k(D_k x), `hx` = H x."""
    g = op.adjoint([h - d for h, d in zip(hx, y)])
    for l0, l1 in _blocks(x.shape[0], planes):
        for axis, delta, mu in prior_list:
            add_diff_t_(g, diff(x, l0, l1, axis).clamp(-delta, delta), l0, l1, axis, mu)
    return g


def _gram(x, x_prev, g, h0, h1, prior_list, planes):
    """The majorant's curvature on (d0, d1) = (−g, x − x_prev) at x: a00,
    a01, a11, and −⟨g, d1⟩; with `x_prev` None, d1 = d0 (the first step).
    All in float64, block by block."""
    a00, a01, a11 = _vdot(h0, h0), _vdot(h0, h1), _vdot(h1, h1)
    b1 = torch.zeros((), dtype=torch.float64, device=x.device)
    L = x.shape[0]
    for l0, l1 in _blocks(L, planes):
        top = min(l1 + 1, L)  # one plane past the block: the λ-differences that start in it
        d0 = -g[l0:top].double()
        d1 = d0 if x_prev is None else (x[l0:top] - x_prev[l0:top]).double()
        xb = x[l0:top].double()
        b1 = b1 - torch.sum(g[l0:l1].double() * d1[: l1 - l0])
        for axis, delta, mu in prior_list:
            u = diff(xb, 0, l1 - l0, axis)
            w = torch.where(u.abs() <= delta, torch.ones_like(u), delta / u.abs().clamp_min(1e-30))
            e0, e1 = diff(d0, 0, l1 - l0, axis), diff(d1, 0, l1 - l0, axis)
            a00 = a00 + mu * torch.sum(w * e0 * e0)
            a01 = a01 + mu * torch.sum(w * e0 * e1)
            a11 = a11 + mu * torch.sum(w * e1 * e1)
    return a00, a01, a11, b1


def mm_solve(op, y: list, x: torch.Tensor, prior_list: list, n_iter: int,
             planes: int = PLANES) -> torch.Tensor:
    """`n_iter` MM memory-gradient steps (the first, steepest descent,
    counted) from `x`, which is updated in place where it already is of
    the operator's type and device: the last iterate."""
    x = x.to(op.device, op.dtype)
    hx_prev = op.forward(x)
    g = gradient(op, y, hx_prev, x, prior_list, planes)
    h0 = [-h for h in op.forward(g)]  # H(−g)
    a00, _, _, _ = _gram(x, None, g, h0, h0, prior_list, planes)
    alpha = _sq(g, planes) / a00.clamp_min(1e-30)
    x_prev = x.clone()
    for l0, l1 in _blocks(x.shape[0], planes):
        x[l0:l1] -= alpha * g[l0:l1]
    hx = [a + alpha * b for a, b in zip(hx_prev, h0)]
    for _ in range(1, n_iter):
        del g
        g = gradient(op, y, hx, x, prior_list, planes)
        h0 = [-h for h in op.forward(g)]
        h1 = [a - b for a, b in zip(hx, hx_prev)]
        a00, a01, a11, b1 = _gram(x, x_prev, g, h0, h1, prior_list, planes)
        b0 = _sq(g, planes)  # −⟨g, d0⟩
        det = a00 * a11 - a01 * a01
        if float(det.abs()) > 1e-30:
            s, t = (b0 * a11 - b1 * a01) / det, (b1 * a00 - b0 * a01) / det
        else:
            s, t = b0 / a00.clamp_min(1e-30), torch.zeros_like(det)
        for l0, l1 in _blocks(x.shape[0], planes):  # x ← x + s·d0 + t·d1, x_prev ← x
            xb = x[l0:l1].clone()
            x[l0:l1] += -s * g[l0:l1] + t * (xb - x_prev[l0:l1])
            x_prev[l0:l1] = xb
        hx, hx_prev = [a + s * b + t * c for a, b, c in zip(hx, h0, h1)], hx
    return x


def vox_reconstruction(op, y: list, params: dict, n_iter: int, planes: int = PLANES) -> torch.Tensor:
    """Upstream's voxel reconstruction of the data `y` through `op`: the
    priors of `params` (``spat_reg``, ``spat_th``, ``spec_reg``,
    ``spec_th``), `n_iter` steps from Hᵗy."""
    prior_list = priors(params["spat_reg"], params["spat_th"], params["spec_reg"], params["spec_th"])
    return mm_solve(op, y, op.adjoint(y), prior_list, n_iter, planes)
