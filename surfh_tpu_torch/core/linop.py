"""Linear operator base and adjoint verification.

Counterpart of `surfh_tpu/core/linop.py` (`LinOp`, `FuncLinOp`,
`dottest`).  An operator holds its shapes, its torch dtype and its device
(None: the card); subclasses implement :meth:`LinOp.forward`, and the
adjoint defaults to the exact transpose of the forward.

The reference derives that transpose with `jax.vjp` at a zero primal
(`build_transpose`).  Here it is `torch.func.vjp` of the linear forward,
taken once at a zero primal and kept: for a linear map the VJP *is* the
transpose, and the one `vjp_fn` serves every cotangent (its graph is
retained), so the forward is not run again per adjoint.  A forward that
goes through the row gather (`core.gather_rows.gather_rows_op`) has the
gather on the transposed plan as its backward, so a derived adjoint runs
kernel #1 in both directions on the card.

Not ported: `build_transpose`'s pinning of trace-time constants to the
CPU, a workaround for the reference's TPU runtime.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

from .precision import pick_device

Shape = Tuple[int, ...]


def torch_dtype(dtype) -> torch.dtype:
    """A NumPy or torch float dtype as a torch dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return torch.from_numpy(np.zeros(0, np.dtype(dtype))).dtype


def complex_dtype(dtype) -> torch.dtype:
    """The complex type that pairs with the float type `dtype` (NumPy or torch)."""
    return torch.complex64 if torch_dtype(dtype) == torch.float32 else torch.complex128


class LinOp:
    """A linear operator with explicit input / output shapes.

    `dtype` (NumPy or torch) is the computation type; `device` None means
    the card (raise without one).  :meth:`adjoint` is the exact transpose
    of :meth:`forward`, derived once; :meth:`normal` is adjoint∘forward,
    the call the port's criteria make, and :meth:`fwadj` the same map,
    which a model with a fused Hessian overrides (the criterion's
    ``use_fwadj``)."""

    def __init__(self, ishape: Shape, oshape: Shape, dtype=torch.float32, device=None):
        self.ishape = tuple(int(s) for s in ishape)
        self.oshape = tuple(int(s) for s in oshape)
        self.dtype = torch_dtype(dtype)
        self.device = pick_device(device)
        self._vjp_fns: dict = {}

    # -- to be provided by subclasses ------------------------------------
    def forward(self, x):
        raise NotImplementedError

    # -- derived ---------------------------------------------------------
    def _x(self, x) -> torch.Tensor:
        return torch.as_tensor(x).to(device=self.device, dtype=self.dtype).reshape(self.ishape)

    def _y(self, y) -> torch.Tensor:
        return torch.as_tensor(y).to(device=self.device, dtype=self.dtype).reshape(self.oshape)

    def derived_adjoint(self, fwd: Callable, key, y, ishape: Optional[Shape] = None) -> torch.Tensor:
        """The transpose of the linear `fwd` (tensor of `ishape`, default
        this operator's, → tensor) applied to `y`: `torch.func.vjp` at a
        zero primal, taken at the first call for `key` and kept."""
        vjp_fn = self._vjp_fns.get(key)
        if vjp_fn is None:
            shape = self.ishape if ishape is None else tuple(ishape)
            zero = torch.zeros(shape, device=self.device, dtype=self.dtype)
            _, vjp_fn = torch.func.vjp(fwd, zero)
            self._vjp_fns[key] = vjp_fn
        (x,) = vjp_fn(y)
        return x

    def adjoint(self, y) -> torch.Tensor:
        """Exact transpose of :meth:`forward` (derived automatically)."""
        return self.derived_adjoint(self.forward, "forward", self._y(y))

    def fwadj(self, x) -> torch.Tensor:
        """Hᵗ H x — override when a fused version exists."""
        return self.adjoint(self.forward(x))

    def normal(self, x) -> torch.Tensor:
        """Hᵗ H x as adjoint∘forward, the criterion's call."""
        return self.adjoint(self.forward(x))

    # -- conveniences ----------------------------------------------------
    @property
    def isize(self) -> int:
        return int(np.prod(self.ishape))

    @property
    def osize(self) -> int:
        return int(np.prod(self.oshape))

    def __call__(self, x):
        return self.forward(x)

    def matvec(self, x) -> np.ndarray:
        return self.forward(np.reshape(x, self.ishape)).detach().cpu().numpy().ravel()

    def rmatvec(self, y) -> np.ndarray:
        return self.adjoint(np.reshape(y, self.oshape)).detach().cpu().numpy().ravel()


class FuncLinOp(LinOp):
    """LinOp from a linear function ``fwd(x) -> y`` on tensors.  `jit` is
    the reference's argument and is not read: PyTorch runs eagerly."""

    def __init__(self, fwd: Callable, ishape: Shape, oshape: Shape, dtype=torch.float32,
                 jit: bool = True, device=None):
        super().__init__(ishape, oshape, dtype, device)
        self._fwd = fwd

    def forward(self, x) -> torch.Tensor:
        return self._fwd(self._x(x)).reshape(self.oshape)


def dottest(op: LinOp, num: int = 5, rtol: float = 1e-5, echo: bool = False, seed: int = 0) -> bool:
    """Adjoint consistency ⟨H x, y⟩ ≈ ⟨x, Hᵗ y⟩ for `num` random pairs
    (the reference's contract): the relative discrepancy of the two inner
    products, taken in float64 on the host, ≤ `rtol` for every pair."""
    rng = np.random.default_rng(seed)
    npdtype = torch.empty((), dtype=op.dtype).numpy().dtype
    ok = True
    for _ in range(num):
        x = rng.standard_normal(op.ishape).astype(npdtype)
        y = rng.standard_normal(op.oshape).astype(npdtype)
        hx = op.forward(x).detach().cpu().numpy().astype(np.float64).ravel()
        hty = op.adjoint(y).detach().cpu().numpy().astype(np.float64).ravel()
        lhs = np.vdot(hx, y.astype(np.float64).ravel())
        rhs = np.vdot(x.astype(np.float64).ravel(), hty)
        rel = abs(lhs - rhs) / max(abs(lhs), abs(rhs), 1e-30)
        if echo:
            print(f"dottest: <Hx,y>={lhs:.8e} <x,Hty>={rhs:.8e} rel={rel:.3e}")
        ok = ok and bool(rel <= rtol)
    return ok
