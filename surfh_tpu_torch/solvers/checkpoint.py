"""Solver-state checkpointing: save and resume long reconstructions.

Counterpart of `surfh_tpu/solvers/checkpoint.py`, with the same file: an
``.npz`` of NumPy arrays under the reference's keys (``x``,
``n_iter_done``, ``grad_norm``, ``crit_val`` and, for `lcg`, the state
``state_0`` … ``state_4`` = (x, r, z, p, rz) with ``n_state``).  So a
checkpoint written by either package resumes in the other; the tensors
are copied to the host to be saved, and to the model's device and dtype
when loaded.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from .cg import SolverResult


def _host(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def save_checkpoint(
    path: str, x, n_iter_done: int, grad_norm=None, crit_val=None, state=None
) -> None:
    """Write the checkpoint atomically (a temporary file, then a rename)."""
    tmp = path + ".tmp"
    parent = os.path.dirname(os.path.abspath(path))
    os.makedirs(parent, exist_ok=True)
    payload = dict(
        x=_host(x),
        n_iter_done=int(n_iter_done),
        grad_norm=np.asarray(grad_norm if grad_norm is not None else []),
        crit_val=np.asarray(crit_val if crit_val is not None else []),
    )
    if state is not None:
        for i, s in enumerate(state):
            payload[f"state_{i}"] = _host(s)
        payload["n_state"] = len(state)
    with open(tmp, "wb") as fh:
        np.savez(fh, **payload)
    os.replace(tmp, path)


def load_checkpoint(path: str):
    """Returns dict(x, n_iter_done, grad_norm, crit_val[, state]) of host
    arrays, or None."""
    if not os.path.exists(path):
        return None
    with np.load(path, allow_pickle=False) as z:
        out = dict(
            x=z["x"],
            n_iter_done=int(z["n_iter_done"]),
            grad_norm=z["grad_norm"],
            crit_val=z["crit_val"],
        )
        if "n_state" in z:
            out["state"] = tuple(z[f"state_{i}"] for i in range(int(z["n_state"])))
        return out


def run_checkpointed(
    criterion,
    method: str = "lcg",
    niter: int = 100,
    checkpoint_path: Optional[str] = None,
    checkpoint_every: int = 0,
    value_init=0.5,
    tolerance: float = 1e-12,
) -> SolverResult:
    """Drive `criterion.run_method` in segments, saving a checkpoint after
    each segment.  Resumes automatically if the checkpoint file already
    exists.  For `lcg` the FULL solver state (x, r, z, p, rz) is carried, so
    segmented runs apply the same operations as an uninterrupted solve;
    other methods resume by warm start.  The result's `x` is a tensor on
    the model's device."""
    dev, dt = criterion.model.device, criterion.model.dtype

    def on_device(a):
        return torch.as_tensor(np.asarray(a)).to(device=dev, dtype=dt)

    done = 0
    grad_hist: list = []
    x = value_init
    state = None
    if checkpoint_path:
        ck = load_checkpoint(checkpoint_path)
        if ck is not None and ck["n_iter_done"] > 0:
            done = min(ck["n_iter_done"], niter)
            x = on_device(ck["x"])
            grad_hist = list(ck["grad_norm"])
            if ck.get("state") is not None:
                state = tuple(on_device(s) for s in ck["state"])

    seg = checkpoint_every if (checkpoint_path and checkpoint_every > 0) else niter
    exact = method == "lcg"
    res = None
    while done < niter:
        step = min(seg, niter - done)
        kwargs = dict(maximum_iterations=step, tolerance=tolerance, value_init=x)
        if exact:
            kwargs.update(solver_state=state, return_state=True)
        res = criterion.run_method(method, **kwargs)
        x = res.x
        state = res.state
        done += res.n_iter if res.n_iter > 0 else step
        grad_hist.extend(res.grad_norm.tolist())
        if checkpoint_path:
            save_checkpoint(checkpoint_path, x, done, grad_hist, state=state)
        if res.converged and res.n_iter < step:
            break
    if not isinstance(x, torch.Tensor):  # niter ≤ 0: `value_init` as given
        x = on_device(x)
    return SolverResult(
        x=x,
        grad_norm=np.asarray(grad_hist),
        n_iter=done,
        converged=True if res is None else res.converged,
    )
