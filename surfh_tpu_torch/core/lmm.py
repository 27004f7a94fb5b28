"""Linear mixing model (the T operator) as plain matmuls.

Counterpart of `surfh_tpu/core/lmm.py`: maps [M, Na, Nb] ↔ cube [L, Na, Nb]
through the templates [M, L], one matmul each way (full FP32, see
`core.precision`).
"""

from __future__ import annotations

import torch


def lmm_maps2cube(maps: torch.Tensor, templates: torch.Tensor) -> torch.Tensor:
    """cube[λ, i, j] = Σ_m maps[m, i, j] · templates[m, λ]."""
    m, na, nb = maps.shape
    return (templates.T @ maps.reshape(m, na * nb)).reshape(templates.shape[1], na, nb)


def lmm_cube2maps(cube: torch.Tensor, templates: torch.Tensor) -> torch.Tensor:
    """maps[m, i, j] = Σ_λ cube[λ, i, j] · templates[m, λ] (exact adjoint)."""
    l, na, nb = cube.shape
    return (templates @ cube.reshape(l, na * nb)).reshape(templates.shape[0], na, nb)
