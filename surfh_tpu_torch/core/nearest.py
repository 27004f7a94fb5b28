"""Nearest-neighbour regridding plans (the S_NN operator).

Counterpart of `surfh_tpu/core/nearest.py`: the cKDTree query runs once per
pointing on the host and produces a 1-corner `BilinearPlan`, so NN and
bilinear gridding share the composed gather, its transpose and kernel #1.
"""

from __future__ import annotations

import numpy as np

from .bilinear import BilinearPlan


def nearest_plan(alpha_axis: np.ndarray, beta_axis: np.ndarray, points: np.ndarray,
                 fill_out_of_bounds: bool = False) -> BilinearPlan:
    """Single-corner gather plan: each target point maps to its nearest
    source-grid node; with `fill_out_of_bounds`, points outside the grid
    get weight 0."""
    from scipy.spatial import cKDTree

    alpha_axis = np.asarray(alpha_axis, np.float64)
    beta_axis = np.asarray(beta_axis, np.float64)
    grid = np.stack(np.meshgrid(alpha_axis, beta_axis, indexing="ij"), axis=-1).reshape(-1, 2)
    tree = cKDTree(grid)
    pa = np.asarray(points[:, 0], np.float64)
    pb = np.asarray(points[:, 1], np.float64)
    _, idx = tree.query(np.stack([pa, pb], axis=-1))
    w = np.ones((1, len(pa)))
    if fill_out_of_bounds:
        oob = ((pa < alpha_axis[0]) | (pa > alpha_axis[-1])
               | (pb < beta_axis[0]) | (pb > beta_axis[-1]))
        w = np.where(oob[np.newaxis, :], 0.0, w)
    return BilinearPlan(idx[np.newaxis, :].astype(np.int32), w, (len(alpha_axis), len(beta_axis)))
