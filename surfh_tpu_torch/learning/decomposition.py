"""Spectral template learning: NMF, PCA, N-FINDR + FCLS (counterpart of
`surfh_tpu/learning/decomposition.py`).

The same decompositions on a torch device (None: the card, or the device
of a tensor argument; pass "cpu" for the host), with the reference's
formulas, initial factors and iteration counts:

* NMF: Lee–Seung multiplicative updates, two full-FP32 matrix products per
  factor per iteration (TF32 stays off, `core.precision`: reduced-precision
  updates stall near the fixed point);
* PCA: SVD of the centred data matrix;
* N-FINDR: simplex-volume maximization by vertex replacement, a host NumPy
  scan over the PCA scores;
* FCLS: projected gradient, nonnegative and sum-to-one, with the exact
  simplex projection.

Results are tensors on the device (N-FINDR: host arrays, as its scan).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..core.precision import pick_device


def _device(device, *args) -> torch.device:
    """`device`, else that of the first tensor argument, else the card."""
    if device is None:
        for a in args:
            if isinstance(a, torch.Tensor):
                return a.device
    return pick_device(device)


def _torch_dtype(dtype) -> torch.dtype:
    """float64 for a NumPy or torch float64, else float32."""
    return torch.float64 if dtype in (np.float64, torch.float64) else torch.float32


def _nmf_run(X, W, H, n_iter: int):
    eps = torch.tensor(1e-9, dtype=X.dtype, device=X.device)
    for _ in range(n_iter):
        H = H * (W.T @ X) / (W.T @ W @ H + eps)
        W = W * (X @ H.T) / (W @ (H @ H.T) + eps)
    return W, H


def nmf(X, n_components: int, n_iter: int = 500, seed: int = 0, dtype=np.float32,
        device=None) -> Tuple[torch.Tensor, torch.Tensor, float]:
    """Nonnegative factorization X ≈ W H (X: [n_samples, n_features],
    negative entries clipped to 0), `dtype` NumPy or torch.  The initial
    factors are the reference's draws from ``np.random.default_rng(seed)``.
    Returns (W [n_samples, k], H [k, n_features], ‖X − WH‖)."""
    device = _device(device, X)
    X = torch.as_tensor(X).to(device=device, dtype=_torch_dtype(dtype)).clamp_min(0)
    rng = np.random.default_rng(seed)
    scale = float(np.sqrt(float(X.mean()) / n_components + 1e-12))
    W0 = torch.as_tensor(rng.random((X.shape[0], n_components)) * scale + 1e-3).to(device, X.dtype)
    H0 = torch.as_tensor(rng.random((n_components, X.shape[1])) * scale + 1e-3).to(device, X.dtype)
    W, H = _nmf_run(X, W0, H0, n_iter)
    err = float(torch.linalg.vector_norm(X - W @ H))
    return W, H, err


def pca(X, n_components: int, device=None) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """PCA of X [n_samples, n_features]: (components [k, f],
    explained_variance [k], scores [n, k]); each component's sign is the
    SVD's."""
    X = torch.as_tensor(X).to(_device(device, X))
    Xc = X - X.mean(dim=0)
    U, S, Vt = torch.linalg.svd(Xc, full_matrices=False)
    comps = Vt[:n_components]
    var = S[:n_components] ** 2 / (X.shape[0] - 1)
    scores = U[:, :n_components] * S[:n_components]
    return comps, var, scores


def nfindr(pixels: np.ndarray, n_endmembers: int, n_sweeps: int = 3, seed: int = 0,
           device=None):
    """N-FINDR endmember extraction: maximize the simplex volume spanned by
    `n_endmembers` pixel spectra in the (k−1)-dim PCA subspace (the PCA on
    `device`, the volume scan on the host).  pixels: [n_pixels, n_bands].
    Returns (endmembers [k, n_bands], indices)."""
    pixels = np.asarray(pixels, np.float64)
    k = n_endmembers
    _, _, scores = pca(pixels, k - 1, device=device)
    Y = scores.cpu().numpy()  # [n, k-1]; a component's sign flips no volume
    rng = np.random.default_rng(seed)
    idx = rng.choice(len(Y), size=k, replace=False)

    def volume(ind):
        M = np.ones((k, k))
        M[:, 1:] = Y[ind]
        return abs(np.linalg.det(M))

    best = volume(idx)
    for _ in range(n_sweeps):
        improved = False
        for j in range(k):
            M = np.ones((k, k))
            M[:, 1:] = Y[idx]
            vols = np.empty(len(Y))
            for cand_block in np.array_split(np.arange(len(Y)), max(1, len(Y) // 4096)):
                Mb = np.broadcast_to(M, (len(cand_block), k, k)).copy()
                Mb[:, j, 1:] = Y[cand_block]
                vols[cand_block] = np.abs(np.linalg.det(Mb))
            cand = int(np.argmax(vols))
            if vols[cand] > best:
                idx[j] = cand
                best = vols[cand]
                improved = True
        if not improved:
            break
    return pixels[idx], idx


def _project_simplex(a: torch.Tensor) -> torch.Tensor:
    """Euclidean projection of each column of a [k, n] onto the probability
    simplex."""
    k = a.shape[0]
    u = torch.sort(a, dim=0, descending=True).values
    css = torch.cumsum(u, dim=0) - 1.0
    ks = torch.arange(1, k + 1, dtype=a.dtype, device=a.device)[:, None]
    rho = (u - css / ks > 0).sum(dim=0)
    theta = torch.gather(css, 0, (rho - 1)[None, :])[0] / rho.to(a.dtype)
    return torch.clamp_min(a - theta[None, :], 0.0)


def fcls(pixels, endmembers, n_iter: int = 200, dtype=np.float32, device=None) -> torch.Tensor:
    """Fully-constrained least squares unmixing, abundances ≥ 0 summing to
    1: pixels [n, bands], endmembers [k, bands] → abundances [n, k].
    Projected gradient with step 1/‖EEᵀ‖₂ from abundances 1/k, in `dtype`
    (the reference's is float32)."""
    device = _device(device, pixels, endmembers)
    tdt = _torch_dtype(dtype)
    E = torch.as_tensor(endmembers).to(device=device, dtype=tdt)
    X = torch.as_tensor(pixels).to(device=device, dtype=tdt)
    k = E.shape[0]
    G = E @ E.T
    lip = torch.linalg.matrix_norm(G, ord=2)
    B = E @ X.T
    A = torch.full((k, X.shape[0]), 1.0 / k, dtype=tdt, device=device)
    for _ in range(n_iter):
        A = _project_simplex(A - (G @ A - B) / lip)
    return A.T


def learn_templates_nmf(cube, n_templates: int, mask: Optional[np.ndarray] = None,
                        n_iter: int = 500, seed: int = 0,
                        device=None) -> Tuple[torch.Tensor, torch.Tensor, float]:
    """LMM spectral templates of a cube [λ, Nα, Nβ] (an array, or a tensor
    on its device) by `nmf` over the pixels of `mask` (all when None), in
    float32.  Returns (templates [k, λ], abundance maps [k, Nα, Nβ], zero
    outside the mask, reconstruction error)."""
    device = _device(device, cube)
    cube = torch.as_tensor(cube).to(device)
    L = cube.shape[0]
    flat = cube.reshape(L, -1).T  # [pixels, λ]
    sel = None
    X = flat
    if mask is not None:
        sel = torch.as_tensor(np.asarray(mask).ravel(), device=device)
        X = flat[sel]
    W, H, err = nmf(X, n_templates, n_iter=n_iter, seed=seed)
    del X
    if sel is None:
        maps_flat = W
    else:
        maps_flat = torch.zeros((flat.shape[0], n_templates), dtype=W.dtype, device=device)
        maps_flat[sel] = W
    maps = maps_flat.T.reshape((n_templates,) + tuple(cube.shape[1:]))
    return H, maps, err
