"""DFT-as-matmul tables (host, NumPy), the rank-basis conv pair and the
materialized-OTF FFT conv (torch).

Counterpart of `surfh_tpu/core/fft.py`.  The host table functions are NumPy
copies of the reference's (same arithmetic, so both packages build
bit-identical tables); the device side is the λ-rank fused T·C conv
`lmm_conv_rank` and its exact transpose as chains of plain GEMMs, and, for
the W-plane path, the unitary `dft` / `idft` pair (cuFFT on the card, as
the reference leaves it to `jnp.fft`), the chunked in-place OTF conv and a
device `ir2fr` that builds the materialized OTF from the PSF stamps.

Layout.  The reference keeps the rank-basis patch as ``[Q, ha, wb]``; the
row-gather kernel downstream wants one contiguous ``Q``-wide row per patch
pixel.  So the port's hot path (`lmm_conv_rank_rows` / `_rows_t`) makes the
inverse α-stage ONE GEMM over a ``[Ka', Kb'·Q]`` operand and lets the last
contraction write ``[ha·wb, Q]`` directly: no transpose anywhere on the
path.  `lmm_conv_rank` / `lmm_conv_rank_t` keep the reference layout for
comparisons and are thin permutes around the row forms.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .precision import require_cuda

# ---------------------------------------------------------------------------
# host tables (NumPy copies of surfh_tpu/core/fft.py:61-413)


def ir2fr(imp_resp: np.ndarray, shape: Tuple[int, int]) -> np.ndarray:
    """Transfer function of an impulse response, centered, non-unitary
    (the `udft.ir2fr` semantics: pad to `shape`, roll the center to (0, 0),
    non-normalized real FFT over the trailing ``len(shape)`` axes)."""
    imp_resp = np.asarray(imp_resp)
    ndim_s = len(shape)
    center = [length // 2 for length in imp_resp.shape[-ndim_s:]]
    padded = np.zeros(imp_resp.shape[:-ndim_s] + tuple(shape), dtype=imp_resp.dtype)
    padded[tuple(slice(0, s) for s in imp_resp.shape)] = imp_resp
    for ax, shift in enumerate(center):
        padded = np.roll(padded, -shift, imp_resp.ndim - ndim_s + ax)
    return np.fft.rfftn(padded, axes=list(range(imp_resp.ndim - ndim_s, imp_resp.ndim)))


def box_otf_sr(srf: int, im_shape: Tuple[int, int], dtype=np.complex64) -> np.ndarray:
    """OTF of the [srf, 1] box that accumulates `srf` oversampled α rows."""
    return ir2fr(np.ones((srf, 1)), im_shape)[np.newaxis, ...].astype(dtype)


def half_srf_shift_otf(srf: int, im_shape: Tuple[int, int], dtype=np.complex64) -> np.ndarray:
    """Pure-phase OTF shifting by (srf-1)//2 along α (the `decalf` trick)."""
    decal = np.zeros(im_shape)
    dsi = int((srf - 1) / 2)
    decal[-dsi if dsi else 0, 0] = np.sqrt(im_shape[0] * im_shape[1])
    return np.fft.rfftn(decal, axes=(-2, -1), norm="ortho").astype(dtype)


def dft_matmul_tables(
    im_shape: Tuple[int, int],
    dtype=np.float32,
    ka_max: Optional[int] = None,
    kb_keep: Optional[int] = None,
    bbox: Optional[Tuple[int, int, int, int]] = None,
) -> dict:
    """DFT matrices of the non-unitary rfft2/irfft2 pair, restricted to the
    OTF's frequency support (`ka_max`, `kb_keep`) and to the spatial window
    `bbox` = (a0, b0, ha, wb) on the inverse side.  The α stages come in
    Gauss 3-multiplication form (``*_d`` = im−re, ``*_s`` = re+im)."""
    na, nb = int(im_shape[0]), int(im_shape[1])
    kb = nb // 2 + 1
    if kb_keep is None or kb_keep > kb:
        kb_keep = kb
    kb_keep = max(int(kb_keep), 1)
    a = np.arange(na)
    b = np.arange(nb)
    sel_a = freq_sel_alpha(na, ka_max)
    fb = np.exp(-2j * np.pi * np.outer(np.arange(kb_keep), b) / nb)  # [Kb', Nb]
    fa = np.exp(-2j * np.pi * np.outer(sel_a, a) / na)  # [Ka', Na]
    ifa = np.conj(fa).T / na  # [Na, Ka']
    cb = np.exp(2j * np.pi * np.outer(b, np.arange(kb_keep)) / nb)  # [Nb, Kb']
    if bbox is not None:
        a0, b0, ha, wb = (int(v) for v in bbox)
        ifa = ifa[a0 : a0 + ha]
        cb = cb[b0 : b0 + wb]
    wgt = np.ones(kb_keep)
    wgt[1:] = 2.0
    if nb % 2 == 0 and kb_keep == kb:
        wgt[-1] = 1.0  # even Nb: the Nyquist bin is not doubled
    return {
        "fb_re": fb.real.astype(dtype),
        "fb_im": fb.imag.astype(dtype),
        "fa_re": fa.real.astype(dtype),
        "fa_d": (fa.imag - fa.real).astype(dtype),
        "fa_s": (fa.real + fa.imag).astype(dtype),
        "ifa_re": ifa.real.astype(dtype),
        "ifa_d": (ifa.imag - ifa.real).astype(dtype),
        "ifa_s": (ifa.real + ifa.imag).astype(dtype),
        "icb_re": (cb.real * wgt / nb).astype(dtype),
        "icb_im": (cb.imag * wgt / nb).astype(dtype),
    }


def freq_sel_alpha(na: int, ka_max: Optional[int]) -> np.ndarray:
    """α-axis DFT bin indices with |signed frequency| ≤ `ka_max` (all if None)."""
    a = np.arange(na)
    if ka_max is None:
        return a
    sfreq = np.minimum(a, na - a)
    return np.nonzero(sfreq <= int(ka_max))[0]


def psf_stamp_tables(
    im_shape: Tuple[int, int],
    stamp_shape: Tuple[int, int],
    dtype=np.float32,
    ka_max: Optional[int] = None,
    kb_keep: Optional[int] = None,
) -> dict:
    """DFT-at-stamp matrices: the OTF of a padded, centered PSF stamp sampled
    only at the kept frequency bins (closed form of ``ir2fr(psf, im_shape)``)."""
    na, nb = int(im_shape[0]), int(im_shape[1])
    sx, sy = int(stamp_shape[0]), int(stamp_shape[1])
    kb = nb // 2 + 1
    if kb_keep is None or kb_keep > kb:
        kb_keep = kb
    kb_keep = max(int(kb_keep), 1)
    cx, cy = sx // 2, sy // 2
    sel_a = freq_sel_alpha(na, ka_max)
    sa = np.exp(-2j * np.pi * np.outer(sel_a, np.arange(sx) - cx) / na)
    sb = np.exp(-2j * np.pi * np.outer(np.arange(sy) - cy, np.arange(kb_keep)) / nb)
    return {
        "sa_re": sa.real.astype(dtype),
        "sa_im": sa.imag.astype(dtype),
        "sb_re": sb.real.astype(dtype),
        "sb_im": sb.imag.astype(dtype),
    }


def lowrank_stamp_factor(psf, rtol: float):
    """λ-rank factorization psf ≈ U·V of a stamp stack [W, sx, sy] by SVD.

    Returns ``(U [W, R], V [R, sx, sy], tail)``; singular values are folded
    into U, components with σ_i/σ₁ ≤ `rtol` dropped (R ≥ 1), and
    ``tail = σ_{R+1}/σ₁`` bounds the truncated conv's relative deviation."""
    psf = np.asarray(psf)
    W = psf.shape[0]
    A = psf.reshape(W, -1).astype(np.float64)
    Um, s, Vt = np.linalg.svd(A, full_matrices=False)
    if s[0] <= 0.0:
        R = 1
    else:
        R = max(1, int(np.sum(s / s[0] > rtol)))
    U = (Um[:, :R] * s[:R]).astype(psf.dtype)
    V = Vt[:R].reshape((R,) + psf.shape[1:]).astype(psf.dtype)
    tail = float(s[R] / s[0]) if R < len(s) and s[0] > 0.0 else 0.0
    return U, V, tail


def _support_from_axis_maxima(colmax, rowmax, rtol: float):
    """Per-axis OTF magnitude maxima → (ka_max, kb_keep, dropped_rel)."""
    na, kb = len(rowmax), len(colmax)
    amax = float(colmax.max())
    if amax == 0.0 or rtol <= 0.0:
        return None, None, 0.0
    thr = rtol * amax
    keep_b = np.nonzero(colmax >= thr)[0]
    kb_keep = int(keep_b[-1]) + 1 if len(keep_b) else 1
    sfreq = np.minimum(np.arange(na), na - np.arange(na))
    keep_a = np.nonzero(rowmax >= thr)[0]
    ka_max = int(sfreq[keep_a].max()) if len(keep_a) else 0
    dropped = 0.0
    if kb_keep < kb:
        dropped = max(dropped, float(colmax[kb_keep:].max()) / amax)
    out_a = sfreq > ka_max
    if out_a.any():
        dropped = max(dropped, float(rowmax[out_a].max()) / amax)
    return ka_max, kb_keep, dropped


def otf_support_from_psf(psf_stack, im_shape: Tuple[int, int], rtol: float, chunk: int = 64):
    """(ka_max, kb_keep, dropped_rel): the frequency support of a PSF stamp
    stack's OTF, evaluated chunk by chunk in float64 without materializing
    the full OTF window."""
    psf_stack = np.asarray(psf_stack)
    na, nb = int(im_shape[0]), int(im_shape[1])
    kb = nb // 2 + 1
    st = psf_stamp_tables(im_shape, psf_stack.shape[-2:], np.float64)
    sa = st["sa_re"] + 1j * st["sa_im"]
    sb = st["sb_re"] + 1j * st["sb_im"]
    colmax = np.zeros(kb)
    rowmax = np.zeros(na)
    for i in range(0, psf_stack.shape[0], chunk):
        z = np.einsum("wxy,cx->wcy", psf_stack[i : i + chunk], sa)
        mag = np.abs(np.einsum("wcy,yk->wck", z, sb))
        colmax = np.maximum(colmax, mag.max(axis=(0, 1)))
        rowmax = np.maximum(rowmax, mag.max(axis=(0, 2)))
    return _support_from_axis_maxima(colmax, rowmax, rtol)


# ---------------------------------------------------------------------------
# device side: the rank-basis fused T·C conv and its exact transpose


def _dft_maps(maps: torch.Tensor, m: dict):
    """Forward 2-D DFT of the M template maps on the kept bins → (re, im) [M, Ka', Kb']."""
    yb_re = maps @ m["fb_re"].T  # [M, Na, Kb']
    yb_im = maps @ m["fb_im"].T
    k1 = m["fa_re"] @ (yb_re + yb_im)  # Gauss 3M α-stage
    return k1 - m["fa_s"] @ yb_im, k1 + m["fa_d"] @ yb_re


def lmm_conv_rank_rows(maps: torch.Tensor, otf_re: torch.Tensor, otf_im: torch.Tensor, m: dict) -> torch.Tensor:
    """Rank-basis conv onto the FOV bbox, ROW layout: maps [M, Na, Nb] →
    [ha·wb, Q], Q = M·R m-major.  `otf_*` are [Ka', Kb', R] (bin-major)."""
    zr, zi = _dft_maps(maps, m)
    zr = zr.permute(1, 2, 0).unsqueeze(-1)  # [Ka', Kb', M, 1]
    zi = zi.permute(1, 2, 0).unsqueeze(-1)
    o_re = otf_re.unsqueeze(-2)  # [Ka', Kb', 1, R]
    o_im = otf_im.unsqueeze(-2)
    ka, kb = zr.shape[0], zr.shape[1]
    t_re = (zr * o_re - zi * o_im).reshape(ka, -1)  # [Ka', Kb'·Q]
    t_im = (zr * o_im + zi * o_re).reshape(ka, -1)
    ha, wb = m["ifa_re"].shape[0], m["icb_re"].shape[0]
    k1 = m["ifa_re"] @ (t_re + t_im)  # one GEMM per term: [ha, Kb'·Q]
    ua_re = (k1 - m["ifa_s"] @ t_im).view(ha, kb, -1)
    ua_im = (k1 + m["ifa_d"] @ t_re).view(ha, kb, -1)
    out = m["icb_re"] @ ua_re - m["icb_im"] @ ua_im  # [ha, wb, Q]
    return out.view(ha * wb, -1)


def lmm_conv_rank_rows_t(g: torch.Tensor, otf_re: torch.Tensor, otf_im: torch.Tensor, m: dict) -> torch.Tensor:
    """Exact transpose of :func:`lmm_conv_rank_rows`: [ha·wb, Q] → [M, Na, Nb]."""
    ha, wb = m["ifa_re"].shape[0], m["icb_re"].shape[0]
    ka, kb, r_ = otf_re.shape
    g = g.view(ha, wb, -1)
    ua_re = (m["icb_re"].T @ g).reshape(ha, -1)  # [ha, Kb'·Q]
    ua_im = -(m["icb_im"].T @ g).reshape(ha, -1)
    k1 = m["ifa_re"].T @ (ua_re + ua_im)  # [Ka', Kb'·Q]
    t_re = (k1 + m["ifa_d"].T @ ua_im).view(ka, kb, -1, r_)  # [Ka', Kb', M, R]
    t_im = (k1 - m["ifa_s"].T @ ua_re).view(ka, kb, -1, r_)
    o_re = otf_re.unsqueeze(-2)
    o_im = otf_im.unsqueeze(-2)
    zm_re = (t_re * o_re + t_im * o_im).sum(-1).permute(2, 0, 1)  # [M, Ka', Kb']
    zm_im = (t_im * o_re - t_re * o_im).sum(-1).permute(2, 0, 1)
    k1 = m["fa_re"].T @ (zm_re + zm_im)  # [M, Na, Kb']
    yb_re = k1 + m["fa_d"].T @ zm_im
    yb_im = k1 - m["fa_s"].T @ zm_re
    return yb_re @ m["fb_re"] + yb_im @ m["fb_im"]


# ---------------------------------------------------------------------------
# device side: the materialized-OTF FFT conv (the W-plane path)


def dft(x: torch.Tensor) -> torch.Tensor:
    """Unitary real DFT over the last two axes (reference `fft.dft`)."""
    return torch.fft.rfftn(x, dim=(-2, -1), norm="ortho")


def idft(x: torch.Tensor, im_shape: Tuple[int, int]) -> torch.Tensor:
    """Unitary inverse real DFT over the last two axes (reference `fft.idft`).
    `im_shape` is required: an odd last axis (501) is not recoverable from
    the half spectrum."""
    return torch.fft.irfftn(x, s=tuple(im_shape), dim=(-2, -1), norm="ortho")


CONV_OTF_CHUNK = 256  # λ-planes per cuFFT call of `conv_otf_`


def conv_otf_(cube: torch.Tensor, otf: torch.Tensor, conj: bool = False,
              chunk: int = CONV_OTF_CHUNK) -> torch.Tensor:
    """``idft(dft(cube) · otf)`` (or · conj(otf)) per λ-plane, IN PLACE on
    `cube` [L, Na, Nb], `chunk` planes at a time, so no whole-cube spectrum
    and no whole-cube FFT workspace are ever held; returns `cube`.  The
    callers own `cube` (a temporary of the operator), hence in place."""
    im_shape = tuple(cube.shape[-2:])
    for i in range(0, cube.shape[0], chunk):
        o = otf[i : i + chunk]
        spec = dft(cube[i : i + chunk])
        spec.mul_(o.conj() if conj else o)
        cube[i : i + chunk] = idft(spec, im_shape)
    return cube


def ir2fr_device(imp_resp, shape: Tuple[int, int], device=None,
                 dtype=torch.complex64, chunk: int = 128) -> torch.Tensor:
    """:func:`ir2fr` of a stamp stack [L, sx, sy] on `device` (None: the
    card, or raise; pass "cpu" for the host): pad to `shape`, roll the
    center to (0, 0), non-normalized rfft2 — computed in float64, `chunk`
    planes at a time, then cast to `dtype` (so it matches the host `ir2fr`
    to rounding)."""
    if device is None:
        device = require_cuda()
    imp = torch.as_tensor(np.asarray(imp_resp))
    n, sx, sy = imp.shape
    na, nb = int(shape[0]), int(shape[1])
    out = torch.empty((n, na, nb // 2 + 1), dtype=dtype, device=device)
    for i in range(0, n, chunk):
        stamps = imp[i : i + chunk].to(device=device, dtype=torch.float64)
        padded = torch.zeros((stamps.shape[0], na, nb), dtype=torch.float64, device=device)
        padded[:, :sx, :sy] = stamps
        padded = torch.roll(padded, shifts=(-(sx // 2), -(sy // 2)), dims=(1, 2))
        out[i : i + chunk] = torch.fft.rfftn(padded, dim=(1, 2)).to(dtype)
    return out


def otf_bins_last(otf: torch.Tensor) -> torch.Tensor:
    """[R, Ka', Kb'] (reference layout) → contiguous [Ka', Kb', R]."""
    return otf.permute(1, 2, 0).contiguous()


def lmm_conv_rank(maps, otf_re, otf_im, m: dict) -> torch.Tensor:
    """Reference-layout `fft.lmm_conv_rank`: maps [M, Na, Nb], otf [R, Ka', Kb']
    → rank-basis bbox patch [M·R, ha, wb]."""
    rows = lmm_conv_rank_rows(maps, otf_bins_last(otf_re), otf_bins_last(otf_im), m)
    ha, wb = m["ifa_re"].shape[0], m["icb_re"].shape[0]
    return rows.view(ha, wb, -1).permute(2, 0, 1)


def lmm_conv_rank_t(g, otf_re, otf_im, m: dict, n_maps: int) -> torch.Tensor:
    """Reference-layout `fft.lmm_conv_rank_t`: g [M·R, ha, wb] → [M, Na, Nb]."""
    q, ha, wb = g.shape
    if q != n_maps * otf_re.shape[0]:
        raise ValueError(f"Q={q} is not n_maps·R = {n_maps}·{otf_re.shape[0]}")
    rows = g.permute(1, 2, 0).reshape(ha * wb, q)
    return lmm_conv_rank_rows_t(rows, otf_bins_last(otf_re), otf_bins_last(otf_im), m)
