"""DFT-as-matmul tables (host, NumPy), the rank-basis conv pair and the
materialized-OTF FFT conv (torch).

Counterpart of `surfh_tpu/core/fft.py`.  The host table functions are NumPy
copies of the reference's (same arithmetic, so both packages build
bit-identical tables); the device side is the λ-rank fused T·C conv
`lmm_conv_rank` and its exact transpose as chains of plain GEMMs, and, for
the W-plane path, the unitary `dft` / `idft` pair (cuFFT on the card, as
the reference leaves it to `jnp.fft`), the chunked OTF conv pair
`conv_otf_chunks` / `_t` (the templates mixed in the frequency domain, or
in cube mode the cube's own planes; on the card in float32 through kernel
#8, `core/fft_conv.py`) and a device `ir2fr` that builds the materialized
OTF from the PSF stamps.

Layout.  The reference keeps the rank-basis patch as ``[Q, ha, wb]``; the
row-gather kernel downstream wants one contiguous ``Q``-wide row per patch
pixel.  So the port's hot path (`lmm_conv_rank_rows` / `_rows_t`) makes the
inverse α-stage ONE GEMM over a ``[Ka', Kb'·Q]`` operand and lets the last
contraction write ``[ha·wb, Q]`` directly: no transpose anywhere on the
path.  `lmm_conv_rank` / `lmm_conv_rank_t` keep the reference layout for
comparisons and are thin permutes around the row forms.

The dense window-local conv (`lmm_conv_otf_rows`, `conv_otf_matmul_rows`
and their transposes) keeps the OTF window in the reference layout
``[W, Ka', Kb']`` (a view of a materialized sotf where nothing is cut) and
runs the inverse α-stage batched over the W planes; its last GEMM reads
each pixel row's ``[Kb', W]`` slab with strides and writes ``[ha·wb, W]``
rows, and the transpose's first GEMM reads them the same way.  Each call of
the pair records the span ``surfh.op.conv.window`` under a profiler.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from ..utils.profiling import span
from . import fft_conv, lmm
from .precision import require_cuda, require_highest

# ---------------------------------------------------------------------------
# host tables (NumPy copies of surfh_tpu/core/fft.py:61-413)


def ir2fr(imp_resp: np.ndarray, shape: Tuple[int, int], center=None, real: bool = True) -> np.ndarray:
    """Transfer function of an impulse response, centered, non-unitary
    (the `udft.ir2fr` semantics: pad to `shape`, roll `center` — by default
    the middle of the response — to (0, 0), non-normalized real FFT over the
    trailing ``len(shape)`` axes, or the complex FFT with ``real=False``)."""
    imp_resp = np.asarray(imp_resp)
    ndim_s = len(shape)
    if center is None:
        center = [length // 2 for length in imp_resp.shape[-ndim_s:]]
    padded = np.zeros(imp_resp.shape[:-ndim_s] + tuple(shape), dtype=imp_resp.dtype)
    padded[tuple(slice(0, s) for s in imp_resp.shape)] = imp_resp
    for ax, shift in enumerate(center):
        padded = np.roll(padded, -shift, imp_resp.ndim - ndim_s + ax)
    axes = list(range(imp_resp.ndim - ndim_s, imp_resp.ndim))
    if real:
        return np.fft.rfftn(padded, axes=axes)
    return np.fft.fftn(padded, axes=axes)


def laplacian(ndim: int) -> np.ndarray:
    """Discrete Laplacian impulse response (sum of 1-D [-1, 2, -1] stencils)."""
    lapl = np.zeros((3,) * ndim)
    for dim in range(ndim):
        idx = tuple([slice(1, 2)] * dim + [slice(None)] + [slice(1, 2)] * (ndim - dim - 1))
        lapl[idx] += np.array([-1.0, 2.0, -1.0]).reshape([-1 if i == dim else 1 for i in range(ndim)])
    return lapl


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
    center=None,
) -> dict:
    """DFT-at-stamp matrices: the OTF of a padded PSF stamp, `center` (by
    default the stamp's middle) rolled to (0, 0), sampled only at the kept
    frequency bins (closed form of ``ir2fr(psf, im_shape, center)``)."""
    na, nb = int(im_shape[0]), int(im_shape[1])
    sx, sy = int(stamp_shape[0]), int(stamp_shape[1])
    kb = nb // 2 + 1
    if kb_keep is None or kb_keep > kb:
        kb_keep = kb
    kb_keep = max(int(kb_keep), 1)
    if center is None:
        center = (sx // 2, sy // 2)
    cx, cy = int(center[0]), int(center[1])
    sel_a = freq_sel_alpha(na, ka_max)
    sa = np.exp(-2j * np.pi * np.outer(sel_a, np.arange(sx) - cx) / na)
    sb = np.exp(-2j * np.pi * np.outer(np.arange(sy) - cy, np.arange(kb_keep)) / nb)
    return {
        "sa_re": sa.real.astype(dtype),
        "sa_im": sa.imag.astype(dtype),
        "sb_re": sb.real.astype(dtype),
        "sb_im": sb.imag.astype(dtype),
    }


def lowrank_stamp_factor(psf, rtol: float, rmax: Optional[int] = None):
    """λ-rank factorization psf ≈ U·V of a stamp stack [W, sx, sy] by SVD.

    Returns ``(U [W, R], V [R, sx, sy], tail)``; singular values are folded
    into U, components with σ_i/σ₁ ≤ `rtol` dropped (R ≥ 1), `rmax` caps R,
    and ``tail = σ_{R+1}/σ₁`` bounds the truncated conv's relative deviation."""
    psf = np.asarray(psf)
    W = psf.shape[0]
    A = psf.reshape(W, -1).astype(np.float64)
    Um, s, Vt = np.linalg.svd(A, full_matrices=False)
    if s[0] <= 0.0:
        R = 1
    else:
        R = max(1, int(np.sum(s / s[0] > rtol)))
    if rmax is not None:
        R = min(R, int(rmax))
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


def otf_support_from_psf(psf_stack, im_shape: Tuple[int, int], rtol: float, center=None,
                         chunk: int = 64):
    """(ka_max, kb_keep, dropped_rel): the frequency support of a PSF stamp
    stack's OTF (stamps centered at `center`, as in :func:`psf_stamp_tables`),
    evaluated chunk by chunk in float64 without materializing the full OTF
    window."""
    psf_stack = np.asarray(psf_stack)
    na, nb = int(im_shape[0]), int(im_shape[1])
    kb = nb // 2 + 1
    st = psf_stamp_tables(im_shape, psf_stack.shape[-2:], np.float64, center=center)
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


def otf_freq_support(otf, rtol: float, chunk: int = 256):
    """(ka_max, kb_keep, dropped_rel) of an OTF stack [..., Na, Kb] (NumPy
    or a tensor, complex or real): bins whose largest magnitude over the
    leading axes is below ``rtol·max|otf|`` are dropped.  Streamed in
    `chunk`-plane pieces, a tensor on its own device (a flagship OTF on the
    card is never copied to the host), a NumPy array as the reference
    streams it."""
    if not isinstance(otf, torch.Tensor):
        otf = np.asarray(otf)
        na, kb = otf.shape[-2], otf.shape[-1]
        flat = otf.reshape(-1, na, kb)
        colmax = np.zeros(kb)
        rowmax = np.zeros(na)
        for i in range(0, flat.shape[0], chunk):
            mag = np.abs(flat[i : i + chunk])
            colmax = np.maximum(colmax, mag.max(axis=(0, 1)))
            rowmax = np.maximum(rowmax, mag.max(axis=(0, 2)))
        return _support_from_axis_maxima(colmax, rowmax, rtol)
    na, kb = otf.shape[-2], otf.shape[-1]
    flat = otf.reshape(-1, na, kb)
    colmax = torch.zeros(kb, dtype=torch.float64, device=otf.device)
    rowmax = torch.zeros(na, dtype=torch.float64, device=otf.device)
    for i in range(0, flat.shape[0], chunk):
        mag = flat[i : i + chunk].abs()
        colmax = torch.maximum(colmax, mag.amax(dim=(0, 1)).double())
        rowmax = torch.maximum(rowmax, mag.amax(dim=(0, 2)).double())
    return _support_from_axis_maxima(colmax.cpu().numpy(), rowmax.cpu().numpy(), rtol)


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
    return _dft_maps_t(zm_re, zm_im, m)


def _dft_maps_t(z_re: torch.Tensor, z_im: torch.Tensor, m: dict) -> torch.Tensor:
    """Exact transpose of :func:`_dft_maps`: (re, im) [..., Ka', Kb'] → [..., Na, Nb]."""
    k1 = m["fa_re"].T @ (z_re + z_im)  # [..., Na, Kb']
    yb_re = k1 + m["fa_d"].T @ z_im
    yb_im = k1 - m["fa_s"].T @ z_re
    return yb_re @ m["fb_re"] + yb_im @ m["fb_im"]


# ---------------------------------------------------------------------------
# device side: the dense window-local conv (the OTF window on W λ-planes)


def otf_from_stamps(psf: torch.Tensor, st: dict, precision: str = "highest", chunk: int = 128):
    """(otf_re, otf_im) [W, Ka', Kb'] of a PSF stamp stack [W, sx, sy] on the
    bins of the stamp-DFT tables `st` (:func:`psf_stamp_tables`), as the
    reference's einsums compute it, `chunk` planes at a time.  Evaluated
    once per model (`models.spectro.device_tables`), so the forward and the
    adjoint read one table and stay an exact pair.  `precision`, as in the
    reference's conv functions below, is "highest" (full FP32) or raises."""
    require_highest(precision)
    w = psf.shape[0]
    ka, kb = st["sa_re"].shape[0], st["sb_re"].shape[1]
    otf_re = torch.empty((w, ka, kb), dtype=psf.dtype, device=psf.device)
    otf_im = torch.empty_like(otf_re)
    for i in range(0, w, chunk):
        p = psf[i : i + chunk]
        z_re = st["sa_re"] @ p  # [c, Ka', sy]: 'wxy,cx->wcy'
        z_im = st["sa_im"] @ p
        otf_re[i : i + chunk] = z_re @ st["sb_re"] - z_im @ st["sb_im"]
        otf_im[i : i + chunk] = z_re @ st["sb_im"] + z_im @ st["sb_re"]
    return otf_re, otf_im


SPAN_CONV_WINDOW = "surfh.op.conv.window"  # around each call of the dense window conv pair


def _idft_rows(t_re: torch.Tensor, t_im: torch.Tensor, m: dict) -> torch.Tensor:
    """Inverse of a [W, Ka', Kb'] spectrum onto the FOV bbox, ROW layout
    [ha·wb, W]: the α-stage in Gauss 3M form batched over the W planes, then
    per pixel row a = one GEMM icb [wb, Kb'] · ua[:, a, :]ᵀ (a strided
    [Kb', W] operand), written straight into the rows."""
    ha, wb = m["ifa_re"].shape[0], m["icb_re"].shape[0]
    k1 = m["ifa_re"] @ (t_re + t_im)  # [W, ha, Kb']
    ua_re = k1 - m["ifa_s"] @ t_im
    ua_im = k1 + m["ifa_d"] @ t_re
    out = m["icb_re"] @ ua_re.permute(1, 2, 0) - m["icb_im"] @ ua_im.permute(1, 2, 0)  # [ha, wb, W]
    return out.view(ha * wb, -1)


def _idft_rows_t(g: torch.Tensor, m: dict):
    """Exact transpose of :func:`_idft_rows`: rows [ha·wb, W] → (re, im)
    [W, Ka', Kb'].  The first GEMM reads the rows with strides and writes
    [ha, W, Kb'], which the α-stage reads as [W, ha, Kb'] (a view)."""
    ha, wb = m["ifa_re"].shape[0], m["icb_re"].shape[0]
    g_t = g.view(ha, wb, -1).transpose(1, 2)  # [ha, W, wb]
    ua_re = (g_t @ m["icb_re"]).transpose(0, 1)  # [W, ha, Kb']
    ua_im = -(g_t @ m["icb_im"]).transpose(0, 1)
    k1 = m["ifa_re"].T @ (ua_re + ua_im)  # [W, Ka', Kb']
    return k1 + m["ifa_d"].T @ ua_im, k1 - m["ifa_s"].T @ ua_re


def lmm_conv_otf_rows(maps, tpl_w, otf_re, otf_im, m: dict) -> torch.Tensor:
    """Fused T·C on a channel window, ROW layout (reference
    `fft.lmm_conv_otf_matmul`): maps [M, Na, Nb], templates tpl_w [M, W],
    OTF window [W, Ka', Kb'] → [ha·wb, W].  The forward DFT runs on the M
    maps; the templates mix the spectra into the W planes."""
    with span(SPAN_CONV_WINDOW):
        zm_re, zm_im = _dft_maps(maps, m)  # [M, Ka', Kb']
        n_map, ka, kb = zm_re.shape
        zw_re = (tpl_w.T @ zm_re.reshape(n_map, -1)).view(-1, ka, kb)  # 'mck,mw->wck'
        zw_im = (tpl_w.T @ zm_im.reshape(n_map, -1)).view(-1, ka, kb)
        t_re = zw_re * otf_re - zw_im * otf_im
        t_im = zw_re * otf_im + zw_im * otf_re
        return _idft_rows(t_re, t_im, m)


def lmm_conv_otf_rows_t(g, tpl_w, otf_re, otf_im, m: dict) -> torch.Tensor:
    """Exact transpose of :func:`lmm_conv_otf_rows` (reference
    `lmm_conv_otf_matmul_t`, term by term): rows [ha·wb, W] → [M, Na, Nb]."""
    with span(SPAN_CONV_WINDOW):
        t_re, t_im = _idft_rows_t(g, m)
        zw_re = t_re * otf_re + t_im * otf_im
        zw_im = -t_re * otf_im + t_im * otf_re
        w, ka, kb = zw_re.shape
        zm_re = (tpl_w @ zw_re.reshape(w, -1)).view(-1, ka, kb)  # 'wck,mw->mck'
        zm_im = (tpl_w @ zw_im.reshape(w, -1)).view(-1, ka, kb)
        return _dft_maps_t(zm_re, zm_im, m)


def conv_otf_matmul_rows(x, otf_re, otf_im, m: dict) -> torch.Tensor:
    """Cube-mode conv of a window x [W, Na, Nb] onto the FOV bbox, ROW
    layout (reference `fft.conv_otf_matmul`): [ha·wb, W]."""
    with span(SPAN_CONV_WINDOW):
        za_re, za_im = _dft_maps(x, m)  # [W, Ka', Kb']
        return _idft_rows(za_re * otf_re - za_im * otf_im, za_re * otf_im + za_im * otf_re, m)


def conv_otf_matmul_rows_t(g, otf_re, otf_im, m: dict) -> torch.Tensor:
    """Exact transpose of :func:`conv_otf_matmul_rows` (reference
    `conv_otf_matmul_t`, term by term): rows [ha·wb, W] → [W, Na, Nb]."""
    with span(SPAN_CONV_WINDOW):
        t_re, t_im = _idft_rows_t(g, m)
        return _dft_maps_t(t_re * otf_re + t_im * otf_im, -t_re * otf_im + t_im * otf_re, m)


# ---------------------------------------------------------------------------
# device side: the materialized-OTF FFT conv (the W-plane path)


def dft(inarray: torch.Tensor) -> torch.Tensor:
    """Unitary real DFT over the last two axes (reference `fft.dft`)."""
    return torch.fft.rfftn(inarray, dim=(-2, -1), norm="ortho")


def idft(inarray: torch.Tensor, im_shape: Tuple[int, int]) -> torch.Tensor:
    """Unitary inverse real DFT over the last two axes (reference `fft.idft`).
    `im_shape` is required: an odd last axis (501) is not recoverable from
    the half spectrum."""
    return torch.fft.irfftn(inarray, s=tuple(im_shape), dim=(-2, -1), norm="ortho")


def dft_mult(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """rfft2(a) · b (reference `fft.dft_mult`)."""
    return dft(a) * b


def idft_mult(a: torch.Tensor, b: torch.Tensor, im_shape: Tuple[int, int]) -> torch.Tensor:
    """irfft2(a · b) (reference `fft.idft_mult`)."""
    return idft(a * b, im_shape)


def convolve_freq(cube: torch.Tensor, otf: torch.Tensor, im_shape: Tuple[int, int]) -> torch.Tensor:
    """Circular convolution of each plane of `cube` with the non-unitary
    transfer function `otf` (from :func:`ir2fr`): with the unitary
    dft / idft pair, the plain circular convolution with the impulse
    response (reference `fft.convolve_freq`, the C operator)."""
    return idft(dft(cube) * otf, im_shape)


CONV_OTF_CHUNK = 256  # λ-planes per transform call of `conv_otf_chunks` / `_t`
SPAN_CONV_MAPS = "surfh.op.conv.maps"  # around each call of `conv_otf_chunks` / `_t` with templates
SPAN_CONV_CUBE = "surfh.op.conv.cube"  # around each call without (cube mode)


def conv_otf_chunks(x: torch.Tensor, otf: torch.Tensor, tpl: Optional[torch.Tensor] = None,
                    chunk: int = CONV_OTF_CHUNK) -> List[torch.Tensor]:
    """C T x: the blurred cube [L, Na, Nb], ``idft(dft(T x) · otf)`` with
    `otf` [L, Na, Nb//2+1], held as its consecutive chunks of `chunk`
    λ-planes (:func:`cube_planes` cuts a λ-range out of them).  `x` is the
    template maps [M, Na, Nb] with `tpl` the templates [M, L], or in cube
    mode (`tpl` None) the cube [L, Na, Nb] itself, read and not written.

    With templates, the DFT is linear and the templates are real, so
    ``rfft2(Σ_m tpl[m, λ]·maps[m]) = Σ_m tpl[m, λ]·rfft2(maps[m])``: the M
    maps are transformed once, each chunk's spectrum is mixed in the
    frequency domain (one real GEMM over the interleaved real and imaginary
    parts), and the unitary pair's two 1/√(Na·Nb) are the GEMM's `alpha`
    around unscaled transforms.  In cube mode each chunk is the unitary
    pair's ``idft(dft(chunk) · otf)``.  Either way the chunks are the
    inverse transforms' own outputs: no plane is copied, and no whole-cube
    spectrum or FFT workspace is held.
    Where autograd tracks `x` the route is the out-of-place T then
    :func:`convolve_freq`, one chunk (a derived transpose).  A float32 `x`
    on the card takes kernel #8 (:func:`_conv_chunks_card`)."""
    na, nb = x.shape[-2:]
    with span(SPAN_CONV_CUBE if tpl is None else SPAN_CONV_MAPS):
        if x.requires_grad and torch.is_grad_enabled():
            return [convolve_freq(x if tpl is None else lmm.lmm_maps2cube(x, tpl), otf, (na, nb))]
        if _on_kernel(x):
            return _conv_chunks_card(x.contiguous(), otf, tpl, chunk)
        if tpl is not None:
            spec_maps = torch.view_as_real(torch.fft.rfft2(x)).reshape(x.shape[0], -1)
        chunks = []
        for i in range(0, otf.shape[0], chunk):
            o = otf[i : i + chunk]
            if tpl is None:
                chunks.append(idft(dft(x[i : i + chunk]).mul_(o), (na, nb)))
            else:
                spec = torch.empty(o.shape + (2,), device=x.device, dtype=x.dtype)
                spec.view(o.shape[0], -1).addmm_(tpl[:, i : i + chunk].T, spec_maps, beta=0,
                                                 alpha=1.0 / (na * nb))
                chunks.append(torch.fft.irfft2(torch.view_as_complex(spec).mul_(o), s=(na, nb),
                                               norm="forward"))
    return chunks


def cube_planes(chunks: List[torch.Tensor], start: int, stop: int) -> List[torch.Tensor]:
    """λ-planes start..stop of a cube held as consecutive chunks
    (:func:`conv_otf_chunks`): views of the chunks they lie in, in order."""
    out, lo = [], 0
    for c in chunks:
        hi = lo + c.shape[0]
        if lo < stop and start < hi:
            out.append(c[max(start - lo, 0) : min(stop, hi) - lo])
        lo = hi
    return out


def conv_otf_chunks_t(cube: torch.Tensor, otf: torch.Tensor, tpl: Optional[torch.Tensor] = None,
                      chunk: int = CONV_OTF_CHUNK) -> torch.Tensor:
    """Tᵗ Cᴴ, the exact transpose of :func:`conv_otf_chunks`: cube
    [L, Na, Nb] → the maps [M, Na, Nb], or in cube mode (`tpl` None) the
    cube.  `cube` is the caller's temporary: cube mode overwrites it with
    the result, chunk by chunk, and returns it (a second output cube would
    add one to the peak); with templates it is read, not written.

    Each chunk of `chunk` λ-planes is transformed and multiplied by
    conj(otf).  With templates, the inverse real DFT is real-linear, so
    ``Σ_λ tpl[m, λ]·irfft2(s_λ) = irfft2(Σ_λ tpl[m, λ]·s_λ)``: the chunk
    is mixed into an [M, Na, Nb//2+1] spectrum (one real GEMM over the
    interleaved real and imaginary parts, accumulating, the unitary scale
    its `alpha`), and only the M maps are transformed back.  In cube mode
    each chunk is the unitary pair's ``idft(dft(chunk) · conj(otf))``.  A
    float32 `cube` on the card takes kernel #8 (:func:`_conv_chunks_t_card`);
    there a strided `cube` is copied first, and the copy is the one
    overwritten and returned."""
    n_lambda, na, nb = cube.shape
    with span(SPAN_CONV_CUBE if tpl is None else SPAN_CONV_MAPS):
        if _on_kernel(cube):
            return _conv_chunks_t_card(cube.contiguous(), otf, tpl, chunk)
        if tpl is None:
            for i in range(0, n_lambda, chunk):
                cube[i : i + chunk] = idft(dft(cube[i : i + chunk]).mul_(otf[i : i + chunk].conj()),
                                           (na, nb))
            return cube
        m = tpl.shape[0]
        acc = torch.empty((m, na, nb // 2 + 1, 2), device=cube.device, dtype=cube.dtype)
        for i in range(0, n_lambda, chunk):
            n = min(chunk, n_lambda - i)
            spec = torch.fft.rfft2(cube[i : i + n]).mul_(otf[i : i + n].conj())
            acc.view(m, -1).addmm_(tpl[:, i : i + n], torch.view_as_real(spec).reshape(n, -1),
                                   beta=0 if i == 0 else 1, alpha=1.0 / (na * nb))
        return torch.fft.irfft2(torch.view_as_complex(acc), s=(na, nb), norm="forward")


def _on_kernel(x: torch.Tensor) -> bool:
    """The pair's route, from the planes' device, dtype and shape alone:
    float32 on the card with each axis within kernel #8's reach.  Strided
    planes are made contiguous by the caller; an OTF the kernels do not take
    (not contiguous complex64) makes them raise."""
    return x.is_cuda and x.dtype == torch.float32 and fft_conv.fits(*x.shape[-2:])


def _conv_chunks_card(x, otf, tpl, chunk: int) -> List[torch.Tensor]:
    """:func:`conv_otf_chunks` through kernel #8: per chunk the rows' half
    spectra into one reused spectrum (cube mode) or the templates' mix of
    the maps' spectra (the GEMM as on the `torch.fft` route), the column
    pass (forward, × otf with the pair's 1/(Na·Nb), inverse; or × otf,
    inverse), and the real rows written into a new chunk."""
    n_lambda, (na, nb) = otf.shape[0], x.shape[-2:]
    spec = torch.empty((min(chunk, n_lambda), na, nb // 2 + 1), dtype=x.dtype.to_complex(),
                       device=x.device)
    if tpl is not None:
        spec_maps = fft_conv.columns_(fft_conv.rows_r2c(x), forward=True, inverse=False)
        spec_maps = torch.view_as_real(spec_maps).reshape(x.shape[0], -1)
    chunks = []
    for i in range(0, n_lambda, chunk):
        o = otf[i : i + chunk]
        s = spec[: o.shape[0]]
        if tpl is None:
            fft_conv.columns_(fft_conv.rows_r2c(x[i : i + chunk], out=s), o, forward=True,
                              inverse=True, scale=1.0 / (na * nb))
        else:
            torch.view_as_real(s).view(o.shape[0], -1).addmm_(tpl[:, i : i + chunk].T, spec_maps,
                                                               beta=0, alpha=1.0 / (na * nb))
            fft_conv.columns_(s, o, forward=False, inverse=True)
        chunks.append(fft_conv.rows_c2r(s, nb))
    return chunks


def _conv_chunks_t_card(cube, otf, tpl, chunk: int) -> torch.Tensor:
    """:func:`conv_otf_chunks_t` through kernel #8: per chunk the rows' half
    spectra, the column pass (forward, × conj(otf) with the pair's
    1/(Na·Nb), inverse) and the real rows written back into the chunk's
    planes of `cube`; with templates the column pass stops at the product,
    the chunk is mixed into the maps' spectrum (the GEMM as on the
    `torch.fft` route), and the maps are transformed back at the end."""
    n_lambda, na, nb = cube.shape
    spec = torch.empty((min(chunk, n_lambda), na, nb // 2 + 1), dtype=cube.dtype.to_complex(),
                       device=cube.device)
    if tpl is not None:
        m = tpl.shape[0]
        acc = torch.empty((m, na, nb // 2 + 1), dtype=cube.dtype.to_complex(), device=cube.device)
    for i in range(0, n_lambda, chunk):
        n = min(chunk, n_lambda - i)
        s = fft_conv.rows_r2c(cube[i : i + n], out=spec[:n])
        if tpl is None:
            fft_conv.columns_(s, otf[i : i + n], forward=True, inverse=True, conj=True,
                              scale=1.0 / (na * nb))
            fft_conv.rows_c2r(s, nb, out=cube[i : i + n])
        else:
            fft_conv.columns_(s, otf[i : i + n], forward=True, inverse=False, conj=True)
            torch.view_as_real(acc).view(m, -1).addmm_(tpl[:, i : i + n], torch.view_as_real(s).view(n, -1),
                                                       beta=0 if i == 0 else 1, alpha=1.0 / (na * nb))
    if tpl is None:
        return cube
    return fft_conv.rows_c2r(fft_conv.columns_(acc, forward=False, inverse=True), nb)


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


def lmm_conv_rank(maps, otf_re, otf_im, m: dict, precision: str = "highest") -> torch.Tensor:
    """Reference-layout `fft.lmm_conv_rank`: maps [M, Na, Nb], otf [R, Ka', Kb']
    → rank-basis bbox patch [M·R, ha, wb].  Here and below `precision` is
    "highest" (full FP32) or raises."""
    require_highest(precision)
    rows = lmm_conv_rank_rows(maps, otf_bins_last(otf_re), otf_bins_last(otf_im), m)
    ha, wb = m["ifa_re"].shape[0], m["icb_re"].shape[0]
    return rows.view(ha, wb, -1).permute(2, 0, 1)


def lmm_conv_rank_t(g, otf_re, otf_im, m: dict, n_maps: int,
                    precision: str = "highest") -> torch.Tensor:
    """Reference-layout `fft.lmm_conv_rank_t`: g [M·R, ha, wb] → [M, Na, Nb]."""
    require_highest(precision)
    q, ha, wb = g.shape
    if q != n_maps * otf_re.shape[0]:
        raise ValueError(f"Q={q} is not n_maps·R = {n_maps}·{otf_re.shape[0]}")
    rows = g.permute(1, 2, 0).reshape(ha * wb, q)
    return lmm_conv_rank_rows_t(rows, otf_bins_last(otf_re), otf_bins_last(otf_im), m)


def _rows_to_planes(rows: torch.Tensor, m: dict) -> torch.Tensor:
    ha, wb = m["ifa_re"].shape[0], m["icb_re"].shape[0]
    return rows.view(ha, wb, -1).permute(2, 0, 1)


def _planes_to_rows(g: torch.Tensor) -> torch.Tensor:
    w, ha, wb = g.shape
    return g.permute(1, 2, 0).reshape(ha * wb, w)


def lmm_conv_otf_matmul(maps, tpl_w, otf_re, otf_im, m: dict,
                        precision: str = "highest") -> torch.Tensor:
    """Reference-layout `fft.lmm_conv_otf_matmul`: → [W, ha, wb]."""
    require_highest(precision)
    return _rows_to_planes(lmm_conv_otf_rows(maps, tpl_w, otf_re, otf_im, m), m)


def lmm_conv_otf_matmul_t(g, tpl_w, otf_re, otf_im, m: dict,
                          precision: str = "highest") -> torch.Tensor:
    """Reference-layout `fft.lmm_conv_otf_matmul_t`: g [W, ha, wb] → [M, Na, Nb]."""
    require_highest(precision)
    return lmm_conv_otf_rows_t(_planes_to_rows(g), tpl_w, otf_re, otf_im, m)


def conv_otf_matmul(x, otf_re, otf_im, m: dict, precision: str = "highest") -> torch.Tensor:
    """Reference-layout `fft.conv_otf_matmul`: x [W, Na, Nb] → [W, ha, wb]."""
    require_highest(precision)
    return _rows_to_planes(conv_otf_matmul_rows(x, otf_re, otf_im, m), m)


def conv_otf_matmul_t(g, otf_re, otf_im, m: dict, precision: str = "highest") -> torch.Tensor:
    """Reference-layout `fft.conv_otf_matmul_t`: g [W, ha, wb] → [W, Na, Nb]."""
    require_highest(precision)
    return conv_otf_matmul_rows_t(_planes_to_rows(g), otf_re, otf_im, m)
