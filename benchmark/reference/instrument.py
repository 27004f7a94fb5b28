"""The flagship problem's inputs and the MIRI MRS geometry, worked out in
plain NumPy for the benchmark's reference.

Frozen here so that the yardstick does not move with the program: the band
constants and the wavelength / dither tables are those of the public MIRI
MRS documentation as `surfh_tpu_torch/instrument/miri.py` holds them
(commit 7f91c5f), and the problem set-up follows
`surfh_tpu_torch/simulation/flagship.py` (same commit): 12 bands × 4
dither pointings, an N² sky at 0.025″, the bands' detector λ tables united
and subsampled, M smooth templates and Gaussian 40 × 40 PSF stamps, all from
the set-up seed.  Nothing of the program is imported.

The geometry of a band (its local grid, slit windows, edge weights and the
spectral response) follows the instrument model's definitions: a rotated
field of view sampled on a local grid with 5-pixel margins, slits cut
along β with fractional edge pixels, α summed over `srf` oversampled rows,
and the grating's sinc² line-spread function normalised over λ.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from math import ceil, floor

import numpy as np

BANDS = ["1a", "1b", "1c", "2a", "2b", "2c", "3a", "3b", "3c", "4a", "4b", "4c"]

# (alpha width ″, beta width ″, angle °, detector pixel ″, slits) per MIRI channel
CHANNEL_GEOMETRY = {
    "1": (3.2, 3.7, 8.4, 0.196, 21),
    "2": (4.0, 4.8, 8.1, 0.196, 17),
    "3": (5.5, 6.2, 7.7, 0.245, 16),
    "4": (6.9, 7.9, 8.3, 0.273, 12),
}

# grating resolving power range per band; the model takes the mid-point
RESOLUTIONS = {
    "1a": (3320, 3710), "1b": (3190, 3750), "1c": (3100, 3610),
    "2a": (2990, 3110), "2b": (2750, 3170), "2c": (2860, 3300),
    "3a": (2530, 2880), "3b": (1790, 2640), "3c": (1980, 2790),
    "4a": (1460, 1930), "4b": (1680, 1760), "4c": (1630, 1330),
}

_TABLES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "miri_tables.npz")
_N_MARGIN = 15  # λ samples added on each side to normalise the line-spread function
_BOX_MARGIN = 5  # local-grid margin, in sky pixels


def tables() -> dict:
    with np.load(_TABLES) as d:
        return {k: np.asarray(d[k]) for k in d.files}


def detector_axis(band: str) -> np.ndarray:
    return tables()[f"wavelength_{band}"]


def rot(degree: float) -> np.ndarray:
    t = np.radians(degree)
    return np.array([[np.cos(t), -np.sin(t)], [np.sin(t), np.cos(t)]])


def gaussian_stamps(wavel: np.ndarray, step_arcsec: float, size: int = 40) -> np.ndarray:
    """Gaussian PSF stamps [L, size, size], FWHM λ/D (D = 6.5 m), each summing to 1."""
    x = np.linspace(-30, 30, size).reshape((1, -1))
    y = x.reshape((-1, 1))
    out = np.empty((len(wavel), size, size))
    for i, w in enumerate(wavel):
        sigma = (w * 1e-6 / 6.5) * 206265 / (step_arcsec * 2.354)
        out[i] = np.exp(-(x**2 + y**2) / (2 * sigma**2))
    return out / out.sum(axis=(1, 2), keepdims=True)


def unknown(problem: dict) -> str:
    """The configuration's unknown: "maps" (the default: the M template
    maps, the cube their mix) or "cube" (the cube itself; the templates are
    drawn all the same, as the set-up's seed stream has them)."""
    u = problem.get("unknown", "maps")
    if u not in ("maps", "cube"):
        raise ValueError(f"unknown {u!r}: the unknown is \"maps\" or \"cube\"")
    return u


def wavelength_axis(problem: dict) -> np.ndarray:
    """The global λ axis: the bands' detector tables united and sorted,
    every `lambda_subsample`-th sample."""
    wavel = np.sort(np.concatenate([detector_axis(b) for b in problem["bands"]]))
    return wavel[:: int(problem["lambda_subsample"])].copy()


def x_shape(problem: dict) -> tuple:
    """The unknown's shape: [M, N, N] maps or the [L, N, N] cube."""
    n = int(problem["npix"])
    return (int(problem["n_tpl"]) if unknown(problem) == "maps" else len(wavelength_axis(problem)), n, n)


def problem_inputs(problem: dict) -> dict:
    """The operator's fixed inputs from the configuration's `problem` block:
    the global λ axis, templates [M, L], PSF stamps [L, s, s] (float32), the
    sky axes (degrees), the step, the pointings (degrees, on the grid), and
    the unknown (:func:`unknown`) and its shape (:func:`x_shape`)."""
    bands = list(problem["bands"])
    npix = int(problem["npix"])
    step_arcsec = float(problem["step_arcsec"])
    step = step_arcsec / 3600.0
    rng = np.random.default_rng(int(problem["setup_seed"]))
    wavel = wavelength_axis(problem)
    lam01 = (wavel - wavel[0]) / (wavel[-1] - wavel[0])
    n_tpl = int(problem["n_tpl"])
    templates = np.empty((n_tpl, len(wavel)))
    for m in range(n_tpl):
        t = 0.5 + 0.5 * (m + 1) / n_tpl * lam01
        for _ in range(3):
            c, w, a = rng.uniform(0.05, 0.95), rng.uniform(0.01, 0.1), rng.uniform(0.5, 2.0)
            t = t + a * np.exp(-((lam01 - c) ** 2) / (2 * w**2))
        templates[m] = t
    stamps = gaussian_stamps(wavel, step_arcsec, int(problem["psf_stamp"])).astype(np.float32)
    axis = (np.arange(npix) - npix / 2) * step
    dither = tables()["dither"][: int(problem["n_pointings"])] / 3600.0
    pointings = np.round(dither / step) * step
    return dict(wavel=wavel, templates=templates, stamps=stamps, alpha=axis, beta=axis.copy(),
                step=step, pointings=pointings, bands=bands, unknown=unknown(problem),
                x_shape=x_shape(problem))


def _local_axis(width: float, margin: float, s: float) -> np.ndarray:
    start = -width / 2 - margin
    length = width + 2 * margin
    round_start = int(floor(start / s)) * s
    num = int(ceil((length + (start - round_start)) / s))
    return np.arange(num + 1) * s + round_start


def _cover(lo: float, hi: float, axis: np.ndarray) -> tuple:
    """[first, last + 1) of the axis pixels (± half a step) that touch [lo, hi]."""
    d = axis[1] - axis[0]
    return (int(np.flatnonzero(lo < axis + d / 2)[0]), int(np.flatnonzero(axis - d / 2 < hi)[-1]) + 1)


@dataclass
class Band:
    """One band's geometry on the sky grid and its spectral response."""

    name: str
    srf: int  # oversampled α rows summed into one detector pixel
    wslice: slice  # its λ window of the global axis
    local_alpha: np.ndarray
    local_beta: np.ndarray
    a_starts: np.ndarray  # [S] first local α row of each slit window
    b_starts: np.ndarray  # [S] first local β column
    n_a: int  # detector α pixels A
    n_b: int  # β columns of a slit window, sb
    slit_w: np.ndarray  # [S, sb] β weights (fractional edge pixels)
    angle: float
    wavel_det: np.ndarray  # [K]
    grating_len: float
    det_pix: float

    @property
    def n_slit(self) -> int:
        return len(self.a_starts)

    @property
    def n_w(self) -> int:
        return self.wslice.stop - self.wslice.start

    def window_points(self, pointing) -> np.ndarray:
        """Sky coordinates [S, A, srf, sb, 2] (degrees) of the local-grid
        samples that the slit windows sum: rows a0 + a·srf + j, columns b0 + b."""
        a = (self.a_starts[:, None, None, None] + np.arange(self.n_a)[None, :, None, None] * self.srf
             + np.arange(self.srf)[None, None, :, None])
        b = self.b_starts[:, None, None, None] + np.arange(self.n_b)[None, None, None, :]
        a, b = np.broadcast_arrays(a, b)
        la, lb = self.local_alpha[a], self.local_beta[b]
        xy = np.einsum("ij,j...->...i", rot(self.angle), np.stack([la, lb]))
        return xy + np.asarray(pointing, np.float64)

    def wpsf(self, wavel_global: np.ndarray, beta_step: float) -> np.ndarray:
        """The spectral response [K, W, sb]: detector λ' ← sky λ at each β
        column of a slit, the sinc² line shape normalised over λ (with
        margins of 15 samples that are dropped afterwards)."""
        wl = wavel_global[self.wslice]
        beta = np.arange(self.n_b) * beta_step
        beta = (beta - beta.mean()).reshape(1, 1, -1)
        scale = (self.wavel_det[1] - self.wavel_det[0]) / self.det_pix
        dw = float(np.min(np.diff(wl)))
        m = _N_MARGIN
        w_norm = np.concatenate([np.linspace(wl.min() - m * dw, wl.min() - dw, m - 1), wl,
                                 np.linspace(wl.max() + dw, wl.max() + m * dw, m - 1)]).reshape(1, -1, 1)
        g = self.grating_len
        out = self.wavel_det.reshape(-1, 1, 1)
        psf = np.pi / w_norm * g * np.sinc(np.pi * g * ((out - scale * beta) / w_norm - 1)) ** 2
        psf /= psf.sum(axis=1, keepdims=True)
        return psf[:, m - 1 : -m + 1, :]


def band_geometry(band: str, inputs: dict) -> Band:
    aw, bw, angle, det_pix, n_slit = CHANNEL_GEOMETRY[band[0]]
    aw, bw = aw / 3600.0, bw / 3600.0
    step = inputs["step"]
    srf = int(det_pix // (step * 3600.0))
    wdet = detector_axis(band)
    gl = inputs["wavel"]
    lo = np.flatnonzero(gl <= max(wdet[0] - 0.1, gl.min()))[-1]
    hi = np.flatnonzero(gl >= min(wdet[-1] + 0.1, gl.max()))[0]
    la = _local_axis(aw, _BOX_MARGIN * step, step)
    lb = _local_axis(bw, _BOX_MARGIN * step, step)
    beta_step = inputs["beta"][1] - inputs["beta"][0]
    sbw = bw / n_slit
    nb_slit = int(ceil(sbw / beta_step))
    la_step = la[1] - la[0]
    na_slit = int(ceil(aw / 2 / la_step)) - int(floor(-aw / 2 / la_step))
    n_a = int(ceil(na_slit / srf))

    def edges(s):
        c = -bw / 2 + sbw / 2 + s * sbw
        return round(c - sbw / 2, 9), round(c + sbw / 2, 9)

    def window(s):
        b0, b1 = edges(s)
        ra = _cover(-aw / 2, aw / 2, la)
        rb = _cover(b0, b1, lb)
        if rb[1] - rb[0] > nb_slit:  # one column too many: drop the one farther from its edge
            if abs(lb[rb[1]] - b1) > abs(lb[rb[0]] - b0):
                rb = (rb[0], rb[1] - 1)
            else:
                rb = (rb[0] + 1, rb[1])
        if n_a % 2 == 0 and n_a < 28:
            if ra[1] - ra[0] > na_slit:
                ra = (ra[0], ra[1] - 1)
            elif ra[1] - ra[0] < na_slit:
                ra = (ra[0] - 2, ra[1])
        return ra, rb

    wins = [window(s) for s in range(n_slit)]
    n_b = wins[0][1][1] - wins[0][1][0]
    if n_b != nb_slit:
        raise ValueError(f"band {band}: slit windows of {n_b} β columns, the response has {nb_slit}")
    a_starts, b_starts, weights = [], [], []
    for s, (ra, rb) in enumerate(wins):
        if (ra[1] - ra[0], rb[1] - rb[0]) != (wins[0][0][1] - wins[0][0][0], n_b):
            raise ValueError(f"band {band}: slit {s} window differs from slit 0's")
        b0, b1 = edges(s)
        cols = lb[rb[0] : rb[1]]
        d = lb[1] - lb[0]
        w = np.ones(n_b)
        if cols[0] - d / 2 < b0:
            w[0] = 1 - abs(cols[0] - d / 2 - b0) / d
        if cols[-1] + d / 2 > b1:
            w[-1] = 1 - abs(cols[-1] + d / 2 - b1) / d
        # an edge pixel not shared with the neighbouring slit keeps its whole weight
        if s > 0 and wins[s - 1][1][1] - 1 != rb[0]:
            w[0] = 1
        if s < n_slit - 1 and rb[1] - 1 != wins[s + 1][1][0]:
            w[-1] = 1
        a_starts.append(ra[0])
        b_starts.append(rb[0])
        weights.append(w)
    a_starts = np.asarray(a_starts)
    if a_starts.min() < 0 or a_starts.max() + n_a * srf > len(la):
        raise ValueError(f"band {band}: a slit's α rows leave the local grid")
    return Band(name=band, srf=srf, wslice=slice(int(lo), int(hi)), local_alpha=la, local_beta=lb,
                a_starts=a_starts, b_starts=np.asarray(b_starts), n_a=n_a, n_b=n_b,
                slit_w=np.asarray(weights), angle=angle, wavel_det=wdet,
                grating_len=2 * 0.44245 / np.pi * float(np.mean(RESOLUTIONS[band])),
                det_pix=det_pix)


def bilinear(alpha: np.ndarray, beta: np.ndarray, pts: np.ndarray):
    """Corner indices into the flattened [Na·Nb] sky grid and weights, both
    [4, n], of bilinear interpolation at `pts` [n, 2]; outside the grid the
    nearest cell extrapolates linearly."""
    def interval(axis, v):
        i = np.clip(np.searchsorted(axis, v, side="right") - 1, 0, len(axis) - 2)
        return i, (v - axis[i]) / (axis[i + 1] - axis[i])

    ia, ta = interval(alpha, pts[:, 0])
    ib, tb = interval(beta, pts[:, 1])
    nb = len(beta)
    base = ia * nb + ib
    idx = np.stack([base, base + 1, base + nb, base + nb + 1])
    w = np.stack([(1 - ta) * (1 - tb), (1 - ta) * tb, ta * (1 - tb), ta * tb])
    return idx.astype(np.int64), w


def stamp_rank(stamps: np.ndarray, rtol: float):
    """(R, U·S, Vᵗ) of a window's stamps [W, s, s] by SVD in float64: R the
    singular values above rtol·σ₁ (at least 1)."""
    u, s, vt = np.linalg.svd(stamps.reshape(len(stamps), -1).astype(np.float64), full_matrices=False)
    r = 1 if s[0] <= 0 else max(1, int(np.sum(s / s[0] > rtol)))
    return r, u * s, vt


def band_support(wpsf: np.ndarray, rel_eps: float) -> np.ndarray:
    """bool [K, W]: where the response exceeds rel_eps of its peak (any β)."""
    return np.abs(wpsf).max(axis=2) > rel_eps * float(np.abs(wpsf).max())


def banded_masks(wpsf: np.ndarray, rel_eps: float):
    """The entries [K, W] that the banded blur keeps at `rel_eps`, forward
    and transpose, as the configuration's banded truncation defines them:
    the forward keeps, per tile of 128 detector rows, one run of LB sky
    samples (LB the widest support of any tile, rounded up to 8); the
    transpose keeps, per tile of 128 // sb' sky samples (sb' = sb rounded up
    to 8), one run of KB detector rows (rounded up to 128)."""
    K, W, B = wpsf.shape
    sup = band_support(wpsf, rel_eps)
    nt = -(-K // 128)
    starts, lb = [], 1
    for t in range(nt):
        rows = sup[t * 128 : (t + 1) * 128]
        cols = np.flatnonzero(rows.any(axis=0))
        s, e = (int(cols[0]), int(cols[-1]) + 1) if cols.size else (0, 0)
        starts.append(min(s, max(W - 1, 0)))
        lb = max(lb, e - s)
    lb = min(W, -(-lb // 8) * 8)
    starts = np.minimum(np.asarray(starts), max(W - lb, 0))
    s_k = starts[np.arange(K) // 128][:, None]
    fwd = (np.arange(W)[None, :] >= s_k) & (np.arange(W)[None, :] < s_k + lb)

    tl = max(1, 128 // (-(-B // 8) * 8))
    nt = -(-W // tl)
    starts, kb = [], 8
    for t in range(nt):
        cols = sup[:, t * tl : min((t + 1) * tl, W)]
        rows = np.flatnonzero(cols.any(axis=1))
        s, e = (int(rows[0]), int(rows[-1]) + 1) if rows.size else (0, 0)
        starts.append(min(s, max(K - 1, 0)))
        kb = max(kb, e - s)
    kb = -(-kb // 128) * 128
    starts = np.maximum(np.minimum(np.asarray(starts), max(K - kb, 0)), 0)
    s_l = starts[np.arange(W) // tl][None, :]
    adj = (np.arange(K)[:, None] >= s_l) & (np.arange(K)[:, None] < s_l + kb)
    return fwd, adj
