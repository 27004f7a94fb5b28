"""The plain reference of the fusion operator y = Σ_c R_c L_c S_c C T x,
its transpose, and the regularised CG solve, in plain PyTorch.

Per band c and pointing p: the templates mix the maps into the band's λ
window (T; where the configuration's unknown is the cube, T is the
identity and the band reads its λ window of the cube), each plane is
circularly convolved with its PSF stamp over the whole sky grid (C, the
OTF taken from the stamp as an FFT of the stamp centred at the origin;
where a window-local configuration truncates the conv, the band's stamps
are first cut to their λ rank at ``conv_rank_rtol`` and the OTF to its
frequency support at ``conv_freq_rtol``, as the configuration states),
the convolved planes are interpolated bilinearly
at the rotated local-grid samples of the slit windows (L), each window
sums `srf` oversampled α rows and weights its β columns (S), and the
spectral response contracts (λ, β) into detector λ' (R, dense, or masked
to the banded truncation of the configuration: the forward's mask in the
forward, the transpose's in the transpose).  The transpose is written out
by hand; `tests/test_perfbench_reference.py` holds it to a dot test.

Nothing of the program is used: every table is worked out again here from
the inputs of `instrument.problem_inputs`.  `tf32=True` is the control:
the same arithmetic with every contraction's operands rounded to TF32
(10 mantissa bits), as a float32 matmul with TF32 on rounds them.
"""

from __future__ import annotations

import numpy as np
import torch

from . import instrument

PLANES = 128  # λ planes per block


def round_tf32(t: torch.Tensor) -> torch.Tensor:
    """`t` (float32) rounded to the nearest TF32 value, ties away from zero."""
    if t.is_complex():
        return torch.complex(round_tf32(t.real.contiguous()), round_tf32(t.imag.contiguous()))
    i = t.float().contiguous().view(torch.int32)
    i = (i + 0x1000) & ~0x1FFF
    return i.view(torch.float32)


class Reference:
    """The reference operator of one configuration on `device` in `dtype`.

    `config` is the configuration file's object; its `model` block decides
    the blur: ``wblur_impl`` "banded" masks the response at
    ``wblur_band_rtol``; its ``window_local``, ``conv_rank_rtol`` and
    ``conv_freq_rtol`` the conv's truncation (:meth:`_band_otf`)."""

    def __init__(self, config: dict, device, dtype=torch.float64, tf32: bool = False):
        self.device = torch.device(device)
        self.dtype = dtype
        self.cdtype = torch.complex128 if dtype == torch.float64 else torch.complex64
        self.tf32 = bool(tf32)
        if self.tf32 and dtype != torch.float32:
            raise ValueError("the TF32 control computes in float32")
        inp = instrument.problem_inputs(config["problem"])
        self.inputs = inp
        self.n = len(inp["alpha"])
        self.x_shape = inp["x_shape"]
        if inp["unknown"] == "cube" and config["model"].get("window_local"):
            raise ValueError("the reference's cube unknown is of the W-plane model only")
        self.tpl = self._t(inp["templates"]) if inp["unknown"] == "maps" else None  # None: T = I
        banded = config["model"].get("wblur_impl", "dense") == "banded"
        rtol = float(config["model"].get("wblur_band_rtol", 0.0))
        beta_step = inp["beta"][1] - inp["beta"][0]
        self.bands = []
        for name in inp["bands"]:
            g = instrument.band_geometry(name, inp)
            wpsf = g.wpsf(inp["wavel"], beta_step)
            fwd = adj = wpsf
            if banded:
                mf, ma = instrument.banded_masks(wpsf, rtol)
                fwd, adj = wpsf * mf[:, :, None], wpsf * ma[:, :, None]
            idx, w = [], []
            for p in inp["pointings"]:
                pts = g.window_points(p).reshape(-1, 2)
                i, wt = instrument.bilinear(inp["alpha"], inp["beta"], pts)
                idx.append(i)
                w.append(wt)
            self.bands.append(dict(
                geom=g, w0=g.wslice.start, w1=g.wslice.stop,
                otf=self._band_otf(inp["stamps"][g.wslice], config["model"]),
                idx=torch.as_tensor(np.stack(idx), device=self.device),  # [P, 4, n]
                wts=self._t(np.stack(w)),  # [P, 4, n]
                slit_w=self._t(g.slit_w),  # [S, sb]
                wpsf=self._t(fwd), wpsf_t=self._t(adj),  # [K, W, sb]
            ))

    def _t(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, np.float64)).to(self.device, self.dtype)

    def _otf(self, stamps: np.ndarray) -> torch.Tensor:
        """[L, N, N//2+1]: the non-normalised rfft2 of each stamp laid on
        the grid with its centre (size // 2) at the origin."""
        n = self.n
        sx, sy = stamps.shape[1:]
        out = torch.empty((stamps.shape[0], n, n // 2 + 1), dtype=self.cdtype, device=self.device)
        for i in range(0, stamps.shape[0], PLANES):
            s = torch.as_tensor(stamps[i : i + PLANES], device=self.device).to(torch.float64)
            pad = torch.zeros((s.shape[0], n, n), dtype=torch.float64, device=self.device)
            pad[:, :sx, :sy] = s
            pad = torch.roll(pad, (-(sx // 2), -(sy // 2)), (1, 2))
            out[i : i + PLANES] = torch.fft.rfft2(pad).to(self.cdtype)
        return out

    def _band_otf(self, stamps: np.ndarray, model: dict) -> torch.Tensor:
        """A band's OTF [W, N, N//2+1].  Window-local: with ``conv_rank_rtol``
        > 0 the stamps [W, s, s] are replaced by their rank-R approximation
        (singular values above rtol·σ₁) where M·R < W // 2; with
        ``conv_freq_rtol`` > 0 the bins are kept where the original stamps'
        OTF reaches rtol of its peak magnitude along either axis (columns
        below the last such β bin, rows within the largest such |α
        frequency|), and the rest set to zero."""
        n = self.n
        st = stamps.astype(np.float64)
        if not model.get("window_local"):
            return self._otf(st)
        rank_rtol = float(model.get("conv_rank_rtol", 0.0))
        freq_rtol = float(model.get("conv_freq_rtol", 0.0))
        approx = st
        if rank_rtol > 0:
            r, us, vt = instrument.stamp_rank(st, rank_rtol)
            if self.x_shape[0] * r < len(st) // 2:
                approx = (us[:, :r] @ vt[:r]).reshape(st.shape)
        otf = self._otf(approx)
        if freq_rtol > 0:
            mag = self._otf(st).abs() if approx is not st else otf.abs()
            col = mag.amax(dim=(0, 1)).double().cpu().numpy()
            row = mag.amax(dim=(0, 2)).double().cpu().numpy()
            thr = freq_rtol * col.max()
            kb_keep = int(np.nonzero(col >= thr)[0][-1]) + 1
            sfreq = np.minimum(np.arange(n), n - np.arange(n))
            ka_max = int(sfreq[row >= thr].max())
            keep = torch.zeros((n, n // 2 + 1), dtype=torch.bool, device=self.device)
            keep[torch.as_tensor(sfreq <= ka_max, device=self.device), :kb_keep] = True
            otf = otf * keep
        return otf

    def _mm(self, *ops):
        return [round_tf32(o) for o in ops] if self.tf32 else list(ops)

    # ------------------------------------------------------------------
    def forward(self, x: torch.Tensor) -> list:
        """Maps [M, N, N] (the cube [L, N, N]) → per band the detector
        blocks [P, S, K, A]."""
        x = x.to(self.device, self.dtype)
        if self.tpl is None:  # each block of λ planes transformed as it is read
            def spectrum(l0, l1):
                return torch.fft.rfft2(x[l0:l1], norm="ortho")
        else:
            xs, tpl = self._mm(x, self.tpl)
            xhat = torch.fft.rfft2(xs, norm="ortho")

            def spectrum(l0, l1):
                return torch.einsum("ml,mab->lab", tpl[:, l0:l1].to(self.cdtype), xhat)
        return [self._forward_band(spectrum, b, b["wpsf"]) for b in self.bands]

    def _forward_band(self, spectrum, b, wpsf) -> torch.Tensor:
        g = b["geom"]
        n = self.n
        P = b["idx"].shape[0]
        S, A, srf, sb = g.n_slit, g.n_a, g.srf, g.n_b
        y = None
        for l0 in range(b["w0"], b["w1"], PLANES):
            l1 = min(l0 + PLANES, b["w1"])
            o = b["otf"][l0 - b["w0"] : l1 - b["w0"]]
            spec = spectrum(l0, l1) * o
            planes = torch.fft.irfft2(spec, s=(n, n), norm="ortho").reshape(l1 - l0, n * n)
            vals = planes[:, b["idx"].reshape(-1)].view(l1 - l0, P, 4, -1)
            loc = (vals * b["wts"]).sum(2).view(l1 - l0, P, S, A, srf, sb)
            win = loc.sum(4) * b["slit_w"][:, None, :]  # [w, P, S, A, sb]
            wp, win = self._mm(wpsf[:, l0 - b["w0"] : l1 - b["w0"]], win)
            part = torch.einsum("kwb,wpsab->pska", wp, win)
            y = part if y is None else y + part
        return y

    def adjoint(self, ys: list, wpsf_key: str = "wpsf_t") -> torch.Tensor:
        """Per band detector blocks → maps [M, N, N] (the cube [L, N, N];
        the transpose of :meth:`forward`, the transpose's mask where the
        blur is banded)."""
        n = self.n
        if self.tpl is None:  # each block's planes added into the cube: the bands' windows overlap
            acc = torch.zeros(self.x_shape, dtype=self.dtype, device=self.device)

            def add(l0, l1, spec):
                acc[l0:l1] += torch.fft.irfft2(spec, s=(n, n), norm="ortho")
        else:
            (tpl,) = self._mm(self.tpl)
            acc = torch.zeros(self.x_shape[:1] + (n, n // 2 + 1), dtype=self.cdtype, device=self.device)

            def add(l0, l1, spec):
                t, spec = self._mm(tpl[:, l0:l1].to(self.cdtype), spec)
                acc.add_(torch.einsum("ml,lab->mab", t, spec))
        for b, y in zip(self.bands, ys):
            self._adjoint_band(add, b, y.to(self.device, self.dtype), b[wpsf_key])
        return acc if self.tpl is None else torch.fft.irfft2(acc, s=(n, n), norm="ortho")

    def _adjoint_band(self, add, b, y, wpsf) -> None:
        g = b["geom"]
        n = self.n
        P = b["idx"].shape[0]
        S, A, srf, sb = g.n_slit, g.n_a, g.srf, g.n_b
        for l0 in range(b["w0"], b["w1"], PLANES):
            l1 = min(l0 + PLANES, b["w1"])
            wp, yy = self._mm(wpsf[:, l0 - b["w0"] : l1 - b["w0"]], y)
            win = torch.einsum("kwb,pska->wpsab", wp, yy) * b["slit_w"][:, None, :]
            loc = win[:, :, :, :, None, :].expand(l1 - l0, P, S, A, srf, sb).reshape(l1 - l0, P, 1, -1)
            vals = (loc * b["wts"]).reshape(l1 - l0, -1)
            planes = torch.zeros((l1 - l0, n * n), dtype=self.dtype, device=self.device)
            planes.index_add_(1, b["idx"].reshape(-1), vals)
            o = b["otf"][l0 - b["w0"] : l1 - b["w0"]]
            add(l0, l1, torch.fft.rfft2(planes.view(l1 - l0, n, n), norm="ortho") * o.conj())

    def normal(self, x: torch.Tensor) -> torch.Tensor:
        return self.adjoint(self.forward(x))


def dtd(x: torch.Tensor) -> torch.Tensor:
    """The circular 2-D Laplacian of each map: (D_rᵀD_r + D_cᵀD_c) x."""
    out = 4 * x
    for shift, dim in ((1, 1), (-1, 1), (1, 2), (-1, 2)):
        out -= torch.roll(x, shift, dim)
    return out


def cg_solve(ref: Reference, y: list, mu_s: float, mu_r: float, x0: float, n_iter: int) -> torch.Tensor:
    """`n_iter` plain CG iterations on (µ_s HᵗH + µ_r DᵀD) x = µ_s Hᵗy from
    the constant `x0`: the iterate after the last.  The vectors are updated
    in place, each operation as written out (x ← x + αp, r ← r − αq,
    p ← r + βp), so that few of the unknown's size are held at once and the
    12-band cube's solve in float64 fits one 80 GB card beside the stored
    OTFs."""
    def q(v):
        out = ref.normal(v)
        out *= mu_s
        d = dtd(v)
        d *= mu_r
        out += d
        return out

    r = ref.adjoint(y)
    r *= mu_s  # b = µ_s Hᵗy
    x = torch.full(ref.x_shape, float(x0), dtype=ref.dtype, device=ref.device)
    r -= q(x)
    p = r.clone()
    rr = torch.sum(r * r)
    for _ in range(n_iter):
        qp = q(p)
        alpha = rr / torch.sum(p * qp)
        x += alpha * p
        r -= alpha * qp
        del qp
        rr_new = torch.sum(r * r)
        p *= rr_new / rr
        p += r
        rr = rr_new
    return x
