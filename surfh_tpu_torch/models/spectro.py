"""The flagship fusion operator y = Σ R L S C T x, λ-rank mode.

Counterpart of `surfh_tpu/models/spectro.py::SpectroSigRLSCT` in its
window-local, PSF-stamp, λ-rank configuration (the flagship main path),
with `SURFH_HOST_MATERIALIZE=1` table semantics: per channel the host
builds the DFT matrices on the OTF support and FOV bbox (`dftm`), the OTF of
the R rank-basis stamps (`sotf_ri`), the rank coefficients (`cu`), the
λ-mix-folded spectral blur (`wpsf_q`), the slit weights and the forward /
transpose gather plans.  Channels are independent, so `workers > 1` builds
them in parallel processes.

Device side: per channel, `fft.lmm_conv_rank_rows` (template maps → Q = M·R
basis planes on the FOV bbox, as ``[ha·wb, Q]`` rows), then the channel's
per-pointing composed gather / slit weights / wblur GEMM; the adjoint
mirrors it, and `normal` fuses fwd∘adj per channel without materializing
the flat data vector.

Not ported yet (raise NotImplementedError): the dense W-plane path
(`lmm_conv_otf_matmul`), taken by the reference when the rank gate
declines (M·R ≥ W/2) or the rank conv is off, and the materialized-sotf
FFT paths.
"""

from __future__ import annotations

import multiprocessing
import os
from concurrent.futures import ProcessPoolExecutor
from typing import Callable, List, Optional

import numpy as np
import torch

from surfh_tpu.instrument.geometry import CoordList, get_srf
from surfh_tpu.instrument.ifu import IFU

from ..core import fft
from ..core.gather_rows import gather_rows
from ..core.wblur import rows_table
from .channel import Channel


def rank_tables(chan: Channel, t: dict, psf_w: np.ndarray, tpl_w: np.ndarray,
                imshape, conv_freq_rtol: float, conv_rank_rtol: float):
    """Add the rank-mode tables of one channel to its host tables `t`
    (reference `_build_host_tables`, spectro.py:378-484); returns the
    channel's support record.  Consumes (deletes) t["wpsf"]."""
    npdtype = chan.npdtype
    na_g = imshape[0]
    ka_max, kb_keep, dropped = None, None, 0.0
    if conv_freq_rtol > 0.0:
        ka_max, kb_keep, dropped = fft.otf_support_from_psf(psf_w, imshape, conv_freq_rtol)
    t["dftm"] = fft.dft_matmul_tables(imshape, npdtype, ka_max=ka_max, kb_keep=kb_keep,
                                      bbox=chan.tbbox)
    sel_a = fft.freq_sel_alpha(na_g, ka_max)
    support = dict(
        ka_max=ka_max, kb_keep=kb_keep, dropped_rel=dropped, bbox=chan.tbbox,
        keep_frac=(1.0 if conv_freq_rtol <= 0.0
                   else len(sel_a) * kb_keep / (na_g * (imshape[1] // 2 + 1))),
    )
    if conv_rank_rtol <= 0.0:
        raise NotImplementedError(
            f"channel {chan.instr.name}: conv_rank_rtol=0 selects the dense W-plane "
            "path (lmm_conv_otf_matmul), which is not ported yet"
        )
    cu, v_psf, tail = fft.lowrank_stamp_factor(psf_w, conv_rank_rtol)
    n_tpl = tpl_w.shape[0]
    if not n_tpl * cu.shape[1] < psf_w.shape[0] // 2:
        raise NotImplementedError(
            f"channel {chan.instr.name}: rank gate declined (M·R = {n_tpl * cu.shape[1]} "
            f"≥ W/2 = {psf_w.shape[0] // 2}); the dense W-plane path "
            "(lmm_conv_otf_matmul) is not ported yet"
        )
    t["cu"] = cu
    support["rank"] = int(cu.shape[1])
    support["rank_tail"] = tail
    st = fft.psf_stamp_tables(imshape, v_psf.shape[-2:], np.float64,
                              ka_max=ka_max, kb_keep=kb_keep)
    sa = st["sa_re"] + 1j * st["sa_im"]
    sb = st["sb_re"] + 1j * st["sb_im"]
    z = np.einsum("wxy,cx->wcy", v_psf.astype(np.float64), sa)
    otf = np.einsum("wcy,yk->wck", z, sb)
    t["sotf_ri"] = np.ascontiguousarray(np.stack([otf.real, otf.imag]), npdtype)
    tpl_w64 = tpl_w.astype(np.float64)
    cmat = np.einsum("mw,wr->wmr", tpl_w64, cu.astype(np.float64)).reshape(tpl_w64.shape[1], -1)
    t["wpsf_q"] = np.ascontiguousarray(
        np.einsum("kwb,wq->kqb", t.pop("wpsf").astype(np.float64), cmat), npdtype)
    return support


def _build_channel(job):
    """One channel's geometry and host tables (a process-pool work item)."""
    (instr, alpha_axis, beta_axis, wavel_axis, srf, pointings, step_degree,
     npdtype, psf_w, tpl_w, imshape, conv_freq_rtol, conv_rank_rtol) = job
    chan = Channel(instr, alpha_axis, beta_axis, wavel_axis, srf, pointings,
                   step_degree, dtype=npdtype)
    t = chan.host_tables()
    support = rank_tables(chan, t, psf_w, tpl_w, imshape, conv_freq_rtol, conv_rank_rtol)
    return chan, t, support


def _map_channels(jobs, workers: int):
    if workers <= 1 or len(jobs) <= 1:
        return [_build_channel(j) for j in jobs]
    # one BLAS thread per worker process; largest λ windows first
    keys = ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS")
    saved = {k: os.environ.get(k) for k in keys}
    os.environ.update({k: "1" for k in keys})
    try:
        ctx = multiprocessing.get_context("spawn")
        with ProcessPoolExecutor(min(workers, len(jobs)), mp_context=ctx) as ex:
            order = sorted(range(len(jobs)), key=lambda i: -jobs[i][8].shape[0])
            futs = {i: ex.submit(_build_channel, jobs[i]) for i in order}
            return [futs[i].result() for i in range(len(jobs))]
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def device_tables(host: dict, device, dtype=torch.float32) -> dict:
    """Host tables → tensors on `device`, in the kernel-friendly layouts:
    OTF bins-last [Ka', Kb', R], wblur table [K, sb·Q], slit weights
    [S·A, sb, 1] and the gather plans as device CSR tensors."""
    def f(a):
        return torch.as_tensor(np.asarray(a)).to(device=device, dtype=dtype).contiguous()

    chans = []
    for t in host["chan"]:
        sotf = f(t["sotf_ri"])
        sw = f(t["slit_w"])
        chans.append({
            "dftm": {k: f(v) for k, v in t["dftm"].items()},
            "otf_re": fft.otf_bins_last(sotf[0]),
            "otf_im": fft.otf_bins_last(sotf[1]),
            "wq": rows_table(f(t["wpsf_q"])),
            "slit_w": sw.reshape(-1, sw.shape[-1], 1),
            "gather_fwd": [p.to(device, dtype) for p in t["gather_fwd"]],
            "gather_t": [p.to(device, dtype) for p in t["gather_t"]],
        })
    return {"chan": chans}


class SpectroSigRLSCT:
    """Multi-channel multi-observation spectro-imaging forward model
    (rank mode).  Inputs are template maps x [M, Na, Nb]; the output is the
    flat concatenation of per-channel blocks [P, S, λ_det, α_det].

    `dtype` is the NumPy dtype of the host tables; :meth:`to` moves them to
    a torch device and dtype.  `workers` > 1 builds channels in parallel
    spawned processes, which re-import the calling script: call it from
    under ``if __name__ == "__main__":``.
    """

    def __init__(
        self,
        templates,
        alpha_axis,
        beta_axis,
        wavelength_axis,
        instrs: List[IFU],
        step_degree: float,
        pointings,
        psf_stack,
        dtype=np.float32,
        conv_freq_rtol: float = 0.0,
        conv_rank_rtol: float = 1e-7,
        workers: int = 1,
    ):
        self.templates = np.asarray(templates)
        self.alpha_axis = np.asarray(alpha_axis, np.float64)
        self.beta_axis = np.asarray(beta_axis, np.float64)
        self.wavelength_axis = np.asarray(wavelength_axis, np.float64)
        self.step_degree = float(step_degree)
        self.psf_stack = np.asarray(psf_stack)
        self.npdtype = np.dtype(dtype)
        self.conv_freq_rtol = float(conv_freq_rtol)
        self.conv_rank_rtol = float(conv_rank_rtol)
        self.srfs = get_srf([chan.det_pix_size for chan in instrs], self.step_degree * 3600)
        if isinstance(pointings, CoordList) or (
            len(pointings) and not isinstance(pointings[0], (list, CoordList))
        ):
            pointings = [CoordList(pointings) for _ in instrs]
        self.pointings = pointings
        self.imshape = (len(self.alpha_axis), len(self.beta_axis))
        self.cube_shape = (len(self.wavelength_axis),) + self.imshape
        self.ishape = (self.templates.shape[0],) + self.imshape

        jobs = []
        for it, (srf, instr) in enumerate(zip(self.srfs, instrs)):
            wsl = instr.pix(self.step_degree).wslice(self.wavelength_axis, 0.1)
            jobs.append((
                instr, self.alpha_axis, self.beta_axis, self.wavelength_axis, srf,
                CoordList(pointings[it]), self.step_degree, self.npdtype,
                np.asarray(self.psf_stack[wsl.start : wsl.stop], self.npdtype),
                self.templates[:, wsl], self.imshape,
                self.conv_freq_rtol, self.conv_rank_rtol,
            ))
        built = _map_channels(jobs, int(workers))
        self.channels = [b[0] for b in built]
        self._host = {"chan": tuple(b[1] for b in built)}
        self.conv_supports = [b[2] for b in built]
        self.instrs_oshape = [chan.oshape for chan in self.channels]
        self._idx = np.cumsum([0] + [int(np.prod(o)) for o in self.instrs_oshape])
        self.oshape = (int(self._idx[-1]),)
        self.tables = None
        self.device = None
        self.dtype = None

    def host_tables(self) -> dict:
        """All model tables as one host (NumPy) tree; do not mutate."""
        return self._host

    def to(self, device, dtype=torch.float32, tables: Optional[dict] = None):
        """Move the tables (or adopt the given device `tables`, e.g. from
        `convert.tables_from_reference`) to `device` / `dtype`."""
        self.device = torch.device(device)
        self.dtype = dtype
        self.tables = device_tables(self._host, self.device, dtype) if tables is None else tables
        return self

    # ------------------------------------------------------------------
    def _x(self, x) -> torch.Tensor:
        if self.tables is None:
            raise RuntimeError("call .to(device, dtype) before applying the model")
        return torch.as_tensor(x).to(device=self.device, dtype=self.dtype).reshape(self.ishape)

    def _conv(self, x, c):
        t = self.tables["chan"][c]
        return fft.lmm_conv_rank_rows(x, t["otf_re"], t["otf_im"], t["dftm"])

    def _conv_t(self, rows, c):
        t = self.tables["chan"][c]
        return fft.lmm_conv_rank_rows_t(rows, t["otf_re"], t["otf_im"], t["dftm"])

    def forward(self, x, gather: Callable = gather_rows) -> torch.Tensor:
        """Template maps [M, Na, Nb] → flat data vector."""
        x = self._x(x)
        outs = []
        for c, chan in enumerate(self.channels):
            rows = self._conv(x, c)
            outs.append(chan.forward_rank(rows, self.tables["chan"][c], gather).reshape(-1))
        return torch.cat(outs)

    def adjoint(self, y, gather: Callable = gather_rows) -> torch.Tensor:
        """Exact transpose of :meth:`forward`: flat data → [M, Na, Nb]."""
        if self.tables is None:
            raise RuntimeError("call .to(device, dtype) before applying the model")
        y = torch.as_tensor(y).to(device=self.device, dtype=self.dtype).reshape(-1)
        acc = torch.zeros(self.ishape, device=self.device, dtype=self.dtype)
        for c, chan in enumerate(self.channels):
            yc = y[int(self._idx[c]) : int(self._idx[c + 1])].view(chan.oshape)
            rows = chan.adjoint_rank(yc, self.tables["chan"][c], gather)
            acc.add_(self._conv_t(rows, c))
        return acc

    def normal(self, x, gather: Callable = gather_rows) -> torch.Tensor:
        """Fused HᵗH x: per channel fwd∘adj, the flat y never materialized."""
        x = self._x(x)
        acc = torch.zeros_like(x)
        for c, chan in enumerate(self.channels):
            t = self.tables["chan"][c]
            yc = chan.forward_rank(self._conv(x, c), t, gather)
            acc.add_(self._conv_t(chan.adjoint_rank(yc, t, gather), c))
        return acc
