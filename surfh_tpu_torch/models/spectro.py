"""The fusion operator y = Σ R L S C T x: λ-rank and materialized-OTF modes.

Counterpart of `surfh_tpu/models/spectro.py::SpectroSigRLSCT` in two of its
configurations:

* window-local, PSF-stamp, λ-rank (the flagship main path), with
  `SURFH_HOST_MATERIALIZE=1` table semantics: per channel the host builds
  the DFT matrices on the OTF support and FOV bbox (`dftm`), the OTF of the
  R rank-basis stamps (`sotf_ri`), the rank coefficients (`cu`), the
  λ-mix-folded spectral blur (`wpsf_q`), the slit weights and the forward /
  transpose gather plans.  Device side, per channel:
  `fft.lmm_conv_rank_rows` (template maps → Q = M·R basis planes on the
  FOV bbox, as ``[ha·wb, Q]`` rows), then the per-pointing composed gather
  / slit weights / wblur GEMM; the adjoint mirrors it, and `normal` fuses
  fwd∘adj per channel without materializing the flat data vector.
* non-window-local with a materialized OTF `sotf` (reference `_forward_fn`
  / `_adjoint_fn_const`, the path of the CLI and the real-data pipeline):
  T (`lmm`), the full-cube ``idft(dft(cube)·sotf)`` conv, then per channel
  the λ-window's FOV-bbox patch laid out as ``[ha·wb, W]`` rows and the
  same per-pointing chain on W λ-planes, with the spectral blur dense or
  banded (`core.wblur_banded`); the adjoint scatter-adds the windows into
  the cube, convolves with conj(sotf) and applies Tᵗ.

Channels are independent, so `workers > 1` builds them in parallel
processes.

Not ported yet (raise NotImplementedError, naming the ROADMAP item): the
dense W-plane matmul conv (`lmm_conv_otf_matmul`), taken by the reference's
window-local mode when the rank gate declines (M·R ≥ W/2) or the rank conv
is off, the window-local OTF-window tables, cube mode and nearest-neighbour
gridding.
"""

from __future__ import annotations

import multiprocessing
import os
import warnings
from concurrent.futures import ProcessPoolExecutor
from typing import List, Optional

import numpy as np
import torch

from ..core import fft, lmm, numpy_ref
from ..core.wblur import rows_table
from ..core.wblur_banded import banded_tables
from ..instrument.geometry import CoordList, get_srf
from ..instrument.ifu import IFU
from .channel import Channel


def rank_tables(chan: Channel, t: dict, psf_w: np.ndarray, tpl_w: np.ndarray,
                imshape, conv_freq_rtol: float, conv_rank_rtol: float):
    """Add the rank-mode tables of one channel to its host tables `t`
    (reference `_build_host_tables`, spectro.py:378-484); returns the
    channel's support record.  Pops t["wpsf"] (the channel keeps its own)."""
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
    cu, v_psf, tail = fft.lowrank_stamp_factor(psf_w, conv_rank_rtol)
    n_tpl = tpl_w.shape[0]
    if not n_tpl * cu.shape[1] < psf_w.shape[0] // 2:
        raise NotImplementedError(
            f"channel {chan.instr.name}: rank gate declined (M·R = {n_tpl * cu.shape[1]} "
            f"≥ W/2 = {psf_w.shape[0] // 2}); the dense W-plane path "
            "(lmm_conv_otf_matmul) is ROADMAP A9, not ported yet"
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


def _channel_tables(chan: Channel, job: dict):
    """One channel's host tables (and rank-mode support record) for `job`."""
    t = chan.host_tables()
    if job["mode"] == "rank":
        support = rank_tables(chan, t, job["psf_w"], job["tpl_w"], job["imshape"],
                              job["conv_freq_rtol"], job["conv_rank_rtol"])
        return chan, t, support
    if job["banded"]:
        t["band_plan"] = chan.band_plan(job["band_rtol"])
        t["band_plan_t"] = chan.band_plan_t(job["band_rtol"])
    return chan, t, None


def _build_channel(job):
    """One channel's geometry and host tables (a process-pool work item)."""
    return _channel_tables(Channel(*job["chan_args"]), job)


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
            order = sorted(range(len(jobs)), key=lambda i: -jobs[i]["n_w"])
            futs = {i: ex.submit(_build_channel, jobs[i]) for i in order}
            return [futs[i].result() for i in range(len(jobs))]
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _gather_tables(t: dict, device, dtype) -> dict:
    sw = torch.as_tensor(np.asarray(t["slit_w"])).to(device=device, dtype=dtype)
    return {
        "slit_w": sw.reshape(-1, sw.shape[-1], 1).contiguous(),
        "gather_fwd": [p.to(device, dtype) for p in t["gather_fwd"]],
        "gather_t": [p.to(device, dtype) for p in t["gather_t"]],
    }


def device_tables(host: dict, device, dtype=torch.float32) -> dict:
    """Host tables → tensors on `device`, in the kernel-friendly layouts.

    Rank mode: OTF bins-last [Ka', Kb', R] and the folded wblur table
    [K, sb·Q].  W-plane mode (the tree has "sotf"): the OTF [L, Na, Nb//2+1]
    complex, the templates [M, L], the dense wblur table [K, sb·W] and, where
    the host tree has band plans, the banded tables.  Both: slit weights
    [S·A, sb, 1] and the gather plans as device CSR tensors."""
    def f(a):
        return torch.as_tensor(np.asarray(a)).to(device=device, dtype=dtype).contiguous()

    chans = []
    if "sotf" in host:
        ctype = torch.complex64 if dtype == torch.float32 else torch.complex128
        for t in host["chan"]:
            wpsf = f(t["wpsf"])
            c = {**_gather_tables(t, device, dtype), "wq": rows_table(wpsf)}
            if "band_plan" in t:
                c["band"] = banded_tables(wpsf, t["band_plan"], t["band_plan_t"])
            chans.append(c)
        return {
            "sotf": torch.as_tensor(host["sotf"]).to(device=device, dtype=ctype).contiguous(),
            "templates": f(host["templates"]),
            "chan": chans,
        }
    for t in host["chan"]:
        sotf = f(t["sotf_ri"])
        chans.append({
            **_gather_tables(t, device, dtype),
            "dftm": {k: f(v) for k, v in t["dftm"].items()},
            "otf_re": fft.otf_bins_last(sotf[0]),
            "otf_im": fft.otf_bins_last(sotf[1]),
            "wq": rows_table(f(t["wpsf_q"])),
        })
    return {"chan": chans}


def _host(a) -> np.ndarray:
    """An array or a tensor (on any device) as a host array."""
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _np_dtype(dtype) -> np.dtype:
    """A NumPy or torch float dtype as a NumPy dtype."""
    if isinstance(dtype, torch.dtype):
        return np.dtype(torch.empty((), dtype=dtype).numpy().dtype)
    return np.dtype(dtype)


class SpectroSigRLSCT:
    """Multi-channel multi-observation spectro-imaging forward model.
    Inputs are template maps x [M, Na, Nb]; the output is the flat
    concatenation of per-channel blocks [P, S, λ_det, α_det].

    The reference's arguments, in its order and with its defaults, then the
    port's own (`workers`, `channels`).  Two modes, chosen as the
    reference's keywords choose them:

    * ``window_local=True`` with `psf_stack` (the flagship main path, so a
      rank-mode caller passes ``psf_stack=…, window_local=True`` and a
      `conv_rank_rtol` > 0): the λ-rank DFT-matmul conv per channel window
      (`conv_freq_rtol`, `conv_rank_rtol`), the dense folded wblur;
      `normal` fuses fwd∘adj per channel.  `sotf` is not read there, as in
      the reference's stamp mode.  A banded blur asked for here warns and
      runs dense, as the reference does.
    * ``window_local=False`` (the default): the materialized OTF `sotf`
      [L, Na, Nb//2+1] (NumPy or a tensor, e.g. built on the card by
      `fft.ir2fr_device`), ``T``, the full-cube FFT conv, then per channel
      and pointing the composed gather on W λ-planes, the slit weights and
      the spectral blur — dense (``wblur_impl="dense"``) or banded
      (``"banded"``, the `wblur_banded` kernel pair with plans at
      `wblur_band_rtol`); `normal` = adjoint∘forward, as the reference
      criterion composes it.  `wblur_impl` may be switched between "dense"
      and the constructed impl after `to()`: the dense table is always on
      the device.  `psf_stack` is not read there.

    ``conv_impl="auto"`` is what the port runs in each mode: "matmul" (the
    λ-rank conv) window-local, "fft" with a materialized sotf.  Not ported
    (NotImplementedError, with the ROADMAP item): cube mode
    (``templates=None``), ``gridding="nn"``, the window-local OTF-window
    tables (`sotf` without `psf_stack`, or ``conv_impl="fft"``) and the
    dense window-local matmul conv (``conv_rank_rtol=0``), all A9;
    ``conv_precision`` other than "highest" (ROADMAP "Do not port": not
    safe under CG).

    `dtype` (NumPy or torch) is the type of the host tables; :meth:`to`
    moves them to a torch device and dtype.  `workers` > 1 builds channels
    in parallel spawned processes, which re-import the calling script: call
    it from under ``if __name__ == "__main__":``.  `channels` reuses the
    Channel objects of another model over the same instruments, axes and
    pointings (their geometry, wpsf and gather plans), skipping the
    costliest host stages.
    """

    def __init__(
        self,
        sotf,
        templates,
        alpha_axis,
        beta_axis,
        wavelength_axis,
        instrs: List[IFU],
        step_degree: float,
        pointings,
        dtype=np.float32,
        gridding: str = "bilinear",
        wblur_impl: str = "dense",
        wblur_band_rtol: float = 0.0,
        window_local: bool = False,
        conv_impl: str = "auto",
        conv_freq_rtol: float = 0.0,
        psf_stack=None,
        conv_precision: str = "highest",
        conv_rank_rtol: float = 0.0,
        workers: int = 1,
        channels: Optional[List[Channel]] = None,
    ):
        if wblur_impl not in ("dense", "banded"):
            raise ValueError(f"unknown wblur_impl {wblur_impl!r}")
        if gridding not in ("bilinear", "nn"):
            raise ValueError(f"unknown gridding mode {gridding!r}")
        if conv_impl not in ("auto", "fft", "matmul"):
            raise ValueError(f"unknown conv_impl {conv_impl!r}")
        if conv_precision not in ("highest", "high", "default"):
            raise ValueError(f"unknown conv_precision {conv_precision!r}")
        if sotf is None and psf_stack is None:
            raise ValueError("need sotf or psf_stack")
        self.window_local = bool(window_local)
        if conv_impl == "auto":
            conv_impl = "matmul" if self.window_local else "fft"
        if sotf is None and not (self.window_local and conv_impl == "matmul"):
            raise ValueError("psf_stack-only mode requires window_local=True and "
                             "conv_impl='matmul' (FFT paths need a materialized sotf)")
        if templates is None:
            raise NotImplementedError("templates=None (cube mode) is ROADMAP A9, not ported yet")
        if gridding == "nn":
            raise NotImplementedError("gridding='nn' (core/nearest.py) is ROADMAP A9, not ported yet")
        if conv_precision != "highest":
            raise NotImplementedError(
                f"conv_precision={conv_precision!r}: not ported (ROADMAP 'Do not port': "
                "a reduced-precision conv is not safe under CG)")
        if self.window_local:
            if conv_impl == "fft" or psf_stack is None:
                raise NotImplementedError(
                    "window_local=True with a materialized sotf (the OTF-window tables, "
                    "conv_impl='fft' or sotf without psf_stack) is ROADMAP A9, not ported yet; "
                    "pass psf_stack for the λ-rank mode, or window_local=False")
            if conv_rank_rtol <= 0.0:
                raise NotImplementedError(
                    "window_local=True with conv_rank_rtol=0 selects the dense window-local "
                    "matmul conv (lmm_conv_otf_matmul), ROADMAP A9, not ported yet")
            if wblur_impl == "banded":
                warnings.warn(
                    "wblur_impl='banded' is not supported in window_local mode; "
                    "falling back to the dense MXU spectral blur",
                    stacklevel=2,
                )
                wblur_impl = "dense"
        self.conv_impl = conv_impl
        self.wblur_impl = wblur_impl
        self.wblur_band_rtol = float(wblur_band_rtol)
        self.templates = np.asarray(templates)
        self.alpha_axis = np.asarray(alpha_axis, np.float64)
        self.beta_axis = np.asarray(beta_axis, np.float64)
        self.wavelength_axis = np.asarray(wavelength_axis, np.float64)
        self.step_degree = float(step_degree)
        self.psf_stack = None if psf_stack is None else np.asarray(psf_stack)
        self.sotf = sotf
        self.npdtype = _np_dtype(dtype)
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
            job = {
                "chan_args": (instr, self.alpha_axis, self.beta_axis, self.wavelength_axis, srf,
                              CoordList(pointings[it]), self.step_degree, self.npdtype),
                "n_w": wsl.stop - wsl.start,
                "mode": "rank" if self.window_local else "wplane",
            }
            if self.window_local:
                job.update(psf_w=np.asarray(self.psf_stack[wsl.start : wsl.stop], self.npdtype),
                           tpl_w=self.templates[:, wsl], imshape=self.imshape,
                           conv_freq_rtol=self.conv_freq_rtol, conv_rank_rtol=self.conv_rank_rtol)
            else:
                job.update(banded=wblur_impl == "banded", band_rtol=self.wblur_band_rtol)
            jobs.append(job)
        if channels is None:
            built = _map_channels(jobs, int(workers))
        else:
            if len(channels) != len(jobs):
                raise ValueError(f"{len(channels)} channels for {len(jobs)} instruments")
            built = [_channel_tables(chan, job) for chan, job in zip(channels, jobs)]
        self.channels = [b[0] for b in built]
        self._host = {"chan": tuple(b[1] for b in built)}
        if not self.window_local:
            self._host.update(sotf=self.sotf, templates=self.templates)
        self.conv_supports = [b[2] for b in built]
        self.instrs_oshape = [chan.oshape for chan in self.channels]
        self._idx = np.cumsum([0] + [int(np.prod(o)) for o in self.instrs_oshape])
        self.oshape = (int(self._idx[-1]),)
        self.tables = None
        self._templates_dev = None
        self.device = None
        self.dtype = None

    def host_tables(self) -> dict:
        """All model tables as one host tree (NumPy; the W-plane `sotf` as
        given); do not mutate."""
        return self._host

    def to(self, device, dtype=torch.float32, tables: Optional[dict] = None):
        """Move the tables (or adopt the given device `tables`, e.g. from
        `convert`) to `device` / `dtype`."""
        self.device = torch.device(device)
        self.dtype = dtype
        self.tables = device_tables(self._host, self.device, dtype) if tables is None else tables
        self._templates_dev = None
        return self

    # ------------------------------------------------------------------
    def _x(self, x) -> torch.Tensor:
        if self.tables is None:
            raise RuntimeError("call .to(device, dtype) before applying the model")
        return torch.as_tensor(x).to(device=self.device, dtype=self.dtype).reshape(self.ishape)

    def _y(self, y) -> torch.Tensor:
        if self.tables is None:
            raise RuntimeError("call .to(device, dtype) before applying the model")
        return torch.as_tensor(y).to(device=self.device, dtype=self.dtype).reshape(-1)

    def _conv(self, x, c):
        t = self.tables["chan"][c]
        return fft.lmm_conv_rank_rows(x, t["otf_re"], t["otf_im"], t["dftm"])

    def _conv_t(self, rows, c):
        t = self.tables["chan"][c]
        return fft.lmm_conv_rank_rows_t(rows, t["otf_re"], t["otf_im"], t["dftm"])

    @property
    def banded(self) -> bool:
        if self.wblur_impl == "banded" and "band" not in self.tables["chan"][0]:
            raise ValueError("wblur_impl='banded' on a model built dense: no band tables")
        return self.wblur_impl == "banded"

    def _templates(self) -> torch.Tensor:
        """The templates [M, L] on the device (the W-plane tables hold them;
        rank mode uploads them at first use)."""
        if "templates" in self.tables:
            return self.tables["templates"]
        if self._templates_dev is None:
            self._templates_dev = torch.as_tensor(self.templates).to(self.device, self.dtype)
        return self._templates_dev

    def mapsToCube(self, maps) -> torch.Tensor:
        """T: maps [M, Na, Nb] → cube [L, Na, Nb]."""
        return lmm.lmm_maps2cube(self._x(maps), self._templates())

    def cubeTomaps(self, cube) -> torch.Tensor:
        """Tᵗ: cube [L, Na, Nb] → maps [M, Na, Nb]."""
        cube = torch.as_tensor(cube).to(device=self.device, dtype=self.dtype)
        return lmm.lmm_cube2maps(cube, self._templates())

    # ------------------------------------------------------------------
    # data side: host NumPy, as in the reference (spectro.py:918-1016)
    def split(self, data) -> list:
        """Split the flat data vector (array or tensor) into per-channel
        4-D host blocks."""
        flat = _host(data).ravel()
        return [
            flat[self._idx[i] : self._idx[i + 1]].reshape(self.instrs_oshape[i])
            for i in range(len(self.channels))
        ]

    def concat(self, blocks) -> np.ndarray:
        """Inverse of :meth:`split`."""
        return np.concatenate([_host(b).ravel() for b in blocks])

    def real_data_janskySR_to_jansky(self, data) -> np.ndarray:
        """Flux normalization of raw real data (reference :225-239): scale each
        slit by the summed β weights of its first row × the channel SRF."""
        data = np.array(_host(data))
        for ch_idx, chan in enumerate(self.channels):
            block = data[self._idx[ch_idx] : self._idx[ch_idx + 1]].reshape(
                self.instrs_oshape[ch_idx]
            )
            for slit in range(self.instrs_oshape[ch_idx][1]):
                slices = chan.slicer.get_slit_slices(slit)
                weights = chan.slicer.get_slit_weights(slit, slices)
                block[:, slit] = block[:, slit] * np.sum(weights[0, 0, :]) * self.srfs[ch_idx]
            data[self._idx[ch_idx] : self._idx[ch_idx + 1]] = block.ravel()
        return data

    def plot_slice(self, all_data, n_chan: int, nslice: int):
        """Re-project one detector λ-slice of a channel onto the sky
        (reference spectroModel.py:242-286): β-duplicate each slit row,
        α-upsample, conj SRF-OTF, reverse-grid, and co-add over pointings.
        Returns (weighted_mean, global_img); no plotting.  `weighted_mean`
        is 0 where no pointing exceeds 100 (the reference leaves those
        entries of its `np.divide` output uninitialized)."""
        chan = self.channels[n_chan]
        global_img = np.zeros(self.imshape)
        cum_grid = np.zeros((len(self.pointings[n_chan]),) + self.imshape)

        chan_data = _host(all_data).ravel()[self._idx[n_chan] : self._idx[n_chan + 1]]
        data = chan_data.reshape(chan.oshape)[:, :, nslice, :]

        nla, nlb = chan.local_im_shape
        sb = chan.slicer.npix_slit_beta_width
        for p_idx in range(len(chan.pointings)):
            local_img = np.zeros((nla, nlb))
            for slit_idx in range(chan.instr.n_slit):
                over = np.repeat(data[p_idx, slit_idx][:, np.newaxis], sb, axis=1) / (sb * chan.srf)
                sliced = np.zeros((1,) + chan.slicer.get_slit_shape()[1:])
                sliced[0, : data.shape[2] * chan.srf : chan.srf, :] = over
                local_img += chan.slicer.slicing_t(sliced, slit_idx, (1, nla, nlb))[0]
            sum_t = np.fft.irfftn(
                np.fft.rfftn(local_img, axes=(-2, -1), norm="ortho")
                * (chan._otf_sr[0].conj() * chan.decalf.conj()),
                s=(nla, nlb), axes=(-2, -1), norm="ortho",
            )
            degridded = numpy_ref.apply_plan(
                chan.plans_rev[p_idx], sum_t[np.newaxis]).reshape(self.imshape)
            global_img += degridded
            cum_grid[p_idx] = degridded
        valid = np.sum(cum_grid > 100, axis=0)
        total = np.sum(cum_grid, axis=0)
        weighted_mean = np.divide(total, valid, out=np.zeros_like(total), where=valid != 0)
        return weighted_mean, global_img

    def _mask_group_leads(self) -> list:
        """First band of each MIRI channel (the reference's `ch = i*3` over
        its fixed 12-band list, spectroModel.py:296-297), grouped by the
        channel digit of the band name, else by consecutive triples."""
        leads, seen = [], set()
        for i, chan in enumerate(self.channels):
            name = str(getattr(chan.instr, "name", "") or "")
            key = name[0] if name[:1].isdigit() else f"g{i // 3}"
            if key not in seen:
                seen.add(key)
                leads.append(i)
        return leads

    def make_mask(self, all_data, threshold: float = 50.0, nslice: int = 50) -> list:
        """One binary spatial mask per channel group (reference :289-338):
        the `plot_slice` re-projection of one detector λ-slice of the first
        band of each channel, thresholded."""
        masks = []
        for ch in self._mask_group_leads():
            _, global_img = self.plot_slice(all_data, ch, nslice)
            masks.append(global_img > threshold)
        return masks

    def patch_rows(self, cube: torch.Tensor, c: int) -> torch.Tensor:
        """Channel c's λ-window of the FOV-bbox patch of `cube`, laid out
        pixel-major for the gather: [W, ha, wb] → [ha·wb, W] (a copy)."""
        chan = self.channels[c]
        ws, (a0, b0, ha, wb) = chan.wslice, chan.tbbox
        patch = cube[ws.start : ws.stop, a0 : a0 + ha, b0 : b0 + wb]
        # a bbox of whole planes would reshape to a strided view: force the copy
        return patch.permute(1, 2, 0).reshape(ha * wb, -1).contiguous()

    def add_patch_rows_(self, cube: torch.Tensor, rows: torch.Tensor, c: int) -> None:
        """Transpose of :meth:`patch_rows`: add rows [ha·wb, W] into `cube`."""
        chan = self.channels[c]
        ws, (a0, b0, ha, wb) = chan.wslice, chan.tbbox
        cube[ws.start : ws.stop, a0 : a0 + ha, b0 : b0 + wb].add_(rows.view(ha, wb, -1).permute(2, 0, 1))

    def blurred_cube(self, x) -> torch.Tensor:
        """C T x: the templates' cube convolved with the OTF (W-plane mode)."""
        cube = lmm.lmm_maps2cube(self._x(x), self.tables["templates"])
        return fft.conv_otf_(cube, self.tables["sotf"])

    def forward(self, x, plain: bool = False) -> torch.Tensor:
        """Template maps [M, Na, Nb] → flat data vector.  `plain=True` runs
        the kernels' plain versions."""
        x = self._x(x)
        outs = []
        if self.window_local:
            for c, chan in enumerate(self.channels):
                rows = self._conv(x, c)
                outs.append(chan.forward_rows(rows, self.tables["chan"][c], plain).reshape(-1))
        else:
            banded = self.banded
            cube = self.blurred_cube(x)
            for c, chan in enumerate(self.channels):
                outs.append(chan.forward_rows(self.patch_rows(cube, c), self.tables["chan"][c],
                                              plain, banded).reshape(-1))
        return torch.cat(outs)

    def adjoint(self, y, plain: bool = False) -> torch.Tensor:
        """Transpose of :meth:`forward`: flat data → [M, Na, Nb].  Exact,
        except the banded blur keeps the transpose plan's mask (reference
        `_adjoint_fn_const` with `wblur_sum_beta_t_banded`)."""
        y = self._y(y)
        if self.window_local:
            acc = torch.zeros(self.ishape, device=self.device, dtype=self.dtype)
            for c, chan in enumerate(self.channels):
                yc = y[int(self._idx[c]) : int(self._idx[c + 1])].view(chan.oshape)
                acc.add_(self._conv_t(chan.adjoint_rows(yc, self.tables["chan"][c], plain), c))
            return acc
        banded = self.banded
        cube = torch.zeros(self.cube_shape, device=self.device, dtype=self.dtype)
        for c, chan in enumerate(self.channels):
            yc = y[int(self._idx[c]) : int(self._idx[c + 1])].view(chan.oshape)
            self.add_patch_rows_(cube, chan.adjoint_rows(yc, self.tables["chan"][c], plain, banded), c)
        fft.conv_otf_(cube, self.tables["sotf"], conj=True)
        return lmm.lmm_cube2maps(cube, self.tables["templates"])

    def normal(self, x, plain: bool = False) -> torch.Tensor:
        """HᵗH x.  Rank mode fuses fwd∘adj per channel without materializing
        the flat y; W-plane mode is adjoint∘forward."""
        x = self._x(x)
        if not self.window_local:
            return self.adjoint(self.forward(x, plain), plain)
        acc = torch.zeros_like(x)
        for c, chan in enumerate(self.channels):
            t = self.tables["chan"][c]
            yc = chan.forward_rows(self._conv(x, c), t, plain)
            acc.add_(self._conv_t(chan.adjoint_rows(yc, t, plain), c))
        return acc
