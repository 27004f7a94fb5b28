"""The fusion operator y = Σ R L S C T x, in every conv mode of the reference.

Counterpart of `surfh_tpu/models/spectro.py::SpectroSigRLSCT`:

* window-local (`window_local=True`, reference `_channel_fwd_tabled` /
  `_channel_adj_tabled`): per channel, the conv of its λ-window onto its
  FOV bbox as ``[ha·wb, Q]`` rows, then the per-pointing composed gather /
  slit weights / dense wblur GEMM; the adjoint mirrors it, and `normal`
  fuses fwd∘adj per channel without materializing the flat data vector.
  Per channel the conv is one of:
  - λ-rank (PSF stamps, `conv_rank_rtol` > 0, the gate open: M·R < W/2),
    `SURFH_HOST_MATERIALIZE=1` table semantics: the host builds the DFT
    matrices on the OTF support and FOV bbox (`dftm`), the OTF of the R
    rank-basis stamps (`sotf_ri`), the rank coefficients (`cu`) and the
    λ-mix-folded blur (`wpsf_q`); `fft.lmm_conv_rank_rows` runs on
    Q = M·R basis planes;
  - dense matmul (`conv_impl="matmul"`, the gate declined or off): the
    OTF window [W, Ka', Kb'] — evaluated once on the device from the
    stamps (`psf` / `stamp`), or cut from a materialized `sotf` (a view of
    it where `conv_freq_rtol` cuts nothing) — and `fft.lmm_conv_otf_rows`
    on Q = W planes;
  - window FFT (`conv_impl="fft"`, a materialized `sotf`): the window's
    cube through `fft.conv_otf_chunks` / `_t`, its FOV bbox laid out as
    rows.
  Rank and dense channels mix in one model, as in the reference.
* non-window-local with a materialized OTF `sotf` (reference `_forward_fn`
  / `_adjoint_fn_const`, the path of the CLI and the real-data pipeline):
  T (`lmm`) and the full-cube ``idft(dft(cube)·sotf)`` conv, then per
  channel the λ-window's FOV-bbox patch laid out as ``[ha·wb, W]`` rows and
  the same per-pointing chain on W λ-planes, with the spectral blur dense
  or banded (`core.wblur_banded`); the adjoint scatter-adds the windows
  into the cube, convolves with conj(sotf) and applies Tᵗ, both through
  `fft.conv_otf_chunks` / `_t`: with templates T is mixed into the conv in
  the frequency domain (the M maps are transformed once, and each λ-plane
  once a direction); in cube mode the conv reads the cube's own planes.
  The forward holds the blurred cube as its λ-chunks; the adjoint's
  scatter-added cube is the operator's temporary, which cube mode's
  transpose overwrites.
* cube mode (``templates=None``) in both: the input is the cube itself
  (window-local: each channel reads and adds into its λ-window).

Channels are independent, so `workers > 1` builds them in parallel
processes.  The window-local stamp-mode host tables are a pure function of
the configuration and are cached on disk (`table_cache_path`).

Gridding is bilinear or nearest-neighbour (``gridding="nn"``) in every
mode, composed or staged as each channel is (`models.channel`).

Under `torch.profiler` the operator records host-lane spans
(`utils.profiling.span`): ``surfh.op.normal`` around each `normal`, and
``surfh.op.band.<band>`` (the channel's instrument name, else its index)
around each channel's part of the forward, the adjoint and the
window-local normal; `fft.conv_otf_chunks` / `_t` record
``surfh.op.conv.maps`` around each call with templates and
``surfh.op.conv.cube`` around each call in cube mode (twice a W-plane
normal, per band on the window-FFT route); the dense window-local conv
pair records ``surfh.op.conv.window`` (twice a band a normal).
"""

from __future__ import annotations

import hashlib
import multiprocessing
import os
import pickle
import warnings
from concurrent.futures import ProcessPoolExecutor
from typing import List, Optional

import numpy as np
import torch

from ..core import fft, lmm, numpy_ref
from ..core.linop import complex_dtype
from ..core.precision import require_highest
from ..core.wblur import rows_table
from ..core.wblur_banded import banded_tables
from ..instrument.geometry import CoordList, get_srf
from ..instrument.ifu import IFU
from ..utils.profiling import span
from .channel import Channel, gather_device_tables

TABLE_CACHE_VERSION = 1
SPAN_NORMAL, SPAN_BAND = "surfh.op.normal", "surfh.op.band."
# the modules whose code builds the cached tables: their bytes are part of the key
_TABLE_SOURCES = ("models/spectro.py", "models/channel.py", "models/slicer.py", "core/fft.py",
                  "core/bilinear.py", "core/gather_rows.py", "instrument/geometry.py",
                  "instrument/ifu.py", "instrument/spectral.py")


def _support_record(tbbox, imshape, ka_max, kb_keep, dropped, conv_freq_rtol) -> dict:
    na_g, nb_g = imshape
    return dict(
        ka_max=ka_max, kb_keep=kb_keep, dropped_rel=dropped, bbox=tbbox,
        keep_frac=(1.0 if conv_freq_rtol <= 0.0
                   else len(fft.freq_sel_alpha(na_g, ka_max)) * kb_keep / (na_g * (nb_g // 2 + 1))),
    )


def stamp_tables(job: dict, tbbox, npdtype, wpsf=None):
    """One channel's window-local stamp-mode tables (reference
    `_build_host_tables`, spectro.py:378-484) from its stamps, templates
    and FOV bbox: returns (the tables, the support record).  The rank gate
    opens where the reference's does (`conv_rank_rtol` > 0, LMM mode, a
    composed channel — ``job["composed"]`` — and M·R < W // 2): the rank
    tables `dftm`, `cu`, `sotf_ri` and `wpsf_q` (folded from the channel's
    `wpsf`, which the caller then drops from the channel's tables).
    Otherwise the dense tables: `dftm`, the stamps `psf` and their DFT
    matrices `stamp` (the channel keeps its `wpsf`)."""
    psf_w, tpl_w, imshape = job["psf_w"], job["tpl_w"], job["imshape"]
    rtol = job["conv_freq_rtol"]
    ka_max, kb_keep, dropped = None, None, 0.0
    if rtol > 0.0:
        ka_max, kb_keep, dropped = fft.otf_support_from_psf(psf_w, imshape, rtol)
    support = _support_record(tbbox, imshape, ka_max, kb_keep, dropped, rtol)
    t = {"dftm": fft.dft_matmul_tables(imshape, npdtype, ka_max=ka_max, kb_keep=kb_keep,
                                       bbox=tbbox)}
    if _rank_possible(job):
        cu, v_psf, tail = fft.lowrank_stamp_factor(psf_w, job["conv_rank_rtol"])
        if tpl_w.shape[0] * cu.shape[1] < psf_w.shape[0] // 2:
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
                np.einsum("kwb,wq->kqb", wpsf.astype(np.float64), cmat), npdtype)
            return t, support
    t["psf"] = psf_w
    t["stamp"] = fft.psf_stamp_tables(imshape, psf_w.shape[-2:], npdtype, ka_max=ka_max,
                                      kb_keep=kb_keep)
    return t, support


def _rank_possible(job: dict) -> bool:
    """The reference's gate before the SVD: rank planes ride the composed
    gather, so a staged channel keeps the dense conv."""
    return job["conv_rank_rtol"] > 0.0 and job["tpl_w"] is not None and job["composed"]


def _merge_stamp_tables(t: dict, out) -> dict:
    """Merge `stamp_tables`' result into a channel's host tables `t`;
    returns the support record."""
    extra, support = out
    if "wpsf_q" in extra:
        t.pop("wpsf")
    t.update(extra)
    return support


def otf_window_tables(chan: Channel, t: dict, sotf_w, imshape, conv_impl: str,
                      conv_freq_rtol: float):
    """Add one channel's window-local OTF-window tables to `t`: its window
    `sotf_w` [W, Na, Nb//2+1] of a materialized sotf (NumPy or a tensor,
    kept as given: a view of the global OTF), cut to `fft.otf_freq_support`
    when the matmul conv truncates, and with the matmul conv the DFT
    matrices; returns the support record (None for the FFT conv)."""
    if conv_impl != "matmul":
        t["sotf_w"] = sotf_w
        return None
    ka_max, kb_keep, dropped = None, None, 0.0
    if conv_freq_rtol > 0.0:
        ka_max, kb_keep, dropped = fft.otf_freq_support(sotf_w, conv_freq_rtol)
        sel_a = fft.freq_sel_alpha(imshape[0], ka_max)
        if isinstance(sotf_w, torch.Tensor):
            sotf_w = sotf_w[:, torch.as_tensor(sel_a, device=sotf_w.device), :kb_keep].contiguous()
        else:
            sotf_w = np.ascontiguousarray(np.asarray(sotf_w)[:, sel_a, :kb_keep])
    t["sotf_w"] = sotf_w
    t["dftm"] = fft.dft_matmul_tables(imshape, chan.npdtype, ka_max=ka_max, kb_keep=kb_keep,
                                      bbox=chan.tbbox)
    return _support_record(chan.tbbox, imshape, ka_max, kb_keep, dropped, conv_freq_rtol)


def _channel_tables(chan: Channel, job: dict):
    """One channel's host tables (and window-local support record) for `job`
    (the OTF-window tables are added afterwards, in the calling process)."""
    t = chan.host_tables()
    if job["mode"] == "stamps":
        job = {**job, "composed": not chan.staged}
        wpsf = t["wpsf"] if _rank_possible(job) else None
        return chan, t, _merge_stamp_tables(t, stamp_tables(job, chan.tbbox, chan.npdtype, wpsf))
    if job.get("banded"):
        t["band_plan"] = chan.band_plan(job["band_rtol"])
        t["band_plan_t"] = chan.band_plan_t(job["band_rtol"])
    return chan, t, None


def _build_channel(job):
    """One channel's geometry and host tables (a process-pool work item)."""
    return _channel_tables(Channel(*job["chan_args"]), job)


def _pool_map(fn, args, n_w, workers: int):
    """[fn(*a) for a in args] in `workers` spawned processes (one BLAS
    thread each), the largest λ windows `n_w` first."""
    keys = ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS")
    saved = {k: os.environ.get(k) for k in keys}
    os.environ.update({k: "1" for k in keys})
    try:
        ctx = multiprocessing.get_context("spawn")
        with ProcessPoolExecutor(min(workers, len(args)), mp_context=ctx) as ex:
            order = sorted(range(len(args)), key=lambda i: -n_w[i])
            futs = {i: ex.submit(fn, *args[i]) for i in order}
            return [futs[i].result() for i in range(len(args))]
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _map_channels(jobs, workers: int):
    if workers <= 1 or len(jobs) <= 1:
        return [_build_channel(j) for j in jobs]
    return _pool_map(_build_channel, [(j,) for j in jobs], [j["n_w"] for j in jobs], workers)


def _map_given_channels(channels, jobs, workers: int):
    """Tables of the given channels; with `workers` > 1 the stamp tables
    are built in processes that receive only their inputs (the stamps,
    the templates, the bbox and, where the rank gate may open, the wpsf)."""
    if workers <= 1 or len(jobs) <= 1 or jobs[0]["mode"] != "stamps":
        return [_channel_tables(chan, job) for chan, job in zip(channels, jobs)]
    tabs = [chan.host_tables() for chan in channels]
    jobs = [{**job, "composed": not chan.staged} for chan, job in zip(channels, jobs)]
    args = [(job, chan.tbbox, chan.npdtype, t["wpsf"] if _rank_possible(job) else None)
            for chan, job, t in zip(channels, jobs, tabs)]
    outs = _pool_map(stamp_tables, args, [j["n_w"] for j in jobs], workers)
    return [(chan, t, _merge_stamp_tables(t, out)) for chan, t, out in zip(channels, tabs, outs)]


def device_tables(host: dict, device, dtype=torch.float32) -> dict:
    """Host tables → tensors on `device`, in the kernel-friendly layouts.

    W-plane mode (the tree has "sotf"): the OTF [L, Na, Nb//2+1] complex,
    the templates [M, L] (None in cube mode), the dense wblur table
    [K, sb·W] and, where the host tree has band plans, the banded tables.
    Window-local, per channel by its tables: rank — the OTF bins-last
    [Ka', Kb', R] and the folded wblur table [K, sb·Q]; dense matmul —
    the OTF window (re, im) [W, Ka', Kb'], evaluated here once from the
    stamps (`fft.otf_from_stamps`) or taken from the materialized window
    (the real and imaginary views of it, no copy where it is already on
    `device` in the complex type); window FFT — the complex window; both
    with the dense wblur table [K, sb·W].  Every mode: slit weights
    [S·A, sb, 1] and the gather plans as device CSR tensors."""
    def f(a):
        return torch.as_tensor(np.asarray(a)).to(device=device, dtype=dtype).contiguous()

    ctype = complex_dtype(dtype)
    chans = []
    if "sotf" in host:
        for t in host["chan"]:
            wpsf = f(t["wpsf"])
            c = {**gather_device_tables(t, device, dtype), "wq": rows_table(wpsf)}
            if "band_plan" in t:
                c["band"] = banded_tables(wpsf, t["band_plan"], t["band_plan_t"])
            chans.append(c)
        tpl = host["templates"]
        return {
            "sotf": torch.as_tensor(host["sotf"]).to(device=device, dtype=ctype).contiguous(),
            "templates": None if tpl is None else f(tpl),
            "chan": chans,
        }
    for t in host["chan"]:
        if t is None:  # a channel this device does not hold (`SpectroSigRLSCT.to(channels=...)`)
            chans.append(None)
            continue
        c = gather_device_tables(t, device, dtype)
        c["dftm"] = {k: f(v) for k, v in t["dftm"].items()} if "dftm" in t else None
        if "wpsf_q" in t:
            sotf = f(t["sotf_ri"])
            c.update(otf_re=fft.otf_bins_last(sotf[0]), otf_im=fft.otf_bins_last(sotf[1]),
                     wq=rows_table(f(t["wpsf_q"])))
        else:
            c["wq"] = rows_table(f(t["wpsf"]))
            if "psf" in t:
                c["otf"] = fft.otf_from_stamps(f(t["psf"]), {k: f(v) for k, v in t["stamp"].items()})
            else:
                s = torch.as_tensor(t["sotf_w"]).to(device=device, dtype=ctype)
                if c["dftm"] is not None:
                    c["otf"] = (s.real, s.imag)
                else:
                    c["sotf"] = s
        chans.append(c)
    return {"chan": chans}


def _host(a) -> np.ndarray:
    """An array or a tensor (on any device) as a host array."""
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _np_dtype(dtype) -> np.dtype:
    """A NumPy or torch float dtype as a NumPy dtype."""
    if isinstance(dtype, torch.dtype):
        return np.dtype(torch.empty((), dtype=dtype).numpy().dtype)
    return np.dtype(dtype)


def _hash_array(h, a) -> None:
    if a is None:
        h.update(b"-")
        return
    a = np.ascontiguousarray(a)
    h.update(str((a.dtype.str, a.shape)).encode())
    h.update(a.tobytes())


def table_cache_dir() -> Optional[str]:
    """The host-table cache directory: ``SURFH_TABLE_CACHE`` (``0`` turns
    the cache off; any other value is the directory), else
    ``~/.cache/surfh_tpu_torch``."""
    loc = os.environ.get("SURFH_TABLE_CACHE")
    if loc == "0":
        return None
    return loc or os.path.join(os.path.expanduser("~"), ".cache", "surfh_tpu_torch")


class SpectroSigRLSCT:
    """Multi-channel multi-observation spectro-imaging forward model.
    Inputs are template maps x [M, Na, Nb] (the cube [L, Na, Nb] in cube
    mode, ``templates=None``); the output is the flat concatenation of
    per-channel blocks [P, S, λ_det, α_det].

    The reference's arguments, in its order and with its defaults, then the
    port's own (`workers`, `channels`), and the reference's modes:

    * ``window_local=True``: per channel its λ-window's conv onto its FOV
      bbox and the dense folded wblur; `normal` fuses fwd∘adj per channel.
      With ``conv_impl="matmul"`` and `psf_stack`, the PSF-stamp mode
      (`sotf` is not read): λ-rank channels where `conv_rank_rtol` > 0 and
      the gate opens, the dense OTF window evaluated from the stamps
      elsewhere; without `psf_stack`, the OTF-window tables cut from `sotf`
      (matmul, or ``conv_impl="fft"``: the window's FFT conv).  Both
      truncate the spectrum at `conv_freq_rtol`.  A banded blur asked for
      here warns and runs dense, as the reference does.
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

    ``conv_impl="auto"`` resolves as on the reference's TPU: "matmul"
    window-local (the card plays the TPU's part), "fft" with a
    materialized sotf.  ``gridding`` is "bilinear" or "nn" in every mode.
    Not ported (NotImplementedError, with the ROADMAP item):
    ``conv_precision`` other than "highest" (ROADMAP "Do not port": not
    safe under CG).

    `dtype` (NumPy or torch) is the type of the host tables; :meth:`to`
    moves them to a torch device and dtype.  `workers` > 1 builds channels
    in parallel spawned processes, which re-import the calling script: call
    it from under ``if __name__ == "__main__":``.  `channels` reuses the
    Channel objects of another model over the same instruments, axes and
    pointings (their geometry, wpsf and gather plans), skipping the
    costliest host stages.  Window-local stamp-mode host tables are read
    from and written to the disk cache of :func:`table_cache_dir` (checked
    before any worker starts).
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
        require_highest(conv_precision, "conv_precision")
        if self.window_local and wblur_impl == "banded":
            warnings.warn(
                "wblur_impl='banded' is not supported in window_local mode; "
                "falling back to the dense MXU spectral blur",
                stacklevel=2,
            )
            wblur_impl = "dense"
        self.conv_impl = conv_impl
        self.conv_precision = conv_precision
        self.wblur_impl = wblur_impl
        self.gridding = gridding
        self.wblur_band_rtol = float(wblur_band_rtol)
        self.lmm = templates is not None
        self.templates = np.asarray(templates) if self.lmm else None
        self.alpha_axis = np.asarray(alpha_axis, np.float64)
        self.beta_axis = np.asarray(beta_axis, np.float64)
        self.wavelength_axis = np.asarray(wavelength_axis, np.float64)
        self.step_degree = float(step_degree)
        self.psf_stack = None if psf_stack is None else np.asarray(psf_stack)
        self.sotf = sotf
        self.npdtype = _np_dtype(dtype)
        self.conv_freq_rtol = float(conv_freq_rtol)
        self.conv_rank_rtol = float(conv_rank_rtol)
        self.instrs = list(instrs)
        self.srfs = get_srf([chan.det_pix_size for chan in instrs], self.step_degree * 3600)
        if isinstance(pointings, CoordList) or (
            len(pointings) and not isinstance(pointings[0], (list, CoordList))
        ):
            pointings = [CoordList(pointings) for _ in instrs]
        self.pointings = pointings
        self.imshape = (len(self.alpha_axis), len(self.beta_axis))
        self.cube_shape = (len(self.wavelength_axis),) + self.imshape
        self.ishape = ((self.templates.shape[0],) + self.imshape) if self.lmm else self.cube_shape
        # stamp mode (reference `_build_host_tables`): the matmul conv with stamps
        self.stamps = self.window_local and conv_impl == "matmul" and self.psf_stack is not None

        jobs, wslices = [], []
        for it, (srf, instr) in enumerate(zip(self.srfs, instrs)):
            wsl = instr.pix(self.step_degree).wslice(self.wavelength_axis, 0.1)
            wslices.append(wsl)
            job = {
                "chan_args": (instr, self.alpha_axis, self.beta_axis, self.wavelength_axis, srf,
                              CoordList(pointings[it]), self.step_degree, self.npdtype, gridding,
                              wblur_impl, self.wblur_band_rtol),
                "n_w": wsl.stop - wsl.start,
                "mode": "stamps" if self.stamps else "plain",
            }
            if self.stamps:
                job.update(psf_w=np.asarray(self.psf_stack[wsl.start : wsl.stop], self.npdtype),
                           tpl_w=self.templates[:, wsl] if self.lmm else None, imshape=self.imshape,
                           conv_freq_rtol=self.conv_freq_rtol, conv_rank_rtol=self.conv_rank_rtol)
            elif not self.window_local:
                job.update(banded=wblur_impl == "banded", band_rtol=self.wblur_band_rtol)
            jobs.append(job)

        cache = self.table_cache_path()
        cached = _read_cache(cache)
        if cached is not None:
            cached_chans, host_chan, supports = cached
            built = list(zip(cached_chans if channels is None else channels, host_chan, supports))
            self.table_cache_hit = True
        else:
            if channels is None:
                built = _map_channels(jobs, int(workers))
            else:
                if len(channels) != len(jobs):
                    raise ValueError(f"{len(channels)} channels for {len(jobs)} instruments")
                if any(chan.gridding != gridding for chan in channels):
                    raise ValueError(f"given channels are not gridding={gridding!r}: use "
                                     "Channel.regrid")
                built = _map_given_channels(channels, jobs, int(workers))
            self.table_cache_hit = False
            if cache is not None:
                _write_cache(cache, ([b[0] for b in built], tuple(b[1] for b in built),
                                     [b[2] for b in built]))
        self.channels = [b[0] for b in built]
        self.list_wslice = [chan.wslice for chan in self.channels]
        self._band_spans = [_band_span(instr, c) for c, instr in enumerate(self.instrs)]
        host_chan = tuple(b[1] for b in built)
        supports = [b[2] for b in built]
        if self.window_local and not self.stamps:
            for c, (chan, t) in enumerate(zip(self.channels, host_chan)):
                supports[c] = otf_window_tables(chan, t, sotf[wslices[c]], self.imshape,
                                                conv_impl, self.conv_freq_rtol)
        self._host = {"chan": host_chan}
        if not self.window_local:
            self._host.update(sotf=self.sotf, templates=self.templates)
        self.conv_supports = supports if self.window_local and conv_impl == "matmul" else None
        self.instrs_oshape = [chan.oshape for chan in self.channels]
        self._idx = np.cumsum([0] + [int(np.prod(o)) for o in self.instrs_oshape])
        self.oshape = (int(self._idx[-1]),)
        self.tables = None
        self._templates_dev = None
        self._auto_vjp = None
        self.device = None
        self.dtype = None

    def table_cache_path(self) -> Optional[str]:
        """The disk-cache file of this model's host tables, or None (the
        cache is off, or the model is not window-local in stamp mode: an OTF
        window is too large to key).  The key hashes a port tag, the cache
        version, the code that builds the tables and every input the
        reference hashes (axes, templates, PSF stamps, each band and its
        pointings, the conv configuration, the table dtype)."""
        loc = table_cache_dir()
        if loc is None or not self.stamps:
            return None
        h = hashlib.sha1(f"surfh_tpu_torch host tables v{TABLE_CACHE_VERSION}".encode())
        root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        for rel in _TABLE_SOURCES:
            with open(os.path.join(root, rel), "rb") as fh:
                h.update(fh.read())
        for a in (self.wavelength_axis, self.templates, self.alpha_axis, self.beta_axis,
                  self.psf_stack):
            _hash_array(h, a)
        for instr, pts in zip(self.instrs, self.pointings):
            fov = instr.fov
            h.update(repr((instr.name, instr.n_slit, instr.det_pix_size, fov.alpha_width,
                           fov.beta_width, fov.angle, fov.origin.alpha, fov.origin.beta,
                           getattr(instr.w_blur, "grating_resolution", None))).encode())
            _hash_array(h, instr.wavel_axis)
            _hash_array(h, instr.pce)
            _hash_array(h, np.asarray([(p.alpha, p.beta) for p in pts], np.float64))
        h.update(repr((self.conv_impl, self.conv_freq_rtol, self.conv_rank_rtol,
                       self.conv_precision, self.npdtype.str, self.step_degree, self.gridding,
                       os.environ.get("SURFH_COMPOSED_GRIDDING", "1") != "0")).encode())
        return os.path.join(loc, f"tables_{h.hexdigest()[:20]}.pkl")

    def host_tables(self) -> dict:
        """All model tables as one host tree (NumPy; a materialized `sotf`
        and its windows as given); do not mutate."""
        return self._host

    def to(self, device, dtype=torch.float32, tables: Optional[dict] = None,
           channels: Optional[List[int]] = None):
        """Move the tables (or adopt the given device `tables`, e.g. from
        `convert`) to `device` / `dtype`; stamp-mode OTF windows are
        evaluated there, once.  `channels` (window-local models) moves only
        those channels' tables: the model then applies only them, as a
        rank of `parallel.ShardedSpectro(shard_tables=True)` does."""
        self.device = torch.device(device)
        self.dtype = dtype
        host = self._host
        if channels is not None:
            if not self.window_local:
                raise ValueError("moving a subset of channels needs a window_local model")
            keep = set(channels)
            host = {**host, "chan": tuple(t if c in keep else None for c, t in enumerate(host["chan"]))}
        self.tables = device_tables(host, self.device, dtype) if tables is None else tables
        self._templates_dev = None
        self._auto_vjp = None
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

    def _tpl_w(self, c: int, lo: int, hi: int) -> Optional[torch.Tensor]:
        """Columns lo..hi of channel c's λ-window of the templates [M, hi - lo];
        None in cube mode."""
        if not self.lmm:
            return None
        ws = self.channels[c].wslice
        return self._templates()[:, ws.start + lo : ws.start + hi]

    def _rank_band(self, c: int) -> bool:
        """Channel c convolves through its λ-rank basis (window-local)."""
        return self.window_local and "otf_re" in self.tables["chan"][c]

    def _n_cols(self, c: int) -> int:
        """Channel c's conv columns, as `cols` counts them: its template
        maps for a λ-rank band (R columns of the rows each), else its λ window."""
        return self.ishape[0] if self._rank_band(c) else self.channels[c].n_wslice

    def _conv(self, x, c, cols=None, plain: bool = False):
        """Channel c's conv: maps (or the cube) → its bbox rows [ha·wb, Q].
        `cols` = (lo, hi) keeps only columns lo..hi (:meth:`_n_cols`), as a
        rank of a λ split does.  A W-plane model convolves the channel's λ
        window with its planes of the whole cube's sotf, as a rank of a
        channel split does.  `plain` runs the dense window conv's spectrum
        side in its plain spelling (kernel #9's comparison)."""
        t = self.tables["chan"][c]
        lo, hi = (0, self._n_cols(c)) if cols is None else cols
        if self._rank_band(c):
            return fft.lmm_conv_rank_rows(x[lo:hi], t["otf_re"], t["otf_im"], t["dftm"])
        tpl, ws = self._tpl_w(c, lo, hi), self.channels[c].wslice
        if tpl is None:
            x = x[ws.start + lo : ws.start + hi]
        if self.window_local and "otf" in t:
            o_re, o_im = t["otf"][0][lo:hi], t["otf"][1][lo:hi]
            if tpl is None:
                return fft.conv_otf_matmul_rows(x, o_re, o_im, t["dftm"], plain)
            return fft.lmm_conv_otf_rows(x, tpl, o_re, o_im, t["dftm"], plain)
        return self.channels[c].bbox_rows(fft.conv_otf_chunks(x, self._sotf_w(c, lo, hi), tpl))

    def _conv_t(self, rows, c, cols=None, plain: bool = False):
        """Transpose of :meth:`_conv`: rows → maps (or the λ-window of the
        cube); add it in with :meth:`_add_contrib_` and the same `cols`."""
        t = self.tables["chan"][c]
        lo, hi = (0, self._n_cols(c)) if cols is None else cols
        if self._rank_band(c):
            return fft.lmm_conv_rank_rows_t(rows, t["otf_re"], t["otf_im"], t["dftm"])
        tpl = self._tpl_w(c, lo, hi)
        if self.window_local and "otf" in t:
            o_re, o_im = t["otf"][0][lo:hi], t["otf"][1][lo:hi]
            if tpl is None:
                return fft.conv_otf_matmul_rows_t(rows, o_re, o_im, t["dftm"], plain)
            return fft.lmm_conv_otf_rows_t(rows, tpl, o_re, o_im, t["dftm"], plain)
        cube_w = torch.zeros((hi - lo,) + self.imshape, device=self.device, dtype=self.dtype)
        self.channels[c].add_bbox_rows_(cube_w, rows)
        return fft.conv_otf_chunks_t(cube_w, self._sotf_w(c, lo, hi), tpl)

    def _sotf_w(self, c: int, lo: int, hi: int) -> torch.Tensor:
        """Planes lo..hi of channel c's λ-window OTF: its own table
        (window-local) or the whole cube's sotf (W-plane)."""
        if self.window_local:
            return self.tables["chan"][c]["sotf"][lo:hi]
        ws = self.channels[c].wslice
        return self.tables["sotf"][ws.start + lo : ws.start + hi]

    def _add_contrib_(self, acc, contrib, c, cols=None) -> None:
        """acc += a :meth:`_conv_t` output of columns `cols` (None: all)."""
        lo = 0 if cols is None else cols[0]
        if self.lmm and not self._rank_band(c):
            acc.add_(contrib)
        else:
            start = lo if self.lmm else self.channels[c].wslice.start + lo
            acc[start : start + contrib.shape[0]].add_(contrib)

    @property
    def banded(self) -> bool:
        if self.wblur_impl == "banded" and "band" not in self.tables["chan"][0]:
            raise ValueError("wblur_impl='banded' on a model built dense: no band tables")
        return self.wblur_impl == "banded"

    def _templates(self) -> torch.Tensor:
        """The templates [M, L] on the device (the W-plane tables hold them;
        window-local mode uploads them at first use)."""
        if not self.lmm:
            raise TypeError("cube mode (templates=None): the model has no templates")
        if "templates" in self.tables:
            return self.tables["templates"]
        if self._templates_dev is None:
            self._templates_dev = torch.as_tensor(self.templates).to(self.device, self.dtype)
        return self._templates_dev

    def mapsToCube(self, maps) -> torch.Tensor:
        """T: maps [M, Na, Nb] → cube [L, Na, Nb] (cube mode has no T: raises)."""
        tpl = self._templates()
        return lmm.lmm_maps2cube(self._x(maps), tpl)

    def cubeTomaps(self, cube) -> torch.Tensor:
        """Tᵗ: cube [L, Na, Nb] → maps [M, Na, Nb] (cube mode has no T: raises)."""
        tpl = self._templates()
        cube = torch.as_tensor(cube).to(device=self.device, dtype=self.dtype)
        return lmm.lmm_cube2maps(cube, tpl)

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

    def patch_rows(self, chunks: List[torch.Tensor], c: int) -> torch.Tensor:
        """Channel c's λ-window of the FOV-bbox patch of a cube held as its
        λ-chunks (:meth:`blurred_cube`), laid out pixel-major for the
        gather: [W, ha, wb] → [ha·wb, W] (a copy)."""
        ws = self.channels[c].wslice
        return self.channels[c].bbox_rows(fft.cube_planes(chunks, ws.start, ws.stop))

    def add_patch_rows_(self, cube: torch.Tensor, rows: torch.Tensor, c: int) -> None:
        """Transpose of :meth:`patch_rows`: add rows [ha·wb, W] into `cube`."""
        ws = self.channels[c].wslice
        self.channels[c].add_bbox_rows_(cube[ws.start : ws.stop], rows)

    def blurred_cube(self, x) -> List[torch.Tensor]:
        """C T x (W-plane mode): the templates' cube, or in cube mode the cube
        itself, convolved with the OTF and held as its λ-chunks
        (`fft.conv_otf_chunks`)."""
        return fft.conv_otf_chunks(self._x(x), self.tables["sotf"], self.tables["templates"])

    def forward(self, x, plain: bool = False) -> torch.Tensor:
        """Template maps [M, Na, Nb] (the cube in cube mode) → flat data
        vector.  `plain=True` runs the kernels' plain versions."""
        return self._forward(self._x(x), plain, not self.window_local and self.banded)

    def _forward(self, x: torch.Tensor, plain: bool, banded: bool) -> torch.Tensor:
        outs = []
        if self.window_local:
            for c, chan in enumerate(self.channels):
                with span(self._band_spans[c]):
                    outs.append(chan.forward_rows(self._conv(x, c, plain=plain), self.tables["chan"][c],
                                                  plain).reshape(-1))
        else:
            cube = self.blurred_cube(x)
            for c, chan in enumerate(self.channels):
                with span(self._band_spans[c]):
                    outs.append(chan.forward_rows(self.patch_rows(cube, c), self.tables["chan"][c],
                                                  plain, banded).reshape(-1))
        return torch.cat(outs)

    def adjoint_auto(self, y) -> torch.Tensor:
        """The derived transpose of the forward with the dense blur (the
        reference's `adjoint_auto`, the comparison for the hand-written
        :meth:`adjoint`): `torch.func.vjp` at a zero primal, taken at the
        first call after :meth:`to` and kept.  The forward's row gathers go
        through `GatherRows`, so on the card the transpose runs kernel #1
        on the transposed plans, and a dense window-local band's spectrum
        side kernel #9 (`window_spectrum.Spectrum`)."""
        if self._auto_vjp is None:
            zero = torch.zeros(self.ishape, device=self.device, dtype=self.dtype)
            _, self._auto_vjp = torch.func.vjp(lambda x: self._forward(x, False, False), zero)
        return self._auto_vjp(self._y(y))[0]

    def adjoint(self, y, plain: bool = False) -> torch.Tensor:
        """Transpose of :meth:`forward`: flat data → [M, Na, Nb] (the cube
        in cube mode).  Exact, except the banded blur keeps the transpose
        plan's mask (reference `_adjoint_fn_const` with
        `wblur_sum_beta_t_banded`)."""
        y = self._y(y)
        if self.window_local:
            acc = torch.zeros(self.ishape, device=self.device, dtype=self.dtype)
            for c, chan in enumerate(self.channels):
                with span(self._band_spans[c]):
                    yc = y[int(self._idx[c]) : int(self._idx[c + 1])].view(chan.oshape)
                    self._add_contrib_(acc, self._conv_t(chan.adjoint_rows(yc, self.tables["chan"][c],
                                                                           plain), c, plain=plain), c)
            return acc
        banded = self.banded
        cube = torch.zeros(self.cube_shape, device=self.device, dtype=self.dtype)
        for c, chan in enumerate(self.channels):
            with span(self._band_spans[c]):
                yc = y[int(self._idx[c]) : int(self._idx[c + 1])].view(chan.oshape)
                self.add_patch_rows_(cube, chan.adjoint_rows(yc, self.tables["chan"][c], plain, banded),
                                     c)
        return fft.conv_otf_chunks_t(cube, self.tables["sotf"], self.tables["templates"])

    def normal(self, x, plain: bool = False) -> torch.Tensor:
        """HᵗH x.  Window-local mode fuses fwd∘adj per channel without
        materializing the flat y; W-plane mode is adjoint∘forward."""
        with span(SPAN_NORMAL):
            x = self._x(x)
            if not self.window_local:
                return self.adjoint(self.forward(x, plain), plain)
            acc = torch.zeros_like(x)
            for c, chan in enumerate(self.channels):
                with span(self._band_spans[c]):
                    t = self.tables["chan"][c]
                    yc = chan.forward_rows(self._conv(x, c, plain=plain), t, plain)
                    self._add_contrib_(acc, self._conv_t(chan.adjoint_rows(yc, t, plain), c, plain=plain), c)
            return acc


def _band_span(instr: IFU, c: int) -> str:
    """The span of channel c's part of an application: its instrument's
    name (the IFU's default ``_`` counts as none), else its index."""
    name = str(getattr(instr, "name", "") or "")
    return SPAN_BAND + (name if name not in ("", "_") else str(c))


def _read_cache(path: Optional[str]):
    """The cached (channels, tables, supports) at `path`, or None when there
    is none or it cannot be read (written by another version of a library
    it pickles): the caller then builds the tables and writes them anew."""
    if path is None or not os.path.exists(path):
        return None
    try:
        with open(path, "rb") as fh:
            return pickle.load(fh)
    except (OSError, EOFError, pickle.UnpicklingError, AttributeError, ImportError):
        return None


def _write_cache(path: str, obj) -> None:
    """Pickle `obj` to `path` atomically (a temporary file, then a rename);
    a cache that cannot be written is skipped."""
    tmp = f"{path}.{os.getpid()}.tmp"
    try:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(tmp, "wb") as fh:
            pickle.dump(obj, fh, protocol=pickle.HIGHEST_PROTOCOL)
        os.replace(tmp, path)
    except OSError:
        if os.path.exists(tmp):
            os.remove(tmp)
