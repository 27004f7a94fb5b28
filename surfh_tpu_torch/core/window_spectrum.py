"""The dense window-local conv's spectrum side, one pass a direction
(kernel #9, ``csrc/window_spectrum.cu``).

Per band of W λ planes on Ka'·Kb' kept bins, between the M maps' spectra
(`fft._dft_maps` / `_dft_maps_t`) and the inverse α stage's Gauss-3M
GEMMs (`fft._idft_rows` / `_idft_rows_t`):

* `spectrum` — the templates' mix ``zw[w] = Σ_m tpl[m, w]·zm[m]``, the
  OTF product ``t = zw·otf[w]``, and the α stage's pre-add: returns
  (t_re, t_im, t_re + t_im) [W, Ka', Kb'];
* `spectrum_t` — from the transpose α stage's three products (k1, pd, ps):
  ``t_re = k1 + pd``, ``t_im = k1 − ps``, the conj-OTF product and the
  mix's transpose ``zm[m] = Σ_w tpl[m, w]·zw[w]``: returns (re, im)
  [M, Ka', Kb'].

Cube mode (``tpl=None``) has no mix: the forward takes the planes' own
spectra [W, Ka', Kb'] and the transpose returns [W, Ka', Kb'].

Each has a plain spelling (`spectrum_plain`, `spectrum_t_plain`: the eager
expressions the pair spelled before, the mix as GEMMs), which a CPU tensor
takes, or any tensor with ``plain=True`` (the models' comparison on the
card).  Otherwise a CUDA tensor launches the kernel or raises (float32,
the spectra contiguous, the OTF planes flat in their bins with any bin
step — a real or imaginary view of a complex table is taken as it is —,
the templates' columns contiguous, at most `MAX_MAPS` maps, no gradient
asked of the OTF or the templates): `launches` counts the kernels,
`launches_sum` the transpose's second pass that adds the partial sums of a
split.  The kernels do the eager chain's float32 operations in its order;
only the mix sums take another order than cuBLAS's (see the source).

On the card the two directions carry each other's gradient in the spectra
(`Spectrum`, `SpectrumT`): the forward's VJP is the transpose kernel and
the transpose's is the forward, so `torch.func.vjp` of a model's forward
(`SpectroSigRLSCT.adjoint_auto`) runs #9 as well.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

THREADS = 256  # a block's threads, one bin each (csrc/window_spectrum.cu)
MAX_MAPS = 8  # the templates a launch takes
MAX_SPLIT = 65535  # the grid's y extent
BLOCKS_PER_SM = 4  # blocks an SM holds at once (≤ 64 registers a thread): one wave, `launch_split`

launches = 0  # kernel launches (forward and transpose) since the last reset_launches()
launches_sum = 0  # the transpose's partial-sum passes since the last reset_launches()


def reset_launches() -> None:
    global launches, launches_sum
    launches = launches_sum = 0


def launch_split(w: int, nbins: int, n_sm: int) -> int:
    """The runs the W planes are cut into (the grid's y extent): the most
    whose blocks still fit the card in one wave of `BLOCKS_PER_SM` an SM,
    at least 1, at most W.  A second, partial wave would leave most SMs
    idle while it runs (measured on the flagship's bands: one wave is
    faster in both directions than the fewest runs that fill the card)."""
    blocks = max(1, -(-nbins // THREADS))
    return max(1, min(w, MAX_SPLIT, BLOCKS_PER_SM * n_sm // blocks))


def spectrum_plain(zm_re, zm_im, otf_re, otf_im, tpl=None):
    """The forward in eager torch: (t_re, t_im, t_re + t_im)."""
    if tpl is None:
        zw_re, zw_im = zm_re, zm_im
    else:
        n_map, ka, kb = zm_re.shape
        zw_re = (tpl.T @ zm_re.reshape(n_map, -1)).view(-1, ka, kb)  # 'mck,mw->wck'
        zw_im = (tpl.T @ zm_im.reshape(n_map, -1)).view(-1, ka, kb)
    t_re = zw_re * otf_re - zw_im * otf_im
    t_im = zw_re * otf_im + zw_im * otf_re
    return t_re, t_im, t_re + t_im


def spectrum_t_plain(k1, pd, ps, otf_re, otf_im, tpl=None):
    """The transpose in eager torch: (re, im) of the maps' (or planes') spectra."""
    t_re, t_im = k1 + pd, k1 - ps
    zw_re = t_re * otf_re + t_im * otf_im
    zw_im = -t_re * otf_im + t_im * otf_re
    if tpl is None:
        return zw_re, zw_im
    w, ka, kb = zw_re.shape
    return ((tpl @ zw_re.reshape(w, -1)).view(-1, ka, kb),  # 'wck,mw->mck'
            (tpl @ zw_im.reshape(w, -1)).view(-1, ka, kb))


class Spectrum(torch.autograd.Function):
    """`spectrum_cuda` with a gradient in the spectra: the VJP of
    (t_re, t_im, t_re + t_im) is the transpose on (k1, pd, ps) = (g_sum,
    g_re, −g_im), itself a `SpectrumT` (so twice differentiable)."""

    @staticmethod
    def forward(zm_re, zm_im, otf_re, otf_im, tpl):
        return spectrum_cuda(zm_re, zm_im, otf_re, otf_im, tpl)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.tables = inputs[2:]

    @staticmethod
    def backward(ctx, g_re, g_im, g_sum):
        z_re, z_im = SpectrumT.apply(g_sum.contiguous(), g_re.contiguous(), (-g_im).contiguous(), *ctx.tables)
        return z_re, z_im, None, None, None


class SpectrumT(torch.autograd.Function):
    """`spectrum_t_cuda` with a gradient in the α-stage products: the VJP
    is the forward on the maps' gradient, (t_re, t_im, t_sum) → (g_k1,
    g_pd, g_ps) = (t_sum, t_re, −t_im), itself a `Spectrum`."""

    @staticmethod
    def forward(k1, pd, ps, otf_re, otf_im, tpl):
        return spectrum_t_cuda(k1, pd, ps, otf_re, otf_im, tpl)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.tables = inputs[3:]

    @staticmethod
    def backward(ctx, g_re, g_im):
        t_re, t_im, t_sum = Spectrum.apply(g_re.contiguous(), g_im.contiguous(), *ctx.tables)
        return t_sum, t_re, -t_im, None, None, None


def _tables_take_no_gradient(otf_re, otf_im, tpl) -> None:
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in (otf_re, otf_im, tpl)):
        raise ValueError("window_spectrum kernel: no gradient in the OTF or the templates; "
                         "take the plain spelling (plain=True) to differentiate in them")


def spectrum(zm_re, zm_im, otf_re, otf_im, tpl=None, plain: bool = False):
    """The forward: the plain spelling for a CPU tensor or with `plain`,
    else kernel #9 (`Spectrum`)."""
    if plain or not zm_re.is_cuda:
        return spectrum_plain(zm_re, zm_im, otf_re, otf_im, tpl)
    _tables_take_no_gradient(otf_re, otf_im, tpl)
    return Spectrum.apply(zm_re, zm_im, otf_re, otf_im, tpl)


def spectrum_t(k1, pd, ps, otf_re, otf_im, tpl=None, plain: bool = False):
    """The transpose: the plain spelling for a CPU tensor or with `plain`,
    else kernel #9 (`SpectrumT`)."""
    if plain or not k1.is_cuda:
        return spectrum_t_plain(k1, pd, ps, otf_re, otf_im, tpl)
    _tables_take_no_gradient(otf_re, otf_im, tpl)
    return SpectrumT.apply(k1, pd, ps, otf_re, otf_im, tpl)


_fns = None


def bind(lib: ctypes.CDLL):
    """The kernels' C entry points (forward, transpose) of a library built
    from ``csrc/window_spectrum.cu``, their argument types set."""
    p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    fwd, t = lib.surfh_window_spectrum_f32, lib.surfh_window_spectrum_t_f32
    fwd.argtypes = [p, p, p, ll, i, p, p, ll, i, p, i, ll, i, p]
    t.argtypes = [p, p, p, p, ll, i, p, p, ll, i, p, p, i, ll, i, p]
    fwd.restype = t.restype = ctypes.c_int
    return fwd, t


def load_kernels():
    """Build (first call) and bind the kernels' C entry points."""
    global _fns
    if _fns is None:
        from ._build import build_library

        _fns = bind(build_library("window_spectrum", ["window_spectrum.cu"]))
    return _fns


def _operands(planes, otf_re, otf_im, tpl) -> Tuple[int, int, int, Tuple[int, int, int]]:
    """Check what both kernels read; (W, Ka', Kb', (plane stride, bin step,
    template row stride)) of the OTF window and the templates."""
    dev = planes[0].device
    named = [(f"spectrum {k}", t) for k, t in enumerate(planes)] + [("otf_re", otf_re), ("otf_im", otf_im)]
    if tpl is not None:
        named.append(("tpl", tpl))
    for name, t in named:
        if not isinstance(t, torch.Tensor) or t.device != dev:
            raise ValueError(f"window_spectrum kernel: {name} must be a tensor on {dev}")
        if t.dtype != torch.float32:
            raise TypeError(f"window_spectrum kernel is f32 only ({name} is {t.dtype})")
    if otf_re.dim() != 3 or otf_im.shape != otf_re.shape or otf_im.stride() != otf_re.stride():
        raise ValueError(f"window_spectrum kernel: OTF planes {tuple(otf_re.shape)} / "
                         f"{tuple(otf_im.shape)} are not one [W, Ka', Kb'] layout")
    w, ka, kb = (int(s) for s in otf_re.shape)
    step = otf_re.stride(2) if kb > 1 else 1
    if step < 1 or (ka > 1 and otf_re.stride(1) != kb * step):
        raise ValueError(f"window_spectrum kernel: the OTF's bins are not flat (strides {otf_re.stride()})")
    ld = 0
    if tpl is not None:
        if tpl.dim() != 2 or tpl.shape[1] != w or not 1 <= tpl.shape[0] <= MAX_MAPS:
            raise ValueError(f"window_spectrum kernel: templates {tuple(tpl.shape)} are not "
                             f"[M ≤ {MAX_MAPS}, W = {w}]")
        if w > 1 and tpl.stride(1) != 1:
            raise ValueError("window_spectrum kernel needs the templates' columns contiguous")
        ld = tpl.stride(0)
    return w, ka, kb, (otf_re.stride(0), step, ld)


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def _n_sm(dev) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def spectrum_cuda(zm_re, zm_im, otf_re, otf_im, tpl=None):
    """Kernel #9's forward on the current stream: (t_re, t_im, t_re + t_im),
    views of one new [3, W, Ka', Kb'] tensor (no gradient: `spectrum`
    carries it)."""
    if not zm_re.is_cuda:
        raise ValueError("window_spectrum kernel needs CUDA tensors")
    w, ka, kb, (o_plane, step, ld) = _operands((zm_re, zm_im), otf_re, otf_im, tpl)
    n_map = 0 if tpl is None else int(tpl.shape[0])
    want = (n_map if tpl is not None else w, ka, kb)
    for t in (zm_re, zm_im):
        if tuple(t.shape) != want or not t.is_contiguous():
            raise ValueError(f"window_spectrum kernel: spectra {tuple(t.shape)} are not contiguous {want}")
    out = torch.empty((3, w, ka, kb), dtype=torch.float32, device=zm_re.device)
    nbins = ka * kb
    if w and nbins:
        split = launch_split(w, nbins, _n_sm(zm_re.device))
        with torch.cuda.device(zm_re.device):
            err = load_kernels()[0](zm_re.data_ptr(), zm_im.data_ptr(), 0 if tpl is None else tpl.data_ptr(),
                                    ld, n_map, otf_re.data_ptr(), otf_im.data_ptr(), o_plane, step,
                                    out.data_ptr(), w, nbins, split, _stream(zm_re.device))
        if err != 0:
            raise RuntimeError(f"window_spectrum kernel launch failed: cudaError {err}")
        global launches
        launches += 1
    return out[0], out[1], out[2]


def spectrum_t_cuda(k1, pd, ps, otf_re, otf_im, tpl=None):
    """Kernel #9's transpose on the current stream: (re, im), views of one
    new [2, M, Ka', Kb'] tensor ([2, W, Ka', Kb'] in cube mode; no
    gradient: `spectrum_t` carries it)."""
    if not k1.is_cuda:
        raise ValueError("window_spectrum kernel needs CUDA tensors")
    w, ka, kb, (o_plane, step, ld) = _operands((k1, pd, ps), otf_re, otf_im, tpl)
    for t in (k1, pd, ps):
        if tuple(t.shape) != (w, ka, kb) or not t.is_contiguous():
            raise ValueError(f"window_spectrum kernel: α-stage products {tuple(t.shape)} are not "
                             f"contiguous {(w, ka, kb)}")
    n_map = 0 if tpl is None else int(tpl.shape[0])
    rows = n_map if tpl is not None else w
    nbins = ka * kb
    if not (w and nbins):
        return torch.zeros((2, rows, ka, kb), dtype=torch.float32, device=k1.device).unbind(0)
    out = torch.empty((2, rows, ka, kb), dtype=torch.float32, device=k1.device)
    split = launch_split(w, nbins, _n_sm(k1.device))
    summed = n_map > 0 and split > 1
    parts = torch.empty((split, 2, n_map, nbins), dtype=torch.float32, device=k1.device) if summed else None
    with torch.cuda.device(k1.device):
        err = load_kernels()[1](k1.data_ptr(), pd.data_ptr(), ps.data_ptr(),
                                0 if tpl is None else tpl.data_ptr(), ld, n_map, otf_re.data_ptr(),
                                otf_im.data_ptr(), o_plane, step, out.data_ptr(),
                                0 if parts is None else parts.data_ptr(), w, nbins, split,
                                _stream(k1.device))
    if err != 0:
        raise RuntimeError(f"window_spectrum kernel launch failed: cudaError {err}")
    global launches, launches_sum
    launches += 1
    launches_sum += int(summed)
    return out[0], out[1]
