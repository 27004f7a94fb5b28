"""Kernel #8: the 2-D real transforms of the W-plane FFT conv, and the
OTF product, in three passes over device memory.

`fft.conv_otf_chunks` / `_t` send every float32 CUDA chunk here (planes of
at most `NMAX` points an axis, by shape; the CPU, float64 and autograd keep
`torch.fft`).  A 2-D transform of real [B, Na, Nb] planes with their half
spectra [B, Na, Kb], Kb = Nb // 2 + 1, is cut into three passes, each one
kernel over a λ-chunk:

* `rows_r2c` — the half spectrum of each real row (the last axis), two
  rows packed into one complex transform, an odd row count padded with a
  zero row;
* `columns_` — complex transforms along Na of every column of a half
  spectrum, in place: forward, then × OTF or conj(OTF) with a scale folded
  in, then inverse, each step where asked (the cube's whole column work is
  one read and one write);
* `rows_c2r` — real rows from Hermitian half spectra, two rows a
  transform (the imaginary parts of bin 0, and of bin Nb / 2 for an even
  Nb, are not read, as `torch.fft.irfft` does not read them), written
  straight into the caller's tensor.

Transforms are unnormalized: forward e^(-2πi nk/N), inverse e^(+2πi nk/N)
without the 1/N.  Every length N ≤ `NMAX` takes the same algorithm
(`plan`): N = n1·n2 split once, Cooley–Tukey (n = q + n1·j, k = n2·k1 + k2);
n1 sums of length n2, each as a product with cosine and sine tables over
the symmetric sums x[j] ± x[n2 − j] (half the multiplies of the plain
sum); then n2 sums of length n1 with the twiddles w^(q·k mod N) folded in.
n1 is chosen to minimise the multiplies, 3 for the flagship's 501 =
3 · 167.  The tables ((cos, sin) of 2π m/n2 over three periods and of
2π m/N) are built in float64 on the host and cast, one set per (N, device,
dtype).  The kernels' design and what bounds them: ``csrc/fft_conv.cu``.

Each pass has a plain PyTorch version (`*_plain`) with the same algorithm
and tables (matmuls for the table sums), which the wrappers take for a CPU
tensor; a CUDA float32 tensor launches the kernel (``csrc/fft_conv.cu``)
or raises, counted in `launches`.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import numpy as np
import torch

NMAX = 2048  # the longest axis the kernels take (a block's shared memory: `plan`)
THREADS = 128  # a block's threads (csrc/fft_conv.cu)
SMEM_MAX = 227 * 1024  # the most dynamic shared memory a block may take on Hopper

launches = 0  # kernel launches since the last reset_launches()


def reset_launches() -> None:
    global launches
    launches = 0


def fits(na: int, nb: int) -> bool:
    """Both axes of a plane within what the kernels take."""
    return 1 <= na <= NMAX and 1 <= nb <= NMAX


@functools.lru_cache(maxsize=None)
def plan(n: int) -> dict:
    """The split of a length-`n` transform and the kernel's block shape:
    n1, n2 (n = n1·n2), ha = n2 // 2 rows of symmetric sums, hk = n2 // 2 + 1
    outputs of each table sum, lines (complex lines a block: 4, or 2 where
    4 do not fit), in_place (four lines, n1 ≤ 4, and a block's threads
    hold the table sums of all its lines at once, 4 k × 2 lines a thread:
    the sums go back into the lines, with no scratch copy) and smem (a
    block's bytes: the lines, n × (lines + 2) complex, their scratch copy
    unless in place, and the tables, 3·n2 + n complex)."""
    if not 1 <= n <= NMAX:
        raise ValueError(f"transform length {n} outside 1..{NMAX}")

    def cost(n1):  # multiplies a line: the table sums, then the length-n1 sums
        n2 = n // n1
        return n1 * (n2 // 2) * (n2 // 2 + 1) + n2 * n1 * n1

    n1 = min((d for d in range(1, n + 1) if n % d == 0), key=cost)
    n2 = n // n1
    hk = n2 // 2 + 1

    def shape(t):  # (in place, shared bytes) of `t` lines a block
        in_place = t == 4 and n1 <= 4 and -(-hk // 4) * (n1 * t // 2) <= THREADS
        return in_place, ((1 if in_place else 2) * n * (t + 2) + 3 * n2 + n) * 8

    lines = next(t for t in (4, 2) if shape(t)[1] <= SMEM_MAX)
    in_place, smem = shape(lines)
    return {"n": n, "n1": n1, "n2": n2, "ha": n2 // 2, "hk": hk, "lines": lines,
            "in_place": in_place, "smem": smem}


def fft_flops(n: int) -> float:
    """The operations of one complex length-`n` transform by the usual
    count, 5·n·log2(n), whatever the algorithm: what a bound is computed
    from (`line_flops` is the kernels' own count, for their issue rate)."""
    return 5.0 * n * np.log2(n)


def line_flops(n: int) -> int:
    """FP32 operations of one length-`n` line as the kernels compute it
    (an FMA two): the symmetric sums, the table sums (4 FMAs a j and k),
    the assembly of Y, the length-n1 sums with their twiddles."""
    p = plan(n)
    n1, n2, ha, hk = p["n1"], p["n2"], p["ha"], p["hk"]
    return 4 * n1 * ((n2 - 1) // 2) + 8 * n1 * ha * hk + 10 * n1 * hk + 8 * n1 * n


@functools.lru_cache(maxsize=None)
def host_tables(n: int) -> Tuple[np.ndarray, np.ndarray]:
    """float64 (ct [3·n2, 2], tw [n, 2]): (cos, sin)(2π m/n2) for m < 3·n2
    (three periods: the table sums read entry j·k0 mod n2 + u·j, u < 4,
    without a second reduction) and (cos, sin)(2π m/n) for m < n, the
    angles reduced in integers and exact zeros kept exact."""
    n2 = plan(n)["n2"]

    def cos_sin(m, length):
        ang = 2.0 * np.pi * (m % length) / length
        cs = np.stack([np.cos(ang), np.sin(ang)], axis=-1)
        cs[np.abs(cs) < 1e-12] = 0.0
        return cs

    return cos_sin(np.arange(3 * n2), n2), cos_sin(np.arange(n), n)


_tables: dict = {}


def tables(n: int, device, dtype=torch.float32) -> Tuple[torch.Tensor, torch.Tensor]:
    """`host_tables(n)` on `device` in `dtype`, cast once and kept."""
    key = (n, torch.device(device), dtype)
    if key not in _tables:
        _tables[key] = tuple(torch.as_tensor(t).to(device=device, dtype=dtype).contiguous()
                             for t in host_tables(n))
    return _tables[key]


# ---------------------------------------------------------------------------
# the plain versions: the kernels' algorithm and tables, in torch


def dft_lines_plain(z: torch.Tensor, inverse: bool = False) -> torch.Tensor:
    """The unnormalized DFT of each line of `z` [..., N] (complex), by the
    kernels' algorithm: the symmetric sums, the table products, the
    length-n1 sums with their twiddles."""
    n = z.shape[-1]
    p = plan(n)
    n1, n2, ha, hk = p["n1"], p["n2"], p["ha"], p["hk"]
    ct, tw = tables(n, z.device, z.real.dtype)
    lead = z.shape[:-1]
    x = z.reshape(-1, n2, n1).transpose(1, 2)  # [B, n1, n2]: point q + n1·j at [:, q, j]
    j = torch.arange(1, ha + 1, device=z.device)
    u, v = x[..., j], x[..., n2 - j]
    pair = (j < n2 - j)  # an even n2's middle point is not paired: a = x[n2/2], b unused
    a = torch.where(pair, u + v, u)
    b = torch.where(pair, u - v, u)
    jk = (j[:, None] * torch.arange(hk, device=z.device)) % n2
    c, s = ct[jk, 0], ct[jk, 1]  # [ha, hk]: cos, sin (2π j k / n2)
    ar = x[..., :1].real + a.real @ c
    ai = x[..., :1].imag + a.imag @ c
    br, bi = b.real @ s, b.imag @ s
    sgn = -1.0 if inverse else 1.0  # Y[k] = A − i·B forward, A + i·B inverse
    y = torch.empty(x.shape, dtype=z.dtype, device=z.device)
    y[..., :hk] = torch.complex(ar + sgn * bi, ai - sgn * br)
    k = torch.arange(1, hk, device=z.device)
    k = k[k < n2 - k]
    y[..., n2 - k] = torch.complex(ar[..., k] - sgn * bi[..., k], ai[..., k] + sgn * br[..., k])
    kk = torch.arange(n, device=z.device)
    m = (torch.arange(n1, device=z.device)[:, None] * kk) % n  # w^(q·k mod n)
    w = torch.complex(tw[m, 0], -sgn * tw[m, 1])
    out = (y[..., kk % n2] * w).sum(-2)
    return out.reshape(lead + (n,))


def rows_r2c_plain(x: torch.Tensor) -> torch.Tensor:
    """Half spectra [..., Kb] of the real rows of `x` [..., Nb]: rows 2i and
    2i + 1 as the real and imaginary parts of one transform Z, then
    H₂ᵢ = (Z[k] + conj Z[−k]) / 2 and H₂ᵢ₊₁ = (Z[k] − conj Z[−k]) / 2i."""
    nb = x.shape[-1]
    kb = nb // 2 + 1
    r = x.reshape(-1, nb)
    rows = r.shape[0]
    if rows % 2:
        r = torch.cat([r, r.new_zeros(1, nb)])
    zf = dft_lines_plain(torch.complex(r[0::2], r[1::2]))
    k = torch.arange(kb, device=x.device)
    z, zr = zf[:, k], zf[:, (nb - k) % nb]
    h0 = torch.complex(0.5 * (z.real + zr.real), 0.5 * (z.imag - zr.imag))
    h1 = torch.complex(0.5 * (z.imag + zr.imag), 0.5 * (zr.real - z.real))
    return torch.stack([h0, h1], 1).reshape(-1, kb)[:rows].reshape(x.shape[:-1] + (kb,))


def rows_c2r_plain(h: torch.Tensor, nb: int) -> torch.Tensor:
    """Real rows [..., Nb] of the Hermitian half spectra `h` [..., Kb]: rows
    2i and 2i + 1 packed as Z = H₂ᵢ + i·H₂ᵢ₊₁ (each extended by
    H[Nb − m] = conj H[m]), one inverse transform, its real and imaginary
    parts.  The imaginary parts of bin 0 and of an even Nb's bin Nb / 2 are
    not read."""
    kb = nb // 2 + 1
    if h.shape[-1] != kb:
        raise ValueError(f"half spectra of {h.shape[-1]} bins are not those of {nb}-point rows")
    r = h.reshape(-1, kb)
    rows = r.shape[0]
    if rows % 2:
        r = torch.cat([r, r.new_zeros(1, kb)])
    a, b = r[0::2].clone(), r[1::2].clone()
    real_bins = [0] + ([nb // 2] if nb % 2 == 0 else [])
    a.imag[:, real_bins] = 0
    b.imag[:, real_bins] = 0
    z = torch.empty((a.shape[0], nb), dtype=h.dtype, device=h.device)
    z[:, :kb] = torch.complex(a.real - b.imag, a.imag + b.real)
    m = torch.arange(1, kb, device=h.device)
    m = m[m < nb - m]
    z[:, nb - m] = torch.complex(a.real[:, m] + b.imag[:, m], b.real[:, m] - a.imag[:, m])
    zt = dft_lines_plain(z, inverse=True)
    return torch.stack([zt.real, zt.imag], 1).reshape(-1, nb)[:rows].reshape(h.shape[:-1] + (nb,))


def columns_plain(s: torch.Tensor, otf: Optional[torch.Tensor] = None, *, forward: bool,
                  inverse: bool, conj: bool = False, scale: float = 1.0) -> torch.Tensor:
    """The column pass on `s` [B, Na, Kb] (complex), in place: the forward
    transform along Na, × scale·OTF (or its conjugate), the inverse
    transform, each where asked; returns `s`."""
    z = s.transpose(-1, -2)
    if forward:
        z = dft_lines_plain(z)
    if otf is not None:
        o = otf.conj() if conj else otf
        z = z * torch.complex(o.real * scale, o.imag * scale).transpose(-1, -2)
    if inverse:
        z = dft_lines_plain(z, inverse=True)
    s.copy_(z.transpose(-1, -2))
    return s


# ---------------------------------------------------------------------------
# the kernels

_FWD, _MUL, _CONJ, _INV = 1, 2, 4, 8  # the column pass's steps (csrc/fft_conv.cu)
_fns: dict = {}


def load_kernels() -> dict:
    """Build (first call) and bind the three C entry points."""
    if not _fns:
        from ._build import build_library

        lib = build_library("fft_conv", ["fft_conv.cu"])
        ptr, ll, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        plan_args = [i32] * 4 + [ptr] * 2  # n1, n2, lines, smem; ct, tw
        for name, args in (("rows_r2c", [ptr, ptr, ll, i32]),
                           ("rows_c2r", [ptr, ptr, ll, i32]),
                           ("cols", [ptr, ptr, ll, i32, i32, i32, ctypes.c_float])):
            fn = getattr(lib, f"surfh_fft_{name}_f32")
            fn.argtypes = args + plan_args + [ptr]
            fn.restype = ctypes.c_int
            _fns[name] = fn
    return _fns


def _launch(name: str, n: int, device: torch.device, *args) -> None:
    p = plan(n)
    ct, tw = tables(n, device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = load_kernels()[name](*args, p["n1"], p["n2"], p["lines"], p["smem"],
                                   ct.data_ptr(), tw.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"fft_conv {name} kernel launch failed: cudaError {err}")
    global launches
    launches += 1


def _check(name: str, t: torch.Tensor, dtype: torch.dtype) -> None:
    if t.dtype != dtype:
        raise TypeError(f"fft_conv kernel: {name} is {t.dtype}, not {dtype}")
    if not t.is_contiguous():
        raise ValueError(f"fft_conv kernel: {name} must be contiguous")


def _on_card(x: torch.Tensor) -> bool:
    """CPU → the plain version; a CUDA tensor → the kernel (float32 only)."""
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"fft_conv: no kernel for {x.device}")
    return True


def rows_r2c(x: torch.Tensor, out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Half spectra [..., Kb] of the real rows of `x` [..., Nb] (written into
    `out` where given).  CPU: `rows_r2c_plain`."""
    nb = x.shape[-1]
    shape = x.shape[:-1] + (nb // 2 + 1,)
    if not _on_card(x):
        h = rows_r2c_plain(x)
        return h if out is None else out.copy_(h)
    _check("x", x, torch.float32)
    out = torch.empty(shape, dtype=torch.complex64, device=x.device) if out is None else out
    _check("out", out, torch.complex64)
    if out.shape != shape or out.device != x.device:
        raise ValueError(f"fft_conv rows_r2c: out {tuple(out.shape)} is not {tuple(shape)} on {x.device}")
    if x.numel():
        _launch("rows_r2c", nb, x.device, x.data_ptr(), out.data_ptr(), x.numel() // nb, nb)
    return out


def rows_c2r(h: torch.Tensor, nb: int, out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Real rows [..., Nb] of the Hermitian half spectra `h` [..., Kb]
    (written into `out` where given).  CPU: `rows_c2r_plain`."""
    shape = h.shape[:-1] + (nb,)
    if h.shape[-1] != nb // 2 + 1:
        raise ValueError(f"half spectra of {h.shape[-1]} bins are not those of {nb}-point rows")
    if not _on_card(h):
        r = rows_c2r_plain(h, nb)
        return r if out is None else out.copy_(r)
    _check("h", h, torch.complex64)
    out = torch.empty(shape, dtype=torch.float32, device=h.device) if out is None else out
    _check("out", out, torch.float32)
    if out.shape != shape or out.device != h.device:
        raise ValueError(f"fft_conv rows_c2r: out {tuple(out.shape)} is not {tuple(shape)} on {h.device}")
    if h.numel():
        _launch("rows_c2r", nb, h.device, h.data_ptr(), out.data_ptr(), h.numel() // h.shape[-1], nb)
    return out


def columns_(s: torch.Tensor, otf: Optional[torch.Tensor] = None, *, forward: bool,
             inverse: bool, conj: bool = False, scale: float = 1.0) -> torch.Tensor:
    """The column pass on `s` [B, Na, Kb] in place (`columns_plain`'s
    steps); `otf` is [B, Na, Kb] like `s`, or None for no product (then
    `conj` and `scale` are not taken).  CPU: `columns_plain`."""
    if otf is None and (conj or scale != 1.0):
        raise ValueError("fft_conv columns_: conj and scale belong to the OTF product")
    if otf is not None and otf.shape != s.shape:
        raise ValueError(f"fft_conv columns_: otf {tuple(otf.shape)} is not s's {tuple(s.shape)}")
    if s.dim() != 3:
        raise ValueError(f"fft_conv columns_: s must be [B, Na, Kb], not {tuple(s.shape)}")
    if not _on_card(s):
        return columns_plain(s, otf, forward=forward, inverse=inverse, conj=conj, scale=scale)
    _check("s", s, torch.complex64)
    flags = (_FWD if forward else 0) | (_INV if inverse else 0)
    if otf is not None:
        _check("otf", otf, torch.complex64)
        if otf.device != s.device:
            raise ValueError(f"fft_conv columns_: otf on {otf.device}, s on {s.device}")
        flags |= _MUL | (_CONJ if conj else 0)
    b, na, kb = s.shape
    if s.numel() and flags:
        _launch("cols", na, s.device, s.data_ptr(), 0 if otf is None else otf.data_ptr(), b * kb,
                na, kb, flags, float(scale))
    return s
