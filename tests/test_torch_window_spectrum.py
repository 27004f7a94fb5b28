"""Kernel #9 (`core/window_spectrum.py`, ``csrc/window_spectrum.cu``): the
dense window conv's spectrum side, one pass a direction.

* float64 on the CPU: the pair (`fft.lmm_conv_otf_rows` / `_t`, cube mode
  `fft.conv_otf_matmul_rows` / `_t`) composed with the plain spelling
  equals the eager chain it replaced (spelled out below) to 1e-12, on
  contiguous OTF planes and on the real / imaginary views of a complex
  table with a column range of the templates; the route (a CPU tensor
  takes the plain spelling, a card tensor the kernel unless `plain`, and
  what the kernel does not take raises); `launch_split`; the models'
  `plain` reaching the pair; the gradient's Functions with the plain
  spelling in the kernels' place.
* The kernels' source on the CPU: ``csrc/window_spectrum.cu`` compiled by
  g++ behind a header that stands in for the CUDA runtime (each launch a
  loop over the grid's blocks and threads, the intrinsics their plain C++
  operations, no FMA contraction), driven through the wrappers: the
  indexing, the split and its partial sums, the views, the arguments'
  marshalling, against the plain spelling.
* On the card (``-m cuda``): each kernel against the plain spelling at
  every band's (W, Ka', Kb') of the 12-band flagship, with and without the
  templates' mix; the split path's bits run to run; the views; the
  launches of a dense window-local normal, and none on the rank and
  W-plane models.

No JAX here: the card cases run on the GPU machine, which has none
(``python -m pytest --noconftest tests/test_torch_window_spectrum.py -m cuda``).
"""

import contextlib
import ctypes
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from surfh_tpu_torch.core import fft
from surfh_tpu_torch.core import window_spectrum as ws

torch.set_num_threads(2)

TOL = 1e-12
# float32 against the float64 plain spelling: the mix sums take another
# order than cuBLAS's.  A sum of W ≤ 613 float32 terms carries a rounding
# error that grows like 2^-24·W/√2 of a term (~2.5e-5), ~1e-6 of the
# largest sum over a band's bins; each product and add of the chain rounds
# once (2^-24).  Neither sum order is exact, so the bound is on both.
F32_TOL = 1e-5

# (W, Ka', Kb') of each band of the 12-band flagship at conv_freq_rtol 1e-6
# (`benchmark/bench/gemm_work.py::band_macs` on `flagship-wlocal`)
FLAGSHIP = {"1a": (425, 485, 243), "1b": (564, 431, 216), "1c": (613, 371, 186),
            "2a": (475, 323, 162), "2b": (484, 279, 140), "2c": (524, 241, 121),
            "3a": (352, 501, 251), "3b": (364, 501, 251), "3c": (399, 501, 251),
            "4a": (252, 501, 251), "4b": (241, 501, 251), "4c": (249, 501, 251)}


def rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.to(b.dtype) - b).abs().max() / b.abs().max())


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


# ---------------------------------------------------------------------------
# the eager chain the pair spelled before kernel #9


def _eager_idft_rows(t_re, t_im, m):
    ha, wb = m["ifa_re"].shape[0], m["icb_re"].shape[0]
    k1 = m["ifa_re"] @ (t_re + t_im)
    ua_re = k1 - m["ifa_s"] @ t_im
    ua_im = k1 + m["ifa_d"] @ t_re
    out = m["icb_re"] @ ua_re.permute(1, 2, 0) - m["icb_im"] @ ua_im.permute(1, 2, 0)
    return out.view(ha * wb, -1)


def _eager_idft_rows_t(g, m):
    ha, wb = m["ifa_re"].shape[0], m["icb_re"].shape[0]
    g_t = g.view(ha, wb, -1).transpose(1, 2)
    ua_re = (g_t @ m["icb_re"]).transpose(0, 1)
    ua_im = -(g_t @ m["icb_im"]).transpose(0, 1)
    k1 = m["ifa_re"].T @ (ua_re + ua_im)
    return k1 + m["ifa_d"].T @ ua_im, k1 - m["ifa_s"].T @ ua_re


def _eager(direction, kind, arg, tpl, otf_re, otf_im, m):
    if direction == "forward":
        zm_re, zm_im = fft._dft_maps(arg, m)
        if kind == "lmm":
            n_map, ka, kb = zm_re.shape
            zw_re = (tpl.T @ zm_re.reshape(n_map, -1)).view(-1, ka, kb)
            zw_im = (tpl.T @ zm_im.reshape(n_map, -1)).view(-1, ka, kb)
        else:
            zw_re, zw_im = zm_re, zm_im
        return _eager_idft_rows(zw_re * otf_re - zw_im * otf_im, zw_re * otf_im + zw_im * otf_re, m)
    t_re, t_im = _eager_idft_rows_t(arg, m)
    zw_re = t_re * otf_re + t_im * otf_im
    zw_im = -t_re * otf_im + t_im * otf_re
    if kind == "lmm":
        w, ka, kb = zw_re.shape
        zw_re = (tpl @ zw_re.reshape(w, -1)).view(-1, ka, kb)
        zw_im = (tpl @ zw_im.reshape(w, -1)).view(-1, ka, kb)
    return fft._dft_maps_t(zw_re, zw_im, m)


def _problem(layout, seed=0, dtype=torch.float64):
    """A band's window: W = 7 planes of 23 × 20 on 6 × 5 kept bins, a 9 × 8
    bbox, 3 templates.  "views": the OTF the real and imaginary views of a
    complex [W, Ka', Kb'] table, the templates a column range of wider ones."""
    g = _gen(seed)
    na, nb, w, n_map = 23, 20, 7, 3
    m = {k: torch.as_tensor(v) for k, v in
         fft.dft_matmul_tables((na, nb), np.float64, ka_max=6, kb_keep=5, bbox=(3, 4, 9, 8)).items()}
    m = {k: v.to(dtype) for k, v in m.items()}
    ka, kb = m["fa_re"].shape[0], m["fb_re"].shape[0]
    otf = torch.complex(torch.randn((w, ka, kb), generator=g, dtype=dtype),
                        torch.randn((w, ka, kb), generator=g, dtype=dtype))
    tpl = torch.rand((n_map, w + 5), generator=g, dtype=dtype)
    if layout == "views":
        otf_re, otf_im, tpl = otf.real, otf.imag, tpl[:, 2 : 2 + w]
    else:
        otf_re, otf_im, tpl = otf.real.contiguous(), otf.imag.contiguous(), tpl[:, :w].contiguous()
    maps = torch.rand((n_map, na, nb), generator=g, dtype=dtype)
    x = torch.rand((w, na, nb), generator=g, dtype=dtype)
    rows = torch.randn((9 * 8, w), generator=g, dtype=dtype)
    return dict(m=m, otf=(otf_re, otf_im), tpl=tpl, maps=maps, x=x, rows=rows)


def _pair(direction, kind, p, plain=False):
    """(the pair's output, the eager chain's) on problem `p`."""
    tpl = p["tpl"] if kind == "lmm" else None
    arg = p["rows"] if direction == "transpose" else (p["maps"] if kind == "lmm" else p["x"])
    fn = {("forward", "lmm"): lambda: fft.lmm_conv_otf_rows(arg, tpl, *p["otf"], p["m"], plain),
          ("transpose", "lmm"): lambda: fft.lmm_conv_otf_rows_t(arg, tpl, *p["otf"], p["m"], plain),
          ("forward", "cube"): lambda: fft.conv_otf_matmul_rows(arg, *p["otf"], p["m"], plain),
          ("transpose", "cube"): lambda: fft.conv_otf_matmul_rows_t(arg, *p["otf"], p["m"], plain)}
    return fn[(direction, kind)](), _eager(direction, kind, arg, tpl, *p["otf"], p["m"])


@pytest.mark.parametrize("layout", ["contiguous", "views"])
@pytest.mark.parametrize("kind", ["lmm", "cube"])
@pytest.mark.parametrize("direction", ["forward", "transpose"])
def test_the_pair_is_the_eager_chain(direction, kind, layout):
    """float64 on the CPU: the pair through the plain spelling is the eager
    chain it replaced, with no kernel launched."""
    p = _problem(layout, seed=len(direction) + len(kind))
    before = (ws.launches, ws.launches_sum)
    got, want = _pair(direction, kind, p)
    assert got.shape == want.shape
    assert rel(got, want) <= TOL
    assert (ws.launches, ws.launches_sum) == before


@pytest.mark.parametrize("kind", ["lmm", "cube"])
def test_the_plain_spellings_are_the_eager_expressions(kind):
    """`spectrum_plain` / `spectrum_t_plain` bit for bit the expressions the
    pair spelled inline, in float32 (their order of operations)."""
    g = _gen(3)
    w, ka, kb, n_map = 6, 5, 4, 2
    o_re, o_im = torch.randn((2, w, ka, kb), generator=g).unbind(0)
    tpl = torch.rand((n_map, w), generator=g) if kind == "lmm" else None
    z_re, z_im = torch.randn((2, n_map if tpl is not None else w, ka, kb), generator=g).unbind(0)
    if tpl is None:
        zw_re, zw_im = z_re, z_im
    else:
        zw_re = (tpl.T @ z_re.reshape(n_map, -1)).view(-1, ka, kb)
        zw_im = (tpl.T @ z_im.reshape(n_map, -1)).view(-1, ka, kb)
    t_re, t_im, t_sum = ws.spectrum_plain(z_re, z_im, o_re, o_im, tpl)
    assert torch.equal(t_re, zw_re * o_re - zw_im * o_im)
    assert torch.equal(t_im, zw_re * o_im + zw_im * o_re)
    assert torch.equal(t_sum, t_re + t_im)
    k1, pd, ps = torch.randn((3, w, ka, kb), generator=g).unbind(0)
    got_re, got_im = ws.spectrum_t_plain(k1, pd, ps, o_re, o_im, tpl)
    a, b = k1 + pd, k1 - ps
    zr, zi = a * o_re + b * o_im, -a * o_im + b * o_re
    if tpl is not None:
        zr, zi = (tpl @ zr.reshape(w, -1)).view(-1, ka, kb), (tpl @ zi.reshape(w, -1)).view(-1, ka, kb)
    assert torch.equal(got_re, zr) and torch.equal(got_im, zi)


# ---------------------------------------------------------------------------
# the route


class _OnCard(torch.Tensor):
    """A CPU tensor that reports itself on the card (`is_cuda`), and so do
    the tensors made from it: the route is chosen here as on the card."""

    @property
    def is_cuda(self):
        return True


def _on_card(t: torch.Tensor) -> torch.Tensor:
    return t.as_subclass(_OnCard)


def _operands(n_map=2, w=5, ka=4, kb=3, seed=0, dtype=torch.float32):
    g = _gen(seed)
    z = torch.randn((2, n_map, ka, kb), generator=g, dtype=dtype).unbind(0)
    k = torch.randn((3, w, ka, kb), generator=g, dtype=dtype).unbind(0)
    o = torch.randn((2, w, ka, kb), generator=g, dtype=dtype).unbind(0)
    tpl = torch.rand((n_map, w), generator=g, dtype=dtype)
    return z, k, o, tpl


def test_a_cpu_tensor_takes_the_plain_spelling(monkeypatch):
    def refuse(*_, **__):
        raise AssertionError("the kernel's wrapper called for a CPU tensor")

    monkeypatch.setattr(ws, "spectrum_cuda", refuse)
    monkeypatch.setattr(ws, "spectrum_t_cuda", refuse)
    z, k, o, tpl = _operands()
    assert all(torch.equal(a, b) for a, b in zip(ws.spectrum(*z, *o, tpl), ws.spectrum_plain(*z, *o, tpl)))
    assert all(torch.equal(a, b) for a, b in zip(ws.spectrum_t(*k, *o, tpl), ws.spectrum_t_plain(*k, *o, tpl)))


@pytest.mark.parametrize("plain", [False, True])
def test_a_card_tensor_takes_the_kernel_unless_plain(monkeypatch, plain):
    seen = []
    monkeypatch.setattr(ws, "spectrum_cuda", lambda *a: seen.append("forward") or a[:3])
    monkeypatch.setattr(ws, "spectrum_t_cuda", lambda *a: seen.append("transpose") or a[:2])
    z, k, o, tpl = _operands()
    z, k = [_on_card(t) for t in z], [_on_card(t) for t in k]
    for t in (tpl, None):
        zz = z if t is not None else [_on_card(a) for a in k[:2]]
        ws.spectrum(*zz, *o, t, plain)
        ws.spectrum_t(*k, *o, t, plain)
    assert seen == ([] if plain else ["forward", "transpose"] * 2)


def _bad(case):
    """Operands the kernels do not take, on a tensor that says it is on the
    card: (forward or transpose, arguments, the error)."""
    z, k, o, tpl = _operands()
    if case == "float64":
        z, k, o, tpl = _operands(dtype=torch.float64)
    elif case == "strided spectra":
        z = [t.transpose(1, 2).contiguous().transpose(1, 2) for t in z]
        k = [t.transpose(1, 2).contiguous().transpose(1, 2) for t in k]
    elif case == "OTF bins not flat":
        o = [torch.randn((5, 4, 6))[:, :, :3] for _ in o]
    elif case == "OTF shapes differ":
        o = [o[0], o[1][:, :, :2]]
    elif case == "nine maps":
        z, k, o, tpl = _operands(n_map=9)
    elif case == "template columns strided":
        tpl = torch.rand((5, 2)).T
    elif case == "templates of another W":
        tpl = tpl[:, :4]
    elif case == "autograd":
        o = [o[0].requires_grad_(), o[1]]
    err = TypeError if case == "float64" else ValueError
    return [_on_card(t) for t in z], [_on_card(t) for t in k], o, tpl, err


@pytest.mark.parametrize("case", ["float64", "strided spectra", "OTF bins not flat", "OTF shapes differ",
                                  "nine maps", "template columns strided", "templates of another W",
                                  "autograd"])
def test_a_card_tensor_the_kernel_does_not_take_raises(monkeypatch, case):
    """Raised before any build or launch (the kernel is never reached)."""
    def refuse():
        raise AssertionError("the kernel was reached")

    monkeypatch.setattr(ws, "load_kernels", refuse)
    z, k, o, tpl, err = _bad(case)
    with pytest.raises(err):
        ws.spectrum(*z, *o, tpl)
    with pytest.raises(err):
        ws.spectrum_t(*k, *o, tpl)


@pytest.mark.parametrize("band", sorted(FLAGSHIP))
def test_launch_split_fills_the_card(band):
    """The runs the planes are cut into: the most whose blocks fit one wave
    of `BLOCKS_PER_SM` an SM of 132, at least one, at most W."""
    w, ka, kb = FLAGSHIP[band]
    blocks = -(-ka * kb // ws.THREADS)
    s = ws.launch_split(w, ka * kb, 132)
    assert 1 <= s <= w
    assert s == 1 or blocks * s <= ws.BLOCKS_PER_SM * 132
    assert s == w or blocks * (s + 1) > ws.BLOCKS_PER_SM * 132
    assert ws.launch_split(3, 1, 132) == 3 and ws.launch_split(w, 10**9, 132) == 1


@pytest.mark.parametrize("kind", ["lmm", "cube"])
@pytest.mark.parametrize("plain", [False, True])
def test_the_model_hands_plain_to_the_pair(monkeypatch, kind, plain):
    """A dense window-local model's forward, adjoint and normal pass their
    `plain` to both directions of the pair, every band."""
    from surfh_tpu_torch.simulation.synthetic import make_model, make_setup

    setup = make_setup(im_size=31, n_lambda=24, n_tpl=2, n_channels=2, n_pointings=1, n_slit=3)
    if kind == "cube":
        setup = dict(setup, templates=None)
    model = make_model(setup=setup, dtype=np.float64, window_local=True, conv_impl="matmul",
                       conv_freq_rtol=1e-6)[0].to("cpu", torch.float64)
    seen = []
    fwd, back = ws.spectrum, ws.spectrum_t
    monkeypatch.setattr(ws, "spectrum", lambda *a: seen.append(("f", a[-1])) or fwd(*a))
    monkeypatch.setattr(ws, "spectrum_t", lambda *a: seen.append(("t", a[-1])) or back(*a))
    x = torch.rand(model.ishape, generator=_gen(1), dtype=torch.float64)
    model.normal(x, plain=plain)
    model.adjoint(model.forward(x, plain=plain), plain=plain)
    n = len(model.channels)
    assert seen == [("f", plain), ("t", plain)] * n + [("f", plain)] * n + [("t", plain)] * n


# ---------------------------------------------------------------------------
# the gradient on the card (`Spectrum`, `SpectrumT`), checked on the CPU with
# the plain spelling in the kernels' place


@pytest.fixture
def kernels_as_plain(monkeypatch):
    monkeypatch.setattr(ws, "spectrum_cuda", ws.spectrum_plain)
    monkeypatch.setattr(ws, "spectrum_t_cuda", ws.spectrum_t_plain)


@pytest.mark.parametrize("kind", ["lmm", "cube"])
@pytest.mark.parametrize("direction", ["forward", "transpose"])
def test_the_kernels_gradient_is_the_other_direction(kernels_as_plain, direction, kind):
    """float64: `Spectrum` / `SpectrumT` pass torch's gradcheck and its
    second-order gradgradcheck, their VJP being the other direction."""
    z, k, o, tpl = _operands(dtype=torch.float64)
    tpl = tpl if kind == "lmm" else None
    if kind == "cube":
        z = k[:2]
    if direction == "forward":
        fn, args = ws.Spectrum.apply, [t.clone().requires_grad_() for t in z]
    else:
        fn, args = ws.SpectrumT.apply, [t.clone().requires_grad_() for t in k]
    call = lambda *a: fn(*a, *o, tpl)  # noqa: E731
    assert torch.autograd.gradcheck(call, args)
    assert torch.autograd.gradgradcheck(call, args)


@pytest.mark.parametrize("kind", ["lmm", "cube"])
def test_func_vjp_of_the_pair_through_the_kernels_is_its_transpose(kernels_as_plain, kind):
    """`torch.func.vjp` of the forward pair with the spectrum side on the
    kernels' route (as `adjoint_auto` takes it on the card) is the
    transpose pair, to float64 rounding."""
    p = _problem("contiguous", seed=4)
    tpl = p["tpl"] if kind == "lmm" else None
    arg = p["maps"] if kind == "lmm" else p["x"]
    if kind == "lmm":
        fwd = lambda a: fft.lmm_conv_otf_rows(_on_card(a), tpl, *p["otf"], p["m"]).as_subclass(torch.Tensor)  # noqa: E731
        adj = fft.lmm_conv_otf_rows_t(p["rows"], tpl, *p["otf"], p["m"])
    else:
        fwd = lambda a: fft.conv_otf_matmul_rows(_on_card(a), *p["otf"], p["m"]).as_subclass(torch.Tensor)  # noqa: E731
        adj = fft.conv_otf_matmul_rows_t(p["rows"], *p["otf"], p["m"])
    _, vjp = torch.func.vjp(fwd, torch.zeros_like(arg))
    (got,) = vjp(p["rows"])
    assert rel(got.as_subclass(torch.Tensor), adj) <= TOL


def test_no_gradient_is_given_in_the_tables(kernels_as_plain):
    z, k, o, tpl = _operands(dtype=torch.float64)
    with pytest.raises(ValueError):
        ws.spectrum(*[_on_card(t) for t in z], *o, tpl.clone().requires_grad_())
    with torch.no_grad():
        ws.spectrum(*[_on_card(t) for t in z], *o, tpl.clone().requires_grad_())


# ---------------------------------------------------------------------------
# the kernels' source, compiled for the CPU

_RUNTIME_SHIM = """
#pragma once
#include <cmath>
#include <cstddef>
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
typedef void* cudaStream_t;
typedef int cudaError_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
static inline cudaError_t cudaGetLastError() { return cudaSuccess; }
#define __global__
#define __device__
#define __forceinline__ inline
#define __launch_bounds__(...)
static dim3 threadIdx, blockIdx, gridDim, blockDim;
template <class T> static inline T __ldg(const T* p) { return *p; }
template <class T> static inline T __ldcs(const T* p) { return *p; }
template <class T> static inline void __stcs(T* p, T v) { *p = v; }
static inline float __fmul_rn(float a, float b) { return a * b; }
static inline float __fadd_rn(float a, float b) { return a + b; }
static inline float __fsub_rn(float a, float b) { return a - b; }
static inline float __fmaf_rn(float a, float b, float c) { return std::fmaf(a, b, c); }
template <class F>
static void surfh_emulate(F f, dim3 grid, dim3 block, size_t = 0, cudaStream_t = nullptr) {
  gridDim = grid;
  blockDim = block;
  for (unsigned bz = 0; bz < grid.z; ++bz)
    for (unsigned by = 0; by < grid.y; ++by)
      for (unsigned bx = 0; bx < grid.x; ++bx)
        for (unsigned t = 0; t < block.x * block.y * block.z; ++t) {
          blockIdx = dim3(bx, by, bz);
          threadIdx = dim3(t % block.x, t / block.x % block.y, t / (block.x * block.y));
          f();
        }
}
"""


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """The entry points of ``csrc/window_spectrum.cu`` built by g++ for the
    CPU, each ``kernel<<<grid, block, 0, stream>>>(args)`` a loop over the
    grid (the kernels use no shared memory and no barrier)."""
    from surfh_tpu_torch.core import _build

    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the kernels' source for the CPU")
    src = (_build.CSRC / "window_spectrum.cu").read_text()
    src, n = re.subn(r"(\w+(?:<\w+>)?)<<<(.*?)>>>\((.*?)\);",
                     lambda m: f"surfh_emulate([&] {{ {m[1]}({m[3]}); }}, {m[2]});", src, flags=re.S)
    assert n == 3  # forward, transpose, the partial sums
    work = tmp_path_factory.mktemp("window_spectrum_cpu")
    (work / "cuda_runtime.h").write_text(_RUNTIME_SHIM)
    (work / "window_spectrum.cpp").write_text(src)
    so = work / "libwindow_spectrum_cpu.so"
    proc = subprocess.run([gxx, "-O2", "-std=c++17", "-ffp-contract=off", "-shared", "-fPIC",
                           "-I", str(work), str(work / "window_spectrum.cpp"), "-o", str(so)],
                          capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr
    return ws.bind(ctypes.CDLL(str(so)))


@pytest.fixture
def on_cpu_kernels(monkeypatch, emulated):
    """The wrappers' kernel route on CPU tensors that report `is_cuda`,
    launching the CPU build."""
    monkeypatch.setattr(ws, "load_kernels", lambda: emulated)
    monkeypatch.setattr(ws, "_stream", lambda dev: None)
    monkeypatch.setattr(ws, "_n_sm", lambda dev: 132)
    monkeypatch.setattr(ws.torch.cuda, "device", lambda dev: contextlib.nullcontext())


@pytest.mark.parametrize("split", [None, 1, 2, 5, 37])
@pytest.mark.parametrize("n_map", [3, 0], ids=["mix", "cube"])
def test_the_kernels_source_matches_the_plain_spelling(on_cpu_kernels, monkeypatch, n_map, split):
    """Both kernels of the source, on 299 bins (two blocks, the second part
    full) × 37 planes cut into `split` runs (None: `launch_split`, all 37):
    without the mix the float32 spelling's bits, with it within the f32
    bound of the float64 spelling; a split transpose adds its partial sums
    in one more pass, the same bits twice."""
    if split is not None:
        monkeypatch.setattr(ws, "launch_split", lambda *_: split)
    w, ka, kb = 37, 23, 13
    z, k, o, tpl = _operands(n_map=max(n_map, 1), w=w, ka=ka, kb=kb, seed=n_map + 11)
    if n_map == 0:
        z, tpl = k[:2], None
    z, k = [_on_card(t) for t in z], [_on_card(t) for t in k]
    before = (ws.launches, ws.launches_sum)
    got, got_t = ws.spectrum_cuda(*z, *o, tpl), ws.spectrum_t_cuda(*k, *o, tpl)
    again = ws.spectrum_t_cuda(*k, *o, tpl)
    runs = ws.launch_split(w, ka * kb, 132)
    summed = int(n_map > 0 and runs > 1)
    assert (ws.launches - before[0], ws.launches_sum - before[1]) == (3, 2 * summed)
    assert all(torch.equal(a, b) for a, b in zip(got_t, again))
    plain = ws.spectrum_plain(*z, *o, tpl) + ws.spectrum_t_plain(*k, *o, tpl)
    plain64 = (ws.spectrum_plain(*_f64(z), *_f64(o), *_f64([tpl]))
               + ws.spectrum_t_plain(*_f64(k), *_f64(o), *_f64([tpl])))
    for a, b, b64 in zip(got + got_t, plain, plain64):
        assert a.shape == b.shape
        if n_map == 0:
            assert torch.equal(a, b.as_subclass(torch.Tensor))
        assert rel(a, b64.as_subclass(torch.Tensor)) <= F32_TOL


@pytest.mark.parametrize("n_map", [3, 0], ids=["mix", "cube"])
def test_the_kernels_source_takes_the_views_of_a_complex_otf(on_cpu_kernels, n_map):
    """The OTF as the real and imaginary views of a complex table (a bin
    step of 2), the templates a column range: the bits of contiguous copies."""
    w, ka, kb = 11, 9, 7
    z, k, o, _ = _operands(n_map=max(n_map, 1), w=w, ka=ka, kb=kb, seed=5)
    if n_map == 0:
        z = k[:2]
    z, k = [_on_card(t) for t in z], [_on_card(t) for t in k]
    otf = torch.complex(*o)
    wide = torch.rand((max(n_map, 1), w + 6), generator=_gen(6))
    tv = wide[:, 2 : 2 + w] if n_map else None
    tc = None if tv is None else tv.contiguous()
    for fn, args in ((ws.spectrum_cuda, z), (ws.spectrum_t_cuda, k)):
        got = fn(*args, otf.real, otf.imag, tv)
        want = fn(*args, otf.real.contiguous(), otf.imag.contiguous(), tc)
        assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("kind", ["lmm", "cube"])
@pytest.mark.parametrize("direction", ["forward", "transpose"])
def test_the_pair_through_the_kernels_source(on_cpu_kernels, direction, kind):
    """float32, the OTF the views of a complex table and the templates a
    column range: the pair on the kernels' route (two launches) against
    the eager chain in float64."""
    p = _problem("views", seed=7, dtype=torch.float32)
    tpl = p["tpl"] if kind == "lmm" else None
    arg = p["rows"] if direction == "transpose" else (p["maps"] if kind == "lmm" else p["x"])
    fn = {("forward", "lmm"): lambda a: fft.lmm_conv_otf_rows(a, tpl, *p["otf"], p["m"]),
          ("transpose", "lmm"): lambda a: fft.lmm_conv_otf_rows_t(a, tpl, *p["otf"], p["m"]),
          ("forward", "cube"): lambda a: fft.conv_otf_matmul_rows(a, *p["otf"], p["m"]),
          ("transpose", "cube"): lambda a: fft.conv_otf_matmul_rows_t(a, *p["otf"], p["m"])}[(direction, kind)]
    before = ws.launches
    got = fn(_on_card(arg)).as_subclass(torch.Tensor)
    assert ws.launches - before == 1
    p64 = {k: v for k, v in p.items()}
    p64["m"] = {k: v.double() for k, v in p["m"].items()}
    want = _eager(direction, kind, arg.double(), None if tpl is None else tpl.double(),
                  *_f64(p["otf"]), p64["m"])
    assert rel(got, want) <= 1e-5


@pytest.mark.parametrize("kind", ["lmm", "cube"])
def test_func_vjp_through_the_kernels_source_is_the_transpose(on_cpu_kernels, monkeypatch, kind):
    """`torch.func.vjp` of the forward pair on the kernels' route (as
    `adjoint_auto` runs on the card): the VJP launches the transpose
    kernel and equals the transpose pair in float32.  (Under the
    transform the Functions see plain CPU tensors here; they reach the
    kernels marked as on the card, as they would be there.)"""
    for name in ("spectrum_cuda", "spectrum_t_cuda"):
        kernel = getattr(ws, name)
        monkeypatch.setattr(ws, name, lambda *a, kernel=kernel: kernel(*[
            _on_card(t) if isinstance(t, torch.Tensor) else t for t in a]))
    p = _problem("views", seed=8, dtype=torch.float32)
    tpl = p["tpl"] if kind == "lmm" else None
    arg = p["maps"] if kind == "lmm" else p["x"]
    if kind == "lmm":
        fwd = lambda a: fft.lmm_conv_otf_rows(_on_card(a), tpl, *p["otf"], p["m"]).as_subclass(torch.Tensor)  # noqa: E731
        adj = fft.lmm_conv_otf_rows_t(p["rows"], tpl, *p["otf"], p["m"], True)
    else:
        fwd = lambda a: fft.conv_otf_matmul_rows(_on_card(a), *p["otf"], p["m"]).as_subclass(torch.Tensor)  # noqa: E731
        adj = fft.conv_otf_matmul_rows_t(p["rows"], *p["otf"], p["m"], True)
    _, vjp = torch.func.vjp(fwd, torch.zeros_like(arg))
    before = ws.launches
    (got,) = vjp(p["rows"])
    assert ws.launches - before == 1
    assert rel(got.as_subclass(torch.Tensor), adj) <= 1e-5


# ---------------------------------------------------------------------------
# on the card


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _card_operands(dev, w, ka, kb, n_map, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    rows = n_map if n_map else w
    z = torch.randn((2, rows, ka, kb), generator=g, device=dev).unbind(0)
    k = torch.randn((3, w, ka, kb), generator=g, device=dev).unbind(0)
    o = torch.randn((2, w, ka, kb), generator=g, device=dev).unbind(0)
    tpl = torch.rand((n_map, w), generator=g, device=dev) if n_map else None
    return z, k, o, tpl


def _f64(ts):
    return [None if t is None else t.double() for t in ts]


@pytest.mark.cuda
@pytest.mark.parametrize("n_map", [4, 0], ids=["mix", "cube"])
@pytest.mark.parametrize("band", sorted(FLAGSHIP))
def test_kernels_match_the_plain_spelling_at_the_flagship_shapes(band, n_map):
    """Both kernels at a band's shape against the plain spelling in float32
    and in float64; without the mix the float32 spelling's bits."""
    dev = _cuda()
    w, ka, kb = FLAGSHIP[band]
    z, k, o, tpl = _card_operands(dev, w, ka, kb, n_map, seed=w)
    before = ws.launches
    got = ws.spectrum(*z, *o, tpl)
    got_t = ws.spectrum_t(*k, *o, tpl)
    torch.cuda.synchronize()
    assert ws.launches - before == 2
    plain32 = ws.spectrum_plain(*z, *o, tpl)
    plain32_t = ws.spectrum_t_plain(*k, *o, tpl)
    plain64 = ws.spectrum_plain(*_f64(z), *_f64(o), *_f64([tpl]))
    plain64_t = ws.spectrum_t_plain(*_f64(k), *_f64(o), *_f64([tpl]))
    for a, b32, b64 in zip(got + got_t, plain32 + plain32_t, plain64 + plain64_t):
        assert a.shape == b32.shape
        if n_map == 0:
            assert torch.equal(a, b32)
        assert rel(a, b32) <= F32_TOL and rel(a, b64) <= F32_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("split", [1, 2, 7, 524])
def test_the_split_path_gives_the_same_bits_twice(monkeypatch, split):
    """Band 2c's shape with the planes cut into `split` runs (the partial
    sums added in run order): the same bits on two runs, within the f32
    bound of the plain spelling; the sums pass counted once a split call.
    The forward's bits do not depend on the split."""
    dev = _cuda()
    w, ka, kb = FLAGSHIP["2c"]
    _, k, o, tpl = _card_operands(dev, w, ka, kb, 4, seed=5)
    z = [t[:4] for t in k[:2]]
    f1 = ws.spectrum_cuda(*z, *o, tpl)
    monkeypatch.setattr(ws, "launch_split", lambda *_: split)
    before = ws.launches_sum
    a = ws.spectrum_t_cuda(*k, *o, tpl)
    b = ws.spectrum_t_cuda(*k, *o, tpl)
    torch.cuda.synchronize()
    assert ws.launches_sum - before == (2 if split > 1 else 0)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    want = ws.spectrum_t_plain(*_f64(k), *_f64(o), tpl.double())
    assert rel(a[0], want[0]) <= F32_TOL and rel(a[1], want[1]) <= F32_TOL
    assert all(torch.equal(x, y) for x, y in zip(ws.spectrum_cuda(*z, *o, tpl), f1))


@pytest.mark.cuda
@pytest.mark.parametrize("n_map", [4, 0], ids=["mix", "cube"])
def test_kernels_take_the_views_of_a_complex_otf(n_map):
    """The OTF as the real and imaginary views of a complex table (a bin
    step of 2), the templates a column range: the bits of contiguous copies."""
    dev = _cuda()
    w, ka, kb = 61, 37, 19
    z, k, o, _ = _card_operands(dev, w, ka, kb, n_map, seed=9)
    otf = torch.complex(*o)
    wide = torch.rand((max(n_map, 1), w + 9), device=dev)
    tv = wide[:, 3 : 3 + w] if n_map else None
    tc = None if tv is None else tv.contiguous()
    for fn, args in ((ws.spectrum, z), (ws.spectrum_t, k)):
        got = fn(*args, otf.real, otf.imag, tv)
        want = fn(*args, otf.real.contiguous(), otf.imag.contiguous(), tc)
        assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.cuda
def test_kernels_reject_what_they_do_not_take():
    dev = _cuda()
    z, k, o, tpl = _card_operands(dev, 9, 5, 4, 2, seed=1)
    with pytest.raises(TypeError):
        ws.spectrum(*[t.double() for t in z], *o, tpl)
    with pytest.raises(ValueError):
        ws.spectrum_t(*[t.transpose(1, 2).contiguous().transpose(1, 2) for t in k], *o, tpl)
    with pytest.raises(ValueError):
        ws.spectrum(*[torch.zeros((9, 5, 4), device=dev)] * 2, *o, torch.rand((9, 9), device=dev))
    with pytest.raises(ValueError):
        ws.spectrum_t(*k, *o, tpl.cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["dense", "dense_cube", "rank", "wplane"])
def test_a_normal_launches_kernel_9_twice_a_dense_band(mode):
    """A float32 normal on the card: one forward and one transpose of #9 a
    band of a dense window-local model (maps or cube mode), none on the
    rank and W-plane models; against the model's plain spelling."""
    from surfh_tpu_torch.simulation.synthetic import make_model, make_setup

    dev = _cuda()
    setup = make_setup(im_size=41, n_lambda=120, n_tpl=2, n_channels=2, n_pointings=2, n_slit=3)
    if mode == "dense_cube":
        setup = dict(setup, templates=None)
    kw = {"dense": dict(window_local=True, conv_impl="matmul", conv_freq_rtol=1e-6),
          "rank": dict(window_local=True, psf_stamps=True, conv_freq_rtol=1e-6, conv_rank_rtol=1e-7),
          "wplane": dict(window_local=False)}[mode.replace("_cube", "")]
    model = make_model(setup=setup, dtype=np.float32, **kw)[0].to(dev, torch.float32)
    x = torch.rand(model.ishape, device=dev)
    before = ws.launches
    got = model.normal(x)
    torch.cuda.synchronize()
    dense = mode.startswith("dense")
    assert ws.launches - before == (2 * len(model.channels) if dense else 0)
    if dense:
        plain = model.normal(x, plain=True)
        assert ws.launches - before == 2 * len(model.channels)
        assert rel(got, plain) <= F32_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["dense", "dense_cube"])
def test_adjoint_auto_of_a_dense_model_runs_kernel_9(mode):
    """`adjoint_auto` (torch.func.vjp of the forward) on the card, dense
    window-local: #9 in both directions of the VJP, equal to `adjoint`."""
    from surfh_tpu_torch.simulation.synthetic import make_model, make_setup

    dev = _cuda()
    setup = make_setup(im_size=41, n_lambda=120, n_tpl=2, n_channels=2, n_pointings=2, n_slit=3)
    if mode == "dense_cube":
        setup = dict(setup, templates=None)
    model = make_model(setup=setup, dtype=np.float32, window_local=True, conv_impl="matmul",
                       conv_freq_rtol=1e-6)[0].to(dev, torch.float32)
    y = model.forward(torch.rand(model.ishape, device=dev))
    before = ws.launches
    got = model.adjoint_auto(y)
    torch.cuda.synchronize()
    assert ws.launches - before >= 2 * len(model.channels)
    assert rel(got, model.adjoint(y)) <= F32_TOL
