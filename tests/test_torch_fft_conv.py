"""Kernel #8 (`core/fft_conv.py`, ``csrc/fft_conv.cu``): the W-plane FFT
conv's three passes.

* float64 on the CPU, against `torch.fft`: the plain version of each pass
  (the kernels' algorithm and tables) — every transform length of a pass
  including N = 1, 2, primes, 32 and 501, odd and even axes, Na ≠ Nb; the
  two-row packing with an odd row count; Hermitian c2r for odd and even Nb
  (the imaginary parts of the real bins not read, as `torch.fft.irfft`);
  the column pass in each of its modes, with OTF and conj(OTF); the split
  chosen for every length the kernels take; and the passes composed
  (`fft._conv_chunks_card` / `_t_card`, the kernel route's loops, which on
  the CPU run the plain passes) equal to the pair's `torch.fft` route to
  1e-12.
* On the card (``-m cuda``): each kernel against its plain version in
  float32, the launch counter on each pass of each chunk of the pair, and
  no cuFFT Bluestein kernel in a W-plane normal.

No JAX here: the card cases run on the GPU machine, which has none
(``python -m pytest --noconftest tests/test_torch_fft_conv.py -m cuda``).
"""

import numpy as np
import pytest
import torch

from surfh_tpu_torch.core import fft, fft_conv

torch.set_num_threads(2)

TOL = 1e-12


def rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a - b).abs().max() / b.abs().max())


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


def _complex(shape, seed=0, dtype=torch.float64, device="cpu"):
    g = _gen(seed)
    return torch.complex(torch.randn(shape, generator=g, dtype=dtype),
                         torch.randn(shape, generator=g, dtype=dtype)).to(device)


LENGTHS = [1, 2, 3, 29, 31, 32, 100, 167, 501, 512, 2039, 2048]


@pytest.mark.parametrize("inverse", [False, True], ids=["forward", "inverse"])
@pytest.mark.parametrize("n", LENGTHS)
def test_dft_lines_plain_is_the_dft(n, inverse):
    z = _complex((3, n), seed=n)
    want = torch.fft.ifft(z, norm="forward") if inverse else torch.fft.fft(z)
    assert rel(fft_conv.dft_lines_plain(z, inverse), want) <= TOL


@pytest.mark.parametrize("n", range(1, fft_conv.NMAX + 1, 23))
def test_every_length_has_a_split_that_fits(n):
    p = fft_conv.plan(n)
    assert p["n1"] * p["n2"] == n and p["ha"] == p["n2"] // 2 and p["hk"] == p["n2"] // 2 + 1
    assert p["lines"] in (4, 2)
    buffers = 1 if p["in_place"] else 2
    assert p["smem"] == (buffers * n * (p["lines"] + 2) + 3 * p["n2"] + n) * 8 <= fft_conv.SMEM_MAX
    ct, tw = fft_conv.host_tables(n)
    assert ct.shape == (3 * p["n2"], 2) and tw.shape == (n, 2)
    m = np.arange(3 * p["n2"])
    assert np.allclose(ct[:, 0] + 1j * ct[:, 1], np.exp(2j * np.pi * m / p["n2"]), rtol=0, atol=1e-13)


class _OnCard(torch.Tensor):
    """A CPU tensor that reports itself on the card (`is_cuda`), and so do
    the tensors made from it: the pair's route is chosen here as on the
    card, and a `torch.fft` route runs on the CPU's numbers."""

    @property
    def is_cuda(self):
        return True


def _on_card(t: torch.Tensor) -> torch.Tensor:
    return t.as_subclass(_OnCard)


def test_the_route_is_chosen_by_shape():
    """Axes up to `NMAX` take the kernels, longer ones keep `torch.fft`;
    the route follows the planes' device, dtype and shape alone: a float32
    tensor on the card takes the kernels, strided or not, float64 on the
    card and a CPU tensor never do."""
    assert fft_conv.fits(501, 501) and fft_conv.fits(1, fft_conv.NMAX)
    assert not fft_conv.fits(fft_conv.NMAX + 1, 501) and not fft_conv.fits(501, fft_conv.NMAX + 1)
    with pytest.raises(ValueError):
        fft_conv.plan(fft_conv.NMAX + 1)
    assert not fft._on_kernel(torch.zeros((2, 31, 31)))
    x = _on_card(torch.zeros((2, 31, 31)))
    assert fft._on_kernel(x) and fft._on_kernel(x.transpose(-1, -2))
    assert not fft._on_kernel(x.double())
    assert not fft._on_kernel(_on_card(torch.zeros((2, fft_conv.NMAX + 1, 31))))
    assert not fft._on_kernel(_on_card(torch.zeros((2, 31, fft_conv.NMAX + 1))))


@pytest.mark.parametrize("na,nb", [(fft_conv.NMAX + 1, 7), (6, fft_conv.NMAX + 1)],
                         ids=["Na-over", "Nb-over"])
@pytest.mark.parametrize("n_maps", [2, None], ids=["maps", "cube"])
def test_a_card_tensor_over_nmax_keeps_torch_fft(monkeypatch, n_maps, na, nb):
    """A float32 tensor on the card with an axis over `NMAX` runs the pair's
    `torch.fft` route each way, bit for bit the CPU's: kernel #8's loops are
    not entered and nothing is launched."""
    def refuse(*_):
        raise AssertionError("kernel #8's loop entered")

    x, tpl, cube, otf = _problem(n_maps, 3, (na, nb), seed=2)
    x, cube, otf = x.float(), cube.float(), otf.to(torch.complex64)
    tpl = None if tpl is None else tpl.float()
    want = fft.conv_otf_chunks(x, otf, tpl, chunk=2)
    want_t = fft.conv_otf_chunks_t(cube.clone(), otf, tpl, chunk=2)
    monkeypatch.setattr(fft, "_conv_chunks_card", refuse)
    monkeypatch.setattr(fft, "_conv_chunks_t_card", refuse)
    before = fft_conv.launches
    got = fft.conv_otf_chunks(_on_card(x), otf, tpl, chunk=2)
    got_t = fft.conv_otf_chunks_t(_on_card(cube.clone()), otf, tpl, chunk=2)
    assert len(got) == len(want) == 2
    assert all(torch.equal(g.as_subclass(torch.Tensor), w) for g, w in zip(got, want))
    assert torch.equal(got_t.as_subclass(torch.Tensor), want_t)
    assert fft_conv.launches == before


@pytest.mark.parametrize("n_maps", [2, None], ids=["maps", "cube"])
def test_strided_planes_on_the_card_reach_the_kernels_contiguous(monkeypatch, n_maps):
    """A strided float32 x (or cube) on the card is made contiguous and sent
    to kernel #8's loops, each way, with its values."""
    seen = []
    monkeypatch.setattr(fft, "_conv_chunks_card", lambda x, *_: seen.append(x) or [x])
    monkeypatch.setattr(fft, "_conv_chunks_t_card", lambda c, *_: seen.append(c) or c)
    x, tpl, cube, otf = _problem(n_maps, 5, (9, 8), seed=3)
    x, cube, otf = x.float(), cube.float(), otf.to(torch.complex64)
    tpl = None if tpl is None else tpl.float()
    xs = _on_card(x.transpose(-1, -2).contiguous()).transpose(-1, -2)
    cs = _on_card(cube.transpose(-1, -2).contiguous()).transpose(-1, -2)
    assert not xs.is_contiguous() and not cs.is_contiguous()
    fft.conv_otf_chunks(xs, otf, tpl)
    fft.conv_otf_chunks_t(cs, otf, tpl)
    assert [t.is_contiguous() for t in seen] == [True, True]
    assert torch.equal(seen[0], x) and torch.equal(seen[1], cube)


ROW_CASES = [pytest.param(b, na, nb, id=f"B{b}-Na{na}-Nb{nb}")
             for nb in (1, 2, 29, 31, 32, 501) for b, na in ((1, 1), (1, 7), (2, 5), (3, 4))]


@pytest.mark.parametrize("b,na,nb", ROW_CASES)
def test_rows_r2c_plain_is_rfft(b, na, nb):
    """Rows packed two a transform; an odd row count (B·Na) pads a zero row."""
    x = torch.randn((b, na, nb), generator=_gen(nb), dtype=torch.float64)
    got = fft_conv.rows_r2c(x)
    assert got.shape == (b, na, nb // 2 + 1) and got.dtype == torch.complex128
    assert rel(got, torch.fft.rfft(x)) <= TOL
    out = torch.empty_like(got)
    assert fft_conv.rows_r2c(x, out=out) is out and torch.equal(out, got)


@pytest.mark.parametrize("b,na,nb", ROW_CASES)
def test_rows_c2r_plain_is_irfft(b, na, nb):
    """Hermitian half spectra to real rows (unnormalized), the imaginary
    parts of bin 0 and of an even Nb's bin Nb / 2 not read."""
    h = _complex((b, na, nb // 2 + 1), seed=nb)
    assert h.imag[..., 0].abs().min() > 0
    got = fft_conv.rows_c2r(h, nb)
    assert got.shape == (b, na, nb) and got.dtype == torch.float64
    assert rel(got, torch.fft.irfft(h, n=nb, norm="forward")) <= TOL
    out = torch.empty_like(got)
    assert fft_conv.rows_c2r(h, nb, out=out) is out and torch.equal(out, got)


MODES = {"forward": (True, False), "inverse": (False, True), "forward-product": (True, False),
         "product-inverse": (False, True), "forward-product-inverse": (True, True)}
COL_CASES = [pytest.param(mode, conj, na, id=f"{mode}-{'conj' if conj else 'otf'}-Na{na}")
             for mode in MODES for conj in (False, True) for na in (1, 2, 29, 31, 32, 501)
             if "product" in mode or not conj]


@pytest.mark.parametrize("mode,conj,na", COL_CASES)
def test_columns_plain_is_the_transform_along_na(mode, conj, na):
    """In place on [B, Na, Kb]: forward along Na, × scale·OTF (or its
    conjugate), inverse along Na (unnormalized), each where the mode asks."""
    forward, inverse = MODES[mode]
    s = _complex((3, na, 6), seed=na)
    otf = _complex((3, na, 6), seed=na + 1) if "product" in mode else None
    scale = 0.37 if otf is not None else 1.0
    want = torch.fft.fft(s, dim=1) if forward else s
    if otf is not None:
        want = want * (otf.conj() if conj else otf) * scale
    if inverse:
        want = torch.fft.ifft(want, dim=1, norm="forward")
    work = s.clone()
    got = fft_conv.columns_(work, otf, forward=forward, inverse=inverse, conj=conj, scale=scale)
    assert got is work
    assert rel(got, want) <= TOL


def test_columns_take_conj_and_scale_only_with_an_otf():
    s = _complex((1, 5, 3))
    for kw in ({"conj": True}, {"scale": 2.0}):
        with pytest.raises(ValueError):
            fft_conv.columns_(s, None, forward=True, inverse=True, **kw)
    with pytest.raises(ValueError):
        fft_conv.columns_(s, _complex((1, 5, 4)), forward=True, inverse=True)


def _problem(n_maps, n_lambda, shape, seed=0):
    rng = np.random.default_rng(seed)
    otf = torch.as_tensor(fft.ir2fr(rng.standard_normal((n_lambda, 5, 4)), shape))
    x = torch.as_tensor(rng.standard_normal((n_lambda if n_maps is None else n_maps,) + shape))
    tpl = None if n_maps is None else torch.as_tensor(rng.random((n_maps, n_lambda)))
    return x, tpl, torch.as_tensor(rng.standard_normal((n_lambda,) + shape)), otf


PAIR_CASES = [pytest.param(m, na, nb, lam, chunk,
                           id=f"{'cube' if m is None else f'M{m}'}-{na}x{nb}-L{lam}-chunk{chunk}")
              for m in (1, 4, None) for na, nb in ((29, 31), (32, 29), (31, 32))
              for lam, chunk in ((23, 5), (7, 1))]


@pytest.mark.parametrize("n_maps,na,nb,n_lambda,chunk", PAIR_CASES)
def test_the_passes_composed_are_the_pair(n_maps, na, nb, n_lambda, chunk):
    """The kernel route's loops over the plain passes, forward and
    transpose, equal the pair's `torch.fft` route in float64; the forward
    leaves its input as it was, cube mode's transpose overwrites and
    returns its cube."""
    x, tpl, cube, otf = _problem(n_maps, n_lambda, (na, nb))
    kept = x.clone()
    want = torch.cat(fft.conv_otf_chunks(x, otf, tpl, chunk=chunk))
    chunks = fft._conv_chunks_card(x, otf, tpl, chunk)
    assert [c.shape[0] for c in chunks] == [min(chunk, n_lambda - i) for i in range(0, n_lambda, chunk)]
    assert rel(torch.cat(chunks), want) <= TOL
    assert torch.equal(x, kept)
    want_t = fft.conv_otf_chunks_t(cube.clone(), otf, tpl, chunk=chunk)
    work = cube.clone()
    got_t = fft._conv_chunks_t_card(work, otf, tpl, chunk)
    assert rel(got_t, want_t) <= TOL
    assert (got_t is work) == (tpl is None)


# ---------------------------------------------------------------------------
# on the card


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


F32_TOL = 2e-6  # kernel against its plain version in f32, relative to the largest value


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 2, 29, 31, 32, 167, 501, 512, 2039, 2048])
def test_row_kernels_match_plain(n):
    dev = _cuda()
    rows = 37  # odd: the last pair has one row
    x = torch.randn((rows, n), generator=_gen(n), dtype=torch.float32).to(dev)
    h = _complex((rows, n // 2 + 1), seed=n, dtype=torch.float32, device=dev)
    before = fft_conv.launches
    got_h = fft_conv.rows_r2c(x)
    got_r = fft_conv.rows_c2r(h, n)
    torch.cuda.synchronize()
    assert fft_conv.launches == before + 2
    assert rel(got_h, fft_conv.rows_r2c_plain(x)) <= F32_TOL
    assert rel(got_r, fft_conv.rows_c2r_plain(h, n)) <= F32_TOL
    assert rel(got_h.cpu().to(torch.complex128), torch.fft.rfft(x.cpu().double())) <= 4 * F32_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("mode,conj", [(m, c) for m in MODES for c in (False, True)
                                       if "product" in m or not c])
@pytest.mark.parametrize("na", [1, 2, 31, 32, 501, 2048])
def test_column_kernel_matches_plain(mode, conj, na):
    dev = _cuda()
    forward, inverse = MODES[mode]
    shape = (3, na, 11)  # 33 flat columns: a ragged last block
    s = _complex(shape, seed=na, dtype=torch.float32, device=dev)
    otf = _complex(shape, seed=na + 1, dtype=torch.float32, device=dev) if "product" in mode else None
    scale = 1.0 / na if otf is not None else 1.0
    want = fft_conv.columns_plain(s.clone(), otf, forward=forward, inverse=inverse, conj=conj, scale=scale)
    before = fft_conv.launches
    got = fft_conv.columns_(s, otf, forward=forward, inverse=inverse, conj=conj, scale=scale)
    torch.cuda.synchronize()
    assert got is s and fft_conv.launches == before + 1
    assert rel(got, want) <= F32_TOL


@pytest.mark.cuda
def test_kernels_reject_what_they_do_not_take():
    dev = _cuda()
    with pytest.raises(TypeError):
        fft_conv.rows_r2c(torch.zeros((4, 31), dtype=torch.float64, device=dev))
    with pytest.raises(ValueError):
        fft_conv.rows_r2c(torch.zeros((31, 4), device=dev).T)
    with pytest.raises(TypeError):
        fft_conv.columns_(torch.zeros((1, 5, 3), dtype=torch.complex128, device=dev), forward=True,
                          inverse=False)
    with pytest.raises(ValueError):
        fft_conv.rows_c2r(torch.zeros((4, 16), dtype=torch.complex64, device=dev), 29)


@pytest.mark.cuda
@pytest.mark.parametrize("n_maps", [4, None], ids=["maps", "cube"])
def test_the_pair_launches_each_pass_of_each_chunk(n_maps):
    """On float32 CUDA tensors the pair runs kernel #8: cube mode three
    passes a chunk each way; with templates the maps' rfft2 (two passes),
    then two a chunk forward, two a chunk back and the maps' irfft2 (two)."""
    dev = _cuda()
    x, tpl, cube, otf = _problem(n_maps, 23, (31, 29), seed=4)
    x, cube = x.float().to(dev), cube.float().to(dev)
    tpl = None if tpl is None else tpl.float().to(dev)
    otf = otf.to(dev, torch.complex64)
    n_chunks = 5
    before = fft_conv.launches
    fft.conv_otf_chunks(x, otf, tpl, chunk=5)
    torch.cuda.synchronize()
    assert fft_conv.launches - before == (3 * n_chunks if tpl is None else 2 + 2 * n_chunks)
    before = fft_conv.launches
    fft.conv_otf_chunks_t(cube, otf, tpl, chunk=5)
    torch.cuda.synchronize()
    assert fft_conv.launches - before == (3 * n_chunks if tpl is None else 2 * n_chunks + 2)


@pytest.mark.cuda
@pytest.mark.parametrize("n_maps", [4, None], ids=["maps", "cube"])
def test_strided_planes_launch_the_kernels(n_maps):
    """A strided float32 CUDA x (and cube) takes kernel #8 as a contiguous
    one does, with the same launches and the same result; an OTF the
    kernels do not take makes them raise."""
    dev = _cuda()
    x, tpl, cube, otf = _problem(n_maps, 23, (31, 29), seed=5)
    x, cube = x.float().to(dev), cube.float().to(dev)
    tpl = None if tpl is None else tpl.float().to(dev)
    otf = otf.to(dev, torch.complex64)
    xs = x.transpose(-1, -2).contiguous().transpose(-1, -2)  # x's values, strided
    cs = cube.transpose(-1, -2).contiguous().transpose(-1, -2)
    assert not xs.is_contiguous() and not cs.is_contiguous()
    before = fft_conv.launches
    want = torch.cat(fft.conv_otf_chunks(x, otf, tpl, chunk=5))
    want_t = fft.conv_otf_chunks_t(cube.clone(), otf, tpl, chunk=5)
    per_call = fft_conv.launches - before
    assert per_call > 0
    got = torch.cat(fft.conv_otf_chunks(xs, otf, tpl, chunk=5))
    got_t = fft.conv_otf_chunks_t(cs, otf, tpl, chunk=5)
    torch.cuda.synchronize()
    assert fft_conv.launches - before == 2 * per_call
    assert torch.equal(got, want) and torch.equal(got_t, want_t)
    with pytest.raises(TypeError):
        fft.conv_otf_chunks(x, otf.to(torch.complex128), tpl, chunk=5)
    with pytest.raises(ValueError):
        fft.conv_otf_chunks(x, otf.transpose(-1, -2).contiguous().transpose(-1, -2), tpl, chunk=5)


@pytest.mark.cuda
@pytest.mark.parametrize("templates", [True, False], ids=["maps", "cube"])
def test_no_bluestein_kernel_in_a_wplane_normal(templates):
    """A W-plane normal at 167² (a prime length, which cuFFT runs by
    Bluestein) under `torch.profiler`: kernel #8's passes run, and no
    kernel named `bluestein`."""
    from torch.profiler import ProfilerActivity, profile

    from surfh_tpu_torch.simulation.synthetic import make_model, make_setup

    dev = _cuda()
    setup = make_setup(im_size=167, n_lambda=40, n_tpl=2, n_channels=2, n_pointings=2, n_slit=3)
    model, _ = make_model(setup=setup if templates else dict(setup, templates=None), window_local=False)
    model = model.to(dev, torch.float32)
    x = torch.as_tensor(setup["maps"] if templates else np.random.default_rng(0).random(model.ishape))
    model.normal(x)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        model.normal(x)
        torch.cuda.synchronize()
    names = [e.key for e in prof.key_averages() if e.device_type.name == "CUDA"]
    assert any("surfh_fft_cols" in n for n in names), names
    assert any("surfh_fft_rows_r2c" in n for n in names) and any("surfh_fft_rows_c2r" in n for n in names)
    assert not any("bluestein" in n.lower() for n in names), names
