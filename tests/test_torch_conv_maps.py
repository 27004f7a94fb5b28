"""The chunked W-plane FFT conv pair (`fft.conv_otf_chunks` /
`fft.conv_otf_chunks_t`), with templates mixed in the frequency domain and
in cube mode (no templates), against the plain spelling: T then
`fft.convolve_freq`, and `convolve_freq` with conj(otf) then Tᵗ (T the
identity in cube mode).

* float64 on the CPU, ≤1e-12 relative: an odd and an even last axis, a λ
  count that is no multiple of the chunk and a chunk of one plane, one map,
  four, and the cube; the forward's chunks and the λ-ranges cut out of
  them; the forward leaves its input as it was; the pair's dot test; the
  transpose leaves its cube as it was with templates and returns it,
  overwritten, in cube mode; where autograd tracks the maps the forward is
  the differentiable T then `convolve_freq`, whose derived transpose is the
  pair's transpose.
* float32 on the CPU: each chunk of cube mode is ``idft(dft(c) · o)`` and
  ``idft(dft(c) · conj(o))`` of its planes, bit for bit.
* On the card (``-m cuda``): float32 against float64 at the flagship's
  501² planes, both modes each way (kernel #8 on the card), no farther
  from it than twice the unchunked `convolve_freq` (cuFFT).

No JAX here: the card case runs on the GPU machine, which has none
(``python -m pytest --noconftest tests/test_torch_conv_maps.py -m cuda``).
"""

import numpy as np
import pytest
import torch

from surfh_tpu_torch.core import fft, lmm

torch.set_num_threads(2)

TOL = 1e-12


def rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a - b).abs().max() / b.abs().max())


def _problem(n_maps, n_lambda, shape, seed=0, dtype=torch.float64, device="cpu"):
    """The unknown (maps, or in cube mode, `n_maps` None, a cube), the
    templates (None in cube mode), a cube and the OTF of real 5 × 4 stamps
    (a real circular conv, so conj(otf) is its exact transpose)."""
    rng = np.random.default_rng(seed)
    stamps = rng.standard_normal((n_lambda, 5, 4))
    otf = torch.as_tensor(fft.ir2fr(stamps, shape)).to(device, torch.complex128)
    as_t = lambda a: torch.as_tensor(a).to(device, dtype)
    x = as_t(rng.standard_normal((n_lambda if n_maps is None else n_maps,) + shape))
    tpl = None if n_maps is None else as_t(rng.random((n_maps, n_lambda)))
    return (x, tpl, as_t(rng.standard_normal((n_lambda,) + shape)),
            otf.to(torch.complex128 if dtype == torch.float64 else torch.complex64))


def _t(x, tpl):
    return x if tpl is None else lmm.lmm_maps2cube(x, tpl)


def _tt(cube, tpl):
    return cube if tpl is None else lmm.lmm_cube2maps(cube, tpl)


CASES = [pytest.param(m, nb, lam, chunk, id=f"{'cube' if m is None else f'M{m}'}-Nb{nb}-L{lam}-chunk{chunk}")
         for m in (1, 4, None) for nb in (31, 32) for lam, chunk in ((23, 5), (7, 1))]


@pytest.mark.parametrize("n_maps,nb,n_lambda,chunk", CASES)
def test_forward_is_t_then_the_conv(n_maps, nb, n_lambda, chunk):
    x, tpl, _, otf = _problem(n_maps, n_lambda, (29, nb))
    kept = x.clone()
    want = fft.convolve_freq(_t(x, tpl), otf, (29, nb))
    chunks = fft.conv_otf_chunks(x, otf, tpl, chunk=chunk)
    assert [c.shape[0] for c in chunks] == [min(chunk, n_lambda - i) for i in range(0, n_lambda, chunk)]
    got = torch.cat(chunks)
    assert tuple(got.shape) == (n_lambda, 29, nb) and got.dtype == torch.float64
    assert rel(got, want) <= TOL
    assert torch.equal(x, kept)
    for start, stop in ((0, n_lambda), (1, n_lambda - 1), (3, 4), (chunk - 1, chunk + 1)):
        assert torch.equal(torch.cat(fft.cube_planes(chunks, start, stop)), got[start:stop])


@pytest.mark.parametrize("n_maps,nb,n_lambda,chunk", CASES)
def test_adjoint_is_the_conv_then_tt(n_maps, nb, n_lambda, chunk):
    _, tpl, cube, otf = _problem(n_maps, n_lambda, (29, nb))
    kept = cube.clone()
    want = _tt(fft.convolve_freq(cube, otf.conj(), (29, nb)), tpl)
    got = fft.conv_otf_chunks_t(cube, otf, tpl, chunk=chunk)
    assert tuple(got.shape) == (n_maps or n_lambda, 29, nb) and got.dtype == torch.float64
    assert rel(got, want) <= TOL
    if tpl is None:
        assert got is cube
    else:
        assert torch.equal(cube, kept)


@pytest.mark.parametrize("n_maps,nb,n_lambda,chunk", CASES)
def test_the_pair_is_a_transpose_pair(n_maps, nb, n_lambda, chunk):
    x, tpl, cube, otf = _problem(n_maps, n_lambda, (29, nb), seed=1)
    lhs = float(torch.sum(torch.cat(fft.conv_otf_chunks(x, otf, tpl, chunk=chunk)) * cube))
    rhs = float(torch.sum(x * fft.conv_otf_chunks_t(cube, otf, tpl, chunk=chunk)))
    assert abs(lhs - rhs) <= TOL * abs(lhs)


@pytest.mark.parametrize("nb", [31, 32])
def test_cube_mode_is_the_unitary_pair_bit_for_bit(nb):
    """float32, cube mode: each chunk of the forward and of the transpose is
    the unitary pair on its planes, ``idft(dft(c) · o)`` and
    ``idft(dft(c) · conj(o))``, bit for bit."""
    _, _, cube, otf = _problem(None, 23, (29, nb), dtype=torch.float32)
    kept = cube.clone()
    chunks = fft.conv_otf_chunks(cube, otf, chunk=5)
    back = fft.conv_otf_chunks_t(cube, otf, chunk=5)
    assert len(chunks) == 5 and back.dtype == torch.float32
    for i, got in zip(range(0, 23, 5), chunks):
        c, o = kept[i : i + 5], otf[i : i + 5]
        assert torch.equal(got, fft.idft(fft.dft(c) * o, (29, nb)))
        assert torch.equal(back[i : i + 5], fft.idft(fft.dft(c) * o.conj(), (29, nb)))


def test_tracked_maps_take_the_differentiable_route():
    """Under autograd the forward is T then `convolve_freq` (one chunk), and
    the derived transpose equals the pair's transpose."""
    maps, tpl, cube, otf = _problem(4, 23, (29, 31), seed=2)
    out, vjp = torch.func.vjp(lambda x: fft.conv_otf_chunks(x, otf, tpl, chunk=5), maps)
    assert len(out) == 1
    assert rel(out[0], torch.cat(fft.conv_otf_chunks(maps, otf, tpl, chunk=5))) <= TOL
    assert rel(vjp([cube])[0], fft.conv_otf_chunks_t(cube, otf, tpl, chunk=5)) <= TOL


@pytest.mark.cuda
def test_float32_on_the_card_is_as_close_as_the_replaced_route():
    """float32 on the card against float64 at 501² (the flagship's planes),
    600 λ-planes (three chunks, the last short), four maps and the cube;
    relative to the largest value of the float64 result: the pair (kernel
    #8) no farther from it than twice the unchunked unitary
    `convolve_freq` (cuFFT's Bluestein path), of T maps and of the cube,
    each way."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: this compares the card's float32 with float64")
    dev = torch.device("cuda")
    maps, tpl, cube, otf = _problem(4, 600, (501, 501), seed=3, dtype=torch.float64, device=dev)
    shape = (501, 501)
    want_f = torch.cat(fft.conv_otf_chunks(maps, otf, tpl))
    want_t = fft.conv_otf_chunks_t(cube, otf, tpl)
    want_cf = torch.cat(fft.conv_otf_chunks(cube, otf))
    want_ct = fft.conv_otf_chunks_t(cube.clone(), otf)
    maps32, tpl32, cube32 = (t.float() for t in (maps, tpl, cube))
    otf32 = otf.to(torch.complex64)
    errs = {name: rel(g.double(), w) for name, g, w in (
        ("forward", torch.cat(fft.conv_otf_chunks(maps32, otf32, tpl32)), want_f),
        ("adjoint", fft.conv_otf_chunks_t(cube32, otf32, tpl32), want_t),
        ("cube forward", torch.cat(fft.conv_otf_chunks(cube32, otf32)), want_cf),
        ("cube adjoint", fft.conv_otf_chunks_t(cube32.clone(), otf32), want_ct),
        ("unchunked forward", fft.convolve_freq(lmm.lmm_maps2cube(maps32, tpl32), otf32, shape), want_f),
        ("unchunked adjoint", lmm.lmm_cube2maps(fft.convolve_freq(cube32, otf32.conj(), shape), tpl32),
         want_t),
        ("unchunked cube forward", fft.convolve_freq(cube32, otf32, shape), want_cf),
        ("unchunked cube adjoint", fft.convolve_freq(cube32, otf32.conj(), shape), want_ct))}
    print(errs)
    assert max(errs[k] for k in ("forward", "adjoint", "cube forward", "cube adjoint")) <= 1e-5, errs
    for k in ("forward", "adjoint", "cube forward", "cube adjoint"):
        assert errs[k] <= 2 * errs[f"unchunked {k}"], errs
