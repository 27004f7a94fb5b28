"""The W-plane conv with the templates mixed in the frequency domain
(`fft.lmm_conv_otf` / `fft.lmm_conv_otf_t`) against the route it replaces,
T then the chunked FFT conv (`lmm.lmm_maps2cube` then `fft.conv_otf_`) and
its transpose (`fft.conv_otf_` with conj(otf) then `lmm.lmm_cube2maps`).

* float64 on the CPU, ≤1e-12 relative: an odd and an even last axis, a λ
  count that is no multiple of the chunk and a chunk of one plane, one map
  and four; the forward's chunks and the λ-ranges cut out of them; the
  pair's dot test; the adjoint leaves its cube as it was;
  where autograd tracks the maps the forward is the differentiable T then
  `convolve_freq`, whose derived transpose is the pair's adjoint.
* On the card (``-m cuda``): float32 against float64 at the flagship's
  501² planes, no farther from it than the replaced route.

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
    """Maps, templates, a cube and the OTF of real 5 × 4 stamps (a real
    circular conv, so conj(otf) is its exact transpose)."""
    rng = np.random.default_rng(seed)
    stamps = rng.standard_normal((n_lambda, 5, 4))
    otf = torch.as_tensor(fft.ir2fr(stamps, shape)).to(device, torch.complex128)
    as_t = lambda a: torch.as_tensor(a).to(device, dtype)
    return (as_t(rng.standard_normal((n_maps,) + shape)), as_t(rng.random((n_maps, n_lambda))),
            as_t(rng.standard_normal((n_lambda,) + shape)),
            otf.to(torch.complex128 if dtype == torch.float64 else torch.complex64))


CASES = [pytest.param(m, nb, lam, chunk, id=f"M{m}-Nb{nb}-L{lam}-chunk{chunk}")
         for m in (1, 4) for nb in (31, 32) for lam, chunk in ((23, 5), (7, 1))]


@pytest.mark.parametrize("n_maps,nb,n_lambda,chunk", CASES)
def test_forward_is_t_then_the_conv(n_maps, nb, n_lambda, chunk):
    maps, tpl, _, otf = _problem(n_maps, n_lambda, (29, nb))
    want = fft.conv_otf_(lmm.lmm_maps2cube(maps, tpl), otf, chunk=chunk)
    chunks = fft.lmm_conv_otf(maps, tpl, otf, chunk=chunk)
    assert [c.shape[0] for c in chunks] == [min(chunk, n_lambda - i) for i in range(0, n_lambda, chunk)]
    got = torch.cat(chunks)
    assert tuple(got.shape) == (n_lambda, 29, nb) and got.dtype == torch.float64
    assert rel(got, want) <= TOL
    for start, stop in ((0, n_lambda), (1, n_lambda - 1), (3, 4), (chunk - 1, chunk + 1)):
        assert torch.equal(torch.cat(fft.cube_planes(chunks, start, stop)), got[start:stop])


@pytest.mark.parametrize("n_maps,nb,n_lambda,chunk", CASES)
def test_adjoint_is_the_conv_then_tt(n_maps, nb, n_lambda, chunk):
    _, tpl, cube, otf = _problem(n_maps, n_lambda, (29, nb))
    kept = cube.clone()
    want = lmm.lmm_cube2maps(fft.conv_otf_(cube.clone(), otf, conj=True, chunk=chunk), tpl)
    got = fft.lmm_conv_otf_t(cube, tpl, otf, chunk=chunk)
    assert tuple(got.shape) == (n_maps, 29, nb) and got.dtype == torch.float64
    assert rel(got, want) <= TOL
    assert torch.equal(cube, kept)


@pytest.mark.parametrize("n_maps,nb,n_lambda,chunk", CASES)
def test_the_pair_is_a_transpose_pair(n_maps, nb, n_lambda, chunk):
    maps, tpl, cube, otf = _problem(n_maps, n_lambda, (29, nb), seed=1)
    lhs = float(torch.sum(torch.cat(fft.lmm_conv_otf(maps, tpl, otf, chunk=chunk)) * cube))
    rhs = float(torch.sum(maps * fft.lmm_conv_otf_t(cube, tpl, otf, chunk=chunk)))
    assert abs(lhs - rhs) <= TOL * abs(lhs)


def test_tracked_maps_take_the_differentiable_route():
    """Under autograd the forward is T then `convolve_freq` (no in-place
    write, one chunk), and the derived transpose equals the pair's adjoint."""
    maps, tpl, cube, otf = _problem(4, 23, (29, 31), seed=2)
    out, vjp = torch.func.vjp(lambda x: fft.lmm_conv_otf(x, tpl, otf, chunk=5), maps)
    assert len(out) == 1
    assert rel(out[0], torch.cat(fft.lmm_conv_otf(maps, tpl, otf, chunk=5))) <= TOL
    assert rel(vjp([cube])[0], fft.lmm_conv_otf_t(cube, tpl, otf, chunk=5)) <= TOL


@pytest.mark.cuda
def test_float32_on_the_card_is_as_close_as_the_replaced_route():
    """float32 on the card against float64 at 501² (the flagship's planes,
    odd: cuFFT's Bluestein path), 600 λ-planes (three chunks, the last
    short), four maps; relative to the largest value of the float64 result."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: this compares the card's float32 with float64")
    dev = torch.device("cuda")
    maps, tpl, cube, otf = _problem(4, 600, (501, 501), seed=3, dtype=torch.float64, device=dev)
    want_f = torch.cat(fft.lmm_conv_otf(maps, tpl, otf))
    want_t = fft.lmm_conv_otf_t(cube, tpl, otf)
    f32 = [t.float() for t in (maps, tpl, cube)]
    maps32, tpl32, cube32 = f32
    otf32 = otf.to(torch.complex64)
    got_f = torch.cat(fft.lmm_conv_otf(maps32, tpl32, otf32))
    got_t = fft.lmm_conv_otf_t(cube32, tpl32, otf32)
    old_f = fft.conv_otf_(lmm.lmm_maps2cube(maps32, tpl32), otf32)
    old_t = lmm.lmm_cube2maps(fft.conv_otf_(cube32.clone(), otf32, conj=True), tpl32)
    errs = {name: rel(g.double(), w) for name, g, w in (
        ("forward", got_f, want_f), ("adjoint", got_t, want_t),
        ("replaced forward", old_f, want_f), ("replaced adjoint", old_t, want_t))}
    print(errs)
    assert errs["forward"] <= 1e-5 and errs["adjoint"] <= 1e-5, errs
    assert errs["forward"] <= 2 * errs["replaced forward"], errs
    assert errs["adjoint"] <= 2 * errs["replaced adjoint"], errs
