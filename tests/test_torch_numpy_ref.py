"""surfh_tpu_torch's NumPy oracle (`core.numpy_ref`) against the JAX
package's (CPU, float64), and the port's torch operators against it.

* the kernels (`dft` / `idft`, the LMM pair, the four blurs, the plan
  gather and its scatter-add adjoint) on the same inputs: bit for bit;
* the reference-structured pipelines on each package's own objects: the
  port's oracle on the port's `Channel` / `SpectroSigRLSCT` against the
  reference's oracle on the JAX ones ≤1e-12 relative, and the port's torch
  `Channel.forward` / `adjoint_windowed` and model `forward` / `adjoint`
  against the port's oracle ≤1e-12 (the oracle's FFT box-sum against the
  composed gather: the same linear map).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from surfh_tpu.core import numpy_ref as jref
from surfh_tpu.core.bilinear import bilinear_plan as jax_bilinear_plan
from surfh_tpu.simulation.synthetic import make_model as jax_make_model
from surfh_tpu.simulation.synthetic import make_setup as jax_make_setup
from surfh_tpu_torch.core import numpy_ref
from surfh_tpu_torch.core.bilinear import bilinear_plan
from surfh_tpu_torch.simulation.synthetic import make_model, make_setup

from test_torch_channel_cube import channel_pair

torch.set_num_threads(2)

KW = dict(im_size=31, n_lambda=40, n_tpl=2, n_channels=2, n_pointings=2, n_slit=3)


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


def test_kernels_bit_for_bit():
    rng = np.random.default_rng(0)
    a = rng.standard_normal((3, 12, 10))
    np.testing.assert_array_equal(numpy_ref.dft(a), jref.dft(a))
    np.testing.assert_array_equal(numpy_ref.idft(jref.dft(a), (12, 10)), jref.idft(jref.dft(a), (12, 10)))
    tpl = rng.standard_normal((3, 7))
    cube = rng.standard_normal((7, 12, 10))
    np.testing.assert_array_equal(numpy_ref.lmm_maps2cube(a, tpl), jref.lmm_maps2cube(a, tpl))
    np.testing.assert_array_equal(numpy_ref.lmm_cube2maps(cube, tpl), jref.lmm_cube2maps(cube, tpl))
    wpsf = rng.standard_normal((5, 7, 10))
    arr = rng.standard_normal((7, 12, 10))
    yk = rng.standard_normal((5, 12))
    for f, args in (("wblur", (arr, wpsf)), ("wblur_t", (rng.standard_normal((5, 12, 10)), wpsf)),
                    ("wblur_sum_beta", (arr, wpsf)), ("wblur_sum_beta_t", (yk, wpsf, 10))):
        np.testing.assert_array_equal(getattr(numpy_ref, f)(*args), getattr(jref, f)(*args), err_msg=f)
    ax, bx = np.linspace(-1, 1, 12), np.linspace(-1, 1, 10)
    pts = rng.uniform(-1.1, 1.1, (60, 2))
    pp, jp = bilinear_plan(ax, bx, pts), jax_bilinear_plan(ax, bx, pts)
    np.testing.assert_array_equal(numpy_ref.apply_plan(pp, cube), jref.apply_plan(jp, cube))
    vals = rng.standard_normal((7, 60))
    np.testing.assert_array_equal(numpy_ref.scatter_plan(pp, vals, (12, 10)),
                                  jref.scatter_plan(jp, vals, (12, 10)))


@pytest.mark.parametrize("mode", ["composed", "staged"])
def test_channel_pipelines(monkeypatch, mode):
    jc, pc = channel_pair(monkeypatch, mode)
    rng = np.random.default_rng(3)
    x, y = rng.standard_normal(pc.ishape), rng.standard_normal(pc.oshape)
    want_f, want_a = numpy_ref.channel_forward(pc, x), numpy_ref.channel_adjoint(pc, y)
    assert rel(want_f, jref.channel_forward(jc, x)) <= 1e-12
    assert rel(want_a, jref.channel_adjoint(jc, y)) <= 1e-12
    assert rel(pc.forward(x), want_f) <= 1e-12
    assert rel(pc.adjoint_windowed(y), want_a) <= 1e-12


@pytest.mark.parametrize("lmm", [True, False])
def test_spectro_pipelines(lmm):
    setup, jsetup = make_setup(**KW), jax_make_setup(**KW)
    if not lmm:
        setup["templates"] = jsetup["templates"] = None
    pm, _ = make_model(setup=setup, dtype=np.float64)
    jm, _ = jax_make_model(setup=jsetup, dtype=jnp.float64)
    pm.to("cpu", torch.float64)
    rng = np.random.default_rng(5)
    x, y = rng.standard_normal(pm.ishape), rng.standard_normal(pm.oshape)
    want_f, want_a = numpy_ref.spectro_forward(pm, x), numpy_ref.spectro_adjoint(pm, y)
    assert rel(want_f, jref.spectro_forward(jm, x)) <= 1e-12
    assert rel(want_a, jref.spectro_adjoint(jm, y)) <= 1e-12
    assert rel(pm.forward(x), want_f) <= 1e-12
    assert rel(pm.adjoint(y), want_a) <= 1e-12
