"""surfh_tpu_torch's mixing models, block-Fourier algebra, closed-form and
Huber solvers against the JAX package (CPU, float64), on the reference
suite's fixture (tests/test_mixing.py: `Model_WCT` with 3 templates, 12
planes, a 24 × 20 image, 11 × 11 Gaussian PSFs, di = dj = 2), inputs from
a NumPy seed.

* `Model_WCT`: its tables (the reference's H_spec_freq and the block
  Hessian), forward and derived adjoint ≤1e-12 of the JAX model's; the dot
  test at 1e-10; `fwadj` against adjoint∘forward at 1e-10; `MixingST` the
  same way;
* the block-Fourier algebra against the JAX package's, and its inverse;
* `run_expsol`: the normal equations' residual (the reference's bar,
  rtol 1e-5) and x̂ against the JAX solve's;
* `mmmg_huber` / `lmm_reconstruction`: 20 iterations' iterate ≤1e-9 of the
  JAX package's; the gradient's fall (the reference's bar); both loops;
* `vox_reconstruction` on a cube-mode W-plane `SpectroSigRLSCT`: 10
  iterations' iterate and history ≤1e-9 of the JAX package's;
* `QuadCriterion_MRS(use_fwadj=True)`: 20 lcg iterations against 20 through
  adjoint∘forward and against the JAX criterion's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from surfh_tpu.core import blockfourier as jbf
from surfh_tpu.models.mixing import MixingST as JaxMixingST
from surfh_tpu.models.mixing import Model_WCT as JaxWCT
from surfh_tpu.solvers import huber as jhuber
from surfh_tpu.solvers.criterion import QuadCriterion_MRS as JaxCrit
from surfh_tpu.solvers.expsol import QuadCriterion3 as JaxQC3
from surfh_tpu_torch.core import blockfourier as bf
from surfh_tpu_torch.core.linop import dottest
from surfh_tpu_torch.models.mixing import MixingST, Model_WCT
from surfh_tpu_torch.solvers.criterion import (DifferenceOperatorJoint, QuadCriterion_MRS,
                                               dtd_separated)
from surfh_tpu_torch.solvers.expsol import QuadCriterion3
from surfh_tpu_torch.solvers.huber import (diff_axis, diff_axis_t, lmm_reconstruction, mmmg_huber,
                                           vox_reconstruction)
from surfh_tpu_torch.utils.psf import gaussian_psf

torch.set_num_threads(2)

OP_RTOL = 1e-12


def rel(a, b) -> float:
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / np.abs(b).max())


def wct_inputs():
    """tests/test_mixing.py's `wct` fixture inputs."""
    rng = np.random.default_rng(3)
    n_spec, n_lamb = 3, 12
    shape_target = (24, 20)
    psfs = gaussian_psf(np.linspace(7.5, 8.0, n_lamb), 0.5)
    ca = (psfs.shape[1] - 11) // 2
    psfs = psfs[:, ca : ca + 11, ca : ca + 11]
    psfs /= psfs.sum(axis=(1, 2), keepdims=True)
    specs = rng.random((n_spec, n_lamb)) + 0.5
    pce = rng.random(n_lamb) + 0.5
    maps = rng.random((n_spec,) + shape_target)
    return (psfs, specs, shape_target, pce), maps


@pytest.fixture(scope="module")
def wct():
    args, maps = wct_inputs()
    model = Model_WCT(*args, di=2, dj=2, dtype=torch.float64, device="cpu")
    jmodel = JaxWCT(*args, di=2, dj=2, dtype=jnp.float64)
    return model, jmodel, maps


def test_wct_tables_match_jax(wct):
    model, jmodel, _ = wct
    assert rel(model.H_spec_freq.numpy(), jmodel.H_spec_freq) <= OP_RTOL
    assert rel(model.hess_spec_freq.numpy(), jmodel.hess_spec_freq) <= OP_RTOL


def test_wct_forward_adjoint_match_jax(wct):
    model, jmodel, maps = wct
    y = np.random.default_rng(4).standard_normal(model.oshape)
    assert rel(model.forward(maps).numpy(), np.asarray(jmodel.forward(maps))) <= OP_RTOL
    assert rel(model.adjoint(y).numpy(), np.asarray(jmodel.adjoint(y))) <= OP_RTOL
    assert rel(model.fwadj(maps).numpy(), np.asarray(jmodel.fwadj(maps))) <= OP_RTOL


def test_wct_dottest(wct):
    assert dottest(wct[0], rtol=1e-10)


def test_wct_fwadj_matches_adjoint_forward(wct):
    model, _, maps = wct
    direct = model.adjoint(model.forward(maps)).numpy()
    np.testing.assert_allclose(model.fwadj(maps).numpy(), direct, rtol=1e-10, atol=1e-12)


def test_partition_roundtrip():
    rng = np.random.default_rng(0)
    x = rng.random((3, 12, 8)) + 1j * rng.random((3, 12, 8))
    part = bf.partition(torch.as_tensor(x), 3, 2)
    np.testing.assert_array_equal(part.numpy(), np.asarray(jbf.partition(jnp.asarray(x), 3, 2)))
    np.testing.assert_array_equal(bf.unpartition(part, (12, 8), 3, 2).numpy(), x)


def test_make_iHtH_inverts():
    rng = np.random.default_rng(1)
    S, D, h, w = 2, 4, 3, 3
    A = rng.random((S, S, D, D, h, w)) + 1j * rng.random((S, S, D, D, h, w))
    M = A.transpose(4, 5, 0, 2, 1, 3).reshape(h * w, S * D, S * D)
    M = M @ M.conj().transpose(0, 2, 1) + 5 * np.eye(S * D)
    A = M.reshape(h, w, S, D, S, D).transpose(2, 4, 3, 5, 0, 1)
    iA = bf.make_iHtH(torch.as_tensor(A)).numpy()
    prod = np.einsum("abijhw,bcjkhw->acikhw", A, iA)
    eye = np.zeros_like(prod)
    for s in range(S):
        for d in range(D):
            eye[s, s, d, d] = 1.0
    np.testing.assert_allclose(prod, eye, atol=1e-8)
    assert rel(iA, np.asarray(jbf.make_iHtH(A))) <= 1e-12
    x = rng.standard_normal((S, 2 * h, 2 * w))
    assert rel(bf.apply_hessian(torch.as_tensor(A), 2, 2, (2 * h, 2 * w), torch.as_tensor(x)).numpy(),
               np.asarray(jbf.apply_hessian(A, 2, 2, (2 * h, 2 * w), jnp.asarray(x)))) <= OP_RTOL


@pytest.mark.parametrize("gradient", ["separated", "joint"])
def test_expsol_solves_normal_equations(wct, gradient):
    """x̂ satisfies (HᵗH + µ DᵗD) x̂ = Hᵗ y: the reference's bar (rtol 1e-5),
    and to 1e-10 of Hᵗy as the JAX solve's x̂ does.  The two x̂ differ by
    the problem's own sensitivity: at µ = 1e-4 the regularized blocks'
    condition numbers reach ~4e5, and both residuals are ~5e-13 (3e-8
    between the two x̂, relative)."""
    model, jmodel, maps = wct
    y = model.forward(maps)
    mu = 1e-4
    x_hat = QuadCriterion3(y, model, mu, gradient=gradient).run_expsol()
    dtd = (dtd_separated if gradient == "separated"
           else DifferenceOperatorJoint(model.shape_target, torch.float64, "cpu").DtD)
    b = model.adjoint(y)
    jx = torch.as_tensor(np.array(JaxQC3(y.numpy(), jmodel, mu, gradient=gradient).run_expsol()))
    for x in (x_hat, jx):
        lhs = model.fwadj(x) + mu * dtd(x)
        np.testing.assert_allclose(lhs.numpy(), b.numpy(), rtol=1e-5, atol=1e-7)
        assert rel(lhs.numpy(), b.numpy()) <= 1e-10
    assert rel(x_hat.numpy(), jx.numpy()) <= 1e-6


def test_mixing_st_dottest_and_fwadj():
    rng = np.random.default_rng(5)
    n_tpl, n_lam, n = 3, 10, 12
    templates = rng.random((n_tpl, n_lam))
    sel = rng.random((n_lam, n, n)) > 0.7
    args = (templates, np.arange(n), np.arange(n), np.arange(n_lam))
    op = MixingST(*args, selection_arr=sel, dtype=torch.float64, device="cpu")
    jop = JaxMixingST(*args, selection_arr=sel, dtype=jnp.float64)
    assert dottest(op, rtol=1e-10)
    maps = rng.random((n_tpl, n, n))
    direct = op.adjoint(op.forward(maps)).numpy()
    np.testing.assert_allclose(op.fwadj(maps).numpy(), direct, rtol=1e-10)
    assert rel(op.forward(maps).numpy(), np.asarray(jop.forward(maps))) <= OP_RTOL
    assert rel(op.fwadj(maps).numpy(), np.asarray(jop.fwadj(maps))) <= OP_RTOL
    np.testing.assert_array_equal(op.mapsToCube(maps), jop.mapsToCube(maps))


def test_diff_axis_adjoint():
    rng = np.random.default_rng(2)
    x = rng.random((4, 6, 5))
    for ax in range(3):
        y = rng.random(tuple(s - (1 if i == ax else 0) for i, s in enumerate(x.shape)))
        d = diff_axis(torch.as_tensor(x), ax).numpy()
        dt = diff_axis_t(torch.as_tensor(y), ax, x.shape[ax]).numpy()
        assert abs(np.vdot(d, y) - np.vdot(x, dt)) < 1e-10
        np.testing.assert_array_equal(d, np.asarray(jhuber.diff_axis(jnp.asarray(x), ax)))
        np.testing.assert_array_equal(dt, np.asarray(jhuber.diff_axis_t(jnp.asarray(y), ax, x.shape[ax])))


def test_huber_mmmg_decreases_objective(wct):
    """The reference's bar after 30 iterations, and 20 iterations' iterate
    ≤1e-9 of the JAX package's."""
    model, jmodel, maps = wct
    y = model.forward(maps)
    res = lmm_reconstruction(y, model, spat_reg=1e-3, spat_th=0.1, max_iter=30)
    assert res.grad_norm[-1] < 0.05 * res.grad_norm[0]
    a = lmm_reconstruction(y, model, spat_reg=1e-3, spat_th=0.1, max_iter=20)
    b = jhuber.lmm_reconstruction(y.numpy(), jmodel, spat_reg=1e-3, spat_th=0.1, max_iter=20)
    assert rel(a.x.numpy(), b.x) <= 1e-9
    assert rel(a.grad_norm, b.grad_norm) <= 1e-9


@pytest.mark.parametrize("loop", ["graph", "dispatch"])
def test_mmmg_huber_matches_jax_on_a_dense_system(loop):
    """Both loops on the reference's dense toy system (test_mixing.py::
    test_mmmg_huber_dispatch_matches_graph): the same iterates as each
    other and as the JAX package's, the dispatch history in float32."""
    rng = np.random.default_rng(3)
    Hm = rng.standard_normal((40, 30))
    y = rng.standard_normal(40)
    H = torch.as_tensor(Hm)
    priors = [(lambda x: x, lambda x: x, 0.3, 0.05)]
    a = mmmg_huber(lambda x: H @ x, lambda r: H.T @ r, y, priors, torch.zeros(30, dtype=torch.float64),
                   max_iter=40, loop=loop)
    graph = mmmg_huber(lambda x: H @ x, lambda r: H.T @ r, y, priors,
                       torch.zeros(30, dtype=torch.float64), max_iter=40)
    j = jhuber.mmmg_huber(lambda x: jnp.asarray(Hm) @ x, lambda r: jnp.asarray(Hm).T @ r, y, priors,
                          jnp.zeros(30), max_iter=40, loop=loop)
    assert torch.equal(a.x, graph.x) and len(a.grad_norm) == 39
    assert rel(a.x.numpy(), j.x) <= 1e-10
    assert rel(a.grad_norm, j.grad_norm) <= (1e-6 if loop == "dispatch" else 1e-10)


def test_vox_reconstruction_matches_jax_on_a_cube_model(monkeypatch):
    """`vox_reconstruction` (the Huber MM on the cube) on the same cube-mode
    W-plane `SpectroSigRLSCT` (``templates=None``) in both packages: 10
    iterations' iterate ≤1e-9 of the JAX package's, and its history."""
    from surfh_tpu.simulation.synthetic import make_model as jax_make_model
    from surfh_tpu.simulation.synthetic import make_setup as jax_make_setup
    from surfh_tpu_torch.simulation.synthetic import make_model, make_setup

    monkeypatch.setenv("SURFH_TABLE_CACHE", "0")
    kw = dict(im_size=31, n_lambda=16, n_tpl=3, n_channels=2, n_pointings=1, n_slit=3)
    jmodel, _ = jax_make_model(setup=dict(jax_make_setup(**kw), templates=None), dtype=jnp.float64,
                               window_local=False)
    model, _ = make_model(setup=dict(make_setup(**kw), templates=None), dtype=np.float64, window_local=False)
    model.to("cpu", torch.float64)
    x = np.random.default_rng(8).random(model.ishape)
    y = model.forward(torch.as_tensor(x))
    prm = dict(spat_reg=0.5, spat_th=0.1, spec_reg=0.5, spec_th=0.1, max_iter=10)
    a = vox_reconstruction(y, model, **prm)
    b = jhuber.vox_reconstruction(y.numpy(), jmodel, **prm)
    assert rel(a.x.numpy(), b.x) <= 1e-9
    assert rel(a.grad_norm, b.grad_norm) <= 1e-9


def test_criterion_use_fwadj(wct):
    """`use_fwadj=True`: the block Hessian in place of adjoint∘forward — 20
    lcg iterations against 20 without it and against the JAX criterion's."""
    model, jmodel, maps = wct
    y = model.forward(maps)
    args = (1.0, y, model, 1e-3)
    a = QuadCriterion_MRS(*args, use_fwadj=True).run_method("lcg", 20)
    b = QuadCriterion_MRS(*args).run_method("lcg", 20)
    j = JaxCrit(1.0, y.numpy(), jmodel, 1e-3, use_fwadj=True).run_method("lcg", 20)
    assert rel(a.x.numpy(), b.x.numpy()) <= 1e-8
    assert rel(a.x.numpy(), np.asarray(j.x)) <= 1e-8


def test_criterion_use_fwadj_needs_a_fwadj():
    """A model without `fwadj` (the flagship operator) refuses use_fwadj."""
    from surfh_tpu_torch.simulation.synthetic import make_model

    model, s = make_model(im_size=21, n_lambda=12, n_tpl=2, n_channels=1, n_pointings=1, n_slit=3,
                          dtype=np.float64)
    model.to("cpu", torch.float64)
    with pytest.raises(ValueError, match="define fwadj"):
        QuadCriterion_MRS(1.0, model.forward(s["maps"]), model, 1.0, use_fwadj=True)
