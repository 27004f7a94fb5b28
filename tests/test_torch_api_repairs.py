"""The port's public API against the reference's where they had drifted
apart (ROADMAP C8–C11), on the CPU in float64.

* C8: every name in a reference package's `__all__` whose module the port
  has imports from the port's package, as the same object as in its module;
* C9: `DifferenceOperatorJoint(shape_target, dtype, device)` in the
  reference's order, with `D_t`, and `diff_rows_t` / `diff_cols_t`, against
  the JAX package's and as exact transposes;
* C10: `dtype=None` builds float32 in `make_model` and
  `make_flagship_model`, the reference's default;
* C11: `fft.convolve_freq` / `dft_mult` / `idft_mult`, `center=` on
  `psf_stamp_tables` and `otf_support_from_psf`, `dtype=` on
  `apply_transpose_plan`, `utils.psf.otf`, `flagship_wavel_axis`, and the
  Shepard regrid's `backend=`.
"""

import importlib
import importlib.util
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

REF_PACKAGES = ["models", "solvers", "simulation", "preprocessing", "learning", "parallel"]


def rel(a, b) -> float:
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.mark.parametrize("pkg", REF_PACKAGES)
def test_reference_exports_import_from_the_port(pkg):
    ref = importlib.import_module(f"surfh_tpu.{pkg}")
    port = importlib.import_module(f"surfh_tpu_torch.{pkg}")
    checked = 0
    for name in ref.__all__:
        obj = getattr(ref, name)  # an alias names its object's module (MCMO_SigRLSCT: spectro)
        mod = obj.__module__.replace("surfh_tpu.", "surfh_tpu_torch.", 1)
        if importlib.util.find_spec(mod) is None:
            continue  # a JAX-only module (ROADMAP "Do not port")
        assert getattr(port, name) is getattr(importlib.import_module(mod), obj.__name__), name
        checked += 1
    assert checked > 0


def test_difference_operator_joint_takes_the_reference_order(monkeypatch):
    from surfh_tpu.solvers import criterion as jc
    from surfh_tpu_torch.solvers import criterion as tc

    shape = (9, 8)
    op = tc.DifferenceOperatorJoint(shape, np.float64, "cpu")
    jop = jc.DifferenceOperatorJoint(shape, jnp.float64)
    assert op.d_freq.dtype == torch.complex128
    assert tc.DifferenceOperatorJoint(shape, device="cpu").d_freq.dtype == torch.complex64
    x = np.random.default_rng(0).standard_normal((2,) + shape)
    for name in ("D", "D_t", "DtD"):
        assert rel(getattr(op, name)(torch.as_tensor(x)).numpy(),
                   np.asarray(getattr(jop, name)(jnp.asarray(x)))) <= 1e-12
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):  # device None: the card
        tc.DifferenceOperatorJoint(shape)


@pytest.mark.parametrize("name", ["diff_rows", "diff_cols"])
def test_difference_transposes(name):
    from surfh_tpu.solvers import criterion as jc
    from surfh_tpu_torch.solvers import criterion as tc

    rng = np.random.default_rng(1)
    x, y = rng.standard_normal((2, 7, 6)), rng.standard_normal((2, 7, 6))
    f, ft = getattr(tc, name), getattr(tc, name + "_t")
    lhs = np.vdot(f(torch.as_tensor(x)).numpy(), y)
    rhs = np.vdot(x, ft(torch.as_tensor(y)).numpy())
    assert abs(lhs - rhs) <= 1e-12 * abs(lhs)
    np.testing.assert_array_equal(ft(torch.as_tensor(y)).numpy(),
                                  np.asarray(getattr(jc, name + "_t")(jnp.asarray(y))))


def test_dtype_none_builds_float32(monkeypatch):
    from surfh_tpu.simulation import flagship as jflag
    from surfh_tpu.simulation import synthetic as jsyn
    from surfh_tpu_torch.simulation import flagship, synthetic

    for port, ref in ((synthetic.make_model, jsyn.make_model),
                      (flagship.make_flagship_model, jflag.make_flagship_model)):
        assert inspect.signature(port).parameters["dtype"].default is None
        assert inspect.signature(ref).parameters["dtype"].default is None
    model, _ = synthetic.make_model(dtype=None, im_size=21, n_lambda=12, n_tpl=2, n_channels=1,
                                    n_pointings=1, n_slit=3)
    assert model.npdtype == np.float32
    monkeypatch.setenv("SURFH_TABLE_CACHE", "0")
    setup = flagship.make_flagship_setup(npix=31, bands=["1a"], n_pointings=1, lambda_subsample=24)
    fmodel, _ = flagship.make_flagship_model(setup, dtype=None, conv_rank_rtol=0.0)
    assert fmodel.npdtype == np.float32


def test_fft_convolution_helpers_match_jax():
    from surfh_tpu.core import fft as jfft
    from surfh_tpu_torch.core import fft

    rng = np.random.default_rng(2)
    shape = (11, 9)
    cube = rng.standard_normal((3,) + shape)
    otf = jfft.ir2fr(rng.random((3, 5, 5)), shape)
    spec = fft.dft(torch.as_tensor(cube)).numpy()
    t = torch.as_tensor
    assert rel(fft.convolve_freq(t(cube), t(otf), shape).numpy(),
               np.asarray(jfft.convolve_freq(jnp.asarray(cube), otf, shape))) <= 1e-12
    assert rel(fft.dft_mult(t(cube), t(otf)).numpy(), np.asarray(jfft.dft_mult(jnp.asarray(cube), otf))) <= 1e-12
    assert rel(fft.idft_mult(t(spec), t(otf), shape).numpy(),
               np.asarray(jfft.idft_mult(jnp.asarray(spec), otf, shape))) <= 1e-12


def test_stamp_tables_take_a_center():
    from surfh_tpu.core import fft as jfft
    from surfh_tpu_torch.core import fft

    im, stamp, center = (31, 28), (8, 6), (2, 5)
    for k in ("sa_re", "sa_im", "sb_re", "sb_im"):
        np.testing.assert_array_equal(
            fft.psf_stamp_tables(im, stamp, np.float64, center=center)[k],
            jfft.psf_stamp_tables(im, stamp, np.float64, center=center)[k])
    psf = np.random.default_rng(3).random((4,) + stamp)
    assert (fft.otf_support_from_psf(psf, im, 1e-3, center=center)
            == jfft.otf_support_from_psf(psf, im, 1e-3, center=center))


def test_apply_transpose_plan_takes_a_dtype():
    from surfh_tpu_torch.core import bilinear

    rng = np.random.default_rng(4)
    axis = np.linspace(0, 1, 7)
    plan = bilinear.bilinear_plan(axis, axis, rng.uniform(0.05, 0.95, (20, 2)))
    vals = torch.as_tensor(rng.standard_normal((2, 20)), dtype=torch.float32)
    out = bilinear.apply_transpose_plan(bilinear.transpose_plan(plan), vals, dtype=np.float64)
    assert out.dtype == torch.float64 and out.shape == (2, 7, 7)
    want = bilinear.scatter_plan(plan.idx, plan.w, vals.double(), plan.shape)
    assert rel(out.numpy(), want.numpy()) <= 1e-12


def test_psf_otf_matches_jax():
    from surfh_tpu.utils import psf as jpsf
    from surfh_tpu_torch.utils import psf

    rng = np.random.default_rng(5)
    stamp, comps = rng.random((6, 5)), rng.random((3, 4))
    np.testing.assert_array_equal(psf.otf(stamp, (12, 10), comps), jpsf.otf(stamp, (12, 10), comps))


def test_flagship_wavel_axis_matches_jax():
    from surfh_tpu.simulation import flagship as jflag
    from surfh_tpu_torch.simulation import flagship

    np.testing.assert_array_equal(flagship.flagship_wavel_axis(), jflag.flagship_wavel_axis())
    np.testing.assert_array_equal(flagship.flagship_wavel_axis(["1c", "2a"], 2),
                                  jflag.flagship_wavel_axis(["1c", "2a"], 2))


def test_shepard_takes_the_reference_backends():
    from surfh_tpu_torch.preprocessing.shepard import exponential_modified_shepard

    rng = np.random.default_rng(6)
    a, lam, v = rng.random(40), rng.random(40), rng.random(40)
    am, lm = np.meshgrid(np.linspace(0, 1, 9), np.linspace(0, 1, 7))
    args = (a, lam, v, am, lm)
    kw = dict(pixel_cutoff=3.0, alpha_res=0.1, lambda_res=0.1, device="cpu")
    base = exponential_modified_shepard(*args, **kw)
    for backend in ("auto", "jax"):
        np.testing.assert_array_equal(exponential_modified_shepard(*args, backend=backend, **kw), base)
    with pytest.raises(NotImplementedError, match="Do not port"):
        exponential_modified_shepard(*args, backend="native", **kw)
    with pytest.raises(ValueError, match="backend"):
        exponential_modified_shepard(*args, backend="cuda", **kw)
