"""surfh_tpu_torch's materialized-OTF (W-plane) model against the JAX
reference's `SpectroSigRLSCT(sotf, window_local=False, wblur_impl=…)` (CPU,
float64).

* forward / adjoint / normal (= adjoint∘forward, as the reference criterion
  composes it for this mode), with the reference's tables carried across
  (`convert.wplane_tables_from_reference`) and with the port's own: dense
  ≤1e-12 relative; banded ≤1e-5 (the reference's banded kernels compute in
  f32 with f32 blocked weights, even in an x64 model);
* the dense pair's dot test ≤1e-12; the banded pair's dot-test mismatch
  (its two masks differ by design) equals the reference's own to ≤1e-6;
* the device `ir2fr` against the host one ≤1e-12;
* the `wblur_band_rtol` accuracy contract of tests/test_wblur_pallas.py;
* 5 `lcg` iterations of `QuadCriterion_MRS` on the dense model ≤1e-9.
"""

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from surfh_tpu.core.fft import ir2fr as jax_ir2fr
from surfh_tpu.simulation.synthetic import make_model as jax_make_model
from surfh_tpu.simulation.synthetic import make_setup as jax_make_setup
from surfh_tpu.solvers.criterion import QuadCriterion_MRS as JaxCriterion
from surfh_tpu_torch.convert import wplane_tables_from_reference
from surfh_tpu_torch.core import fft
from surfh_tpu_torch.models.spectro import SpectroSigRLSCT
from surfh_tpu_torch.simulation.synthetic import make_model, make_setup
from surfh_tpu_torch.solvers.criterion import QuadCriterion_MRS
from surfh_tpu_torch.utils.psf import gaussian_psf

torch.set_num_threads(2)

KW = dict(im_size=31, n_lambda=24, n_tpl=3, n_channels=2, n_pointings=2, n_slit=3)
# one band whose λ'-axis spans several 128-row tiles, so banding truncates
# (the reference's accuracy-contract configuration)
TRUNC_KW = dict(im_size=31, n_lambda=200, n_tpl=3, n_channels=1, n_pointings=1, n_slit=3,
                detector_oversample=4)
RTOL = 1e-4
MU_REG = 5e3
TOL = {"dense": 1e-12, "banded": 1e-5}


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _ref_channels(jm, banded):
    return [(c._wpsf_dev, c.slit_weights_sub, c._composed_stack, c._tbbox,
             c.band_plan() if banded else None, c.band_plan_t() if banded else None)
            for c in jm.channels]


def _pair(kw, impl, rtol):
    jsetup, psetup = jax_make_setup(**kw), make_setup(**kw)
    jm, _ = jax_make_model(setup=jsetup, dtype=jnp.float64, wblur_impl=impl, wblur_band_rtol=rtol)
    args = dict(setup=psetup, dtype=np.float64, window_local=False, wblur_impl=impl,
                wblur_band_rtol=rtol)
    pm = make_model(**args)[0].to("cpu", torch.float64)
    tables = wplane_tables_from_reference(jm._sotf_dev, jm._templates_dev,
                                          _ref_channels(jm, impl == "banded"), "cpu", torch.float64)
    ref = make_model(**args)[0].to("cpu", torch.float64, tables=tables)
    return SimpleNamespace(jm=jm, pm=pm, ref=ref, x=np.array(jsetup["maps"]), psetup=psetup)


@pytest.fixture(scope="module", params=["dense", "banded"])
def small(request):
    impl = request.param
    p = _pair(KW, impl, RTOL)
    rng = np.random.default_rng(3)
    p.impl = impl
    p.yr = rng.standard_normal(p.jm.oshape)
    y = p.jm.forward(p.x)
    p.want = {
        "forward": np.asarray(y),
        "adjoint": np.asarray(p.jm.adjoint(p.yr)),
        "normal": np.asarray(p.jm.adjoint(y)),
    }
    return p


@pytest.fixture(scope="module")
def truncating():
    return {impl: _pair(TRUNC_KW, impl, 1e-3) for impl in ("dense", "banded")}


@pytest.mark.parametrize("tables", ["reference", "own"])
@pytest.mark.parametrize("op", ["forward", "adjoint", "normal"])
def test_operator_matches_reference(small, op, tables):
    model = small.ref if tables == "reference" else small.pm
    arg = small.yr if op == "adjoint" else small.x
    got = getattr(model, op)(torch.as_tensor(arg)).numpy()
    want = small.want[op]
    assert got.shape == want.shape
    assert rel(got, want) <= TOL[small.impl]


def test_band_plans_match_reference(truncating):
    p = truncating["banded"]
    for chan, jchan in zip(p.pm.channels, p.jm.channels):
        got, want = chan.band_plan(1e-3), jchan.band_plan()
        np.testing.assert_array_equal(got.starts, want.starts)
        assert (got.LB, got.TK, got.Bp) == (want.LB, want.TK, want.Bp)
        got_t, want_t = chan.band_plan_t(1e-3), jchan.band_plan_t()
        np.testing.assert_array_equal(got_t.starts, want_t.starts)
        assert (got_t.KB, got_t.TL, got_t.Bp) == (want_t.KB, want_t.TL, want_t.Bp)


def _dot_mismatch(fwd, adj, shape_x, shape_y, seed):
    rng = np.random.default_rng(seed)
    x, y = rng.standard_normal(shape_x), rng.standard_normal(shape_y)
    lhs = float(np.vdot(np.asarray(fwd(x), np.float64).ravel(), y.ravel()))
    rhs = float(np.vdot(x.ravel(), np.asarray(adj(y), np.float64).ravel()))
    return abs(lhs - rhs) / abs(lhs)


def _port_ops(model):
    return (lambda x: model.forward(torch.as_tensor(x)).numpy(),
            lambda y: model.adjoint(torch.as_tensor(y)).numpy())


def test_dense_pair_dot_test():
    pm = make_model(setup=make_setup(**KW), dtype=np.float64, window_local=False)[0]
    pm.to("cpu", torch.float64)
    assert _dot_mismatch(*_port_ops(pm), pm.ishape, pm.oshape, 5) <= 1e-12


def test_banded_pair_dot_mismatch_equals_reference(truncating):
    p = truncating["banded"]
    got = _dot_mismatch(*_port_ops(p.pm), p.pm.ishape, p.pm.oshape, 7)
    want = _dot_mismatch(p.jm.forward, p.jm.adjoint, p.jm.ishape, p.jm.oshape, 7)
    print(f"banded dot mismatch: port {got:.6e}, reference {want:.6e}")
    assert got > 1e-9  # the two masks differ: not an exact pair
    assert abs(got - want) <= 1e-6


def test_truncating_banded_matches_reference(truncating):
    p = truncating["banded"]
    assert p.pm.channels[0].band_plan(1e-3).density < 1.0
    got = p.pm.forward(torch.as_tensor(p.x)).numpy()
    assert rel(got, np.asarray(p.jm.forward(p.x))) <= 1e-5
    yr = np.random.default_rng(8).standard_normal(p.jm.oshape)
    assert rel(p.pm.adjoint(torch.as_tensor(yr)).numpy(), np.asarray(p.jm.adjoint(yr))) <= 1e-5


def test_band_rtol_accuracy_contract(truncating):
    """wblur_band_rtol trades work for a truncation error of its order."""
    x = torch.as_tensor(truncating["dense"].x)
    y_exact = truncating["dense"].pm.forward(x).numpy()
    y_approx = truncating["banded"].pm.forward(x).numpy()
    err = rel(y_approx, y_exact)
    assert 0 < err < 5e-2


@pytest.mark.parametrize("shape", [(31, 31), (45, 50)])
def test_device_ir2fr_matches_host(shape):
    psf = gaussian_psf(np.linspace(5.0, 27.0, 9), 0.025)[:, 5:36, 4:35]  # odd 31 x 31 stamps
    got = fft.ir2fr_device(psf, shape, "cpu", torch.complex128, chunk=4).numpy()
    want = jax_ir2fr(psf, shape)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()


def test_fft_conv_is_the_reference_conv():
    setup = make_setup(**KW)
    cube = torch.as_tensor(np.random.default_rng(2).standard_normal((24, 31, 31)))
    otf = torch.as_tensor(setup["sotf"])
    want = np.fft.irfftn(np.fft.rfftn(cube.numpy(), axes=(-2, -1), norm="ortho") * setup["sotf"],
                         s=(31, 31), axes=(-2, -1), norm="ortho")
    got = torch.cat(fft.conv_otf_chunks(cube, otf, chunk=5))
    assert tuple(got.shape) == (24, 31, 31)
    assert rel(got.numpy(), want) <= 1e-12
    back = fft.conv_otf_chunks_t(cube.clone(), otf, chunk=7)
    lhs, rhs = float(torch.sum(got * cube)), float(torch.sum(cube * back))
    assert abs(lhs - rhs) <= 1e-12 * abs(lhs)


def test_lcg_iterates_match_reference():
    p = _pair(KW, "dense", 0.0)
    y = np.array(p.jm.forward(p.x))
    jres = JaxCriterion(1.0, y, p.jm, MU_REG).run_method("lcg", maximum_iterations=5)
    res = QuadCriterion_MRS(1.0, torch.as_tensor(y), p.pm, MU_REG).run_method(
        "lcg", maximum_iterations=5)
    assert res.n_iter == jres.n_iter == 5
    assert rel(res.x.numpy(), jres.x) <= 1e-9
    assert res.grad_norm[-1] < res.grad_norm[0]


def test_maps_to_cube_matches_reference():
    p = _pair(KW, "dense", 0.0)
    assert rel(p.pm.mapsToCube(torch.as_tensor(p.x)).numpy(),
               np.asarray(p.jm.mapsToCube(p.x))) <= 1e-12


def test_patch_rows_are_contiguous_and_transposed_exactly():
    """The gather kernel reads contiguous [ha·wb, W] rows, also when the
    bbox spans whole sky rows (the relayout would then reshape to a strided
    view: channel 1 here, bbox (1, 0, 30, 31) on the 31² sky)."""
    pm = make_model(setup=make_setup(**KW), dtype=np.float64, window_local=False)[0]
    pm.to("cpu", torch.float64)
    rng = np.random.default_rng(4)
    cube = torch.as_tensor(rng.standard_normal(pm.cube_shape))
    assert any(chan.tbbox[3] == pm.imshape[1] for chan in pm.channels)
    for c, chan in enumerate(pm.channels):
        rows = pm.patch_rows(list(cube.split(5)), c)
        assert rows.is_contiguous() and tuple(rows.shape) == (
            chan.tbbox[2] * chan.tbbox[3], chan.n_wslice)
        r = torch.as_tensor(rng.standard_normal(tuple(rows.shape)))
        back = torch.zeros_like(cube)
        pm.add_patch_rows_(back, r, c)
        assert abs(float(torch.sum(rows * r)) - float(torch.sum(cube * back))) <= 1e-12 * float(
            torch.sum(torch.abs(rows * r)))


def test_mixing_the_modes_raises():
    """The reference's argument order (`sotf` first): what neither mode
    takes raises ValueError with the reference's text, what the port has not
    ported NotImplementedError (tests/test_torch_solver_api.py has them all);
    a window-local model over the sotf builds the OTF-window tables."""
    s = make_setup(**KW)
    args = (s["templates"], s["alpha_axis"], s["beta_axis"], s["wavelength_axis"], s["instrs"],
            s["step_degree"], s["pointings"])
    otf_windows = SpectroSigRLSCT(s["sotf"], *args, window_local=True)
    assert otf_windows.conv_impl == "matmul"
    assert all("sotf_w" in t and "dftm" in t for t in otf_windows.host_tables()["chan"])
    with pytest.raises(ValueError, match="need sotf or psf_stack"):
        SpectroSigRLSCT(None, *args, window_local=False)
    with pytest.raises(ValueError, match="psf_stack-only mode requires window_local=True"):
        SpectroSigRLSCT(None, *args, psf_stack=s["spsf"])
    # banded with window_local=True warns and goes on dense; at this size the
    # rank gate then declines (M·R ≥ W/2): the dense stamp tables
    with pytest.warns(UserWarning, match="falling back to the dense"):
        declined = SpectroSigRLSCT(None, *args, wblur_impl="banded", window_local=True,
                                   psf_stack=s["spsf"], conv_rank_rtol=1e-7)
    assert declined.wblur_impl == "dense"
    assert all("psf" in t and "cu" not in t for t in declined.host_tables()["chan"])
    dense = make_model(setup=s, window_local=False)[0].to("cpu", torch.float64)
    dense.wblur_impl = "banded"
    with pytest.raises(ValueError, match="no band tables"):
        dense.forward(torch.as_tensor(s["maps"]))
