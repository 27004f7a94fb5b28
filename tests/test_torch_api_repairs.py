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
  Shepard regrid's `backend=`;
* C13: `Channel(..., gridding, wblur_impl, wblur_band_rtol, slit_unroll,
  pointing_scan)` in the reference's order; a banded channel's `forward`
  runs the banded blur (the reference's interpret-mode Pallas kernel
  computes in float32 even in a float64 channel, so the port's float64
  forward is held to it at the interpret-mode kernel's bar of
  tests/test_torch_wblur_banded.py, ≤1e-6 relative, and at
  ``wblur_band_rtol=0`` to the port's own dense float64 forward at
  ≤1e-12); its adjoints are the dense transpose's, ≤1e-12; the band plans
  bit for bit through `convert`; `beta_step`, the cube / slice shapes and
  the resolved `pointing_scan`; `SpectroSigRLSCT`'s channels carry the
  model's blur, and `list_wslice`;
* C14: `SpectroC.sotf`, `QuadCriterion_MRS.dtype`;
* C15: `precision=` on the seven conv functions of `core/fft.py` (at the
  reference's position; "high" raises), `dft` / `idft`'s `inarray` and
  `LambdaShardedChannel.forward(cube_sharded)`, by keyword.
"""

import importlib
import importlib.util
import inspect
from contextlib import nullcontext

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


# ----------------------------------------------------------------------
# C13: the banded channel on cubes

BAND_KW = dict(im_size=31, n_lambda=96, n_channels=1, n_pointings=2, n_slit=3)  # LB < W at 1e-3
BANDED_TOL = 1e-6  # the reference's interpret-mode kernel computes in float32


def _channel_args(setup):
    from surfh_tpu.instrument.geometry import get_srf

    srf = get_srf([setup["instrs"][0].det_pix_size], setup["step_degree"] * 3600)[0]
    return (setup["instrs"][0], setup["alpha_axis"], setup["beta_axis"], setup["wavelength_axis"],
            srf, setup["pointings"][0], setup["step_degree"])


@pytest.fixture(scope="module", params=[0.0, 1e-3], ids=["rtol0", "rtol1e-3"])
def banded(request):
    from surfh_tpu.models.channel import Channel as JaxChannel
    from surfh_tpu.simulation.synthetic import make_setup as jax_make_setup
    from surfh_tpu_torch.models.channel import Channel
    from surfh_tpu_torch.simulation.synthetic import make_setup

    rtol = request.param
    jargs, pargs = _channel_args(jax_make_setup(**BAND_KW)), _channel_args(make_setup(**BAND_KW))
    jc = JaxChannel(*jargs, jnp.float64, "bilinear", "banded", rtol)  # the reference's order
    pc = Channel(*pargs, np.float64, "bilinear", "banded", rtol).to("cpu", torch.float64)
    dense = Channel(*pargs, np.float64).to("cpu", torch.float64)
    rng = np.random.default_rng(7)
    return jc, pc, dense, rng.standard_normal(jc.ishape), rng.standard_normal(jc.oshape), rtol


def test_banded_channel_forward(banded):
    jc, pc, dense, x, _, rtol = banded
    got = pc.forward(x).numpy()
    assert got.shape == jc.oshape
    assert rel(got, np.asarray(jc.forward(x))) <= BANDED_TOL
    np.testing.assert_array_equal(got, pc.forward(x, plain=True).numpy())  # the CPU's plain version
    if rtol == 0.0:
        assert rel(got, dense.forward(x).numpy()) <= 1e-12
    else:
        assert pc.band_plan().LB < pc.band_plan().W  # the band truncates here


def test_banded_channel_adjoints_are_the_dense_transpose(banded):
    jc, pc, dense, x, y, _ = banded
    for name in ("adjoint", "adjoint_windowed", "adjoint_interp"):
        got = getattr(pc, name)(y).numpy()
        assert rel(got, np.asarray(getattr(jc, name)(y))) <= 1e-12, name
        assert rel(got, getattr(dense, name)(y).numpy()) <= 1e-12, name


def test_banded_channel_plans_and_attributes(banded):
    from surfh_tpu_torch.convert import channel_tables_from_reference

    jc, pc, _, _, _, rtol = banded
    want = channel_tables_from_reference(jc)
    assert (want["wblur_impl"], want["wblur_band_rtol"]) == (pc.wblur_impl, pc.wblur_band_rtol)
    assert pc.wblur_band_rtol == rtol
    for a, b in zip(want["band_plans"], (pc.band_plan(), pc.band_plan_t()), strict=True):
        assert type(a) is type(b)
        for k, v in vars(a).items():
            np.testing.assert_array_equal(getattr(b, k), v, err_msg=k)
    assert pc.band_plan() is pc.band_plan(rtol)  # one cache for the implicit and explicit rtol
    for k in ("beta_step", "instr_cube_shape", "local_cube_shape", "slices_shape", "pointing_scan",
              "slit_unroll"):
        assert getattr(pc, k) == getattr(jc, k), k


@pytest.mark.parametrize("env", ["0", "1"])
def test_channel_pointing_scan_follows_the_environment(monkeypatch, env):
    from surfh_tpu.models.channel import Channel as JaxChannel
    from surfh_tpu.simulation.synthetic import make_setup as jax_make_setup
    from surfh_tpu_torch.models.channel import Channel
    from surfh_tpu_torch.simulation.synthetic import make_setup

    kw = dict(BAND_KW, n_lambda=24)
    monkeypatch.setenv("SURFH_POINTING_SCAN", env)
    jc = JaxChannel(*_channel_args(jax_make_setup(**kw)), jnp.float64)
    pc = Channel(*_channel_args(make_setup(**kw)), np.float64, slit_unroll=False)
    assert pc.pointing_scan == jc.pointing_scan == (env == "1")
    assert pc.slit_unroll is False
    assert Channel(*_channel_args(make_setup(**kw)), pointing_scan=env == "0").pointing_scan == (env == "0")
    with pytest.raises(ValueError, match="wblur_impl"):
        Channel(*_channel_args(make_setup(**kw)), np.float64, "bilinear", "pallas")


@pytest.mark.parametrize("window_local", [False, True], ids=["wplane", "window_local"])
def test_spectro_channels_carry_the_model_blur(window_local):
    """The model's blur reaches its channels; window-local models force the
    dense blur (with the reference's warning), so their channels are dense."""
    from surfh_tpu.simulation.synthetic import make_model as jax_make_model
    from surfh_tpu.simulation.synthetic import make_setup as jax_make_setup
    from surfh_tpu_torch.simulation.synthetic import make_model, make_setup

    kw = dict(im_size=31, n_lambda=24, n_tpl=2, n_channels=2, n_pointings=1, n_slit=3)
    args = dict(wblur_impl="banded", wblur_band_rtol=1e-3, window_local=window_local)
    with pytest.warns(UserWarning, match="window_local") if window_local else nullcontext():
        jm, _ = jax_make_model(setup=jax_make_setup(**kw), dtype=jnp.float64, **args)
    with pytest.warns(UserWarning, match="window_local") if window_local else nullcontext():
        pm, _ = make_model(setup=make_setup(**kw), dtype=np.float64, **args)
    assert pm.list_wslice == jm.list_wslice == [c.wslice for c in pm.channels]
    impl = "dense" if window_local else "banded"
    for jc, pc in zip(jm.channels, pm.channels, strict=True):
        assert (pc.wblur_impl, pc.wblur_band_rtol) == (jc.wblur_impl, jc.wblur_band_rtol) \
            == (impl, 1e-3)
        assert pc.tables is None  # the model keeps its own device tables; no channel copy


# ----------------------------------------------------------------------
# C14

def test_spectro_c_keeps_its_sotf():
    from surfh_tpu.models import family as jfam
    from surfh_tpu_torch.models import family

    rng = np.random.default_rng(8)
    sotf = rng.standard_normal((3, 9, 5)) + 1j * rng.standard_normal((3, 9, 5))
    maps, tpl, wl = rng.random((2, 9, 8)), rng.random((2, 3)), np.arange(3.0)
    op = family.SpectroC(sotf, maps, tpl, wl, torch.float64, "cpu")
    jop = jfam.SpectroC(sotf, maps, tpl, wl, jnp.float64)
    assert isinstance(op.sotf, np.ndarray)
    np.testing.assert_array_equal(op.sotf, jop.sotf)
    t = torch.as_tensor(sotf)
    assert family.SpectroC(t, maps, tpl, wl, torch.float64, "cpu").sotf is t  # not copied


def test_quad_criterion_has_the_model_dtype():
    from surfh_tpu_torch.solvers.criterion import QuadCriterion_MRS
    from surfh_tpu_torch.simulation.synthetic import make_model

    model, setup = make_model(dtype=np.float64, im_size=21, n_lambda=12, n_tpl=2, n_channels=1,
                              n_pointings=1, n_slit=3)
    model.to("cpu", torch.float64)
    crit = QuadCriterion_MRS(1.0, np.zeros(model.oshape), model, 1.0)
    assert crit.dtype == model.dtype == torch.float64


# ----------------------------------------------------------------------
# C15

@pytest.fixture(scope="module")
def conv():
    from surfh_tpu.core import fft as jfft

    rng = np.random.default_rng(9)
    na, nb, w, m, r = 23, 20, 7, 3, 2
    dm = jfft.dft_matmul_tables((na, nb), np.float64, ka_max=6, kb_keep=5, bbox=(3, 4, 9, 8))
    st = jfft.psf_stamp_tables((na, nb), (5, 5), np.float64, ka_max=6, kb_keep=5)
    psf = rng.random((w, 5, 5))
    o_re, o_im = (np.array(a) for a in jfft.otf_from_stamps(jnp.asarray(psf), st))
    return {
        "otf_from_stamps": (psf, st),
        "lmm_conv_rank": (rng.random((m, na, nb)), o_re[:r], o_im[:r], dm),
        "lmm_conv_rank_t": (rng.random((m * r, 9, 8)), o_re[:r], o_im[:r], dm, m),
        "conv_otf_matmul": (rng.random((w, na, nb)), o_re, o_im, dm),
        "conv_otf_matmul_t": (rng.random((w, 9, 8)), o_re, o_im, dm),
        "lmm_conv_otf_matmul": (rng.random((m, na, nb)), rng.random((m, w)), o_re, o_im, dm),
        "lmm_conv_otf_matmul_t": (rng.random((w, 9, 8)), rng.random((m, w)), o_re, o_im, dm),
    }


def _to_torch(a):
    if isinstance(a, dict):
        return {k: torch.as_tensor(v) for k, v in a.items()}
    return torch.as_tensor(a) if isinstance(a, np.ndarray) else a


def _to_jax(a):
    if isinstance(a, dict):
        return {k: jnp.asarray(v) for k, v in a.items()}
    return jnp.asarray(a) if isinstance(a, np.ndarray) else a


@pytest.mark.parametrize("name", ["otf_from_stamps", "lmm_conv_rank", "lmm_conv_rank_t",
                                  "conv_otf_matmul", "conv_otf_matmul_t", "lmm_conv_otf_matmul",
                                  "lmm_conv_otf_matmul_t"])
def test_conv_functions_take_the_reference_precision(conv, name):
    from surfh_tpu.core import fft as jfft
    from surfh_tpu_torch.core import fft

    args = conv[name]
    fn = getattr(fft, name)
    assert inspect.signature(fn).parameters["precision"].default == "highest"
    got = fn(*(_to_torch(a) for a in args), "highest")  # positional, in the reference's place
    want = getattr(jfft, name)(*(_to_jax(a) for a in args), "highest")
    for g, w in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,), strict=True):
        assert rel(g.numpy(), np.asarray(w)) <= 1e-12
    with pytest.raises(NotImplementedError, match="not safe under CG"):
        fn(*(_to_torch(a) for a in args), precision="high")


def test_dft_pair_takes_inarray():
    from surfh_tpu.core import fft as jfft
    from surfh_tpu_torch.core import fft

    x = np.random.default_rng(10).standard_normal((2, 9, 7))
    spec = fft.dft(inarray=torch.as_tensor(x))
    assert rel(spec.numpy(), np.asarray(jfft.dft(inarray=jnp.asarray(x)))) <= 1e-12
    back = fft.idft(inarray=spec, im_shape=(9, 7))
    assert rel(back.numpy(), np.asarray(jfft.idft(inarray=jnp.asarray(spec.numpy()),
                                                  im_shape=(9, 7)))) <= 1e-12
    assert rel(back.numpy(), x) <= 1e-12


def test_lambda_sharded_forward_takes_cube_sharded(monkeypatch):
    """World 1 without a process group: the mesh lookup and the all_reduce
    (a sum over one rank) are stubbed, so no default group outlives the test."""
    from surfh_tpu_torch.parallel import lambda_sharded
    from surfh_tpu_torch.simulation.synthetic import make_model

    monkeypatch.setattr(lambda_sharded, "mesh_axis", lambda mesh, name=None: ("lam", None, 1, 0))
    monkeypatch.setattr(lambda_sharded.dist, "all_reduce", lambda t, group=None: None)
    model, _ = make_model(dtype=np.float64, im_size=21, n_lambda=12, n_tpl=2, n_channels=1,
                          n_pointings=2, n_slit=3)
    chan = model.channels[0].to("cpu", torch.float64)
    sh = lambda_sharded.LambdaShardedChannel(chan, n_lambda=12, mesh=None)
    cube = np.random.default_rng(11).standard_normal(model.cube_shape)
    got = sh.forward(cube_sharded=sh.shard_cube(cube))
    assert rel(got.numpy(), chan.forward(cube).numpy()) <= 1e-12


def test_slicer_has_the_transpose_shape_alias():
    from surfh_tpu_torch.models.slicer import Slicer

    assert Slicer.get_slit_shape_t is Slicer.get_slit_shape
