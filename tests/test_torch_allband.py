"""The port's all-band path (BASELINE config 5) against the JAX package's:
the decomposition module, `make_allband_setup`, the co-add, the
`run_allband_simulated` pipeline stage by stage, the `allband` command and
`config.py`.  CPU, inputs from numpy seeds; every tolerance is stated
where it is used.

* `learning.decomposition` in float64: `nmf(dtype=float64)` W, H and the
  error ≤1e-10 relative; `pca` components and scores up to each
  component's sign, variances, ≤1e-10; `nfindr` the same indices; `fcls`
  in float64 against the reference's own projected-gradient loop run in
  float64 ≤1e-10 (the reference's public `fcls` is float32 only), and the
  float32 `fcls` ≤1e-5 absolute; `learn_templates_nmf` in float32 ≤1e-5
  relative (measured 2.7e-6: the NMF's float32 matrix products sum in
  another order);
* `make_allband_setup`: the reference's keys and values, the OTF on the
  CPU equal to the reference's `sotf` to its complex64 rounding (≤1e-6 of
  the largest magnitude) (the diffraction PSF: tests/test_torch_jwst_psf.py);
* the co-add (`pipeline.coadd_cube`, float64, on a torch device) on the
  reference's data blocks against the reference's host co-add ≤1e-12, and
  `bright_mask` on the reference's cube equal to its mask;
* `run_allband_simulated` at the reference's CLI test size (npix 31, bands
  1a and 1b, 2 pointings, 2 templates, 8 iterations, 40 NMF iterations,
  λ-subsample 4), for `lcg`, `mmmg` and ``window_local=True``, stage by
  stage, each stage given the reference's inputs: the co-added cube ≤1e-5
  relative (float32 data through two packages' FFTs, measured 1.4e-6);
  the NMF templates and maps ≤1e-5 (2.1e-6); the solve, 4 iterations from
  the reference's templates and data, x and the cube ≤5e-4 (1.1e-5
  W-plane; window-local, the reference's OTF-window model over the same
  sotf, 7.2e-6 for x and 5.7e-6 for the cube: past 4 iterations this
  small problem's float32 CG amplifies rounding, 2-5e-2 at 8 in either
  solver); the report
  the reference's keys, values where they do not depend on the mask, and
  its metrics those of the written cube.  End to end, the masks may differ
  at pixels whose λ-summed flux ties with the 25 % quantile (at this size
  the quantile falls among near-equal sums: 622 distinct of 961), and the
  NMF's initial H follows the masked row count; so the NMF stage is
  compared on the reference's mask and every pixel where the masks differ
  is held to lie within 1e-6 of the quantile;
* `allband` through the port's command line under ``SURFH_CPU=1``
  (tests/test_cli.py's case) and the reference's: the same report keys;
* `config.py` round-trips (tests/test_cli.py's cases), and a JSON written
  by either package reads back in the other.
"""

import contextlib
import io
import json
import os
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from click.testing import CliRunner

import surfh_tpu.learning.decomposition as jd
import surfh_tpu.pipeline as jpl
import surfh_tpu.solvers.criterion as jcrit
import surfh_tpu_torch.learning.decomposition as td
import surfh_tpu_torch.pipeline as tpl
import surfh_tpu_torch.solvers.criterion as tcrit
from surfh_tpu.cli import cli as jax_cli
from surfh_tpu.simulation import flagship as jflagship
from surfh_tpu_torch import cli
from surfh_tpu_torch.models.spectro import SpectroSigRLSCT
from surfh_tpu_torch.simulation import flagship
from surfh_tpu_torch.solvers.criterion import QuadCriterion_MRS

torch.set_num_threads(2)

SIZE = dict(npix=31, bands=["1a", "1b"], n_pointings=2, n_templates=2, niter=8, nmf_iter=40,
            lambda_subsample=4)
SEED = 19940407
TOL_F64 = 1e-10
TOL_F32 = 1e-5
TOL_SOLVE = 5e-4
SOLVE_ITERS = 4


def rel(a, b) -> float:
    a = a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a, np.float64)
    b = b.cpu().numpy() if isinstance(b, torch.Tensor) else np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.fixture(scope="module")
def mixed():
    """200 spectra of 40 samples mixed from 3 positive endmembers, plus noise."""
    rng = np.random.default_rng(5)
    E = rng.random((3, 40)) + 0.1
    A = rng.dirichlet(np.ones(3), size=200)
    return SimpleNamespace(E=E, X=A @ E + 0.01 * rng.random((200, 40)))


# ---------------------------------------------------------------------------
# learning.decomposition

@pytest.mark.parametrize("dtype", [np.float64, torch.float64])
def test_nmf_matches_reference_f64(mixed, dtype):
    W0, H0, e0 = jd.nmf(mixed.X, 3, n_iter=100, seed=3, dtype=jnp.float64)
    W, H, e = td.nmf(mixed.X, 3, 100, 3, dtype=dtype, device="cpu")
    assert W.dtype == H.dtype == torch.float64
    assert rel(W, W0) <= TOL_F64 and rel(H, H0) <= TOL_F64
    assert abs(e - e0) <= TOL_F64 * e0


def test_nmf_clips_negatives_and_runs_float32_by_default(mixed):
    X = mixed.X - 0.05
    W0, H0, e0 = jd.nmf(X, 3, n_iter=50, seed=1)
    W, H, e = td.nmf(torch.as_tensor(X), 3, n_iter=50, seed=1)  # the tensor's device
    assert W.dtype == torch.float32 and W.device.type == "cpu"
    assert rel(H, H0) <= TOL_F32 and abs(e - e0) <= TOL_F32 * e0


def test_pca_matches_reference_up_to_sign(mixed):
    c0, v0, s0 = jd.pca(mixed.X, 4)
    c, v, s = td.pca(mixed.X, 4, device="cpu")
    sign = np.sign(np.sum(np.asarray(c0) * c.numpy(), axis=1))
    assert np.all(np.abs(sign) == 1)
    assert rel(sign[:, None] * c.numpy(), c0) <= TOL_F64
    assert rel(v, v0) <= TOL_F64
    assert rel(sign[None, :] * s.numpy(), s0) <= TOL_F64


def test_nfindr_finds_the_reference_indices(mixed):
    e0, i0 = jd.nfindr(mixed.X, 3)
    e, i = td.nfindr(mixed.X, 3, device="cpu")
    np.testing.assert_array_equal(i, i0)
    np.testing.assert_array_equal(e, e0)


def test_fcls_matches_the_reference_loop_f64(mixed):
    want = np.asarray(jd._fcls_run(jnp.asarray(mixed.E), jnp.asarray(mixed.X), 200)).T
    got = td.fcls(mixed.X, mixed.E, 200, dtype=np.float64, device="cpu")
    assert got.dtype == torch.float64 and got.shape == (200, 3)
    assert np.abs(got.numpy() - want).max() <= TOL_F64
    assert float(got.min()) >= 0.0
    assert np.abs(got.sum(dim=1).numpy() - 1.0).max() <= TOL_F64


def test_fcls_float32_matches_reference(mixed):
    want = jd.fcls(mixed.X, mixed.E)
    got = td.fcls(mixed.X, mixed.E, device="cpu")
    assert got.dtype == torch.float32
    assert np.abs(got.numpy() - want).max() <= TOL_F32


@pytest.mark.parametrize("masked", [True, False])
def test_learn_templates_nmf_matches_reference_f32(masked):
    rng = np.random.default_rng(8)
    cube = rng.random((30, 12, 11))
    mask = rng.random((12, 11)) > 0.3 if masked else None
    t0, m0, e0 = jd.learn_templates_nmf(cube, 3, mask=mask, n_iter=150, seed=2)
    t, m, e = td.learn_templates_nmf(cube, 3, mask=mask, n_iter=150, seed=2, device="cpu")
    assert t.shape == (3, 30) and m.shape == (3, 12, 11)
    assert rel(t, t0) <= TOL_F32 and rel(m, m0) <= TOL_F32 and abs(e - e0) <= TOL_F32 * e0
    if masked:
        assert float(m[:, ~mask].abs().max()) == 0.0


# ---------------------------------------------------------------------------
# simulation.flagship.make_allband_setup

def test_make_allband_setup_matches_reference(monkeypatch, tmp_path):
    monkeypatch.setenv("SURFH_CACHE_DIR", str(tmp_path))  # the reference's sotf cache
    kw = dict(npix=31, bands=["1a", "2b"], n_pointings=2, n_tpl=3, lambda_subsample=4)
    want = jflagship.make_allband_setup(**kw)
    got = flagship.make_allband_setup(device="cpu", **kw)
    assert list(got) == list(want)
    for k in ("maps", "templates", "wavelength_axis", "alpha_axis", "beta_axis", "psf_stack"):
        np.testing.assert_array_equal(got[k], want[k])
    assert got["step_degree"] == want["step_degree"] and got["im_shape"] == want["im_shape"]
    assert got["bands"] == want["bands"]
    assert [i.name for i in got["instrs"]] == [i.name for i in want["instrs"]]
    for gi, wi in zip(got["instrs"], want["instrs"]):
        np.testing.assert_array_equal(gi.wavel_axis, wi.wavel_axis)
    for gp, wp in zip(got["pointings"], want["pointings"]):
        np.testing.assert_array_equal([(c.alpha, c.beta) for c in gp], [(c.alpha, c.beta) for c in wp])
    sotf = got["sotf"]
    assert sotf.dtype == torch.complex64 and tuple(sotf.shape) == want["sotf"].shape
    assert np.abs(sotf.numpy() - want["sotf"]).max() <= 1e-6 * np.abs(want["sotf"]).max()
    assert flagship.make_allband_setup(build_sotf=False, **kw)["sotf"] is None


def test_make_allband_setup_full_lambda_axis():
    """BASELINE config 5's λ axis: 12 PCE grids of 201 samples."""
    s = flagship.make_allband_setup(npix=11, build_sotf=False)
    assert len(s["wavelength_axis"]) == 2412 and len(s["instrs"]) == 12
    assert np.all(np.diff(s["wavelength_axis"]) >= 0)


# ---------------------------------------------------------------------------
# the co-add and the mask

def test_coadd_matches_the_reference_host_coadd():
    """The reference's host float64 co-add (pipeline.py:466-473) and the
    port's on a torch device, from the same data blocks."""
    from surfh_tpu.models.spectro import SpectroSigRLSCT as JaxSpectro

    kw = dict(npix=31, bands=["1a", "1b"], n_pointings=2, n_tpl=2, lambda_subsample=4)
    js = jflagship.make_allband_setup(**kw)
    ps = flagship.make_allband_setup(build_sotf=False, **kw)
    args = ("alpha_axis", "beta_axis", "wavelength_axis", "instrs", "step_degree", "pointings")
    jm = JaxSpectro(js["sotf"], js["templates"], *[js[a] for a in args], dtype=jnp.float64)
    pm = SpectroSigRLSCT(np.ones((1, 1, 1), np.complex64), ps["templates"], *[ps[a] for a in args],
                         dtype=np.float64)
    y = np.asarray(jm.forward(js["maps"]))
    blocks = jm.split(y)
    want = np.zeros(jm.cube_shape)
    cover = np.zeros(jm.cube_shape[0])
    for c, chan in enumerate(jm.channels):
        want += chan.sliceToCube(blocks[c])
        cover[chan.wslice] += 1.0
    want /= np.maximum(cover, 1.0)[:, None, None]
    got = tpl.coadd_cube(pm.channels, blocks, pm.cube_shape, torch.device("cpu"))
    assert got.dtype == torch.float64 and tuple(got.shape) == want.shape
    assert rel(got, want) <= 1e-12
    bright = want.sum(axis=0)
    np.testing.assert_array_equal(tpl.bright_mask(torch.as_tensor(want), 0.25),
                                  bright > np.quantile(bright, 0.25))
    for c, chan in enumerate(pm.channels):  # the window is the full-axis re-projection's
        full = chan.sliceToCube(blocks[c])
        np.testing.assert_array_equal(chan.sliceToWindow(blocks[c], "cpu").numpy(), full[chan.wslice])
        assert not full[: chan.wslice.start].any() and not full[chan.wslice.stop :].any()


def test_unit_rows():
    t = np.array([[3.0, 4.0], [0.0, 0.0]], np.float32)
    got = tpl.unit_rows(t)
    assert got.dtype == np.float32 and got.flags["C_CONTIGUOUS"]
    np.testing.assert_array_equal(got, t / np.maximum(np.linalg.norm(t, axis=1, keepdims=True), 1e-30))


# ---------------------------------------------------------------------------
# run_allband_simulated, stage by stage

def _capture(monkeypatch, decomposition, criterion, store):
    learn = decomposition.learn_templates_nmf
    base = criterion.QuadCriterion_MRS

    def kept_learn(cube, *a, **k):
        cube_np = cube.cpu().numpy().copy() if isinstance(cube, torch.Tensor) else np.array(cube)
        out = learn(cube, *a, **k)
        store["learn"] = (cube_np, k["mask"], out)
        return out

    class Kept(base):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            store["crit"] = self

    monkeypatch.setattr(decomposition, "learn_templates_nmf", kept_learn)
    monkeypatch.setattr(criterion, "QuadCriterion_MRS", Kept)


@pytest.fixture(scope="module", params=["lcg", "mmmg", "lcg-window_local"])
def runs(request, tmp_path_factory):
    method, _, wl = request.param.partition("-")
    out = tmp_path_factory.mktemp(f"allband_{request.param}")
    J, T = {}, {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SURFH_CACHE_DIR", str(out / "cache"))
        _capture(mp, jd, jcrit, J)
        _capture(mp, td, tcrit, T)
        kw = dict(SIZE, method=method, window_local=bool(wl))
        want = jpl.run_allband_simulated(output_dir=str(out / "jax"), **kw)
        got = tpl.run_allband_simulated(output_dir=str(out / "port"), device="cpu", **kw)
    return SimpleNamespace(method=method, window_local=bool(wl), out=out, J=J, T=T, want=want, got=got)


def test_allband_coadd_stage(runs):
    cube_j, cube_t = runs.J["learn"][0], runs.T["learn"][0]
    assert cube_t.shape == cube_j.shape == (101, 31, 31)
    assert rel(cube_t, cube_j) <= TOL_F32
    assert cube_t.min() >= 0.0  # clipped before the NMF, as in the reference


def test_allband_mask_differs_only_at_quantile_ties(runs):
    cube_j, mask_j = runs.J["learn"][0], runs.J["learn"][1]
    mask_t = runs.T["learn"][1]
    assert mask_t.shape == mask_j.shape == (31, 31)
    bright = cube_j.sum(axis=0)
    q = np.quantile(bright, 0.25)
    assert np.all(np.abs(bright[mask_t != mask_j] - q) <= 1e-6 * q)
    assert abs(int(mask_t.sum()) - int(mask_j.sum())) <= 10


def test_allband_nmf_stage(runs):
    cube_j, mask_j, (t0, m0, e0) = runs.J["learn"]
    t, m, e = td.learn_templates_nmf(cube_j, 2, mask=mask_j, n_iter=SIZE["nmf_iter"], seed=SEED,
                                     device="cpu")
    assert rel(t, t0) <= TOL_F32 and rel(m, m0) <= TOL_F32 and abs(e - e0) <= TOL_F32 * e0
    got = runs.T["learn"][2][0]
    assert bool(torch.isfinite(got).all()) and float(got.min()) >= 0.0


def test_allband_solve_stage(runs):
    """The port's model over the reference's normalized templates, solving
    the reference's data: `SOLVE_ITERS` iterations of the run's method."""
    jc = runs.J["crit"]
    tc = runs.T["crit"]
    tpl_j = np.asarray(jc.model.templates)
    assert tpl_j.dtype == np.float32 and tc.model.templates.dtype == np.float32
    np.testing.assert_allclose(np.linalg.norm(tc.model.templates, axis=1), 1.0, rtol=1e-6)
    s = flagship.make_allband_setup(npix=31, bands=SIZE["bands"], n_pointings=2, n_tpl=2,
                                    lambda_subsample=4, device="cpu")
    common = (tpl_j, s["alpha_axis"], s["beta_axis"], s["wavelength_axis"], s["instrs"],
              s["step_degree"], s["pointings"])
    model = SpectroSigRLSCT(s["sotf"], *common, dtype=np.float32, window_local=runs.window_local)
    assert model.conv_impl == ("matmul" if runs.window_local else "fft")
    model.to("cpu", torch.float32)
    crit = QuadCriterion_MRS(1.0, np.array(jc.y_spectro), model, 5e3)
    res = crit.run_method(runs.method, maximum_iterations=SOLVE_ITERS)
    jres = jc.run_method(runs.method, maximum_iterations=SOLVE_ITERS)
    assert res.n_iter == jres.n_iter == SOLVE_ITERS
    assert rel(res.x, jres.x) <= TOL_SOLVE
    assert rel(model.mapsToCube(res.x), np.asarray(jc.model.mapsToCube(jres.x))) <= TOL_SOLVE


def test_allband_report(runs):
    from surfh_tpu_torch.utils import metrics

    got, want = runs.got, runs.want
    assert list(got) == list(want)
    assert list(got["timings_s"]) == list(want["timings_s"])
    for k in ("bands", "n_lambda", "npix", "niter"):
        assert got[k] == want[k], k
    assert got["niter"] == SIZE["niter"] and got["n_lambda"] == 101
    assert all(np.isfinite(v) for v in [got[k] for k in ("iters_per_s", "nmf_recon_err", "psnr_cube",
                                                            "relative_cube_error_pct")])
    port = runs.out / "port"
    for f in ("allband_templates.npy", "allband_x.npy", "allband_cube.npy"):
        assert np.load(port / f).shape == np.load(runs.out / "jax" / f).shape, f
    s = flagship.make_allband_setup(npix=31, bands=SIZE["bands"], n_pointings=2, n_tpl=2,
                                    lambda_subsample=4, build_sotf=False)
    truth = np.einsum("ml,mij->lij", np.asarray(s["templates"], np.float32),
                      np.asarray(s["maps"], np.float32))
    cube = np.load(port / "allband_cube.npy")
    assert abs(got["relative_cube_error_pct"] - metrics.relative_error(truth, cube)) <= 1e-4
    assert abs(got["psnr_cube"] - metrics.psnr(truth, cube)) <= 1e-4


def test_allband_needs_a_known_method():
    with pytest.raises(ValueError, match="method"):
        tpl.run_allband_simulated(method="cg", device="cpu", **SIZE)


# ---------------------------------------------------------------------------
# the command line and the configuration

ALLBAND_ARGV = ["allband", "-np", "31", "-b", "1a,1b", "--pointings", "2", "-nt", "2", "-ni", "8",
                "--nmf-iter", "40", "--lambda-subsample", "4"]


@pytest.mark.parametrize("method", ["lcg", "mmmg"])
def test_cli_allband(monkeypatch, tmp_path, method):
    """tests/test_cli.py::test_cli_allband through the port's command line,
    and the reference's report keys."""
    monkeypatch.setenv("SURFH_CPU", "1")
    monkeypatch.setenv("SURFH_CACHE_DIR", str(tmp_path / "cache"))
    argv = ALLBAND_ARGV + ["-m", method]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert cli.main(argv + ["-o", str(tmp_path / "port")]) == 0
    report = json.loads(out.getvalue().strip().splitlines()[-1])
    assert report["niter"] > 0 and report["bands"] == ["1a", "1b"]
    assert "nmf_s" in report["timings_s"] and "solve_s" in report["timings_s"]
    assert np.isfinite(report["psnr_cube"])
    assert os.path.exists(tmp_path / "port" / "allband_templates.npy")
    r = CliRunner().invoke(jax_cli, argv + ["-o", str(tmp_path / "jax")])
    assert r.exit_code == 0, r.output
    want = json.loads(r.output.strip().splitlines()[-1])
    assert list(report) == list(want) and list(report["timings_s"]) == list(want["timings_s"])


def test_fusion_config_roundtrip(tmp_path, monkeypatch):
    """tests/test_cli.py::test_fusion_config_roundtrip on the port's copy."""
    from surfh_tpu_torch.config import FusionConfig, data_root

    cfg = FusionConfig(bands=["1a"], simulated=True)
    cfg.solver.niter = 7
    cfg.solver.method = "mmmg"
    p = str(tmp_path / "cfg.json")
    cfg.to_json(p)
    back = FusionConfig.from_json(p)
    assert back.solver.niter == 7 and back.bands == ["1a"] and back.simulated
    assert back.solver.method == "mmmg" and back == cfg
    monkeypatch.setenv("SURFH_DATA_ROOT", "/tmp/xyz")
    assert data_root() == "/tmp/xyz"
    assert data_root("/a") == "/a"
    monkeypatch.delenv("SURFH_DATA_ROOT")
    assert data_root() == os.getcwd()


def test_fusion_config_rejects_unknown():
    from surfh_tpu_torch.config import FusionConfig

    with pytest.raises(ValueError):
        FusionConfig.from_dict({"bogus": 1})


def test_fusion_config_reads_across_packages(tmp_path):
    import dataclasses

    from surfh_tpu.config import FusionConfig as JaxConfig
    from surfh_tpu_torch.config import FusionConfig

    cfg = FusionConfig(bands=["2c", "3a"], output_dir="out")
    cfg.model.npix = 201
    cfg.solver.method = "mmmg"
    jcfg = JaxConfig.from_json(cfg.to_json())
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(cfg)
    assert FusionConfig.from_json(jcfg.to_json()) == cfg
