"""surfh_tpu_torch's real-data fusion pipeline against the JAX package's
(CPU, float64), on the fixture directory of tests/test_pipeline.py: band 4a
with its detector λ table shrunk to 60 samples (one assignment to each
package's `pipeline.get_mrs_wavelength`), NPIX 31 at 0.1″, 2 pointings,
slices written from the reference model's own forward.

* `create_model`: forward and adjoint ≤1e-12 relative; the port's adjoint
  dot test ≤1e-12;
* `run_real_fusion` (the reference's model built in float64), with and
  without the flux normalization: x ≤1e-9 relative after 8 lcg
  iterations; after 15 both reconstruct the data, and x differs by no more
  than 10× what a one-ulp change of µ·Hᵗy moves it (this fixture's CG
  amplifies rounding ~100× an iteration past 8, in either package);
* the data-side methods (`split`, `concat`, `cubeTomaps`,
  `real_data_janskySR_to_jansky`, `plot_slice`, `make_mask`, `sliceToCube`):
  ≤1e-12; `realData_cubeToSlice` / `realData_sliceToCube` ≤1e-12 on
  tests/test_model_utils.py's synthetic model (on the fixture's geometry
  the reference's `realData_sliceToCube` raises: ⌈sa/srf⌉ > A), and both
  raise alike there;
* `run_checkpointed` in segments equals the uninterrupted solve bit for
  bit; a JAX checkpoint resumes in the port and a port checkpoint in JAX,
  ≤1e-12.
"""

import functools
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import surfh_tpu.pipeline as jpl
import surfh_tpu_torch.pipeline as tpl
from surfh_tpu.core.fft import ir2fr
from surfh_tpu.preprocessing.fits_io import fits_write
from surfh_tpu.solvers import checkpoint as jax_ck
from surfh_tpu.solvers.criterion import QuadCriterion_MRS as JaxCriterion
from surfh_tpu.utils.psf import gaussian_psf
from surfh_tpu_torch.solvers import checkpoint as ck
from surfh_tpu_torch.solvers.criterion import QuadCriterion_MRS

torch.set_num_threads(2)

BAND = "4a"
NPIX = 31
PA_V3 = 12.5
STEP = 0.1
TOL = 1e-12  # float64 operators and host re-projections
TOL_SOLVE = 1e-9  # float64 CG iterations, before rounding is amplified
SAME_ITERS = 8  # the fixture's CG holds rounding below 1e-11 for 8 iterations (1e-4 at 12)


def rel(a, b) -> float:
    a = a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = b.cpu().numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.fixture(scope="module", autouse=True)
def small_band():
    """Shrink the 4a detector λ grid (542 → 60 samples) in both pipelines."""
    orig = jpl.get_mrs_wavelength
    full = orig(BAND)
    det = np.linspace(full[0], full[-1], 60)
    jpl.get_mrs_wavelength = tpl.get_mrs_wavelength = lambda b: det
    yield
    jpl.get_mrs_wavelength = orig
    tpl.get_mrs_wavelength = orig


@pytest.fixture(scope="module")
def fusion_dir(tmp_path_factory):
    """The fixture directory of tests/test_pipeline.py."""
    root = tmp_path_factory.mktemp("fusion")
    for d in ("Templates", "PSF", "Filtered_slices"):
        os.makedirs(root / d)
    step_degree = STEP / 3600.0
    det_wavel = jpl.get_mrs_wavelength(BAND)
    wavel_axis = np.linspace(det_wavel[0] - 0.05, det_wavel[-1] + 0.05, 60)
    templates = np.vstack([np.ones(60), np.linspace(0.5, 2.0, 60)])
    spsf = gaussian_psf(wavel_axis, STEP)
    c = (spsf.shape[1] - NPIX) // 2
    spsf = spsf[:, c : c + NPIX, c : c + NPIX]
    spsf /= spsf.sum(axis=(1, 2), keepdims=True)
    np.save(root / "Templates" / "templates.npy", templates)
    np.save(root / "Templates" / "wavel_axis.npy", wavel_axis)
    np.save(root / "PSF" / "psf.npy", spsf)

    targets = [(83.83, -5.41), (83.83 + 4 * step_degree, -5.41 - 3 * step_degree)]
    data_dict = {"data": {BAND: []}, "target": {BAND: targets}, "rotation": {BAND: PA_V3}}
    alpha = np.arange(NPIX) * step_degree
    alpha -= alpha.mean()
    model = jpl.create_model(ir2fr(spsf, (NPIX, NPIX)), templates, alpha, alpha.copy(), wavel_axis,
                             jpl.create_instruments(data_dict, [BAND]), step_degree, data_dict)
    truth = np.random.default_rng(0).random(model.ishape).astype(np.float32)
    y = np.asarray(model.forward(truth)).reshape(model.instrs_oshape[0])
    for p, (ra, dec) in enumerate(targets):
        flat = y[p].transpose(1, 0, 2).reshape(y.shape[2], -1)
        fits_write(str(root / "Filtered_slices" / f"{BAND}_dither{p}.fits"), flat.astype(np.float32),
                   header={"PA_V3": PA_V3, "TARG_RA": ra, "TARG_DEC": dec, "BAND": BAND.upper()})
    return root


def _inputs(fusion_dir):
    step_degree = STEP / 3600.0
    templates = np.load(fusion_dir / "Templates" / "templates.npy")
    wavel = np.load(fusion_dir / "Templates" / "wavel_axis.npy")
    spsf = jpl.crop_psf_stack(np.load(fusion_dir / "PSF" / "psf.npy"), NPIX)
    alpha = np.arange(NPIX) * step_degree
    alpha -= alpha.mean()
    return step_degree, templates, wavel, spsf, alpha


@pytest.fixture(scope="module")
def pair(fusion_dir):
    """The same fusion model from each package, float64, on the CPU."""
    step_degree, templates, wavel, spsf, alpha = _inputs(fusion_dir)
    slices = str(fusion_dir / "Filtered_slices")
    jdd, tdd = jpl.load_corrected_data(slices, [BAND]), tpl.load_corrected_data(slices, [BAND])
    sotf = ir2fr(spsf, (NPIX, NPIX))
    jm = jpl.create_model(sotf, templates, alpha, alpha.copy(), wavel,
                          jpl.create_instruments(jdd, [BAND]), step_degree, jdd, dtype=jnp.float64)
    tm = tpl.create_model(sotf, templates, alpha, alpha.copy(), wavel,
                          tpl.create_instruments(tdd, [BAND]), step_degree, tdd,
                          dtype=np.float64, device="cpu")
    y = jpl.assemble_data_vector(jm, jdd, [BAND])
    return jm, tm, jdd, tdd, y


def test_load_corrected_data_and_data_vector(fusion_dir, pair):
    jm, tm, jdd, tdd, y = pair
    assert tdd["target"] == jdd["target"] and tdd["rotation"] == jdd["rotation"]
    for a, b in zip(tdd["data"][BAND], jdd["data"][BAND]):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tpl.assemble_data_vector(tm, tdd, [BAND]), y)


def test_create_instruments(pair):
    _, _, jdd, tdd, _ = pair
    a, b = tpl.create_instruments(tdd, [BAND])[BAND], jpl.create_instruments(jdd, [BAND])[BAND]
    assert (a.name, a.n_slit, a.det_pix_size, a.fov.angle) == (b.name, b.n_slit, b.det_pix_size, b.fov.angle)
    np.testing.assert_array_equal(a.wavel_axis, b.wavel_axis)


def test_crop_psf_stack():
    x = np.random.default_rng(1).random((3, 40, 37))
    for n in (31, 32, 37, 50):
        np.testing.assert_array_equal(tpl.crop_psf_stack(x, n), jpl.crop_psf_stack(x, n))


def test_create_model_forward(pair):
    jm, tm, *_ = pair
    assert tm.instrs_oshape == list(jm.instrs_oshape) and tm.oshape == jm.oshape
    x = np.random.default_rng(2).random(jm.ishape)
    assert rel(tm.forward(x), np.asarray(jm.forward(x))) <= TOL


def test_create_model_adjoint_and_dot_test(pair):
    jm, tm, *_ = pair
    rng = np.random.default_rng(3)
    x, y = rng.standard_normal(jm.ishape), rng.standard_normal(jm.oshape)
    assert rel(tm.adjoint(y), np.asarray(jm.adjoint(y))) <= TOL
    lhs = float(torch.dot(tm.forward(x), torch.as_tensor(y)))
    rhs = float(torch.dot(torch.as_tensor(x).reshape(-1), tm.adjoint(y).reshape(-1)))
    assert abs(lhs - rhs) / abs(lhs) <= TOL


@pytest.mark.parametrize("scale_data", [False, True])
def test_run_real_fusion(fusion_dir, tmp_path, monkeypatch, scale_data):
    # the reference's run_real_fusion builds its model in float32; pin float64
    monkeypatch.setattr(jpl, "create_model", functools.partial(jpl.create_model, dtype=jnp.float64))
    kw = dict(npix=NPIX, mu=1.0, niter=SAME_ITERS, step_arcsec=STEP, scale_data=scale_data)
    jres, _ = jpl.run_real_fusion(str(fusion_dir), [BAND], output_dir=str(tmp_path / "jax"), **kw)
    tres, tm = tpl.run_real_fusion(str(fusion_dir), [BAND], output_dir=str(tmp_path / "port"),
                                   dtype=np.float64, device="cpu", **kw)
    assert tres.n_iter == jres.n_iter == SAME_ITERS and tres.x.dtype == torch.float64
    assert rel(tres.x, jres.x) <= TOL_SOLVE
    assert rel(tres.grad_norm, jres.grad_norm) <= TOL_SOLVE
    for f in ("res_x.npy", "res_cube.npy", "criterion.npy"):
        assert rel(np.load(tmp_path / "port" / f), np.load(tmp_path / "jax" / f)) <= TOL_SOLVE


def test_run_real_fusion_15_iterations(fusion_dir, tmp_path, monkeypatch):
    """15 iterations (tests/test_pipeline.py's run): both solves reconstruct
    the data alike, and the iterates differ by no more than this problem
    moves one of them when µ·Hᵗy is perturbed by one unit in the last
    place: past ~8 iterations the fixture's CG amplifies rounding ~100× an
    iteration, in either package."""
    monkeypatch.setattr(jpl, "create_model", functools.partial(jpl.create_model, dtype=jnp.float64))
    kw = dict(npix=NPIX, mu=1.0, niter=15, step_arcsec=STEP)
    jres, jm = jpl.run_real_fusion(str(fusion_dir), [BAND], **kw)
    tres, tm = tpl.run_real_fusion(str(fusion_dir), [BAND], dtype=np.float64, device="cpu", **kw)
    y = tpl.assemble_data_vector(tm, tpl.load_corrected_data(str(fusion_dir / "Filtered_slices"), [BAND]),
                                 [BAND])
    for res, fwd in ((tres, lambda x: tm.forward(x).numpy()), (jres, lambda x: np.asarray(jm.forward(x)))):
        assert res.grad_norm[-1] < 0.1 * res.grad_norm[0]
        assert np.linalg.norm(fwd(res.x) - y) / np.linalg.norm(y) < 0.15  # tests/test_pipeline.py's bar
    crit = QuadCriterion_MRS(1.0, y, tm, 1.0)
    crit._b = crit.b * (1 + 2.0 ** -52)
    nudged = crit.run_method("lcg", maximum_iterations=15)
    assert rel(tres.x, jres.x) <= 10 * rel(nudged.x, tres.x)


# ---------------------------------------------------------------------------
# the data side
def test_split_concat(pair):
    jm, tm, _, _, y = pair
    for a, b in zip(tm.split(y), jm.split(y)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tm.concat(tm.split(torch.as_tensor(y))), jm.concat(jm.split(y)))


def test_cube_to_maps(pair):
    jm, tm, *_ = pair
    cube = np.random.default_rng(4).random(jm.cube_shape)
    assert rel(tm.cubeTomaps(cube), np.asarray(jm.cubeTomaps(cube))) <= TOL


def test_jansky_normalization(pair):
    jm, tm, _, _, y = pair
    np.testing.assert_array_equal(tm.real_data_janskySR_to_jansky(y), jm.real_data_janskySR_to_jansky(y))


def test_plot_slice_and_make_mask(pair):
    jm, tm, _, _, y = pair
    y = 1e3 * y  # above plot_slice's co-add threshold of 100 in the FOV
    mean, img = tm.plot_slice(y, 0, 7)
    jmean, jimg = jm.plot_slice(y, 0, 7)
    assert rel(img, jimg) <= TOL
    seen = mean != 0  # the reference leaves the other entries uninitialized
    assert seen.any() and rel(mean[seen], jmean[seen]) <= TOL
    for a, b in zip(tm.make_mask(y, threshold=50.0, nslice=7), jm.make_mask(y, threshold=50.0, nslice=7)):
        np.testing.assert_array_equal(a, b)


def test_slice_to_cube(pair):
    jm, tm, _, _, y = pair
    got, want = tm.channels[0].sliceToCube(tm.split(y)[0]), jm.channels[0].sliceToCube(jm.split(y)[0])
    assert got.shape == jm.cube_shape and rel(got, want) <= TOL


@pytest.fixture(scope="module")
def synthetic_pair():
    """tests/test_model_utils.py's synthetic W-plane model from each package."""
    from surfh_tpu.simulation.synthetic import make_model as jax_make_model
    from surfh_tpu.simulation.synthetic import make_setup as jax_make_setup
    from surfh_tpu_torch.simulation.synthetic import make_model, make_setup

    kw = dict(im_size=41, n_lambda=30, n_tpl=3, n_channels=3, n_pointings=2, n_slit=3)
    jm, _ = jax_make_model(setup=jax_make_setup(**kw), dtype=jnp.float64)
    tm, _ = make_model(setup=make_setup(**kw), dtype=np.float64, window_local=False)
    return jm, tm.to("cpu", torch.float64)


@pytest.mark.parametrize("c", [0, 2])
def test_real_data_cube_to_slice_and_back(synthetic_pair, c):
    """The reference's conventions (tests/test_channel_parity.py): a cube at
    the detector λ count to slices, slices [S, W, A] to a W-plane cube."""
    jm, tm = synthetic_pair
    tc, jc = tm.channels[c], jm.channels[c]
    rng = np.random.default_rng(5)
    cube = rng.random((tc.oshape[2],) + tm.imshape)
    s_got, s_want = tc.realData_cubeToSlice(cube), jc.realData_cubeToSlice(cube)
    assert s_got.shape == tc.oshape[1:] and rel(s_got, s_want) <= TOL
    slices = rng.random((tc.instr.n_slit, tc.n_wslice, tc.oshape[3]))
    dim = (tc.n_wslice,) + tm.imshape
    c_got, c_want = tc.realData_sliceToCube(slices, dim), jc.realData_sliceToCube(slices, dim)
    assert c_got.shape == dim and rel(c_got, c_want) <= TOL


@pytest.mark.parametrize("c", [0, 1])
def test_slice_to_cube_where_the_fov_is_a_part_of_the_grid(synthetic_pair, c):
    """The re-projection at cube pixels the local grid does not reach is 0."""
    jm, tm = synthetic_pair
    y = np.random.default_rng(6).random(jm.oshape)
    got, want = tm.channels[c].sliceToCube(tm.split(y)[c]), jm.channels[c].sliceToCube(jm.split(y)[c])
    reached = (tm.channels[c].plans_rev[0].w != 0).any(axis=0)
    assert not reached.all() and rel(got, want) <= TOL


def test_real_data_slice_to_cube_raises_alike(pair):
    jm, tm, *_ = pair
    tc, jc = tm.channels[0], jm.channels[0]
    slices = np.ones((tc.instr.n_slit, tc.n_wslice, tc.oshape[3]))
    dim = (tc.n_wslice,) + tm.imshape
    for chan in (tc, jc):
        with pytest.raises(ValueError, match="could not broadcast"):
            chan.realData_sliceToCube(slices, dim)


# ---------------------------------------------------------------------------
# checkpoints
@pytest.fixture(scope="module")
def crits(pair):
    jm, tm, _, _, y = pair
    return JaxCriterion(1.0, y, jm, 1.0), QuadCriterion_MRS(1.0, y, tm, 1.0)


def test_segmented_solve_equals_the_uninterrupted_one(crits, tmp_path):
    _, crit = crits
    straight = ck.run_checkpointed(crit, "lcg", niter=12)
    p = str(tmp_path / "cg.npz")
    seg = ck.run_checkpointed(crit, "lcg", niter=12, checkpoint_path=p, checkpoint_every=4)
    assert seg.n_iter == 12 and torch.equal(seg.x, straight.x)
    # stopped after 4, then resumed from the file to 12
    p2 = str(tmp_path / "cg2.npz")
    ck.run_checkpointed(crit, "lcg", niter=4, checkpoint_path=p2, checkpoint_every=4)
    resumed = ck.run_checkpointed(crit, "lcg", niter=12, checkpoint_path=p2, checkpoint_every=4)
    assert resumed.n_iter == 12 and torch.equal(resumed.x, straight.x)
    # resuming a finished run is a no-op returning the stored iterate
    again = ck.run_checkpointed(crit, "lcg", niter=12, checkpoint_path=p, checkpoint_every=4)
    assert again.n_iter == 12 and torch.equal(again.x, seg.x)


def test_checkpoint_file_keys(crits, tmp_path):
    jcrit, crit = crits
    pj, pt = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    jax_ck.run_checkpointed(jcrit, "lcg", niter=3, checkpoint_path=pj, checkpoint_every=3)
    ck.run_checkpointed(crit, "lcg", niter=3, checkpoint_path=pt, checkpoint_every=3)
    with np.load(pj) as zj, np.load(pt) as zt:
        assert sorted(zj.files) == sorted(zt.files)
        for k in zj.files:
            assert zj[k].shape == zt[k].shape and zj[k].dtype == zt[k].dtype, k


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoint_resumes_in_the_other_package(crits, tmp_path, writer):
    jcrit, crit = crits
    p = str(tmp_path / "cg.npz")
    # 3 + 3 iterations: within SAME_ITERS, where rounding is not yet amplified
    first = (jax_ck if writer == "jax" else ck).run_checkpointed(
        jcrit if writer == "jax" else crit, "lcg", niter=3, checkpoint_path=p, checkpoint_every=3)
    assert first.n_iter == 3
    if writer == "jax":
        res = ck.run_checkpointed(crit, "lcg", niter=6, checkpoint_path=p, checkpoint_every=3)
    else:
        res = jax_ck.run_checkpointed(jcrit, "lcg", niter=6, checkpoint_path=p, checkpoint_every=3)
    want = jax_ck.run_checkpointed(jcrit, "lcg", niter=6)
    assert res.n_iter == 6 and rel(res.x, want.x) <= TOL
