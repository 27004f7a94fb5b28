"""surfh_tpu_torch's blind-2D models and the 2-D criterion against the JAX
package (CPU, float64), on the geometry of tests/test_solvers.py's
`_blind_setup` (a 1C-like IFU, the FOV unrotated or at 8.1°, three
pointings, a 5×5 box PSF).

* `MRSBlurred` / `MRSBlurredRectangle` / `DeconvCube`: the host tables bit
  for bit (`convert.blind2d_tables` of either package); forward and the
  derived adjoint ≤1e-12 relative; the port's dot test at 1e-12; the plain
  gather path equal to the kernel path's dispatch; `DeconvCube` against the
  per-plane 2-D forward with each plane's OTF;
* `data_to_img`: each pointing's transpose ≤1e-12; the coverage average
  equal to the reference's wherever both count the same pointings (the
  reference counts a pointing where its transpose is not exactly 0, and the
  two FFT libraries round a few mathematically-zero pixels differently:
  those pixels hold round-off ≤1e-12 of the maximum);
* the reference's recovery bar (in-FOV relative error < 0.05 after 150
  lcg iterations, tests/test_solvers.py:81-92) and the criterion's fall;
* `QuadCriterion_MRS_2D`: criterion values ≤1e-12 and 10 lcg iterates
  ≤1e-10 relative to the reference's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fixtures
from surfh_tpu.core import fft as jfft
from surfh_tpu.core.fft import ir2fr as jax_ir2fr
from surfh_tpu.instrument import geometry as jgeo
from surfh_tpu.instrument.ifu import IFU as JaxIFU
from surfh_tpu.models import blind2d as jblind
from surfh_tpu.solvers.criterion import QuadCriterion_MRS_2D as JaxCrit2D
from surfh_tpu_torch.convert import blind2d_tables
from surfh_tpu_torch.core.fft import ir2fr
from surfh_tpu_torch.core.linop import dottest
from surfh_tpu_torch.instrument import geometry as pgeo
from surfh_tpu_torch.instrument.ifu import IFU
from surfh_tpu_torch.models import blind2d
from surfh_tpu_torch.solvers.criterion import QuadCriterion_MRS_2D

torch.set_num_threads(2)


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


def blind_setup(port: bool, rectangle: bool, im: int = 41, n_slit: int = 3):
    """tests/test_solvers.py `_blind_setup` in either package (float64)."""
    geo, ifu, mod, f = (pgeo, IFU, blind2d, ir2fr) if port else (jgeo, JaxIFU, jblind, jax_ir2fr)
    step = fixtures.STEP_DEGREE
    axis = (np.arange(im) - im // 2) * step
    fov_w = 0.4 * im * fixtures.STEP_ARCSEC
    instr = ifu(fov=geo.FOV(fov_w / 3600, 1.1 * fov_w / 3600, origin=geo.Coord(0, 0),
                            angle=0.0 if rectangle else 8.1),
                det_pix_size=0.196, n_slit=n_slit, w_blur=None, pce=None, wavel_axis=None,
                name="1C").pix(step)
    pointings = geo.CoordList([geo.Coord(0, 0), geo.Coord(4 * step, 2 * step),
                               geo.Coord(-3 * step, -2 * step)]).pix(step)
    sotf = f(np.ones((5, 5)) / 25.0, (im, im))
    cls = mod.MRSBlurredRectangle if rectangle else mod.MRSBlurred
    kw = dict(device="cpu") if port else {}
    model = cls(sotf, axis, axis.copy(), instr, step, pointings,
                dtype=np.float64 if port else jnp.float64, **kw)
    xx, yy = np.meshgrid(np.linspace(-1, 1, im), np.linspace(-1, 1, im), indexing="ij")
    return model, np.exp(-(xx**2 + yy**2) / 0.2) + 0.3


GEOMETRIES = ["rectangle", "rotated"]


@pytest.fixture(scope="module", params=GEOMETRIES)
def pair(request):
    rect = request.param == "rectangle"
    jm, truth = blind_setup(False, rect)
    pm, _ = blind_setup(True, rect)
    return jm, pm, truth


def _assert_tables_equal(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        if isinstance(a[k], list) and a[k] and isinstance(a[k][0], tuple):
            assert len(a[k]) == len(b[k]), k
            for u, v in zip(a[k], b[k]):
                for s, t in zip(u, v):
                    np.testing.assert_array_equal(s, t, err_msg=k)
        else:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_tables_bit_for_bit(pair):
    jm, pm, _ = pair
    _assert_tables_equal(blind2d_tables(pm), blind2d_tables(jm))


def test_forward_adjoint_and_dot_test(pair):
    jm, pm, _ = pair
    rng = np.random.default_rng(0)
    x, y = rng.standard_normal(jm.ishape), rng.standard_normal(jm.oshape)
    assert pm.oshape == jm.oshape and pm.ishape == jm.ishape
    assert rel(pm.forward(x), jm.forward(x)) <= 1e-12
    assert rel(pm.adjoint(y), jm.adjoint(y)) <= 1e-12
    assert torch.equal(pm.adjoint(y, plain=True), pm.adjoint(y))
    assert torch.equal(pm.forward(x, plain=True), pm.forward(x))
    assert rel(pm.normal(x), jm.adjoint(jm.forward(x))) <= 1e-12
    assert dottest(pm, num=3, rtol=1e-12)


def test_deconv_cube(pair):
    jm, pm, _ = pair
    rng = np.random.default_rng(2)
    stack = np.stack([jm.sotf, 0.5 * jm.sotf, np.conj(jm.sotf)])
    jc, pc = jblind.DeconvCube(jm, stack), blind2d.DeconvCube(pm, stack)
    _assert_tables_equal(blind2d_tables(pc), blind2d_tables(jc))
    x, y = rng.standard_normal(jc.ishape), rng.standard_normal(jc.oshape)
    got = pc.forward(x)
    assert rel(got, jc.forward(x)) <= 1e-12
    assert rel(pc.adjoint(y), jc.adjoint(y)) <= 1e-12
    assert dottest(pc, num=2, rtol=1e-12)
    per_plane = torch.stack([pm._forward_fn(torch.as_tensor(x[w]), pc._stack_t[w])
                             for w in range(3)])
    assert rel(got, per_plane.reshape(-1)) <= 1e-14
    assert pc.cube_oshape == jc.cube_oshape and pc.n_lambda == 3


def test_data_to_img(pair):
    jm, pm, truth = pair
    y = np.asarray(jm.forward(truth))
    got, want = pm.data_to_img(y), jm.data_to_img(y)
    assert got.shape == want.shape == pm.imshape and np.isfinite(got).all()
    scale = pm.npix_slit_beta_width * pm.srf
    yp = y.reshape(pm.slices_shape) / scale
    cums = []
    for p in range(len(pm.pointings)):
        cum = pm.derived_adjoint(lambda x, p=p: pm._slit_sums(pm._grid(x, p, False)),
                                 ("data_to_img", p), torch.as_tensor(yp[p])).numpy()

        def fwd(x, p=p):  # the reference's per-pointing map, as its data_to_img spells it
            summed = jfft.idft(jfft.dft(jm._grid(x, p)) * jm.otf_combined, jm.local_im_shape)
            n_aout, srf, sb = jm.slices_shape[2], jm.srf, jm.slit_shape[1]
            win = jnp.stack([summed[a0 : a0 + n_aout * srf : srf, b0 : b0 + sb]
                             for a0, b0 in zip(jm.slit_a_starts, jm.slit_b_starts)])
            return jnp.sum(win * jm.slit_weights_sub, axis=2)

        want_p = np.asarray(jax.linear_transpose(fwd, jax.ShapeDtypeStruct(jm.ishape, jnp.float64))(
            jnp.asarray(yp[p]))[0])
        assert rel(cum, want_p) <= 1e-12
        cums.append((cum, want_p))
    n_got = sum((c != 0).astype(int) for c, _ in cums)
    n_want = sum((w != 0).astype(int) for _, w in cums)
    same = n_got == n_want
    assert same.mean() > 0.9
    assert np.abs(got[same] - want[same]).max() <= 1e-12 * np.abs(want).max()
    peak = max(np.abs(w).max() for _, w in cums)
    for c, w in cums:
        flip = (c != 0) != (w != 0)
        assert np.abs(c[flip]).max(initial=0) <= 1e-12 * peak
        assert np.abs(w[flip]).max(initial=0) <= 1e-12 * peak


def test_recovery_bar():
    """The reference's end-to-end bar: in-FOV relative error < 0.05."""
    model, truth = blind_setup(True, True, im=61, n_slit=4)
    y = model.forward(truth)
    crit = QuadCriterion_MRS_2D(1.0, y, model, mu_reg=1e-6)
    res = crit.run_method("lcg", maximum_iterations=150, tolerance=1e-12, value_init=0.5)
    recon = res.x.numpy().reshape(model.ishape)
    cover = model.adjoint(np.ones(model.oshape)).numpy()
    mask = cover > 0.5 * cover.max()
    err = np.linalg.norm((recon - truth)[mask]) / np.linalg.norm(truth[mask])
    assert err < 0.05, f"relative error {err:.3f}"


@pytest.mark.parametrize("geometry", GEOMETRIES)
def test_criterion_2d_against_the_reference(geometry):
    rect = geometry == "rectangle"
    jm, truth = blind_setup(False, rect)
    pm, _ = blind_setup(True, rect)
    y = np.asarray(jm.forward(truth))
    jc, pc = JaxCrit2D(1.0, y, jm, 1e-5), QuadCriterion_MRS_2D(1.0, y, pm, 1e-5)
    x0 = np.full(pm.ishape, 0.5)
    j0, p0 = jc.get_crit_val(x0), pc.get_crit_val(x0)
    assert abs(p0 - j0) <= 1e-12 * abs(j0)
    jr = jc.run_method("lcg", maximum_iterations=10)
    pr = pc.run_method("lcg", maximum_iterations=10)
    assert pr.n_iter == jr.n_iter
    assert rel(pr.x, jr.x) <= 1e-10
    assert abs(pc.get_crit_val(pr.x) - jc.get_crit_val(jr.x)) <= 1e-10 * abs(jc.get_crit_val(jr.x))
    res = pc.run_method("lcg", maximum_iterations=30)
    assert pc.get_crit_val(res.x) < p0 * 1e-2
    with pytest.raises(NotImplementedError, match="separated"):
        QuadCriterion_MRS_2D(1.0, y, pm, 1e-5, gradient="joint")
