"""surfh_tpu_torch's s3d ingestion (`preprocessing/s3d.py`, host NumPy and
SciPy) against `surfh_tpu.preprocessing.s3d` on the cases of
tests/test_s3d.py: every output array for array (exact: the same host
code on the same inputs), plus each case's own assertion on the port."""

import numpy as np
import pytest

from surfh_tpu.preprocessing import s3d as jax_s3d
from surfh_tpu_torch.preprocessing import fits_write
from surfh_tpu_torch.preprocessing import s3d


def _write_s3d(path, cube, ra0=83.8, dec0=-5.4, cd=2.0e-5, lam0=5.0, dlam=0.01, extra=None):
    header = {"CRVAL1": ra0, "CRPIX1": 1.0, "CDELT1": cd, "CRVAL2": dec0, "CRPIX2": 1.0,
              "CDELT2": cd, "CRVAL3": lam0, "CRPIX3": 1.0, "CDELT3": dlam, "CUNIT3": "um",
              "CTYPE3": "WAVE"}
    header.update(extra or {})
    fits_write(str(path), cube.astype(np.float32), header=header)


def same(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("extra", [None, {"CRPIX1": 2.0, "CRPIX2": 2.0, "PC1_1": 0.0,
                                          "PC1_2": -1.0, "PC2_1": 1.0, "PC2_2": 0.0}],
                         ids=["axes", "pc_rotation"])
def test_read_s3d_matches_reference(tmp_path, extra):
    cube = np.arange(3 * 5 * 4, dtype=np.float64).reshape(3, 5, 4)
    _write_s3d(tmp_path / "c.fits", cube, extra=extra)
    got = s3d.read_s3d(str(tmp_path / "c.fits"))
    same(got, jax_s3d.read_s3d(str(tmp_path / "c.fits")))
    np.testing.assert_allclose(got[0], cube)
    np.testing.assert_allclose(got[1], 5.0 + np.arange(3) * 0.01)


@pytest.mark.parametrize("width", [0, 2])
def test_nan_border_matches_reference(width):
    cube = np.random.default_rng(0).random((2, 10, 10))
    got = s3d.nan_border(cube, width=width)
    np.testing.assert_array_equal(got, jax_s3d.nan_border(cube, width=width))
    if width:
        assert np.isnan(got[:, :width]).all() and np.isfinite(got[:, width:-width, width:-width]).all()


@pytest.mark.parametrize("factor", [1, 3])
def test_oversample_plane_cloud_matches_reference(factor):
    ny, nx = 5, 6
    yy, xx = np.mgrid[0:ny, 0:nx].astype(float)
    ra, dec = 10.0 + 0.5 * xx + 0.1 * yy, -3.0 + 0.4 * yy
    cube = np.arange(ny * nx, dtype=float).reshape(1, ny, nx)
    got = s3d.oversample_plane_cloud(cube, ra, dec, factor)
    same(got, jax_s3d.oversample_plane_cloud(cube, ra, dec, factor))
    assert got[0].shape == (1, ny * factor, nx * factor)


def _linear_case():
    ny, nx = 14, 12
    yy, xx = np.mgrid[0:ny, 0:nx].astype(float)
    cd = 1.0e-3
    ra, dec = 50.0 + cd * xx, 10.0 + cd * yy
    cube = np.stack([2.0 + 100.0 * (ra - 50.0) + 40.0 * (dec - 10.0) + w for w in range(3)])
    alpha = 50.0 + cd * np.linspace(2.2, 8.8, 9)
    beta = 10.0 + cd * np.linspace(2.1, 10.9, 7)
    return cube, ra, dec, alpha, beta


@pytest.mark.parametrize("oversample", [1, 2])
def test_resample_matches_reference(oversample):
    cube, ra, dec, alpha, beta = _linear_case()
    got = s3d.resample_cube_to_grid(cube, ra, dec, alpha, beta, oversample=oversample, border=1)
    want = jax_s3d.resample_cube_to_grid(cube, ra, dec, alpha, beta, oversample=oversample,
                                         border=1)
    np.testing.assert_array_equal(got, want)
    assert got.shape == (3, 7, 9)
    if oversample == 1:  # linear interpolation is exact on an affine field
        expect = 2.0 + 100.0 * (alpha[None, :] - 50.0) + 40.0 * (beta[:, None] - 10.0)
        for w in range(3):
            np.testing.assert_allclose(got[w], expect + w, rtol=1e-10)


def test_resample_fill_and_border_match_reference():
    yy, xx = np.mgrid[0:10, 0:10].astype(float)
    ra, dec = 1.0 + 0.01 * xx, 2.0 + 0.01 * yy
    cube = np.ones((2, 10, 10))
    for alpha, beta, border in ((np.array([1.02, 99.0]), np.array([2.02, 2.03]), 1),
                                (1.0 + 0.01 * np.array([2.0, 2.1, 7.0]),
                                 2.0 + 0.01 * np.array([2.0, 5.0, 7.0]), 2)):
        got = s3d.resample_cube_to_grid(cube, ra, dec, alpha, beta, oversample=1, border=border)
        want = jax_s3d.resample_cube_to_grid(cube, ra, dec, alpha, beta, oversample=1,
                                             border=border)
        np.testing.assert_array_equal(got, want)
    assert np.isfinite(got).all() and np.allclose(got, 1.0, rtol=1e-12)
