"""surfh_tpu_torch's real-data preprocessing against the JAX package's
(CPU; the same inputs from a seed or the same files on disk).

* FITS: `fits_write` writes the reference's bytes; each package reads the
  other's files; the synthetic stage-2 writer writes the same bytes;
* `get_IFU` / `get_IFU_from_corrected_data` on the same files and
  `header_geometry` on the vendored header dump equal the reference's;
* Shepard: the port's torch version (CPU, float32) against the reference's
  JAX path (``backend="jax"``): ≤1e-5 of the max, and exactly 0 where no
  sample is in range;
* `correct_file` + `median_filter_slices` on a synthetic stage-2 file
  (the reference's Shepard pinned to ``backend="jax"``): ≤1e-5 of the max;
* labels, slit reorders, metrics, the NumPy oracle's plan gather: equal
  (≤1e-12 where arithmetic is involved).
"""

import functools
import os

import numpy as np
import pytest
import torch

from surfh_tpu.core import bilinear as jax_bilinear
from surfh_tpu.core import numpy_ref as jax_numpy_ref
from surfh_tpu.instrument import realmiri as jax_realmiri
from surfh_tpu.preprocessing import correction_driver as jax_cd
from surfh_tpu.preprocessing import distortion as jax_distortion
from surfh_tpu.preprocessing import fits_io as jax_fits
from surfh_tpu.preprocessing import metadata as jax_metadata
from surfh_tpu.preprocessing import shepard as jax_shepard
from surfh_tpu.simulation import stage2 as jax_stage2
from surfh_tpu.utils import metrics as jax_metrics
from surfh_tpu_torch.core import bilinear, numpy_ref
from surfh_tpu_torch.instrument import realmiri
from surfh_tpu_torch.preprocessing import correction_driver as cd
from surfh_tpu_torch.preprocessing import distortion, fits_io, metadata, shepard
from surfh_tpu_torch.simulation import stage2
from surfh_tpu_torch.utils import metrics

torch.set_num_threads(2)

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "miri_mrs_cal_header.txt")
TOL_SHEPARD = 1e-5  # float32 on both sides; exp and the row sums round differently
HEADER = {"PA_V3": 68.5755, "TARG_RA": 83.8354047, "TARG_DEC": -5.4170556, "BAND": "1A",
          "CHANNEL": 1, "NAME": "it's a test", "FLAG": True, "COUNT": 7}


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


# ---------------------------------------------------------------------------
# FITS
@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.int16, np.uint8])
def test_fits_write_same_bytes(tmp_path, dtype):
    data = (np.random.default_rng(0).random((5, 7, 3)) * 100).astype(dtype)
    fits_io.fits_write(str(tmp_path / "port.fits"), data, header=HEADER)
    jax_fits.fits_write(str(tmp_path / "ref.fits"), data, header=HEADER)
    assert (tmp_path / "port.fits").read_bytes() == (tmp_path / "ref.fits").read_bytes()


@pytest.mark.parametrize("writer", ["port", "ref"])
def test_fits_read_the_other_packages_files(tmp_path, writer):
    data = np.random.default_rng(1).standard_normal((6, 4)).astype(np.float32)
    path = str(tmp_path / "f.fits")
    (fits_io if writer == "port" else jax_fits).fits_write(path, data, header=HEADER)
    for reader in (fits_io, jax_fits):
        (hdu,) = reader.fits_open(path)
        np.testing.assert_array_equal(hdu.data, data)
        for k, v in HEADER.items():
            assert hdu.header[k] == v


def test_synthetic_stage2_same_bytes(tmp_path):
    kw = dict(band="2b", targ_ra=83.83, targ_dec=-5.42, pa_v3=30.0, n_rows=40, strip_w=9,
              noise_rms=0.1, seed=3)
    stage2.write_synthetic_stage2(str(tmp_path / "port.fits"), **kw)
    jax_stage2.write_synthetic_stage2(str(tmp_path / "ref.fits"), **kw)
    assert (tmp_path / "port.fits").read_bytes() == (tmp_path / "ref.fits").read_bytes()
    data, d2w = stage2.stage2_wcs_loader(str(tmp_path / "ref.fits"))
    jdata, jd2w = jax_stage2.stage2_wcs_loader(str(tmp_path / "ref.fits"))
    np.testing.assert_array_equal(data, jdata)
    xs, ys = np.meshgrid(np.arange(data.shape[1]), np.arange(data.shape[0]))
    for a, b in zip(d2w(xs, ys), jd2w(xs, ys)):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# instruments from headers
def _same_ifu(a, b):
    assert a.name == b.name and a.n_slit == b.n_slit and a.det_pix_size == b.det_pix_size
    assert (a.fov.alpha_width, a.fov.beta_width, a.fov.angle) == (
        b.fov.alpha_width, b.fov.beta_width, b.fov.angle)
    np.testing.assert_array_equal(a.wavel_axis, b.wavel_axis)
    np.testing.assert_array_equal(a.pce, b.pce)
    assert a.w_blur.grating_resolution == b.w_blur.grating_resolution


@pytest.mark.parametrize("band", ["1a", "2b", "3c", "4a"])
def test_get_ifu_on_a_stage2_file(tmp_path, band):
    path = str(tmp_path / f"ch{band}_cal.fits")
    jax_stage2.write_synthetic_stage2(path, band, 83.8, -5.4, pa_v3=12.5, n_rows=8, strip_w=4)
    got, want = realmiri.get_IFU(path), jax_realmiri.get_IFU(path)
    _same_ifu(got[0], want[0])
    assert got[1:] == want[1:]
    _same_ifu(realmiri.get_IFU(path, chan_name=f"ch{band}")[0],
              jax_realmiri.get_IFU(path, chan_name=f"ch{band}")[0])


@pytest.mark.parametrize("channel", [1, 2, 3, 4])
def test_get_ifu_from_corrected_data(tmp_path, channel):
    path = str(tmp_path / f"ch{channel}.fits")
    jax_fits.fits_write(path, np.zeros((4, 5), np.float32), header={
        "PA_V3": 12.5, "TARG_RA": 83.8, "TARG_DEC": -5.4, "CHANNEL": channel, "BAND": "LONG"})
    got = realmiri.get_IFU_from_corrected_data(path)
    want = jax_realmiri.get_IFU_from_corrected_data(path)
    _same_ifu(got[0], want[0])
    assert got[1:] == want[1:]


def test_header_geometry_of_the_real_header():
    got = metadata.header_geometry(FIXTURE)
    assert got == jax_metadata.header_geometry(FIXTURE)
    assert got["band"] == "1a" and got["pa_v3"] == pytest.approx(68.57554349924975)


# ---------------------------------------------------------------------------
# Shepard
def _scattered(seed, n, n_a, n_l, lo=0.0, hi=10.0):
    rng = np.random.default_rng(seed)
    pa, pl = rng.uniform(lo, hi, n), rng.uniform(lo, hi / 2, n)
    vals = np.sin(pa) + 0.3 * pl + rng.normal(0, 0.05, n)
    # the mesh overhangs the samples: its outer cells have no sample in range
    am, lm = np.meshgrid(np.linspace(lo - 3, hi + 3, n_a), np.linspace(lo - 2, hi / 2 + 2, n_l))
    return pa, pl, vals, am, lm


@pytest.mark.parametrize("kw", [
    dict(pixel_cutoff=1.0, alpha_res=0.4, lambda_res=0.3),
    dict(pixel_cutoff=2.0, alpha_res=0.25, lambda_res=0.5, p=1.5, alpha=1.0),
    dict(pixel_cutoff=2.0, alpha_res=0.5, lambda_res=0.2, row_chunk=7),
])
def test_shepard_matches_the_jax_path(kw):
    pa, pl, vals, am, lm = _scattered(0, 600, 23, 17)
    ref = jax_shepard.exponential_modified_shepard(
        pa, pl, vals, am, lm, backend="jax", **{k: v for k, v in kw.items() if k != "row_chunk"})
    got = shepard.exponential_modified_shepard(pa, pl, vals, am, lm, device="cpu", **kw)
    assert got.shape == am.shape and got.dtype == np.float32
    assert np.array_equal(got == 0, ref == 0) and (ref == 0).any() and (ref != 0).any()
    assert rel(got, ref) <= TOL_SHEPARD


def test_shepard_on_an_unsorted_mesh():
    """A mesh in no λ order: each chunk's λ window spans the samples."""
    pa, pl, vals, am, lm = _scattered(1, 300, 11, 9)
    perm = np.random.default_rng(2).permutation(am.size)
    am, lm = am.ravel()[perm], lm.ravel()[perm]
    kw = dict(pixel_cutoff=1.5, alpha_res=0.5, lambda_res=0.5)
    ref = jax_shepard.exponential_modified_shepard(pa, pl, vals, am, lm, backend="jax", **kw)
    got = shepard.exponential_modified_shepard(pa, pl, vals, am, lm, device="cpu", row_chunk=5, **kw)
    assert np.array_equal(got == 0, ref == 0) and rel(got, ref) <= TOL_SHEPARD


def test_shepard_zero_where_no_sample_is_in_range():
    got = shepard.exponential_modified_shepard(
        np.array([0.0]), np.array([0.0]), np.array([5.0]), np.array([[10.0, 0.5]]),
        np.array([[10.0, 0.0]]), pixel_cutoff=1.0, device="cpu")
    assert got[0, 0] == 0.0 and got[0, 1] == pytest.approx(5.0)


# ---------------------------------------------------------------------------
# the correction chain
N_LAMBDA = 40  # 4a's 542-sample table shrunk: the channel build and the regrid stay test-sized


@pytest.fixture()
def shrunk_4a(monkeypatch):
    full = jax_realmiri.get_mrs_wavelength("4a")
    det = np.linspace(full[0], full[-1], N_LAMBDA)
    for mod in (jax_realmiri, realmiri):
        monkeypatch.setattr(mod, "get_mrs_wavelength", lambda b: det)
    # the reference's Shepard pinned to its JAX path (not the native library)
    monkeypatch.setattr(jax_distortion, "exponential_modified_shepard",
                        functools.partial(jax_shepard.exponential_modified_shepard, backend="jax"))
    return det


@pytest.mark.parametrize("pa_v3", [0.0, 68.58])
def test_correct_file_and_median_filter(tmp_path, shrunk_4a, pa_v3):
    lam = shrunk_4a
    step = 0.2
    path = str(tmp_path / "obs1_ch4a_dither1_cal.fits")
    jax_stage2.write_synthetic_stage2(path, "4a", 83.83, -5.42, pa_v3=pa_v3, lam_table=lam,
                                      strip_w=40, noise_rms=0.05, seed=1)
    dstep = float(np.median(np.diff(lam)))
    wavel = np.concatenate([lam[0] - dstep * np.arange(3, 0, -1), lam, lam[-1] + dstep * np.arange(1, 4)])
    args = (path, "ch4a", 61, wavel, 0)
    got, ifu, ra, dec = cd.correct_file(*args, wcs_loader=stage2.stage2_wcs_loader,
                                        step_arcsec=step, device="cpu")
    want, jifu, jra, jdec = jax_cd.correct_file(*args, wcs_loader=jax_stage2.stage2_wcs_loader,
                                                step_arcsec=step)
    _same_ifu(ifu, jifu)
    assert (ra, dec) == (jra, jdec)
    assert got.shape == want.shape and got.shape[:2] == (12, N_LAMBDA)
    assert np.abs(want).max() > 0 and rel(got, want) <= TOL_SHEPARD
    f_got = distortion.median_filter_slices(got, size=11)
    f_want = jax_distortion.median_filter_slices(want, size=11)
    assert rel(f_got, f_want) <= TOL_SHEPARD
    cd.corrected_to_fits(str(tmp_path / "port.fits"), f_want, ifu, ra, dec)
    jax_cd.corrected_to_fits(str(tmp_path / "ref.fits"), f_want, jifu, jra, jdec)
    assert (tmp_path / "port.fits").read_bytes() == (tmp_path / "ref.fits").read_bytes()


@pytest.mark.parametrize("chan", ["ch1b", "ch2a", "ch3c", "ch4a"])
def test_reorder_slits(chan):
    n = {"1": 21, "2": 17, "3": 16, "4": 12}[chan[2]]
    x = np.random.default_rng(4).random((n, 5, 3))
    np.testing.assert_array_equal(cd.reorder_slits(x, chan), jax_cd.reorder_slits(x, chan))


def test_labels_sorted_by_centroid():
    rng = np.random.default_rng(5)
    grid = np.zeros((20, 60))
    for x0 in rng.permutation(np.arange(2, 58, 7))[:6]:
        grid[:, x0 : x0 + 3] = 1
    got = distortion.sort_labels_by_centroid(distortion.generate_label_image(grid))
    want = jax_distortion.sort_labels_by_centroid(jax_distortion.generate_label_image(grid))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape", [(3, 20, 60), (20, 60)])
def test_median_filter_slices(shape):
    x = np.random.default_rng(8).random(shape)
    np.testing.assert_array_equal(distortion.median_filter_slices(x, size=5),
                                  jax_distortion.median_filter_slices(x, size=5))


# ---------------------------------------------------------------------------
# metrics and the NumPy oracle
def test_metrics_equal():
    rng = np.random.default_rng(6)
    a, b = rng.random((6, 9, 8)), rng.random((6, 9, 8))
    b[:, :2] = 0
    for name in ("mse", "relative_error", "psnr", "sam"):
        assert getattr(metrics, name)(a, b) == getattr(jax_metrics, name)(a, b)
    assert metrics.ssim(a[0], b[0]) == pytest.approx(jax_metrics.ssim(a[0], b[0]), rel=1e-12)
    assert metrics.snr([a], [b]) == jax_metrics.snr([a], [b])
    np.testing.assert_array_equal(metrics.nonzero_mean_per_slice(b), jax_metrics.nonzero_mean_per_slice(b))
    poly = [(1.5, 1.2), (1.5, 6.8), (7.2, 6.1), (6.9, 1.0)]
    np.testing.assert_array_equal(metrics.region_mean_spectrum(a, poly),
                                  jax_metrics.region_mean_spectrum(a, poly))


def test_numpy_oracle_plan_gather():
    rng = np.random.default_rng(7)
    aa, bb = np.linspace(-1, 1, 13), np.linspace(-1, 1, 11)
    pts = rng.uniform(-1.3, 1.3, (40, 2))
    for fill in (False, True):
        plan = bilinear.bilinear_plan(aa, bb, pts, fill_out_of_bounds=fill)
        jplan = jax_bilinear.bilinear_plan(aa, bb, pts, fill_out_of_bounds=fill)
        np.testing.assert_array_equal(plan.idx, jplan.idx)
        np.testing.assert_array_equal(plan.w, jplan.w)
        cube = rng.random((3, 13, 11))
        np.testing.assert_array_equal(numpy_ref.apply_plan(plan, cube), jax_numpy_ref.apply_plan(jplan, cube))
