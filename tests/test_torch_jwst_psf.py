"""surfh_tpu_torch's diffraction PSF (`utils/jwst_psf.py`) against the JAX
package's and against the physics the reference's tests hold
(tests/test_jwst_psf.py), on the CPU at small sizes.

* the physics on the port's own functions: the pupil's geometry, the core
  FWHM against λ/D, the 'last' energy normalization, the λ scaling, the
  oversampled binning, a Zernike OPD that changes the PSF and keeps its
  energy (Parseval), the recorded commissioning OPD at the in-flight level
  and its Strehl against Maréchal;
* against the reference: the pupil, the Zernike and recorded OPDs and
  `load_opd` (.npy and FITS) equal; the host `psf_stack` and
  `psf_stack_device` (on the CPU device, chunked with a ragged tail)
  against the reference's `psf_stack(use_jax=False)`, with and without an
  OPD and oversampled, ≤1e-5 of the peak (measured: the host bit for bit,
  the device stack 4e-7 — its kernels' cos / sin in torch);
* ``SURFH_SIM_PSF=diffraction``: the flagship / all-band setup's stamps
  against the reference's, ≤1e-5 of the peak, on the device asked for,
  and the card asked for without one raises.
"""

import json
import os

import numpy as np
import pytest
import torch

from surfh_tpu.simulation import flagship as jflagship
from surfh_tpu.utils import jwst_psf as jpsf
from surfh_tpu_torch.simulation import flagship
from surfh_tpu_torch.utils import jwst_psf

torch.set_num_threads(2)

TOL_PEAK = 1e-5
OPD_FIXTURE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                           "surfh_tpu_torch", "instrument", "data", "jwst_opd_commissioning.json")


def _fwhm_px(psf: np.ndarray) -> float:
    peak = psf.max()
    row = psf[np.unravel_index(psf.argmax(), psf.shape)[0]]
    above = np.where(row >= peak / 2.0)[0]
    return float(above[-1] - above[0] + 1)


def peak_rel(a, b) -> float:
    return float(np.abs(np.asarray(a, np.float64) - b).max() / np.abs(b).max())


# ---------------------------------------------------------------------------
# physics (the reference's contracts on the port's functions)


def test_pupil_geometry_and_reference():
    pup = jwst_psf.jwst_pupil(384)
    assert pup.shape == (384, 384) and pup.dtype == np.float32
    dx = jwst_psf.PUPIL_DIAMETER / 384
    assert 24.0 < pup.sum() * dx * dx < 28.0
    assert pup[192, 192] == 0.0
    np.testing.assert_array_equal(pup, jpsf.jwst_pupil(384))
    assert jwst_psf.segment_centers() == jpsf.segment_centers()


def test_core_fwhm_matches_lambda_over_d():
    psf = jwst_psf.monochromatic_psf(jwst_psf.jwst_pupil(256), 10.0, 0.025, 201)
    lam_over_d_px = (10.0e-6 / 6.5) / jwst_psf.ARCSEC_TO_RAD / 0.025
    assert 0.75 * lam_over_d_px < _fwhm_px(psf) < 1.35 * lam_over_d_px
    assert np.unravel_index(psf.argmax(), psf.shape) == (100, 100)


def test_energy_normalization_last_convention():
    psf = jwst_psf.monochromatic_psf(jwst_psf.jwst_pupil(256), 5.0, 0.05, 301)
    assert 0.75 < float(psf.sum()) <= 1.0 + 1e-3


def test_wavelength_scaling():
    pup = jwst_psf.jwst_pupil(256)
    f1 = _fwhm_px(jwst_psf.monochromatic_psf(pup, 6.0, 0.025, 201))
    f2 = _fwhm_px(jwst_psf.monochromatic_psf(pup, 12.0, 0.025, 201))
    assert 1.7 < f2 / f1 < 2.3


def test_oversample_binning():
    wavels = np.array([8.0, 12.0])
    s1 = jwst_psf.psf_stack(wavels, 0.05, npix=65, oversample=1, n_pupil=128)
    s2 = jwst_psf.psf_stack(wavels, 0.05, npix=65, oversample=2, n_pupil=128)
    assert s1.shape == s2.shape == (2, 65, 65)
    for a, b in zip(s1, s2):
        assert abs(float(a.max()) - float(b.max())) / float(a.max()) < 0.05


def test_zernike_opd_changes_psf_conserves_energy():
    pup = jwst_psf.jwst_pupil(128)
    opd = jwst_psf.zernike_opd(128, {4: 1.5e-6, 6: 0.5e-6})
    np.testing.assert_array_equal(opd, jpsf.zernike_opd(128, {4: 1.5e-6, 6: 0.5e-6}))
    base = jwst_psf.monochromatic_psf(pup, 8.0, 0.05, 301)
    aber = jwst_psf.monochromatic_psf(pup, 8.0, 0.05, 301, opd=opd)
    assert float(np.abs(aber - base).max()) > 0.1 * float(base.max())
    assert float(aber.max()) < float(base.max())
    assert abs(float(aber.sum()) - float(base.sum())) < 0.02  # Parseval: a pure phase screen
    zero = jwst_psf.monochromatic_psf(pup, 8.0, 0.05, 301, opd=np.zeros((128, 128)))
    assert np.allclose(zero, base, rtol=1e-5, atol=1e-12)


def test_recorded_opd_level_and_marechal():
    pup = jwst_psf.jwst_pupil(256)
    opd = jwst_psf.recorded_opd(OPD_FIXTURE, 256)
    with open(OPD_FIXTURE) as fh:
        np.testing.assert_array_equal(opd, jpsf.recorded_opd(json.load(fh), 256))
    sigma = float(np.sqrt(np.mean(opd[pup > 0] ** 2)))
    assert 60.0 < sigma * 1e9 < 80.0 and np.ptp(opd[pup > 0]) * 1e9 > 200.0
    for lam_um, scale in ((1.0, 0.008), (5.35, 0.025)):
        p0 = jwst_psf.monochromatic_psf(pup, lam_um, scale, 201)
        p1 = jwst_psf.monochromatic_psf(pup, lam_um, scale, 201, opd=opd)
        marechal = float(np.exp(-((2 * np.pi * sigma / (lam_um * 1e-6)) ** 2)))
        assert abs(float(p1.max() / p0.max()) - marechal) < 0.02


def test_load_opd_matches_reference(tmp_path):
    from surfh_tpu_torch.preprocessing.fits_io import fits_write

    opd = jwst_psf.zernike_opd(96, {4: 100e-9})
    np.save(tmp_path / "opd.npy", opd * 1e9)
    got = jwst_psf.load_opd(str(tmp_path / "opd.npy"), 96, unit="nm")
    assert np.allclose(got, opd, atol=1e-15)
    fits_write(str(tmp_path / "opd.fits"), (opd * 1e6).astype(np.float64))
    got = jwst_psf.load_opd(str(tmp_path / "opd.fits"), 128, unit="um")
    np.testing.assert_array_equal(got, jpsf.load_opd(str(tmp_path / "opd.fits"), 128, unit="um"))
    assert got.shape == (128, 128) and abs(got[64, 64] - opd[48, 48]) < 5e-9


# ---------------------------------------------------------------------------
# the stacks against the reference's NumPy stack


@pytest.mark.parametrize("variant", ["plain", "oversample", "zernike", "recorded"])
@pytest.mark.parametrize("where", ["host", "device"])
def test_stack_matches_reference(variant, where):
    wavels = np.array([5.3, 7.1, 9.4, 12.0, 15.5])
    kw = dict(npix=41, n_pupil=96)
    if variant == "oversample":
        kw["oversample"] = 2
    elif variant == "zernike":
        kw["opd"] = jwst_psf.zernike_opd(96, {4: 300e-9, 7: 100e-9})
    elif variant == "recorded":
        kw["opd"] = jwst_psf.recorded_opd(OPD_FIXTURE, 96)
    want = jpsf.psf_stack(wavels, 0.05, use_jax=False, **kw)
    if where == "host":
        got = jwst_psf.psf_stack(wavels, 0.05, **kw)
    else:
        got = jwst_psf.psf_stack_device(wavels, 0.05, chunk=2, device="cpu", **kw)
    assert got.shape == want.shape == (5, 41, 41) and got.dtype == np.float32
    assert peak_rel(got, want) <= TOL_PEAK


def test_device_stack_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        jwst_psf.psf_stack_device(np.array([8.0]), 0.05, npix=11, n_pupil=32)


@pytest.mark.parametrize("make", ["make_allband_setup", "make_flagship_setup"])
def test_diffraction_setup_matches_reference(monkeypatch, tmp_path, make):
    """``SURFH_SIM_PSF=diffraction``: the stamps on the device asked for (the
    CPU here) are the reference's within 1e-5 of the peak, normalized."""
    monkeypatch.setenv("SURFH_SIM_PSF", "diffraction")
    monkeypatch.setenv("SURFH_CACHE_DIR", str(tmp_path))
    kw = dict(npix=41, bands=["1a"], n_pointings=1, lambda_subsample=64, build_sotf=False)
    want = getattr(jflagship, make)(**kw)["psf_stack"]
    got = getattr(flagship, make)(device="cpu", **kw)["psf_stack"]
    assert got.shape == want.shape and got.shape[1:] == (40, 40) and got.dtype == np.float32
    assert np.allclose(got.sum(axis=(1, 2)), 1.0, atol=1e-5)
    assert float(got[0].max()) < 0.5  # not a Gaussian: the hex spikes take energy off-axis
    assert peak_rel(got, want) <= TOL_PEAK
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        getattr(flagship, make)(**kw)
