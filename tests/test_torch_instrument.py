"""The port's own instrument model (`surfh_tpu_torch/instrument/`) against
`surfh_tpu.instrument`, on the CPU: equal, value for value.

* `miri.fusion_bands` for all 12 bands, field by field (FOV, slits, PCE,
  λ axis, resolution), and `build_ifu` in arcsec, not centered;
* `wavelength_mrs.get_mrs_wavelength` and the dither table;
* `SpectralBlur.psfs` in float64, bit for bit, computed afresh by each
  package (separate cache directories), with the same cache key and file;
  without `SURFH_CACHE_DIR` the port's cache lies in the temporary
  directory that TMPDIR names;
* `FOV` / `LocalFOV` / `CoordList` / `get_step` / `get_srf` on seeded inputs.

The two packages' classes are distinct types now, so objects are compared
through their numbers, never with ``isinstance``.
"""

import tempfile

import numpy as np
import pytest

from surfh_tpu.instrument import geometry as jgeometry
from surfh_tpu.instrument import miri as jmiri
from surfh_tpu.instrument import spectral as jspectral
from surfh_tpu.instrument import wavelength_mrs as jwavelength
from surfh_tpu_torch.instrument import geometry, miri, spectral, wavelength_mrs


def coord(c):
    return (c.alpha, c.beta)


def fov_numbers(f):
    return (f.alpha_width, f.beta_width, coord(f.origin), f.angle)


def assert_same_ifu(a, b):
    assert type(a).__module__.startswith("surfh_tpu_torch.")
    assert not type(b).__module__.startswith("surfh_tpu_torch.")
    assert a.name == b.name and a.n_slit == b.n_slit and a.det_pix_size == b.det_pix_size
    assert fov_numbers(a.fov) == fov_numbers(b.fov)
    assert [coord(c) for c in a.fov.vertices] == [coord(c) for c in b.fov.vertices]
    assert a.slit_beta_width == b.slit_beta_width
    assert [coord(s) for s in a.slit_shift] == [coord(s) for s in b.slit_shift]
    assert [fov_numbers(f) for f in a.slit_fov] == [fov_numbers(f) for f in b.slit_fov]
    assert a.w_blur.grating_resolution == b.w_blur.grating_resolution
    assert a.w_blur.grating_len == b.w_blur.grating_len
    np.testing.assert_array_equal(a.pce, b.pce)
    np.testing.assert_array_equal(a.wavel_axis, b.wavel_axis)
    assert (a.wavel_min, a.wavel_max, a.wavel_step, a.n_wavel) == (
        b.wavel_min, b.wavel_max, b.wavel_step, b.n_wavel)
    pa, pb = a.pix(0.025 / 3600), b.pix(0.025 / 3600)
    assert pa.name == pb.name and fov_numbers(pa.fov) == fov_numbers(pb.fov)


def test_fusion_bands_match_reference():
    assert miri.BANDS == jmiri.BANDS and len(miri.BANDS) == 12
    for a, b in zip(miri.fusion_bands(), jmiri.fusion_bands()):
        assert_same_ifu(a, b)
    for a, b in zip(miri.fusion_bands(["2b", "4c"], 0.25), jmiri.fusion_bands(["2b", "4c"], 0.25)):
        assert_same_ifu(a, b)


@pytest.mark.parametrize("band", ["1a", "3c"])
def test_build_ifu_arcsec_matches_reference(band):
    assert_same_ifu(miri.build_ifu(band), jmiri.build_ifu(band))
    assert miri.mean_resolution(band) == jmiri.mean_resolution(band)
    axis = np.linspace(4.8, 28.0, 4000)
    assert miri.build_ifu(band).wslice(axis, 0.1) == jmiri.build_ifu(band).wslice(axis, 0.1)


def test_wavelength_tables_match_reference():
    for band in miri.BANDS:
        np.testing.assert_array_equal(wavelength_mrs.get_mrs_wavelength(band),
                                      jwavelength.get_mrs_wavelength(band))
        np.testing.assert_array_equal(miri.mrs_wavel_axis(band), jmiri.mrs_wavel_axis(band))
    np.testing.assert_array_equal(wavelength_mrs.get_mrs_wavelength("ch2A"),
                                  jwavelength.get_mrs_wavelength("ch2A"))
    np.testing.assert_array_equal(miri.dithering, jmiri.dithering)
    assert [coord(c) for c in miri.ch3_dither] == [coord(c) for c in jmiri.ch3_dither]
    with pytest.raises(ValueError):
        wavelength_mrs.get_mrs_wavelength("5a")


@pytest.mark.parametrize("type_", ["mrs", "dirac"])
def test_spectral_psfs_bitwise_equal(type_, tmp_path, monkeypatch):
    rng = np.random.default_rng(11)
    out_axis = np.sort(rng.uniform(7.5, 8.7, 37))
    wavelength = np.sort(rng.uniform(7.4, 8.8, 53))
    beta = rng.uniform(-0.3, 0.3, 5)
    scale, res = float(rng.uniform(0.5, 2.0)), float(rng.uniform(2500, 3500))
    outs = []
    for name, mod in (("port", spectral), ("ref", jspectral)):
        monkeypatch.setenv("SURFH_CACHE_DIR", str(tmp_path / name))
        outs.append(mod.SpectralBlur(res).psfs(out_axis, beta, wavelength, scale, type_))
    a, b = outs
    assert a.dtype == np.float64 and a.shape == (37, 53, 5)
    np.testing.assert_array_equal(a, b)
    key = spectral._psfs_cache_key(spectral.SpectralBlur(res).grating_len, out_axis, beta,
                                   wavelength, scale, type_)
    assert key == jspectral._psfs_cache_key(jspectral.SpectralBlur(res).grating_len, out_axis,
                                            beta, wavelength, scale, type_)
    files = [sorted(p.name for p in (tmp_path / n).iterdir()) for n in ("port", "ref")]
    assert files[0] == files[1] == [f"wpsf_{key}.npy"]
    np.testing.assert_array_equal(np.load(tmp_path / "ref" / files[0][0]), a)


def test_spectral_cache_default_follows_tmpdir(tmp_path, monkeypatch):
    monkeypatch.delenv("SURFH_CACHE_DIR", raising=False)
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    monkeypatch.setattr(tempfile, "tempdir", None)  # gettempdir() reads TMPDIR afresh
    monkeypatch.setattr(spectral, "_PSF_MEM_CACHE", {})
    out_axis, wavelength = np.linspace(7.5, 8.5, 11), np.linspace(7.4, 8.6, 17)
    beta = np.array([-0.1, 0.0, 0.1])
    blur = spectral.SpectralBlur(3000.0)
    a = blur.psfs(out_axis, beta, wavelength, 1.0)
    key = spectral._psfs_cache_key(blur.grating_len, out_axis, beta, wavelength, 1.0, "mrs")
    path = tmp_path / "surfh_cache" / f"wpsf_{key}.npy"
    np.testing.assert_array_equal(np.load(path), a)


def test_geometry_matches_reference():
    rng = np.random.default_rng(12)
    step = 0.025 / 3600
    sizes = [0.196, 0.245, 0.273]
    assert geometry.get_step(sizes) == jgeometry.get_step(sizes)
    assert geometry.get_srf(sizes, 0.025) == jgeometry.get_srf(sizes, 0.025)
    axis_a = (np.arange(201) - 100.5) * step
    axis_b = (np.arange(187) - 93.5) * step
    for _ in range(5):
        w = rng.uniform(2.0, 7.0, 2) / 3600
        o = rng.uniform(-1.0, 1.0, 2) / 3600
        ang = float(rng.uniform(-20, 20))
        fa = geometry.FOV(w[0], w[1], geometry.Coord(o[0], o[1]), ang)
        fb = jgeometry.FOV(w[0], w[1], jgeometry.Coord(o[0], o[1]), ang)
        for x, y in zip(fa.local_coords(step, 5 * step, 5 * step), fb.local_coords(step, 5 * step, 5 * step)):
            np.testing.assert_array_equal(x, y)
        for x, y in zip(fa.coords(step), fb.coords(step)):
            np.testing.assert_array_equal(x, y)
        for x, y in zip(fa.global2local(axis_a, axis_b), fb.global2local(axis_a, axis_b)):
            np.testing.assert_array_equal(x, y)
        assert [coord(c) for c in fa.bbox] == [coord(c) for c in fb.bbox]
        shift = rng.uniform(-1, 1, 2) * step
        assert fov_numbers(fa + geometry.Coord(*shift)) == fov_numbers(fb + jgeometry.Coord(*shift))
        la, lb = fa.local, fb.local
        assert la.to_slices(axis_a, axis_b) == lb.to_slices(axis_a, axis_b)
        assert (la.n_alpha(step), la.n_beta(step)) == (lb.n_alpha(step), lb.n_beta(step))
        assert (la.alpha_start, la.beta_start, la.alpha_end, la.beta_end) == (
            lb.alpha_start, lb.beta_start, lb.alpha_end, lb.beta_end)
        shifted_a, shifted_b = la + geometry.Coord(*shift), lb + jgeometry.Coord(*shift)
        assert shifted_a.to_slices(axis_a, axis_b) == shifted_b.to_slices(axis_a, axis_b)
    pts = rng.uniform(-3, 3, (6, 2)) * step
    ca, cb = geometry.CoordList.from_array(pts), jgeometry.CoordList.from_array(pts)
    assert ca.box == cb.box and (ca.alpha_mean, ca.beta_mean) == (cb.alpha_mean, cb.beta_mean)
    assert [coord(c) for c in ca.pix(step)] == [coord(c) for c in cb.pix(step)]
    instrs_a, instrs_b = miri.fusion_bands(["1a", "4c"]), jmiri.fusion_bands(["1a", "4c"])
    assert [coord(c) for c in ca.fov(instrs_a, margin=step)] == [
        coord(c) for c in cb.fov(instrs_b, margin=step)]
    assert geometry.generate_pointings((1.0, 2.0), pts) == jgeometry.generate_pointings((1.0, 2.0), pts)
