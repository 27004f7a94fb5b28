"""surfh_tpu_torch's simulated ground truth (`simulation/data.py`, host
NumPy) against `surfh_tpu.simulation.data`: the two synthetic scenes and
`get_simulation_data` (margins, subsampling, the PSF from a file) array
for array at 1e-12; `get_simulation_data` on Orion FITS files the test
writes, the reference's processing chain fed the same arrays."""

import numpy as np
import pytest

from surfh_tpu.simulation import data as jax_data
from surfh_tpu_torch import simulation
from surfh_tpu_torch.preprocessing import fits_write
from surfh_tpu_torch.preprocessing.fits_io import CARD, _format_card, _pad_block
from surfh_tpu_torch.simulation import data

TOL = 1e-12


def close(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        x, y = np.asarray(x), np.asarray(y)
        assert x.shape == y.shape
        np.testing.assert_allclose(x, y, rtol=TOL, atol=TOL * max(1.0, float(np.abs(y).max())))


@pytest.mark.parametrize("scene", ["synthetic_orion", "synthetic_ngc7023"])
def test_scene_matches_reference(scene):
    kw = dict(n_maps=3, size=41, n_wavel=60)
    close(getattr(data, scene)(**kw), getattr(jax_data, scene)(**kw))


@pytest.mark.parametrize("sub,margin", [(4, 0), (4, 5), (2, 0)])
def test_get_simulation_data_matches_reference(sub, margin):
    kw = dict(spatial_subsampling=sub, margin=margin, synthetic_kwargs=dict(size=120, n_wavel=120))
    got = data.get_simulation_data(**kw)
    close(got, jax_data.get_simulation_data(**kw))
    a, b, w, spsf, maps, tpl = got
    assert maps.shape[0] == 4 and tpl.shape == (4, len(w)) and spsf.shape[0] == len(w)


def test_margin_too_large_raises():
    with pytest.raises(ValueError, match="margin"):
        data.get_simulation_data(spatial_subsampling=4, margin=200,
                                 synthetic_kwargs=dict(size=60, n_wavel=30))


def _write_spectra(path, columns):
    """A primary HDU, then a BINTABLE of float64 columns."""
    names = list(columns)
    n = len(columns[names[0]])

    def header(cards):
        return _pad_block(b"".join([_format_card(k, v) for k, v in cards] + [b"END".ljust(CARD)]))

    cards = [("XTENSION", "BINTABLE"), ("BITPIX", 8), ("NAXIS", 2), ("NAXIS1", 8 * len(names)),
             ("NAXIS2", n), ("PCOUNT", 0), ("GCOUNT", 1), ("TFIELDS", len(names))]
    for i, name in enumerate(names, 1):
        cards += [(f"TTYPE{i}", name), (f"TFORM{i}", "D")]
    rows = np.stack([np.asarray(columns[k], np.float64) for k in names], axis=1).astype(">f8")
    buf = header([("SIMPLE", True), ("BITPIX", 8), ("NAXIS", 0)])
    buf += header(cards) + _pad_block(rows.tobytes(), b"\x00")
    path.write_bytes(buf)


def test_get_simulation_data_from_files(tmp_path, monkeypatch):
    rng = np.random.default_rng(3)
    maps = rng.random((4, 64, 64))
    wavel = np.linspace(4.9, 28.3, 90)
    cols = {"wavelength": wavel}
    for k in ("spectrum_h2", "spectrum_if", "spectrum_df", "spectrum_mc"):
        cols[k] = 10 + rng.random(90)
    fits_write(str(tmp_path / "abundances_orion.fits"), maps)
    _write_spectra(tmp_path / "spectra_mir_orion.fits", cols)
    psf = rng.random((30, 9, 9))
    np.save(tmp_path / "psf.npy", psf)

    m, tpl, step, w = data._load_orion_files(str(tmp_path))
    np.testing.assert_array_equal(m, maps)
    np.testing.assert_array_equal(w, wavel)
    np.testing.assert_array_equal(tpl, np.stack([cols[k] for k in list(cols)[1:]]))
    got = data.get_simulation_data(spatial_subsampling=4, path_cube_orion=str(tmp_path),
                                   path_spsf=str(tmp_path / "psf.npy"))
    # the reference's chain on the same arrays (its FITS table read aside)
    monkeypatch.setattr(jax_data, "_load_orion_files", lambda p: (maps, tpl, step, wavel))
    want = jax_data.get_simulation_data(spatial_subsampling=4, path_cube_orion=str(tmp_path),
                                        path_spsf=str(tmp_path / "psf.npy"))
    close(got, want)
    np.testing.assert_array_equal(got[3], psf)


def test_package_exports():
    assert simulation.get_simulation_data is data.get_simulation_data
    assert simulation.synthetic_orion is data.synthetic_orion
    assert simulation.synthetic_ngc7023 is data.synthetic_ngc7023
