"""The port's NumPy host table functions against the reference's, bit for bit:
bilinear plans, the composed window plan, the Slicer tables, the PSF
stack, the flagship problem generator, and the channel geometry; and the
name under which the port's CUDA libraries are built."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from surfh_tpu.core import bilinear as jbilinear
from surfh_tpu.models.channel import Channel as JaxChannel
from surfh_tpu.simulation import flagship as jflagship
from surfh_tpu.utils.psf import gaussian_psf as jax_gaussian_psf
from surfh_tpu_torch.core import bilinear
from surfh_tpu_torch.models.channel import Channel
from surfh_tpu_torch.simulation import flagship
from surfh_tpu_torch.simulation.synthetic import make_setup
from surfh_tpu_torch.utils.psf import gaussian_psf

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def channels():
    s = make_setup(im_size=41, n_lambda=36, n_tpl=2, n_channels=2, n_pointings=3, n_slit=4)
    out = []
    for instr in s["instrs"]:
        args = (instr, s["alpha_axis"], s["beta_axis"], s["wavelength_axis"], 3,
                s["pointings"][0], s["step_degree"])
        out.append((Channel(*args, dtype=np.float64), JaxChannel(*args, dtype=jnp.float64)))
    return out


def test_bilinear_plan_matches_reference():
    rng = np.random.default_rng(0)
    aa, bb = np.linspace(-1, 1, 17), np.linspace(-2, 1, 13)
    pts = rng.uniform(-2.5, 2.5, (400, 2))
    got = bilinear.bilinear_plan(aa, bb, pts)
    want = jbilinear.bilinear_plan(aa, bb, pts)
    np.testing.assert_array_equal(got.idx, want.idx)
    np.testing.assert_array_equal(got.w, want.w)
    assert got.shape == want.shape
    np.testing.assert_array_equal(bilinear.grid_points(pts[:, :1], pts[:, 1:]),
                                  jbilinear.grid_points(pts[:, :1], pts[:, 1:]))


@pytest.mark.parametrize("c", [0, 1])
def test_channel_geometry_and_composed_plans_match_reference(channels, c):
    chan, ref = channels[c]
    assert chan.oshape == ref.oshape and chan.tbbox == ref._tbbox
    assert chan.box_offset == ref._box_offset and chan.slit_shape == ref.slit_shape
    assert chan.wslice == ref.wslice
    np.testing.assert_array_equal(chan.slit_a_starts, ref.slit_a_starts)
    np.testing.assert_array_equal(chan.slit_b_starts, ref.slit_b_starts)
    np.testing.assert_array_equal(chan.slit_weights_sub, ref.slit_weights_sub)
    for a, b in zip(chan.composed_stack, ref._composed_stack):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(chan.host_tables()["wpsf"], ref._wpsf_dev)
    # one pointing's composed plan straight from compose_window_plan
    p = ref.plans_fwd[0]
    args = (p, ref.slit_a_starts, ref.slit_b_starts, ref._box_offset, ref.srf, ref.oshape[3],
            ref.slit_shape[2], ref.local_im_shape, ref._tbbox, np.float64)
    got, want = bilinear.compose_window_plan(*args), jbilinear.compose_window_plan(*args)
    for f in ("idx", "w", "csrc", "cw", "cdst"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)
    assert got.out_shape == want.out_shape and got.patch_shape == want.patch_shape


def test_gaussian_psf_matches_reference():
    lam = np.linspace(5.0, 27.0, 17)
    np.testing.assert_array_equal(gaussian_psf(lam, 0.025), jax_gaussian_psf(lam, 0.025))


def test_flagship_setup_matches_reference():
    kw = dict(npix=31, bands=["1a", "3b"], n_pointings=2)
    got = flagship.make_flagship_setup(**kw)
    want = jflagship.make_flagship_setup(build_sotf=False, **kw)
    for k in ("maps", "templates", "wavelength_axis", "alpha_axis", "beta_axis", "psf_stack"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got["bands"] == want["bands"] and got["im_shape"] == want["im_shape"]
    assert [(p.alpha, p.beta) for p in got["pointings"][1]] == [
        (p.alpha, p.beta) for p in want["pointings"][1]]
    for a, b in zip(got["instrs"], want["instrs"]):
        assert a.name == b.name and a.n_slit == b.n_slit
        np.testing.assert_array_equal(a.wavel_axis, b.wavel_axis)


def test_library_name_hashes_every_file_the_build_reads(tmp_path, monkeypatch):
    """An edited header renames the libraries that include it (a stale
    library is never loaded), and no other."""
    import shutil

    from surfh_tpu_torch.core import _build

    libs = {"gather_rows": ["gather_rows.cu"], "gather_fixed": ["gather_fixed.cu"],
            "wblur_banded": ["wblur_banded.cu"]}
    assert _build.build_inputs(libs["gather_rows"]) == ["gather_rows.cu", "gather_lanes.cuh"]
    assert _build.build_inputs(libs["gather_fixed"]) == ["gather_fixed.cu", "gather_lanes.cuh"]
    # every file of csrc/ is read by some build, and every include is a file there
    read = {f for srcs in libs.values() for f in _build.build_inputs(srcs)}
    assert read == {p.name for p in _build.CSRC.iterdir() if p.is_file()}
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    before = {name: _build.library_path(name, srcs) for name, srcs in libs.items()}
    assert before == {name: _build.library_path(name, srcs) for name, srcs in libs.items()}
    with open(csrc / "gather_lanes.cuh", "a") as f:
        f.write("// edited\n")
    after = {name: _build.library_path(name, srcs) for name, srcs in libs.items()}
    assert after["gather_rows"] != before["gather_rows"]
    assert after["gather_fixed"] != before["gather_fixed"]
    assert after["wblur_banded"] == before["wblur_banded"]
    with open(csrc / "wblur_banded.cu", "a") as f:
        f.write("// edited\n")
    assert _build.library_path("wblur_banded", libs["wblur_banded"]) != before["wblur_banded"]
