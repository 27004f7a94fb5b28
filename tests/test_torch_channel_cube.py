"""surfh_tpu_torch's `Channel` on cubes against the JAX package (CPU,
float64), on `make_setup(im_size=31, n_slit=3, n_pointings=2)`'s band.

* the composed path: `forward`, the exact `adjoint` / `adjoint_windowed`
  and the approximate `adjoint_interp` ≤1e-12 relative to the reference's,
  the port's dot test ≤1e-12;
* the staged path (``SURFH_COMPOSED_GRIDDING=0`` at construction, in both
  packages): the gather onto the local grid and the direct box-sum, against
  the reference's staged path;
* the FFT box-sum branch: no `make_setup` geometry reaches it (every one
  calibrates to offset 0), so both packages' staged channels are built,
  then their box offset set to None before the first application;
* the three agree with each other, and the gridding tables of either
  package are the same bits (`convert.channel_tables_from_reference`);
  `regrid` shares the spectral tables and builds what a fresh channel does.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from surfh_tpu.instrument.geometry import get_srf
from surfh_tpu.models.channel import Channel as JaxChannel
from surfh_tpu.simulation.synthetic import make_setup as jax_make_setup
from surfh_tpu_torch.convert import channel_tables_from_reference
from surfh_tpu_torch.models.channel import Channel
from surfh_tpu_torch.simulation.synthetic import make_setup

torch.set_num_threads(2)

KW = dict(im_size=31, n_lambda=24, n_channels=1, n_pointings=2, n_slit=3)
MODES = ["composed", "staged", "fft"]


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


def channel_pair(monkeypatch, mode: str, gridding: str = "bilinear", kw=KW):
    """The band of `make_setup(**kw)` in both packages, float64, in `mode`."""
    if mode == "composed":
        monkeypatch.delenv("SURFH_COMPOSED_GRIDDING", raising=False)
    else:
        monkeypatch.setenv("SURFH_COMPOSED_GRIDDING", "0")
    js, ps = jax_make_setup(**kw), make_setup(**kw)
    srf = get_srf([js["instrs"][0].det_pix_size], js["step_degree"] * 3600)[0]
    jc = JaxChannel(js["instrs"][0], js["alpha_axis"], js["beta_axis"], js["wavelength_axis"], srf,
                    js["pointings"][0], js["step_degree"], dtype=jnp.float64, gridding=gridding)
    pc = Channel(ps["instrs"][0], ps["alpha_axis"], ps["beta_axis"], ps["wavelength_axis"], srf,
                 ps["pointings"][0], ps["step_degree"], np.float64, gridding)
    if mode == "fft":
        jc._box_offset = None
        pc.box_offset = None
    return jc, pc.to("cpu", torch.float64)


def assert_same_tables(want: dict, chan: Channel):
    assert chan.gridding == want["gridding"]
    assert chan.tbbox == want["tbbox"] and chan.box_offset == want["box_offset"]
    for (idx, w), p in zip(want["plans_fwd"], chan.plans_fwd, strict=True):
        np.testing.assert_array_equal(p.idx, idx)
        np.testing.assert_array_equal(p.w, w)
    if want["composed_stack"] is None:
        assert chan.composed_stack is None and chan.staged
    else:
        for a, b in zip(chan.composed_stack, want["composed_stack"], strict=True):
            np.testing.assert_array_equal(a, b)
    for k in ("slit_a_starts", "slit_b_starts", "slit_weights_sub", "wpsf"):
        np.testing.assert_array_equal(getattr(chan, k), want[k], err_msg=k)


@pytest.mark.parametrize("mode", MODES)
def test_channel_against_the_reference(monkeypatch, mode):
    jc, pc = channel_pair(monkeypatch, mode)
    assert pc.staged == (mode != "composed") == (jc._composed_stack is None)
    assert_same_tables(channel_tables_from_reference(jc), pc)
    rng = np.random.default_rng(0)
    x, y = rng.standard_normal(jc.ishape), rng.standard_normal(jc.oshape)
    hx = pc.forward(x)
    assert hx.shape == jc.oshape and rel(hx, jc.forward(x)) <= 1e-12
    adj = pc.adjoint(y)
    assert adj.shape == jc.ishape and rel(adj, jc.adjoint(y)) <= 1e-12
    assert rel(pc.adjoint_windowed(y), jc.adjoint_windowed(y)) <= 1e-12
    assert rel(pc.adjoint_interp(y), jc.adjoint_interp(y)) <= 1e-12
    lhs, rhs = float((hx * torch.as_tensor(y)).sum()), float((torch.as_tensor(x) * adj).sum())
    assert abs(lhs - rhs) <= 1e-12 * abs(lhs)
    assert torch.equal(pc.forward(x, plain=True), hx)
    assert torch.equal(pc.adjoint_interp(y, plain=True), pc.adjoint_interp(y))


def test_the_three_paths_agree(monkeypatch):
    rng = np.random.default_rng(4)
    outs = {}
    for mode in MODES:
        _, pc = channel_pair(monkeypatch, mode)
        if not outs:
            x, y = rng.standard_normal(pc.ishape), rng.standard_normal(pc.oshape)
        outs[mode] = (pc.forward(x), pc.adjoint(y))
    for mode in ("staged", "fft"):
        assert rel(outs[mode][0], outs["composed"][0]) <= 1e-12
        assert rel(outs[mode][1], outs["composed"][1]) <= 1e-12


def test_regrid_shares_the_spectral_tables(monkeypatch):
    _, pc = channel_pair(monkeypatch, "composed")
    wpsf = pc.wpsf
    monkeypatch.setenv("SURFH_COMPOSED_GRIDDING", "0")
    staged = pc.regrid("nn")
    assert staged.staged and staged.gridding == "nn" and staged.wpsf is wpsf
    assert not pc.staged and pc.gridding == "bilinear" and pc.tables is not None
    _, fresh = channel_pair(monkeypatch, "staged", "nn")
    assert staged.tbbox == fresh.tbbox
    staged.to("cpu", torch.float64)
    x = np.random.default_rng(1).standard_normal(pc.ishape)
    assert torch.equal(staged.forward(x), fresh.forward(x))


def test_unknown_gridding_raises():
    ps = make_setup(**KW)
    with pytest.raises(ValueError, match="gridding"):
        Channel(ps["instrs"][0], ps["alpha_axis"], ps["beta_axis"], ps["wavelength_axis"], 2,
                ps["pointings"][0], ps["step_degree"], np.float64, "cubic")
    chan = Channel(ps["instrs"][0], ps["alpha_axis"], ps["beta_axis"], ps["wavelength_axis"], 2,
                   ps["pointings"][0], ps["step_degree"], np.float64)
    with pytest.raises(RuntimeError, match="to\\(device"):
        chan.forward(np.zeros(chan.ishape))
