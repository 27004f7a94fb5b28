"""Nearest-neighbour gridding in surfh_tpu_torch against the JAX package
(CPU, float64).

* `nearest_plan` equals the reference's, with and without
  `fill_out_of_bounds`;
* `Channel(gridding="nn")`, composed and staged: the gridding tables bit
  for bit, forward / adjoint / the reverse-plan `adjoint_interp` ≤1e-12
  relative, the port's dot test ≤1e-12;
* `SpectroSigRLSCT(gridding="nn")` in the W-plane mode (materialized OTF,
  dense blur) and the rank mode (window-local PSF stamps, the λ-rank conv
  engaged): forward and adjoint ≤1e-12 relative to the reference's, the
  port's dot test ≤1e-12; given channels of another gridding are refused.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from surfh_tpu.core.nearest import nearest_plan as jax_nearest_plan
from surfh_tpu.simulation.synthetic import make_model as jax_make_model
from surfh_tpu.simulation.synthetic import make_setup as jax_make_setup
from surfh_tpu_torch.convert import channel_tables_from_reference
from surfh_tpu_torch.core.nearest import nearest_plan
from surfh_tpu_torch.simulation.synthetic import make_model, make_setup

from test_torch_channel_cube import assert_same_tables, channel_pair

torch.set_num_threads(2)

KW = dict(im_size=31, n_lambda=120, n_tpl=2, n_channels=1, n_pointings=2, n_slit=3)
MODES = {
    "wplane": dict(window_local=False),
    "rank": dict(window_local=True, psf_stamps=True, conv_freq_rtol=1e-6, conv_rank_rtol=1e-7),
}


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.mark.parametrize("fill", [False, True])
def test_nearest_plan_matches(fill):
    rng = np.random.default_rng(2)
    a, b = np.linspace(-1, 1, 11), np.linspace(-0.8, 0.9, 9)
    pts = np.stack([rng.uniform(-1.3, 1.3, 200), rng.uniform(-1.1, 1.1, 200)], axis=1)
    got, want = nearest_plan(a, b, pts, fill), jax_nearest_plan(a, b, pts, fill)
    np.testing.assert_array_equal(got.idx, want.idx)
    np.testing.assert_array_equal(got.w, want.w)
    assert got.shape == want.shape and got.idx.shape == (1, 200)
    assert (got.w == 0).any() == fill


@pytest.mark.parametrize("mode", ["composed", "staged"])
def test_nn_channel_against_the_reference(monkeypatch, mode):
    jc, pc = channel_pair(monkeypatch, mode, "nn")
    assert_same_tables(channel_tables_from_reference(jc), pc)
    rng = np.random.default_rng(0)
    x, y = rng.standard_normal(jc.ishape), rng.standard_normal(jc.oshape)
    hx, adj = pc.forward(x), pc.adjoint(y)
    assert rel(hx, jc.forward(x)) <= 1e-12
    assert rel(adj, jc.adjoint(y)) <= 1e-12
    assert rel(pc.adjoint_interp(y), jc.adjoint_interp(y)) <= 1e-12
    lhs, rhs = float((hx * torch.as_tensor(y)).sum()), float((torch.as_tensor(x) * adj).sum())
    assert abs(lhs - rhs) <= 1e-12 * abs(lhs)


@pytest.mark.parametrize("mode", list(MODES))
def test_nn_model_against_the_reference(monkeypatch, mode):
    monkeypatch.setenv("SURFH_TABLE_CACHE", "0")
    kw = MODES[mode]
    jm, jsetup = jax_make_model(setup=jax_make_setup(**KW), dtype=jnp.float64, gridding="nn",
                                **{**kw, **({"conv_impl": "matmul"} if mode == "rank" else {})})
    pm, psetup = make_model(setup=make_setup(**KW), dtype=np.float64, gridding="nn", **kw)
    pm.to("cpu", torch.float64)
    assert pm.gridding == "nn" and all(c.gridding == "nn" for c in pm.channels)
    if mode == "rank":
        assert all("wpsf_q" in t for t in pm.host_tables()["chan"])
    rng = np.random.default_rng(1)
    x = rng.standard_normal(pm.ishape)
    y = rng.standard_normal(pm.oshape)
    hx, adj = pm.forward(x), pm.adjoint(y)
    assert rel(hx, jm.forward(x)) <= 1e-12
    assert rel(adj, jm.adjoint(y)) <= 1e-12
    lhs, rhs = float((hx * torch.as_tensor(y)).sum()), float((torch.as_tensor(x) * adj).sum())
    assert abs(lhs - rhs) <= 1e-12 * abs(lhs)


def test_given_channels_must_match_the_gridding(monkeypatch):
    monkeypatch.setenv("SURFH_TABLE_CACHE", "0")
    setup = make_setup(**KW)
    pm, _ = make_model(setup=setup, dtype=np.float64)
    with pytest.raises(ValueError, match="regrid"):
        make_model(setup=setup, dtype=np.float64, gridding="nn", channels=pm.channels)
    nn, _ = make_model(setup=setup, dtype=np.float64, gridding="nn",
                       channels=[c.regrid("nn") for c in pm.channels])
    fresh, _ = make_model(setup=setup, dtype=np.float64, gridding="nn")
    nn.to("cpu", torch.float64)
    fresh.to("cpu", torch.float64)
    x = torch.as_tensor(setup["maps"])
    assert torch.equal(nn.forward(x), fresh.forward(x))
