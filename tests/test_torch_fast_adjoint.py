"""The port's hand-written adjoints against the derived transposes, and its
transpose-plan forms, on the reference suite's model (tests/test_fast_adjoint.py:
`make_model(im_size=41, n_lambda=30, n_tpl=3, n_channels=2,
n_pointings=2, n_slit=3, dtype=float64)`), CPU float64, inputs from a
NumPy seed.

* the transpose plans (padded and sorted-COO) against the scatter and
  against each other, including heavy index collisions, and against the
  JAX package's;
* `Channel.adjoint_windowed` against the derived transpose of the
  channel's forward (`torch.func.vjp`) at 1e-10;
* `SpectroSigRLSCT.adjoint` against `adjoint_auto` at 1e-10, in the
  reference's default (the materialized-OTF W-plane model), the rank and
  dense window-local modes, cube mode and NN gridding; and `adjoint_auto`
  against the JAX `adjoint_auto` ≤1e-12;
* the channel's transpose plans (the composed COO taps) against the
  transposes of its forward plans (`RowGatherPlan.t`).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from surfh_tpu.core import bilinear as jbil
from surfh_tpu.simulation.synthetic import make_model as jax_make_model
from surfh_tpu_torch.core import bilinear
from surfh_tpu_torch.simulation.synthetic import make_model

torch.set_num_threads(2)

SETUP = dict(im_size=41, n_lambda=30, n_tpl=3, n_pointings=2, n_slit=3)
MODES = {
    "wplane": dict(),
    "rank": dict(window_local=True, psf_stamps=True, conv_freq_rtol=1e-6, conv_rank_rtol=1e-7),
    "dense_window_local": dict(window_local=True, psf_stamps=True, conv_freq_rtol=1e-6),
    "nn": dict(gridding="nn"),
}


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.fixture(scope="module")
def model_setup():
    model, setup = make_model(n_channels=2, dtype=np.float64, **SETUP)
    return model.to("cpu", torch.float64), setup


def test_transpose_plan_matches_scatter():
    rng = np.random.default_rng(0)
    axis = np.linspace(0, 1, 9)
    pts = rng.uniform(0.05, 0.95, (40, 2))
    plan = bilinear.bilinear_plan(axis, axis, pts)
    tplan = bilinear.transpose_plan(plan)
    vals = torch.as_tensor(rng.standard_normal((3, 40)))
    a = bilinear.scatter_plan(plan.idx, plan.w, vals, plan.shape).numpy()
    b = bilinear.apply_transpose_plan(tplan, vals, dtype=np.float64).numpy()
    np.testing.assert_allclose(b, a, rtol=1e-12, atol=1e-14)
    jplan = jbil.bilinear_plan(axis, axis, pts)
    want = np.asarray(jbil.apply_transpose_plan(jbil.transpose_plan(jplan), jnp.asarray(vals.numpy())))
    assert rel(b, want) <= 1e-12


def test_channel_adjoint_windowed_matches_derived(model_setup):
    model, _ = model_setup
    chan = model.channels[0].to("cpu", torch.float64)
    rng = np.random.default_rng(1)
    y = torch.as_tensor(rng.standard_normal(chan.oshape))
    zero = torch.zeros((chan.n_wslice,) + chan.imshape, dtype=torch.float64)
    _, vjp = torch.func.vjp(lambda xw: chan.forward_rows(chan.bbox_rows(xw), chan.tables), zero)
    np.testing.assert_allclose(chan.adjoint_windowed(y).numpy(), vjp(y)[0].numpy(), rtol=1e-10,
                               atol=1e-12)


@pytest.mark.parametrize("mode", list(MODES))
def test_spectro_adjoint_matches_derived(mode, monkeypatch):
    """The hand-written adjoint against `adjoint_auto` (1e-10) in each mode."""
    monkeypatch.setenv("SURFH_TABLE_CACHE", "0")
    model, _ = make_model(n_channels=2, dtype=np.float64, **SETUP, **MODES[mode])
    model.to("cpu", torch.float64)
    y = np.random.default_rng(2).standard_normal(model.oshape)
    np.testing.assert_allclose(model.adjoint(y).numpy(), model.adjoint_auto(y).numpy(),
                               rtol=1e-10, atol=1e-12)


def test_spectro_adjoint_auto_cube_mode_and_banded():
    """Cube mode (templates=None) and the banded blur: `adjoint_auto`
    transposes the dense-blur forward (the reference's), so in cube mode it
    equals the adjoint, and on a banded model the dense model's adjoint."""
    from surfh_tpu_torch.models.spectro import SpectroSigRLSCT
    from surfh_tpu_torch.simulation.synthetic import make_setup

    s = make_setup(n_channels=2, **SETUP)
    args = (s["sotf"], None, s["alpha_axis"], s["beta_axis"], s["wavelength_axis"], s["instrs"],
            s["step_degree"], s["pointings"])
    cube = SpectroSigRLSCT(*args, dtype=np.float64).to("cpu", torch.float64)
    y = np.random.default_rng(3).standard_normal(cube.oshape)
    np.testing.assert_allclose(cube.adjoint(y).numpy(), cube.adjoint_auto(y).numpy(), rtol=1e-10,
                               atol=1e-12)
    banded, _ = make_model(s, dtype=np.float64, wblur_impl="banded", wblur_band_rtol=1e-3)
    banded.to("cpu", torch.float64)
    banded.wblur_impl = "dense"
    dense_adj = banded.adjoint(y2 := np.random.default_rng(4).standard_normal(banded.oshape))
    banded.wblur_impl = "banded"
    np.testing.assert_allclose(banded.adjoint_auto(y2).numpy(), dense_adj.numpy(), rtol=1e-10,
                               atol=1e-12)


def test_spectro_adjoint_auto_matches_jax(model_setup):
    model, _ = model_setup
    jmodel, _ = jax_make_model(n_channels=2, dtype=jnp.float64, **SETUP)
    y = np.random.default_rng(5).standard_normal(model.oshape)
    assert rel(model.adjoint_auto(y).numpy(), np.asarray(jmodel.adjoint_auto(y))) <= 1e-12


def test_csr_transpose_matches_dense():
    """Sorted-COO and padded-gather transpose forms agree, with heavy index
    collisions (the edge-clamping degeneracy)."""
    rng = np.random.default_rng(3)
    na, nb, P = 13, 17, 600
    idx = (rng.integers(0, 25, (4, P)) * rng.integers(1, 3, (4, P))).astype(np.int32)
    w = rng.random((4, P))
    w[rng.random((4, P)) < 0.3] = 0.0
    plan = bilinear.BilinearPlan(idx=idx, w=w, shape=(na, nb))
    vals = torch.as_tensor(rng.standard_normal((5, P)))
    a = bilinear.apply_transpose_plan(bilinear.transpose_plan(plan), vals).numpy()
    b = bilinear.apply_transpose_plan(bilinear.csr_transpose_plan(plan), vals).numpy()
    np.testing.assert_allclose(b, a, rtol=1e-12, atol=1e-14)


def test_channel_transpose_plans_match_transposed_forward_plans(model_setup):
    """The channel's transpose plans (the composed plans' sorted COO taps)
    give the adjoint that the transposes of its forward plans give."""
    from surfh_tpu_torch.core.gather_rows import gather_rows

    model, _ = model_setup
    chan = model.channels[1]
    fwd, adj = chan.gather_plans()
    rng = np.random.default_rng(4)
    for p in range(len(fwd)):
        win = torch.as_tensor(rng.standard_normal((fwd[p].n_rows, 5)))
        a = gather_rows(win, adj[p].to("cpu", torch.float64))
        b = gather_rows(win, fwd[p].to("cpu", torch.float64).t)
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-12, atol=1e-14)
