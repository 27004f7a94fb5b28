"""surfh_tpu_torch's flagship slice against the JAX reference (CPU, float64).

One rank-mode fixture (window-local, PSF stamps, matmul conv,
conv_freq_rtol=1e-6, conv_rank_rtol=1e-7, rank engaged on both channels)
is built by both packages from the same seeds:

* (a) the port's NumPy host tables equal the reference's tables carried
  across (`convert.tables_from_reference`) — bit-for-bit here, bound 1e-12;
* (d) forward / adjoint / fused normal against the reference's tabled
  programs (≤1e-12 relative: the same f64 linear map, summed in another
  order), with the reference's tables and with the port's own, plus the
  port's own dot test;
* (e) 5 CG iterates against the reference `lcg` (≤1e-10 relative: five
  round-off-level differences amplified by CG), and a bit-exact resume.

Data are finite: the reference's banded transpose spreads non-finite
values differently from a gather-form transpose.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from surfh_tpu.simulation.synthetic import make_model as jax_make_model
from surfh_tpu.simulation.synthetic import make_setup as jax_make_setup
from surfh_tpu.solvers.criterion import QuadCriterion_MRS as JaxCriterion
from surfh_tpu_torch.convert import host_tables_from_reference, tables_from_reference
from surfh_tpu_torch.core.gather_rows import RowGatherPlan
from surfh_tpu_torch.models.spectro import device_tables
from surfh_tpu_torch.simulation.synthetic import make_model, make_setup
from surfh_tpu_torch.solvers.criterion import QuadCriterion_MRS

torch.set_num_threads(2)

KW = dict(im_size=41, n_lambda=120, n_tpl=2, n_channels=2, n_pointings=2, n_slit=3)
RANK = dict(conv_freq_rtol=1e-6, conv_rank_rtol=1e-7)
PORT_RANK = dict(window_local=True, psf_stamps=True, **RANK)
MU_REG = 5e3


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.fixture(scope="module")
def pair():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SURFH_TABLE_CACHE", "0")
        jsetup = jax_make_setup(**KW)
        jm, _ = jax_make_model(setup=jsetup, dtype=jnp.float64, window_local=True,
                               conv_impl="matmul", psf_stamps=True, **RANK)
        jtables = jm.device_tables()
    stacks = [c._composed_stack for c in jm.channels]
    host = jm.host_tables()
    psetup = make_setup(**KW)
    pm, _ = make_model(setup=psetup, dtype=np.float64, **PORT_RANK)
    ref = make_model(setup=psetup, dtype=np.float64, **PORT_RANK)[0].to(
        "cpu", torch.float64, tables=tables_from_reference(host, stacks, "cpu", torch.float64))
    pm.to("cpu", torch.float64)
    x = np.array(jsetup["maps"])
    y = np.array(jax.jit(jm._forward_fn_tabled)(jnp.asarray(x), jtables))
    return SimpleNamespace(jm=jm, jtables=jtables, jsetup=jsetup, host=host, stacks=stacks,
                           pm=pm, ref=ref, psetup=psetup, x=x, y=y)


def _assert_tree_equal(a, b, path="", rtol=1e-12):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), path
        for k in a:
            _assert_tree_equal(a[k], b[k], f"{path}/{k}", rtol)
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (u, v) in enumerate(zip(a, b)):
            _assert_tree_equal(u, v, f"{path}[{i}]", rtol)
    elif isinstance(a, RowGatherPlan):
        assert a.n_src == b.n_src, path
        for f in ("row_ptr", "idx", "w", "dst"):
            _assert_tree_equal(getattr(a, f), getattr(b, f), f"{path}.{f}", rtol)
    else:
        u, v = np.asarray(a), np.asarray(b)
        assert u.shape == v.shape and u.dtype == v.dtype, (path, u.shape, v.shape, u.dtype, v.dtype)
        if u.dtype.kind in "iu":
            np.testing.assert_array_equal(u, v, err_msg=path)
        elif v.size:
            assert np.abs(u - v).max() <= rtol * max(np.abs(v).max(), 1e-300), path


def test_setup_matches_reference(pair):
    for k in ("maps", "templates", "wavelength_axis", "alpha_axis", "beta_axis", "spsf", "sotf"):
        np.testing.assert_array_equal(pair.psetup[k], pair.jsetup[k], err_msg=k)


def test_rank_engaged_and_supports_match(pair):
    assert all(s.get("rank") for s in pair.jm.conv_supports)
    assert pair.pm.conv_supports == pair.jm.conv_supports
    assert [c.oshape for c in pair.pm.channels] == [c.oshape for c in pair.jm.channels]
    assert [c.tbbox for c in pair.pm.channels] == [c._tbbox for c in pair.jm.channels]


def test_composed_stacks_match_reference(pair):
    for chan, stack in zip(pair.pm.channels, pair.stacks):
        _assert_tree_equal(tuple(chan.composed_stack), tuple(np.asarray(s) for s in stack))


def test_host_tables_match_reference(pair):
    """(a): the port's own NumPy build = the reference's tables carried across."""
    want = host_tables_from_reference(pair.host, pair.stacks)
    _assert_tree_equal(pair.pm.host_tables(), want)


def test_device_tables_match_reference(pair):
    got = device_tables(pair.pm.host_tables(), "cpu", torch.float64)
    _assert_tree_equal(got, pair.ref.tables)


@pytest.mark.parametrize("tables", ["reference", "own"])
@pytest.mark.parametrize("op", ["forward", "adjoint", "normal"])
def test_operator_matches_reference(pair, op, tables):
    """(d): the slice against the reference's tabled programs."""
    model = pair.ref if tables == "reference" else pair.pm
    rng = np.random.default_rng(3)
    if op == "forward":
        arg = pair.x
        want = jax.jit(pair.jm._forward_fn_tabled)(jnp.asarray(arg), pair.jtables)
    elif op == "adjoint":
        arg = rng.standard_normal(pair.jm.oshape)
        want = jax.jit(pair.jm._adjoint_fn_tabled)(jnp.asarray(arg), pair.jtables)
    else:
        arg = pair.x
        want = jax.jit(pair.jm._normal_fn_tabled)(jnp.asarray(arg), pair.jtables)
    got = getattr(model, op)(torch.as_tensor(arg))
    assert got.shape == tuple(np.shape(want))
    assert rel(got.numpy(), np.asarray(want)) <= 1e-12


def test_dot_test_and_fused_normal(pair):
    rng = np.random.default_rng(5)
    x = torch.as_tensor(rng.standard_normal(pair.pm.ishape))
    y = torch.as_tensor(rng.standard_normal(pair.pm.oshape))
    lhs = float(torch.dot(pair.pm.forward(x), y))
    rhs = float(torch.dot(x.reshape(-1), pair.pm.adjoint(y).reshape(-1)))
    assert abs(lhs - rhs) <= 1e-12 * abs(lhs)
    assert rel(pair.pm.normal(x), pair.pm.adjoint(pair.pm.forward(x))) <= 1e-13


def test_lcg_iterates_match_reference(pair):
    """(e): 5 iterates of the fused-normal CG against the reference's."""
    jres = JaxCriterion(1.0, pair.y, pair.jm, MU_REG).run_method("lcg", maximum_iterations=5)
    res = QuadCriterion_MRS(1.0, torch.as_tensor(pair.y), pair.pm, MU_REG).run_method(
        "lcg", maximum_iterations=5)
    assert res.n_iter == jres.n_iter == 5
    assert rel(res.x.numpy(), jres.x) <= 1e-10
    np.testing.assert_allclose(res.grad_norm, jres.grad_norm, rtol=1e-10)
    assert res.grad_norm[-1] < res.grad_norm[0]


def test_lcg_resume_is_bit_exact(pair):
    crit = QuadCriterion_MRS(1.0, torch.as_tensor(pair.y), pair.pm, MU_REG)
    straight = crit.run_method("lcg", maximum_iterations=5, return_state=True)
    first = crit.run_method("lcg", maximum_iterations=3, return_state=True)
    resumed = crit.run_method("lcg", maximum_iterations=2, solver_state=first.state,
                              return_state=True)
    for a, b in zip(resumed.state, straight.state):
        assert torch.equal(a, b)
    np.testing.assert_array_equal(
        np.concatenate([first.grad_norm, resumed.grad_norm[1:]]), straight.grad_norm)


def test_criterion_value_matches_reference(pair):
    x = np.random.default_rng(9).random(pair.pm.ishape)
    want = JaxCriterion(1.0, pair.y, pair.jm, MU_REG).get_crit_val(x)
    got = QuadCriterion_MRS(1.0, torch.as_tensor(pair.y), pair.pm, MU_REG).get_crit_val(x)
    # the reference returns its value rounded to f32
    assert abs(got - want) <= 1e-6 * abs(want)
