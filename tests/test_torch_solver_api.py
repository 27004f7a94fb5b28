"""The port's `lcg`, `QuadCriterion_MRS` and `SpectroSigRLSCT` take the
reference's arguments, in its order and with its defaults, and give its
results (CPU, float64, inputs from numpy seeds).

* `lcg` in both loop modes on a small SPD system (a shifted circular
  Laplacian with a varying diagonal, applied elementwise, so both packages
  apply the same operator bit for bit): `n_iter`, `converged`, `grad_norm`
  and `x` ≤1e-12 relative — a solve that stops mid-way, one that crosses the
  tolerance on its last iteration (graph mode then reports not converged,
  as the reference does), one that crosses it between two dispatch checks
  (dispatch mode runs on to the next check, as the reference does), and
  chained dispatch; a Jacobi `precond`, a `callback` called once, a
  positional call in the reference's order, an exact resume in both modes;
* `QuadCriterion_MRS.run_method` with `calc_crit=True` (`crit_val`), with
  ``gradient="joint"`` (the reference's `DifferenceOperatorJoint`), with
  ``solver_loop="dispatch"``, on a model whose forward and adjoint are
  elementwise (the same bits in both packages);
* `SpectroSigRLSCT` built from one positional argument list in the
  reference's order, both modes, forward and adjoint ≤1e-12 against the
  reference's programs, on the small synthetic problems the other tests
  use; the banded + window-local warning (the reference's text) with a
  result equal to the dense model's;
* every configuration the port has not ported raises NotImplementedError
  naming its ROADMAP item (`mmmg`: tests/test_torch_mmmg.py).
"""

import warnings
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from surfh_tpu.models.spectro import SpectroSigRLSCT as JaxSpectro
from surfh_tpu.simulation.synthetic import make_setup as jax_make_setup
from surfh_tpu.solvers import cg as jcg
from surfh_tpu.solvers.criterion import QuadCriterion_MRS as JaxCriterion
from surfh_tpu_torch.models.spectro import SpectroSigRLSCT
from surfh_tpu_torch.simulation.synthetic import make_setup
from surfh_tpu_torch.solvers import cg
from surfh_tpu_torch.solvers.criterion import QuadCriterion_MRS

torch.set_num_threads(2)

N = 400  # unknowns of the SPD system
EPS = 2e-3  # its smallest eigenvalue's scale: condition ~2e3, no early convergence


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.fixture(scope="module")
def spd():
    """Q x = d·x − (x[i−1] + x[i+1]) with d_i ∈ [2 + EPS, 3): SPD, and the
    same elementwise arithmetic in both packages."""
    rng = np.random.default_rng(11)
    d = 2.0 + EPS + rng.random(N)
    b = rng.standard_normal(N)
    jd, td = jnp.asarray(d), torch.as_tensor(d)

    def jop(x):
        return jd * x - (jnp.roll(x, 1) + jnp.roll(x, -1))

    def top(x):
        return td * x - (torch.roll(x, 1) + torch.roll(x, -1))

    # the residual history to 80 iterations, to place the tolerances
    full = jcg.lcg(jop, b, np.zeros(N), max_iter=80, tol=0.0)
    return SimpleNamespace(d=d, b=b, jop=jop, top=top, jd=jd, td=td,
                           hist=np.asarray(full.grad_norm), bnorm=float(np.linalg.norm(b)))


def _tol_crossing_at(s, k: int) -> float:
    """A tolerance that ‖r‖ first meets after iteration k."""
    h = s.hist / s.bnorm
    assert np.all(np.diff(h[: k + 1]) < 0)  # falling to there
    return float(np.sqrt(h[k] * h[k - 1]))


def _same(res, jres):
    assert res.n_iter == jres.n_iter
    assert res.converged == jres.converged
    assert res.grad_norm.shape == np.shape(jres.grad_norm)
    np.testing.assert_allclose(res.grad_norm, jres.grad_norm, rtol=1e-12, atol=0)
    assert rel(res.x.numpy(), jres.x) <= 1e-12


# case: (max_iter, crossing iteration or None, graph n_iter / converged, dispatch n_iter / converged)
LCG_CASES = {
    "stops_mid_way": (60, 12, (12, True), (25, True)),
    "crosses_on_the_last_iteration": (20, 20, (20, False), (20, True)),
    "crosses_between_two_checks": (70, 30, (30, True), (50, True)),
    "runs_out": (15, None, (15, False), (15, False)),
}


@pytest.mark.parametrize("loop", ["graph", "dispatch"])
@pytest.mark.parametrize("case", list(LCG_CASES))
def test_lcg_matches_reference(spd, case, loop):
    max_iter, k, graph, dispatch = LCG_CASES[case]
    tol = 1e-30 if k is None else _tol_crossing_at(spd, k)
    jres = jcg.lcg(spd.jop, spd.b, np.zeros(N), max_iter=max_iter, tol=tol, loop=loop)
    res = cg.lcg(spd.top, torch.as_tensor(spd.b), torch.zeros(N, dtype=torch.float64),
                 max_iter=max_iter, tol=tol, loop=loop)
    _same(res, jres)
    assert (res.n_iter, res.converged) == (graph if loop == "graph" else dispatch)


@pytest.mark.parametrize("chain", [4, 7])
def test_lcg_chained_dispatch_matches_reference(spd, chain):
    """`chain_steps` groups the iterations, so the checks fall on the
    groups' ends (28 with groups of 4 and 7 here, not 25), as in the
    reference's chained programs; the iterates are the unchained ones."""
    tol = _tol_crossing_at(spd, 12)
    jres = jcg.lcg(spd.jop, spd.b, np.zeros(N), max_iter=60, tol=tol, loop="dispatch",
                   chain_steps=chain)
    res = cg.lcg(spd.top, torch.as_tensor(spd.b), torch.zeros(N, dtype=torch.float64),
                 max_iter=60, tol=tol, loop="dispatch", chain_steps=chain)
    _same(res, jres)
    assert res.n_iter == 28
    plain = cg.lcg(spd.top, torch.as_tensor(spd.b), torch.zeros(N, dtype=torch.float64),
                   max_iter=28, tol=0.0, loop="graph")
    assert torch.equal(res.x, plain.x)


@pytest.mark.parametrize("loop", ["graph", "dispatch"])
def test_lcg_precond_and_callback_match_reference(spd, loop):
    """A Jacobi preconditioner, z = r / diag(Q), in the first residual and
    every step; the callback is called once, with the result."""
    tol = 1e-9
    jres = jcg.lcg(spd.jop, spd.b, np.zeros(N), max_iter=60, tol=tol,
                   precond=lambda r: r / spd.jd, loop=loop)
    seen = []
    res = cg.lcg(spd.top, torch.as_tensor(spd.b), torch.zeros(N, dtype=torch.float64),
                 max_iter=60, tol=tol, precond=lambda r: r / spd.td, callback=seen.append, loop=loop)
    _same(res, jres)
    assert seen == [res]
    unprec = cg.lcg(spd.top, torch.as_tensor(spd.b), torch.zeros(N, dtype=torch.float64),
                    max_iter=60, tol=tol, loop=loop)
    assert not np.array_equal(res.grad_norm, unprec.grad_norm)  # the preconditioner was applied


@pytest.mark.parametrize("loop", ["graph", "dispatch"])
def test_lcg_positional_call_in_the_reference_order(spd, loop):
    """normal_op, b, x0, max_iter, tol, precond, callback, state,
    return_state, op_args, loop, chain_steps — op_args reach the operator."""
    tol = _tol_crossing_at(spd, 9)
    calls = []
    jres = jcg.lcg(lambda x, s: s * spd.jop(x), spd.b, np.zeros(N), 40, tol, None, calls.append,
                   None, True, (jnp.asarray(1.0),), loop, 1)
    res = cg.lcg(lambda x, s: s * spd.top(x), torch.as_tensor(spd.b),
                 torch.zeros(N, dtype=torch.float64), 40, tol, None, calls.append, None, True,
                 (torch.tensor(1.0, dtype=torch.float64),), loop, 1)
    _same(res, jres)
    assert len(calls) == 2 and calls[1] is res
    for got, want in zip(res.state, jres.state):
        assert rel(got.numpy(), want) <= 1e-12


@pytest.mark.parametrize("loop", ["graph", "dispatch"])
def test_lcg_resume_is_bit_exact_in_both_modes(spd, loop):
    b, x0 = torch.as_tensor(spd.b), torch.zeros(N, dtype=torch.float64)
    straight = cg.lcg(spd.top, b, x0, max_iter=40, tol=0.0, return_state=True, loop=loop)
    first = cg.lcg(spd.top, b, x0, max_iter=23, tol=0.0, return_state=True, loop=loop)
    resumed = cg.lcg(spd.top, b, x0, max_iter=17, tol=0.0, state=first.state, return_state=True,
                     loop=loop)
    assert resumed.n_iter == 17
    for u, v in zip(resumed.state, straight.state):
        assert torch.equal(u, v)
    np.testing.assert_array_equal(np.concatenate([first.grad_norm, resumed.grad_norm[1:]]),
                                  straight.grad_norm)


def test_lcg_refuses_an_unknown_loop(spd):
    with pytest.raises(ValueError, match="loop"):
        cg.lcg(spd.top, torch.as_tensor(spd.b), torch.zeros(N, dtype=torch.float64), loop="while")


# ---------------------------------------------------------------------------
# QuadCriterion_MRS on a model with an elementwise forward: y = (w·x) flat

ISHAPE = (2, 12, 10)


class _JaxToy:
    def __init__(self, w):
        self.w = jnp.asarray(w)
        self.ishape, self.oshape, self.dtype = ISHAPE, (int(np.prod(ISHAPE)),), jnp.float64

    def forward_fn(self, x):
        return (self.w * x).reshape(-1)

    def adjoint_fn(self, y):
        return self.w * y.reshape(ISHAPE)


class _TorchToy:
    def __init__(self, w):
        self.w = torch.as_tensor(w)
        self.ishape, self.device, self.dtype = ISHAPE, torch.device("cpu"), torch.float64

    def forward(self, x):
        return (self.w * x.reshape(ISHAPE)).reshape(-1)

    def adjoint(self, y):
        return self.w * y.reshape(ISHAPE)

    def normal(self, x):
        return self.adjoint(self.forward(x))


@pytest.fixture(scope="module")
def toy():
    rng = np.random.default_rng(21)
    w = rng.uniform(0.2, 1.0, ISHAPE) * (rng.random(ISHAPE) < 0.7)  # some pixels unseen
    y = (w * rng.standard_normal(ISHAPE)).reshape(-1)
    return SimpleNamespace(w=w, y=y)


@pytest.mark.parametrize("loop", ["graph", "dispatch"])
@pytest.mark.parametrize("gradient", ["separated", "joint"])
def test_run_method_matches_reference(toy, gradient, loop):
    """µ_s = 2, µ_r = 0.3, 30 iterations at tolerance 1e-9, then 5 more from
    another start: x, grad_norm, n_iter, converged, and crit_val after
    each (the reference rounds its value to float32, a TPU fetch rule: the
    port's value, rounded so, is its value)."""
    jcrit = JaxCriterion(2.0, toy.y, _JaxToy(toy.w), 0.3, False, gradient)
    crit = QuadCriterion_MRS(2.0, torch.as_tensor(toy.y), _TorchToy(toy.w), 0.3, False, gradient)
    init = np.random.default_rng(4).random(ISHAPE)
    for args in (("lcg", 30, 1e-9, True, None, 0.5), ("lcg", 5, 1e-12, True, None, init)):
        jres = jcrit.run_method(*args, solver_loop=loop)
        res = crit.run_method(*args, solver_loop=loop)
        _same(res, jres)
        assert len(res.crit_val) == len(jres.crit_val)
        np.testing.assert_allclose(res.crit_val.astype(np.float32), jres.crit_val, rtol=1e-12, atol=0)
        assert rel(res.crit_val, jres.crit_val) <= 1e-7  # the reference's float32 rounding
    assert crit.L_crit_val == list(res.crit_val)


def test_joint_prior_matches_reference_difference_operator():
    from surfh_tpu.solvers.criterion import DifferenceOperatorJoint as JaxJoint
    from surfh_tpu_torch.solvers.criterion import DifferenceOperatorJoint

    x = np.random.default_rng(6).standard_normal(ISHAPE)
    jj = JaxJoint(ISHAPE[1:], jnp.float64)
    tj = DifferenceOperatorJoint(ISHAPE[1:], torch.float64, "cpu")
    assert np.abs(tj.d_freq.numpy() - jj.d_freq).max() <= 1e-15 * np.abs(jj.d_freq).max()
    for op in ("D", "D_t", "DtD"):
        assert rel(getattr(tj, op)(torch.as_tensor(x)).numpy(), getattr(jj, op)(jnp.asarray(x))) <= 1e-12


def test_run_method_printing_and_positional_order(toy, capsys):
    crit = QuadCriterion_MRS(1.0, torch.as_tensor(toy.y), _TorchToy(toy.w), 0.1, True)
    # method, maximum_iterations, tolerance, calc_crit, perf_crit, value_init,
    # solver_state, return_state, solver_loop, solver_chain
    res = crit.run_method("lcg", 4, 1e-12, True, None, 0.25, None, True, "dispatch", 2)
    assert "Total time needed for lcg:" in capsys.readouterr().out
    assert res.n_iter == 4 and res.state is not None and len(res.crit_val) == 1
    again = crit.run_method("lcg", 4, 1e-12, False, None, 0.25, None, False, "graph", 1)
    assert torch.equal(again.x, res.x) and again.crit_val is None  # chained dispatch: same iterates


# ---------------------------------------------------------------------------
# SpectroSigRLSCT from the reference's positional argument list

RANK_KW = dict(im_size=41, n_lambda=120, n_tpl=2, n_channels=2, n_pointings=2, n_slit=3)
WPLANE_KW = dict(im_size=31, n_lambda=24, n_tpl=3, n_channels=2, n_pointings=2, n_slit=3)


DTYPE = object()  # where the dtype goes in a positional list


def _positional(s, mode):
    """The reference's order: sotf, templates, alpha_axis, beta_axis,
    wavelength_axis, instrs, step_degree, pointings, dtype, gridding,
    wblur_impl, wblur_band_rtol, window_local, conv_impl, conv_freq_rtol,
    psf_stack, conv_precision, conv_rank_rtol."""
    head = [s["templates"], s["alpha_axis"], s["beta_axis"], s["wavelength_axis"], s["instrs"],
            s["step_degree"], s["pointings"]]
    if mode == "rank":
        return [None, *head, DTYPE, "bilinear", "dense", 0.0, True, "matmul", 1e-6, s["spsf"],
                "highest", 1e-7]
    return [s["sotf"], *head, DTYPE]


@pytest.mark.parametrize("mode, torch_dtype", [("rank", False), ("wplane", True)])
def test_spectro_positional_construction_matches_reference(monkeypatch, mode, torch_dtype):
    """Forward and adjoint of the model built from one positional list (the
    dtype a NumPy or a torch one) against the reference built from it."""
    monkeypatch.setenv("SURFH_TABLE_CACHE", "0")
    kw = RANK_KW if mode == "rank" else WPLANE_KW
    jsetup, psetup = jax_make_setup(**kw), make_setup(**kw)
    jargs = [jnp.float64 if a is DTYPE else a for a in _positional(jsetup, mode)]
    pargs = [(torch.float64 if torch_dtype else np.float64) if a is DTYPE else a
             for a in _positional(psetup, mode)]
    jm = JaxSpectro(*jargs)
    pm = SpectroSigRLSCT(*pargs).to("cpu", torch.float64)
    assert pm.window_local == (mode == "rank") and pm.npdtype == np.float64
    assert pm.conv_impl == ("matmul" if mode == "rank" else "fft")
    x = np.array(jsetup["maps"])
    yr = np.random.default_rng(3).standard_normal(jm.oshape)
    if mode == "rank":
        tables = jm.device_tables()
        want_f = jax.jit(jm._forward_fn_tabled)(jnp.asarray(x), tables)
        want_a = jax.jit(jm._adjoint_fn_tabled)(jnp.asarray(yr), tables)
    else:
        want_f, want_a = jm.forward(x), jm.adjoint(yr)
    assert rel(pm.forward(torch.as_tensor(x)).numpy(), want_f) <= 1e-12
    assert rel(pm.adjoint(torch.as_tensor(yr)).numpy(), want_a) <= 1e-12


def test_banded_window_local_warns_and_runs_dense(monkeypatch):
    """The reference warns and runs the dense blur; so does the port, with
    the reference's text, and its model is the dense one."""
    monkeypatch.setenv("SURFH_TABLE_CACHE", "0")
    jsetup, psetup = jax_make_setup(**RANK_KW), make_setup(**RANK_KW)

    def banded(s):
        a = _positional(s, "rank")
        a[10] = "banded"
        return a

    with pytest.warns(UserWarning) as jw:
        JaxSpectro(*[jnp.float64 if a is DTYPE else a for a in banded(jsetup)])
    with pytest.warns(UserWarning) as pw:
        pm = SpectroSigRLSCT(*[np.float64 if a is DTYPE else a for a in banded(psetup)])
    assert [str(w.message) for w in pw] == [str(w.message) for w in jw]
    assert pm.wblur_impl == "dense"
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        dense = SpectroSigRLSCT(*[np.float64 if a is DTYPE else a for a in _positional(psetup, "rank")])
    pm.to("cpu", torch.float64)
    dense.to("cpu", torch.float64)
    x = torch.as_tensor(psetup["maps"])
    assert torch.equal(pm.forward(x), dense.forward(x))
    assert torch.equal(pm.normal(x), dense.normal(x))


@pytest.mark.parametrize("mode", ["rank", "wplane"])
def test_spectro_gridding_nn_matches_reference(monkeypatch, mode):
    """``gridding="nn"`` by keyword beside the reference's positional list
    (once NotImplementedError, ROADMAP A9): the port's model against the
    reference's, forward and adjoint ≤1e-12 relative."""
    monkeypatch.setenv("SURFH_TABLE_CACHE", "0")
    kw = RANK_KW if mode == "rank" else WPLANE_KW
    jsetup, psetup = jax_make_setup(**kw), make_setup(**kw)
    names = ["sotf", "templates", "alpha_axis", "beta_axis", "wavelength_axis", "instrs",
             "step_degree", "pointings", "dtype", "gridding", "wblur_impl", "wblur_band_rtol",
             "window_local", "conv_impl", "conv_freq_rtol", "psf_stack", "conv_precision",
             "conv_rank_rtol"]
    jm = JaxSpectro(**dict(zip(names, _positional(jsetup, mode)), dtype=jnp.float64, gridding="nn"))
    pm = SpectroSigRLSCT(**dict(zip(names, _positional(psetup, mode)), dtype=np.float64,
                                gridding="nn")).to("cpu", torch.float64)
    assert pm.gridding == "nn" and all(c.gridding == "nn" for c in pm.channels)
    x = np.array(jsetup["maps"])
    yr = np.random.default_rng(3).standard_normal(jm.oshape)
    if mode == "rank":
        tables = jm.device_tables()
        want_f = jax.jit(jm._forward_fn_tabled)(jnp.asarray(x), tables)
        want_a = jax.jit(jm._adjoint_fn_tabled)(jnp.asarray(yr), tables)
    else:
        want_f, want_a = jm.forward(x), jm.adjoint(yr)
    assert rel(pm.forward(torch.as_tensor(x)).numpy(), want_f) <= 1e-12
    assert rel(pm.adjoint(torch.as_tensor(yr)).numpy(), want_a) <= 1e-12


# what is not ported: (positional list, its changes, ROADMAP item)
NOT_PORTED = {
    "conv_precision_high": ("rank", lambda s: dict(conv_precision="high"), "Do not port"),
    "conv_precision_default": ("wplane", lambda s: dict(conv_precision="default"), "Do not port"),
}


@pytest.mark.parametrize("case", list(NOT_PORTED))
def test_spectro_not_ported_raises(case):
    mode, change, item = NOT_PORTED[case]
    s = make_setup(**WPLANE_KW)
    names = ["sotf", "templates", "alpha_axis", "beta_axis", "wavelength_axis", "instrs",
             "step_degree", "pointings", "dtype", "gridding", "wblur_impl", "wblur_band_rtol",
             "window_local", "conv_impl", "conv_freq_rtol", "psf_stack", "conv_precision",
             "conv_rank_rtol"]
    kw = dict(zip(names, _positional(s, mode)), dtype=np.float64)
    kw.update(change(s))
    with pytest.raises(NotImplementedError, match=item):
        SpectroSigRLSCT(**kw)


@pytest.mark.parametrize("case, item", [("use_fwadj", "define fwadj")])
def test_criterion_not_ported_raises(toy, case, item):
    """What the criterion refuses, as the reference does: `use_fwadj` on a
    model without `fwadj` (ValueError), an unknown prior, an unknown method."""
    model = _TorchToy(toy.w)
    with pytest.raises(ValueError, match=item):
        QuadCriterion_MRS(1.0, torch.as_tensor(toy.y), model, 0.1, False, "separated", True)
    with pytest.raises(ValueError, match="gradient"):
        QuadCriterion_MRS(1.0, torch.as_tensor(toy.y), model, 0.1, gradient="laplace")
    with pytest.raises(ValueError, match="method"):
        QuadCriterion_MRS(1.0, torch.as_tensor(toy.y), model, 0.1).run_method("cg")
