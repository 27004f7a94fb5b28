"""The port's MM memory-gradient solver `mmmg` against the reference's
(`surfh_tpu/solvers/cg.py::mmmg`), CPU, float64 unless a test says
otherwise, inputs from numpy seeds.

* on a small SPD system applied elementwise (the same operator bit for bit
  in both packages, as tests/test_torch_solver_api.py's `lcg` cases), in
  the graph and the dispatch loop: `x` and `grad_norm` ≤1e-12 relative,
  `n_iter` and `converged` equal — a solve that stops mid-way, one that
  runs out, one that crosses the tolerance between two dispatch checks
  (dispatch runs on to the next multiple of 25, as the reference does) and
  one that crosses it on its last iteration; the callback, `op_args` in
  the reference's positional order, Gram determinants below the guard (the
  steepest-descent fallback), an unknown loop refused;
* the reference's own properties (tests/test_solvers.py): it solves a
  dense SPD system (rtol 1e-5 against `np.linalg.solve`), it gives `lcg`'s
  iterates in exact arithmetic (f64: ≤1e-9 after 10 iterations) and its
  criterion value on a fusion model (rtol 0.25 after 40, as the
  reference's), and the dispatch loop's iterate is the graph loop's, here
  bit for bit;
* `QuadCriterion_MRS.run_method("mmmg")` on a small float64 W-plane
  `SpectroSigRLSCT` against the reference's, both loops: x ≤1e-12 after 6
  iterations.  6, because this fixture's gradient norm falls from 1e4 to
  62 in those and to 1.5 in the next two, which amplify the two packages'
  last-bit operator differences to 1e-7 (`lcg` alike: 5e-14 at 6, 4e-7
  at 8), as the real-data fixture of tests/test_torch_pipeline.py does
  past 8.
"""

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from surfh_tpu.simulation.synthetic import make_model as jax_make_model
from surfh_tpu.solvers import cg as jcg
from surfh_tpu.solvers.criterion import QuadCriterion_MRS as JaxCriterion
from surfh_tpu_torch.simulation.synthetic import make_model
from surfh_tpu_torch.solvers import cg
from surfh_tpu_torch.solvers.criterion import QuadCriterion_MRS

torch.set_num_threads(2)

N = 400  # unknowns of the SPD system
EPS = 2e-3  # its smallest eigenvalue's scale: condition ~2e3
TOL_F64 = 1e-12  # elementwise operator: the same bits in both packages
TOL_MODEL = 1e-12  # fusion model, before the solve amplifies rounding (see above)


def rel(a, b) -> float:
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.fixture(scope="module")
def spd():
    """Q x = d·x − (x[i−1] + x[i+1]) with d_i ∈ [2 + EPS, 3): SPD."""
    rng = np.random.default_rng(11)
    d = 2.0 + EPS + rng.random(N)
    b = rng.standard_normal(N)
    jd, td = jnp.asarray(d), torch.as_tensor(d)

    def jop(x):
        return jd * x - (jnp.roll(x, 1) + jnp.roll(x, -1))

    def top(x):
        return td * x - (torch.roll(x, 1) + torch.roll(x, -1))

    full = jcg.mmmg(jop, b, np.zeros(N), max_iter=80, tol=0.0)
    return SimpleNamespace(b=b, jop=jop, top=top, hist=np.asarray(full.grad_norm),
                           bnorm=float(np.linalg.norm(b)))


def _tol_crossing_at(s, k: int) -> float:
    """A tolerance that ‖g‖ first meets after iteration k."""
    h = s.hist / s.bnorm
    assert np.all(h[:k] > h[k])
    return float(np.sqrt(h[k] * h[:k].min()))


def _port(s, **kw):
    return cg.mmmg(s.top, torch.as_tensor(s.b), torch.zeros(N, dtype=torch.float64), **kw)


def _same(res, jres, tol=TOL_F64):
    assert res.n_iter == jres.n_iter
    assert res.converged == jres.converged
    assert res.grad_norm.shape == np.shape(jres.grad_norm)
    np.testing.assert_allclose(res.grad_norm, jres.grad_norm, rtol=tol, atol=0)
    assert rel(res.x, jres.x) <= tol


# case: (max_iter, crossing iteration or None, graph n_iter / converged, dispatch n_iter / converged)
CASES = {
    "stops_mid_way": (60, 12, (12, True), (25, True)),
    "crosses_on_the_last_iteration": (20, 20, (20, False), (20, True)),
    "crosses_between_two_checks": (70, 30, (30, True), (50, True)),
    "runs_out": (15, None, (15, False), (15, False)),
}


@pytest.mark.parametrize("loop", ["graph", "dispatch"])
@pytest.mark.parametrize("case", list(CASES))
def test_mmmg_matches_reference(spd, case, loop):
    max_iter, k, graph, dispatch = CASES[case]
    tol = 1e-30 if k is None else _tol_crossing_at(spd, k)
    jres = jcg.mmmg(spd.jop, spd.b, np.zeros(N), max_iter=max_iter, tol=tol, loop=loop)
    res = _port(spd, max_iter=max_iter, tol=tol, loop=loop)
    _same(res, jres)
    assert (res.n_iter, res.converged) == (graph if loop == "graph" else dispatch)
    assert res.state is None  # the exact-resume state is lcg's alone, as in the reference


@pytest.mark.parametrize("loop", ["graph", "dispatch"])
def test_mmmg_positional_call_and_callback(spd, loop):
    """normal_op, b, x0, max_iter, tol, callback, op_args, loop — op_args
    reach the operator; the callback is called once, with the result."""
    tol = _tol_crossing_at(spd, 9)
    calls = []
    jres = jcg.mmmg(lambda x, s: s * spd.jop(x), spd.b, np.zeros(N), 40, tol, calls.append,
                    (jnp.asarray(2.0),), loop)
    res = cg.mmmg(lambda x, s: s * spd.top(x), torch.as_tensor(spd.b),
                  torch.zeros(N, dtype=torch.float64), 40, tol, calls.append,
                  (torch.tensor(2.0, dtype=torch.float64),), loop)
    _same(res, jres)
    assert len(calls) == 2 and calls[1] is res


@pytest.mark.parametrize("loop", ["graph", "dispatch"])
def test_mmmg_tiny_gram_takes_steepest_descent(spd, loop):
    """With b scaled by 1e-10 every 2×2 Gram determinant is below the
    reference's 1e-30 guard, so each step is the exact steepest-descent
    step, in both packages alike."""
    b = 1e-10 * spd.b
    jres = jcg.mmmg(spd.jop, b, np.zeros(N), max_iter=6, tol=0.0, loop=loop)
    res = cg.mmmg(spd.top, torch.as_tensor(b), torch.zeros(N, dtype=torch.float64),
                  max_iter=6, tol=0.0, loop=loop)
    _same(res, jres)
    x = torch.zeros(N, dtype=torch.float64)
    for _ in range(6):  # steepest descent with the exact line search
        g = spd.top(x) - torch.as_tensor(b)
        x = x - torch.dot(g, g) / torch.dot(g, spd.top(g)) * g
    assert rel(res.x, x.numpy()) <= TOL_F64


def test_mmmg_refuses_an_unknown_loop(spd):
    with pytest.raises(ValueError, match="loop"):
        _port(spd, loop="while")


# ---------------------------------------------------------------------------
# the reference's own mmmg properties (tests/test_solvers.py)

def test_mmmg_solves():
    rng = np.random.default_rng(19940407)
    n = 24
    A = rng.standard_normal((n, n))
    Q = torch.as_tensor(A @ A.T + n * np.eye(n))
    b = rng.standard_normal(n)
    res = cg.mmmg(lambda x: Q @ x, torch.as_tensor(b), torch.zeros(n, dtype=torch.float64),
                  max_iter=300, tol=1e-12)
    np.testing.assert_allclose(res.x.numpy(), np.linalg.solve(Q.numpy(), b), rtol=1e-5)


def test_mmmg_gives_lcg_iterates_in_exact_arithmetic(spd):
    """Exact minimization over {−g, x − x_prev} on a quadratic is CG: in
    f64 the iterates agree to ≤1e-9 after 10 iterations."""
    b, x0 = torch.as_tensor(spd.b), torch.zeros(N, dtype=torch.float64)
    m = cg.mmmg(spd.top, b, x0, max_iter=10, tol=0.0)
    c = cg.lcg(spd.top, b, x0, max_iter=10, tol=0.0)
    assert rel(m.x, c.x.numpy()) <= 1e-9
    np.testing.assert_allclose(m.grad_norm, c.grad_norm, rtol=1e-9)


MODEL_KW = dict(im_size=31, n_lambda=16, n_tpl=3, n_channels=1, n_pointings=1, n_slit=3)


@pytest.fixture(scope="module")
def fusion():
    """The reference's small W-plane fusion problem (its dispatch tests' model)."""
    jm, jsetup = jax_make_model(**MODEL_KW, dtype=jnp.float64)
    pm, _ = make_model(**MODEL_KW, dtype=np.float64, window_local=False)
    pm.to("cpu", torch.float64)
    return SimpleNamespace(jm=jm, pm=pm, y=np.array(jm.forward(jsetup["maps"])))


def test_mmmg_agrees_with_lcg_on_a_fusion_model(fusion):
    """tests/test_solvers.py::TestCriterion3D: both fall below 1e-3·J₀ in 40
    iterations and agree within rtol 0.25."""
    crit = QuadCriterion_MRS(1.0, torch.as_tensor(fusion.y), fusion.pm, 1e-4)
    res_cg = crit.run_method("lcg", maximum_iterations=40)
    res_mm = crit.run_method("mmmg", maximum_iterations=40)
    j0 = crit.get_crit_val(torch.full(fusion.pm.ishape, 0.5, dtype=torch.float64))
    j_cg, j_mm = crit.get_crit_val(res_cg.x), crit.get_crit_val(res_mm.x)
    assert j_cg < 1e-3 * j0 and j_mm < 1e-3 * j0
    np.testing.assert_allclose(j_cg, j_mm, rtol=0.25)


def test_mmmg_dispatch_equals_graph(fusion):
    """tests/test_solvers.py::test_mmmg_dispatch_matches_graph: 25
    iterations each; the port's two loops run the same steps, so the
    iterate is the same bits (the reference: ≤1e-10), the norms agree to
    the dispatch loop's float32 history."""
    crit = QuadCriterion_MRS(1.0, torch.as_tensor(fusion.y), fusion.pm, 10.0)
    a = crit.run_method("mmmg", maximum_iterations=25)
    b = crit.run_method("mmmg", maximum_iterations=25, solver_loop="dispatch")
    assert a.n_iter == b.n_iter == 25
    assert torch.equal(a.x, b.x)
    np.testing.assert_allclose(a.grad_norm, b.grad_norm, rtol=1e-6)


@pytest.mark.parametrize("loop", ["graph", "dispatch"])
def test_run_method_mmmg_matches_reference(fusion, loop):
    jcrit = JaxCriterion(1.0, fusion.y, fusion.jm, 10.0)
    crit = QuadCriterion_MRS(1.0, torch.as_tensor(fusion.y), fusion.pm, 10.0)
    jres = jcrit.run_method("mmmg", maximum_iterations=6, solver_loop=loop)
    res = crit.run_method("mmmg", maximum_iterations=6, solver_loop=loop)
    assert res.n_iter == jres.n_iter == 6 and res.converged == jres.converged
    assert rel(res.x, jres.x) <= TOL_MODEL
    if loop == "graph":
        assert rel(res.grad_norm, jres.grad_norm) <= TOL_MODEL
    else:  # the dispatch loop's float32 history
        np.testing.assert_allclose(res.grad_norm, jres.grad_norm, rtol=1e-6)
    assert res.grad_norm[-1] < res.grad_norm[0]


class _JaxToy:
    """y = (w·x) flat: the same elementwise bits in both packages."""

    def __init__(self, w):
        self.w = jnp.asarray(w)
        self.ishape, self.oshape, self.dtype = w.shape, (w.size,), jnp.float64

    def forward_fn(self, x):
        return (self.w * x).reshape(-1)

    def adjoint_fn(self, y):
        return self.w * y.reshape(self.ishape)


class _TorchToy:
    def __init__(self, w):
        self.w = torch.as_tensor(w)
        self.ishape, self.device, self.dtype = w.shape, torch.device("cpu"), torch.float64

    def forward(self, x):
        return (self.w * x.reshape(self.ishape)).reshape(-1)

    def adjoint(self, y):
        return self.w * y.reshape(self.ishape)

    def normal(self, x):
        return self.adjoint(self.forward(x))


@pytest.mark.parametrize("loop", ["graph", "dispatch"])
@pytest.mark.parametrize("gradient", ["separated", "joint"])
def test_run_method_mmmg_on_an_elementwise_model(gradient, loop):
    """µ_s = 2, µ_r = 0.3, 30 iterations at tolerance 1e-9 with
    `calc_crit` and a `perf_crit` (read by neither package): x, grad_norm,
    n_iter, converged ≤1e-12, crit_val to the reference's float32 rounding."""
    rng = np.random.default_rng(21)
    shape = (2, 12, 10)
    w = rng.uniform(0.2, 1.0, shape) * (rng.random(shape) < 0.7)
    y = (w * rng.standard_normal(shape)).reshape(-1)
    jcrit = JaxCriterion(2.0, y, _JaxToy(w), 0.3, False, gradient)
    crit = QuadCriterion_MRS(2.0, torch.as_tensor(y), _TorchToy(w), 0.3, False, gradient)
    args = ("mmmg", 30, 1e-9, True, lambda x: 0.0, 0.5)
    jres = jcrit.run_method(*args, solver_loop=loop)
    res = crit.run_method(*args, solver_loop=loop)
    _same(res, jres)
    assert rel(res.crit_val, jres.crit_val) <= 1e-7
    assert res.grad_norm[-1] < 1e-3 * res.grad_norm[0]
