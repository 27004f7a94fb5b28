"""surfh_tpu_torch's operator base and the differentiable row gather against
the JAX package (CPU, float64).

* `LinOp` / `FuncLinOp` / `dottest`: the same linear function (a matrix, a
  circular roll, an ortho rfft2 · H · irfft2 conv) in both packages —
  forward and derived adjoint ≤1e-12 relative, `dottest` at 1e-12 true in
  both and false in both for a wrong adjoint; the one `vjp_fn` taken at a
  zero primal serves repeated cotangents, bit for bit a fresh one;
* `gather_rows_op`: its backward is the gather on the transposed plan
  (`RowGatherPlan.t`, the same taps as the host CSR transpose), and
  `torch.autograd.gradcheck` / `gradgradcheck` pass in float64;
* the plan gathers on tensors (`apply_plan`, `scatter_plan`,
  `apply_transpose_plan` in both transpose forms) against the reference's,
  and the host transpose plans bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from surfh_tpu.core import bilinear as jbil
from surfh_tpu.core import linop as jlin
from surfh_tpu_torch.core import bilinear, linop
from surfh_tpu_torch.core.gather_rows import (RowGatherPlan, build_row_gather_plan, gather_rows_op,
                                              gather_rows_reference, plan_from_gather_table)

torch.set_num_threads(2)

N_A, N_B, M = 9, 8, 40


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.fixture(scope="module")
def op_pair():
    rng = np.random.default_rng(3)
    mat = rng.standard_normal((M, N_A * N_B))
    h = np.fft.rfftn(rng.standard_normal((N_A, N_B)), norm="ortho")

    def jfwd(x):
        conv = jnp.fft.irfftn(jnp.fft.rfftn(x, norm="ortho") * h, s=(N_A, N_B), norm="ortho")
        return jnp.concatenate([jnp.asarray(mat) @ jnp.roll(x, 2, axis=1).ravel(), conv.ravel()])

    th, tmat = torch.as_tensor(h), torch.as_tensor(mat)

    def pfwd(x):
        conv = torch.fft.irfftn(torch.fft.rfftn(x, norm="ortho") * th, s=(N_A, N_B), norm="ortho")
        return torch.cat([tmat @ torch.roll(x, 2, dims=1).reshape(-1), conv.reshape(-1)])

    oshape = (M + N_A * N_B,)
    jop = jlin.FuncLinOp(jfwd, (N_A, N_B), oshape, dtype=jnp.float64)
    pop = linop.FuncLinOp(pfwd, (N_A, N_B), oshape, dtype=torch.float64, device="cpu")
    return jop, pop, rng


def test_funclinop_forward_and_adjoint(op_pair):
    jop, pop, rng = op_pair
    x, y = rng.standard_normal(jop.ishape), rng.standard_normal(jop.oshape)
    assert rel(pop.forward(x), jop.forward(x)) <= 1e-12
    assert rel(pop.adjoint(y), jop.adjoint(y)) <= 1e-12
    assert rel(pop.normal(x), jop.fwadj(x)) <= 1e-12
    assert rel(pop.matvec(x.ravel()), jop.matvec(x.ravel())) <= 1e-12
    assert rel(pop.rmatvec(y), jop.rmatvec(y)) <= 1e-12
    assert (pop.isize, pop.osize) == (jop.isize, jop.osize)
    assert pop(x).shape == pop.oshape and pop.device.type == "cpu"


def test_dottest_agrees(op_pair):
    jop, pop, _ = op_pair
    assert jlin.dottest(jop, num=3, rtol=1e-12) and linop.dottest(pop, num=3, rtol=1e-12)

    class Wrong(linop.FuncLinOp):
        def adjoint(self, y):
            return 1.001 * super().adjoint(y)

    wrong = Wrong(pop._fwd, pop.ishape, pop.oshape, torch.float64, device="cpu")
    jwrong = jlin.FuncLinOp(jop._fwd, jop.ishape, jop.oshape, jnp.float64)
    jwrong.adjoint = lambda y: 1.001 * jlin.FuncLinOp.adjoint(jwrong, y)
    assert not linop.dottest(wrong, num=2, rtol=1e-6)
    assert not jlin.dottest(jwrong, num=2, rtol=1e-6)


def test_derived_adjoint_reuses_one_vjp(op_pair):
    jop, pop, rng = op_pair
    fresh = linop.FuncLinOp(pop._fwd, pop.ishape, pop.oshape, torch.float64, device="cpu")
    ys = [rng.standard_normal(pop.oshape) for _ in range(3)]
    first = [pop.adjoint(y) for y in ys]
    assert len(pop._vjp_fns) == 1
    again = [pop.adjoint(y) for y in ys]
    for a, b, y in zip(first, again, ys):
        assert torch.equal(a, b)
        assert torch.equal(a, fresh.adjoint(y))
        fresh._vjp_fns.clear()


def test_linop_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        linop.FuncLinOp(lambda x: x, (2,), (2,))
    assert linop.LinOp((2,), (3,), np.float32, device="cpu").dtype == torch.float32


@pytest.fixture(scope="module")
def plan():
    rng = np.random.default_rng(5)
    idx = rng.integers(0, 30, (4, 17))
    w = rng.standard_normal((4, 17))
    w[1, 3] = 0.0
    return idx, w


def test_gather_backward_is_the_transposed_plan(plan):
    idx, w = plan
    hp = plan_from_gather_table(idx, w, 30)
    p = hp.to("cpu", torch.float64)
    rng = np.random.default_rng(0)
    src = torch.as_tensor(rng.standard_normal((30, 3)), dtype=torch.float64).requires_grad_()
    g = torch.as_tensor(rng.standard_normal((17, 3)))
    (grad,) = torch.autograd.grad(gather_rows_op(src, p), src, g)
    assert torch.equal(grad, gather_rows_reference(g, p.t))
    want = build_row_gather_plan(hp.dst, hp.w, hp.idx, 30, 17)
    for f in ("row_ptr", "idx", "w", "dst"):
        np.testing.assert_array_equal(getattr(p.t, f).numpy(), getattr(want, f))
        np.testing.assert_array_equal(getattr(hp.t, f), getattr(want, f))
    assert p.t is p.t and isinstance(p.t, RowGatherPlan) and p.t.n_src == 17
    dense = np.zeros((17, 30))
    np.add.at(dense, (np.tile(np.arange(17), 4), idx.reshape(-1)), w.reshape(-1))
    np.testing.assert_allclose(grad.numpy(), dense.T @ g.numpy(), rtol=1e-13, atol=1e-13)


def test_gather_gradcheck(plan):
    idx, w = plan
    p = plan_from_gather_table(idx, w, 30).to("cpu", torch.float64)
    src = torch.randn(30, 2, dtype=torch.float64, requires_grad=True)
    assert torch.autograd.gradcheck(lambda s: gather_rows_op(s, p), (src,))
    assert torch.autograd.gradgradcheck(lambda s: gather_rows_op(s, p), (src,))


@pytest.fixture(scope="module")
def bplan():
    rng = np.random.default_rng(11)
    a = np.linspace(-1, 1, 9)
    b = np.linspace(-1, 1, 7)
    pts = np.stack([rng.uniform(-1.2, 1.2, 50), rng.uniform(-1.2, 1.2, 50)], axis=1)
    return (jbil.bilinear_plan(a, b, pts, fill_out_of_bounds=True),
            bilinear.bilinear_plan(a, b, pts, fill_out_of_bounds=True))


def test_host_transpose_plans_match(bplan):
    jp, pp = bplan
    for jt, pt in ((jbil.transpose_plan(jp), bilinear.transpose_plan(pp)),
                   (jbil.csr_transpose_plan(jp), bilinear.csr_transpose_plan(pp))):
        for f in ("idx", "w", "src", "dst"):
            if hasattr(jt, f):
                np.testing.assert_array_equal(getattr(pt, f), getattr(jt, f))
        assert tuple(pt.shape) == tuple(jt.shape)


def test_plan_gathers_match_the_reference(bplan):
    jp, pp = bplan
    rng = np.random.default_rng(1)
    cube = rng.standard_normal((3, 9, 7))
    vals = rng.standard_normal((3, 50))
    got = bilinear.apply_plan(pp.idx, pp.w, torch.as_tensor(cube))
    assert rel(got, jbil.apply_plan(jp.idx, jp.w, jnp.asarray(cube))) <= 1e-12
    want_t = jbil.scatter_plan(jp.idx, jp.w, jnp.asarray(vals), (9, 7))
    assert rel(bilinear.scatter_plan(pp.idx, pp.w, torch.as_tensor(vals), (9, 7)), want_t) <= 1e-12
    for tp in (bilinear.transpose_plan(pp), bilinear.csr_transpose_plan(pp)):
        assert rel(bilinear.apply_transpose_plan(tp, torch.as_tensor(vals)), want_t) <= 1e-12
    lhs = float((got * torch.as_tensor(vals)).sum())
    rhs = float((torch.as_tensor(cube) * bilinear.scatter_plan(pp.idx, pp.w, torch.as_tensor(vals),
                                                               (9, 7))).sum())
    assert abs(lhs - rhs) <= 1e-12 * abs(lhs)
