"""The CSR row gather (`surfh_tpu_torch.core.gather_rows`) against the
reference's row-gather Pallas kernel and composed gather / transpose.

* the host prep equals `scatter_pallas.build_row_gather_plan`'s (same taps
  per row, same order);
* the plain version against `gather_rows_pallas(interpret=True)` and the
  reference's NumPy oracle (f32: ≤2e-6 of the output scale, a few dozen
  taps summed in another order) on random COO plans and on a real
  composed plan, both directions;
* a row with thousands of taps (the border-clamping case of small sky
  grids) against the reference's COO transpose (f64 ≤1e-13) and NumPy
  oracle — not through Pallas interpret mode, whose fixed fan-in L unrolls
  into thousands of traced ops (about a minute of CPU per call);
* against `bilinear.apply_composed_plan` / `apply_composed_plan_t` on a
  real channel's plans in f64 (≤1e-13: same taps, another summation order);
* the dispatch rule (the kernel itself: test_torch_kernels_cuda.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from surfh_tpu.core import bilinear as jbilinear
from surfh_tpu.core import scatter_pallas
from surfh_tpu.simulation.synthetic import make_model as jax_make_model
from surfh_tpu_torch.core import bilinear
from surfh_tpu_torch.core import gather_rows as gr
from surfh_tpu_torch.models.channel import gather_plans_from_composed

torch.set_num_threads(2)


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


def random_coo(rng, n_dst, n_src, n_taps, heavy_row=None, heavy_taps=0):
    cdst = rng.integers(0, n_dst, n_taps)
    if heavy_row is not None:
        cdst = np.concatenate([cdst, np.full(heavy_taps, heavy_row)])
    cdst = np.sort(cdst, kind="stable")
    csrc = rng.integers(0, n_src, cdst.size)
    cw = rng.standard_normal(cdst.size)
    cw[rng.random(cdst.size) < 0.05] = 0.0  # exercise the zero-tap filter
    return csrc, cw, cdst


@pytest.fixture(scope="module")
def real_plans():
    """One reference channel's composed gather + transpose, one pointing."""
    model, _ = jax_make_model(im_size=41, n_lambda=24, n_tpl=3, n_channels=1,
                              n_pointings=1, n_slit=4, dtype=jnp.float64)
    chan = model.channels[0]
    stack = tuple(np.asarray(a) for a in chan._composed_stack)
    n_patch = chan._tbbox[2] * chan._tbbox[3]
    n_out = stack[0].shape[2]
    fwd, adj = gather_plans_from_composed(stack, n_patch, n_out)
    return dict(stack=stack, n_patch=n_patch, n_out=n_out, fwd=fwd[0], adj=adj[0])


def test_plan_taps_match_reference_prep():
    rng = np.random.default_rng(0)
    n_dst, n_src = 300, 120
    csrc, cw, cdst = random_coo(rng, n_dst, n_src, 1500)
    plan = gr.build_row_gather_plan(csrc, cw, cdst, n_dst, n_src)
    ref = scatter_pallas.build_row_gather_plan(csrc, cw, cdst, n_dst, n_src, 8)
    tsrc = ref.tsrc.T[:n_dst] // ref.SUB
    tw = ref.tw.T[:n_dst]
    counts = np.diff(plan.row_ptr)
    assert plan.nnz == int((cw != 0).sum())
    for r in range(n_dst):
        k0, k1 = plan.row_ptr[r], plan.row_ptr[r + 1]
        np.testing.assert_array_equal(plan.idx[k0:k1], tsrc[r, : counts[r]])
        np.testing.assert_array_equal(plan.w[k0:k1].astype(np.float32), tw[r, : counts[r]])
        np.testing.assert_array_equal(plan.dst[k0:k1], r)
        assert not tw[r, counts[r]:].any()


@pytest.mark.parametrize("width", [20, 33])
def test_random_plan_matches_pallas_interpret(width):
    rng = np.random.default_rng(1)
    n_dst, n_src = 700, 300
    csrc, cw, cdst = random_coo(rng, n_dst, n_src, 2500)
    plan = gr.build_row_gather_plan(csrc, cw, cdst, n_dst, n_src)
    vals = rng.standard_normal((n_src, width)).astype(np.float32)
    jplan = scatter_pallas.build_row_gather_plan(csrc, cw, cdst, n_dst, n_src, width,
                                                 tp=128, unroll=4)
    want = np.asarray(scatter_pallas.gather_rows_pallas(jnp.asarray(vals), jplan, interpret=True))
    oracle = scatter_pallas.gather_rows_reference(vals, jplan)
    got = gr.gather_rows_reference(torch.as_tensor(vals), plan.to("cpu", torch.float32))
    assert got.shape == (n_dst, width)
    assert rel(got, want) <= 2e-6
    assert rel(got, oracle) <= 2e-6


def test_row_with_thousands_of_taps():
    rng = np.random.default_rng(2)
    n_dst, n_src, width = 150, 400, 12
    csrc, cw, cdst = random_coo(rng, n_dst, n_src, 900, heavy_row=7, heavy_taps=3000)
    plan = gr.build_row_gather_plan(csrc, cw, cdst, n_dst, n_src)
    assert np.diff(plan.row_ptr).max() > 2500
    vals = rng.standard_normal((width, n_src))
    want = np.asarray(jbilinear.apply_composed_plan_t(
        jnp.asarray(csrc.astype(np.int32)), jnp.asarray(cw), jnp.asarray(cdst.astype(np.int32)),
        jnp.asarray(vals), n_dst))  # [width, n_dst]
    got = gr.gather_rows(torch.as_tensor(vals.T.copy()), plan.to("cpu", torch.float64))
    assert rel(got.numpy().T, want) <= 1e-13
    jplan = scatter_pallas.build_row_gather_plan(csrc, cw, cdst, n_dst, n_src, width)
    oracle = scatter_pallas.gather_rows_reference(vals.T, jplan)  # f32 output
    assert rel(got.numpy(), oracle) <= 1e-6


@pytest.mark.parametrize("direction", ["forward", "transpose"])
def test_real_composed_plan_matches_reference(real_plans, direction):
    rng = np.random.default_rng(3)
    q = 10
    idx, w, csrc, cw, cdst = real_plans["stack"]
    if direction == "forward":
        vals = rng.standard_normal((q, real_plans["n_patch"]))
        want = np.asarray(jbilinear.apply_composed_plan(idx[0], w[0], jnp.asarray(vals)))
        plain = bilinear.apply_composed_plan(torch.as_tensor(idx[0]), torch.as_tensor(w[0]),
                                             torch.as_tensor(vals))
        plan = real_plans["fwd"]
    else:
        vals = rng.standard_normal((q, real_plans["n_out"]))
        want = np.asarray(jbilinear.apply_composed_plan_t(
            csrc[0], cw[0], cdst[0], jnp.asarray(vals), real_plans["n_patch"]))
        plain = bilinear.apply_composed_plan_t(
            torch.as_tensor(csrc[0]), torch.as_tensor(cw[0]), torch.as_tensor(cdst[0]),
            torch.as_tensor(vals), real_plans["n_patch"])
        plan = real_plans["adj"]
    got = gr.gather_rows(torch.as_tensor(vals.T.copy()), plan.to("cpu", torch.float64))
    assert rel(got.numpy().T, want) <= 1e-13
    assert rel(plain.numpy(), want) <= 1e-13


@pytest.mark.parametrize("direction", ["forward", "transpose"])
def test_real_composed_plan_matches_pallas_interpret(real_plans, direction):
    rng = np.random.default_rng(4)
    idx, w, csrc, cw, cdst = real_plans["stack"]
    n_patch, n_out = real_plans["n_patch"], real_plans["n_out"]
    if direction == "forward":
        c = idx.shape[1]
        coo = (idx[0].reshape(-1), w[0].reshape(-1), np.tile(np.arange(n_out), c))
        n_dst, n_src, plan = n_out, n_patch, real_plans["fwd"]
    else:
        coo = (csrc[0], cw[0], cdst[0])
        n_dst, n_src, plan = n_patch, n_out, real_plans["adj"]
    vals = rng.standard_normal((n_src, 16)).astype(np.float32)
    jplan = scatter_pallas.build_row_gather_plan(*coo, n_dst, n_src, 16, tp=256)
    want = np.asarray(scatter_pallas.gather_rows_pallas(jnp.asarray(vals), jplan, interpret=True))
    got = gr.gather_rows_reference(torch.as_tensor(vals), plan.to("cpu", torch.float32))
    assert rel(got, want) <= 2e-6


def test_cpu_dispatch_takes_the_plain_version():
    rng = np.random.default_rng(5)
    plan = gr.build_row_gather_plan(*random_coo(rng, 50, 40, 200), 50, 40).to("cpu", torch.float64)
    src = torch.as_tensor(rng.standard_normal((40, 6)))
    before = gr.launches
    assert torch.equal(gr.gather_rows(src, plan), gr.gather_rows_reference(src, plan))
    assert gr.launches == before
    with pytest.raises(ValueError, match="CUDA"):
        gr.gather_rows_cuda(src, plan)

