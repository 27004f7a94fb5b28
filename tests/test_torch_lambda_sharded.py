"""surfh_tpu_torch's λ-sharded channel (`parallel.lambda_sharded`) against
the JAX reference's `LambdaShardedChannel` (CPU, float64, gloo in spawned
processes; the JAX side on the virtual CPU devices of tests/conftest.py),
at worlds 1, 2 and 3 on the channel of tests/test_lambda_sharded.py:

* the forward (the same on every rank) against the JAX class on a mesh of
  as many devices and against the unsharded channel, ≤1e-12 relative;
* the ranks' adjoint blocks, put together, against the JAX class's adjoint
  and the unsharded one, ≤1e-12;
* the all_reduce counts 1 (forward) / 0 (adjoint);
* the dot test ≤1e-12; `shard_cube`'s blocks.
"""

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch_dist_workers as W

from surfh_tpu.parallel.fusion import make_mesh as jax_make_mesh
from surfh_tpu.parallel.lambda_sharded import LambdaShardedChannel as JaxLambda
from surfh_tpu.simulation.synthetic import make_model as jax_make_model
from surfh_tpu_torch.parallel.fusion import spawn_world

TOL = 1e-12
L = W.LAMBDA_KW["n_lambda"]


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.fixture(scope="module")
def jax_chan():
    model, _ = jax_make_model(dtype=jnp.float64, **W.LAMBDA_KW)
    rng = np.random.default_rng(0)
    cube = rng.standard_normal(model.cube_shape)
    yr = rng.standard_normal(model.channels[0].oshape)
    return model.channels[0], cube, yr


@pytest.fixture(scope="module", params=[1, 2, 3], ids=lambda w: f"world{w}")
def lam(request, jax_chan):
    world = request.param
    chan, cube, yr = jax_chan
    ranks = spawn_world(W.lambda_worker, world, (cube, yr))
    jsh = JaxLambda(chan, n_lambda=L, mesh=jax_make_mesh(world, axis_name="lam"))
    want = {"forward": np.asarray(jsh.forward(jsh.shard_cube(cube))),
            "adjoint": np.asarray(jsh.adjoint(yr))[:L]}
    return SimpleNamespace(world=world, ranks=ranks, want=want, cube=cube)


def test_lambda_forward_matches_jax_and_unsharded(lam):
    for r in lam.ranks:
        assert rel(r["forward"], lam.want["forward"]) <= TOL
        assert rel(r["forward"], r["un_forward"]) <= TOL


def test_lambda_adjoint_blocks_match_jax_and_unsharded(lam):
    got = np.concatenate([r["adjoint_block"] for r in lam.ranks])[:L]
    assert got.shape == lam.want["adjoint"].shape
    assert rel(got, lam.want["adjoint"]) <= TOL
    assert rel(got, lam.ranks[0]["un_adjoint"]) <= TOL


def test_lambda_collective_counts(lam):
    for r in lam.ranks:
        assert (r["count_forward"], r["count_adjoint"]) == (1, 0)


def test_lambda_dot_test(lam):
    lhs = lam.ranks[0]["lhs"]
    rhs = sum(r["rhs_part"] for r in lam.ranks)
    assert abs(lhs - rhs) / abs(lhs) <= TOL


def test_lambda_shard_cube_blocks(lam):
    lp = lam.ranks[0]["Lp"]
    assert lp == -(-L // lam.world)
    got = np.concatenate([r["shard"] for r in lam.ranks])
    np.testing.assert_array_equal(got[:L], lam.cube)
    assert not got[L:].any()
