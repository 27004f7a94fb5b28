"""surfh_tpu_torch's 2-D (channel × λ) sharding (`parallel.mesh2d`) against
the JAX reference's `ShardedSpectro2D` (CPU, float64, gloo in spawned
processes; the JAX side on the virtual CPU devices of tests/conftest.py),
on the meshes 2 × 2, 2 × 1 and 1 × 2:

* the W-plane model of tests/test_mesh2d.py: the forward's blocks put
  together into the flat layout and the normal of every rank against the
  JAX class on the same mesh, ≤1e-12 relative; the all_reduce counts 1
  (forward) / 2 (normal); the dispatch resume bit for bit; every rank's
  normal bit for bit rank 0's;
* the window-local λ-rank model, whose rank-basis columns split over
  "lam" by template maps (the JAX class takes only the W-plane model):
  the forward and the normal against the unsharded model, ≤1e-12.
"""

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch_dist_workers as W

from surfh_tpu.parallel.mesh2d import ShardedSpectro2D as JaxSharded2D
from surfh_tpu.parallel.mesh2d import make_mesh_2d as jax_make_mesh_2d
from surfh_tpu.simulation.synthetic import make_model as jax_make_model
from surfh_tpu_torch.parallel.fusion import spawn_world

TOL = 1e-12
MESHES = [(2, 2), (2, 1), (1, 2)]


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


def flat_from_rows(ranks, idx, key, mine="mine"):
    """Every "chan" rank's rows → the flat data vector (round-robin slots)."""
    n_c = max(r["d"] for r in ranks) + 1
    flat = np.zeros(int(idx[-1]))
    for r in ranks:
        for s, c in enumerate(r[mine]):
            flat[idx[c] : idx[c + 1]] = r[key][s, : idx[c + 1] - idx[c]]
    assert all(c % n_c == r["d"] for r in ranks for c in r[mine])
    return flat


@pytest.fixture(scope="module")
def jax_model():
    return jax_make_model(dtype=jnp.float64, **W.MESH2D_KW)


@pytest.fixture(scope="module", params=MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def mesh2d(request, jax_model):
    n_c, n_l = request.param
    jm, setup = jax_model
    ranks = spawn_world(W.mesh2d_worker, n_c * n_l, (n_c, n_l))
    jsh = JaxSharded2D(jm, jax_make_mesh_2d(n_c, n_l))
    rows = np.asarray(jsh.forward(setup["maps"]))
    per = jsh.per_dev
    flat = np.zeros(int(jm._idx[-1]))
    for c in range(len(jm.channels)):
        d, s = c % n_c, c // n_c
        flat[jm._idx[c] : jm._idx[c + 1]] = rows[d * per + s, : jm._idx[c + 1] - jm._idx[c]]
    want = {"forward": flat, "normal": np.asarray(jsh.normal(setup["maps"])),
            "idx": np.asarray(jm._idx)}
    return SimpleNamespace(mesh=(n_c, n_l), ranks=ranks, want=want)


def test_mesh2d_forward_matches_jax(mesh2d):
    got = flat_from_rows(mesh2d.ranks, mesh2d.want["idx"], "rows")
    assert rel(got, mesh2d.want["forward"]) <= TOL
    n_c = mesh2d.mesh[0]
    for r in mesh2d.ranks:  # the lam ranks of one chan rank hold the same rows
        twin = next(q for q in mesh2d.ranks if q["d"] == r["d"])
        np.testing.assert_array_equal(r["rows"], twin["rows"])
    assert len({r["d"] for r in mesh2d.ranks}) == n_c


def test_mesh2d_normal_matches_jax(mesh2d):
    for r in mesh2d.ranks:
        assert rel(r["normal"], mesh2d.want["normal"]) <= TOL
        np.testing.assert_array_equal(r["normal"], mesh2d.ranks[0]["normal"])


def test_mesh2d_collective_counts(mesh2d):
    for r in mesh2d.ranks:
        assert (r["count_forward"], r["count_normal"]) == (1, 2)


def test_mesh2d_dispatch_resume_bitmatch(mesh2d):
    for r in mesh2d.ranks:
        np.testing.assert_array_equal(r["x7_5"], r["x12"])
        np.testing.assert_array_equal(r["x12"], mesh2d.ranks[0]["x12"])


@pytest.mark.parametrize("op", ["forward", "normal"])
def test_mesh2d_rank_model_matches_unsharded(mesh2d, op):
    for r in mesh2d.ranks:
        if op == "forward":
            got = flat_from_rows(mesh2d.ranks, r["rank_idx"], "rank_rows", "rank_mine")
            assert rel(got, r["rank_un_forward"]) <= TOL
        else:
            assert rel(r["rank_normal"], r["rank_un_normal"]) <= TOL
