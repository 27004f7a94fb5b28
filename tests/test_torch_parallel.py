"""surfh_tpu_torch's channel-expert sharding (`parallel.fusion.ShardedSpectro`)
against the JAX reference's `surfh_tpu.parallel.fusion.ShardedSpectro`
(CPU, float64, gloo in spawned processes; the JAX side on the virtual CPU
devices of tests/conftest.py):

* at worlds 1, 2, 3 and 4, on the W-plane model of tests/test_parallel.py:
  the forward (gathered to the flat layout), the adjoint and the normal of
  every rank against the JAX class on a mesh of as many devices, ≤1e-12
  relative; the all_reduce counts 0 / 1 / 1; the round-robin ownership;
  pack / unpack; the solve's fall; every rank's iterate bit for bit rank
  0's; the dispatch resume and the checkpoint resume bit for bit; mmmg
  against the JAX class's mmmg; a train step that descends;
* at world 2, on the window-local λ-rank and dense stamp models (the
  tests/test_parallel.py window-local cases, in float64): against the JAX
  class ≤1e-12 and the unsharded model; `shard_tables` bit for bit the
  replicated layout, with fewer table bytes on each rank.

The packed layouts differ between meshes, so the comparisons are of flat
vectors and maps.  The rank functions live in tests/torch_dist_workers.py,
which imports no JAX.
"""

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch_dist_workers as W

from surfh_tpu.parallel.fusion import ShardedSpectro as JaxSharded
from surfh_tpu.parallel.fusion import make_mesh as jax_make_mesh
from surfh_tpu.simulation.synthetic import make_model as jax_make_model
from surfh_tpu_torch.parallel.fusion import spawn_world

TOL = 1e-12
WORLDS = [1, 2, 3, 4]


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.fixture(scope="module")
def jax_wplane():
    model, setup = jax_make_model(dtype=jnp.float64, **W.WPLANE_KW)
    yr = np.random.default_rng(7).standard_normal(model.oshape)
    return model, setup, yr


@pytest.fixture(scope="module", params=WORLDS, ids=lambda w: f"world{w}")
def fusion(request, jax_wplane, tmp_path_factory):
    world = request.param
    jm, setup, yr = jax_wplane
    ranks = spawn_world(W.fusion_worker, world, (yr, str(tmp_path_factory.mktemp("ckpt") / "cg.npz")))
    jsh = JaxSharded(jm, jax_make_mesh(world))
    x = setup["maps"]
    y = np.asarray(jm.forward(x))
    want = {"forward_flat": np.asarray(jsh.forward_flat(x)),
            "adjoint": np.asarray(jsh.adjoint(jsh.pack(yr))),
            "normal": np.asarray(jsh.normal(x)),
            "mmmg_x": np.asarray(jsh.solve(y, mu_reg=1.0, max_iter=6, method="mmmg").x)}
    return SimpleNamespace(world=world, ranks=ranks, want=want, n_ch=len(jm.channels))


@pytest.mark.parametrize("op", ["forward_flat", "adjoint", "normal"])
def test_sharded_operator_matches_jax(fusion, op):
    for r in fusion.ranks:
        assert r[op].shape == fusion.want[op].shape
        assert rel(r[op], fusion.want[op]) <= TOL, (fusion.world, op)


def test_collective_counts(fusion):
    """The reference's contract (tests/test_comm_contract.py): no
    collective in the forward, one all_reduce in the adjoint and in the
    normal."""
    for r in fusion.ranks:
        assert (r["count_forward"], r["count_adjoint"], r["count_normal"]) == (0, 1, 1)


def test_round_robin_ownership(fusion):
    w = fusion.world
    for rank, r in enumerate(fusion.ranks):
        assert r["n_dev"] == w
        assert r["mine"] == [c for c in range(fusion.n_ch) if c % w == rank]


def test_pack_unpack_and_local_rows(fusion):
    for r in fusion.ranks:
        assert r["pack_roundtrip"]
        np.testing.assert_array_equal(r["adjoint_local_rows"], r["adjoint"])


def test_sharded_solve_reduces_residual(fusion):
    gn = fusion.ranks[0]["solve_grad_norm"]
    assert gn[-1] < 1e-3 * gn[0]


@pytest.mark.parametrize("key", ["solve_x", "x12", "mmmg_x"])
def test_ranks_iterate_bit_for_bit(fusion, key):
    """Replicated maps, one all_reduce: every rank holds rank 0's bits."""
    for r in fusion.ranks[1:]:
        np.testing.assert_array_equal(r[key], fusion.ranks[0][key])


def test_sharded_dispatch_resume_bitmatch(fusion):
    for r in fusion.ranks:
        np.testing.assert_array_equal(r["x7_5"], r["x12"])


def test_sharded_checkpoint_resume_bitmatch(fusion):
    """Rank 0 writes the checkpoint; every rank resumes from it to the
    uninterrupted solve's bits."""
    for r in fusion.ranks:
        assert r["ckpt_n_iter"] == 7
        np.testing.assert_array_equal(r["x7_ckpt_5"], r["x12"])


def test_sharded_mmmg_matches_jax(fusion):
    assert rel(fusion.ranks[0]["mmmg_x"], fusion.want["mmmg_x"]) <= 1e-10


def test_train_step_descends(fusion):
    for r in fusion.ranks:
        assert r["loss1"] < r["loss0"]


# ---------------------------------------------------------------------------
# window-local models at world 2


@pytest.fixture(scope="module")
def modes():
    out = {}
    jax_models = {}
    for name, kw in (("rank", W.RANK_KW), ("dense", W.DENSE_KW)):
        jm, setup = jax_make_model(dtype=jnp.float64, **kw)
        jax_models[name] = (jm, setup)
    jm0 = jax_models["rank"][0]
    rng = np.random.default_rng(5)
    xr = rng.random(jm0.ishape)
    yr = rng.standard_normal(jm0.oshape)
    ranks = spawn_world(W.modes_worker, 2, (xr, yr))
    for name, (jm, _) in jax_models.items():
        jsh = JaxSharded(jm, jax_make_mesh(2))
        out[name] = {"forward_flat": np.asarray(jsh.forward_flat(xr)),
                     "adjoint": np.asarray(jsh.adjoint(jsh.pack(yr))),
                     "normal": np.asarray(jsh.normal(xr)),
                     "supports": [s.get("rank") for s in jm.conv_supports]}
    return SimpleNamespace(ranks=ranks, want=out)


@pytest.mark.parametrize("op", ["forward_flat", "adjoint", "normal"])
@pytest.mark.parametrize("mode", ["rank", "dense"])
def test_window_local_sharded_matches_jax_and_unsharded(modes, mode, op):
    want = modes.want[mode][op]
    un = {"forward_flat": "un_forward", "adjoint": "un_adjoint", "normal": "un_normal"}[op]
    for r in modes.ranks:
        got = r[mode]
        assert got["supports"] == modes.want[mode]["supports"]
        assert rel(got[op], want) <= TOL
        assert rel(got[op], got[un]) <= TOL
    if mode == "rank":
        assert any(s is not None for s in modes.want["rank"]["supports"])


@pytest.mark.parametrize("mode", ["rank", "dense"])
def test_shard_tables_matches_replicated(modes, mode):
    """Owner-held tables: each rank holds only its channels' tables and its
    forward rows, adjoint and normal are the replicated layout's bits."""
    for r in modes.ranks:
        got = r[mode]
        assert got["held"] == got["mine"]
        np.testing.assert_array_equal(got["own_forward"], got["repl_forward"])
        np.testing.assert_array_equal(got["own_adjoint"], got["adjoint"])
        np.testing.assert_array_equal(got["own_normal"], got["normal"])
        own, repl = got["own_bytes"], got["repl_bytes"]
        assert 0 < own["per_device"] < own["replicated_would_be"]
        assert own["replicated_would_be"] == repl["per_device"] == repl["replicated_would_be"]
