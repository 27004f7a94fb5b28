"""Rank functions of the port's sharded tests, run by
`surfh_tpu_torch.parallel.fusion.spawn_world` in spawned processes (gloo,
float64, on the CPU).

This module imports torch and the port only: the children import it by
name, and JAX must not reach them.  Each function returns a dict of host
arrays and numbers, which the parent test holds against the JAX classes.
"""

from __future__ import annotations

import os

os.environ.setdefault("SURFH_TABLE_CACHE", "0")

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

torch.set_num_threads(1)

WPLANE_KW = dict(im_size=31, n_lambda=24, n_tpl=3, n_channels=3, n_pointings=2, n_slit=3)
RANK_KW = dict(im_size=31, n_lambda=120, n_tpl=2, n_channels=4, n_pointings=2, n_slit=3,
               window_local=True, conv_impl="matmul", conv_freq_rtol=1e-6, conv_rank_rtol=1e-7,
               psf_stamps=True)
DENSE_KW = dict(RANK_KW, conv_rank_rtol=0.0)
MESH2D_KW = dict(im_size=31, n_lambda=24, n_tpl=3, n_channels=2, n_pointings=2, n_slit=3)
LAMBDA_KW = dict(im_size=31, n_lambda=26, n_tpl=3, n_channels=1, n_pointings=2, n_slit=3)


class CountAllReduce:
    """Counts the calls of `torch.distributed.all_reduce` while active."""

    def __enter__(self):
        self.n = 0
        self._orig = dist.all_reduce

        def counted(*a, **k):
            self.n += 1
            return self._orig(*a, **k)

        dist.all_reduce = counted
        return self

    def __exit__(self, *exc):
        dist.all_reduce = self._orig


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy()


def _model(**kw):
    from surfh_tpu_torch.simulation.synthetic import make_model

    return make_model(dtype=np.float64, **kw)


def fusion_worker(rank: int, world: int, yr: np.ndarray, ckpt_path: str) -> dict:
    """`ShardedSpectro` on the W-plane model: forward, adjoint, normal, the
    collective counts, pack/unpack, the solves and resumes, a train step."""
    from surfh_tpu_torch.parallel import ShardedSpectro, make_mesh
    from surfh_tpu_torch.solvers import checkpoint as ckpt

    model, setup = _model(**WPLANE_KW)
    sh = ShardedSpectro(model, make_mesh(device_type="cpu"))
    x = torch.as_tensor(setup["maps"])
    out = {"mine": sh.mine, "n_dev": sh.n_dev}
    with CountAllReduce() as n:
        rows = sh.forward(x)
    out["count_forward"] = n.n
    with CountAllReduce() as n:
        out["adjoint"] = _np(sh.adjoint(sh.pack(yr)))
    out["count_adjoint"] = n.n
    with CountAllReduce() as n:
        out["normal"] = _np(sh.normal(x))
    out["count_normal"] = n.n
    out["forward_flat"] = sh.unpack(sh.gather_packed(rows))
    out["pack_roundtrip"] = bool(np.array_equal(sh.unpack(sh.pack(yr)), yr.ravel()))
    out["adjoint_local_rows"] = _np(sh.adjoint(sh.pack(yr)[rank * sh.per_dev : (rank + 1) * sh.per_dev]))

    y = model.forward(x)
    res = sh.solve(y, mu_reg=1.0, max_iter=15)
    out["solve_grad_norm"] = res.grad_norm
    out["solve_x"] = _np(res.x)
    r12 = sh.solve(y, mu_reg=1.0, max_iter=12, tol=0.0, loop="dispatch")
    r7 = sh.solve(y, mu_reg=1.0, max_iter=7, tol=0.0, loop="dispatch", return_state=True)
    r5 = sh.solve(y, mu_reg=1.0, max_iter=5, tol=0.0, loop="dispatch", state=r7.state)
    out["x12"], out["x7_5"] = _np(r12.x), _np(r5.x)
    if rank == 0:  # one writer
        ckpt.save_checkpoint(ckpt_path, r7.x, 7, grad_norm=r7.grad_norm, state=r7.state)
    dist.barrier()
    loaded = ckpt.load_checkpoint(ckpt_path)
    state = tuple(torch.as_tensor(s) for s in loaded["state"])
    out["ckpt_n_iter"] = loaded["n_iter_done"]
    out["x7_ckpt_5"] = _np(sh.solve(y, mu_reg=1.0, max_iter=5, tol=0.0, loop="dispatch",
                                    state=state).x)
    out["mmmg_x"] = _np(sh.solve(y, mu_reg=1.0, max_iter=6, method="mmmg").x)

    yp = sh.forward(x)
    x0 = torch.zeros_like(x)
    x1 = sh.make_train_step(mu_spectro=1.0, mu_reg=0.0, lr=1e-10)(x0, yp)

    def loss(z):
        r = sh.forward(z) - yp
        s = (r * r).sum().reshape(1)
        dist.all_reduce(s, group=sh.group)
        return float(s)

    out["loss0"], out["loss1"] = loss(x0), loss(x1)
    return out


def modes_worker(rank: int, world: int, xr: np.ndarray, yr: np.ndarray) -> dict:
    """Window-local models (λ-rank, dense stamps): the sharded forward /
    adjoint / normal against the unsharded model, `shard_tables` against
    the replicated layout bit for bit, the table bytes."""
    from surfh_tpu_torch.parallel import ShardedSpectro, make_mesh

    mesh = make_mesh(device_type="cpu")
    out = {}
    for name, kw in (("rank", RANK_KW), ("dense", DENSE_KW)):
        model, _ = _model(**kw)
        sh = ShardedSpectro(model, mesh)
        x = torch.as_tensor(xr)
        got = {"forward_flat": sh.forward_flat(x), "adjoint": _np(sh.adjoint(sh.pack(yr))),
               "normal": _np(sh.normal(x))}
        model.to("cpu", torch.float64)  # every table, for the unsharded results
        got.update(un_forward=_np(model.forward(x)), un_adjoint=_np(model.adjoint(yr)),
                   un_normal=_np(model.normal(x)),
                   supports=[s.get("rank") for s in model.conv_supports])
        own, _ = _model(**kw)
        sho = ShardedSpectro(own, mesh, shard_tables=True)
        got.update(own_forward=_np(sho.forward(x)), repl_forward=_np(sh.forward(x)),
                   own_adjoint=_np(sho.adjoint(sho.pack(yr))), own_normal=_np(sho.normal(x)),
                   own_bytes=sho.table_hbm_bytes(), repl_bytes=sh.table_hbm_bytes(),
                   held=[c for c, t in enumerate(own.tables["chan"]) if t is not None],
                   mine=sho.mine)
        out[name] = got
    return out


def lambda_worker(rank: int, world: int, cube: np.ndarray, yr: np.ndarray) -> dict:
    """`LambdaShardedChannel`: forward, this rank's adjoint block, the
    collective counts, the dot-test terms, the unsharded channel."""
    from surfh_tpu_torch.parallel import LambdaShardedChannel, make_mesh

    model, _ = _model(**LAMBDA_KW)
    chan = model.channels[0].to("cpu", torch.float64)
    sh = LambdaShardedChannel(chan, n_lambda=LAMBDA_KW["n_lambda"],
                              mesh=make_mesh(axis_name="lam", device_type="cpu"))
    shard = sh.shard_cube(cube)
    with CountAllReduce() as n:
        fwd = sh.forward(shard)
    count_fwd = n.n
    with CountAllReduce() as n:
        adj = sh.adjoint(yr)
    # ⟨H cube, y⟩ (replicated) and this rank's part of ⟨cube, Hᵗ y⟩
    return {"forward": _np(fwd), "adjoint_block": _np(adj), "shard": _np(shard),
            "count_forward": count_fwd, "count_adjoint": n.n, "Lp": sh.Lp, "span": sh.span,
            "lhs": float((fwd * torch.as_tensor(yr)).sum()), "rhs_part": float((shard * adj).sum()),
            "un_forward": _np(chan.forward(cube)), "un_adjoint": _np(chan.adjoint(yr))}


def mesh2d_worker(rank: int, world: int, n_c: int, n_l: int) -> dict:
    """`ShardedSpectro2D` on an n_c × n_l mesh: the W-plane model (forward
    rows, normal, the collective counts, the dispatch resume) and the
    window-local λ-rank model (forward, normal against the unsharded)."""
    from surfh_tpu_torch.parallel import ShardedSpectro2D, make_mesh_2d

    mesh = make_mesh_2d(n_c, n_l, device_type="cpu")
    model, setup = _model(**MESH2D_KW)
    model.to("cpu", torch.float64)
    sh = ShardedSpectro2D(model, mesh)
    x = torch.as_tensor(setup["maps"])
    out = {"d": sh.d, "e": sh.e, "mine": sh.mine, "per_dev": sh.per_dev}
    with CountAllReduce() as n:
        out["rows"] = _np(sh.forward(x))
    out["count_forward"] = n.n
    with CountAllReduce() as n:
        out["normal"] = _np(sh.normal(x))
    out["count_normal"] = n.n
    y = model.forward(x)
    r12 = sh.solve(y, mu_reg=1e4, max_iter=12, tol=0.0, loop="dispatch")
    r7 = sh.solve(y, mu_reg=1e4, max_iter=7, tol=0.0, loop="dispatch", return_state=True)
    r5 = sh.solve(y, mu_reg=1e4, max_iter=5, tol=0.0, loop="dispatch", state=r7.state)
    out["x12"], out["x7_5"] = _np(r12.x), _np(r5.x)

    rmodel, rsetup = _model(**RANK_KW)
    rmodel.to("cpu", torch.float64)
    rsh = ShardedSpectro2D(rmodel, mesh)
    xr = torch.as_tensor(rsetup["maps"])
    out["rank_rows"] = _np(rsh.forward(xr))
    out["rank_normal"] = _np(rsh.normal(xr))
    out["rank_un_forward"] = _np(rmodel.forward(xr))
    out["rank_un_normal"] = _np(rmodel.normal(xr))
    out["rank_idx"] = rmodel._idx
    out["rank_mine"] = rsh.mine
    return out
