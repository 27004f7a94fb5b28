"""2-D mesh sharding: channel-expert × λ-axis, composed.

Counterpart of `surfh_tpu/parallel/mesh2d.py`.  The bands spread over the
mesh's "chan" axis, as in `parallel.fusion`; within each band the columns
of its conv output spread over the "lam" axis in contiguous spans of
``ceil(n / n_lam)``: each rank convolves only its columns, runs the
channel's gather and slit weights on them, and contracts them with its
columns of the blur table.  The columns are the band's λ window (W-plane
models, and window-local models with the dense or the FFT conv) or, for a
λ-rank window-local band, its template maps (the Q = M·R rank-basis
columns, R at a time).

Communication per application:

* forward: one ``all_reduce`` over "lam" (the partial detector blocks);
* normal: that one, then one over the whole mesh (the maps contributions).
"""

from __future__ import annotations

from math import ceil
from typing import List, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..solvers import cg as cg_mod
from ..solvers.criterion import dtd_separated
from .fusion import init_world, mesh_device_type


def make_mesh_2d(n_chan: int, n_lam: int, axis_names=("chan", "lam"),
                 device_type: Optional[str] = None):
    """A 2-D `DeviceMesh` [n_chan, n_lam] over the whole world (rank r at
    (r // n_lam, r % n_lam))."""
    from torch.distributed.device_mesh import init_device_mesh

    device_type = mesh_device_type(device_type)
    init_world(device_type)
    world = dist.get_world_size()
    if n_chan * n_lam != world:
        raise ValueError(f"a {n_chan} x {n_lam} mesh needs a world of {n_chan * n_lam}; "
                         f"this one has {world}")
    return init_device_mesh(device_type, (n_chan, n_lam), mesh_dim_names=tuple(axis_names))


class ShardedSpectro2D:
    """A `SpectroSigRLSCT` over a ("chan", "lam") mesh; maps replicated.
    The model must be on this rank's device (``model.to``) with every
    table."""

    def __init__(self, model, mesh):
        if len(mesh.mesh_dim_names) != 2:
            raise ValueError("expects a 2-D mesh")
        if model.tables is None:
            raise RuntimeError("call model.to(device, dtype) before sharding it")
        if int(np.prod(mesh.mesh.shape)) != dist.get_world_size():
            raise ValueError("the 2-D mesh must span the whole world")
        self.model = model
        self.mesh = mesh
        self.ax_c, self.ax_l = mesh.mesh_dim_names
        self.n_c, self.n_l = int(mesh.size(0)), int(mesh.size(1))
        self.d = int(mesh.get_local_rank(self.ax_c))
        self.e = int(mesh.get_local_rank(self.ax_l))
        self.lam_group = mesh.get_group(self.ax_l)
        n_ch = len(model.channels)
        self.slots: List[List[int]] = [
            [c for c in range(n_ch) if c % self.n_c == d] for d in range(self.n_c)
        ]
        self.mine = self.slots[self.d]
        self.per_dev = max(1, ceil(n_ch / self.n_c))
        self.block = max(int(np.prod(o)) for o in model.instrs_oshape)
        self.device, self.dtype = model.device, model.dtype

        # per channel and lam rank: the span (lo, n) of its columns
        self._spans = []
        for c in range(n_ch):
            cols = model._n_cols(c)
            per = ceil(cols / self.n_l)
            self._spans.append([(e * per, max(min((e + 1) * per, cols) - e * per, 0))
                                for e in range(self.n_l)])
        # this rank's blur-table columns of each owned channel
        self._tables = {}
        for c in self.mine:
            lo, n = self._spans[c][self.e]
            if n == 0:
                continue
            t = model.tables["chan"][c]
            k = t["wq"].shape[0]
            q = self._q_per_col(c)
            wq = t["wq"].view(k, model.channels[c].slit_shape[2], -1)[:, :, lo * q : (lo + n) * q]
            self._tables[c] = {**t, "wq": wq.reshape(k, -1).contiguous()}

    # ------------------------------------------------------------------
    def _q_per_col(self, c: int) -> int:
        """Blur-table columns per split column: R for a λ-rank band, else 1."""
        t = self.model.tables["chan"][c]
        return int(t["otf_re"].shape[-1]) if self.model._rank_band(c) else 1

    def _partial_rows(self, x, plain: bool) -> torch.Tensor:
        """This rank's partial forward of every owned channel, padded and
        stacked [slots, block] (a slot with no columns here adds zeros), so
        the lam reduction is one all_reduce on every rank."""
        model = self.model
        out = torch.zeros((self.per_dev, self.block), device=self.device, dtype=self.dtype)
        for s, c in enumerate(self.mine):
            if c not in self._tables:
                continue
            lo, n = self._spans[c][self.e]
            y = model.channels[c].forward_rows(model._conv(x, c, (lo, lo + n), plain), self._tables[c],
                                               plain).reshape(-1)
            out[s, : y.numel()] = y
        return out

    # ------------------------------------------------------------------
    def forward(self, x, plain: bool = False) -> torch.Tensor:
        """maps → this "chan" rank's rows [slots, block] of the packed data,
        the same on its "lam" ranks (one all_reduce over "lam")."""
        rows = self._partial_rows(self.model._x(x), plain)
        dist.all_reduce(rows, group=self.lam_group)
        return rows

    def normal(self, x, plain: bool = False) -> torch.Tensor:
        """HᵗH x over the 2-D mesh: the partial forwards, one all_reduce over
        "lam", the adjoint of this rank's columns, one all_reduce over the
        whole mesh."""
        model = self.model
        x = model._x(x)
        y_rows = self._partial_rows(x, plain)
        dist.all_reduce(y_rows, group=self.lam_group)
        acc = torch.zeros_like(x)
        for s, c in enumerate(self.mine):
            if c not in self._tables:
                continue
            lo, n = self._spans[c][self.e]
            chan = model.channels[c]
            yc = y_rows[s, : int(np.prod(chan.oshape))].reshape(chan.oshape)
            cols = (lo, lo + n)
            rows = chan.adjoint_rows(yc, self._tables[c], plain)
            model._add_contrib_(acc, model._conv_t(rows, c, cols, plain), c, cols)
        dist.all_reduce(acc)
        return acc

    def solve(
        self,
        y,
        mu_reg: float,
        x0=None,
        mu_spectro: float = 1.0,
        max_iter: int = 100,
        tol: float = 1e-12,
        method: str = "lcg",
        loop: str = "graph",
        chain_steps: int = 1,
        state=None,
        return_state: bool = False,
    ) -> cg_mod.SolverResult:
        """min_x ½µ_s‖y − Hx‖² + ½µ_r‖Dx‖² over the 2-D mesh: b = µ_s·Hᵗy once
        through the model's own adjoint, then every iteration one sharded
        normal (two all_reduces) plus the replicated prior.  Keywords as
        `parallel.fusion.ShardedSpectro.solve`."""
        model = self.model
        b = mu_spectro * model.adjoint(y)
        x0 = torch.zeros_like(b) if x0 is None else model._x(x0)

        def normal_op(x):
            return mu_spectro * self.normal(x) + mu_reg * dtd_separated(x)

        if method == "lcg":
            return cg_mod.lcg(normal_op, b, x0, max_iter=max_iter, tol=tol, loop=loop,
                              chain_steps=chain_steps, state=state, return_state=return_state)
        if state is not None or return_state or chain_steps != 1:
            raise ValueError("state/return_state/chain_steps are lcg-only; mmmg would "
                             "silently cold-restart from x0")
        if method != "mmmg":
            raise ValueError(f"unknown method {method!r}")
        return cg_mod.mmmg(normal_op, b, x0, max_iter=max_iter, tol=tol, loop=loop)
