"""λ-axis sharding of one channel's pipeline (the sequence-parallel analog).

Counterpart of `surfh_tpu/parallel/lambda_sharded.py`.  For cube-domain
models the cube itself is the memory bottleneck, so its λ axis is split
over the ranks of a mesh axis in contiguous blocks of ``Lp = ceil(L /
world)`` planes:

* gridding, the SRF box-sum and the slit windows are per λ plane — local to
  each rank (the row gather onto the channel's local grid, kernel #1 on the
  card; the FFT × `otf_combined` box-sum; the strided slit read; the slit
  weights);
* the spectral blur contracts over λ, so each rank contracts its planes
  with its own columns of the channel's `wpsf` and one ``all_reduce`` (sum)
  gives the detector data;
* the adjoint communicates nothing: each rank's cube block receives only
  what its own `wpsf` columns send it.
"""

from __future__ import annotations

from math import ceil
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..core.bilinear import row_plan
from ..core.gather_rows import gather_rows, gather_rows_reference
from ..core.linop import complex_dtype
from ..core.wblur import rows_table, wblur_rows, wblur_rows_t
from .fusion import mesh_axis


class LambdaShardedChannel:
    """One channel's forward / adjoint over a λ-sharded full cube.

    Parameters
    ----------
    chan: a `models.channel.Channel` moved with ``chan.to(device, dtype)``.
    n_lambda: length of the global cube λ axis.
    mesh: a `DeviceMesh`; its axis `axis_name` (default: the first) shards
        the λ axis in contiguous blocks.
    """

    def __init__(self, chan, n_lambda: int, mesh, axis_name: Optional[str] = None):
        if chan.tables is None:
            raise RuntimeError("call chan.to(device, dtype) before sharding it")
        self.chan = chan
        self.mesh = mesh
        self.axis, self.group, self.n_dev, self.rank = mesh_axis(mesh, axis_name)
        self.L = int(n_lambda)
        self.Lp = ceil(self.L / self.n_dev)  # padded block length
        self.L_pad = self.Lp * self.n_dev

        # each rank's block against the channel's window: (local start,
        # length, window-column offset), or None where they do not meet
        w0, w1 = chan.wslice.start, chan.wslice.stop
        self._spans = []
        for d in range(self.n_dev):
            s0, s1 = d * self.Lp, (d + 1) * self.Lp
            lo, hi = max(s0, w0), min(s1, w1)
            self._spans.append(None if lo >= hi else (lo - s0, hi - lo, lo - w0))
        self.span = self._spans[self.rank]

        dev, dt = chan.device, chan.dtype
        self.device, self.dtype = dev, dt
        n_src = int(np.prod(chan.imshape))
        self._plans = [row_plan(p.idx, p.w, n_src, dev, dt) for p in chan.plans_fwd]
        self._plans_t = [p.t for p in self._plans]
        self._box = {"otf_box": torch.as_tensor(chan.otf_combined[0]).to(dev, complex_dtype(dt))}
        self._wq = None
        if self.span is not None:
            _, n, c0 = self.span
            wcols = np.ascontiguousarray(chan.wpsf[:, c0 : c0 + n, :])  # [K, n, sb]
            self._wq = rows_table(torch.as_tensor(wcols).to(dev, dt))

    # ------------------------------------------------------------------
    def shard_cube(self, cube) -> torch.Tensor:
        """This rank's block [Lp, Na, Nb] of the cube [L, Na, Nb] (zero past
        the end of the λ axis), on the channel's device."""
        cube = torch.as_tensor(cube)
        if cube.shape[0] != self.L:
            raise ValueError(f"cube has {cube.shape[0]} planes, expected {self.L}")
        block = torch.zeros((self.Lp,) + tuple(cube.shape[1:]), dtype=self.dtype, device=self.device)
        lo = self.rank * self.Lp
        hi = min(lo + self.Lp, self.L)
        if hi > lo:
            block[: hi - lo] = cube[lo:hi].to(device=self.device, dtype=self.dtype)
        return block

    def forward(self, cube_sharded, plain: bool = False) -> torch.Tensor:
        """This rank's cube block [Lp, Na, Nb] → the detector block
        [P, S, K, A], the same on every rank (one all_reduce)."""
        chan = self.chan
        out = torch.zeros(chan.oshape, device=self.device, dtype=self.dtype)
        if self.span is not None:
            s0, n, _ = self.span
            shard = torch.as_tensor(cube_sharded).to(device=self.device, dtype=self.dtype)
            src = shard[s0 : s0 + n].reshape(n, -1).T.contiguous()  # [Na·Nb, n]
            gather = gather_rows_reference if plain else gather_rows
            _, S, K, A = chan.oshape
            sb = chan.slit_shape[2]
            for p, plan in enumerate(self._plans):
                win = chan._slit_windows(gather(src, plan), self._box, fft_box=True)  # [S·A·sb, n]
                win = (win.view(S * A, sb, n) * chan.tables["slit_w"]).view(S * A, sb * n)
                out[p] = wblur_rows(win, self._wq).view(S, A, K).transpose(1, 2)
        dist.all_reduce(out, group=self.group)
        return out

    def adjoint(self, y, plain: bool = False) -> torch.Tensor:
        """The detector block [P, S, K, A] (replicated) → this rank's cube
        block [Lp, Na, Nb] (no communication)."""
        chan = self.chan
        out = torch.zeros((self.Lp,) + chan.imshape, device=self.device, dtype=self.dtype)
        if self.span is None:
            return out
        s0, n, _ = self.span
        y = torch.as_tensor(y).to(device=self.device, dtype=self.dtype).reshape(chan.oshape)
        gather = gather_rows_reference if plain else gather_rows
        _, S, K, A = chan.oshape
        sb = chan.slit_shape[2]
        acc = None
        for p, plan_t in enumerate(self._plans_t):
            win = wblur_rows_t(y[p].transpose(1, 2).reshape(S * A, K), self._wq)
            win = (win.view(S * A, sb, n) * chan.tables["slit_w"]).view(S * A * sb, n)
            rows = gather(chan._slit_windows_t(win, self._box, fft_box=True), plan_t)  # [Na·Nb, n]
            acc = rows if acc is None else acc.add_(rows)
        out[s0 : s0 + n] = acc.T.reshape((n,) + chan.imshape)
        return out
