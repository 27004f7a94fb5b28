"""Channel-expert sharding of the fusion operator over `torch.distributed`.

Counterpart of `surfh_tpu/parallel/fusion.py`.  The reference runs one SPMD
program over a device mesh (`shard_map`, a `lax.switch` on the device index,
a `psum`); here one process drives one device, and the mesh is a
`torch.distributed.device_mesh.DeviceMesh` over the default process group:

* rank ``d`` owns the channels ``c`` with ``c % world == d``, in slot
  ``c // world`` (the reference's round-robin);
* the maps (the unknown, a few MB) are replicated; the forward computes
  only the owned channels' blocks and communicates nothing;
* the adjoint and the normal operator each do exactly one ``all_reduce``
  (sum) of the maps-shaped contribution (the reference's `psum`).

Window-local models run the model's own per-channel conv, gather, slit
weights and blur (`SpectroSigRLSCT._conv` / `Channel.forward_rows` and
their transposes), so the row gathers are kernel #1 on the card.  W-plane
models convolve each owned channel over its own λ window only (the
reference's `_make_channel_fwd` / `_make_channel_adj`): the window's cube,
its slice of the OTF, then the channel's windowed pipeline with the
model's blur (dense, or the banded kernel pair), so each rank does only its
bands' FFT work.

`make_mesh` initializes the default process group where none exists: from
the launcher's environment (``torchrun``: ``RANK``, ``WORLD_SIZE``,
``MASTER_ADDR``), else a world of 1 in this process on a `FileStore` in a
temporary directory.  NCCL on the card, gloo on the CPU; no fallback.
"""

from __future__ import annotations

import atexit
import dataclasses
import multiprocessing
import os
import pickle
import shutil
import tempfile
import time
from datetime import timedelta
from math import ceil
from typing import List, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..core.precision import require_cuda
from ..solvers import cg as cg_mod
from ..solvers.criterion import dtd_separated

PG_TIMEOUT = timedelta(minutes=10)  # a rank that waits longer than this on a collective fails


def mesh_device_type(device_type: Optional[str] = None) -> str:
    """"cuda" (the card; raises without one), or "cpu" under ``SURFH_CPU``
    or when asked."""
    if device_type is not None:
        return device_type
    if os.environ.get("SURFH_CPU"):
        return "cpu"
    require_cuda()
    return "cuda"


def init_world(device_type: Optional[str] = None) -> None:
    """Initialize the default process group unless one exists: NCCL on the
    card and gloo on the CPU; from the launcher's environment where it is
    set, else a world of 1 on a `FileStore` in a temporary directory.  On
    the card the process takes the device ``LOCAL_RANK`` (0 without a
    launcher) first."""
    if dist.is_initialized():
        return
    device_type = mesh_device_type(device_type)
    backend = "nccl" if device_type == "cuda" else "gloo"
    if device_type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    if all(k in os.environ for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR")):
        dist.init_process_group(backend, timeout=PG_TIMEOUT)
        return
    root = tempfile.mkdtemp(prefix="surfh_pg_")
    atexit.register(shutil.rmtree, root, True)
    store = dist.FileStore(os.path.join(root, "store"), 1)
    dist.init_process_group(backend, store=store, rank=0, world_size=1, timeout=PG_TIMEOUT)


def _world_main(fn, rank: int, world: int, store: str, backend: str, out: str, args) -> None:
    """A process of :func:`spawn_world`: join the group, run `fn`, pickle
    what it returns to `out`, leave the group."""
    dist.init_process_group(backend, store=dist.FileStore(store, world), rank=rank,
                            world_size=world, timeout=PG_TIMEOUT)
    try:
        result = fn(rank, world, *args)
    finally:
        dist.destroy_process_group()
    with open(out, "wb") as fh:
        pickle.dump(result, fh)


def spawn_world(fn, world: int, args: tuple = (), backend: str = "gloo", timeout: float = 120.0) -> list:
    """Run ``fn(rank, world, *args)`` in `world` spawned processes joined in
    one process group (`backend`, on a `FileStore` in a temporary
    directory); returns each rank's result.  `fn` must be importable by
    the children (a module-level function of a module they can import).
    A process that fails, or one still running after `timeout` seconds,
    stops them all (the others may wait on it in a collective) and raises."""
    ctx = multiprocessing.get_context("spawn")
    root = tempfile.mkdtemp(prefix="surfh_world_")
    try:
        outs = [os.path.join(root, f"rank{r}.pkl") for r in range(world)]
        procs = [ctx.Process(target=_world_main,
                             args=(fn, r, world, os.path.join(root, "store"), backend, outs[r], args))
                 for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        while (any(p.is_alive() for p in procs) and time.monotonic() < deadline
               and not any(p.exitcode for p in procs)):
            time.sleep(0.05)
        failed = {r: p.exitcode for r, p in enumerate(procs) if p.exitcode}
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        if failed:
            raise RuntimeError(f"ranks failed (exit codes {failed}); stopped ranks {hung}")
        if hung:
            raise TimeoutError(f"ranks {hung} of {world} still running after {timeout:g} s")
        results = []
        for path in outs:
            with open(path, "rb") as fh:
                results.append(pickle.load(fh))
        return results
    finally:
        shutil.rmtree(root, ignore_errors=True)


def make_mesh(n_devices: Optional[int] = None, axis_name: str = "chan",
              device_type: Optional[str] = None):
    """A 1-D `DeviceMesh` named `axis_name` over the whole world (one process
    per device, so `n_devices`, when given, must be the world size)."""
    from torch.distributed.device_mesh import init_device_mesh

    device_type = mesh_device_type(device_type)
    init_world(device_type)
    world = dist.get_world_size()
    n = world if n_devices is None else int(n_devices)
    if n != world:
        raise ValueError(f"a {n}-device mesh needs a world of {n} processes; this one has {world}")
    return init_device_mesh(device_type, (n,), mesh_dim_names=(axis_name,))


def mesh_axis(mesh, axis_name: Optional[str]):
    """(name, process group, size, this process's index) of one mesh axis."""
    names = tuple(mesh.mesh_dim_names)
    name = axis_name or names[0]
    return name, mesh.get_group(name), int(mesh.size(names.index(name))), int(mesh.get_local_rank(name))


def tensor_bytes(obj, seen: Optional[set] = None) -> int:
    """Bytes of the tensor storages reachable from `obj` (dicts, lists,
    tuples, dataclasses), each storage once: a view of a table counts its
    storage, not once per view."""
    seen = set() if seen is None else seen
    if isinstance(obj, torch.Tensor):
        st = obj.untyped_storage()
        key = (obj.device, st.data_ptr())
        if key in seen:
            return 0
        seen.add(key)
        return int(st.nbytes())
    if isinstance(obj, dict):
        return sum(tensor_bytes(v, seen) for v in obj.values())
    if isinstance(obj, (list, tuple)):
        return sum(tensor_bytes(v, seen) for v in obj)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return sum(tensor_bytes(getattr(obj, f.name), seen) for f in dataclasses.fields(obj))
    return 0


class ShardedSpectro:
    """Channel-sharded wrapper of a `SpectroSigRLSCT` model.

    Parameters
    ----------
    model:
        The fusion operator (`surfh_tpu_torch.models.spectro.SpectroSigRLSCT`).
    mesh:
        A `DeviceMesh` (`make_mesh`); the axis `axis_name` (default: its
        first) shards the channel list.
    shard_tables:
        Window-local models only.  False (the reference's default): every
        table on every rank — a model not yet moved goes to this process's
        device (the mesh's: its card, or the CPU) in its host tables' type.
        True: this rank's device holds only its own channels' tables
        (``model.to(..., channels=...)``); the model then applies only
        those channels.
    """

    def __init__(self, model, mesh, axis_name: Optional[str] = None, shard_tables: bool = False):
        self.model = model
        self.mesh = mesh
        self.axis, self.group, self.n_dev, self.rank = mesh_axis(mesh, axis_name)
        n_ch = len(model.channels)
        self.n_ch = n_ch
        self.per_dev = max(1, ceil(n_ch / self.n_dev))
        self.block = max(int(np.prod(o)) for o in model.instrs_oshape)
        # round-robin: channel c → rank c % n_dev, slot c // n_dev
        self.slots: List[List[int]] = [
            [c for c in range(n_ch) if c % self.n_dev == d] for d in range(self.n_dev)
        ]
        self.mine = self.slots[self.rank]
        self.window_local = bool(model.window_local)
        self.shard_tables = bool(shard_tables)
        if self.shard_tables and not self.window_local:
            raise ValueError("shard_tables requires a window_local model")
        device = model.device if model.device is not None else (
            torch.device("cuda", torch.cuda.current_device()) if mesh.device_type == "cuda"
            else torch.device("cpu"))
        dtype = model.dtype if model.dtype is not None else (
            torch.float64 if model.npdtype == np.float64 else torch.float32)
        if self.shard_tables:
            model.to(device, dtype, channels=self.mine)
        elif model.tables is None:
            model.to(device, dtype)
        self.device, self.dtype = model.device, model.dtype
        self._table_bytes = self._count_table_bytes()

    # ------------------------------------------------------------------
    def _count_table_bytes(self) -> dict:
        """This rank's table bytes, and what the replicated layout would put
        on every rank (under `shard_tables`: the owners' bytes summed over
        the axis, one all_reduce at construction)."""
        model = self.model
        held = tensor_bytes(model.tables) + tensor_bytes(model._templates_dev)
        if not self.shard_tables:
            return {"per_device": held, "replicated_would_be": held}
        own = torch.tensor([float(held)], dtype=torch.float64,
                           device=self.device if self.device.type == "cuda" else "cpu")
        dist.all_reduce(own, group=self.group)
        return {"per_device": held, "replicated_would_be": int(own.item())}

    def table_hbm_bytes(self) -> dict:
        """{"per_device": bytes of tables this rank holds on its device,
        "replicated_would_be": bytes the replicated layout would put on
        every rank}."""
        return dict(self._table_bytes)

    # ------------------------------------------------------------------
    # per-channel pieces
    @property
    def banded(self) -> bool:
        return not self.window_local and self.model.banded

    def _fwd(self, x, c: int, plain: bool) -> torch.Tensor:
        """Channel c's detector block: the model's own per-channel conv (a
        W-plane model's over the channel's λ window alone)."""
        model = self.model
        chan, t = model.channels[c], model.tables["chan"][c]
        return chan.forward_rows(model._conv(x, c), t, plain, self.banded)

    def _adj(self, yc, c: int, plain: bool) -> torch.Tensor:
        model = self.model
        chan, t = model.channels[c], model.tables["chan"][c]
        return model._conv_t(chan.adjoint_rows(yc, t, plain, self.banded), c)

    # ------------------------------------------------------------------
    # public API
    def _x(self, x) -> torch.Tensor:
        return self.model._x(x)

    def _local_rows(self, y_packed) -> torch.Tensor:
        """This rank's [slots, block] rows of a packed array: the whole
        packed layout [n_dev·slots, block] or this rank's rows as given."""
        y = torch.as_tensor(y_packed).to(device=self.device, dtype=self.dtype)
        if y.shape[0] == self.n_dev * self.per_dev:
            return y[self.rank * self.per_dev : (self.rank + 1) * self.per_dev]
        if y.shape[0] != self.per_dev:
            raise ValueError(f"packed data of {y.shape[0]} rows: expected {self.n_dev * self.per_dev} "
                             f"(the whole layout) or {self.per_dev} (this rank's)")
        return y

    def forward(self, x, plain: bool = False) -> torch.Tensor:
        """maps → this rank's rows [slots, block] of the packed data (no
        communication); `plain` runs the kernels' plain versions."""
        x = self._x(x)
        out = torch.zeros((self.per_dev, self.block), device=self.device, dtype=self.dtype)
        for s, c in enumerate(self.mine):
            y = self._fwd(x, c, plain).reshape(-1)
            out[s, : y.numel()] = y
        return out

    def adjoint(self, y_packed, plain: bool = False) -> torch.Tensor:
        """packed data (the whole layout or this rank's rows) → maps (one
        all_reduce)."""
        model = self.model
        y = self._local_rows(y_packed)
        acc = torch.zeros(model.ishape, device=self.device, dtype=self.dtype)
        for s, c in enumerate(self.mine):
            oshape = model.instrs_oshape[c]
            yc = y[s, : int(np.prod(oshape))].reshape(oshape)
            model._add_contrib_(acc, self._adj(yc, c, plain), c)
        dist.all_reduce(acc, group=self.group)
        return acc

    def normal(self, x, plain: bool = False) -> torch.Tensor:
        """HᵗH x, fused per channel on its owner (one all_reduce)."""
        model = self.model
        x = self._x(x)
        acc = torch.zeros_like(x)
        for c in self.mine:
            model._add_contrib_(acc, self._adj(self._fwd(x, c, plain), c, plain), c)
        dist.all_reduce(acc, group=self.group)
        return acc

    # ------------------------------------------------------------------
    # layout conversion (reference flat vector ↔ packed rows)
    def pack(self, y_flat) -> torch.Tensor:
        """Reference flat data vector → the whole packed layout
        [n_dev·slots, block] on this rank's device (row d·slots + s: rank
        d, slot s; zero-padded)."""
        flat = torch.as_tensor(y_flat).to(device=self.device, dtype=self.dtype).reshape(-1)
        out = torch.zeros((self.n_dev * self.per_dev, self.block), device=self.device, dtype=self.dtype)
        idx = self.model._idx
        for c in range(self.n_ch):
            d, s = c % self.n_dev, c // self.n_dev
            out[d * self.per_dev + s, : idx[c + 1] - idx[c]] = flat[idx[c] : idx[c + 1]]
        return out

    def unpack(self, y_packed) -> np.ndarray:
        """Inverse of :meth:`pack` (the whole layout → the reference flat
        layout, host NumPy)."""
        packed = y_packed.detach().cpu().numpy() if isinstance(y_packed, torch.Tensor) else np.asarray(y_packed)
        idx = self.model._idx
        flat = np.zeros((int(idx[-1]),), packed.dtype)
        for c in range(self.n_ch):
            d, s = c % self.n_dev, c // self.n_dev
            flat[idx[c] : idx[c + 1]] = packed[d * self.per_dev + s, : idx[c + 1] - idx[c]]
        return flat

    def gather_packed(self, rows: torch.Tensor) -> torch.Tensor:
        """Every rank's rows (:meth:`forward`'s output) → the whole packed
        layout, on every rank (one all_gather)."""
        parts = [torch.empty_like(rows) for _ in range(self.n_dev)]
        dist.all_gather(parts, rows.contiguous(), group=self.group)
        return torch.cat(parts)

    def forward_flat(self, x) -> np.ndarray:
        """Forward returning the reference flat layout (its rows gathered
        from every rank, then unpacked on the host)."""
        return self.unpack(self.gather_packed(self.forward(x)))

    # ------------------------------------------------------------------
    def make_train_step(self, mu_spectro: float = 1.0, mu_reg: float = 1.0, lr: float = 1e-6):
        """One gradient step of ½µ_s‖y−Hx‖² + ½µ_r‖Dx‖²: the sharded forward
        (no communication), the residual of this rank's rows, the adjoint
        (one all_reduce), the replicated prior and update.  Returns
        ``step(x, y_packed) -> x``."""

        def step(x, y_packed):
            x = self._x(x)
            r = self.forward(x) - self._local_rows(y_packed)
            g = mu_spectro * self.adjoint(r) + mu_reg * dtd_separated(x)
            return x - lr * g

        return step

    def solve(
        self,
        y,
        mu_reg: float,
        x0=None,
        mu_spectro: float = 1.0,
        max_iter: int = 100,
        tol: float = 1e-12,
        method: str = "lcg",
        packed: bool = False,
        loop: str = "graph",
        chain_steps: int = 1,
        state=None,
        return_state: bool = False,
    ) -> cg_mod.SolverResult:
        """Sharded regularized least squares:
        min_x ½µ_s‖y − Hx‖² + ½µ_r‖Dx‖² via CG (or `mmmg`) on the normal
        equations.  Every iteration does one fused HᵗH (one all_reduce)
        plus the replicated separated-difference prior; the solver state is
        replicated maps, the same bits on every rank, so the ranks stop
        together.  `loop`, `chain_steps`, `state` and `return_state` as in
        `solvers.cg.lcg` (state is lcg-only)."""
        y_packed = y if packed else self.pack(y)
        b = mu_spectro * self.adjoint(y_packed)
        x0 = torch.zeros_like(b) if x0 is None else self._x(x0)

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
