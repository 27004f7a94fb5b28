"""Banded spectral blur: the port of `surfh_tpu/core/wblur_pallas.py`.

The spectral response wpsf[λ', λ, β] of a band is band-limited: detector
wavelength λ' takes flux only from cube wavelengths λ near it.  The banded
pair keeps, per tile, only the slab of the λ-window (forward) or of the λ'
axis (transpose) where the tile's response lives, as the reference's plans
decide:

* `BandPlan` / `build_band_plan`: per λ'-tile of TK = 128 rows, the λ
  offset `starts[t]` of a band of LB samples (LB rounded up to 8, at most
  W) — the forward keeps ``wpsf[k, l, b]`` for
  ``starts[k // TK] <= l < starts[k // TK] + LB``;
* `BandPlanT` / `build_band_plan_t`: per λ-tile of TL = 128 // Bp rows,
  the λ' offset of a band of KB samples (rounded up to 128) — the
  transpose keeps ``wpsf[k, l, b]`` for
  ``starts_t[l // TL] <= k < starts_t[l // TL] + KB``.

The two masks differ, so at ``rel_eps > 0`` the banded pair is not an
exact transpose pair (the reference's design; its dot test is off by about
the truncated mass).  The plans are NumPy copies of the reference's, so
both packages keep the same entries.

Layout: the port's row layout (`core.wblur`): windows ``[S·A, B·W]`` as the
row gather leaves them (β-major, then λ), detector rows ``[S·A, K]``.

* `banded_tables` — the plans' device tables: the per-tile re-laid blocks
  the kernels read, and the masked dense tables the plain versions read.
* `wblur_banded_reference` / `wblur_banded_t_reference` — the plain torch
  versions: one matmul against the masked table.
* `wblur_banded_cuda` / `wblur_banded_t_cuda` — the hand-written kernels
  (``csrc/wblur_banded.cu``), built with nvcc at first use; each counts its
  launches in `launches` / `launches_t`.  The forward cuts its contraction
  into `forward_launch_shape(...).split` parts over the β runs so that
  every band fills the card; the parts are added in a fixed order by a
  second small kernel (counted in `launches_sum`), never with atomics.
  The transpose runs one block per (row tile, λ-tile) over the tile's whole
  width, in the instance `transpose_launch_shape` picks (row tile 64 or 32,
  12 / 14 / 16 column groups of 8, or the general instance).
* `wblur_banded_by_runs` — the forward spelled run by run in plain torch,
  in the order the kernel sums: what "the sums repeat bit for bit" means;
  `wblur_banded_t_by_tiles` — the transpose spelled λ-tile by λ-tile from
  the kernel's own operands (`blocks_t`, `starts_t`, runs of TL at stride W).
* `wblur_banded` / `wblur_banded_t` — the dispatch: a CPU tensor takes the
  plain version, a CUDA tensor launches the kernel or raises.  Never a
  fallback.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from .wblur import rows_table

launches = 0  # forward kernel launches since the last reset_launches()
launches_sum = 0  # launches of the forward's add-the-parts kernel (split > 1)
launches_t = 0  # transpose kernel launches since the last reset_launches()

# the forward kernel's tile (csrc/wblur_banded.cu: kFBM, kFBN, kFBK)
FWD_BM, FWD_BN, FWD_BK = 64, 128, 8
FWD_MAX_SPLIT = 16
H100_SMS = 132
# the split's cost model, in contraction steps of FWD_BK terms (forward_launch_shape)
FWD_BLOCK_COST = 16  # a block's fixed cost
FWD_PART_COST = 2  # the second pass, per part
FWD_SHARED_RATE = (1.0, 1.0, 1.2)  # throughput of 1, 2, 3 blocks sharing an SM, one alone = 1
# the transpose kernel's instances (csrc/wblur_banded.cu): rows per block,
# column groups of 8 columns; the general instance takes any table
T_BMS = (64, 32)
T_CGS = (12, 14, 16)
T_GENERAL = (64, 16)


def reset_launches() -> None:
    global launches, launches_sum, launches_t
    launches = 0
    launches_sum = 0
    launches_t = 0


def _support(wpsf: np.ndarray, eps: float, rel_eps: float) -> np.ndarray:
    thresh = max(eps, rel_eps * float(np.abs(wpsf).max()))
    return np.abs(wpsf).max(axis=2) > thresh  # [K, W]


@dataclass(frozen=True)
class BandPlan:
    """Forward banded plan of one wpsf [K, W, B] (reference `BandPlan`
    without its blocked f32 table)."""

    starts: np.ndarray  # int32 [nT] λ offset of each λ'-tile's band
    K: int
    W: int
    B: int
    Bp: int  # β rounded up to 8 (the reference's padding; sets nothing here)
    LB: int  # band length
    TK: int  # λ' tile

    @property
    def n_tiles(self) -> int:
        return int(self.starts.shape[0])

    @property
    def density(self) -> float:
        """Banded fraction of the dense contraction."""
        return self.LB / max(self.W, 1)

    def mask(self) -> np.ndarray:
        """bool [K, W]: the wpsf entries the forward keeps."""
        s = self.starts.astype(np.int64)[np.arange(self.K) // self.TK][:, None]
        l = np.arange(self.W)[None, :]
        return (l >= s) & (l < s + self.LB)


def build_band_plan(wpsf, tile_k: int = 128, eps: float = 0.0, rel_eps: float = 0.0) -> BandPlan:
    """The reference's `build_band_plan` (wblur_pallas.py:54-99): support
    above max(eps, rel_eps·max|wpsf|), per-tile band start, LB → multiple of
    8 (≤ W), starts clamped so every band lies inside the window."""
    wpsf = np.asarray(wpsf)
    K, W, B = wpsf.shape
    nT = -(-K // tile_k)
    K_pad = nT * tile_k
    support = _support(wpsf, eps, rel_eps)
    lo = np.full(K_pad, W, np.int64)
    hi = np.full(K_pad, 0, np.int64)
    any_k = support.any(axis=1)
    lo[:K][any_k] = support.argmax(axis=1)[any_k]
    hi[:K][any_k] = W - support[:, ::-1].argmax(axis=1)[any_k]
    starts = np.zeros(nT, np.int64)
    LB = 1
    for t in range(nT):
        ks = slice(t * tile_k, (t + 1) * tile_k)
        s = int(lo[ks].min()) if (lo[ks] < W).any() else 0
        e = int(hi[ks].max())
        starts[t] = min(s, max(W - 1, 0))
        LB = max(LB, e - s)
    LB = min(W, -(-LB // 8) * 8)
    starts = np.minimum(starts, max(W - LB, 0))
    Bp = -(-B // 8) * 8
    return BandPlan(starts.astype(np.int32), K, W, B, Bp, LB, tile_k)


@dataclass(frozen=True)
class BandPlanT:
    """Transpose banded plan of one wpsf [K, W, B] (reference `BandPlanT`
    without its blocked f32 table)."""

    starts: np.ndarray  # int32 [nT] λ' offset of each λ-tile's band
    K: int
    W: int
    B: int
    Bp: int
    TL: int  # λ rows per tile
    KB: int  # λ' band length

    @property
    def n_tiles(self) -> int:
        return int(self.starts.shape[0])

    @property
    def density(self) -> float:
        return min(self.KB, self.K) / max(self.K, 1)

    def mask(self) -> np.ndarray:
        """bool [K, W]: the wpsf entries the transpose keeps."""
        s = self.starts.astype(np.int64)[np.arange(self.W) // self.TL][None, :]
        k = np.arange(self.K)[:, None]
        return (k >= s) & (k < s + self.KB)


def build_band_plan_t(wpsf, eps: float = 0.0, rel_eps: float = 0.0) -> BandPlanT:
    """The reference's `build_band_plan_t` (wblur_pallas.py:182-224): TL =
    128 // Bp, per-λ-tile λ' band start, KB → multiple of 128 (may exceed K:
    the slab then runs past the end and reads zeros)."""
    wpsf = np.asarray(wpsf)
    K, W, B = wpsf.shape
    Bp = -(-B // 8) * 8
    TL = max(1, 128 // Bp)
    nT = -(-W // TL)
    support = _support(wpsf, eps, rel_eps)
    lo = np.full(W, K, np.int64)
    hi = np.full(W, 0, np.int64)
    any_l = support.any(axis=0)
    lo[any_l] = support.argmax(axis=0)[any_l]
    hi[any_l] = K - support[::-1, :].argmax(axis=0)[any_l]
    starts = np.zeros(nT, np.int64)
    KB = 8
    for t in range(nT):
        ls = slice(t * TL, min((t + 1) * TL, W))
        s = int(lo[ls].min()) if (lo[ls] < K).any() else 0
        e = int(hi[ls].max())
        starts[t] = min(s, max(K - 1, 0))
        KB = max(KB, e - s)
    KB = -(-KB // 128) * 128
    starts = np.maximum(np.minimum(starts, max(K - KB, 0)), 0)
    return BandPlanT(starts.astype(np.int32), K, W, B, Bp, TL, KB)


@dataclass(frozen=True)
class BandedTables:
    """Device tables of one channel's banded pair.

    blocks   [nT, B·LB, TK]     forward block of tile t: row b·LB + j is λ = starts[t] + j
    blocks_t [nT_t, KB, B·TL]   transpose block of tile t: column b·TL + j is λ = t·TL + j
    rows / rows_t [K, B·W]      the forward / transpose masked wpsf, row layout
    """

    plan: BandPlan
    plan_t: BandPlanT
    starts: Any
    starts_t: Any
    blocks: Any
    blocks_t: Any
    rows: Any
    rows_t: Any


def banded_tables(wpsf: torch.Tensor, plan: BandPlan, plan_t: BandPlanT) -> BandedTables:
    """Both plans' tables from wpsf [K, W, B] (on its device, in its dtype)."""
    K, W, B = wpsf.shape
    if (plan.K, plan.W, plan.B) != (K, W, B) or (plan_t.K, plan_t.W, plan_t.B) != (K, W, B):
        raise ValueError(f"band plans do not match wpsf {tuple(wpsf.shape)}")
    dev = wpsf.device

    def idx(a):
        return torch.as_tensor(np.asarray(a, np.int64), device=dev)

    # forward blocks: wpsf[t·TK + i, starts[t] + j, b] at [t, b·LB + j, i]
    nT, TK, LB = plan.n_tiles, plan.TK, plan.LB
    wk = torch.cat([wpsf, wpsf.new_zeros((nT * TK - K, W, B))])  # partial last tile → zero rows
    kk = idx(np.arange(nT * TK).reshape(nT, TK, 1))
    ll = idx(plan.starts[:, None, None] + np.arange(LB)[None, None, :])
    blocks = wk[kk, ll]  # [nT, TK, LB, B]
    blocks = blocks.permute(0, 3, 2, 1).reshape(nT, B * LB, TK).contiguous()

    # transpose blocks: wpsf[starts_t[t] + c, t·TL + j, b] at [t, c, b·TL + j],
    # zero where the slab runs past K or the tile past W
    nTt, TL, KB = plan_t.n_tiles, plan_t.TL, plan_t.KB
    k_need = int(plan_t.starts.max()) + KB
    l_need = nTt * TL
    wt = torch.zeros((max(K, k_need), max(W, l_need), B), dtype=wpsf.dtype, device=dev)
    wt[:K, :W] = wpsf
    kk = idx(plan_t.starts[:, None, None] + np.arange(KB)[None, :, None])
    ll = idx(np.arange(l_need).reshape(nTt, 1, TL))
    blocks_t = wt[kk, ll]  # [nTt, KB, TL, B]
    blocks_t = blocks_t.permute(0, 1, 3, 2).reshape(nTt, KB, B * TL).contiguous()

    def masked_rows(mask):
        return rows_table(wpsf * torch.as_tensor(mask, device=dev)[:, :, None])

    return BandedTables(
        plan, plan_t,
        torch.as_tensor(plan.starts, dtype=torch.int32, device=dev),
        torch.as_tensor(plan_t.starts, dtype=torch.int32, device=dev),
        blocks, blocks_t, masked_rows(plan.mask()), masked_rows(plan_t.mask()),
    )


# ---------------------------------------------------------------------------
# plain versions


def wblur_banded_reference(win: torch.Tensor, bt: BandedTables) -> torch.Tensor:
    """win [S·A, B·W] → [S·A, K] against the forward-masked table."""
    return win @ bt.rows.T


def wblur_banded_t_reference(y2d: torch.Tensor, bt: BandedTables) -> torch.Tensor:
    """y2d [S·A, K] → [S·A, B·W] against the transpose-masked table."""
    return y2d @ bt.rows_t


def wblur_banded_by_runs(win: torch.Tensor, bt: BandedTables, split: int) -> torch.Tensor:
    """The forward in the forward kernel's order of summation: per λ'-tile
    one product per β run (LB window columns from ``b·W + starts[t]``
    against rows ``b·LB ...`` of the tile's block), the runs of a part added
    in order, the `split` parts added in order.  Any device, any dtype."""
    p = bt.plan
    starts = [int(s) for s in p.starts]
    out = None
    for run0, run1 in forward_runs(p.B, split):
        part = win.new_zeros((win.shape[0], p.n_tiles * p.TK))
        for t, s in enumerate(starts):
            acc = part[:, t * p.TK:(t + 1) * p.TK]
            for b in range(run0, run1):
                acc += win[:, b * p.W + s:b * p.W + s + p.LB] @ bt.blocks[t, b * p.LB:(b + 1) * p.LB]
        out = part if out is None else out + part
    return out[:, :p.K]


def wblur_banded_t_by_tiles(y2d: torch.Tensor, bt: BandedTables) -> torch.Tensor:
    """The transpose from the transpose kernel's own operands: per λ-tile t
    one product of the slab of KB input columns from ``starts_t[t]`` (zeros
    past K) with the tile's block ``blocks_t[t] [KB, B·TL]``, its B·TL result
    columns written to B runs of TL columns at stride W (the last tile only
    its columns below W).  Any device, any dtype."""
    p = bt.plan_t
    m = y2d.shape[0]
    reach = max(int(p.starts.max()) + p.KB, p.K)
    ypad = torch.cat([y2d, y2d.new_zeros((m, reach - p.K))], dim=1)
    out = y2d.new_zeros((m, p.B, p.W))
    for t, s in enumerate(int(s) for s in p.starts):
        runs = (ypad[:, s:s + p.KB] @ bt.blocks_t[t]).view(m, p.B, p.TL)
        l0 = t * p.TL
        l1 = min(l0 + p.TL, p.W)
        out[:, :, l0:l1] = runs[:, :, :l1 - l0]
    return out.view(m, p.B * p.W)


# ---------------------------------------------------------------------------
# the forward kernel's launch shape


def forward_runs(b: int, split: int) -> tuple:
    """The β runs [run0, run1) of each of the `split` parts: 0..B−1 once, in
    order, sizes differing by at most one (the kernel computes the same)."""
    if not 1 <= split <= b:
        raise ValueError(f"split {split} is not in 1..B={b}")
    return tuple((z * b // split, (z + 1) * b // split) for z in range(split))


@dataclass(frozen=True)
class ForwardShape:
    """How one forward launch is cut: grid (row tiles of 64, λ'-tiles ×
    column blocks of 128, split) and the scratch floats it needs."""

    split: int
    grid: tuple
    runs: tuple
    scratch: int  # floats of the [split, M, K] partial sums; 0 when split = 1

    @property
    def blocks(self) -> int:
        return self.grid[0] * self.grid[1] * self.grid[2]


def forward_shape(m: int, plan: BandPlan, split: int) -> ForwardShape:
    """The launch of `m` rows with the contraction cut into `split` parts."""
    grid = (-(-m // FWD_BM), plan.n_tiles * -(-plan.TK // FWD_BN), split)
    return ForwardShape(split, grid, forward_runs(plan.B, split),
                        split * m * plan.K if split > 1 else 0)


def forward_launch_shape(m: int, plan: BandPlan, n_sm: int = H100_SMS) -> ForwardShape:
    """Pick the split of the contraction over the B runs for `m` rows.

    Unsplit, a band gives ⌈M/64⌉ · nT blocks (30–77 on the flagship) for
    `n_sm` SMs, each block summing all B·LB terms.  Among the splits that
    give at least `n_sm` blocks (all splits, if none does) take the one with
    the least estimated time, in contraction steps: the blocks the busiest
    SM gets, n = ⌈blocks / n_sm⌉, times the steps of the longest part plus
    a fixed cost per block (pipeline fill, the store), over the throughput
    n blocks sharing an SM reach relative to one alone, plus the second
    pass's cost per part; ties go to the smaller split.  The constants are
    fitted to `scripts/torch_kernel_sweep.py` on the H100: over the
    flagship's bands the pick is 3 % above the best split's time on
    average, 15 % at most."""
    base = -(-m // FWD_BM) * plan.n_tiles * -(-plan.TK // FWD_BN)
    return forward_shape(m, plan, _pick_split(base, plan.B, -(-plan.LB // FWD_BK), n_sm))


@functools.lru_cache(maxsize=None)
def _pick_split(base: int, b: int, steps: int, n_sm: int) -> int:
    cands = range(1, min(b, FWD_MAX_SPLIT) + 1)
    full = [s for s in cands if base * s >= n_sm]

    def cost(s):
        n = -(-base * s // n_sm)
        rate = FWD_SHARED_RATE[min(n, len(FWD_SHARED_RATE)) - 1]
        return n * (-(-b // s) * steps + FWD_BLOCK_COST) / rate + FWD_PART_COST * s * (s > 1), s

    return min(full or cands, key=cost)


# ---------------------------------------------------------------------------
# the transpose kernel's launch shape


@dataclass(frozen=True)
class TransposeShape:
    """The instance of one transpose launch: a block is `bm` rows × 8·`cg`
    columns of one λ-tile, BM/8 · CG threads; `vec`: 16-byte copies of the
    table; grid (row tiles, λ-tiles × column blocks)."""

    bm: int
    cg: int
    vec: bool
    grid: tuple

    @property
    def blocks(self) -> int:
        return self.grid[0] * self.grid[1]

    @property
    def threads(self) -> int:
        return self.bm // 8 * self.cg


def transpose_shape(m: int, plan_t: BandPlanT, bm: int, cg: int, vec: bool = True) -> TransposeShape:
    """The launch of `m` rows in the instance (`bm`, `cg`, `vec`)."""
    n = plan_t.B * plan_t.TL
    if vec:
        if bm not in T_BMS or cg not in T_CGS:
            raise ValueError(f"no transpose instance bm={bm}, cg={cg}")
        if n % 4 or n > 8 * cg:
            raise ValueError(f"a tile's {n} columns are no multiple of 4 within {8 * cg}")
    elif (bm, cg) != T_GENERAL:
        raise ValueError(f"the general transpose instance is bm, cg = {T_GENERAL}")
    return TransposeShape(bm, cg, vec, (-(-m // bm), plan_t.n_tiles * -(-n // (8 * cg))))


def transpose_launch_shape(m: int, plan_t: BandPlanT, n_sm: int = H100_SMS,
                           aligned: bool = True) -> TransposeShape:
    """Pick the transpose kernel's instance for `m` rows.

    A tile's n = B·TL columns (≤ 128 whenever B ≤ 128) go to one block: the
    least of 12 / 14 / 16 column groups of 8 that holds them, so that n = 96
    and n = 108 do not pay for 128 columns.  That needs rows of the table
    that start on 16 bytes: n a multiple of 4 and an `aligned` base; any
    other table (and n > 128) takes the general instance, 64 × 128 with
    4-byte copies and column blocks.  Rows per block, 64 or 32: every warp
    of either instance does the same work (8 × 8 outputs a lane over the
    slab) and the warps of an SM share its shared-memory bandwidth, so the
    time follows the warps the busiest SM gets, ⌈blocks / n_sm⌉ · ⌈threads /
    32⌉ (a block of 96 columns × 32 rows is 48 threads and leaves half a
    warp idle); ties go to the fewer padded rows.  Fitted to
    `scripts/torch_kernel_sweep.py` on the H100 at the flagship's M = 336–408."""
    n = plan_t.B * plan_t.TL
    if n % 4 or n > 8 * max(T_CGS) or not aligned:
        return transpose_shape(m, plan_t, *T_GENERAL, vec=False)
    cg = next(c for c in T_CGS if n <= 8 * c)

    def cost(bm):
        blocks = -(-m // bm) * plan_t.n_tiles
        return -(-blocks // n_sm) * -(-(bm // 8 * cg) // 32), -(-m // bm) * bm

    return transpose_shape(m, plan_t, min(T_BMS, key=cost), cg)


# ---------------------------------------------------------------------------
# the kernels

_fns = None


def load_kernels():
    """Build (first call) and bind both kernels' C entry points."""
    global _fns
    if _fns is None:
        from ._build import build_library

        lib = build_library("wblur_banded", ["wblur_banded.cu"])
        fns = []
        for name, n_ptr, n_int in (("surfh_wblur_banded_f32", 5, 8),
                                   ("surfh_wblur_banded_t_f32", 4, 10)):
            fn = getattr(lib, name)
            fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
            fns.append(fn)
        _fns = tuple(fns)
    return _fns


def _check(x: torch.Tensor, shape, bt: BandedTables, what: str) -> None:
    if not x.is_cuda:
        raise ValueError(f"{what} needs a CUDA tensor")
    if x.dtype != torch.float32:
        raise TypeError(f"{what} is f32 only (got {x.dtype})")
    if x.dim() != 2 or x.shape[1] != shape:
        raise ValueError(f"{what}: input {tuple(x.shape)} is not [S·A, {shape}]")
    if not x.is_contiguous():
        raise ValueError(f"{what} needs a contiguous input")
    for name in ("blocks", "blocks_t", "starts", "starts_t"):
        a = getattr(bt, name)
        if a.device != x.device or not a.is_contiguous():
            raise ValueError(f"tables.{name} must be contiguous on {x.device}")
    if bt.blocks.dtype != torch.float32 or bt.blocks_t.dtype != torch.float32:
        raise TypeError(f"{what}: tables must be f32 (got {bt.blocks.dtype})")


def _launch(fn, args, device) -> None:
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"wblur_banded kernel launch failed: cudaError {err}")


@functools.lru_cache(maxsize=None)
def _sm_count(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _forward_launch(win: torch.Tensor, bt: BandedTables, shape: ForwardShape) -> torch.Tensor:
    """Launch the forward kernel cut as `shape` says (and, for split > 1,
    the kernel that adds the parts)."""
    p = bt.plan
    _check(win, p.B * p.W, bt, "wblur_banded kernel")
    if p.TK % 4:
        raise ValueError(f"wblur_banded kernel needs a λ' tile that is a multiple of 4 (got {p.TK})")
    m = int(win.shape[0])
    out = torch.empty((m, p.K), device=win.device, dtype=torch.float32)
    parts = torch.empty(shape.scratch, device=win.device, dtype=torch.float32)
    _launch(load_kernels()[0],
            (win.data_ptr(), bt.blocks.data_ptr(), bt.starts.data_ptr(), out.data_ptr(),
             parts.data_ptr() if shape.split > 1 else None,
             m, p.W, p.B, p.K, p.n_tiles, p.LB, p.TK, shape.split), win.device)
    global launches, launches_sum
    launches += 1
    launches_sum += shape.split > 1
    return out


def wblur_banded_cuda(win: torch.Tensor, bt: BandedTables) -> torch.Tensor:
    """The forward kernel: f32 win [S·A, B·W] → [S·A, K] on the current stream."""
    return _forward_launch(win, bt, forward_launch_shape(int(win.shape[0]), bt.plan,
                                                         _sm_count(win.device)))


def _transpose_launch(y2d: torch.Tensor, bt: BandedTables, shape: TransposeShape) -> torch.Tensor:
    """Launch the transpose kernel in the instance `shape` names."""
    p = bt.plan_t
    _check(y2d, p.K, bt, "wblur_banded_t kernel")
    out = torch.empty((y2d.shape[0], p.B * p.W), device=y2d.device, dtype=torch.float32)
    _launch(load_kernels()[1],
            (y2d.data_ptr(), bt.blocks_t.data_ptr(), bt.starts_t.data_ptr(), out.data_ptr(),
             int(y2d.shape[0]), p.W, p.B, p.K, p.n_tiles, p.TL, p.KB,
             shape.bm, shape.cg, int(shape.vec)), y2d.device)
    global launches_t
    launches_t += 1
    return out


def wblur_banded_t_cuda(y2d: torch.Tensor, bt: BandedTables) -> torch.Tensor:
    """The transpose kernel: f32 y2d [S·A, K] → [S·A, B·W] on the current stream."""
    return _transpose_launch(y2d, bt, transpose_launch_shape(
        int(y2d.shape[0]), bt.plan_t, _sm_count(y2d.device), bt.blocks_t.data_ptr() % 16 == 0))


def wblur_banded(win: torch.Tensor, bt: BandedTables) -> torch.Tensor:
    """Dispatch: plain version for a CPU tensor, the kernel for a CUDA one."""
    if win.is_cuda:
        return wblur_banded_cuda(win, bt)
    if win.device.type == "cpu":
        return wblur_banded_reference(win, bt)
    raise ValueError(f"wblur_banded: unsupported device {win.device}")


def wblur_banded_t(y2d: torch.Tensor, bt: BandedTables) -> torch.Tensor:
    """Dispatch: plain version for a CPU tensor, the kernel for a CUDA one."""
    if y2d.is_cuda:
        return wblur_banded_t_cuda(y2d, bt)
    if y2d.device.type == "cpu":
        return wblur_banded_t_reference(y2d, bt)
    raise ValueError(f"wblur_banded_t: unsupported device {y2d.device}")
