"""The launch shapes that the port's wrappers choose for its redesigned
kernels, and the order in which the banded forward sums (CPU, pure Python /
plain torch; the kernels themselves: test_torch_kernels_cuda.py).

* `wblur_banded.forward_launch_shape` on the twelve bands of the flagship at
  wblur_band_rtol 1e-4 (S·A, K, W, β width, band length, λ'-tiles as the
  port's plans give them at full width) and on test-size plans: the runs of
  the parts cover 0..B−1 once and in order, the grid fills the card wherever
  B allows, the scratch is what the wrapper allocates;
* `wblur_banded.transpose_launch_shape` on the same bands and on tables the
  fast instances do not take: the instance, the grid, every output column
  written by exactly one block;
* `gather_rows.gather_launch_shape` over the row widths of both solve paths,
  and that K2's wrapper launches in that shape from the plan's host-side
  tap count;
* `wblur_banded_by_runs`, the forward summed run by run and part by part as
  the kernel does, against `wblur_banded_reference` in f64 (≤ 1e-12).
"""

import numpy as np
import pytest
import torch

from surfh_tpu_torch.core import gather_fixed as gf
from surfh_tpu_torch.core import gather_rows as gr
from surfh_tpu_torch.core import wblur_banded as wb

torch.set_num_threads(2)

# band: S·A, K, W, B, LB, λ'-tiles
FLAGSHIP = {
    "1a": (399, 1050, 425, 8, 128, 9), "1b": (399, 1213, 564, 8, 144, 10),
    "1c": (399, 1400, 613, 8, 136, 11), "2a": (408, 970, 475, 12, 160, 8),
    "2b": (408, 1124, 484, 12, 136, 9), "2c": (408, 1300, 524, 12, 128, 11),
    "3a": (400, 769, 352, 16, 144, 7), "3b": (400, 892, 364, 16, 120, 7),
    "3c": (400, 1028, 399, 16, 120, 9), "4a": (336, 542, 252, 27, 128, 5),
    "4b": (336, 632, 241, 27, 112, 5), "4c": (336, 717, 249, 27, 112, 6),
}
# test-size plans: one block, B = 1, a window shorter than a step, B prime
SMALL = {
    "one_block": (21, 200, 120, 6, 16, 2), "b1": (21, 40, 6, 1, 6, 1),
    "w_below_8": (21, 40, 6, 3, 6, 1), "b_prime": (391, 300, 90, 5, 24, 3),
}


def _plan(K, W, B, LB, nT):
    starts = np.minimum(np.round(np.linspace(0, W - LB, nT)).astype(np.int64) | 1, W - LB)
    return wb.BandPlan(starts.astype(np.int32), K, W, B, -(-B // 8) * 8, LB, 128)


@pytest.mark.parametrize("name", list(FLAGSHIP) + list(SMALL))
def test_forward_launch_shape(name):
    m, K, W, B, LB, nT = {**FLAGSHIP, **SMALL}[name]
    plan = _plan(K, W, B, LB, nT)
    assert plan.n_tiles == nT
    shape = wb.forward_launch_shape(m, plan)
    assert 1 <= shape.split <= min(B, wb.FWD_MAX_SPLIT)
    # the parts' runs: 0..B−1 once, in order, none empty, sizes within one
    assert shape.runs == wb.forward_runs(B, shape.split)
    assert [b for r0, r1 in shape.runs for b in range(r0, r1)] == list(range(B))
    sizes = [r1 - r0 for r0, r1 in shape.runs]
    assert min(sizes) >= 1 and max(sizes) - min(sizes) <= 1
    # the grid: 64-row tiles × λ'-tiles × parts; the card is full wherever B allows
    assert shape.grid == (-(-m // wb.FWD_BM), nT, shape.split)
    assert shape.blocks == shape.grid[0] * nT * shape.split
    if shape.grid[0] * nT * min(B, wb.FWD_MAX_SPLIT) >= wb.H100_SMS:
        assert shape.blocks >= wb.H100_SMS
    # the scratch the wrapper allocates: the parts' [split, M, K], none unsplit
    assert shape.scratch == (shape.split * m * K if shape.split > 1 else 0)
    if name in FLAGSHIP:
        assert shape.split > 1 and shape.blocks >= wb.H100_SMS


def test_forward_launch_shape_follows_the_sm_count():
    m, K, W, B, LB, nT = FLAGSHIP["2c"]
    plan = _plan(K, W, B, LB, nT)
    assert wb.forward_launch_shape(m, plan, n_sm=8).split == 1  # 77 blocks fill 8 SMs unsplit
    big = wb.forward_launch_shape(m, plan, n_sm=528)
    assert big.blocks >= 528 and big.split >= 7


@pytest.mark.parametrize("b, split", [(1, 1), (8, 3), (12, 12), (27, 7), (27, 16)])
def test_forward_runs(b, split):
    runs = wb.forward_runs(b, split)
    assert len(runs) == split and runs[0][0] == 0 and runs[-1][1] == b
    assert all(a[1] == c[0] for a, c in zip(runs, runs[1:]))
    # the kernel's own arithmetic: part z takes [z·B / split, (z + 1)·B / split)
    assert runs == tuple((z * b // split, (z + 1) * b // split) for z in range(split))
    for bad in (0, b + 1):
        with pytest.raises(ValueError):
            wb.forward_runs(b, bad)


@pytest.mark.parametrize("q, aligned, taps_per_row, want", [
    (1, True, 1.0, (1, 1, 4, 1)), (3, True, 1.0, (1, 1, 4, 3)),  # narrow rows: a lane per column
    (24, True, 1.2, (4, 1, 4, 6)), (24, False, 23.0, (1, 1, 4, 24)),  # the rank path, Q = 4R
    (40, True, 1.0, (4, 1, 4, 10)), (40, False, 1.0, (1, 8, 2, 8)), (40, False, 17.0, (1, 4, 4, 16)),
    (241, True, 1.2, (1, 8, 2, 32)), (252, True, 1.2, (4, 2, 2, 32)),  # ≤ 256 floats: 8 per lane
    (466, True, 1.0, (1, 16, 1, 32)), (466, False, 1.0, (1, 16, 1, 32)),  # W ≡ 2 mod 4: single floats
    (564, True, 1.0, (4, 6, 1, 32)), (564, False, 1.0, (1, 24, 1, 32)),
    (613, True, 1.0, (1, 24, 1, 32)), (1000, True, 1.0, (4, 6, 1, 32)),  # wider than 768: chunks of 24 floats a lane
    (613, True, 16.8, (1, 4, 4, 32)), (252, True, 23.1, (4, 1, 4, 32)),  # many taps a row: chunks of 128 floats
])
def test_gather_launch_shape(q, aligned, taps_per_row, want):
    vec, cols, taps, group = gr.gather_launch_shape(q, aligned, taps_per_row)
    assert (vec, cols, taps, group) == want
    nvec = q // vec
    assert q % vec == 0 and (vec == 1 or aligned) and 1 <= group <= 32
    if nvec <= 32:  # the narrow kernel: whole rows, a lane per column
        assert (cols, taps, group) == (1, gr._NARROW_TAPS, nvec)
    else:  # an instance the wide kernel has, a power-of-two group with no idle half
        assert (vec * cols, taps) in {gr._MANY_TAPS_SHAPE, *gr._LANE_FLOATS.items()}
        assert group & (group - 1) == 0 and cols * (group // 2) < nvec
        # few taps a row: one chunk wherever 32 lanes of the widest instance can cover the row
        if taps_per_row < gr._MANY_TAPS and q <= 32 * max(gr._LANE_FLOATS):
            assert cols * group >= nvec
    with pytest.raises(ValueError):
        gr.gather_launch_shape(0)


@pytest.mark.parametrize("name", ["2b_narrow", "b_prime", "w_below_8", "b1"])
def test_forward_by_runs_is_the_masked_product(name):
    """f64: summing run by run, part by part (the kernel's order) gives the
    plain version's masked product, for every split."""
    m, K, W, B, LB, nT = {**SMALL, "2b_narrow": (23, 300, 121, 12, 40, 3)}[name]
    rng = np.random.default_rng(3)
    plan = _plan(K, W, B, LB, nT)
    wpsf = rng.uniform(0.5, 1.5, (K, W, B)) * plan.mask()[:, :, None]
    bt = wb.banded_tables(torch.as_tensor(wpsf), plan, wb.build_band_plan_t(wpsf))
    win = torch.as_tensor(rng.standard_normal((m, B * W)))
    want = wb.wblur_banded_reference(win, bt)
    for split in range(1, min(B, wb.FWD_MAX_SPLIT) + 1):
        got = wb.wblur_banded_by_runs(win, bt, split)
        assert got.shape == want.shape
        assert float((got - want).abs().max() / want.abs().max()) <= 1e-12


def _plan_t(K, W, B, KB=256):
    Bp = -(-B // 8) * 8
    TL = max(1, 128 // Bp)
    nT = -(-W // TL)
    starts = np.round(np.linspace(0, max(K - KB, 0), nT)).astype(np.int32)
    return wb.BandPlanT(starts, K, W, B, Bp, TL, KB)


# tables of the small problems and of no flagship band: M, K, W, B
SMALL_T = {
    "b1": (21, 40, 6, 1), "b5": (391, 300, 90, 5), "b20_tl5": (70, 300, 61, 20),
    "b33_tl3": (391, 200, 61, 33), "b130_tl1": (21, 200, 9, 130),
}
# per flagship channel: TL, n = B·TL, column groups; per band on 132 SMs: the row tile
FLAGSHIP_T = {"1": (16, 128, 16), "2": (8, 96, 12), "3": (8, 128, 16), "4": (4, 108, 14)}
FLAGSHIP_BM = {"1a": 32, "1b": 32, "1c": 32, "2a": 32, "2b": 64, "2c": 64,
               "3a": 32, "3b": 32, "3c": 32, "4a": 32, "4b": 32, "4c": 32}


@pytest.mark.parametrize("name", list(FLAGSHIP) + list(SMALL_T))
def test_transpose_launch_shape(name):
    if name in FLAGSHIP:
        m, K, W, B = FLAGSHIP[name][:4]
    else:
        m, K, W, B = SMALL_T[name]
    plan_t = _plan_t(K, W, B)
    n = B * plan_t.TL
    shape = wb.transpose_launch_shape(m, plan_t)
    # the instance: 16-byte copies of the table need rows of a multiple of 4
    # floats within one block; the least column width that holds the tile
    if n % 4 or n > 128:
        assert (shape.bm, shape.cg, shape.vec) == (*wb.T_GENERAL, False)
    else:
        assert shape.vec and shape.bm in wb.T_BMS and shape.cg in wb.T_CGS
        assert shape.cg == min(c for c in wb.T_CGS if n <= 8 * c)
    assert shape == wb.transpose_shape(m, plan_t, shape.bm, shape.cg, shape.vec)
    assert shape.threads == shape.bm // 8 * shape.cg and shape.threads % 8 == 0
    col_blocks = -(-n // (8 * shape.cg))
    assert shape.grid == (-(-m // shape.bm), plan_t.n_tiles * col_blocks)
    assert shape.blocks == shape.grid[0] * shape.grid[1]
    if name in FLAGSHIP:
        tl, n_want, cg = FLAGSHIP_T[name[0]]
        assert (plan_t.TL, n, shape.cg, col_blocks) == (tl, n_want, cg, 1)
        assert shape.bm == FLAGSHIP_BM[name] and shape.blocks >= wb.H100_SMS
        # the busiest SM's warps: no more than the other row tile would give it
        other = wb.transpose_shape(m, plan_t, 96 - shape.bm, shape.cg)
        busiest = [-(-sh.blocks // wb.H100_SMS) * -(-sh.threads // 32) for sh in (shape, other)]
        assert busiest[0] <= busiest[1]
    # the kernel's store: column j of block (t, cb) is run j // TL, position
    # t·TL + j % TL; every output column is written exactly once
    cols = []
    for t in range(plan_t.n_tiles):
        for cb in range(col_blocks):
            j = np.arange(cb * 8 * shape.cg, min((cb + 1) * 8 * shape.cg, n))
            pos = t * plan_t.TL + j % plan_t.TL
            cols.append((j // plan_t.TL * W + pos)[pos < W])
    assert sorted(np.concatenate(cols).tolist()) == list(range(B * W))


def test_transpose_launch_shape_follows_the_sm_count_and_the_alignment():
    m, K, W, B = FLAGSHIP["2c"][:4]
    plan_t = _plan_t(K, W, B)
    # 462 blocks of 3 warps or 858 of 2 (48 threads: half a warp idle)
    assert wb.transpose_launch_shape(m, plan_t, n_sm=132).bm == 64  # 4 · 3 warps against 7 · 2
    assert wb.transpose_launch_shape(m, plan_t, n_sm=429).bm == 32  # 2 · 3 against 2 · 2
    off = wb.transpose_launch_shape(m, plan_t, aligned=False)
    assert (off.bm, off.cg, off.vec) == (*wb.T_GENERAL, False)
    for bad in ((48, 12, True), (64, 8, True), (32, 16, False)):  # no such instance
        with pytest.raises(ValueError):
            wb.transpose_shape(m, plan_t, *bad)
    with pytest.raises(ValueError):  # 128 columns do not fit 96
        wb.transpose_shape(FLAGSHIP["1a"][0], _plan_t(*FLAGSHIP["1a"][1:4]), 64, 12)


@pytest.mark.parametrize("W, aligned", [(13, True), (52, True), (52, False), (241, True),
                                        (466, True), (484, True), (484, False), (613, True)])
def test_k2_launches_in_the_gather_launch_shape(monkeypatch, W, aligned):
    """K2's wrapper takes `gather_launch_shape`'s shape for (W, the bases'
    alignment, the plan's taps per row), the taps per row from the number
    the host fixed when it built the plan: the launch reads nothing of the
    table (here there is no `cnt` to read)."""
    import dataclasses

    rng = np.random.default_rng(W)
    n_rows, n_src = 200, 50
    cdst = np.sort(rng.integers(0, n_rows, 260))
    plan = gf.build_fixed_fanin_plan(rng.integers(0, n_src, 260), rng.uniform(0.5, 1.5, 260), cdst,
                                     n_rows, n_src, 8, ld=W)
    assert plan.nnz == 260 == int(plan.cnt.sum())
    dplan = plan.to("cpu", torch.float32)
    assert isinstance(dplan.nnz, int) and dplan.nnz == 260  # carried through .to()
    assert dplan.to("cpu", torch.float64).nnz == 260
    store = torch.zeros(n_src * W + 4)
    src = store[:n_src * W].view(n_src, W) if aligned else store[1:n_src * W + 1].view(n_src, W)
    seen = []
    monkeypatch.setattr(gf, "_check", lambda *a, **k: None)
    monkeypatch.setattr(gf, "_launch_k2", lambda src, plan, out, *shape: seen.append((shape, out)))
    out = gf.gather_fixed_k2_cuda(src, dataclasses.replace(dplan, cnt=None))
    (shape, launched_out), = seen
    assert launched_out is out and tuple(out.shape) == (n_rows, W)
    both = src.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0
    assert shape == gr.gather_launch_shape(W, both, 260 / n_rows)
    if not aligned:
        assert shape[0] == 1  # single floats from a base that is not on 16 bytes


# K1 / K3 (every tap of the padded row) on every band's transpose and at the
# entry point's W = 466: (vec, cols, taps, group) from 16-byte aligned bases
K13_SHAPES = {
    "1a": (1, 16, 1, 32), "1b": (4, 6, 1, 32), "1c": (1, 16, 1, 16), "2a": (1, 16, 1, 32),
    "2b": (4, 4, 1, 32), "2c": (4, 6, 1, 32), "3a": (4, 6, 1, 16), "3b": (4, 6, 1, 16),
    "3c": (1, 16, 1, 32), "4a": (4, 4, 1, 16), "4b": (1, 16, 1, 16), "4c": (1, 16, 1, 16),
    "proto": (2, 8, 1, 32),
}


@pytest.mark.parametrize("align", [16, 4])
@pytest.mark.parametrize("band", list(K13_SHAPES))
def test_k1_k3_launch_shape_on_every_band(monkeypatch, band, align):
    """K1's and K3's wrappers launch in `fixed_launch_shape`'s shape for W
    and the bases' alignment: one tap at a time, one chunk of the row on 16
    lanes where 16 hold it, else on 32 where they do (up to 16 floats a lane,
    24 as float4), else chunks of the widest on 16 lanes (1c: W = 613 at
    single floats); float2 where W is even but not a multiple of 4, from
    8-byte aligned bases; single floats from a base one float into its
    storage.  Pinned on the flagship's widths."""
    W = FLAGSHIP[band][2] if band in FLAGSHIP else 466
    rng = np.random.default_rng(len(band) + W)
    n_rows, n_src = 64, 40
    plan = gf.build_fixed_fanin_plan(rng.integers(0, n_src, 90), rng.uniform(0.5, 1.5, 90),
                                     np.sort(rng.integers(0, n_rows, 90)), n_rows, n_src, 8, ld=W)
    store = torch.zeros(n_src * W + 4)
    src = store[:n_src * W].view(n_src, W) if align == 16 else store[1:n_src * W + 1].view(n_src, W)
    seen = []
    monkeypatch.setattr(gf, "_check", lambda *a, **k: None)
    for launch in ("_launch_k1", "_launch_k3"):
        monkeypatch.setattr(gf, launch, lambda src, plan, out, *shape: seen.append((shape, out)))
    outs = [gf.gather_fixed_k1_cuda(src, plan), gf.gather_fixed_k3_cuda(src, plan)]
    assert [o for _, o in seen] == outs
    both = gf._align(src, *outs)
    want = gf.fixed_launch_shape(W, both)
    assert [s for s, _ in seen] == [want, want]
    if both == 16:
        assert want == K13_SHAPES[band]
    else:
        assert want[0] == 1  # single floats from a base that is not on 8 bytes
    vec, cols, taps, group = want
    nvec, widest = W // vec, gf.FIXED_LANE_FLOATS[vec][-1] // vec
    assert W % vec == 0 and vec * cols in gf.FIXED_LANE_FLOATS[vec] and taps == 1
    if widest * 32 >= nvec:  # one chunk, on 16 lanes where they hold it
        assert cols * group >= nvec and group == (16 if widest * 16 >= nvec else 32)
    else:  # chunks of the widest on 16 lanes
        assert (cols, group) == (widest, 16)
