"""The hand-written CUDA kernels on the card (skipped without one).

No JAX here: these run on the GPU machine, which has none.  Run them there
with ``python -m pytest tests/test_torch_kernels_cuda.py -m cuda``.
"""

import numpy as np
import pytest
import torch

from surfh_tpu_torch.core import gather_rows as gr


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _plan(rng, n_dst, n_src, n_taps, heavy_row, heavy_taps):
    cdst = np.sort(np.concatenate([rng.integers(0, n_dst, n_taps), np.full(heavy_taps, heavy_row)]))
    csrc = rng.integers(0, n_src, cdst.size)
    cw = rng.standard_normal(cdst.size)
    cw[rng.random(cdst.size) < 0.05] = 0.0
    return gr.build_row_gather_plan(csrc, cw, cdst, n_dst, n_src)


@pytest.mark.cuda
@pytest.mark.parametrize("q", [52, 13])  # float4 path and scalar path
def test_gather_rows_kernel_matches_plain(q):
    dev = _cuda()
    rng = np.random.default_rng(6)
    plan = _plan(rng, 3000, 2000, 20000, heavy_row=11, heavy_taps=3000)
    src = torch.as_tensor(rng.standard_normal((2000, q)), dtype=torch.float32, device=dev)
    before = gr.launches
    got = gr.gather_rows(src, plan.to(dev, torch.float32))
    torch.cuda.synchronize()
    assert gr.launches == before + 1
    want = gr.gather_rows_reference(src.double(), plan.to(dev, torch.float64))
    # f32 FMAs over ≤ a few thousand taps against the f64 plain version
    assert float((got.double() - want).abs().max() / want.abs().max()) <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("misaligned", [False, True])
@pytest.mark.parametrize("q", [1, 3, 24, 241, 466, 613, 1000])
def test_gather_rows_kernel_shapes(q, misaligned):
    """Every launch shape (1 to 32 lanes per row, 8 / 16 / 24 floats a lane,
    float4 and single floats, two column chunks at Q = 1000): a third of the
    rows empty, one row with more taps than two chunks of taps, base
    pointers 16-byte aligned or one float into their storage."""
    dev = _cuda()
    rng = np.random.default_rng(q)
    n_dst, n_src = 1501, 700
    live = np.sort(rng.choice(n_dst, size=2 * n_dst // 3, replace=False))
    cdst = np.sort(np.concatenate([np.repeat(live, rng.integers(1, 8, live.size)),
                                   np.full(130, live[7])]))
    csrc = rng.integers(0, n_src, cdst.size)
    cw = rng.standard_normal(cdst.size)
    plan = gr.build_row_gather_plan(csrc, cw, cdst, n_dst, n_src)
    counts = np.diff(plan.row_ptr)
    assert (counts == 0).sum() >= n_dst // 3 and counts.max() > 100
    store = torch.as_tensor(rng.standard_normal(n_src * q + 1), dtype=torch.float32, device=dev)
    src = store[1:].view(n_src, q) if misaligned else store[:-1].view(n_src, q)
    assert src.is_contiguous() and (src.data_ptr() % 16 == 4) == misaligned
    got = gr.gather_rows(src, plan.to(dev, torch.float32))
    torch.cuda.synchronize()
    want = gr.gather_rows_reference(src.double(), plan.to(dev, torch.float64))
    # f32 FMAs over ≤ ~140 taps against the f64 plain version
    assert float((got.double() - want).abs().max() / want.abs().max()) <= 1e-5
    assert not got[torch.as_tensor(counts == 0, device=dev)].any()  # rows with no taps: zero
    assert torch.equal(got, gr.gather_rows(src, plan.to(dev, torch.float32)))  # taps in plan order


@pytest.mark.cuda
def test_gather_rows_kernel_rejects_what_it_does_not_take():
    dev = _cuda()
    plan = _plan(np.random.default_rng(7), 40, 30, 100, 0, 0)
    with pytest.raises(TypeError):
        gr.gather_rows(torch.zeros((30, 8), dtype=torch.float64, device=dev),
                       plan.to(dev, torch.float64))
    with pytest.raises(ValueError):
        gr.gather_rows(torch.zeros((29, 8), device=dev), plan.to(dev, torch.float32))
    with pytest.raises(ValueError):
        gr.gather_rows(torch.zeros((8, 30), device=dev).T, plan.to(dev, torch.float32))


@pytest.mark.cuda
def test_small_model_on_card_matches_cpu_f64():
    from surfh_tpu_torch.simulation.synthetic import make_model

    dev = _cuda()
    model, setup = make_model(im_size=41, n_lambda=120, n_tpl=2, n_channels=2,
                              n_pointings=2, n_slit=3, dtype=np.float64, window_local=True,
                              psf_stamps=True, conv_freq_rtol=1e-6, conv_rank_rtol=1e-7)
    x = torch.as_tensor(setup["maps"])
    want = model.to("cpu", torch.float64).normal(x)
    before = gr.launches
    got = model.to(dev, torch.float32).normal(x).cpu().double()
    assert gr.launches - before == 2 * sum(c.oshape[0] for c in model.channels)
    assert float((got - want).abs().max() / want.abs().max()) <= 1e-5


def _band_case(rng, K, W, B, rtol):
    """A random banded wpsf [K, W, B] and its two plans at `rtol`."""
    from surfh_tpu_torch.core import wblur_banded as wb

    k = np.arange(K)[:, None]
    l = np.arange(W)[None, :]
    prof = np.exp(-0.5 * ((l - k * (W - 1) / (K - 1)) / 4.0) ** 2)
    wpsf = prof[:, :, None] * rng.uniform(0.5, 1.5, (K, W, B))
    return wpsf, wb.build_band_plan(wpsf, rel_eps=rtol), wb.build_band_plan_t(wpsf, rel_eps=rtol)


@pytest.mark.cuda
@pytest.mark.parametrize("K, W, B, rtol", [
    (300, 90, 5, 1e-3),  # partial last λ'-tile (300 = 2·128 + 44), banded
    (300, 90, 5, 0.0),   # full band: LB = W, KB = 384 > K: the slab runs past K
    (1124, 374, 12, 1e-4),  # band 2b's widths
])
def test_wblur_banded_kernels_match_plain(K, W, B, rtol):
    from surfh_tpu_torch.core import wblur_banded as wb

    dev = _cuda()
    rng = np.random.default_rng(8)
    wpsf, plan, plan_t = _band_case(rng, K, W, B, rtol)
    if rtol == 0.0:
        assert plan.LB == W and plan_t.KB > K
    else:
        assert plan.LB < W
    bt32 = wb.banded_tables(torch.as_tensor(wpsf, dtype=torch.float32, device=dev), plan, plan_t)
    bt64 = wb.banded_tables(torch.as_tensor(wpsf, device=dev), plan, plan_t)
    m = 17 * 23  # odd S·A
    win = torch.as_tensor(rng.standard_normal((m, B * W)), dtype=torch.float32, device=dev)
    y2d = torch.as_tensor(rng.standard_normal((m, K)), dtype=torch.float32, device=dev)
    before = (wb.launches, wb.launches_t)
    got = wb.wblur_banded(win, bt32)
    got_t = wb.wblur_banded_t(y2d, bt32)
    torch.cuda.synchronize()
    assert (wb.launches, wb.launches_t) == (before[0] + 1, before[1] + 1)
    want = wb.wblur_banded_reference(win.double(), bt64)
    want_t = wb.wblur_banded_t_reference(y2d.double(), bt64)
    # f32 FMAs over ≤ B·LB (forward) / KB (transpose) terms against f64
    assert float((got.double() - want).abs().max() / want.abs().max()) <= 1e-5
    assert float((got_t.double() - want_t).abs().max() / want_t.abs().max()) <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("K, W, B, LB, m", [
    (300, 90, 1, 24, 391),   # B = 1: no split; partial last λ'-tile (300 = 2·128 + 44)
    (300, 90, 8, 24, 391),   # M = 6·64 + 7 rows
    (200, 61, 27, 61, 70),   # LB = W = 61: the last step of a run is 5 terms of 8
    (1124, 484, 12, 136, 408),  # band 2b's widths
])
def test_wblur_banded_forward_every_split(K, W, B, LB, m):
    """The forward kernel at every split of the contraction: against the
    run-by-run plain spelling in f64, odd slab offsets, and bit for bit the
    same on a second launch."""
    from surfh_tpu_torch.core import wblur_banded as wb

    dev = _cuda()
    rng = np.random.default_rng(K + B)
    nT = -(-K // 128)
    starts = np.minimum(np.round(np.linspace(0, W - LB, nT)).astype(np.int64) | 1, W - LB)
    assert LB == W or (starts % 2 == 1).any()
    plan = wb.BandPlan(starts.astype(np.int32), K, W, B, -(-B // 8) * 8, LB, 128)
    wpsf = rng.uniform(0.5, 1.5, (K, W, B)) * plan.mask()[:, :, None]
    plan_t = wb.build_band_plan_t(wpsf)
    bt32 = wb.banded_tables(torch.as_tensor(wpsf, dtype=torch.float32, device=dev), plan, plan_t)
    bt64 = wb.banded_tables(torch.as_tensor(wpsf, device=dev), plan, plan_t)
    win = torch.as_tensor(rng.standard_normal((m, B * W)), dtype=torch.float32, device=dev)
    want = wb.wblur_banded_reference(win.double(), bt64)
    picked = wb.forward_launch_shape(m, plan, torch.cuda.get_device_properties(dev).multi_processor_count)
    for split in range(1, min(B, wb.FWD_MAX_SPLIT) + 1):
        shape = wb.forward_shape(m, plan, split)
        before = (wb.launches, wb.launches_sum)
        got = wb._forward_launch(win, bt32, shape)
        again = wb._forward_launch(win, bt32, shape)
        torch.cuda.synchronize()
        assert (wb.launches, wb.launches_sum) == (before[0] + 2, before[1] + 2 * (split > 1))
        # f32 FMAs over B·LB terms against f64
        assert float((got.double() - want).abs().max() / want.abs().max()) <= 1e-5
        assert torch.equal(got, again)
        by_runs = wb.wblur_banded_by_runs(win.double(), bt64, split)
        assert float((by_runs - want).abs().max() / want.abs().max()) <= 1e-12
    assert torch.equal(wb.wblur_banded(win, bt32), wb._forward_launch(win, bt32, picked))


@pytest.mark.cuda
@pytest.mark.parametrize("m", [391, 70])
@pytest.mark.parametrize("K, KB", [(300, 128), (200, 256)])  # a slab inside K; KB > K: it runs past K
@pytest.mark.parametrize("B", [1, 5, 12, 20, 27, 33])  # n = B·TL = 16, 80, 96, 100, 108, 99
def test_wblur_banded_transpose_every_instance(B, K, KB, m):
    """The transpose kernel in every instance that takes the table (row tile
    64 / 32, 12 / 14 / 16 column groups, the general instance; from an
    aligned table and from one a float into its storage): odd slab offsets,
    slabs that run past K, TL a power of two and not (5, 3), a partial last
    λ-tile, against the f64 plain version and bit for bit on a second launch."""
    import dataclasses

    from surfh_tpu_torch.core import wblur_banded as wb

    dev = _cuda()
    rng = np.random.default_rng(100 * B + K)
    W = 61
    Bp = -(-B // 8) * 8
    TL = max(1, 128 // Bp)
    nT = -(-W // TL)
    if KB < K:
        starts = np.round(np.linspace(0, K - KB, nT)).astype(np.int64) | 1
    else:
        starts = 2 * (np.arange(nT) % 5) + 1
    assert (starts % 2 == 1).all() and starts.max() + KB > K and W % TL
    plan_t = wb.BandPlanT(starts.astype(np.int32), K, W, B, Bp, TL, KB)
    wpsf = rng.uniform(0.5, 1.5, (K, W, B)) * plan_t.mask()[:, :, None]
    plan = wb.build_band_plan(wpsf)
    bt32 = wb.banded_tables(torch.as_tensor(wpsf, dtype=torch.float32, device=dev), plan, plan_t)
    bt64 = wb.banded_tables(torch.as_tensor(wpsf, device=dev), plan, plan_t)
    store = torch.empty(bt32.blocks_t.numel() + 1, device=dev)
    off1 = dataclasses.replace(bt32, blocks_t=store[1:].view(bt32.blocks_t.shape).copy_(bt32.blocks_t))
    assert off1.blocks_t.data_ptr() % 16 == 4 and off1.blocks_t.is_contiguous()
    y2d = torch.as_tensor(rng.standard_normal((m, K)), dtype=torch.float32, device=dev)
    want = wb.wblur_banded_t_reference(y2d.double(), bt64)
    by_tiles = wb.wblur_banded_t_by_tiles(y2d.double(), bt64)
    assert float((by_tiles - want).abs().max() / want.abs().max()) <= 1e-12
    n = B * TL
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    picked = wb.transpose_launch_shape(m, plan_t, n_sm)
    assert picked.vec == (n % 4 == 0)
    shapes = [(bt32, wb.transpose_shape(m, plan_t, *wb.T_GENERAL, vec=False)),
              (off1, wb.transpose_shape(m, plan_t, *wb.T_GENERAL, vec=False))]
    if n % 4 == 0:
        shapes += [(bt32, wb.transpose_shape(m, plan_t, bm, cg)) for bm in wb.T_BMS for cg in wb.T_CGS
                   if n <= 8 * cg]
    for bt, shape in shapes:
        before = wb.launches_t
        got = wb._transpose_launch(y2d, bt, shape)
        again = wb._transpose_launch(y2d, bt, shape)
        torch.cuda.synchronize()
        assert wb.launches_t == before + 2
        # f32 FMAs over ≤ KB terms against f64
        assert float((got.double() - want).abs().max() / want.abs().max()) <= 1e-5, shape
        assert torch.equal(got, again), shape
    assert torch.equal(wb.wblur_banded_t(y2d, bt32), wb._transpose_launch(y2d, bt32, picked))
    # a table that does not start on 16 bytes takes the general instance
    assert float((wb.wblur_banded_t(y2d, off1).double() - want).abs().max() / want.abs().max()) <= 1e-5
    if n % 4 == 0:
        with pytest.raises(RuntimeError):  # 16-byte copies from a misaligned table: refused, not launched
            wb._transpose_launch(y2d, off1, picked)


@pytest.mark.cuda
def test_wblur_banded_kernels_reject_what_they_do_not_take():
    from surfh_tpu_torch.core import wblur_banded as wb

    dev = _cuda()
    wpsf, plan, plan_t = _band_case(np.random.default_rng(9), 200, 60, 3, 1e-3)
    bt = wb.banded_tables(torch.as_tensor(wpsf, dtype=torch.float32, device=dev), plan, plan_t)
    with pytest.raises(TypeError):
        wb.wblur_banded(torch.zeros((7, 180), dtype=torch.float64, device=dev), bt)
    with pytest.raises(TypeError):
        wb.wblur_banded_t(torch.zeros((7, 200), dtype=torch.float64, device=dev), bt)
    with pytest.raises(ValueError):
        wb.wblur_banded(torch.zeros((180, 7), device=dev).T, bt)
    with pytest.raises(ValueError):
        wb.wblur_banded_t(torch.zeros((200, 7), device=dev).T, bt)
    with pytest.raises(ValueError):
        wb.wblur_banded(torch.zeros((7, 181), device=dev), bt)


@pytest.mark.cuda
def test_small_wplane_model_on_card_matches_cpu_f64():
    from surfh_tpu_torch.core import wblur_banded as wb
    from surfh_tpu_torch.simulation.synthetic import make_model

    dev = _cuda()
    model, setup = make_model(im_size=31, n_lambda=200, n_tpl=3, n_channels=2, n_pointings=2,
                              n_slit=3, detector_oversample=4, dtype=np.float64,
                              window_local=False, wblur_impl="banded", wblur_band_rtol=1e-3)
    x = torch.as_tensor(setup["maps"])
    want = model.to("cpu", torch.float64).normal(x)
    n_pt = sum(c.oshape[0] for c in model.channels)
    before = (gr.launches, wb.launches, wb.launches_t)
    got = model.to(dev, torch.float32).normal(x).cpu().double()
    assert (gr.launches - before[0], wb.launches - before[1], wb.launches_t - before[2]) == (
        2 * n_pt, n_pt, n_pt)
    assert float((got - want).abs().max() / want.abs().max()) <= 1e-5


@pytest.mark.cuda
def test_mmmg_graph_and_dispatch_loops_agree_bit_for_bit_on_the_card():
    """`mmmg` on a small W-plane model on the card: the graph and the
    dispatch loop run the same steps, so 30 iterations give the same bits;
    one normal application (2 gathers a pointing) per iteration."""
    from surfh_tpu_torch.simulation.synthetic import make_model
    from surfh_tpu_torch.solvers.criterion import QuadCriterion_MRS

    dev = _cuda()
    model, setup = make_model(im_size=31, n_lambda=40, n_tpl=3, n_channels=2, n_pointings=2,
                              n_slit=3, dtype=np.float32, window_local=False)
    model.to(dev, torch.float32)
    y = model.forward(torch.as_tensor(setup["maps"], dtype=torch.float32, device=dev))
    crit = QuadCriterion_MRS(1.0, y, model, 10.0)
    crit.b
    n_pt = sum(c.oshape[0] for c in model.channels)
    before = gr.launches
    a = crit.run_method("mmmg", maximum_iterations=30)
    assert gr.launches - before == 2 * n_pt * 31
    b = crit.run_method("mmmg", maximum_iterations=30, solver_loop="dispatch")
    assert a.n_iter == b.n_iter == 30
    assert torch.equal(a.x, b.x)
    assert bool(torch.isfinite(a.x).all()) and a.grad_norm[-1] < a.grad_norm[0]


def _fixed_case(rng, n_rows, n_src, max_per_row, tp, ld):
    """Sorted COO taps, a third of the rows empty, some zero weights."""
    from surfh_tpu_torch.core import gather_fixed as gf

    live = np.sort(rng.choice(n_rows, size=2 * n_rows // 3, replace=False))
    cdst = np.repeat(live, rng.integers(1, max_per_row + 1, live.size))
    csrc = rng.integers(0, n_src, cdst.size)
    cw = rng.standard_normal(cdst.size)
    cw[rng.random(cdst.size) < 0.05] = 0.0
    empty = np.bincount(cdst[cw != 0], minlength=n_rows) == 0
    return gf.build_fixed_fanin_plan(csrc, cw, cdst, n_rows, n_src, tp, ld=ld), empty


@pytest.mark.cuda
@pytest.mark.parametrize("W", [52, 466, 181])  # float4, float2 and scalar paths
@pytest.mark.parametrize("n_rows, tp, max_per_row", [(3001, 512, 7), (1022, 8, 8), (999, 4, 1),
                                                     (1501, 8, 11)])
def test_gather_fixed_kernels_match_plain(W, n_rows, tp, max_per_row):
    """Each kernel once against its plain version (a launch counted, rows
    without taps zero) and a second launch bit for bit the first."""
    from surfh_tpu_torch.core import gather_fixed as gf

    dev = _cuda()
    rng = np.random.default_rng(W + n_rows)
    n_src = 700
    plan, empty = _fixed_case(rng, n_rows, n_src, max_per_row, tp, W)
    assert empty.any() and n_rows % 4 and plan.L == max_per_row
    src = torch.as_tensor(rng.standard_normal((n_src, W)), dtype=torch.float32, device=dev)
    p32, p64 = plan.to(dev, torch.float32), plan.to(dev, torch.float64)
    for kernel, plain in ((gf.gather_fixed_k1, gf.gather_fixed_k1_reference),
                          (gf.gather_fixed_k2, gf.gather_fixed_k2_reference),
                          (gf.gather_fixed_k3, gf.gather_fixed_k3_reference)):
        before = (gf.launches_k1, gf.launches_k2, gf.launches_k3)
        got = kernel(src, p32)
        torch.cuda.synchronize()
        after = (gf.launches_k1, gf.launches_k2, gf.launches_k3)
        assert sum(after) - sum(before) == 1
        assert tuple(got.shape) == (n_rows, W)
        # the same taps in the same order, f32 FMAs against separate mul/add
        want32 = plain(src, p32)
        assert float((got - want32).abs().max() / want32.abs().max()) <= 1e-6
        want = plain(src.double(), p64)
        assert float((got.double() - want).abs().max() / want.abs().max()) <= 1e-5
        assert not got[torch.as_tensor(empty, device=dev)].any()  # rows with no taps: zero
        assert torch.equal(got, kernel(src, p32))


@pytest.mark.cuda
def test_gather_fixed_kernels_reject_what_they_do_not_take():
    from surfh_tpu_torch.core import gather_fixed as gf

    dev = _cuda()
    rng = np.random.default_rng(10)
    plan, _ = _fixed_case(rng, 40, 30, 4, 8, 8)
    p32 = plan.to(dev, torch.float32)
    for kernel in (gf.gather_fixed_k1, gf.gather_fixed_k2, gf.gather_fixed_k3):
        with pytest.raises(TypeError):
            kernel(torch.zeros((30, 8), dtype=torch.float64, device=dev), plan.to(dev, torch.float64))
        with pytest.raises(ValueError):
            kernel(torch.zeros((29, 8), device=dev), p32)
        with pytest.raises(ValueError):
            kernel(torch.zeros((8, 30), device=dev).T, p32)
    with pytest.raises(ValueError, match="ld"):
        gf.gather_fixed_k3(torch.zeros((30, 12), device=dev), p32)
    # no static fan-in: every kernel takes L = 11 (more than the prototype's 7 or 8)
    wide, _ = _fixed_case(rng, 40, 30, 11, 8, 8)
    assert wide.L == 11
    w32, src = wide.to(dev, torch.float32), torch.randn((30, 8), device=dev)
    for kernel, plain in ((gf.gather_fixed_k1, gf.gather_fixed_k1_reference),
                          (gf.gather_fixed_k2, gf.gather_fixed_k2_reference),
                          (gf.gather_fixed_k3, gf.gather_fixed_k3_reference)):
        got, want = kernel(src, w32), plain(src, w32)
        assert float((got - want).abs().max() / want.abs().max()) <= 1e-6


@pytest.mark.cuda
@pytest.mark.parametrize("misaligned", [False, True])
@pytest.mark.parametrize("L", [1, 7, 8, 40])
@pytest.mark.parametrize("W", [13, 52, 181, 241, 466, 613, 1000])
def test_gather_fixed_k2_shapes(W, L, misaligned):
    """K2 in every launch shape (a lane per column; 1 to 32 lanes per row
    with 8 / 16 / 24 floats a lane, 4 floats × 4 taps at L = 40; float4 and
    single floats; two column chunks at W = 1000), bases 16-byte aligned or
    one float into their storage: a third of the rows empty, rows of exactly
    L taps (more than a group of lanes at L = 40), and a NaN in src[0] that
    reaches only the rows whose taps name row 0 — the padded taps (tsrc = 0)
    are never read."""
    from surfh_tpu_torch.core import gather_fixed as gf

    dev = _cuda()
    rng = np.random.default_rng(1000 * L + W)
    n_rows, n_src = 1501, 700
    live = np.sort(rng.choice(n_rows, size=2 * n_rows // 3, replace=False))
    per = rng.integers(1, L + 1, live.size)
    per[:5] = L
    cdst = np.repeat(live, per)
    csrc = rng.integers(1, n_src, cdst.size)  # no tap names row 0 ...
    named = rng.choice(cdst.size, size=9, replace=False)
    csrc[named] = 0  # ... but these
    cw = rng.uniform(0.5, 1.5, cdst.size) * rng.choice([-1.0, 1.0], cdst.size)
    plan = gf.build_fixed_fanin_plan(csrc, cw, cdst, n_rows, n_src, 8, ld=W)
    assert plan.L == L and plan.nnz == cdst.size and (plan.cnt[:n_rows] == 0).sum() >= n_rows // 3
    store = torch.as_tensor(rng.standard_normal(n_src * W + 1), dtype=torch.float32, device=dev)
    src = store[1:].view(n_src, W) if misaligned else store[:-1].view(n_src, W)
    assert src.is_contiguous() and (src.data_ptr() % 16 == 4) == misaligned
    src[0] = float("nan")
    p32 = plan.to(dev, torch.float32)
    before = gf.launches_k2
    got = gf.gather_fixed_k2(src, p32)
    torch.cuda.synchronize()
    assert gf.launches_k2 == before + 1 and tuple(got.shape) == (n_rows, W)
    want = gf.gather_fixed_k2_reference(src, p32)
    poisoned = torch.zeros(n_rows, dtype=torch.bool, device=dev)
    poisoned[torch.as_tensor(np.unique(cdst[named]), device=dev)] = True
    assert torch.isnan(got[poisoned]).all() and torch.isfinite(got[~poisoned]).all()
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    # the same taps in the same order, f32 FMAs against separate mul/add
    g, w_ = got[~poisoned], want[~poisoned]
    assert float((g - w_).abs().max() / w_.abs().max()) <= 1e-6
    assert not got[p32.cnt[:n_rows] == 0].any()  # rows with no taps: zero
    assert torch.equal(got[~poisoned], gf.gather_fixed_k2(src, p32)[~poisoned])  # taps in table order


@pytest.mark.cuda
@pytest.mark.parametrize("misaligned", [False, True])
@pytest.mark.parametrize("L", [1, 7, 11, 40])
@pytest.mark.parametrize("W", [13, 52, 181, 241, 466, 613, 1000])
def test_gather_fixed_k1_k3_shapes(W, L, misaligned):
    """K1 and K3 in the shape `fixed_launch_shape` picks (a lane per column;
    16 or 32 lanes a row; float4, float2 and single floats; several column
    chunks at W = 1000), bases 16-byte aligned or one float into their
    storage: a third
    of the rows empty, some rows of exactly L taps, and a NaN in src[0].
    Every tap is summed, so the NaN reaches exactly the rows with a padded
    tap (fewer than L taps) and those whose taps name row 0, as in the plain
    versions; the rest agree with them ≤1e-6, and a second launch is bit for
    bit the first."""
    from surfh_tpu_torch.core import gather_fixed as gf

    dev = _cuda()
    rng = np.random.default_rng(100 * L + W)
    n_rows, n_src = 1501, 700
    live = np.sort(rng.choice(n_rows, size=2 * n_rows // 3, replace=False))
    per = rng.integers(1, L + 1, live.size)
    per[:5] = L
    cdst = np.repeat(live, per)
    csrc = rng.integers(1, n_src, cdst.size)
    named = rng.choice(cdst.size, size=9, replace=False)
    csrc[named] = 0
    cw = rng.uniform(0.5, 1.5, cdst.size) * rng.choice([-1.0, 1.0], cdst.size)
    plan = gf.build_fixed_fanin_plan(csrc, cw, cdst, n_rows, n_src, 8, ld=W)
    assert plan.L == L
    store = torch.as_tensor(rng.standard_normal(n_src * W + 1), dtype=torch.float32, device=dev)
    src = store[1:].view(n_src, W) if misaligned else store[:-1].view(n_src, W)
    assert src.is_contiguous() and (src.data_ptr() % 16 == 4) == misaligned
    src[0] = float("nan")
    p32 = plan.to(dev, torch.float32)
    poisoned = (p32.cnt[:n_rows] < L).clone()
    poisoned[torch.as_tensor(np.unique(cdst[named]), device=dev)] = True
    assert not poisoned.all()
    for kernel, plain, count in ((gf.gather_fixed_k1, gf.gather_fixed_k1_reference, "launches_k1"),
                                 (gf.gather_fixed_k3, gf.gather_fixed_k3_reference, "launches_k3")):
        before = getattr(gf, count)
        got = kernel(src, p32)
        torch.cuda.synchronize()
        assert getattr(gf, count) == before + 1 and tuple(got.shape) == (n_rows, W)
        want = plain(src, p32)
        assert torch.isnan(got[poisoned]).all() and torch.isfinite(got[~poisoned]).all()
        assert torch.equal(torch.isnan(got), torch.isnan(want))
        g, w_ = got[~poisoned], want[~poisoned]
        assert float((g - w_).abs().max() / w_.abs().max()) <= 1e-6
        assert torch.equal(torch.nan_to_num(got), torch.nan_to_num(kernel(src, p32)))


@pytest.mark.cuda
@pytest.mark.parametrize("tables", ["stamps", "otf_window"])
def test_dense_window_local_normal_matches_plain_gathers(tables):
    """The dense window-local model (the stamps with `conv_rank_rtol=0`, or
    the OTF windows of the sotf) on the card: its fused normal through the
    row-gather kernel against the plain gathers and against the CPU f64
    model, and one kernel launch per pointing and direction."""
    from surfh_tpu_torch.simulation.synthetic import make_model

    dev = _cuda()
    kw = dict(psf_stamps=True, conv_rank_rtol=0.0) if tables == "stamps" else {}
    model, setup = make_model(im_size=41, n_lambda=120, n_tpl=2, n_channels=2, n_pointings=2,
                              n_slit=3, dtype=np.float64, window_local=True, conv_impl="matmul",
                              conv_freq_rtol=1e-6, **kw)
    assert all("cu" not in t for t in model.host_tables()["chan"])
    x = torch.as_tensor(setup["maps"])
    want = model.to("cpu", torch.float64).normal(x)
    model.to(dev, torch.float32)
    xd = x.to(dev, torch.float32)
    before = gr.launches
    got = model.normal(xd)
    torch.cuda.synchronize()
    assert gr.launches - before == 2 * sum(c.oshape[0] for c in model.channels)
    plain = model.normal(xd, plain=True)
    assert float((got - plain).abs().max() / plain.abs().max()) <= 1e-5
    assert float((got.cpu().double() - want).abs().max() / want.abs().max()) <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("opd", [False, True])
def test_psf_stack_device_matches_host(opd):
    """`psf_stack_device` on the card against the host NumPy stack, with a
    ragged last chunk: ≤1e-5 of the peak."""
    from surfh_tpu_torch.utils import jwst_psf

    dev = _cuda()
    wavels = np.array([5.3, 7.0, 9.1, 12.4, 16.0])
    kw = dict(npix=65, n_pupil=128, opd=jwst_psf.zernike_opd(128, {4: 300e-9}) if opd else None)
    host = jwst_psf.psf_stack(wavels, 0.05, **kw)
    got = jwst_psf.psf_stack_device(wavels, 0.05, chunk=2, device=dev, **kw)
    assert got.shape == host.shape and got.dtype == np.float32
    assert float(np.abs(got - host).max() / host.max()) <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("q", [1, 100])  # the deconvolution widths: config 1 and config 2
def test_gather_gradient_runs_the_kernel_on_the_transposed_plan(q):
    """`gather_rows_op`'s backward on the card: kernel #1 on the cached
    transposed plan (one launch each way), against the plain transpose."""
    dev = _cuda()
    rng = np.random.default_rng(q)
    plan = _plan(rng, 3000, 2000, 20000, heavy_row=5, heavy_taps=40).to(dev, torch.float32)
    src = torch.as_tensor(rng.standard_normal((2000, q)), dtype=torch.float32,
                          device=dev).requires_grad_()
    g = torch.as_tensor(rng.standard_normal((3000, q)), dtype=torch.float32, device=dev)
    before = gr.launches
    (grad,) = torch.autograd.grad(gr.gather_rows_op(src, plan), src, g)
    torch.cuda.synchronize()
    assert gr.launches == before + 2
    want = gr.gather_rows_reference(g.double(), plan.t.to(dev, torch.float64))
    assert float((grad.double() - want).abs().max() / want.abs().max()) <= 1e-5


@pytest.mark.cuda
def test_rotated_blind2d_model_on_card_matches_plain_f64():
    """The rotated 2-D model's f32 forward / derived adjoint through #1
    against the same model in float64 on the card (plain gather)."""
    from surfh_tpu_torch.core.fft import ir2fr
    from surfh_tpu_torch.models.blind2d import MRSBlurred
    from surfh_tpu_torch.simulation.synthetic import make_setup

    dev = _cuda()
    s = make_setup(im_size=61, n_lambda=8, n_channels=1, n_pointings=4)
    args = (ir2fr(s["spsf"][0], s["im_shape"]), s["alpha_axis"], s["beta_axis"], s["instrs"][0],
            s["step_degree"], s["pointings"][0])
    m32 = MRSBlurred(*args, dtype=np.float32, device=dev)
    m64 = MRSBlurred(*args, dtype=np.float64, device=dev)
    rng = np.random.default_rng(0)
    x, y = rng.random(m32.ishape), rng.random(m32.oshape)
    before = gr.launches
    f, a = m32.forward(x), m32.adjoint(y)
    torch.cuda.synchronize()
    assert gr.launches > before
    for got, want in ((f, m64.forward(x, plain=True)), (a, m64.adjoint(y, plain=True))):
        assert float((got.double() - want).abs().max() / want.abs().max()) <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("name, gathers", [("SpectroSigRLCT", 1), ("MO_SigRLSCT", 4),
                                           ("MO_SigRLSCT_shiftConv", 1), ("SpectroMO_ST", 4)])
def test_family_derived_adjoint_runs_the_kernel_both_ways(name, gathers):
    """A family operator's f32 forward and derived adjoint on the card: #1
    launched once per gather in each direction (the adjoint through
    `GatherRows` on the transposed plans), against the same operator in
    float64 on the card with the plain gather."""
    from surfh_tpu_torch.models import family
    from surfh_tpu_torch.simulation.synthetic import make_setup

    dev = _cuda()
    s = make_setup(im_size=61, n_lambda=40, n_tpl=3, n_channels=1, n_pointings=4, n_slit=3)
    a = (s["sotf"], s["templates"], s["alpha_axis"], s["beta_axis"], s["wavelength_axis"],
         s["instrs"][0], s["step_degree"])
    if name != "SpectroSigRLCT":
        a = a + (s["pointings"][0],)
    cls = getattr(family, name)
    m32 = cls(*a, dtype=torch.float32, device=dev)
    m64 = cls(*a, dtype=torch.float64, device=dev)
    rng = np.random.default_rng(0)
    x, y = rng.random(m32.ishape), rng.random(m32.oshape)
    m32.adjoint(y)  # the derived adjoint's one-time forward at a zero primal
    torch.cuda.synchronize()
    before = gr.launches
    f, t = m32.forward(x), m32.adjoint(y)
    torch.cuda.synchronize()
    assert gr.launches - before == 2 * gathers
    for got, want in ((f, m64.forward(x, plain=True)), (t, m64.adjoint(y, plain=True))):
        assert float((got.double() - want).abs().max() / want.abs().max()) <= 1e-5


@pytest.mark.cuda
def test_spectro_adjoint_auto_through_the_kernel_matches_the_adjoint():
    """`SpectroSigRLSCT.adjoint_auto` on the card (rank mode, f32): the
    derived transpose through `GatherRows` against the hand-written adjoint."""
    from surfh_tpu_torch.simulation.synthetic import make_model

    dev = _cuda()
    model, _ = make_model(im_size=61, n_lambda=120, n_tpl=2, n_channels=2, n_pointings=2, n_slit=3,
                          window_local=True, psf_stamps=True, conv_freq_rtol=1e-6,
                          conv_rank_rtol=1e-7)
    model.to(dev, torch.float32)
    y = torch.rand(model.oshape, device=dev)
    want = model.adjoint(y)
    before = gr.launches
    got = model.adjoint_auto(y)
    torch.cuda.synchronize()
    assert gr.launches > before
    assert float((got - want).abs().max() / want.abs().max()) <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["rank", "wplane_banded"])
def test_sharded_normal_on_the_card(mode):
    """`ShardedSpectro` at world 1 on the card (NCCL): the rank model's
    sharded normal bit for bit `model.normal`; the W-plane banded model's
    (each band's own λ window) within f32 rounding of it; the kernels
    launched once per pointing and direction."""
    import torch.distributed as dist

    from surfh_tpu_torch.core import wblur_banded as wb
    from surfh_tpu_torch.parallel import ShardedSpectro, make_mesh
    from surfh_tpu_torch.simulation.synthetic import make_model

    dev = _cuda()
    kw = (dict(window_local=True, psf_stamps=True, conv_freq_rtol=1e-6, conv_rank_rtol=1e-7)
          if mode == "rank" else dict(wblur_impl="banded", wblur_band_rtol=1e-4))
    model, setup = make_model(im_size=61, n_lambda=120, n_tpl=2, n_channels=2, n_pointings=2,
                              n_slit=3, **kw)
    model.to(dev, torch.float32)
    x = torch.as_tensor(setup["maps"], dtype=torch.float32, device=dev)
    sh = ShardedSpectro(model, make_mesh())
    try:
        assert dist.get_backend() == "nccl"
        n_pt = sum(c.oshape[0] for c in model.channels)
        before, before_b = gr.launches, wb.launches
        got = sh.normal(x)
        torch.cuda.synchronize()
        assert gr.launches - before == 2 * n_pt
        assert wb.launches - before_b == (n_pt if mode != "rank" else 0)
        want = model.normal(x)
        if mode == "rank":
            assert torch.equal(got, want)
        else:
            assert float((got - want).abs().max() / want.abs().max()) <= 1e-5
    finally:
        dist.destroy_process_group()


@pytest.mark.cuda
def test_lambda_sharded_forward_on_the_card():
    """`LambdaShardedChannel` at world 1 on the card: its forward through the
    row-gather kernel against the channel's own forward, one launch per
    pointing."""
    import torch.distributed as dist

    from surfh_tpu_torch.parallel import LambdaShardedChannel, make_mesh
    from surfh_tpu_torch.simulation.synthetic import make_model

    dev = _cuda()
    model, _ = make_model(im_size=61, n_lambda=40, n_tpl=2, n_channels=1, n_pointings=2, n_slit=3)
    chan = model.channels[0].to(dev, torch.float32)
    cube = torch.rand(model.cube_shape, device=dev)
    lam = LambdaShardedChannel(chan, model.cube_shape[0], make_mesh(axis_name="lam"))
    try:
        before = gr.launches
        got = lam.forward(lam.shard_cube(cube))
        torch.cuda.synchronize()
        assert gr.launches - before == chan.oshape[0]
        want = chan.forward(cube)
        assert float((got - want).abs().max() / want.abs().max()) <= 1e-5
    finally:
        dist.destroy_process_group()


@pytest.mark.cuda
@pytest.mark.parametrize("wblur_impl", ["dense", "banded"])
def test_bench_chain_as_a_cuda_graph(wblur_impl):
    """`bench_torch.py`'s loop mode: the forward → adjoint chain captured
    once as a CUDA graph (the row gather, and the banded blur pair) replays
    to the eager chain's `g` (≤1e-6: one f32 computation, the same kernels
    in the same order), and a replay passes through no wrapper."""
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import bench_torch
    from surfh_tpu_torch.simulation.synthetic import make_model

    dev = _cuda()
    model, setup = make_model(im_size=61, n_lambda=40, n_tpl=2, n_channels=2, n_pointings=2,
                              n_slit=3, wblur_impl=wblur_impl, wblur_band_rtol=1e-3)
    model.to(dev, torch.float32)
    x0 = torch.as_tensor(setup["maps"], dtype=torch.float32, device=dev)
    graph, g, total = bench_torch.capture_chain(model, x0, 3)
    before = gr.launches
    graph.replay()
    torch.cuda.synchronize()
    assert gr.launches == before
    eager = bench_torch.apply_chain(model, x0, 3)
    assert bench_torch.rel_gap(g, eager) <= 1e-6
    assert float(total) == pytest.approx(float(eager.sum()), rel=1e-5)


@pytest.mark.cuda
def test_banded_channel_forward_runs_kernel_2():
    """`Channel(..., wblur_impl="banded")` on a cube: its forward through the
    banded kernel (#2) against `plain=True` (≤1e-5: f32 sums in another
    order), one #2 launch per pointing; its adjoint is the dense transpose
    (no #3 launch)."""
    from surfh_tpu_torch.core import wblur_banded as wb
    from surfh_tpu_torch.instrument.geometry import get_srf
    from surfh_tpu_torch.models.channel import Channel
    from surfh_tpu_torch.simulation.synthetic import make_setup

    dev = _cuda()
    s = make_setup(im_size=31, n_lambda=96, n_channels=1, n_pointings=2, n_slit=3)
    instr = s["instrs"][0]
    srf = get_srf([instr.det_pix_size], s["step_degree"] * 3600)[0]
    chan = Channel(instr, s["alpha_axis"], s["beta_axis"], s["wavelength_axis"], srf, s["pointings"][0],
                   s["step_degree"], np.float32, "bilinear", "banded", 1e-3).to(dev, torch.float32)
    gen = torch.Generator(device=dev).manual_seed(0)
    cube = torch.rand(chan.ishape, generator=gen, device=dev)
    wb.reset_launches()
    got = chan.forward(cube)
    torch.cuda.synchronize()
    assert wb.launches == chan.oshape[0] and wb.launches_t == 0
    want = chan.forward(cube, plain=True)
    assert float((got - want).abs().max() / want.abs().max()) <= 1e-5
    chan.adjoint(torch.rand(chan.oshape, generator=gen, device=dev))
    torch.cuda.synchronize()
    assert wb.launches == chan.oshape[0] and wb.launches_t == 0
