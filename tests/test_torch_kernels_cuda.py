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
                              n_pointings=2, n_slit=3, dtype=np.float64)
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
