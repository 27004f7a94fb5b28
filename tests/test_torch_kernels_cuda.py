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
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
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
