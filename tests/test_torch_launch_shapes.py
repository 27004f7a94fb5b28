"""The launch shapes that the port's wrappers choose for its two redesigned
kernels, and the order in which the banded forward sums (CPU, pure Python /
plain torch; the kernels themselves: test_torch_kernels_cuda.py).

* `wblur_banded.forward_launch_shape` on the twelve bands of the flagship at
  wblur_band_rtol 1e-4 (S·A, K, W, β width, band length, λ'-tiles as the
  port's plans give them at full width) and on test-size plans: the runs of
  the parts cover 0..B−1 once and in order, the grid fills the card wherever
  B allows, the scratch is what the wrapper allocates;
* `gather_rows.gather_launch_shape` over the row widths of both solve paths;
* `wblur_banded_by_runs`, the forward summed run by run and part by part as
  the kernel does, against `wblur_banded_reference` in f64 (≤ 1e-12).
"""

import numpy as np
import pytest
import torch

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
