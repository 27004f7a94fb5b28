"""The port's banded spectral blur (`surfh_tpu_torch/core/wblur_banded.py`)
against the reference's `surfh_tpu/core/wblur_pallas.py` (CPU).

* the plans are the reference's, as integers (starts, LB, KB, TL, Bp, TK),
  and the kernels' re-laid blocks hold exactly the reference's blocked f32
  tables — so both keep the same wpsf entries;
* the plain versions match `wblur_sum_beta_banded_reference` and both
  Pallas kernels run in interpret mode, ≤1e-6 relative (the reference
  computes in f32);
* in f64 the plain versions match a NumPy masked einsum with the masks
  rebuilt from the reference's plans, ≤1e-12;
* the transpose spelled λ-tile by λ-tile from the transpose kernel's own
  operands (`wblur_banded_t_by_tiles`) is that masked product (f64, ≤1e-12)
  and the reference's transpose kernel in interpret mode (f32, ≤1e-5).

Cases: the banded synthetic wpsf of `tests/test_wblur_pallas.py` (K = 200,
not a multiple of 128; B = 6, not a multiple of 8), a window shorter than 8
(W = 6), and the wpsf of MIRI band 2b (K = 1124, W = 374, sb = 12) at
rtol 0 (LB = W, KB > K: the transpose slab runs past K), 1e-4 and 1e-3.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from surfh_tpu.core import wblur_pallas as wp
from surfh_tpu_torch.core import wblur_banded as wb
from surfh_tpu_torch.instrument.geometry import get_srf
from surfh_tpu_torch.models.channel import Channel
from surfh_tpu_torch.simulation import flagship

torch.set_num_threads(2)

S, A = 3, 7  # S·A = 21: odd


def _banded_wpsf(K=200, W=120, B=6, width=3.0):
    """The synthetic banded wpsf of tests/test_wblur_pallas.py."""
    wpsf = np.zeros((K, W, B))
    ls = np.arange(W)
    for k in range(K):
        c = k * (W - 1) / max(K - 1, 1)
        prof = np.exp(-0.5 * ((ls - c) / width) ** 2)
        prof[prof < 1e-4] = 0.0
        wpsf[k] = prof[:, None] * (1 + 0.1 * np.arange(B))[None, :]
    return wpsf


@pytest.fixture(scope="module")
def band_2b_wpsf():
    s = flagship.make_flagship_setup(npix=61, bands=["2b"], n_pointings=1)
    instr = s["instrs"][0]
    srf = get_srf([instr.det_pix_size], s["step_degree"] * 3600)[0]
    chan = Channel(instr, s["alpha_axis"], s["beta_axis"], s["wavelength_axis"], srf,
                   s["pointings"][0], s["step_degree"], dtype=np.float64)
    return chan.wpsf


CASES = {
    "synthetic": (lambda _: _banded_wpsf(), 0.0),
    "w_below_8": (lambda _: _banded_wpsf(K=40, W=6, B=3, width=1.0), 0.0),
    "band2b_rtol0": (lambda w: w, 0.0),
    "band2b_rtol1e-4": (lambda w: w, 1e-4),
    "band2b_rtol1e-3": (lambda w: w, 1e-3),
}


@pytest.fixture(scope="module", params=list(CASES))
def case(request, band_2b_wpsf):
    make, rtol = CASES[request.param]
    wpsf = make(band_2b_wpsf)
    ref = (wp.build_band_plan(wpsf, rel_eps=rtol), wp.build_band_plan_t(wpsf, rel_eps=rtol))
    got = (wb.build_band_plan(wpsf, rel_eps=rtol), wb.build_band_plan_t(wpsf, rel_eps=rtol))
    return request.param, wpsf, ref, got


def _to_rows(windows):
    """[S, W, A, B] → the port's rows [S·A, B·W]."""
    s, w, a, b = windows.shape
    return torch.as_tensor(windows).permute(0, 2, 3, 1).reshape(s * a, b * w)


def _from_rows(out, s, a):
    """[S·A, K] → [S, K, A]."""
    return out.view(s, a, -1).transpose(1, 2).numpy()


def _rel(a, b):
    return float(np.abs(np.asarray(a, np.float64) - b).max() / np.abs(b).max())


def test_plans_equal_reference(case):
    name, wpsf, (ref, ref_t), (got, got_t) = case
    np.testing.assert_array_equal(got.starts, ref.starts)
    assert (got.K, got.W, got.B, got.Bp, got.LB, got.TK) == (
        ref.K, ref.W, ref.B, ref.Bp, ref.LB, ref.TK)
    np.testing.assert_array_equal(got_t.starts, ref_t.starts)
    assert (got_t.K, got_t.W, got_t.B, got_t.Bp, got_t.TL, got_t.KB) == (
        ref_t.K, ref_t.W, ref_t.B, ref_t.Bp, ref_t.TL, ref_t.KB)
    if name == "band2b_rtol0":
        assert got.LB == got.W and got_t.KB > got_t.K  # full band; slab past K
    if name == "band2b_rtol1e-4":
        assert got.density < 0.5  # the threshold makes a real band


def test_blocks_hold_the_reference_blocked_tables(case):
    """The kernels' re-laid blocks = the reference's blocked f32 tables."""
    _, wpsf, (ref, ref_t), (got, got_t) = case
    bt = wb.banded_tables(torch.as_tensor(wpsf, dtype=torch.float32), got, got_t)
    nT, B, LB, TK, Bp = ref.n_tiles, ref.B, ref.LB, ref.TK, ref.Bp
    want = ref.wpsf_blocked.reshape(nT, LB, Bp, TK)[:, :, :B].transpose(0, 2, 1, 3)
    np.testing.assert_array_equal(bt.blocks.numpy(), want.reshape(nT, B * LB, TK))
    nTt, TL, KB = ref_t.starts.shape[0], ref_t.TL, ref_t.KB
    want_t = ref_t.wpsf_blocked.reshape(nTt, TL, Bp, KB)[:, :, :B].transpose(0, 3, 2, 1)
    np.testing.assert_array_equal(bt.blocks_t.numpy(), want_t.reshape(nTt, KB, B * TL))


def test_plain_matches_reference_and_interpret_kernels(case):
    """f32: plain versions against the reference's NumPy banded forward and
    both Pallas kernels in interpret mode."""
    _, wpsf, (ref, ref_t), (got, got_t) = case
    K, W, B = wpsf.shape
    rng = np.random.default_rng(0)
    windows = rng.standard_normal((S, W, A, B)).astype(np.float32)
    y = rng.standard_normal((S, K, A)).astype(np.float32)
    bt = wb.banded_tables(torch.as_tensor(wpsf, dtype=torch.float32), got, got_t)

    out = _from_rows(wb.wblur_banded(_to_rows(windows), bt), S, A)
    assert _rel(out, wp.wblur_sum_beta_banded_reference(windows, ref)) <= 1e-6
    pallas = np.asarray(wp.wblur_sum_beta_banded(jnp.asarray(windows), ref, interpret=True))
    assert _rel(out, pallas) <= 1e-6

    y2d = torch.as_tensor(y).transpose(1, 2).reshape(S * A, K)
    out_t = wb.wblur_banded_t(y2d, bt).view(S, A, B, W).permute(0, 3, 1, 2).numpy()
    pallas_t = np.asarray(wp.wblur_sum_beta_t_banded(jnp.asarray(y), ref_t, interpret=True))
    assert _rel(out_t, pallas_t) <= 1e-6


def test_plain_f64_matches_masked_einsum(case):
    """f64: the plain versions are the masked contractions, the masks rebuilt
    here from the reference's plans."""
    _, wpsf, (ref, ref_t), (got, got_t) = case
    K, W, B = wpsf.shape
    rng = np.random.default_rng(1)
    windows = rng.standard_normal((S, W, A, B))
    y = rng.standard_normal((S, K, A))
    k, l = np.arange(K)[:, None], np.arange(W)[None, :]
    s_f = ref.starts.astype(np.int64)[k // ref.TK]
    s_t = ref_t.starts.astype(np.int64)[l // ref_t.TL]
    mask_f = (l >= s_f) & (l < s_f + ref.LB)
    mask_t = (k >= s_t) & (k < s_t + ref_t.KB)
    np.testing.assert_array_equal(got.mask(), mask_f)
    np.testing.assert_array_equal(got_t.mask(), mask_t)
    bt = wb.banded_tables(torch.as_tensor(wpsf), got, got_t)

    want = np.einsum("slab,klb->ska", windows, wpsf * mask_f[:, :, None])
    assert _rel(_from_rows(wb.wblur_banded(_to_rows(windows), bt), S, A), want) <= 1e-12
    want_t = np.einsum("ska,klb->slab", y, wpsf * mask_t[:, :, None])
    y2d = torch.as_tensor(y).transpose(1, 2).reshape(S * A, K)
    got_t_out = wb.wblur_banded_t(y2d, bt).view(S, A, B, W).permute(0, 3, 1, 2).numpy()
    assert _rel(got_t_out, want_t) <= 1e-12


def test_transpose_by_tiles_matches_masked_product_and_interpret_kernel(case):
    """The transpose from the kernel's operands (blocks_t, starts_t, runs of
    TL columns at stride W, slabs past K, a partial last tile): the masked
    product in f64, and the reference's Pallas transpose in interpret mode
    in f32 (≤ 1e-5, the banded bar: both sum ≤ KB f32 terms in their own
    order)."""
    _, wpsf, (ref, ref_t), (got, got_t) = case
    K, W, B = wpsf.shape
    rng = np.random.default_rng(2)
    y = rng.standard_normal((S, K, A))
    y2d = torch.as_tensor(y).transpose(1, 2).reshape(S * A, K)
    bt = wb.banded_tables(torch.as_tensor(wpsf), got, got_t)
    want = wb.wblur_banded_t_reference(y2d, bt)
    by_tiles = wb.wblur_banded_t_by_tiles(y2d, bt)
    assert by_tiles.shape == want.shape
    assert _rel(by_tiles.numpy(), want.numpy()) <= 1e-12

    bt32 = wb.banded_tables(torch.as_tensor(wpsf, dtype=torch.float32), got, got_t)
    out_t = wb.wblur_banded_t_by_tiles(y2d.float(), bt32).view(S, A, B, W).permute(0, 3, 1, 2).numpy()
    pallas_t = np.asarray(wp.wblur_sum_beta_t_banded(jnp.asarray(y.astype(np.float32)), ref_t,
                                                      interpret=True))
    assert _rel(out_t, pallas_t) <= 1e-5


def test_tables_refuse_a_plan_of_another_wpsf():
    wpsf = _banded_wpsf()
    plan, plan_t = wb.build_band_plan(wpsf), wb.build_band_plan_t(wpsf)
    with pytest.raises(ValueError):
        wb.banded_tables(torch.as_tensor(wpsf[:, :100]), plan, plan_t)
