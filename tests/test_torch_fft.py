"""surfh_tpu_torch.core.fft / core.wblur against the JAX reference (float64).

(c) the rank-basis conv pair `lmm_conv_rank` / `lmm_conv_rank_t` against
the reference's (≤1e-12 relative: the same DFT-matmul chain, summed in
another order), in both layouts, with truncated frequency support and a
bbox, plus the port's own transpose dot test; the wblur GEMM pair against
`wblur_sum_beta_batched` and its transpose; and the host DFT tables
bit-for-bit against the reference's, `ir2fr` with the reference's `center`
and `real` parameters among them.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from surfh_tpu.core import fft as jfft
from surfh_tpu.core import wblur as jwblur
from surfh_tpu_torch.core import fft, wblur

torch.set_num_threads(2)

IM = (23, 20)
BBOX = (3, 2, 15, 13)


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.fixture(scope="module")
def conv():
    rng = np.random.default_rng(0)
    M, R = 3, 4
    m = fft.dft_matmul_tables(IM, np.float64, ka_max=6, kb_keep=7, bbox=BBOX)
    ka, kb = m["fa_re"].shape[0], m["fb_re"].shape[0]
    return dict(
        m=m,
        maps=rng.standard_normal((M,) + IM),
        o_re=rng.standard_normal((R, ka, kb)),
        o_im=rng.standard_normal((R, ka, kb)),
        g=rng.standard_normal((M * R, BBOX[2], BBOX[3])),
        M=M,
    )


def _t(d):
    return {k: torch.as_tensor(v) for k, v in d.items()}


def test_lmm_conv_rank_matches_reference(conv):
    want = jfft.lmm_conv_rank(jnp.asarray(conv["maps"]), conv["o_re"], conv["o_im"], conv["m"])
    got = fft.lmm_conv_rank(torch.as_tensor(conv["maps"]), torch.as_tensor(conv["o_re"]),
                            torch.as_tensor(conv["o_im"]), _t(conv["m"]))
    assert got.shape == want.shape
    assert rel(got.numpy(), want) <= 1e-12


def test_lmm_conv_rank_t_matches_reference(conv):
    want = jfft.lmm_conv_rank_t(jnp.asarray(conv["g"]), conv["o_re"], conv["o_im"], conv["m"],
                                conv["M"])
    got = fft.lmm_conv_rank_t(torch.as_tensor(conv["g"]), torch.as_tensor(conv["o_re"]),
                              torch.as_tensor(conv["o_im"]), _t(conv["m"]), conv["M"])
    assert got.shape == want.shape
    assert rel(got.numpy(), want) <= 1e-12


def test_lmm_conv_rank_pair_dot_test(conv):
    m = _t(conv["m"])
    o_re, o_im = torch.as_tensor(conv["o_re"]), torch.as_tensor(conv["o_im"])
    x, g = torch.as_tensor(conv["maps"]), torch.as_tensor(conv["g"])
    lhs = float(torch.sum(fft.lmm_conv_rank(x, o_re, o_im, m) * g))
    rhs = float(torch.sum(x * fft.lmm_conv_rank_t(g, o_re, o_im, m, conv["M"])))
    assert abs(lhs - rhs) <= 1e-12 * abs(lhs)
    # the row layout is the same map with the patch axes moved
    rows = fft.lmm_conv_rank_rows(x, fft.otf_bins_last(o_re), fft.otf_bins_last(o_im), m)
    ref = fft.lmm_conv_rank(x, o_re, o_im, m)
    assert torch.equal(rows.view(BBOX[2], BBOX[3], -1).permute(2, 0, 1), ref)


@pytest.mark.parametrize("kw", [
    dict(),
    dict(ka_max=5, kb_keep=4),
    dict(ka_max=4, kb_keep=9, bbox=BBOX),
])
def test_dft_matmul_tables_match_reference(kw):
    got = fft.dft_matmul_tables((21, 18), np.float64, **kw)
    want = jfft.dft_matmul_tables((21, 18), np.float64, **kw)
    assert sorted(got) == sorted(want)
    for k in got:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_stamp_tables_match_reference():
    rng = np.random.default_rng(1)
    psf = rng.random((30, 9, 9))
    for a, b in zip(fft.lowrank_stamp_factor(psf, 1e-3), jfft.lowrank_stamp_factor(psf, 1e-3)):
        np.testing.assert_array_equal(a, b)
    assert fft.otf_support_from_psf(psf, (25, 22), 1e-4) == jfft.otf_support_from_psf(psf, (25, 22), 1e-4)
    st, jst = (mod.psf_stamp_tables((25, 22), (9, 9), np.float64, ka_max=5, kb_keep=6)
               for mod in (fft, jfft))
    for k in jst:
        np.testing.assert_array_equal(st[k], jst[k])
    np.testing.assert_array_equal(fft.ir2fr(psf, (25, 22)), jfft.ir2fr(psf, (25, 22)))
    np.testing.assert_array_equal(fft.box_otf_sr(5, (25, 22)), jfft.box_otf_sr(5, (25, 22)))
    np.testing.assert_array_equal(fft.half_srf_shift_otf(5, (25, 22)),
                                  jfft.half_srf_shift_otf(5, (25, 22)))


def test_wblur_pair_matches_reference():
    rng = np.random.default_rng(2)
    s, l, a, b, k = 3, 11, 5, 4, 7
    arr = rng.standard_normal((s, l, a, b))
    wpsf = rng.standard_normal((k, l, b))
    y = rng.standard_normal((s, k, a))
    got = wblur.wblur_sum_beta_batched(torch.as_tensor(arr), torch.as_tensor(wpsf))
    assert rel(got.numpy(), jwblur.wblur_sum_beta_batched(jnp.asarray(arr), jnp.asarray(wpsf))) <= 1e-13
    got_t = wblur.wblur_sum_beta_batched_t(torch.as_tensor(y), torch.as_tensor(wpsf))
    want_t = np.einsum("ska,klb->slab", y, wpsf)  # channel.py:1153-1159 transpose GEMM
    assert rel(got_t.numpy(), want_t) <= 1e-13
    # row layout: windows [S·A, sb·Q] against the re-laid table
    wq = wblur.rows_table(torch.as_tensor(wpsf))
    win = torch.as_tensor(arr).permute(0, 2, 3, 1).reshape(s * a, b * l)
    rows = wblur.wblur_rows(win, wq).view(s, a, k).transpose(1, 2)
    assert rel(rows.numpy(), got.numpy()) <= 1e-13
    y2d = torch.as_tensor(y).transpose(1, 2).reshape(s * a, k)
    lhs = float(torch.sum(wblur.wblur_rows(win, wq) * y2d))
    rhs = float(torch.sum(win * wblur.wblur_rows_t(y2d, wq)))
    assert abs(lhs - rhs) <= 1e-12 * abs(lhs)


@pytest.mark.parametrize("real", [True, False])
@pytest.mark.parametrize("center", [None, (1, 3)])
def test_ir2fr_center_and_real(real, center):
    """`ir2fr(imp_resp, shape, center, real)` as the reference's
    (surfh_tpu/core/fft.py:61-82): a given center rolled to (0, 0), the
    complex FFT with ``real=False``; float64, bit for bit."""
    psf = np.random.default_rng(4).random((2, 5, 7))
    got = fft.ir2fr(psf, (25, 22), center=center, real=real)
    want = jfft.ir2fr(psf, (25, 22), center=center, real=real)
    assert got.dtype == want.dtype == np.complex128
    assert got.shape == (2, 25, 12 if real else 22)
    np.testing.assert_array_equal(got, want)
    assert np.array_equal(fft.ir2fr(psf, (25, 22), center, real), got)
