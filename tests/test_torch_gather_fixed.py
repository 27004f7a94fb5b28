"""The fixed-fan-in row gather (`surfh_tpu_torch.core.gather_fixed`, the port
of the K1–K3 prototypes of `scripts/scatter_pallas_proto.py`) on the CPU.

* the host plan equals the prototype's host prep, restated below from
  `scatter_pallas_proto.py:74-93`, on a real composed transpose and on
  random COO taps;
* the plain versions of K1, K2 and K3 against the JAX package's
  `bilinear.apply_composed_plan_t` and the port's CSR plain version, on a
  real JAX channel's `_composed_stack` (MIRI band 1c, 201² sky, one
  pointing: L = 12, flagship-like; smaller skies clamp hundreds of taps onto
  border pixels, which a padded table multiplies into every row): f64
  ≤1e-13, f32 ≤2e-6 (the same taps summed in the same order, plus the
  reference's own f32 rounding);
* random COO cases: empty rows (exactly zero), P not a multiple of `tp` or
  of 4, W = 181 and W = 466 (the widths of bands 4a and 1c);
* the plan's refusals and the dispatch rule (the kernels themselves:
  test_torch_kernels_cuda.py);
* the JAX prototype itself in interpret mode: its K1–K3 check lines.
"""

import re
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from surfh_tpu.core import bilinear as jbilinear
from surfh_tpu.instrument.geometry import get_srf as jget_srf
from surfh_tpu.models.channel import Channel as JaxChannel
from surfh_tpu.simulation import flagship as jflagship
from surfh_tpu_torch.core import gather_fixed as gf
from surfh_tpu_torch.core import gather_rows as gr

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parents[1]
KERNELS = {
    "K1": (gf.gather_fixed_k1_reference, gf.gather_fixed_k1),
    "K2": (gf.gather_fixed_k2_reference, gf.gather_fixed_k2),
    "K3": (gf.gather_fixed_k3_reference, gf.gather_fixed_k3),
}


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


def proto_prep(csrc, cw, cdst, P, TP):
    """The prototype's host prep, scatter_pallas_proto.py:74-93 (its COO
    taps come sorted by destination, as a composed transpose's do)."""
    nz = cw != 0  # :74
    csrc, cw, cdst = csrc[nz], cw[nz], cdst[nz]  # :75
    seg = np.bincount(cdst, minlength=P)  # :78
    L = int(seg.max())  # :79
    starts = np.concatenate([[0], np.cumsum(seg)])  # :80
    Pp = -(-P // TP) * TP  # :82
    tsrc = np.zeros((Pp, L), np.int32)  # :83
    tw = np.zeros((Pp, L), np.float32)  # :84
    for k in range(L):  # :85-88
        has = seg > k
        tsrc[:P][has, k] = csrc[starts[:-1][has] + k]
        tw[:P][has, k] = cw[starts[:-1][has] + k]
    cnt = np.zeros((Pp,), np.int32)  # :89
    cnt[:P] = seg  # :90
    return tsrc, tw, cnt, L, Pp


@pytest.fixture(scope="module")
def band_1c():
    """Pointing 0's composed transpose of the JAX channel of band 1c."""
    s = jflagship.make_flagship_setup(npix=201, bands=["1c"], n_pointings=1, build_sotf=False)
    instr = s["instrs"][0]
    srf = jget_srf([instr.det_pix_size], s["step_degree"] * 3600)[0]
    chan = JaxChannel(instr, s["alpha_axis"], s["beta_axis"], s["wavelength_axis"], srf,
                      s["pointings"][0], s["step_degree"], dtype=jnp.float64)
    idx, _w, csrc, cw, cdst = (np.asarray(a[0]) for a in chan._composed_stack)
    P = chan._tbbox[2] * chan._tbbox[3]
    W = chan.wslice.stop - chan.wslice.start
    return dict(csrc=csrc, cw=cw, cdst=cdst, P=P, n_src=idx.shape[1], W=W)


def random_coo(rng, n_rows, n_src, n_taps, max_per_row=9):
    """Sorted COO taps with at most `max_per_row` per row, some zero weights
    and a third of the rows empty."""
    live = np.sort(rng.choice(n_rows, size=2 * n_rows // 3, replace=False))
    per = rng.integers(1, max_per_row + 1, live.size)
    cdst = np.repeat(live, per)[:n_taps]
    csrc = rng.integers(0, n_src, cdst.size)
    cw = rng.standard_normal(cdst.size)
    cw[rng.random(cdst.size) < 0.05] = 0.0
    return csrc, cw, cdst


def test_plan_matches_proto_prep_on_a_composed_transpose(band_1c):
    b = band_1c
    plan = gf.build_fixed_fanin_plan(b["csrc"], b["cw"], b["cdst"], b["P"], b["n_src"], 512, ld=b["W"])
    tsrc, tw, cnt, L, Pp = proto_prep(b["csrc"], b["cw"], b["cdst"], b["P"], 512)
    assert (plan.L, plan.n_padded, plan.n_rows) == (L, Pp, b["P"]) and 7 <= L <= 32
    np.testing.assert_array_equal(plan.tsrc, tsrc)
    np.testing.assert_array_equal(plan.tw.astype(np.float32), tw)
    np.testing.assert_array_equal(plan.cnt, cnt)
    np.testing.assert_array_equal(plan.tsrc_s, tsrc * b["W"])
    assert plan.nnz == int((b["cw"] != 0).sum())


@pytest.mark.parametrize("P, tp", [(1001, 8), (1000, 64), (37, 512)])
def test_plan_matches_proto_prep_on_random_taps(P, tp):
    rng = np.random.default_rng(P)
    csrc, cw, cdst = random_coo(rng, P, 300, 4 * P)
    plan = gf.build_fixed_fanin_plan(csrc, cw, cdst, P, 300, tp, ld=13)
    tsrc, tw, cnt, L, Pp = proto_prep(csrc, cw, cdst, P, tp)
    assert (plan.L, plan.n_padded) == (L, Pp) and Pp % tp == 0
    np.testing.assert_array_equal(plan.tsrc, tsrc)
    np.testing.assert_array_equal(plan.tw.astype(np.float32), tw)
    np.testing.assert_array_equal(plan.cnt, cnt)
    assert not plan.tw[P:].any() and not plan.tsrc[P:].any() and not plan.cnt[P:].any()


@pytest.mark.parametrize("kernel", list(KERNELS))
@pytest.mark.parametrize("dtype, tol", [(np.float64, 1e-13), (np.float32, 2e-6)])
def test_plain_versions_match_the_composed_transpose(band_1c, kernel, dtype, tol):
    b = band_1c
    rng = np.random.default_rng(7)
    vals = rng.standard_normal((b["W"], b["n_src"])).astype(dtype)
    want = np.asarray(jbilinear.apply_composed_plan_t(
        jnp.asarray(b["csrc"]), jnp.asarray(b["cw"].astype(dtype)), jnp.asarray(b["cdst"]),
        jnp.asarray(vals), b["P"])).T  # [P, W]
    tdt = torch.float64 if dtype == np.float64 else torch.float32
    plan = gf.build_fixed_fanin_plan(b["csrc"], b["cw"], b["cdst"], b["P"], b["n_src"], 512,
                                     ld=b["W"]).to("cpu", tdt)
    csr = gr.build_row_gather_plan(b["csrc"], b["cw"], b["cdst"], b["P"], b["n_src"]).to("cpu", tdt)
    rows = torch.as_tensor(vals.T.copy())
    got = KERNELS[kernel][0](rows, plan)
    assert got.dtype == tdt and tuple(got.shape) == (b["P"], b["W"])
    assert rel(got, want) <= tol
    assert rel(got, gr.gather_rows_reference(rows, csr)) <= tol


@pytest.mark.parametrize("W", [181, 466])
@pytest.mark.parametrize("P, tp", [(1001, 8), (1022, 512)])
def test_plain_versions_on_random_taps(W, P, tp):
    rng = np.random.default_rng(W + P)
    n_src = 250
    csrc, cw, cdst = random_coo(rng, P, n_src, 5 * P)
    plan = gf.build_fixed_fanin_plan(csrc, cw, cdst, P, n_src, tp, ld=W).to("cpu", torch.float64)
    csr = gr.build_row_gather_plan(csrc, cw, cdst, P, n_src).to("cpu", torch.float64)
    src = torch.as_tensor(rng.standard_normal((n_src, W)))
    want = gr.gather_rows_reference(src, csr)
    empty = np.bincount(cdst[cw != 0], minlength=P) == 0
    assert empty.any() and P % 4
    outs = {}
    for name, (plain, dispatch) in KERNELS.items():
        outs[name] = got = plain(src, plan)
        assert torch.equal(got, dispatch(src, plan))
        assert tuple(got.shape) == (P, W)
        assert rel(got, want) <= 1e-13
        assert not got[torch.as_tensor(empty)].any()  # rows with no taps: exactly zero
    assert torch.equal(outs["K1"], outs["K3"])  # the same sum, read through the offsets


def test_plan_refuses_what_the_kernels_cannot_take():
    csrc, cw, cdst = np.array([0, 2]), np.array([1.0, 2.0]), np.array([0, 3])
    with pytest.raises(ValueError, match="multiple of 4"):
        gf.build_fixed_fanin_plan(csrc, cw, cdst, 4, 3, 6, ld=8)
    with pytest.raises(ValueError, match="out of bounds"):
        gf.build_fixed_fanin_plan(csrc, cw, cdst, 3, 3, 8, ld=8)
    with pytest.raises(ValueError, match="int32"):
        gf.build_fixed_fanin_plan(csrc, cw, cdst, 4, 3, 8, ld=2**30)
    empty = gf.build_fixed_fanin_plan(csrc[:0], cw[:0], cdst[:0], 5, 3, 8, ld=4)
    assert empty.L == 1 and empty.nnz == 0 and empty.n_padded == 8
    got = gf.gather_fixed_k1(torch.ones((3, 4)), empty.to("cpu", torch.float32))
    assert tuple(got.shape) == (5, 4) and not got.any()


def test_cpu_dispatch_takes_the_plain_versions():
    rng = np.random.default_rng(5)
    plan = gf.build_fixed_fanin_plan(*random_coo(rng, 50, 40, 200), 50, 40, 8, ld=6)
    plan = plan.to("cpu", torch.float64)
    src = torch.as_tensor(rng.standard_normal((40, 6)))
    before = (gf.launches_k1, gf.launches_k2, gf.launches_k3)
    for name, (plain, dispatch) in KERNELS.items():
        assert torch.equal(dispatch(src, plan), plain(src, plan))
    assert (gf.launches_k1, gf.launches_k2, gf.launches_k3) == before
    for kernel in (gf.gather_fixed_k1_cuda, gf.gather_fixed_k2_cuda, gf.gather_fixed_k3_cuda):
        with pytest.raises(ValueError, match="CUDA"):
            kernel(src, plan)


def test_jax_prototype_checks_in_interpret_mode():
    """`scripts/scatter_pallas_proto.py --cpu` (Pallas interpret mode) at a
    201² sky: its K1–K3 agree with its COO transpose."""
    proc = subprocess.run([sys.executable, "scripts/scatter_pallas_proto.py", "--cpu", "--npix", "201"],
                          cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    checks = dict(re.findall(r"check (K\d): max rel (\S+)", proc.stdout))
    assert sorted(checks) == ["K1", "K2", "K3"], proc.stdout
    assert all(float(v) <= 1e-5 for v in checks.values()), checks
