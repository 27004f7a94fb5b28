"""The metric arithmetic: unions of device intervals, the idle share and
breakdown, the end-to-end rates over the window, the sample of answers,
TF32 rounding, and the work counts against the program's own plans on a
toy problem."""

import numpy as np
import pytest
import torch

from benchmark import run
from benchmark.bench import spec, yardstick
from benchmark.bench.trace import TraceView, merged, union_length
from benchmark.bench.traffic import Sample
from benchmark.reference.operator import round_tf32


def test_union_counts_overlaps_once():
    assert union_length([]) == 0.0
    assert union_length([(0, 1), (0.5, 2), (3, 4)]) == pytest.approx(3.0)
    assert union_length([(1, 2), (0, 5)]) == pytest.approx(5.0)
    assert merged([(3, 4), (0, 1), (0.5, 2)]) == [[0, 2], [3, 4]]


def view():
    device = [("gemm_kernel_a", 0.1, 0.4), ("void gather_rows_kernel<4>", 0.3, 0.5),
              ("Memcpy DtoH", 0.7, 0.8), ("vectorized_elementwise_kernel", 0.9, 1.0)]
    host = [("aten::item", 0.45, 0.75), ("aten::_local_scalar_dense", 0.5, 0.7),
            ("cudaDeviceSynchronize", 0.0, 0.05)]
    return TraceView(window_s=1.0, device=device, host=host, units={"iterations": 2, "normals": 3},
                     work=lambda: {"gather_bytes": 3.35e9, "blur_seconds": 0.0})


def test_trace_view_reads():
    t = view()
    assert t.busy_s == pytest.approx(0.6)
    assert t.seconds("gemm") == pytest.approx(0.3)
    assert t.seconds("gather_rows") == pytest.approx(0.2)
    assert t.kernels() == 3
    b = t.breakdown()
    assert b["device_ops"][0] == ["gemm_kernel_a", pytest.approx(0.3)]
    gaps = dict((k, v) for k, v in b["idle_gaps"])
    assert gaps["aten::_local_scalar_dense"] == pytest.approx(0.2)  # 0.5–0.7, the innermost op
    assert gaps["cudaDeviceSynchronize"] == pytest.approx(0.1)  # 0–0.1
    assert sum(gaps.values()) == pytest.approx(0.4)


def test_metric_readers():
    t = view()
    read = {n: spec.metric_reader(n) for n in ("device.idle_frac.cg", "solver.syncs_per_iter",
                                                "operator.launches_per_iter", "gemm.ms_per_iter",
                                                "kernel.gather_rows.bw_share.cg", "fft.ms_per_iter")}
    assert read["device.idle_frac.cg"](t) == pytest.approx(40.0)
    assert read["solver.syncs_per_iter"](t) == pytest.approx(1.0)
    assert read["operator.launches_per_iter"](t) == pytest.approx(1.5)
    assert read["gemm.ms_per_iter"](t) == pytest.approx(150.0)
    # 3 normals × 3.35e9 bytes at 3.35e12 B/s = 3 ms against 200 ms of gathers
    assert read["kernel.gather_rows.bw_share.cg"](t) == pytest.approx(1.5)
    assert read["fft.ms_per_iter"](t) is None  # nothing to read: no value, never 0
    empty = TraceView(window_s=1.0, device=[], host=[], units={"iterations": 2, "normals": 3})
    assert read["device.idle_frac.cg"](empty) is None
    assert read["operator.launches_per_iter"](empty) is None


def test_rates_over_the_window():
    r = {"setup_s": 12.5, "peak_bytes": 3 * 2**30, "window_s": 20.0,
         "units": {"iterations": 800, "normals": 816}, "voxels": 10}
    assert run.end_to_end("cg_ms_per_iter", r) == pytest.approx(25.0)
    assert run.end_to_end("gvox_per_s", r) == pytest.approx(816 * 2 * 10 / 20 / 1e9)
    assert run.end_to_end("peak_gib", r) == pytest.approx(3.0)
    assert run.end_to_end("setup_s", r) == 12.5


@pytest.mark.parametrize("n", [1, 2, 3, 10, 57])
def test_sample_keeps_first_last_and_a_seeded_draw(n):
    picks = []
    for _ in range(2):
        s = Sample(3, seed=2**31 + 11)
        for i in range(n):
            s.offer(i, lambda i=i: i)
        picks.append([i for i, _ in s.answers()])
    assert picks[0] == picks[1]
    assert picks[0][0] == 0 and picks[0][-1] == n - 1
    assert len(picks[0]) == min(n, 3) and len(set(picks[0])) == len(picks[0])


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0, 1 + 2**-10, 1 + 2**-11 + 2**-13, 1 + 2**-12, -3.14159265], dtype=torch.float32)
    r = round_tf32(x)
    assert r[0] == 1.0 and r[1] == 1 + 2**-10
    assert r[2] == 1 + 2**-10  # above half an ulp rounds up
    assert r[3] == 1.0  # below half an ulp rounds down
    assert abs(float(r[4]) + 3.14159265) <= 2**-10 * 4


def test_bound_takes_the_larger():
    assert yardstick.bound(3.35e12) == pytest.approx(1.0)
    assert yardstick.bound(0.0, 67e12) == pytest.approx(1.0)
    assert yardstick.bound(3.35e12, 2 * 67e12) == pytest.approx(2.0)


def test_gather_footprint_matches_the_program_plans():
    """The work count's source rows and output rows, from the configuration,
    equal the rows of the program's composed gather plans that carry weight."""
    from benchmark.reference import instrument
    from surfh_tpu_torch.simulation.flagship import make_flagship_model, make_flagship_setup

    problem = dict(npix=101, bands=["2c"], n_pointings=2, n_tpl=4, lambda_subsample=9,
                   setup_seed=19940407, step_arcsec=0.025, psf_stamp=40)
    inp = instrument.problem_inputs(problem)
    setup = make_flagship_setup(npix=101, bands=["2c"], n_pointings=2, lambda_subsample=9)
    model, _ = make_flagship_model(setup, dtype=np.float64, conv_rank_rtol=0.0, conv_freq_rtol=0.0)
    chan = model.channels[0]
    g = instrument.band_geometry("2c", inp)
    a0, b0, ha, wb = chan.tbbox
    for p, pointing in enumerate(inp["pointings"]):
        idx, w = instrument.bilinear(inp["alpha"], inp["beta"], g.window_points(pointing).reshape(-1, 2))
        ours = np.unique(idx[w != 0])
        cidx, cw = chan.composed_stack[0][p], chan.composed_stack[1][p]
        rows = np.unique(cidx[cw != 0])
        n = len(inp["beta"])
        theirs = (rows // wb + a0) * n + rows % wb + b0
        assert np.array_equal(np.sort(theirs), ours)
        assert cidx.shape[1] == g.n_slit * g.n_a * g.n_b
