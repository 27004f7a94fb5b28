"""The exact window-local flagship (`flagship-wlocal`: the λ-rank gate
closed, every band's conv the dense DFT-matmul GEMM chains) as a benchmark
configuration, on the CPU at toy sizes.

* The program's dense window-local operator against the benchmark's plain
  reference (`benchmark/reference/operator.py`) in float64, two bands of
  different channels, 101², 2 pointings, at the configuration's own
  ``conv_rank_rtol`` 0 and ``conv_freq_rtol`` 1e-6: forward and adjoint
  within 1e-10.
* A toy copy of `flagship-wlocal.cg50` written as files to a temporary
  checkout, through `run_cell`: `correct`; with one band's conv rows
  zeroed, not `correct`, each number above 10× its limit; traced, the
  span reader's value.
* ``surfh.op.conv.window``: twice a band a normal, inside the band's span,
  under a profiler only; none on the λ-rank or the W-plane operator; the
  iterates with the profiler on equal those with it off, bit for bit.
* The cell's readers on hand-built views: their known answers, each alias
  equal to the metric it re-reads, and nothing to read without the span.
* `benchmark/bench/gemm_work.py`'s count against a hand count of the
  products from the program's own tables at the toy size.
"""

import json
import shutil
import types
from collections import Counter
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark import run
from benchmark.bench import gemm_work, program, spec
from benchmark.bench.trace import TraceView
from benchmark.bench.yardstick import FP32_FLOPS_PER_S
from benchmark.reference.operator import Reference
from surfh_tpu_torch.models.spectro import SpectroSigRLSCT
from surfh_tpu_torch.utils import profiling

ROOT = Path(__file__).resolve().parents[1]
SEED = 2**31 + 27
WORKLOAD = "flagship-wlocal.cg50"
PROBLEM = dict(npix=101, bands=["1c", "2c"], n_pointings=2, n_tpl=4, lambda_subsample=9,
               setup_seed=19940407, step_arcsec=0.025, psf_stamp=40)
SOLVE, ITER, NORMAL, BAND = "surfh.solver.solve", "surfh.solver.iter", "surfh.op.normal", "surfh.op.band."
WINDOW = "surfh.op.conv.window"
# well above the sound toy run (float32 on the CPU, three seeds: at most 2.5e-6 / 4.3e-5), far below
# the run with one band's conv rows zeroed (6.6e-3 / 0.12)
TOY_LIMITS = {"x_rel_l2": 1e-4, "x_max_abs": 1e-3}
TOY_ITERATIONS = 5


@pytest.fixture(autouse=True)
def _caches(monkeypatch, tmp_path):
    monkeypatch.setenv("SURFH_TABLE_CACHE", "0")
    monkeypatch.setenv("SURFH_CACHE_DIR", str(tmp_path / "wpsf"))
    monkeypatch.setattr(program, "WORKERS", 1)


def _config() -> dict:
    return json.loads((ROOT / "benchmark" / "configs" / "flagship-wlocal.json").read_text())


def _model(model_block: dict, dtype=np.float64):
    from surfh_tpu_torch.simulation.flagship import make_flagship_model, make_flagship_setup

    kw = dict(model_block)
    setup = make_flagship_setup(npix=PROBLEM["npix"], bands=PROBLEM["bands"], n_pointings=2,
                                lambda_subsample=PROBLEM["lambda_subsample"],
                                build_sotf=not kw["window_local"], device="cpu")
    model, _ = make_flagship_model(setup, dtype=dtype, **kw)
    return model.to("cpu", torch.float64 if dtype == np.float64 else torch.float32)


@pytest.fixture(scope="module")
def dense():
    """The configuration's model block on the toy problem, float64."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SURFH_TABLE_CACHE", "0")
        model = _model(_config()["model"])
    assert not any(model._rank_band(c) for c in range(len(model.channels)))
    return model


def test_the_configuration_is_flagship_rank_s_with_the_gate_closed():
    cfg, rank = _config(), json.loads((ROOT / "benchmark" / "configs" / "flagship-rank.json").read_text())
    assert cfg["model"] == dict(rank["model"], conv_rank_rtol=0.0)
    assert {k for k in cfg if cfg[k] != rank[k]} == {"name", "source", "deployment", "model"}
    bench = spec.load_benchmark(ROOT)
    sources = {c["name"]: c["source"] for c in bench["configs"]}
    assert sources.pop("flagship-wlocal") == cfg["source"]
    assert cfg["source"] not in sources.values()
    cell = {w["name"]: w for w in bench["workloads"]}[WORKLOAD]
    assert (cell["config"], cell["traffic"], cell["chips"]) == ("flagship-wlocal", "cg50", 1)
    assert {c["name"]: c for c in bench["configs"]}["flagship-wlocal"]["reduced"] == cfg["reduced"] == []


def test_reference_matches_the_program(dense):
    ref = Reference({"problem": PROBLEM, "model": _config()["model"]}, "cpu", torch.float64)
    x = torch.as_tensor(np.random.default_rng(5).random((4, 101, 101)))
    ys = ref.forward(x)
    yr = torch.cat([y.reshape(-1) for y in ys])
    assert float((dense.forward(x) - yr).norm() / yr.norm()) <= 1e-10
    v = torch.as_tensor(np.random.default_rng(6).standard_normal(yr.numel()))
    ar = ref.adjoint([b.view(y.shape) for b, y in zip(torch.split(v, [y.numel() for y in ys]), ys)])
    assert float((dense.adjoint(v) - ar).norm() / ar.norm()) <= 1e-10


# ---------------------------------------------------------------------------
# the cell as files alone, end to end


@pytest.fixture(scope="module")
def toy_cell(tmp_path_factory):
    """A checkout whose `flagship-wlocal` configuration is cut to the toy
    problem, with the toy's limits: the cell loaded from its files."""
    root = tmp_path_factory.mktemp("checkout")
    shutil.copytree(ROOT / "benchmark", root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    bd = root / "benchmark"
    cfg = _config()
    cfg["problem"].update(PROBLEM)
    (bd / "configs" / "flagship-wlocal.json").write_text(json.dumps(cfg))
    (bd / "limits" / f"{WORKLOAD}.json").write_text(json.dumps(TOY_LIMITS))

    def load():
        cell = spec.cell(WORKLOAD, root=root, bench_dir=bd)
        cell["traffic"]["maximum_iterations"] = TOY_ITERATIONS
        return cell
    return load


def _drive(cell, trace=0):
    args = types.SimpleNamespace(seed=SEED, seconds=0.2, trace=trace)
    return run.run_cell(args, torch.device("cpu"), cell, clock=lambda: 0.0)


def test_the_toy_cell_from_files_alone_is_correct(toy_cell):
    cell = toy_cell()
    assert cell["config"]["problem"]["npix"] == 101 and cell["traffic"]["kind"] == "cg_solve"
    res = _drive(cell)
    assert res["correct"], res["checks"]
    assert set(res["metrics"]) == {"setup_s", "cg_ms_per_iter", "peak_gib"}


def test_the_toy_cell_with_a_band_zeroed_is_not_correct(toy_cell, monkeypatch):
    conv = SpectroSigRLSCT._conv

    def zeroed(self, x, c, cols=None, plain=False):
        rows = conv(self, x, c, cols, plain)
        return rows * 0 if c == 0 else rows

    monkeypatch.setattr(SpectroSigRLSCT, "_conv", zeroed)
    res = _drive(toy_cell())
    assert not res["correct"], res["checks"]
    assert all(n["value"] > 10 * n["limit"] for n in res["checks"].values()), res["checks"]


def test_the_traced_toy_cell_reads_the_conv_window_span(toy_cell):
    """On the CPU the trace has no device lane: the span's reader alone finds
    something to read, and the other new readers return nothing."""
    res = _drive(toy_cell(), trace=1)
    assert res["correct"], res["checks"]
    metrics = res["metrics"]
    assert metrics["operator.conv_window_host_ms_per_normal"]["value"] > 0
    assert metrics["operator.conv_window_host_ms_per_normal"]["unit"] == "ms/normal"
    for name in ("gemm.flop_share.wlocal", "gemm.ms_per_iter", "device.idle_frac.wlocal",
                 "kernel.gather_rows.bw_share.wlocal"):
        assert name not in metrics


# ---------------------------------------------------------------------------
# the span


def _spans(events):
    return [(e.name, e.time_range.start, e.time_range.end) for e in events if e.name.startswith("surfh.")]


def _inside(inner, outers) -> bool:
    return any(s <= inner[1] and inner[2] <= e for _, s, e in outers)


def test_conv_window_span_twice_a_band_a_normal(dense):
    x = torch.ones(dense.ishape, dtype=torch.float64)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(2):
            dense.normal(x)
    spans = _spans(prof.events())
    counts = Counter(n for n, _, _ in spans)
    assert counts[NORMAL] == 2 and counts[WINDOW] == 2 * 2 * len(dense.channels)
    bands = [h for h in spans if h[0].startswith(BAND)]
    assert all(_inside(h, bands) for h in spans if h[0] == WINDOW)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        dense.forward(x)
    assert Counter(n for n, _, _ in _spans(prof.events()))[WINDOW] == len(dense.channels)


def test_conv_window_span_never_on_the_rank_or_the_wplane_operator():
    rank = _model(_config()["model"] | {"conv_rank_rtol": 1e-7})
    assert all(rank._rank_band(c) for c in range(len(rank.channels)))
    wplane = _model({"window_local": False, "wblur_impl": "banded", "wblur_band_rtol": 1e-4})
    for model in (rank, wplane):
        x = torch.ones(model.ishape, dtype=torch.float64)
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            model.normal(x)
        counts = Counter(n for n, _, _ in _spans(prof.events()))
        assert counts[NORMAL] == 1 and WINDOW not in counts


def test_conv_window_span_only_under_a_profiler_and_the_iterates_unchanged(dense, monkeypatch):
    from surfh_tpu_torch.solvers.criterion import QuadCriterion_MRS

    crit = QuadCriterion_MRS(1.0, dense.forward(torch.full(dense.ishape, 0.7, dtype=torch.float64)),
                             dense, 5e3)
    crit.b

    def solve():
        return crit.run_method("lcg", maximum_iterations=4, value_init=0.5)

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        traced = solve()
    assert Counter(n for n, _, _ in _spans(prof.events()))[WINDOW] == 2 * len(dense.channels) * 5

    def refuse(name):
        raise AssertionError(f"a range {name!r} made with no profiler running")

    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", refuse)
    plain = solve()
    assert torch.equal(plain.x, traced.x)
    np.testing.assert_array_equal(plain.grad_norm, traced.grad_norm)
    assert profiling.span(WINDOW) is profiling.span(NORMAL)


# ---------------------------------------------------------------------------
# the readers

READERS = ("operator.conv_window_host_ms_per_normal", "gemm.flop_share.wlocal", "gemm.ms_per_iter")
ALIASES = {"device.idle_frac.wlocal": "device.idle_frac.cg",
           "kernel.gather_rows.bw_share.wlocal": "kernel.gather_rows.bw_share.cg"}

# 2 iterations and 3 normals in a window of 1 s
DEVICE = [("sm90_xmma_gemm_f32f32_f32f32_f32_tn_n_tilesize128x128x16", 0.0, 0.2),
          ("void at::native::vectorized_elementwise_kernel", 0.2, 0.3),
          ("ampere_sgemm_128x64_nn", 0.3, 0.4), ("gather_rows_kernel", 0.45, 0.47),
          ("void at::native::reduce_kernel", 0.5, 0.9)]
SPANS = [(SOLVE, 0.0, 0.95), (ITER, 0.0, 0.4), (ITER, 0.4, 0.9), (NORMAL, 0.01, 0.1), (NORMAL, 0.1, 0.2),
         (NORMAL, 0.41, 0.5), (BAND + "1C", 0.01, 0.09), (WINDOW, 0.02, 0.05), (WINDOW, 0.06, 0.08),
         (WINDOW, 0.11, 0.12)]
WORK = {"gather_bytes": 1e6, "blur_seconds": 1e-3}


def _view(host=SPANS, units=None):
    return TraceView(window_s=1.0, device=list(DEVICE), host=list(host),
                     units=dict(units or {"iterations": 2, "normals": 3}), work=lambda: dict(WORK))


def test_the_cells_readers_give_their_known_answers(toy_cell):
    """Read in the toy checkout: the GEMM share counts its configuration."""
    bd = toy_cell()["bench_dir"]
    read = {name: spec.metric_reader(name, bd) for name in READERS}
    t = _view()
    assert read["operator.conv_window_host_ms_per_normal"](t) == pytest.approx(60.0 / 3)
    assert read["gemm.ms_per_iter"](t) == pytest.approx(300.0 / 2)
    flops = gemm_work.normal_flops(toy_cell()["config"], "cpu")
    assert read["gemm.flop_share.wlocal"](t) == pytest.approx(100.0 * 3 * flops / FP32_FLOPS_PER_S / 0.3)
    assert spec.metric_reader("device.idle_frac.wlocal", bd)(t) == pytest.approx(100.0 * (1 - 0.82))


@pytest.mark.parametrize("name", sorted(ALIASES))
def test_an_alias_reads_what_its_metric_reads(name):
    alias, original = spec.metric_reader(name), spec.metric_reader(ALIASES[name])
    t = _view()
    assert alias(t) is not None and alias(t) == original(t)
    empty = TraceView(window_s=1.0, device=[], host=[], units={"iterations": 0, "normals": 0},
                      work=lambda: dict(WORK))
    assert alias(empty) is None and original(empty) is None


def test_nothing_to_read_without_the_span():
    read = spec.metric_reader("operator.conv_window_host_ms_per_normal")
    # the parent's spans: the CG's iterations, normals and bands, but no conv window
    assert read(_view(host=[h for h in SPANS if h[0] != WINDOW])) is None
    assert read(_view(host=[])) is None
    assert read(_view(units={"iterations": 3, "normals": 3})) is None
    no_gemm = TraceView(window_s=1.0, device=[d for d in DEVICE if "gemm" not in d[0]], host=list(SPANS),
                        units={"iterations": 2, "normals": 3}, work=lambda: dict(WORK))
    assert spec.metric_reader("gemm.flop_share.wlocal")(no_gemm) is None
    assert spec.metric_reader("gemm.ms_per_iter")(no_gemm) is None


# ---------------------------------------------------------------------------
# the GEMM count


def test_gemm_work_counts_the_products_by_hand(dense):
    """Per band a direction: the conv's inverse stage 3·W·ha·Ka'·Kb' +
    2·W·ha·Kb'·wb and the dense blur P·S·A·sb·W·K, each size read here from
    the program's own tables, which the count never reads.  The count's
    bbox is the footprint of what the slit windows read, the program's that
    of the band's whole local grid: at this size both are the whole grid
    (at the flagship's 501² the program's is a few rows and columns
    wider)."""
    config = {"problem": PROBLEM, "model": _config()["model"]}
    counted = gemm_work.band_macs(config, "cpu")
    assert [b["band"] for b in counted] == PROBLEM["bands"]
    for b, chan, t in zip(counted, dense.channels, dense.tables["chan"]):
        w, ka, kb = t["otf"][0].shape
        ha, wb = chan.tbbox[2:]
        p, s, k, a = chan.oshape
        sb = chan.slit_shape[2]
        assert (b["W"], b["Ka"], b["Kb"], b["ha"], b["wb"]) == (w, ka, kb, ha, wb)
        assert b["conv"] == 3 * w * ha * ka * kb + 2 * w * ha * kb * wb
        assert b["blur"] == p * (s * a) * (sb * w) * k
    # band 1c at the toy size: W 156, Ka' 73, Kb' 37, the whole 101² grid, 2 × 21 × 19 × 8 × 1400
    assert counted[0]["conv"] == 3 * 156 * 101 * 73 * 37 + 2 * 156 * 101 * 37 * 101 == 245_431_212
    assert counted[0]["blur"] == 2 * 21 * 19 * 8 * 156 * 1400
    assert gemm_work.normal_flops(config, "cpu") == 4.0 * sum(b["conv"] + b["blur"] for b in counted)
    assert gemm_work.least_seconds(config, "cpu") == gemm_work.normal_flops(config, "cpu") / FP32_FLOPS_PER_S


def test_gemm_work_refuses_an_open_rank_gate():
    with pytest.raises(ValueError, match="rank gate closed"):
        gemm_work.band_macs({"problem": PROBLEM, "model": _config()["model"] | {"conv_rank_rtol": 1e-7}})
