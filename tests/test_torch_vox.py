"""The voxel reconstruction (`solvers.vox_reconstruction`, the Huber-prior
MM memory gradient on the cube) against the benchmark's plain MM reference
(`benchmark/reference/huber_mm.py`), its spans, and the benchmark's voxel
cell driven end to end, all on the CPU at toy sizes.

* The reference against the port on a cube-mode W-plane `SpectroSigRLSCT`
  (2 bands, 2 pointings, 41², 90 λ-planes), float64, 10 steps: ≤ 1e-9.
* The reference's own algebra: its Huber gradient against central finite
  differences of its objective, its difference transposes in a dot test,
  its blocks of λ-planes against one block.
* A `vox_mm` cell written as files to a temporary checkout, through
  `run_cell`: `correct` true; with one band dropped from the program's
  output, false; the cube's CG kind with pinned answer buffers
  (`cg_solve_pinned`) `correct` too, and its sample the plain one's.
* `mmmg_huber`'s spans: 50 ``iter``, 100 ``prior`` and one ``host_read``
  in one ``solve`` for ``max_iter=50``; ``surfh.op.conv.cube`` twice a
  cube-mode normal and never on the maps route; the iterates with the
  profiler on equal those with it off, bit for bit.
* The float32 MM from Hᵗy at the flagship's µ: finite and near float64.
* The readers of the cube cell's metrics on hand-built views: their
  known answers, each alias equal to the metric it re-reads, and nothing
  to read without the program's spans.
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
from benchmark.bench import program, spec
from benchmark.bench.trace import TraceView
from benchmark.reference import huber_mm
from benchmark.reference.operator import Reference
from surfh_tpu_torch.simulation.synthetic import make_model, make_setup
from surfh_tpu_torch.solvers import mmmg_huber, vox_reconstruction

ROOT = Path(__file__).resolve().parents[1]
SEED = 2**31 + 5
CUBE = dict(npix=41, bands=["1c", "2c"], n_pointings=2, n_tpl=4, lambda_subsample=30,
            setup_seed=19940407, step_arcsec=0.025, psf_stamp=40, unknown="cube")
BANDED = {"wblur_impl": "banded", "wblur_band_rtol": 1e-4}
PARAMS = dict(spat_reg=5.0, spat_th=0.1, spec_reg=5.0, spec_th=0.1)
SOLVE, ITER, READ, PRIOR = ("surfh.solver.solve", "surfh.solver.iter", "surfh.solver.host_read",
                            "surfh.solver.prior")
NORMAL, CONV_CUBE, CONV_MAPS = "surfh.op.normal", "surfh.op.conv.cube", "surfh.op.conv.maps"


@pytest.fixture(autouse=True)
def _caches(monkeypatch, tmp_path):
    monkeypatch.setenv("SURFH_TABLE_CACHE", "0")
    monkeypatch.setenv("SURFH_CACHE_DIR", str(tmp_path / "wpsf"))
    monkeypatch.setattr(program, "WORKERS", 1)


@pytest.fixture(scope="module")
def pair():
    """The reference and the program's cube-mode W-plane model of `CUBE`,
    both float64 (the program's OTF in complex128)."""
    from surfh_tpu_torch.core.fft import ir2fr_device
    from surfh_tpu_torch.simulation.flagship import make_flagship_model, make_flagship_setup

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SURFH_TABLE_CACHE", "0")
        ref = Reference({"problem": CUBE, "model": BANDED}, "cpu", torch.float64)
        setup = make_flagship_setup(npix=41, bands=CUBE["bands"], n_pointings=2, lambda_subsample=30,
                                    device="cpu")
        setup = dict(setup, templates=None,
                     sotf=ir2fr_device(setup["psf_stack"], (41, 41), "cpu", dtype=torch.complex128))
        model, _ = make_flagship_model(setup, dtype=np.float64, window_local=False, **BANDED)
    return ref, model.to("cpu", torch.float64)


def test_reference_matches_the_program(pair):
    ref, model = pair
    assert model.ishape == ref.x_shape == (90, 41, 41)
    x = torch.as_tensor(np.random.default_rng(5).random(ref.x_shape))
    a = vox_reconstruction(model.forward(x), model, **PARAMS, max_iter=10).x
    b = huber_mm.vox_reconstruction(ref, ref.forward(x), PARAMS, 10, planes=32)
    assert float((a - b).norm() / b.norm()) <= 1e-9
    # ten steps moved the iterate well away from its start Hᵗy
    start = ref.adjoint(ref.forward(x))
    assert float((b - start).norm() / start.norm()) > 0.5


class Dense:
    """A toy operator [L, N, N] → two bands of data, as lists."""

    def __init__(self, shape, rng):
        self.x_shape, self.dtype, self.device = shape, torch.float64, torch.device("cpu")
        n = int(np.prod(shape))
        self.mats = [torch.as_tensor(rng.standard_normal((m, n))) for m in (7, 11)]

    def forward(self, x):
        return [a @ x.reshape(-1) for a in self.mats]

    def adjoint(self, ys):
        return sum(a.T @ y for a, y in zip(self.mats, ys)).reshape(self.x_shape)


@pytest.mark.parametrize("planes", [2, 3, 9])
def test_reference_gradient_is_the_objective_s(planes):
    rng = np.random.default_rng(11)
    op = Dense((9, 5, 4), rng)
    prior_list = huber_mm.priors(0.7, 0.3, 1.3, 0.2)
    x = torch.as_tensor(rng.standard_normal(op.x_shape))
    y = [torch.as_tensor(rng.standard_normal(7)), torch.as_tensor(rng.standard_normal(11))]
    g = huber_mm.gradient(op, y, op.forward(x), x, prior_list, planes)
    for _ in range(3):
        v = torch.as_tensor(rng.standard_normal(op.x_shape))
        eps = 1e-6
        fd = (huber_mm.objective(op, y, x + eps * v, prior_list, planes)
              - huber_mm.objective(op, y, x - eps * v, prior_list, planes)) / (2 * eps)
        assert float(fd) == pytest.approx(float((g * v).sum()), rel=1e-7)
    one = huber_mm.gradient(op, y, op.forward(x), x, prior_list, planes=9)
    assert torch.allclose(g, one, rtol=1e-13, atol=1e-13)


@pytest.mark.parametrize("axis", [0, 1, 2])
def test_reference_difference_transposes_are_exact(axis):
    rng = np.random.default_rng(12)
    x = torch.as_tensor(rng.standard_normal((7, 6, 5)))
    blocks = [(0, 3), (3, 6), (6, 7)]
    dx = [huber_mm.diff(x, l0, l1, axis) for l0, l1 in blocks]
    vs = [torch.as_tensor(rng.standard_normal(tuple(d.shape))) for d in dx]
    out = torch.zeros_like(x)
    for (l0, l1), v in zip(blocks, vs):
        huber_mm.add_diff_t_(out, v, l0, l1, axis, 1.0)
    lhs = sum(float((d * v).sum()) for d, v in zip(dx, vs))
    assert abs(lhs - float((x * out).sum())) <= 1e-12 * abs(lhs)
    # the blocks' differences are those of the whole cube, each once
    assert torch.equal(torch.cat(dx), torch.diff(x, dim=axis))


def test_reference_mm_lowers_the_objective():
    rng = np.random.default_rng(13)
    op = Dense((6, 4, 4), rng)
    prior_list = huber_mm.priors(0.5, 0.2, 0.5, 0.2)
    y = op.forward(torch.as_tensor(rng.random(op.x_shape)))
    j = [float(huber_mm.objective(op, y, huber_mm.mm_solve(op, y, op.adjoint(y), prior_list, n, 4),
                                  prior_list)) for n in (1, 3, 10)]
    assert float(huber_mm.objective(op, y, op.adjoint(y), prior_list)) > j[0] > j[1] > j[2]


def test_float32_mm_from_hty_stays_finite_and_near_float64():
    """From Hᵗy on a small MIRI operator at the flagship's µ the gradient's
    squared norm passes float32's range (~1e43 here): the float32 MM has to
    stay finite and within 2e-3 of the float64 MM on the same tables
    (6.3e-4 after 10 steps; float32 loses some 11 bits in the first step
    from a start ~5e8 times the cube's scale)."""
    cfg = json.loads((ROOT / "benchmark" / "configs" / "flagship-cube-wplane-banded.json").read_text())
    cfg["problem"].update({k: CUBE[k] for k in ("npix", "bands", "n_pointings", "lambda_subsample")})
    model = program.build(cfg, torch.device("cpu"), program.Stages(lambda *a: None))
    y = model.forward(program.seed_unknown(cfg, SEED, torch.device("cpu")))
    mu = dict(PARAMS, spat_reg=5000.0, spec_reg=5000.0)
    a = vox_reconstruction(y, model, **mu, max_iter=10)
    assert torch.isfinite(a.x).all() and np.isfinite(a.grad_norm).all()
    model.to("cpu", torch.float64)
    b = vox_reconstruction(y.double(), model, **mu, max_iter=10).x
    assert float(b.abs().max()) > 1e6  # still near the start's scale
    assert float((a.x.double() - b).norm() / b.norm()) <= 2e-3


# ---------------------------------------------------------------------------
# the voxel cell as files alone, end to end

TOY_LIMITS = {"x_rel_l2": 2e-3, "x_max_abs": 2e-3}  # well above the sound run here (float32, CPU: 2.6e-4)
# upstream's edge-preserving reconstruction at the flagship fusion's µ, thresholds where the seeded
# cube's differences mostly lie in the Huber's linear part
VOX5 = {"kind": "vox_mm", "maximum_iterations": 5, "spat_reg": 5000.0, "spat_th": 0.1,
        "spec_reg": 5000.0, "spec_th": 0.1, "init": "Hty", "loop": "graph", "warmup_iterations": 2,
        "sample": 3, "trace_units": 1}


@pytest.fixture(scope="module")
def vox_cell(tmp_path_factory):
    root = tmp_path_factory.mktemp("checkout")
    shutil.copytree(ROOT / "benchmark", root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bd = root / "benchmark"
    bench = spec.load_benchmark(ROOT)
    cfg = json.loads((bd / "configs" / "flagship-cube-wplane-banded.json").read_text())
    cfg["problem"].update({k: CUBE[k] for k in ("npix", "bands", "n_pointings", "lambda_subsample")})
    (bd / "configs" / "toy-cube.json").write_text(json.dumps(cfg))
    (bd / "traffic" / "vox5.json").write_text(json.dumps(VOX5))
    (bd / "limits" / "toy-cube.vox5.json").write_text(json.dumps(TOY_LIMITS))
    bench["configs"].append({"name": "toy-cube", "source": "https://example.org", "reduced": [],
                             "file": "benchmark/configs/toy-cube.json", "why": "the cube unknown"})
    bench["workloads"].append({"name": "toy-cube.vox5", "config": "toy-cube", "traffic": "vox5",
                               "chips": 1, "why": "the voxel reconstruction"})
    for m in bench["end_to_end"]:
        if m["name"] == "cg_ms_per_iter":
            m["workloads"].append("toy-cube.vox5")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return lambda: spec.cell("toy-cube.vox5", root=root, bench_dir=bd)


def _drive(cell):
    args = types.SimpleNamespace(seed=SEED, seconds=0.2, trace=0)
    return run.run_cell(args, torch.device("cpu"), cell, clock=lambda: 0.0)


def test_a_vox_cell_from_files_alone_is_correct(vox_cell):
    cell = vox_cell()
    assert cell["traffic"]["kind"] == "vox_mm" and cell["config"]["problem"]["unknown"] == "cube"
    res = _drive(cell)
    assert res["correct"], res["checks"]
    assert set(res["metrics"]) == {"setup_s", "cg_ms_per_iter", "peak_gib"}


def test_a_vox_cell_missing_a_band_is_not_correct(vox_cell, monkeypatch):
    from surfh_tpu_torch.models.spectro import SpectroSigRLSCT

    forward = SpectroSigRLSCT.forward

    def dropped(self, x, plain=False):
        y = forward(self, x, plain).clone()
        y[int(self._idx[0]) : int(self._idx[1])] = 0
        return y

    monkeypatch.setattr(SpectroSigRLSCT, "forward", dropped)
    res = _drive(vox_cell())
    assert not res["correct"], res["checks"]
    assert all(n["value"] > 10 * n["limit"] for n in res["checks"].values()), res["checks"]


def test_a_pinned_cg_cell_from_files_alone_is_correct(vox_cell):
    """The cube's CG cell's own kind (`cg_solve_pinned`) on the same toy
    configuration: `correct`, its answers in the pool's buffers."""
    cell = vox_cell()
    cell["traffic"] = json.loads((cell["bench_dir"] / "traffic" / "cg50-pinned.json").read_text())
    cell["traffic"]["maximum_iterations"] = 5
    res = _drive(cell)
    assert res["correct"], res["checks"]


def test_pinned_sample_keeps_what_sample_keeps():
    from benchmark.bench.pinned import PinnedSample
    from benchmark.bench.traffic import Sample

    plain, pinned = Sample(3, SEED), PinnedSample(3, SEED, torch.zeros(2, 3))
    for i in range(20):
        value = torch.full((2, 3), float(i))
        plain.offer(i, lambda: value.clone())
        pinned.offer(i, value)
        assert [j for j, _ in pinned.answers()] == [j for j, _ in plain.answers()]
        assert all(torch.equal(a, b) for (_, a), (_, b) in zip(pinned.answers(), plain.answers()))
        assert len(pinned.free) == len(pinned.pool) - len(pinned.answers())
    assert len(pinned.pool) == 4


# ---------------------------------------------------------------------------
# spans


def _names(events):
    return [(e.name, e.time_range.start, e.time_range.end) for e in events if e.name.startswith("surfh.")]


def _inside(inner, outers) -> bool:
    return any(s <= inner[1] and inner[2] <= e for _, s, e in outers)


def test_mmmg_huber_spans_count_and_nest():
    rng = np.random.default_rng(3)
    H = torch.as_tensor(rng.standard_normal((40, 30)))
    y = torch.as_tensor(rng.standard_normal(40))
    priors = [(lambda x: x, lambda x: x, 0.3, 0.05)]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        res = mmmg_huber(lambda x: H @ x, lambda r: H.T @ r, y, priors, torch.zeros(30, dtype=torch.float64),
                         max_iter=50)
    spans = _names(prof.events())
    assert Counter(n for n, _, _ in spans) == {SOLVE: 1, ITER: 50, PRIOR: 100, READ: 1}
    assert len(res.grad_norm) == 49
    solve = [h for h in spans if h[0] == SOLVE]
    iters = [h for h in spans if h[0] == ITER]
    assert all(_inside(h, solve) for h in spans if h[0] != SOLVE)
    assert all(_inside(h, iters) for h in spans if h[0] == PRIOR)
    assert not any(_inside(h, iters) for h in spans if h[0] == READ)


KW = dict(im_size=31, n_lambda=16, n_tpl=3, n_channels=2, n_pointings=1, n_slit=3)


@pytest.fixture(scope="module")
def cube_model():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SURFH_TABLE_CACHE", "0")
        model, _ = make_model(setup=dict(make_setup(**KW), templates=None), dtype=np.float64,
                              window_local=False)
    return model.to("cpu", torch.float64)


def test_conv_cube_span_twice_a_cube_normal_and_never_on_the_maps_route(cube_model):
    maps_model, _ = make_model(**KW, dtype=np.float64, window_local=False)
    maps_model.to("cpu", torch.float64)
    for model, want in ((cube_model, 4), (maps_model, 0)):
        x = torch.ones(model.ishape, dtype=torch.float64)
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            for _ in range(2):
                model.normal(x)
        spans = _names(prof.events())
        counts = Counter(n for n, _, _ in spans)
        assert counts[NORMAL] == 2 and counts[CONV_CUBE] == want
        assert all(_inside(h, [s for s in spans if s[0] == NORMAL]) for h in spans if h[0] == CONV_CUBE)
    assert counts[CONV_MAPS] == 4  # the maps route's own span


def test_vox_reconstruction_spans_leave_the_iterates_unchanged(cube_model):
    x = torch.as_tensor(np.random.default_rng(7).random(cube_model.ishape))
    y = cube_model.forward(x)
    plain = vox_reconstruction(y, cube_model, **PARAMS, max_iter=6)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        traced = vox_reconstruction(y, cube_model, **PARAMS, max_iter=6)
    assert torch.equal(plain.x, traced.x)
    np.testing.assert_array_equal(plain.grad_norm, traced.grad_norm)
    counts = Counter(n for n, _, _ in _names(prof.events()))
    # Hᵗy, then a forward and a transpose a step and the first step's second forward: 7 pairs
    assert counts[ITER] == 6 and counts[PRIOR] == 12 and counts[CONV_CUBE] == 2 * 7


# ---------------------------------------------------------------------------
# the readers

SPAN_READERS = ("operator.conv_cube_host_ms_per_normal",)
ALIASES = {"fft.ms_per_iter.cube": "fft.ms_per_iter", "device.idle_frac.cube": "device.idle_frac.cg",
           "kernel.gather_rows.bw_share.cube": "kernel.gather_rows.bw_share.cg",
           "kernel.wblur_banded.flop_share.cube": "kernel.wblur_banded.flop_share.cg",
           "operator.launches_per_iter.cube": "operator.launches_per_iter",
           "solver.syncs_per_iter.cube": "solver.syncs_per_iter",
           "solver.host_reads_per_iter.cube": "solver.host_reads_per_iter",
           "solver.read_wait_ms_per_iter.cube": "solver.read_wait_ms_per_iter"}

# 2 iterations and 3 normals in a window of 1 s
DEVICE = [("void regular_bluestein_fft", 0.0, 0.2), ("Memcpy DtoD (Device -> Device)", 0.2, 0.3),
          ("void at::native::vectorized_elementwise_kernel", 0.3, 0.4),
          ("void at::native::reduce_kernel", 0.35, 0.45), ("Memcpy DtoH (Device -> Pageable)", 0.5, 0.9),
          ("gather_rows_kernel", 0.45, 0.47), ("wblur_banded_kernel", 0.47, 0.5)]
HOST = [("aten::_local_scalar_dense", 0.46, 0.47)]
SPANS = [(SOLVE, 0.0, 0.95), (ITER, 0.0, 0.4), (ITER, 0.4, 0.9), (NORMAL, 0.01, 0.1), (NORMAL, 0.1, 0.2),
         (NORMAL, 0.41, 0.5), (CONV_CUBE, 0.02, 0.05), (CONV_CUBE, 0.06, 0.08), (READ, 0.45, 0.47)]
WORK = {"gather_bytes": 1e6, "blur_seconds": 1e-3}


def _view(host=HOST + SPANS, units=None):
    return TraceView(window_s=1.0, device=list(DEVICE), host=list(host),
                     units=dict(units or {"iterations": 2, "normals": 3}), work=lambda: dict(WORK))


def test_the_cube_cells_readers_give_their_known_answers():
    t = _view()
    read = {name: spec.metric_reader(name) for name in SPAN_READERS + tuple(ALIASES)}
    assert read["operator.conv_cube_host_ms_per_normal"](t) == pytest.approx(50.0 / 3)
    assert read["fft.ms_per_iter.cube"](t) == pytest.approx(100.0)
    assert spec.metric_reader("copy.ms_per_iter.cube")(t) == pytest.approx(50.0)  # the DtoH copy left out
    assert read["device.idle_frac.cube"](t) == pytest.approx(100.0 * (1 - 0.9))
    assert read["operator.launches_per_iter.cube"](t) == pytest.approx(5 / 2)
    assert read["solver.syncs_per_iter.cube"](t) == pytest.approx(0.5)
    assert read["solver.host_reads_per_iter.cube"](t) == pytest.approx(0.5)
    assert read["solver.read_wait_ms_per_iter.cube"](t) == pytest.approx(10.0)


@pytest.mark.parametrize("name", sorted(ALIASES))
def test_a_cube_alias_reads_what_its_metric_reads(name):
    """Each reader of the cube cell that re-reads an accepted metric gives
    that metric's value on the same view, and nothing where it finds
    nothing."""
    alias, original = spec.metric_reader(name), spec.metric_reader(ALIASES[name])
    t = _view()
    assert alias(t) is not None and alias(t) == original(t)
    empty = TraceView(window_s=1.0, device=[], host=[], units={"iterations": 0, "normals": 0},
                      work=lambda: dict(WORK))
    assert alias(empty) is None and original(empty) is None


@pytest.mark.parametrize("name", SPAN_READERS)
def test_nothing_to_read_without_the_spans(name):
    read = spec.metric_reader(name)
    assert read(_view(host=HOST)) is None
    # the parent's spans: the CG's iterations and normals, but none of this PR's
    assert read(_view(host=HOST + [h for h in SPANS if h[0] in (SOLVE, ITER, NORMAL)])) is None
    assert read(_view(units={"iterations": 3, "normals": 3})) is None
