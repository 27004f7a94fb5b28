"""The port's host-lane spans (`utils.profiling.span`) in the CG solvers and
the operator, and the device time of a trace (`device_busy_us`).

No JAX here: the card test at the end runs on the GPU machine, which has
none (``python -m pytest --noconftest tests/test_torch_spans.py -m cuda``).

* Under `torch.profiler` a 3-iteration solve on a small `SpectroSigRLSCT`,
  in W-plane and window-local mode, with `lcg` and `mmmg`, each loop:
  the exact count of every span, their nesting, and the same iterates as
  without the profiler; window-local, ``surfh.op.conv.window`` (the dense
  conv pair) twice a band a normal, inside the band's span.
* Without a profiler `span` is one shared no-op and makes no range.
* ``surfh.op.conv.maps`` (the templates mixed into the FFT conv) twice a
  normal on the W-plane model with templates, never in cube mode nor on
  the window-local λ-rank model.
* No span name falls in a class of the benchmark's device kernels (the
  Huber MM's and the cube conv's too: `tests/test_torch_vox.py` counts them).
* `profiling.trace()` writes the spans into its Chrome trace.
* `device_busy_us` counts overlapping device intervals once and skips the
  host's events and the card lane's annotations.
"""

import json
from collections import Counter
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from benchmark.bench.yardstick import kernel_class
from surfh_tpu_torch.models.spectro import _band_span
from surfh_tpu_torch.simulation.synthetic import make_model, make_setup
from surfh_tpu_torch.solvers.criterion import QuadCriterion_MRS
from surfh_tpu_torch.utils import profiling

KW = dict(im_size=31, n_lambda=16, n_tpl=3, n_channels=2, n_pointings=1, n_slit=3)
N_ITER = 3
MODES = {"wplane": dict(window_local=False), "wlocal": dict(window_local=True, conv_impl="matmul")}
CASES = [(m, s, loop) for m in MODES for s in ("lcg", "mmmg") for loop in ("graph", "dispatch")]
SOLVE, ITER, READ = "surfh.solver.solve", "surfh.solver.iter", "surfh.solver.host_read"
NORMAL, BAND, CONV = "surfh.op.normal", "surfh.op.band.", "surfh.op.conv.maps"
WINDOW = "surfh.op.conv.window"


@pytest.fixture(scope="module")
def crits():
    out = {}
    for mode, kw in MODES.items():
        model, setup = make_model(**KW, dtype=np.float64, **kw)
        model.to("cpu", torch.float64)
        crit = QuadCriterion_MRS(1.0, model.forward(setup["maps"]), model, 10.0)
        crit.b  # µ_s Hᵗy, outside the traced solves
        out[mode] = crit
    return out


def _solve(crit, method, loop):
    return crit.run_method(method, maximum_iterations=N_ITER, solver_loop=loop)


def _traced(crit, method, loop):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        res = _solve(crit, method, loop)
    spans = [(e.name, e.time_range.start, e.time_range.end) for e in prof.events()
             if e.name.startswith("surfh.")]
    return res, spans, prof.events()


def _inside(inner, outers) -> bool:
    return any(s <= inner[1] and inner[2] <= e for _, s, e in outers)


@pytest.mark.parametrize("mode,method,loop", CASES)
def test_spans_count_and_nest(crits, mode, method, loop):
    crit = crits[mode]
    res, spans, events = _traced(crit, method, loop)
    assert res.n_iter == N_ITER
    n_bands = len(crit.model.channels)
    normals = N_ITER + 1  # the initial residual's (lcg) or gradient's (mmmg), then one an iteration
    # graph: the limit, the initial norm and one an iteration; dispatch: the
    # limit, the check at the last iteration and the history
    reads = N_ITER + 2 if loop == "graph" else 3
    # W-plane: a band span in the forward and one in the adjoint; window-local: one in the fused normal
    per_normal = 2 if mode == "wplane" else 1
    want = {SOLVE: 1, ITER: N_ITER, READ: reads, NORMAL: normals}
    want.update({name: normals * per_normal for name in crit.model._band_spans})
    if mode == "wplane":  # the templates' conv: once in the forward, once in the adjoint
        want[CONV] = 2 * normals
    else:  # the dense window conv pair: both directions of every band
        want[WINDOW] = 2 * n_bands * normals
    assert len(crit.model._band_spans) == n_bands
    assert Counter(n for n, _, _ in spans) == want
    by = {k: [h for h in spans if h[0] == k] for k in (SOLVE, ITER, READ, NORMAL)}
    solve = by[SOLVE]
    assert all(_inside(h, solve) for h in spans if h[0] != SOLVE)
    assert all(_inside(h, by[NORMAL]) for h in spans if h[0].startswith(BAND) or h[0] == CONV)
    bands = [h for h in spans if h[0].startswith(BAND)]
    assert not any(_inside(h, bands) for h in spans if h[0] == CONV)
    assert all(_inside(h, bands) for h in spans if h[0] == WINDOW)
    # a step's normal inside its iteration; the first normal before the first iteration
    assert sum(_inside(h, by[ITER]) for h in by[NORMAL]) == N_ITER
    # host-lane ranges: none is a user annotation (which the profiler mirrors on the card's lane)
    assert not any(e.is_user_annotation for e in events if e.name.startswith("surfh."))


@pytest.mark.parametrize("mode,method,loop", CASES)
def test_spans_leave_the_iterates_unchanged(crits, mode, method, loop):
    crit = crits[mode]
    plain = _solve(crit, method, loop)
    traced, _, _ = _traced(crit, method, loop)
    assert torch.equal(plain.x, traced.x)
    np.testing.assert_array_equal(plain.grad_norm, traced.grad_norm)
    assert (plain.n_iter, plain.converged) == (traced.n_iter, traced.converged)


def test_span_without_a_profiler_is_one_shared_noop(crits, monkeypatch):
    assert profiling.span(SOLVE) is profiling.span(NORMAL)
    with profiling.span(ITER) as entered:
        assert entered is None

    def refuse(name):
        raise AssertionError(f"a range {name!r} made with no profiler running")

    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", refuse)
    for mode in MODES:
        assert _solve(crits[mode], "lcg", "graph").n_iter == N_ITER
    with pytest.raises(AssertionError, match="a range"):
        with profile(activities=[ProfilerActivity.CPU]):
            profiling.span(ITER)


def _normal_spans(model, n=2):
    x = torch.ones(model.ishape, dtype=torch.float64)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(n):
            model.normal(x)
    return Counter(e.name for e in prof.events() if e.name.startswith("surfh."))


def test_conv_maps_span_twice_a_normal_with_templates_only(crits):
    assert _normal_spans(crits["wplane"].model)[CONV] == 4
    cube = make_model(setup=dict(make_setup(**KW), templates=None), dtype=np.float64,
                      window_local=False)[0].to("cpu", torch.float64)
    assert not cube.lmm
    rank = make_model(**dict(KW, n_lambda=120, n_tpl=2), dtype=np.float64, window_local=True,
                      psf_stamps=True, conv_impl="matmul", conv_freq_rtol=1e-6,
                      conv_rank_rtol=1e-7)[0].to("cpu", torch.float64)
    assert all(rank._rank_band(c) for c in range(len(rank.channels)))
    for model in (cube, rank):
        counts = _normal_spans(model)
        assert counts[NORMAL] == 2 and CONV not in counts


def test_span_names_fall_in_no_kernel_class(crits):
    names = {SOLVE, ITER, READ, NORMAL, CONV, WINDOW, "surfh.op.conv.cube", "surfh.solver.prior"}
    for crit in crits.values():
        names.update(crit.model._band_spans)
    for name in names:
        assert name.startswith("surfh.")
        assert kernel_class(name) == "other", name


def test_band_spans_take_the_instrument_name_else_the_index(crits):
    model = crits["wplane"].model
    assert model._band_spans == [BAND + instr.name for instr in model.instrs]
    instrs = [SimpleNamespace(name="1a"), SimpleNamespace(name="_"), SimpleNamespace(name="")]
    assert [_band_span(instr, c) for c, instr in enumerate(instrs)] == [BAND + "1a", BAND + "1", BAND + "2"]


def test_trace_json_holds_the_spans(crits, tmp_path):
    with profiling.trace(str(tmp_path)):
        _solve(crits["wplane"], "lcg", "graph")
    with open(tmp_path / "trace.json") as fh:
        names = Counter(e.get("name") for e in json.load(fh)["traceEvents"])
    assert names[SOLVE] == 1 and names[ITER] == N_ITER and names[NORMAL] == N_ITER + 1
    assert names[READ] == N_ITER + 2


def _event(start, end, device="cuda", annotation=False):
    dtype = torch.autograd.DeviceType.CUDA if device == "cuda" else torch.autograd.DeviceType.CPU
    return SimpleNamespace(time_range=SimpleNamespace(start=start, end=end), device_type=dtype,
                           is_user_annotation=annotation)


def test_device_busy_counts_overlaps_once():
    events = [_event(0, 10), _event(5, 12), _event(20, 25), _event(21, 22), _event(30, 30)]
    assert profiling.device_busy_us(events) == 17  # [0, 12] and [20, 25]
    assert profiling.device_busy_us([]) == 0


def test_device_busy_skips_the_host_and_annotations():
    events = [_event(0, 10), _event(0, 100, annotation=True), _event(50, 200, device="cpu"),
              _event(90, 95)]
    assert profiling.device_busy_us(events) == 15


def test_device_busy_of_a_record_function_trace():
    """A real trace: a `record_function` range is a user annotation, and on
    the CPU no event lies on the card's lane."""
    x = torch.ones(64)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("bench.window"):
            (x + 1).sum()
    assert any(e.is_user_annotation for e in prof.events() if e.name == "bench.window")
    assert profiling.device_busy_us(prof.events()) == 0


@pytest.mark.cuda
def test_spans_stay_off_the_card_lane():
    """On the card: a traced W-plane solve has its spans on the host lane
    and no event of the card's lane bears a ``surfh.`` name."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the card's lane exists only there")
    model, setup = make_model(**KW, dtype=np.float32)
    model.to("cuda", torch.float32)
    crit = QuadCriterion_MRS(1.0, model.forward(setup["maps"]), model, 10.0)
    crit.b
    _solve(crit, "lcg", "graph")  # warm-up
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _solve(crit, "lcg", "graph")
        torch.cuda.synchronize()
    events = prof.events()
    card = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    assert card and not [e.name for e in card if e.name.startswith("surfh.")]
    host = Counter(e.name for e in events if e.name.startswith("surfh."))
    assert host[SOLVE] == 1 and host[ITER] == N_ITER and host[NORMAL] == N_ITER + 1
    assert profiling.device_busy_us(events) > 0
