"""The readers of the program's own spans (`bench/spans.py` and the six
metrics on it) on hand-built views: their known answers, nothing to read
where the spans are missing or disagree with the traced units, a gap put
down to the innermost span, and the other readers blind to the spans."""

from pathlib import Path

import pytest

from benchmark.bench import spans, spec
from benchmark.bench.trace import TraceView

NEW = ("solver.host_reads_per_iter", "solver.read_wait_ms_per_iter", "solver.idle_ms_per_iter",
       "operator.host_ms_per_normal", "operator.band_host_ms_per_normal", "operator.idle_ms_per_iter")

# one solve of 2 iterations and 3 normals in a window of 1 s; device gaps
# [0.10, 0.12] under a band, [0.28, 0.32] under a host read, [0.55, 0.60]
# under an iteration between its read and the next, [0.85, 1.0] after the solve
DEVICE = [("void gather_rows_kernel<4>", 0.0, 0.10), ("regular_bluestein_fft", 0.12, 0.28),
          ("wblur_banded_kernel", 0.32, 0.45), ("sm90_xmma_gemm", 0.40, 0.55),
          ("Memcpy DtoH", 0.60, 0.85)]
ASIDE = [("aten::_local_scalar_dense", 0.29, 0.305), ("cudaDeviceSynchronize", 0.9, 0.99),
         ("aten::add", 0.11, 0.115)]
SPANS = [("surfh.solver.solve", 0.0, 0.9),
         ("surfh.op.normal", 0.02, 0.20), ("surfh.op.band.1a", 0.03, 0.09), ("surfh.op.band.1b", 0.09, 0.15),
         ("surfh.solver.host_read", 0.20, 0.25), ("surfh.solver.host_read", 0.25, 0.31),
         ("surfh.solver.iter", 0.31, 0.58),
         ("surfh.op.normal", 0.33, 0.50), ("surfh.op.band.1a", 0.34, 0.40), ("surfh.op.band.1b", 0.41, 0.48),
         ("surfh.solver.host_read", 0.52, 0.57),
         ("surfh.solver.iter", 0.58, 0.89),
         ("surfh.op.normal", 0.59, 0.80), ("surfh.op.band.1a", 0.60, 0.70), ("surfh.op.band.1b", 0.71, 0.78),
         ("surfh.solver.host_read", 0.82, 0.88)]
UNITS = {"iterations": 2, "normals": 3}


def view(host=ASIDE + SPANS, units=UNITS):
    return TraceView(window_s=1.0, device=list(DEVICE), host=list(host), units=dict(units),
                     work=lambda: {"gather_bytes": 3.35e9, "blur_seconds": 0.01})


def read(name):
    return spec.metric_reader(name)


def test_readers_give_their_known_answers():
    t = view()
    assert read("solver.host_reads_per_iter")(t) == pytest.approx(2.0)  # 4 reads, 2 iterations
    assert read("solver.read_wait_ms_per_iter")(t) == pytest.approx(110.0)  # 0.22 s of reads
    assert read("solver.idle_ms_per_iter")(t) == pytest.approx(45.0)  # 0.04 + 0.05 s
    assert read("operator.idle_ms_per_iter")(t) == pytest.approx(10.0)  # 0.02 s
    assert read("operator.host_ms_per_normal")(t) == pytest.approx(560.0 / 3)  # 0.18 + 0.17 + 0.21 s
    assert read("operator.band_host_ms_per_normal")(t) == pytest.approx(420.0 / 3)
    assert spans.counts(t) == (2, 3)


def test_a_gap_goes_to_the_innermost_span():
    idle = spans.idle_by_span(view())
    assert idle == {"surfh.op.band.1b": pytest.approx(0.02), "surfh.solver.host_read": pytest.approx(0.04),
                    "surfh.solver.iter": pytest.approx(0.05), None: pytest.approx(0.15)}
    # the attributed idle and the rest make up the device's idle time
    t = view()
    assert sum(idle.values()) == pytest.approx(t.window_s - t.busy_s)


def test_innermost_of_nested_spans():
    nested = [("a", 0, 10), ("b", 1, 4), ("c", 2, 3), ("d", 5, 6)]
    assert spans.innermost(nested, [0.5, 1.5, 2.5, 3.5, 4.5, 5.5, 11]) == ["a", "b", "c", "b", "a", "d", None]
    assert spans.innermost([], [1.0]) == [None]


@pytest.mark.parametrize("name", NEW)
def test_nothing_to_read_without_the_program_spans(name):
    assert read(name)(view(host=ASIDE)) is None


@pytest.mark.parametrize("name", NEW)
@pytest.mark.parametrize("units", [{"iterations": 3, "normals": 3}, {"iterations": 2, "normals": 4},
                                   {"iterations": 0, "normals": 0}])
def test_nothing_to_read_where_the_counts_disagree(name, units):
    assert read(name)(view(units=units)) is None


def test_the_other_readers_do_not_see_the_spans():
    new = set(NEW)
    names = [p.stem for p in sorted((Path(spec.BENCH) / "metrics").glob("*.py")) if p.stem not in new]
    assert "solver.syncs_per_iter" in names and "device.idle_frac.cg" in names
    with_spans, without = view(), view(host=ASIDE)
    for name in names:
        assert read(name)(with_spans) == read(name)(without), name
    assert with_spans.kernels() == without.kernels() and with_spans.busy_s == without.busy_s
