"""The GEMM class (cuBLAS): the least time of the dense window-local conv's
and the dense blur's products (`bench/gemm_work.py`, from the configuration
of `flagship-wlocal.cg50` in this checkout) at the card's FP32 rate, as a
share (%) of the class's device time, over a traced CG solve."""

from pathlib import Path

from benchmark.bench import gemm_work, spec

WORKLOAD = "flagship-wlocal.cg50"
BENCH_DIR = Path(__file__).resolve().parents[1]


def read(t):
    measured = t.seconds("gemm")
    if measured <= 0 or not t.units["iterations"]:
        return None
    config = spec.cell(WORKLOAD, root=BENCH_DIR.parent, bench_dir=BENCH_DIR)["config"]
    least = gemm_work.least_seconds(config) * t.units["normals"]
    return 100.0 * least / measured
