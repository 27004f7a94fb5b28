"""Kernel #1's share (%) of its least time, over a traced CG solve on the
dense window-local operator: `kernel.gather_rows.bw_share.cg`'s reading, the
gathers' bytes counted at Q = W (the λ-rank gate closed)."""

from benchmark.bench.spec import metric_reader

read = metric_reader("kernel.gather_rows.bw_share.cg")
