"""Kernel #1's share (%) of its least time, over a traced CG solve on the
voxel cube: `kernel.gather_rows.bw_share.cg`'s reading, the gathers' bytes
counted for a cube (each band's λ window W)."""

from benchmark.bench.spec import metric_reader

read = metric_reader("kernel.gather_rows.bw_share.cg")
