"""Host milliseconds inside ``surfh.solver.host_read`` per CG iteration
traced, on the voxel cube: `solver.read_wait_ms_per_iter`'s reading."""

from benchmark.bench.spec import metric_reader

read = metric_reader("solver.read_wait_ms_per_iter")
