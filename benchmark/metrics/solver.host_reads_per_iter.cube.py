"""The solver's ``surfh.solver.host_read`` spans per CG iteration traced,
on the voxel cube: `solver.host_reads_per_iter`'s reading."""

from benchmark.bench.spec import metric_reader

read = metric_reader("solver.host_reads_per_iter")
