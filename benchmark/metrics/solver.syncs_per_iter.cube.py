"""Host reads of a device value and synchronisations per CG iteration
traced, on the voxel cube: `solver.syncs_per_iter`'s reading."""

from benchmark.bench.spec import metric_reader

read = metric_reader("solver.syncs_per_iter")
