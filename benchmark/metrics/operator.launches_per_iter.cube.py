"""Kernels launched per CG iteration traced, on the voxel cube:
`operator.launches_per_iter`'s reading."""

from benchmark.bench.spec import metric_reader

read = metric_reader("operator.launches_per_iter")
