"""Kernels #2 and #3's share (%) of their least time, over a traced CG
solve on the voxel cube: `kernel.wblur_banded.flop_share.cg`'s reading."""

from benchmark.bench.spec import metric_reader

read = metric_reader("kernel.wblur_banded.flop_share.cg")
