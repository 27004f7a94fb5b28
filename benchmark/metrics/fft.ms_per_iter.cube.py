"""Device milliseconds of the cuFFT class per CG iteration traced, in the
voxel cube's cell: `fft.ms_per_iter`'s reading, the full-cube conv
(`conv_otf_`) there."""

from benchmark.bench.spec import metric_reader

read = metric_reader("fft.ms_per_iter")
