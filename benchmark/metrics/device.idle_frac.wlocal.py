"""The device's idle share (%) of a traced CG solve on the dense window-local
operator: `device.idle_frac.cg`'s reading."""

from benchmark.bench.spec import metric_reader

read = metric_reader("device.idle_frac.cg")
