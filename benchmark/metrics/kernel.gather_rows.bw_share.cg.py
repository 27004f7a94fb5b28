"""Kernel #1 (`gather_rows*`): the least time of the bytes the
configuration needs of its gathers over the card's memory rate, as a share (%)
of the device time of the gather kernels, over a traced CG solve."""

from benchmark.bench.yardstick import bound


def read(t):
    measured = t.seconds("gather_rows")
    if measured <= 0 or not t.units["iterations"]:
        return None
    return 100.0 * bound(t.counts()["gather_bytes"] * t.units["normals"]) / measured
