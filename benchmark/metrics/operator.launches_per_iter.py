"""Kernels that ran on the device, per CG iteration traced: each is one
launch, whether the host enqueued it eagerly or a graph replayed it."""


def read(t):
    it = t.units["iterations"]
    n = t.kernels()
    return n / it if it and n else None
