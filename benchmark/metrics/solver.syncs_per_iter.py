"""Host reads of a device value (`aten::_local_scalar_dense`) and explicit
synchronisations, per CG iteration traced."""

SYNCS = ("aten::_local_scalar_dense", "cudaDeviceSynchronize")


def read(t):
    it = t.units["iterations"]
    return t.host_count(SYNCS) / it if it else None
