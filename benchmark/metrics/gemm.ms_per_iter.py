"""Device milliseconds of the GEMM class (cuBLAS) per CG iteration traced."""


def read(t):
    it = t.units["iterations"]
    ms = t.seconds("gemm") * 1e3
    return ms / it if it and ms > 0 else None
