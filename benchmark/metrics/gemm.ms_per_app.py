"""Device milliseconds of the GEMM class (cuBLAS) per fwd+adjoint application traced."""


def read(t):
    n = t.units["normals"]
    ms = t.seconds("gemm") * 1e3
    return ms / n if n and ms > 0 else None
