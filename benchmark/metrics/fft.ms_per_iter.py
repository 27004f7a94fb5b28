"""Device milliseconds of the cuFFT class per CG iteration traced."""


def read(t):
    it = t.units["iterations"]
    ms = t.seconds("fft") * 1e3
    return ms / it if it and ms > 0 else None
