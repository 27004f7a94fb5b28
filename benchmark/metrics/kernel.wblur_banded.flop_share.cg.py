"""Kernels #2 and #3 (`wblur_banded_*`, the add-the-parts pass included): the
least time of the banded blur's products (from the response's support at the
configuration's wblur_band_rtol) as a share (%) of their device time, over a
traced CG solve."""


def read(t):
    measured = t.seconds("wblur_banded")
    least = t.counts()["blur_seconds"] * t.units["normals"]
    if measured <= 0 or least <= 0 or not t.units["iterations"]:
        return None
    return 100.0 * least / measured
