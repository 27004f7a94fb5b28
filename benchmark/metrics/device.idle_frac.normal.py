"""The device's idle share (%) of the traced replays: 1 − the union of its
kernel, memcpy and memset intervals over the traced wall time."""


def read(t):
    if not t.units["normals"] or t.window_s <= 0 or t.busy_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
