"""Device milliseconds of the copy class per CG iteration traced, less the
copies to the host (``Memcpy DtoH``: the kept answer's, the user's result
file): the cube route's chunk copy-backs, its clone of the unknown and the
gathers' bounding-box rows."""

from benchmark.bench.trace import union_length
from benchmark.bench.yardstick import kernel_class


def read(t):
    it = t.units["iterations"]
    ms = 1e3 * union_length([(s, e) for n, s, e in t.device
                             if kernel_class(n) == "copy" and not n.startswith("Memcpy DtoH")])
    return ms / it if it and ms > 0 else None
