"""Host milliseconds inside ``surfh.op.conv.cube`` per normal application:
the enqueue of the cube route's two full-cube FFT convs (`conv_otf_`), any
wait on a full launch queue included.  Nothing where the program records
no such span (an older commit)."""

from benchmark.bench import spans

CONV_CUBE = "surfh.op.conv.cube"


def read(t):
    n = spans.counts(t)
    if n is None or not any(name == CONV_CUBE for name, _, _ in spans.program_spans(t)):
        return None
    return 1e3 * spans.span_seconds(t, CONV_CUBE) / n[1]
