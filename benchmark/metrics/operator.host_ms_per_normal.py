"""Host milliseconds inside ``surfh.op.normal`` per normal application:
the enqueue of one HᵗH, any wait on a full launch queue included."""

from benchmark.bench import spans


def read(t):
    n = spans.counts(t)
    if n is None:
        return None
    return 1e3 * spans.span_seconds(t, spans.NORMAL) / n[1]
