"""Host milliseconds inside ``surfh.op.conv.window`` per normal application:
the enqueue of the dense window-local conv pair (the DFT-matmul GEMM
chains, both directions of every band), any wait on a full launch queue
included.  Nothing where the program records no such span (an older
commit)."""

from benchmark.bench import spans

CONV_WINDOW = "surfh.op.conv.window"


def read(t):
    n = spans.counts(t)
    if n is None or not any(name == CONV_WINDOW for name, _, _ in spans.program_spans(t)):
        return None
    return 1e3 * spans.span_seconds(t, CONV_WINDOW) / n[1]
