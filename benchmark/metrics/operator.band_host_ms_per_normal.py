"""Host milliseconds inside the ``surfh.op.band.*`` spans per normal
application: the bands' part of `operator.host_ms_per_normal`; the rest is
the cube-wide stages (T, the W-plane OTF conv, the concatenation)."""

from benchmark.bench import spans


def read(t):
    n = spans.counts(t)
    if n is None:
        return None
    return 1e3 * spans.span_seconds(t, spans.BAND) / n[1]
