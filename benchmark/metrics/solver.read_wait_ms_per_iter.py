"""Host milliseconds inside the solver's ``surfh.solver.host_read`` spans,
per CG iteration: how long the host waits for the device to drain, the
device's lead over the host."""

from benchmark.bench import spans


def read(t):
    n = spans.counts(t)
    if n is None:
        return None
    return 1e3 * spans.span_seconds(t, spans.HOST_READ) / n[0]
