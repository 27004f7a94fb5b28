"""Device idle milliseconds per CG iteration in the gaps whose middle falls
under a ``surfh.op.*`` span: the device starved while the host enqueues
the operator."""

from benchmark.bench import spans


def read(t):
    n = spans.counts(t)
    if n is None or not t.device:
        return None
    return 1e3 * spans.idle_seconds(t, spans.OPERATOR) / n[0]
