"""Device idle milliseconds per CG iteration in the gaps whose middle falls
under a ``surfh.solver.*`` span (and under no operator span inside it):
the device drained and restarted around the solver's host reads."""

from benchmark.bench import spans


def read(t):
    n = spans.counts(t)
    if n is None or not t.device:
        return None
    return 1e3 * spans.idle_seconds(t, spans.SOLVER) / n[0]
