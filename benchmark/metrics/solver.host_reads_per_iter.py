"""The solver's own reads of a device value on the host (its
``surfh.solver.host_read`` spans: the stopping limit, each norm, a
dispatch loop's history), per CG iteration its ``surfh.solver.iter`` spans
count.  `solver.syncs_per_iter` also counts the harness's synchronise."""

from benchmark.bench import spans


def read(t):
    n = spans.counts(t)
    if n is None:
        return None
    return sum(1 for h in spans.program_spans(t) if h[0] == spans.HOST_READ) / n[0]
