"""The program's own spans in a `TraceView`, and the device's idle time put
down to them.

`surfh_tpu_torch` records host-lane ranges named ``surfh.*`` while a
profiler runs (``utils/profiling.py::span``): ``surfh.solver.solve``,
``surfh.solver.iter`` and ``surfh.solver.host_read`` in the CG solvers,
``surfh.op.normal`` and ``surfh.op.band.<band>`` in the operator.  They
reach the view as host operations.  The names are fixed here, as the
yardstick's other measures are, so the readers do not move when the
program does.  A program without the spans (an older commit) gives the
readers nothing to read: they return None.
"""

from __future__ import annotations

from .trace import merged

PREFIX = "surfh."
SOLVER = "surfh.solver."
OPERATOR = "surfh.op."
ITER = "surfh.solver.iter"
HOST_READ = "surfh.solver.host_read"
NORMAL = "surfh.op.normal"
BAND = "surfh.op.band."


def program_spans(t) -> list:
    """The view's ``surfh.*`` host spans, [(name, start, end)]."""
    return [h for h in t.host if h[0].startswith(PREFIX)]


def counts(t):
    """(iterations, normals) as the program's spans count them, or None
    where the view holds none or they disagree with ``t.units``."""
    names = [n for n, _, _ in program_spans(t)]
    it, normals = names.count(ITER), names.count(NORMAL)
    if not it or it != t.units["iterations"] or normals != t.units["normals"]:
        return None
    return it, normals


def span_seconds(t, prefix: str) -> float:
    """Host seconds inside the spans whose names start with `prefix` (such
    spans do not nest in one another)."""
    return sum(e - s for n, s, e in program_spans(t) if n.startswith(prefix))


def innermost(spans, points) -> list:
    """For each of the ascending `points`, the name of the innermost of the
    nested `spans` running at it (the one that started last), or None."""
    spans = sorted(spans, key=lambda h: (h[1], -h[2]))
    out, stack, i = [], [], 0
    for p in points:
        while i < len(spans) and spans[i][1] <= p:
            stack.append(spans[i])
            i += 1
        while stack and stack[-1][2] < p:
            stack.pop()
        out.append(stack[-1][0] if stack else None)
    return out


def idle_by_span(t) -> dict:
    """The device's idle seconds in the window by the innermost program span
    running at the middle of each gap (None: under no span); the gaps are
    those of `TraceView.breakdown`."""
    gaps, last = [], 0.0
    for s, e in merged([(s, e) for _, s, e in t.device]) + [[t.window_s, t.window_s]]:
        if s > last:
            gaps.append((last, s))
        last = max(last, e)
    out = {}
    for (s, e), name in zip(gaps, innermost(program_spans(t), [(s + e) / 2 for s, e in gaps])):
        out[name] = out.get(name, 0.0) + (e - s)
    return out


def idle_seconds(t, prefix: str) -> float:
    """The device's idle seconds put down to spans whose names start with `prefix`."""
    return sum(v for n, v in idle_by_span(t).items() if n is not None and n.startswith(prefix))
