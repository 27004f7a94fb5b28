"""The traced stretch of a run reduced to what the per-layer readers read.

`torch.profiler` (CPU and CUDA activities) records a bounded stretch of
the window, marked by a host span ``bench.window``.  `TraceView` keeps the
device's kernel, memcpy and memset intervals and the host's operations
inside that span; the device's busy time is the union of its intervals,
not their sum, and its idle share is taken over the whole span.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .yardstick import kernel_class

WINDOW_SPAN = "bench.window"
LOOK_BACK = 256  # host operations searched back from a moment for one that spans it


def merged(intervals) -> list:
    """[(start, end), ...] merged where they overlap, in order."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def union_length(intervals) -> float:
    """Total length covered by [(start, end), ...] (overlaps counted once)."""
    return sum(e - s for s, e in merged(intervals))


def host_at(host, hs, he, t: float) -> str:
    """The innermost host operation running at `t` (of `host` sorted by
    start, with their starts `hs` and ends `he`): among those that span it,
    the one that started last."""
    i = int(np.searchsorted(hs, t, side="right")) - 1
    for j in range(i, max(i - LOOK_BACK, -1), -1):
        if he[j] >= t:
            return host[j][0]
    return "(no host operation)"


@dataclass
class TraceView:
    """Times in seconds from the window's start.  `units` holds the work
    traced: ``iterations`` (CG) and ``normals`` (normal applications,
    the CG's initial residual included)."""

    window_s: float
    device: list  # [(name, start, end)] kernels, memcpys, memsets
    host: list  # [(name, start, end)] host operations and runtime calls
    units: dict
    work: object = None  # callable → yardstick.work_counts(config), computed at first use
    _work: dict = field(default=None, repr=False)

    def counts(self) -> dict:
        if self._work is None:
            self._work = self.work()
        return self._work

    @property
    def busy_s(self) -> float:
        return union_length([(s, e) for _, s, e in self.device])

    def seconds(self, cls: str) -> float:
        """Device seconds of one kernel class (their union)."""
        return union_length([(s, e) for n, s, e in self.device if kernel_class(n) == cls])

    def kernels(self) -> int:
        return sum(1 for n, _, _ in self.device if not n.lower().startswith(("memcpy", "memset")))

    def host_count(self, names) -> int:
        return sum(1 for n, _, _ in self.host if n in names)

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, by name, and the
        device's idle time, by the innermost host operation running at the
        middle of each gap."""
        by_op = {}
        for n, s, e in self.device:
            by_op[n] = by_op.get(n, 0.0) + (e - s)
        gaps, last = [], 0.0
        for s, e in merged([(s, e) for _, s, e in self.device]) + [[self.window_s, self.window_s]]:
            if s > last:
                gaps.append((last, s))
            last = max(last, e)
        host = sorted(self.host, key=lambda h: h[1])
        hs = np.array([h[1] for h in host])
        he = np.array([h[2] for h in host])
        by_host = {}
        for s, e in gaps:
            name = host_at(host, hs, he, (s + e) / 2)
            by_host[name] = by_host.get(name, 0.0) + (e - s)
        def order(d):
            return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]
        return {"device_ops": order(by_op), "idle_gaps": order(by_host)}


def view_from_profile(prof, units: dict, work) -> TraceView:
    """The TraceView of a finished `torch.profiler.profile` whose stretch
    ran inside ``record_function(WINDOW_SPAN)``."""
    import torch

    events = prof.events()
    spans = [e for e in events if e.name == WINDOW_SPAN and e.device_type == torch.autograd.DeviceType.CPU]
    if not spans:
        raise RuntimeError(f"the trace holds no {WINDOW_SPAN!r} span")
    w0, w1 = spans[0].time_range.start, spans[0].time_range.end
    device, host = [], []
    for e in events:
        s, t = max(e.time_range.start, w0), min(e.time_range.end, w1)
        if t < s or e.name == WINDOW_SPAN:
            continue
        item = (e.name, (s - w0) * 1e-6, (t - w0) * 1e-6)
        if e.device_type == torch.autograd.DeviceType.CUDA:
            device.append(item)
        else:
            host.append(item)
    return TraceView(window_s=(w1 - w0) * 1e-6, device=device, host=host, units=units, work=work)
