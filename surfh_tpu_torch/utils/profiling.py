"""Tracing / profiling utilities: the counterpart of
`surfh_tpu/utils/profiling.py`.

Named phase timers with a summary table, `torch.profiler` trace capture,
and a chained timer: N dependent applications per measurement, timed
between CUDA events on the card (the host clock on the CPU).
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict

import numpy as np
import torch


class PhaseTimer:
    """Accumulating named wall-clock phases.

    >>> timer = PhaseTimer()
    >>> with timer("forward"):
    ...     y = model.forward(x)
    >>> print(timer.summary())
    """

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def __call__(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def summary(self) -> str:
        rows = ["phase                    total      calls    per-call"]
        for name in sorted(self.totals, key=self.totals.get, reverse=True):
            t, n = self.totals[name], self.counts[name]
            rows.append(f"{name:<22} {t:9.3f}s {n:8d} {t / n * 1e3:9.2f}ms")
        return "\n".join(rows)

    def reset(self):
        self.totals.clear()
        self.counts.clear()


@contextlib.contextmanager
def trace(log_dir: str = "surfh_trace"):
    """Capture a `torch.profiler` trace of the CPU and, where there is one,
    the card; writes a Chrome trace (``trace.json``, view with Perfetto)
    under `log_dir` and yields the profiler."""
    from pathlib import Path

    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    Path(log_dir).mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(Path(log_dir) / "trace.json"))


def chained_time(fn, x: torch.Tensor, chain: int = 10, reps: int = 3) -> float:
    """Median seconds per application of `fn`, over `chain` dependent
    applications per measurement: each input is ``x + 1e-30 · acc``, where
    `acc` sums the outputs so far, so no application can start before the
    previous one ends.  The chain is timed between CUDA events when `x` is
    on the card, by the host clock otherwise; one untimed chain warms up.
    The feedback's add and sum are inside the time, as in the reference."""
    def run():
        acc = torch.zeros((), dtype=x.dtype, device=x.device)
        for _ in range(chain):
            acc = acc + fn(x + acc * 1e-30).sum().to(x.dtype)
        return acc

    run()
    times = []
    for _ in range(reps):
        if x.is_cuda:
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            run()
            e1.record()
            e1.synchronize()
            times.append(e0.elapsed_time(e1) * 1e-3)
        else:
            t0 = time.perf_counter()
            run()
            times.append(time.perf_counter() - t0)
    return float(np.median(times)) / chain
