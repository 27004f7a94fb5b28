"""Tracing / profiling utilities: the counterpart of
`surfh_tpu/utils/profiling.py`.

Named phase timers with a summary table, `torch.profiler` trace capture,
a chained timer (N dependent applications per measurement, timed between
CUDA events on the card, the host clock on the CPU), the device time of a
run as the profiler reads it, and the card's published peaks, the
denominators of every bound and utilization the port reports.
"""

from __future__ import annotations

import contextlib
import subprocess
import time
from collections import defaultdict
from typing import Dict

import numpy as np
import torch

# NVIDIA H100 SXM, NVIDIA's data sheet (dense rates, at the 700 W limit)
FP32_FLOPS_PER_S = 67e12  # FP32 outside the tensor cores: the port runs FP32, TF32 off
HBM_BYTES_PER_S = 3.35e12  # device memory (HBM3)


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


def card_name(device) -> str:
    """The card's name and power limit as nvidia-smi reads them (the note
    every time taken on it stands beside), or "cpu" for the host."""
    if torch.device(device).type != "cuda":
        return "cpu"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0].strip()


def device_trace_ms(run_once, chain: int):
    """Device milliseconds per application of `run_once` (which runs
    `chain` applications and synchronises), from one `torch.profiler`
    trace: the durations of the device's kernel, memcpy and memset events
    summed (the host's lanes are not), over `chain`.  None when the trace
    holds no device event (no card, or a profiler that does not see it)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run_once()
    dev_us = sum(e.time_range.elapsed_us() for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA)
    if dev_us <= 0:
        return None
    return dev_us / 1e3 / max(int(chain), 1)
