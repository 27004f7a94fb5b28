#!/usr/bin/env python3
"""Where the time of the port's flagship application goes.

    python3 scripts/torch_profile.py [--bands 1a,1b,...] [--wplane dense|banded |
                                     --wlocal stamps|otf] [--trace out.json]

Builds the flagship model of `surfh_tpu_torch` on one NVIDIA card — the
rank mode (as chip_smoke.py does), with `--wplane` the materialized-OTF
mode with that spectral blur (OTF built on the card, wblur_band_rtol=1e-4),
or with `--wlocal` the dense window-local mode (conv_rank_rtol 0,
conv_freq_rtol 1e-6) with OTF windows from the PSF stamps or cut from the
OTF built on the card — and measures the normal application (HᵗH x, the CG
hot loop):

* `--wlocal`: per band the conv's OTF support, FOV bbox and GEMM count
  (3·W·ha·Ka′·Kb′ + 2·W·ha·Kb′·wb multiply-adds a direction) and their FP32
  bound;
* eager time per application (CUDA events, 8 × 10 repetitions: the spread)
  and the host time to enqueue one application (no sync inside);
* the window-local modes: the device floor, one application captured in a
  CUDA graph, its replay time and its difference from the eager result,
  then the SM clock and power draw as nvidia-smi reads them;
* five applications under torch.profiler: device time by kernel class
  (GEMM, FFT, this repo's kernels, elementwise, reduction, copy), this
  repo's kernels one by one, the top kernels, the launch count, and the
  busy share of the profiled window (union of kernel intervals over the
  first-to-last-kernel span).

Needs a CUDA device; imports no JAX.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time
from collections import defaultdict

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

WORKERS = min(8, os.cpu_count() or 1)  # processes for the host table build
REPS = 5  # profiled applications
BAND_RTOL = 1e-4  # the banded blur's support threshold (--wplane banded)
FP32_FLOPS_PER_S = 67e12  # H100 SXM FP32 outside the tensor cores (data sheet)


def kernel_class(name: str) -> str:
    n = name.lower()
    if "gather_rows" in n:
        return "gather_rows (CUDA, this repo)"
    if "wblur_banded" in n:
        return "wblur_banded (CUDA, this repo)"
    if "fft" in n:
        return "FFT (cuFFT)"
    if any(k in n for k in ("gemm", "xmma", "cutlass", "sm90", "ampere", "cublas")):
        return "GEMM (cuBLAS)"
    if "reduce" in n:
        return "reduction"
    if "copy" in n or "memcpy" in n or "memset" in n or "cat" in n:
        return "copy / layout"
    if "elementwise" in n or "vectorized" in n:
        return "elementwise"
    return "other"


def graph_floor(model, x, event_ms, smi, vox) -> None:
    """The device floor: one normal application replayed as a CUDA graph."""
    import numpy as np
    import torch

    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up on a side stream before capture
        for _ in range(2):
            model.normal(x)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = model.normal(x)
    graph.replay()
    eager_out = model.normal(x)
    torch.cuda.synchronize()
    diff = float((captured - eager_out).abs().max() / eager_out.abs().max())
    replay = [event_ms(graph.replay) for _ in range(8)]
    clocks = smi("clocks.sm,power.draw")  # read right after the replays, card still warm
    print(f"  CUDA-graph replay (8 x 10): {min(replay):.3f}-{max(replay):.3f} ms/app "
          f"-> {vox / (np.median(replay) * 1e-3) / 1e9:.2f} GVox/s; max rel diff vs eager {diff:.3e}")
    print(f"  SM clock, power draw after the replays: {clocks}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--bands", default=None)
    ap.add_argument("--wplane", choices=("dense", "banded"), default=None,
                    help="profile the materialized-OTF model with this blur")
    ap.add_argument("--wlocal", choices=("stamps", "otf"), default=None,
                    help="profile the dense window-local model with these OTF windows")
    ap.add_argument("--trace", default=None, help="write a chrome trace here")
    args = ap.parse_args(argv)
    if args.wplane and args.wlocal:
        ap.error("--wplane and --wlocal are two models: pick one")

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from surfh_tpu_torch.core.precision import require_cuda
    from surfh_tpu_torch.simulation.flagship import make_flagship_model, make_flagship_setup

    def smi(query: str) -> str:
        return subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                              capture_output=True, text=True, check=True).stdout.splitlines()[0].strip()

    dev = require_cuda()
    card = smi("name,power.limit")
    bands = args.bands.split(",") if args.bands else None
    if args.wplane:
        setup = make_flagship_setup(bands=bands, build_sotf=True, device=dev)
        model, _ = make_flagship_model(setup, dtype=np.float32, workers=WORKERS,
                                       window_local=False, wblur_impl=args.wplane,
                                       wblur_band_rtol=BAND_RTOL)
    elif args.wlocal:
        setup = make_flagship_setup(bands=bands, build_sotf=args.wlocal == "otf", device=dev)
        os.environ["SURFH_PSF_STAMPS"] = "1" if args.wlocal == "stamps" else "0"
        model, _ = make_flagship_model(setup, dtype=np.float32, workers=WORKERS,
                                       conv_freq_rtol=1e-6, conv_rank_rtol=0.0)
    else:
        setup = make_flagship_setup(bands=bands)
        model, _ = make_flagship_model(setup, dtype=np.float32, workers=WORKERS)
    model.to(dev, torch.float32)
    if args.wlocal:
        macs = 0.0
        for chan, t in zip(model.channels, model.tables["chan"]):
            w, ka, kb = t["otf"][0].shape
            ha, wb = chan.tbbox[2], chan.tbbox[3]
            mac = 3.0 * w * ha * ka * kb + 2.0 * w * ha * kb * wb
            macs += mac
            print(f"  {chan.instr.name}: W {w}, Ka' {ka}, Kb' {kb}, bbox {ha} x {wb}: "
                  f"{mac / 1e9:.3f} G multiply-adds a direction")
        print(f"  the conv's inverse-stage GEMMs: {4 * macs / 1e9:.1f} GFLOP an application, FP32 "
              f"bound {4 * macs / FP32_FLOPS_PER_S * 1e3:.3f} ms")
    x = torch.as_tensor(setup["maps"], dtype=torch.float32, device=dev)
    for _ in range(3):
        model.normal(x)
    torch.cuda.synchronize()

    def event_ms(fn, reps=10):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(reps):
            fn()
        e1.record()
        e1.synchronize()
        return e0.elapsed_time(e1) / reps

    eager = [event_ms(lambda: model.normal(x)) for _ in range(8)]
    enqueue = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.normal(x)
        enqueue.append((time.perf_counter() - t0) * 1e3)
    vox = 2.0 * float(np.prod(model.cube_shape))
    mode = (f"W-plane ({args.wplane} blur)" if args.wplane
            else f"dense window-local ({args.wlocal})" if args.wlocal else "rank")
    print(f"{card}: {len(model.channels)} bands, {mode} normal application")
    print(f"  eager (CUDA events, 8 x 10): {min(eager):.3f}-{max(eager):.3f} ms/app "
          f"(median {np.median(eager):.3f}, {vox / (np.median(eager) * 1e-3) / 1e9:.2f} GVox/s); "
          f"host enqueue {min(enqueue):.3f}-{max(enqueue):.3f} ms/app")
    if not args.wplane:
        graph_floor(model, x, event_ms, smi, vox)

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(REPS):
            model.normal(x)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    if args.trace:
        prof.export_chrome_trace(args.trace)

    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    print(f"  profiler: {REPS} applications, wall {wall / REPS * 1e3:.3f} ms/app "
          f"(host clock, profiler on)")
    if not kernels:
        print("no device events in the profile: time with CUDA events instead")
        return 1
    by_class, by_name = defaultdict(float), defaultdict(lambda: [0, 0.0])
    spans = []
    for e in kernels:
        us = e.time_range.elapsed_us()
        by_class[kernel_class(e.name)] += us
        by_name[e.name][0] += 1
        by_name[e.name][1] += us
        spans.append((e.time_range.start, e.time_range.end))
    spans.sort()
    busy, cur_s, cur_e = 0.0, *spans[0]
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    window = spans[-1][1] - spans[0][0]
    total = sum(by_class.values())
    print(f"device kernel time {total / REPS / 1e3:.3f} ms/app over "
          f"{len(kernels) // REPS} kernels/app; busy {busy / window:.1%} of the "
          f"first-to-last-kernel window ({window / REPS / 1e3:.3f} ms/app)")
    for cls, us in sorted(by_class.items(), key=lambda kv: -kv[1]):
        print(f"  {cls:32s} {us / REPS / 1e3:8.3f} ms/app  {us / total:6.1%}")
    print("this repo's kernels:")
    for name, (n, us) in sorted(by_name.items(), key=lambda kv: -kv[1][1]):
        if "this repo" in kernel_class(name):
            print(f"  {us / REPS / 1e3:8.3f} ms/app  {n // REPS:5d}/app  {name[:110]}")
    print("top kernels:")
    for name, (n, us) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:15]:
        print(f"  {us / REPS / 1e3:8.3f} ms/app  {n // REPS:5d}/app  {name[:110]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
