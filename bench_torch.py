#!/usr/bin/env python3
"""Benchmark: fwd+adjoint cube-op throughput of the flagship fusion operator
on one NVIDIA card — the counterpart of `bench.py` for `surfh_tpu_torch`.

Prints ONE JSON line on stdout, its last; progress goes to stderr.

* value: GVox/s of one forward+adjoint application ``g = adjoint(forward(x))``
  of `SpectroSigRLSCT` (voxels = 2 × cube size per application), float32.
  One timed run is `chain` dependent applications (``x = x0 + g·1e-30``)
  and a scalar read of ``sum(g)``, which synchronises; `t_app_s` is the
  median over the runs, divided by `chain` (host clock).
* mode (``SURFH_BENCH_MODE``): ``dispatch`` is eager torch, one enqueue per
  kernel, so the host paces the card (the default for flagship and large,
  and on the CPU); ``loop`` captures the whole chain once as a CUDA graph
  and replays it (the default for small and medium: `bench.py`'s jitted
  `fori_loop` chain program).  The capture's seconds and the largest
  relative gap between the replay and the eager chain go to stderr.
* vs_baseline: `baseline_s / t_app_s`, from the recorded CPU baseline of
  the preset in `baseline_cpu.json` (`bench.py`'s file; null, with a note
  in `baseline_config`, for a preset the file lacks).
* flops_per_app: `bench.py`'s analytic count (the port has no cost model,
  `flops_note`); `tflops`; `mfu_est` against the card's FP32 peak
  (`mfu_note`).  The count charges every band a full-grid FFT conv, so
  `tflops` and `mfu_est` are null for a window-local model (large,
  flagship), which runs none.  `mfu_est` is an estimate from that count,
  not a device measurement.
* device_ms_per_app, dispatch_ms_per_app, device_busy_frac: from one
  `torch.profiler` trace of one chain after the timed runs (null on the CPU
  or under ``SURFH_BENCH_NO_TRACE=1``).  `device_busy_frac` is not
  clamped: above 1 the traced chain's device time exceeds the timed
  window, which `device_busy_note` then says.
* compile_breakdown: `host_build_s` (with `table_cache`: hit, miss, or off
  where the model has no disk cache), `upload_mb` (the model's tables on
  the device), `tables_dispatch_s` (the upload, synchronised),
  `warmup_run_s` and, in loop mode, `graph_capture_s`; `t_compile_s` is
  the sum of its seconds.
* device: the card's name and power limit as nvidia-smi reads them, or
  "cpu".

Presets: small / medium / large are `bench.py`'s synthetic problems (large
in window-local mode with PSF stamps and the λ-rank conv at
``SURFH_CONV_RANK_RTOL``, default 1e-7); flagship is the 12-band, 4-pointing,
501², 3879-λ problem of `simulation/flagship.py` (window-local rank mode by
default; ``SURFH_WBLUR_IMPL`` and ``SURFH_CONV_IMPL`` as in `bench.py`), its
host tables read from the table cache where it holds them.

Environment: SURFH_BENCH_PRESET (flagship), SURFH_BENCH_CPU=1 (run on the
host CPU; without it and without a card the run fails), SURFH_BENCH_REPS
(5), SURFH_BENCH_CHAIN (10), SURFH_BENCH_MODE, SURFH_BENCH_NO_TRACE,
SURFH_BENCH_SKIP_BASELINE, SURFH_WBLUR_IMPL (dense), SURFH_CONV_IMPL (auto),
SURFH_CONV_RANK_RTOL, SURFH_TABLE_CACHE.

    python3 bench_torch.py
    SURFH_BENCH_CPU=1 SURFH_BENCH_PRESET=small python3 bench_torch.py

Imports no JAX and nothing of `surfh_tpu`.  A failure exits non-zero with
the error on stderr and prints no result.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

PRESETS = {
    "small": dict(im_size=81, n_lambda=60, n_tpl=4, n_channels=2, n_pointings=2, n_slit=5),
    "medium": dict(im_size=251, n_lambda=250, n_tpl=4, n_channels=2, n_pointings=2, n_slit=11),
    "large": dict(im_size=501, n_lambda=600, n_tpl=4, n_channels=4, n_pointings=4, n_slit=17),
}

_BASELINE_FILE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "baseline_cpu.json")

WORKERS = min(8, os.cpu_count() or 1)  # processes for the host table build

METRIC = "fwd+adjoint cube-op throughput ({})"
FLOPS_NOTE = ("analytic count (bench.py's _analytic_flops, its fallback when the XLA cost "
              "model fails; the port has no cost model): it charges every band a full-grid FFT "
              "conv, which the window-local models do not run")
MFU_NOTE = ("estimate from the analytic count against the H100 SXM's FP32 peak outside the "
            "tensor cores (67 TFLOP/s, the port runs FP32 with TF32 off); not a device metric")
MFU_NOTE_WINDOW_LOCAL = ("null: the analytic count charges a full-grid FFT conv that this "
                         "window-local model does not run")


def _log(msg):
    print(f"[bench {time.strftime('%H:%M:%S')}] {msg}", file=sys.stderr, flush=True)


def _analytic_flops(model) -> float:
    """Analytic FLOP count of one fwd+adjoint application (lower bound).

    Counts the dominant stages (LMM matmul, FFT conv pairs, gridding gather,
    SRF box-sum, spectral-blur matmul) for forward and adjoint alike.
    """
    n_tpl = model.templates.shape[0] if model.lmm else 0
    N2 = float(np.prod(model.imshape))
    total = 0.0
    for chan in model.channels:
        W = float(chan.n_wslice)
        P = len(chan.pointings)
        S, K, A = chan.oshape[1], chan.oshape[2], chan.oshape[3]
        sb = chan.slit_shape[2]
        nl = float(np.prod(chan.local_im_shape))
        if model.lmm:
            total += 2 * n_tpl * W * N2  # T
        total += 2 * 5 * W * N2 * np.log2(max(N2, 2))  # C: rfft2+irfft2 pair
        total += 6 * W * N2 / 2  # OTF multiply (complex, half-spectrum)
        per_pointing = (
            7 * W * nl  # bilinear gather (4 mul + 3 add)
            + W * S * A * chan.srf * sb  # SRF box-sum adds
            + W * S * A * sb  # slit weights
            + 2 * K * W * sb * S * A  # Sig·R matmul
        )
        total += P * per_pointing
    return 2.0 * total  # adjoint mirrors the forward


def _read_json(path):
    try:
        with open(path) as fh:
            return json.load(fh)
    except (OSError, ValueError):
        return None


def _attach_baseline(result, preset, t_app):
    """`vs_baseline`, `baseline_s`, `baseline_config` from the recorded CPU
    baselines (`bench.py`'s file and note)."""
    result["baseline_s"] = None
    result["baseline_config"] = None
    if os.environ.get("SURFH_BENCH_SKIP_BASELINE"):
        result["vs_baseline"] = None
        return
    recorded = _read_json(_BASELINE_FILE) or {}
    if preset in recorded:
        rec = recorded[preset]
        result["baseline_s"] = float(rec["seconds"])
        result["baseline_config"] = rec.get("config", "recorded")
        result["vs_baseline"] = result["baseline_s"] / t_app
    else:
        result["vs_baseline"] = None
        result["baseline_config"] = (
            f"no recorded baseline for preset {preset!r} in baseline_cpu.json"
        )


def rate_fields(flops: float, t_app: float, window_local: bool) -> dict:
    """`flops_per_app`, `tflops`, `mfu_est` and their notes; the rates are
    null where the count describes work the model does not do."""
    from surfh_tpu_torch.utils.profiling import FP32_FLOPS_PER_S

    counted = not window_local
    return {
        "flops_per_app": flops,
        "flops_note": FLOPS_NOTE,
        "tflops": flops / t_app / 1e12 if counted else None,
        "mfu_est": flops / t_app / FP32_FLOPS_PER_S if counted else None,
        "mfu_note": MFU_NOTE if counted else MFU_NOTE_WINDOW_LOCAL,
    }


def busy_fields(t_app: float, device_ms) -> dict:
    """`device_ms_per_app`, `dispatch_ms_per_app` (bench.py's formula) and
    `device_busy_frac`, unclamped; above 1, a `device_busy_note`."""
    out = {"device_ms_per_app": device_ms, "dispatch_ms_per_app": None, "device_busy_frac": None}
    if device_ms is None:
        return out
    busy = device_ms / (t_app * 1e3)
    out.update(dispatch_ms_per_app=max(t_app * 1e3 - device_ms, 0.0), device_busy_frac=busy)
    if busy > 1.0:
        out["device_busy_note"] = ("above 1: the traced chain's device time exceeds the timed "
                                   "window; read device_ms_per_app against t_app_s")
        _log(f"device busy share {busy:.4f} > 1: {out['device_busy_note']}")
    return out


def bench_device():
    """The card, or the host CPU under ``SURFH_BENCH_CPU``; without a card
    and without that request, raise."""
    import torch

    from surfh_tpu_torch.core.precision import require_cuda

    if os.environ.get("SURFH_BENCH_CPU"):
        return torch.device("cpu")
    return require_cuda()


def bench_mode(preset: str, device) -> str:
    mode = os.environ.get("SURFH_BENCH_MODE") or (
        "dispatch" if preset in ("flagship", "large") or device.type != "cuda" else "loop")
    if mode not in ("dispatch", "loop"):
        raise ValueError(f"SURFH_BENCH_MODE={mode!r}: dispatch or loop")
    if mode == "loop" and device.type != "cuda":
        raise ValueError("SURFH_BENCH_MODE=loop captures a CUDA graph: it needs the card")
    return mode


def build_model(preset: str, device, wblur_impl: str = "dense"):
    """(model, setup, compile_breakdown) of `preset`, host tables built (or
    read from the table cache)."""
    t0 = time.perf_counter()
    if preset == "flagship":
        from surfh_tpu_torch.simulation.flagship import make_flagship_model

        model, setup = make_flagship_model(
            dtype=np.float32, wblur_impl=wblur_impl,
            conv_impl=os.environ.get("SURFH_CONV_IMPL", "auto"), workers=WORKERS, device=device)
    elif preset in PRESETS:
        from surfh_tpu_torch.simulation.synthetic import make_model

        kw = dict(dtype=np.float32, wblur_impl=wblur_impl, workers=WORKERS, **PRESETS[preset])
        if preset == "large":
            kw.update(window_local=True, psf_stamps=True,
                      conv_rank_rtol=float(os.environ.get("SURFH_CONV_RANK_RTOL", "1e-7")))
        model, setup = make_model(**kw)
    else:
        raise ValueError(f"unknown preset {preset!r}: flagship, {', '.join(PRESETS)}")
    cache = "off" if model.table_cache_path() is None else (
        "hit" if model.table_cache_hit else "miss")
    return model, setup, {"host_build_s": time.perf_counter() - t0, "table_cache": cache}


def apply_chain(model, x0, chain: int, plain: bool = False):
    """The timed work: `chain` dependent applications ``g = Hᵗ(H x)``,
    ``x = x0 + g·1e-30``; returns the last `g` (no synchronisation)."""
    x = x0
    g = None
    for _ in range(chain):
        g = model.adjoint(model.forward(x, plain), plain)
        x = x0 + g * 1e-30
    return g


def capture_chain(model, x0, chain: int):
    """The chain captured as one CUDA graph on the static input `x0`, after
    two warm-up chains on a side stream: returns (graph, g, sum(g)), the
    last two recomputed in place by each ``graph.replay()``."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            apply_chain(model, x0, chain)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        g = apply_chain(model, x0, chain)
        total = g.sum()
    return graph, g, total


def rel_gap(a, b) -> float:
    """max |a − b| / max |b|."""
    return float((a - b).abs().max() / b.abs().max())


def measure(model, setup, preset: str, device, compile_breakdown: dict) -> dict:
    """Upload, warm up, time and trace one fwd+adjoint chain; the result
    line without `t_total_s`."""
    import torch

    from surfh_tpu_torch.core import gather_rows as gr
    from surfh_tpu_torch.core import wblur_banded as wb
    from surfh_tpu_torch.parallel.fusion import tensor_bytes
    from surfh_tpu_torch.utils.profiling import card_name, device_trace_ms

    reps = int(os.environ.get("SURFH_BENCH_REPS", "5"))
    chain = int(os.environ.get("SURFH_BENCH_CHAIN", "10"))
    if reps < 1 or chain < 1:
        raise ValueError(f"SURFH_BENCH_REPS={reps}, SURFH_BENCH_CHAIN={chain}: each at least 1")
    mode = bench_mode(preset, device)
    cb = dict(compile_breakdown)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    t0 = time.perf_counter()
    model.to(device, torch.float32)
    sync()
    cb["tables_dispatch_s"] = time.perf_counter() - t0
    cb["upload_mb"] = tensor_bytes(model.tables) / 1e6
    x0 = torch.as_tensor(np.asarray(setup["maps"]), dtype=torch.float32).to(device)

    def eager():
        return float(apply_chain(model, x0, chain).sum())

    _log(f"{preset}: {mode} mode, {reps} reps x chain {chain}, cube {model.cube_shape}, "
         f"{len(model.channels)} channels on {device}")
    gr.reset_launches()
    wb.reset_launches()
    t0 = time.perf_counter()
    eager()
    cb["warmup_run_s"] = time.perf_counter() - t0
    run = eager
    if mode == "loop":
        t0 = time.perf_counter()
        graph, g_graph, total = capture_chain(model, x0, chain)
        sync()
        cb["graph_capture_s"] = time.perf_counter() - t0

        def run():
            graph.replay()
            return float(total)

        run()
        gap = rel_gap(g_graph, apply_chain(model, x0, chain))
        _log(f"{preset}: CUDA graph of the {chain}-application chain captured in "
             f"{cb['graph_capture_s']:.3f} s; replay vs eager chain: max rel gap {gap:.3e}")
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        run()
        times.append(time.perf_counter() - t0)
    t_app = float(np.median(times)) / chain
    result = {
        "metric": METRIC.format(preset),
        "value": 2.0 * float(np.prod(model.cube_shape)) / t_app / 1e9,
        "unit": "GVox/s",
        "vs_baseline": None,
        "preset": preset,
        "mode": mode,
        "device": card_name(device),
        "t_app_s": t_app,
        "t_compile_s": sum(v for k, v in cb.items() if k.endswith("_s")),
        "compile_breakdown": cb,
        **rate_fields(_analytic_flops(model), t_app, model.window_local),
        "cube_shape": list(model.cube_shape),
        "n_channels": len(model.channels),
        "n_pointings": len(model.pointings[0]),
    }
    _attach_baseline(result, preset, t_app)
    device_ms = None
    if device.type == "cuda" and not os.environ.get("SURFH_BENCH_NO_TRACE"):
        _log(f"{preset}: device trace of one chain")
        device_ms = device_trace_ms(run, chain)
    result.update(busy_fields(t_app, device_ms))
    # a replay of the captured graph launches the kernels without their wrappers
    _log(f"{preset}: kernel launches through the wrappers in this run: gather_rows {gr.launches}, "
         f"wblur_banded {wb.launches}, wblur_banded_t {wb.launches_t}")
    return result


def main() -> int:
    t_start = time.monotonic()
    preset = os.environ.get("SURFH_BENCH_PRESET", "flagship")
    device = bench_device()
    bench_mode(preset, device)  # an impossible mode fails before the build
    model, setup, cb = build_model(preset, device, os.environ.get("SURFH_WBLUR_IMPL", "dense"))
    _log(f"{preset}: host tables in {cb['host_build_s']:.2f} s (table cache {cb['table_cache']})")
    result = measure(model, setup, preset, device, cb)
    result["t_total_s"] = time.monotonic() - t_start
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
