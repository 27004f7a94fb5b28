#!/usr/bin/env python3
"""Drive surfh_tpu_torch's main path once on one NVIDIA card and check it.

    python3 chip_smoke.py [--bands 1a,1b,...]

The flagship rank-mode fusion solve at full width (501² sky, ~3879-λ cube,
M = 4 templates, 4 dither pointings, all 12 MIRI bands unless `--bands`
cuts them), f32 on the card, weights and data from seeds:

1. device   — the card's name and power limit (nvidia-smi);
2. build    — nvcc builds the row-gather kernel from csrc/ into build/;
3. host     — the flagship host tables (NumPy, channels in parallel);
4. kernel   — the kernel against its plain torch version on one flagship
              channel's real composed plans, both directions (error, times);
5. slice    — upload, y = H·truth, an f64-accumulated dot test, the fused
              normal through the kernel against the same through the plain
              version, the launch count per normal application, the main
              path (y, b = µ·Hᵗy, 10 lcg iterations), timings;
6. small    — the card's f32 operator against the CPU f64 one on a small
              synthetic problem.

Prints the kernels' JSON record, then as its last line
``{"ok": true, "device": {...}}``.  Exits non-zero, with no result line,
when there is no CUDA device or any check fails.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

WORKERS = min(8, os.cpu_count() or 1)  # processes for the host table build
REPS = 10  # timed applications per operator

def log(msg: str) -> None:
    print(msg, flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SystemExit(f"CHECK FAILED: {what}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--bands", default=None, help="comma-separated MIRI bands (default: all 12)")
    args = ap.parse_args(argv)

    import torch

    from surfh_tpu_torch.core.precision import require_cuda

    dev = require_cuda()

    import numpy as np

    from surfh_tpu_torch.core import _build, gather_rows as gr
    from surfh_tpu_torch.simulation.flagship import make_flagship_model, make_flagship_setup
    from surfh_tpu_torch.simulation.synthetic import make_model
    from surfh_tpu_torch.solvers.criterion import QuadCriterion_MRS

    def sync():
        torch.cuda.synchronize(dev)

    def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
        """Mean device ms per call, CUDA events around `reps` calls."""
        for _ in range(warmup):
            fn()
        sync()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(reps):
            fn()
        e1.record()
        e1.synchronize()
        return e0.elapsed_time(e1) / reps

    def rel(a, b) -> float:
        return float((a - b).abs().max() / b.abs().max())

    # 1. device --------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    card = smi[0].strip()
    log(card)
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(dev)} x{torch.cuda.device_count()}, "
        f"tf32 matmul={torch.backends.cuda.matmul.allow_tf32} cudnn={torch.backends.cudnn.allow_tf32}")

    # 2. build ---------------------------------------------------------
    t0 = time.perf_counter()
    gr.load_kernel()
    log(f"[build] gather_rows.cu -> {_build.BUILD_DIR} in {time.perf_counter() - t0:.2f} s")
    for line in _build.build_logs.get("gather_rows", "").splitlines():
        if "registers" in line or "spill" in line:
            log(f"[build] ptxas: {line.strip()}")

    # 3. host tables ----------------------------------------------------
    bands = args.bands.split(",") if args.bands else None
    t0 = time.perf_counter()
    setup = make_flagship_setup(bands=bands)
    model, _ = make_flagship_model(setup, dtype=np.float32, workers=WORKERS)
    t_host = time.perf_counter() - t0
    n_pt = sum(c.oshape[0] for c in model.channels)
    log(f"[host] {len(model.channels)} bands {setup['bands']}, cube {model.cube_shape}, "
        f"maps {model.ishape}, y {model.oshape[0]}: host tables in {t_host:.2f} s "
        f"({WORKERS} workers)")
    host = model.host_tables()
    for chan, t, sup in zip(model.channels, host["chan"], model.conv_supports):
        q = t["wpsf_q"].shape[1]
        log(f"[host]   {chan.instr.name}: P={chan.oshape[0]} S={chan.oshape[1]} K={chan.oshape[2]} "
            f"A={chan.oshape[3]} sb={chan.slit_shape[2]} W={chan.n_wslice} R={sup['rank']} Q={q} "
            f"bbox={chan.tbbox} fwd nnz={t['gather_fwd'][0].nnz} adj nnz={t['gather_t'][0].nnz}")

    # 4. kernel vs plain version ----------------------------------------
    c_big = max(range(len(host["chan"])), key=lambda c: host["chan"][c]["gather_fwd"][0].nnz)
    tb = host["chan"][c_big]
    q = tb["wpsf_q"].shape[1]
    gen = torch.Generator(device=dev).manual_seed(0)
    # f32: the kernel's sequential FMAs and the plain version's index_add_
    # sum the same ≤ ~30 taps per row in another order (~1e-7 each)
    tol_kernel = 1e-5
    kern = {"err": 0.0, "ms": 0.0, "plain_ms": 0.0}
    for name in ("gather_fwd", "gather_t"):
        plan = tb[name][0].to(dev, torch.float32)
        src = torch.rand((plan.n_src, q), generator=gen, device=dev)
        out_k = gr.gather_rows_cuda(src, plan)
        out_p = gr.gather_rows_reference(src, plan)
        sync()
        err = rel(out_k, out_p)
        ms_k = cuda_ms(lambda: gr.gather_rows_cuda(src, plan), 50)
        ms_p = cuda_ms(lambda: gr.gather_rows_reference(src, plan), 50)
        moved = plan.nnz * (8 + 4 * q) + plan.n_rows * 4 * (q + 1)
        log(f"[kernel] {model.channels[c_big].instr.name} {name}: rows {plan.n_rows} x Q {q}, "
            f"nnz {plan.nnz}: max rel err {err:.3e} (bound {tol_kernel:g}, f32 sums in another "
            f"order); kernel {ms_k:.4f} ms, "
            f"plain {ms_p:.4f} ms; {moved / ms_k / 1e6:.1f} GB/s of tap+row traffic")
        check(err <= tol_kernel, f"kernel vs plain {name}: {err:.3e} > {tol_kernel:g}")
        kern["err"] = max(kern["err"], float((out_k - out_p).abs().max()))
        kern["ms"] += ms_k
        kern["plain_ms"] += ms_p

    # 5. slice ------------------------------------------------------------
    t0 = time.perf_counter()
    model.to(dev, torch.float32)
    sync()
    t_up = time.perf_counter() - t0
    log(f"[slice] upload {t_up:.3f} s, {torch.cuda.memory_allocated(dev) / 2**20:.1f} MiB on the card")
    truth = torch.as_tensor(setup["maps"], dtype=torch.float32, device=dev)

    t0 = time.perf_counter()
    y = model.forward(truth)
    sync()
    log(f"[slice] y = H truth: {tuple(y.shape)} in {time.perf_counter() - t0:.3f} s (first call)")
    check(tuple(y.shape) == model.oshape and bool(torch.isfinite(y).all()), "y finite, shape")

    xr = torch.rand(model.ishape, generator=gen, device=dev)
    yr = torch.rand(model.oshape, generator=gen, device=dev)
    lhs = float(torch.dot(model.forward(xr).double(), yr.double()))
    rhs = float(torch.dot(xr.reshape(-1).double(), model.adjoint(yr).reshape(-1).double()))
    dot_rel = abs(lhs - rhs) / abs(lhs)
    # f32 operator pair; positive data keep both products free of cancellation
    tol_dot = 1e-5
    log(f"[slice] dot test (f64 sums): <Hx,y>={lhs:.9e} <x,H'y>={rhs:.9e} rel {dot_rel:.3e} "
        f"(bound {tol_dot:g})")
    check(dot_rel <= tol_dot, "dot test")

    n_k = model.normal(truth)
    n_p = model.normal(truth, gather=gr.gather_rows_reference)
    sync()
    nrm_rel = rel(n_k, n_p)
    tol_normal = 1e-5
    log(f"[slice] fused normal, kernel vs plain gathers: max rel {nrm_rel:.3e} (bound {tol_normal:g})")
    check(bool(torch.isfinite(n_k).all()) and nrm_rel <= tol_normal, "normal kernel vs plain")

    gr.reset_launches()
    model.normal(truth)
    sync()
    per_app = gr.launches
    log(f"[slice] gather_rows launches per normal application: {per_app} (expected {2 * n_pt})")
    check(per_app == 2 * n_pt, "launches per normal application")

    t_fwd = cuda_ms(lambda: model.forward(truth), REPS)
    t_adj = cuda_ms(lambda: model.adjoint(y), REPS)
    t_app = cuda_ms(lambda: model.normal(truth), REPS)
    vox = 2.0 * float(np.prod(model.cube_shape))
    log(f"[slice] {card}: forward {t_fwd:.3f} ms, adjoint {t_adj:.3f} ms, fused fwd+adjoint "
        f"{t_app:.3f} ms/app -> {vox / (t_app * 1e-3) / 1e9:.2f} GVox/s "
        f"(2 x {int(np.prod(model.cube_shape))} voxels per app); "
        f"peak {torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")

    # the main path, counted: y, b = µ·Hᵗy, 10 CG iterations
    mu_reg = 5e3
    gr.reset_launches()
    t0 = time.perf_counter()
    y = model.forward(truth)
    crit = QuadCriterion_MRS(1.0, y, model, mu_reg)
    b = crit.b
    res = crit.run_method("lcg", maximum_iterations=10, return_state=True)
    sync()
    t_main = time.perf_counter() - t0
    main_launches = gr.launches
    expect = 2 * n_pt + 2 * n_pt * (res.n_iter + 1)
    gn = res.grad_norm
    log(f"[slice] main path (y, b, {res.n_iter} lcg it, mu_reg={mu_reg:g}) in {t_main:.3f} s; "
        f"gather_rows launches {main_launches} (expected {expect}); grad norms {gn.tolist()}")
    check(main_launches == expect and main_launches > 0, "main-path launches")
    check(bool(torch.isfinite(b).all()) and bool(torch.isfinite(res.x).all()), "b, x finite")
    check(res.n_iter == 10 and bool(np.isfinite(gn).all()) and gn[-1] < gn[0], "grad norms finite, falling")
    t0 = time.perf_counter()
    res2 = crit.run_method("lcg", maximum_iterations=10, solver_state=res.state)
    sync()
    s_it = (time.perf_counter() - t0) / res2.n_iter
    check(bool(np.isfinite(res2.grad_norm).all()) and res2.grad_norm[-1] < gn[0], "resumed CG")
    log(f"[slice] {card}: CG {s_it:.4f} s/iteration (10 resumed iterations, host clock); "
        f"grad norm {gn[0]:.4e} -> {res2.grad_norm[-1]:.4e} after 20")

    # 6. small input against the CPU f64 operator -----------------------
    small, ssetup = make_model(im_size=41, n_lambda=120, n_tpl=2, n_channels=2,
                               n_pointings=2, n_slit=3, dtype=np.float64)
    small.to("cpu", torch.float64)
    xs = torch.as_tensor(ssetup["maps"])
    ref_y, ref_n = small.forward(xs), small.normal(xs)
    small.to(dev, torch.float32)
    got_y, got_n = small.forward(xs).cpu().double(), small.normal(xs).cpu().double()
    e_y, e_n = rel(got_y, ref_y), rel(got_n, ref_n)
    log(f"[small] card f32 vs CPU f64: forward {e_y:.3e}, normal {e_n:.3e} (bound 1e-5)")
    check(e_y <= 1e-5 and e_n <= 1e-5, "small problem vs CPU f64")

    log(json.dumps({"kernels": [{
        "name": "gather_rows",
        "route": "cuda",
        "source": "surfh_tpu_torch/csrc/gather_rows.cu",
        "replaces": "surfh_tpu/core/scatter_pallas.py:138",
        "launches": main_launches,
        "max_abs_err": kern["err"],
        "ms": kern["ms"],
        "plain_ms": kern["plain_ms"],
    }]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
