#!/usr/bin/env python3
"""Drive surfh_tpu_torch's main path once on one NVIDIA card and check it.

    python3 chip_smoke.py [--bands 1a,1b,...]

Two paths of the flagship fusion solve at full width (501² sky, ~3879-λ
cube, M = 4 templates, 4 dither pointings, all 12 MIRI bands unless
`--bands` cuts them), f32 on the card, weights and data from seeds: the
rank mode (window-local, PSF stamps) and the materialized-OTF W-plane mode
(`window_local=False`, `wblur_impl="banded"`, `wblur_band_rtol=1e-4`);
and the composed-transpose prototype entry point
(`scripts/torch_scatter_proto.py`) with its three fixed-fan-in kernels.

1. device      — the card's name and power limit (nvidia-smi);
2. build       — nvcc builds the three kernel sources from csrc/ into
                 build/, one nvcc each, in parallel;
3. host        — the flagship rank-mode host tables (NumPy, channels in
                 parallel);
4. kernel      — the row gather against its plain torch version and the
                 library's CSR SpMM on one flagship channel's real composed
                 plans (error, times, byte bound);
5. proto       — the prototype entry point as a user runs it (`run`: band
                 1c alone, one pointing, Q = W = 466) with K1–K3 launches
                 counted, then `run_proto` on every band's pointing-0
                 transpose of the flagship model at Q = W: K1–K3 against A,
                 their plain versions and the CSR kernel (errors, times,
                 byte bound);
6. slice       — the rank path: upload, y = H·truth, an f64-accumulated dot
                 test, the fused normal through the kernel against the plain
                 version, launches per normal application, the main path
                 (y, b = µ·Hᵗy, 10 lcg iterations), timings;
7. wplane-host — the OTF built on the card from the PSF stamps, the W-plane
                 model over the rank model's channels, the band plans;
8. kernel      — both banded kernels against their plain versions and
                 cuBLAS on the masked table on the largest band's real plans
                 (error, times, flop bound);
9. wplane      — the W-plane path: FFT stage and relayout costs, y, the
                 dense pair's dot test, the banded pair's mismatch, banded
                 against dense, kernels against plain versions, launches per
                 normal application, times for both blurs, the main path
                 (y, b, 10 lcg iterations);
10. small      — the card's f32 operators (both modes) against the CPU f64
                 ones on small synthetic problems.

Prints the kernels' JSON record, then as its last line
``{"ok": true, "device": {...}}``.  Exits non-zero, with no result line,
when there is no CUDA device or any check fails.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import time

WORKERS = min(8, os.cpu_count() or 1)  # processes for the host table build
REPS = 10  # timed applications per operator
BAND_RTOL = 1e-4  # the banded blur's support threshold (the throughput setting)
FP32_FLOPS_PER_S = 67e12  # H100 SXM FP32 outside the tensor cores (data sheet)


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

    from concurrent.futures import ThreadPoolExecutor

    import importlib.util

    from surfh_tpu_torch.core import _build, fft
    from surfh_tpu_torch.core import gather_fixed as gf
    from surfh_tpu_torch.core import gather_rows as gr
    from surfh_tpu_torch.core import wblur_banded as wb
    from surfh_tpu_torch.simulation.flagship import make_flagship_model, make_flagship_setup
    from surfh_tpu_torch.simulation.synthetic import make_model
    from surfh_tpu_torch.solvers.criterion import QuadCriterion_MRS

    def sync():
        torch.cuda.synchronize(dev)

    def rel(a, b) -> float:
        return float((a - b).abs().max() / b.abs().max())

    def bound(nbytes: float, flops: float = 0.0):
        """The least time the card could take: bytes over the memory rate or
        operations over the FP32 rate, whichever is larger (ms, which)."""
        t_b, t_f = nbytes / proto.HBM_BYTES_PER_S * 1e3, flops / FP32_FLOPS_PER_S * 1e3
        return (t_b, "bytes") if t_b >= t_f else (t_f, "operations")

    spec = importlib.util.spec_from_file_location(
        "torch_scatter_proto", os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                            "scripts", "torch_scatter_proto.py"))
    proto = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(proto)
    cuda_ms = proto.event_ms  # mean device ms per call, CUDA events around `reps` calls

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
    with ThreadPoolExecutor(3) as ex:  # one nvcc per source, all at once
        for f in [ex.submit(gr.load_kernel), ex.submit(wb.load_kernels),
                  ex.submit(gf.load_kernels)]:
            f.result()
    log(f"[build] gather_rows.cu, wblur_banded.cu, gather_fixed.cu -> {_build.BUILD_DIR} in "
        f"{time.perf_counter() - t0:.2f} s")
    for name in ("gather_rows", "wblur_banded"):
        for line in _build.build_logs.get(name, "").splitlines():
            if "Compiling entry" in line or "registers" in line or "spill" in line:
                log(f"[build] ptxas {name}: {line.strip()}")
    # gather_fixed.cu holds 51 instances (static L = 1..8): the largest
    # register count and every spill, not one line per instance
    flog = _build.build_logs.get("gather_fixed", "")
    regs = [int(m) for m in re.findall(r"Used (\d+) registers", flog)]
    spills = [m.group(0) for m in re.finditer(r"(\d+) bytes spill stores, (\d+) bytes spill loads", flog)
              if int(m.group(1)) or int(m.group(2))]
    log(f"[build] ptxas gather_fixed: {len(regs)} kernel instances, at most {max(regs, default=0)} "
        f"registers; spill lines with bytes: {spills or 'none'}")

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
    kern = {"err": 0.0, "ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0}
    for name in ("gather_fwd", "gather_t"):
        plan = tb[name][0].to(dev, torch.float32)
        spm = proto.library_csr(tb[name][0], dev)
        src = torch.rand((plan.n_src, q), generator=gen, device=dev)
        out_k = gr.gather_rows_cuda(src, plan)
        out_p = gr.gather_rows_reference(src, plan)
        out_l = torch.sparse.mm(spm, src)
        sync()
        err, err_l = rel(out_k, out_p), rel(out_l, out_p)
        ms_k = cuda_ms(lambda: gr.gather_rows_cuda(src, plan), 50)
        ms_p = cuda_ms(lambda: gr.gather_rows_reference(src, plan), 50)
        ms_l = cuda_ms(lambda: torch.sparse.mm(spm, src), 50)
        moved = plan.nnz * (8 + 4 * q) + plan.n_rows * 4 * (q + 1)
        b_ms, _ = bound(proto.gather_bytes(plan.n_rows, plan.n_src, q, plan.nnz))
        log(f"[kernel] {model.channels[c_big].instr.name} {name}: rows {plan.n_rows} x Q {q}, "
            f"nnz {plan.nnz}: max rel err {err:.3e} (bound {tol_kernel:g}, f32 sums in another "
            f"order); kernel {ms_k:.4f} ms, "
            f"plain {ms_p:.4f} ms, library torch.sparse.mm {ms_l:.4f} ms (max rel {err_l:.3e}); "
            f"{moved / ms_k / 1e6:.1f} GB/s of tap+row traffic; byte bound {b_ms:.4f} ms "
            f"({100 * b_ms / ms_k:.1f} % of the kernel's time)")
        check(err <= tol_kernel, f"kernel vs plain {name}: {err:.3e} > {tol_kernel:g}")
        check(err_l <= tol_kernel, f"library vs plain {name}: {err_l:.3e} > {tol_kernel:g}")
        kern["err"] = max(kern["err"], float((out_k - out_p).abs().max()))
        kern["ms"] += ms_k
        kern["plain_ms"] += ms_p
        kern["library_ms"] += ms_l
        kern["bound_ms"] += b_ms

    # 5. the prototype entry point as a user runs it, counted; every band ---
    # its defaults: band 1c alone, one pointing, 501², Q = W = 466 (float2)
    gf.reset_launches()
    t0 = time.perf_counter()
    pres = proto.run(device=dev, log=lambda m: log(f"[proto] {m}"))
    sync()
    proto_launches = (gf.launches_k1, gf.launches_k2, gf.launches_k3)
    expect_p = proto.launches_per_run()
    log(f"[proto] {card}: the entry point (band 1c, one pointing, host build included) in "
        f"{time.perf_counter() - t0:.2f} s; launches K1 / K2 / K3 {proto_launches} (expected "
        f"{expect_p} each: one check, {proto.EVENT_WARMUP} + {proto.EVENT_REPS} timed, 4 chains "
        f"of 10)")
    check(proto_launches == (expect_p,) * 3, "proto launches")

    # K1–K3 against their plain versions: the same taps in the same order,
    # so only the FMA contraction differs; against A (index_add_, summing in
    # the order of the card's atomics) and the CSR kernel: ≤ tol_kernel
    tol_fixed = 1e-6

    def check_proto(r, what):
        check(max(r["check"].values()) <= tol_kernel, f"{what}: checks against A {r['check']}")
        for k in ("K1", "K2", "K3"):
            check(r["vs_plain"][k] <= tol_fixed and r["vs_csr"][k] <= tol_kernel,
                  f"{what} {k}: {r['vs_plain'][k]:.3e} vs plain (bound {tol_fixed:g}), "
                  f"{r['vs_csr'][k]:.3e} vs CSR (bound {tol_kernel:g})")

    check_proto(pres, "entry point")
    log(f"[proto] {card}: K1–K3 on every band's pointing-0 transpose of the {len(model.channels)}-band, "
        f"{n_pt // len(model.channels)}-pointing model at Q = W")
    for chan, band in zip(model.channels, setup["bands"]):
        check_proto(proto.run_proto(chan, dev, chain=0, band=band, log=lambda m: log(f"[proto] {m}")),
                    band)

    # 6. slice ------------------------------------------------------------
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
    n_p = model.normal(truth, plain=True)
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

    # 7. the W-plane model: OTF on the card, channels reused, band plans ---
    t0 = time.perf_counter()
    wsetup = make_flagship_setup(bands=bands, build_sotf=True, device=dev)
    sync()
    t_otf = time.perf_counter() - t0
    sotf = wsetup["sotf"]
    log(f"[wplane-host] OTF {tuple(sotf.shape)} {sotf.dtype} built on the card from the PSF "
        f"stamps in {t_otf:.2f} s (setup included, f64 FFTs, chunks of 128 planes); "
        f"{sotf.numel() * sotf.element_size() / 2**30:.2f} GiB")
    t0 = time.perf_counter()
    wmodel, _ = make_flagship_model(wsetup, dtype=np.float32, window_local=False,
                                    wblur_impl="banded", wblur_band_rtol=BAND_RTOL,
                                    channels=model.channels)
    t_wh = time.perf_counter() - t0
    t0 = time.perf_counter()
    wmodel.to(dev, torch.float32)
    sync()
    log(f"[wplane-host] W-plane model over the rank model's channels: host {t_wh:.2f} s "
        f"(band plans at rtol {BAND_RTOL:g}), upload + banded tables {time.perf_counter() - t0:.2f} s, "
        f"{torch.cuda.memory_allocated(dev) / 2**30:.2f} GiB on the card")
    for chan, t in zip(wmodel.channels, wmodel.host_tables()["chan"]):
        p, q = t["band_plan"], t["band_plan_t"]
        aw = np.abs(chan.wpsf.astype(np.float64))
        kept = float((aw * p.mask()[:, :, None]).sum() / aw.sum())
        kept_t = float((aw * q.mask()[:, :, None]).sum() / aw.sum())
        log(f"[wplane-host]   {chan.instr.name}: K={p.K} W={p.W} sb={p.B} S*A={chan.oshape[1] * chan.oshape[3]} "
            f"LB={p.LB} (density {p.density:.3f}, {p.n_tiles} tiles, kept mass {kept:.6f}) "
            f"KB={q.KB} TL={q.TL} ({q.n_tiles} tiles, kept mass {kept_t:.6f})")

    # 8. both banded kernels against their plain versions ------------------
    wt = wmodel.tables["chan"]
    c_w = max(range(len(wt)), key=lambda c: wt[c]["band"].plan.K * wt[c]["band"].plan.LB
              * wt[c]["band"].plan.B * wmodel.channels[c].oshape[1] * wmodel.channels[c].oshape[3])
    bt = wt[c_w]["band"]
    _, S_, K_, A_ = wmodel.channels[c_w].oshape
    win = torch.rand((S_ * A_, bt.plan.B * bt.plan.W), generator=gen, device=dev)
    y2d = torch.rand((S_ * A_, K_), generator=gen, device=dev)
    bkern = {}
    for name, kfn, pfn, arg, table, starts, lib in (
            ("wblur_banded", wb.wblur_banded_cuda, wb.wblur_banded_reference, win, bt.blocks,
             bt.starts, lambda: torch.matmul(win, bt.rows.T)),
            ("wblur_banded_t", wb.wblur_banded_t_cuda, wb.wblur_banded_t_reference, y2d,
             bt.blocks_t, bt.starts_t, lambda: torch.matmul(y2d, bt.rows_t))):
        out_k, out_p = kfn(arg, bt), pfn(arg, bt)
        sync()
        err = rel(out_k, out_p)
        ms_k = cuda_ms(lambda: kfn(arg, bt), 50)
        ms_p = cuda_ms(lambda: pfn(arg, bt), 50)
        ms_l = cuda_ms(lib, 50)  # one cuBLAS call on the masked dense table
        terms = bt.plan.B * bt.plan.LB if name == "wblur_banded" else bt.plan_t.KB
        flops = 2.0 * arg.shape[0] * out_k.shape[1] * terms
        nbytes = 4.0 * (arg.numel() + table.numel() + starts.numel() + out_k.numel())
        b_ms, b_by = bound(nbytes, flops)
        log(f"[kernel] {wmodel.channels[c_w].instr.name} {name}: [{arg.shape[0]} x {arg.shape[1]}] -> "
            f"[{out_k.shape[0]} x {out_k.shape[1]}], {terms} terms per output: max rel err {err:.3e} "
            f"(bound {tol_kernel:g}, f32 sums in another order); kernel {ms_k:.4f} ms "
            f"({flops / (ms_k * 1e-3) / 1e12:.2f} TFLOP/s of banded work), plain (cuBLAS on the "
            f"masked table) {ms_p:.4f} ms, library torch.matmul on the masked table {ms_l:.4f} ms; "
            f"bound {b_ms:.4f} ms by {b_by} ({flops / 1e9:.3f} GFLOP, {nbytes / 1e6:.2f} MB; "
            f"{100 * b_ms / ms_k:.1f} % of the kernel's time)")
        check(err <= tol_kernel, f"kernel vs plain {name}: {err:.3e} > {tol_kernel:g}")
        bkern[name] = {"err": float((out_k - out_p).abs().max()), "ms": ms_k, "plain_ms": ms_p,
                       "library_ms": ms_l, "bound_ms": b_ms, "bound_by": b_by}
    del win, y2d

    # 9. the W-plane path at full width ------------------------------------
    torch.cuda.reset_peak_memory_stats(dev)
    cube = wmodel.mapsToCube(truth)
    t_lmm = cuda_ms(lambda: wmodel.mapsToCube(truth), 5)
    t_fft = cuda_ms(lambda: fft.conv_otf_(cube, sotf), 5)
    n_c = len(wmodel.channels)
    rows = [wmodel.patch_rows(cube, c) for c in range(n_c)]
    t_rel = cuda_ms(lambda: [wmodel.patch_rows(cube, c) for c in range(n_c)], 5)
    t_rel_t = cuda_ms(lambda: [wmodel.add_patch_rows_(cube, rows[c], c) for c in range(n_c)], 5)
    log(f"[wplane] {card}: T (maps -> cube {tuple(cube.shape)}) {t_lmm:.3f} ms; FFT stage "
        f"(rfft2 * sotf, irfft2, {fft.CONV_OTF_CHUNK}-plane chunks, in place) {t_fft:.3f} ms per "
        f"direction; bbox relayout [W, ha, wb] -> [ha*wb, W] {t_rel:.3f} ms, back (add into "
        f"the cube) {t_rel_t:.3f} ms, all {n_c} bands; peak {torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")
    del cube, rows

    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    y_b = wmodel.forward(truth)
    sync()
    log(f"[wplane] y = H truth (banded): {tuple(y_b.shape)} in {time.perf_counter() - t0:.3f} s (first call)")
    check(tuple(y_b.shape) == wmodel.oshape and bool(torch.isfinite(y_b).all()), "W-plane y finite, shape")
    xr = torch.rand(wmodel.ishape, generator=gen, device=dev)
    yr = torch.rand(wmodel.oshape, generator=gen, device=dev)

    def dot_rel(m):
        lhs = float(torch.dot(m.forward(xr).double(), yr.double()))
        rhs = float(torch.dot(xr.reshape(-1).double(), m.adjoint(yr).reshape(-1).double()))
        return abs(lhs - rhs) / abs(lhs), lhs, rhs

    wmodel.wblur_impl = "dense"
    d_rel, lhs, rhs = dot_rel(wmodel)
    y_d = wmodel.forward(truth)
    wmodel.wblur_impl = "banded"
    log(f"[wplane] dense pair dot test (f64 sums): <Hx,y>={lhs:.9e} <x,H'y>={rhs:.9e} rel {d_rel:.3e} "
        f"(bound {tol_dot:g})")
    check(d_rel <= tol_dot, "W-plane dense dot test")
    b_rel, lhs, rhs = dot_rel(wmodel)
    log(f"[wplane] banded pair dot mismatch (its two masks differ by design): rel {b_rel:.3e} (bound 1e-2)")
    check(b_rel <= 1e-2, "W-plane banded dot mismatch")
    bd = rel(y_b, y_d)
    log(f"[wplane] banded vs dense forward: max rel {bd:.3e} (bound 5e-2; the truncated response mass)")
    check(bd <= 5e-2, "banded vs dense forward")

    n_k = wmodel.normal(truth)
    n_p = wmodel.normal(truth, plain=True)
    sync()
    nrm_rel = rel(n_k, n_p)
    log(f"[wplane] normal, kernels vs plain versions: max rel {nrm_rel:.3e} (bound {tol_normal:g})")
    check(bool(torch.isfinite(n_k).all()) and nrm_rel <= tol_normal, "W-plane normal kernels vs plain")
    del n_k, n_p

    gr.reset_launches()
    wb.reset_launches()
    wmodel.normal(truth)
    sync()
    per_app = (gr.launches, wb.launches, wb.launches_t)
    log(f"[wplane] launches per normal application: gather_rows {per_app[0]}, wblur_banded "
        f"{per_app[1]}, wblur_banded_t {per_app[2]} (expected {2 * n_pt}, {n_pt}, {n_pt}: one per "
        f"band and pointing and direction)")
    check(per_app == (2 * n_pt, n_pt, n_pt), "W-plane launches per normal application")

    vox = float(np.prod(wmodel.cube_shape))
    for impl in ("dense", "banded"):
        wmodel.wblur_impl = impl
        tf = cuda_ms(lambda: wmodel.forward(truth), REPS)
        ta = cuda_ms(lambda: wmodel.adjoint(y_b), REPS)
        tn = cuda_ms(lambda: wmodel.normal(truth), REPS)
        log(f"[wplane] {card}: {impl} blur: forward {tf:.3f} ms ({vox / (tf * 1e-3) / 1e9:.2f} GVox/s), "
            f"adjoint {ta:.3f} ms ({vox / (ta * 1e-3) / 1e9:.2f} GVox/s), normal {tn:.3f} ms/app "
            f"({2 * vox / (tn * 1e-3) / 1e9:.2f} GVox/s, 2 x {int(vox)} voxels per app)")
    log(f"[wplane] peak {torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB (W-plane path, "
        f"both models' tables on the card)")

    # the W-plane main path, counted: y, b = µ·Hᵗy, 10 CG iterations
    gr.reset_launches()
    wb.reset_launches()
    t0 = time.perf_counter()
    y_w = wmodel.forward(truth)
    wcrit = QuadCriterion_MRS(1.0, y_w, wmodel, mu_reg)
    wres = wcrit.run_method("lcg", maximum_iterations=10, return_state=True)
    sync()
    t_wmain = time.perf_counter() - t0
    wmain = (gr.launches, wb.launches, wb.launches_t)
    n_app = wres.n_iter + 1
    expect_w = (2 * n_pt + 2 * n_pt * n_app, n_pt * (1 + n_app), n_pt * (1 + n_app))
    wgn = wres.grad_norm
    log(f"[wplane] main path (y, b, {wres.n_iter} lcg it, mu_reg={mu_reg:g}) in {t_wmain:.3f} s; "
        f"launches gather_rows / wblur_banded / wblur_banded_t {wmain} (expected {expect_w}); "
        f"grad norms {wgn.tolist()}")
    check(wmain == expect_w and min(wmain) > 0, "W-plane main-path launches")
    check(bool(torch.isfinite(wcrit.b).all()) and bool(torch.isfinite(wres.x).all()), "W-plane b, x finite")
    check(wres.n_iter == 10 and bool(np.isfinite(wgn).all()) and wgn[-1] < wgn[0],
          "W-plane grad norms finite, falling")
    t0 = time.perf_counter()
    wres2 = wcrit.run_method("lcg", maximum_iterations=10, solver_state=wres.state)
    sync()
    ws_it = (time.perf_counter() - t0) / wres2.n_iter
    check(bool(np.isfinite(wres2.grad_norm).all()) and wres2.grad_norm[-1] < wgn[0], "W-plane resumed CG")
    log(f"[wplane] {card}: CG {ws_it:.4f} s/iteration (banded, 10 resumed iterations, host clock); "
        f"grad norm {wgn[0]:.4e} -> {wres2.grad_norm[-1]:.4e} after 20")
    del wmodel, wcrit, wres, wres2, wsetup, sotf, y_b, y_d, y_w, xr, yr
    torch.cuda.empty_cache()

    # 10. small inputs against the CPU f64 operators -----------------------
    for mode, kw in (("rank", dict(im_size=41, n_lambda=120, n_tpl=2)),
                     ("wplane banded", dict(im_size=31, n_lambda=200, n_tpl=3, detector_oversample=4,
                                            window_local=False, wblur_impl="banded",
                                            wblur_band_rtol=1e-3))):
        small, ssetup = make_model(n_channels=2, n_pointings=2, n_slit=3, dtype=np.float64, **kw)
        small.to("cpu", torch.float64)
        xs = torch.as_tensor(ssetup["maps"])
        ref_y, ref_n = small.forward(xs), small.normal(xs)
        small.to(dev, torch.float32)
        got_y, got_n = small.forward(xs).cpu().double(), small.normal(xs).cpu().double()
        e_y, e_n = rel(got_y, ref_y), rel(got_n, ref_n)
        log(f"[small] {mode}: card f32 vs CPU f64: forward {e_y:.3e}, normal {e_n:.3e} (bound 1e-5)")
        check(e_y <= 1e-5 and e_n <= 1e-5, f"small {mode} problem vs CPU f64")

    log(json.dumps({"kernels": [{
        "name": "gather_rows",
        "route": "cuda",
        "source": "surfh_tpu_torch/csrc/gather_rows.cu",
        "replaces": "surfh_tpu/core/scatter_pallas.py:138",
        "launches": main_launches,
        "max_abs_err": kern["err"],
        "ms": kern["ms"],
        "plain_ms": kern["plain_ms"],
        "bound_ms": kern["bound_ms"],
        "bound_by": "bytes",
        "library_ms": kern["library_ms"],
    }] + [{
        "name": name,
        "route": "cuda",
        "source": "surfh_tpu_torch/csrc/wblur_banded.cu",
        "replaces": replaces,
        "launches": launches,
        "max_abs_err": bkern[name]["err"],
        "ms": bkern[name]["ms"],
        "plain_ms": bkern[name]["plain_ms"],
        "bound_ms": bkern[name]["bound_ms"],
        "bound_by": bkern[name]["bound_by"],
        "library_ms": bkern[name]["library_ms"],
    } for name, replaces, launches in (
        ("wblur_banded", "surfh_tpu/core/wblur_pallas.py:102", wmain[1]),
        ("wblur_banded_t", "surfh_tpu/core/wblur_pallas.py:227", wmain[2]))] + [{
        "name": f"gather_fixed_{k.lower()}",
        "route": "cuda",
        "source": "surfh_tpu_torch/csrc/gather_fixed.cu",
        "replaces": replaces,
        "launches": launches,
        "max_abs_err": pres["err_plain"][k],
        "ms": pres["ms"][k],
        "plain_ms": pres["plain_ms"][k],
        "bound_ms": pres["bound_ms"],
        "bound_by": "bytes",
        "library_ms": pres["ms"]["library"],
    } for k, replaces, launches in (
        ("K1", "scripts/scatter_pallas_proto.py:113", proto_launches[0]),
        ("K2", "scripts/scatter_pallas_proto.py:143", proto_launches[1]),
        ("K3", "scripts/scatter_pallas_proto.py:185", proto_launches[2]))]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
