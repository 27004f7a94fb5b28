#!/usr/bin/env python3
"""Drive surfh_tpu_torch's main path once on one NVIDIA card and check it.

    python3 chip_smoke.py [--bands 1a,1b,...]

Three paths of the flagship fusion solve at full width (501² sky, ~3879-λ
cube, M = 4 templates, 4 dither pointings, all 12 MIRI bands unless
`--bands` cuts them), f32 on the card, weights and data from seeds: the
rank mode (window-local, PSF stamps), the materialized-OTF W-plane mode
(`window_local=False`, `wblur_impl="banded"`, `wblur_band_rtol=1e-4`) and
the dense window-local mode (`conv_rank_rtol=0`); the composed-transpose
prototype entry point (`scripts/torch_scatter_proto.py`) with its three
fixed-fan-in kernels; through the port's command line, the band-1c
real-data rehearsal, the all-band path with NMF templates learned on the
card (BASELINE config 5) in both its models, `gen-psf`, and the
single-λ and λ-stack deconvolutions (BASELINE configs 1 and 2, both
geometries); the flagship under the JWST diffraction PSF and with
nearest-neighbour gridding; one band's staged gridding; the sharded paths
over `torch.distributed` (channel-expert, λ, 2-D; NCCL at world 1, gloo
for two processes on the one card) and BASELINE config 4 through
`torchrun`; `warmup`; and the repository's entry points: `bench_torch.py`,
the headline-measurement scripts and the user tools.

1. device      — the card's name and power limit (nvidia-smi);
2. build       — nvcc builds the six kernel sources from csrc/ into
                 build/, one nvcc each, in parallel;
   normal-prior — the criterion's fused normal (`core.normal_prior`) on
                 the voxel cube's shape [3879, 501, 501] against the eager
                 twelve-kernel chain it replaces: bit for bit, kernel and
                 plain ms, the byte bound of three volumes, its share;
   fft-conv    — kernel #8's three passes (`core.fft_conv`), the column
                 pass in each mode the pair runs (maps mode also on a
                 4-map spectrum) and a whole cube-mode conv direction on a
                 256-plane chunk of 501² planes: errors against the plain
                 versions and float64, kernel, plain and cuFFT ms, the
                 bound (bytes, or 5 N log2 N operations a transform);
   window-spectrum — kernel #9 (`core.window_spectrum`), the dense window
                 conv's spectrum side, both directions at bands 1b's and
                 3c's (W, Ka', Kb') with 4 templates: errors against the
                 plain spelling in float32 and float64, kernel and plain
                 ms, the byte floor (5 spectrum volumes a direction), its
                 share, the split;
3. host        — the flagship rank-mode host tables (NumPy, channels in
                 parallel), cold into a fresh disk-cache directory, then
                 again as a cache hit, bit for bit;
4. kernel      — the row gather against its plain torch version and the
                 library's CSR SpMM on one flagship channel's real composed
                 plans at the rank path's width (error, times, byte bound),
                 then at the W-plane path's width Q = W on every band's
                 pointing-0 gather and transpose, and once on base pointers
                 one float into their storage;
5. proto       — the prototype entry point as a user runs it (`run`: band
                 1c alone, one pointing, Q = W = 466) with K1–K3 launches
                 counted, then `run_proto` on every band's pointing-0
                 transpose of the flagship model at Q = W: K1–K3 against A,
                 their plain versions and the CSR kernel (errors, times,
                 byte bound, K1 / K3 against K2, the launch shapes), and a
                 NaN in src[0] through K1–K3 against their plain versions;
6. slice       — the rank path: upload, y = H·truth, an f64-accumulated dot
                 test, the fused normal through the kernel against the plain
                 version, launches per normal application, the main path
                 (y, b = µ·Hᵗy, 10 lcg iterations; the dispatch loop's 10
                 against them), timings;
7. wplane-host — the OTF built on the card from the PSF stamps, the W-plane
                 model over the rank model's channels, the band plans;
8. kernel      — both banded kernels against their plain versions and
                 cuBLAS on the masked table on every band's real plans
                 (error, times, flop bound, the forward's split and blocks,
                 the transpose's instance), each twice on one input bit for
                 bit;
9. wplane      — the W-plane path: FFT stage and relayout costs, y, the
                 dense pair's dot test, the banded pair's mismatch, banded
                 against dense, kernels against plain versions, launches per
                 normal application, times for both blurs, the main path
                 (y, b, 10 lcg iterations; the launches of #1, #2/#3, #7
                 and #8 counted and checked);
10. wlocal     — the dense window-local flagship (stamps, conv_freq_rtol
                 1e-6, conv_rank_rtol 0) over the rank model's channels:
                 the OTF windows evaluated on the card, the GEMM count of
                 the conv, kernels against plain gathers, the dot test, the
                 fused normal against adjoint∘forward, the forward against
                 the rank and the W-plane models within their truncation
                 bounds, launches, times, the main path (y, b, 20 lcg
                 iterations) with the launches of #1 and #9 counted, none
                 of #9 on the rank and W-plane models; its OTF-window variant (SURFH_PSF_STAMPS=0:
                 each band's window of the W-plane setup's sotf): one normal,
                 the dot test;
11. small      — the card's f32 operators (both modes) against the CPU f64
                 ones on small synthetic problems;
12. pipeline   — the real-data path through the port's CLI at full width
                 (band 1c, 4 pointings, 501² at 0.025″, the whole 1400-row
                 detector λ table, µ = 5e3, 400 iterations): `rehearse`
                 (synthetic stage-2 files,
                 Shepard correction, median filter, corrected-slice FITS,
                 the checkpointed W-plane fusion, the flux comparison)
                 against the reference's quality bars, with its row-gather
                 launches counted; Shepard on the card against a dense
                 float64 version for one slit; the fusion model rebuilt from
                 the slices (kernels against plain gathers, launches per
                 normal, the dense blur's dot test, times, peak memory);
                 `fusion --fusion-data` uninterrupted and stopped after 20
                 iterations then resumed, bit for bit;
13. allband    — BASELINE config 5 through the port's CLI at full width
                 (all 12 bands, 4 pointings, 501², the 2412-λ PCE grids, 4
                 NMF templates learned on the card in 300 iterations, 50 lcg
                 iterations, the W-plane model with the dense blur): the
                 report and stage times, the NMF loop against its byte bound,
                 the row-gather launches counted, the peak memory; on the
                 learned-template model, kernels against plain gathers,
                 launches per normal, the dot test, the error against that
                 of the initial maps, `mmmg` against `lcg` (50 iterations
                 each, the reference's criterion-gap bar) and `mmmg`'s
                 dispatch loop against its graph loop, bit for bit;
14. allband-wl — the same with `--window-local` (each band's OTF window, a
                 view of the setup's sotf on the card, the dense matmul
                 conv), the same checks but `mmmg`'s;
15. psf        — `gen-psf` at its defaults (band 1c, 1400 λ, 501², n_pupil
                 256) plain and with the commissioning OPD, sampled planes
                 against the host NumPy stack; the flagship under
                 SURFH_SIM_PSF=diffraction (stamps built on the card), its
                 rank model's per-band rank and tail, one normal, the dot
                 test;
16. nn         — (after wlocal) the W-plane banded flagship with
                 nearest-neighbour gridding over the rank model's bands
                 regridded and the wplane OTF: kernels against plain
                 versions, launches and ms per normal, 20 lcg iterations
                 counted, #1 on the NN plans at Q = W;
17. staged     — (after nn) band 1c's channel composed, staged (direct
                 box-sum) and with the FFT box-sum: forward and adjoint
                 against the composed one, launches, times, #1 on the
                 staged plans;
    channel-banded — band 2c's `Channel` built with the reference's
                 arguments and `wblur_impl="banded"` (rtol 1e-4) on a full
                 cube: the forward through #2 against its plain version and
                 against the band built dense, the adjoint bit for bit the
                 dense channel's, the dense pair's dot test, #2's launches
                 per forward (one per pointing) and none of #3 per adjoint,
                 ms per direction;
18. deconv2d   — (after small) BASELINE config 1 through the port's CLI
                 (301², 4 pointings, 200 lcg iterations, µ = 500),
                 `--rectangle` and `--rotated`: the report, launches, the
                 criterion's fall, f32 against f64 on the card, the f64 dot
                 test, kernels against plain gathers, ms per normal, #1 at
                 Q = 1 on the rotated plans;
19. deconv-cube — BASELINE config 2 (301², 100 λ planes, 2 pointings, 100
                 iterations, µ = 5) the same way, plus the stack forward
                 against the 2-D forward on three planes, #1 at Q = 100;
20. sharded    — (after wplane) `parallel.ShardedSpectro` at world 1 over
                 NCCL: on the rank flagship, the sharded normal bit for bit
                 `model.normal`, against the plain gathers, #1's launches
                 per normal, ms per normal and per all_reduce, 10 solve
                 iterations against 10 unsharded lcg ones; on the W-plane
                 banded flagship (each band's own λ window), against its
                 normal and the plain versions, launches of #1–#3, ms; then
                 two processes on the card over gloo from [host]'s table
                 cache with `shard_tables=True`: the normal against world
                 1's, the iterates of 10 solve iterations bit for bit
                 across the ranks, the table bytes per rank;
21. lambda     — `LambdaShardedChannel` on band 1c's channel at world 1
                 (NCCL) and 2 (gloo): the forward against the channel's,
                 the float64 pair's dot test, #1's launches;
22. mesh2d     — `ShardedSpectro2D` on the rank flagship over the two
                 processes as meshes (2, 1) and (1, 2): the normal against
                 `model.normal`, the all_reduces per normal;
23. config4    — (after psf) BASELINE config 4 through the port's CLI:
                 `fusion --simulated --sharded -nc 3 --pointings 4 -np 501
                 -nt 4 -ni 50 -hp 5e3` under torchrun and the same unsharded:
                 the reports, the criterion's fall, the command's maps bit
                 for bit the library's sharded solve, ms per normal and per
                 iteration, the objective against the unsharded lcg's;
24. warmup     — `warmup --bands 1c,2a --programs fwd,adj,normal` into a
                 fresh table cache, then again as a cache hit;
25. bench      — on [host]'s flagship model in this process, 3 dependent
                 applications g = Hᵗ(H x) (`bench_torch.apply_chain`)
                 through the kernels against the plain versions, their
                 launches, and the chain's CUDA-graph replay against the
                 eager chain; the same chain of `bench_torch.py`'s medium
                 preset with the dense and the banded blur (#1, #2, #3)
                 against the plain versions; then `bench_torch.py` as a user
                 runs it, four times: the flagship in dispatch mode and in
                 loop mode (its tables from [host]'s cache), medium (loop
                 mode: the CUDA graph) and medium with the banded blur:
                 each result line's keys, its device time from the
                 profiler trace, the wrappers' launches and the replay's
                 gap read from its log;
26. flagship-cg — `scripts/torch_flagship_cg.py --niter 50` on all 12 bands
                 (the tables from [host]'s cache): the report, the
                 gradient's fall, #1's launches;
27. quality    — `scripts/torch_quality_surface.py` on one point (Orion,
                 noise 0.01, µ = 5e3, 50 iterations) at full width;
28. audit      — `scripts/torch_rank_fidelity_audit.py --phase deviation`
                 on bands 1c and 2a (a cut in depth): both deviations within
                 the script's bound, #1's launches;
29. tools      — `torch_learn_templates.py --demo` (NMF, N-FINDR + FCLS on
                 the card), `torch_correct_mrs_data.py` then
                 `torch_filter_slices.py` on [pipeline]'s four stage-2
                 frames against the rehearsal's filtered slices, and
                 `torch_run_fusion_simulated.py` at its defaults with #1's
                 launches counted.

Prints the kernels' JSON record, then as its last line
``{"ok": true, "device": {...}}``.  Exits non-zero, with no result line,
when there is no CUDA device or any check fails.
"""

from __future__ import annotations

import argparse
import atexit
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

WORKERS = min(8, os.cpu_count() or 1)  # processes for the host table build
REPS = 10  # timed applications per operator
BAND_RTOL = 1e-4  # the banded blur's support threshold (the throughput setting)


def log(msg: str) -> None:
    print(msg, flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SystemExit(f"CHECK FAILED: {what}")


def tables_equal(a, b) -> bool:
    """Two host-table trees hold the same keys and the same bits."""
    import numpy as np

    if isinstance(a, dict):
        return sorted(a) == sorted(b) and all(tables_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(tables_equal(u, v) for u, v in zip(a, b))
    if hasattr(a, "row_ptr"):  # a gather plan
        return a.n_src == b.n_src and all(tables_equal(getattr(a, f), getattr(b, f))
                                          for f in ("row_ptr", "idx", "w", "dst"))
    u, v = np.asarray(a), np.asarray(b)
    return u.dtype == v.dtype and u.shape == v.shape and np.array_equal(u, v)


REHEARSE_BAND, REHEARSE_NPIX, REHEARSE_STEP = "1c", 501, 0.025
# At the rehearse command's defaults (µ = 1, 60 iterations) this geometry
# misses the flux bar at any iteration count: the sky outside band 1c's FOV
# (~8 % of the 501² grid) keeps CG's initial 0.5 and adds a flat spectrum to
# the fused cube's mean (flux_ratio_median 1.118-1.119 from 20 to 400
# iterations; the JAX package's rehearsal gives the same ratio, PERF.md
# section 6).  At the fusion's own default µ = 5e3 (`fusion`,
# `run_real_fusion`) CG pulls that sky in: 1.0942 at 400 iterations.
REHEARSE_MU, REHEARSE_NITER = 5e3, 400
FUSION_NITER, FUSION_SEGMENT = 60, 20  # `fusion --checkpoint-every 20 -ni 60`, stopped after 20
REHEARSE_BARS = "residual_rel < 0.10, 0.9 < flux_ratio_median < 1.1, flux_shape_corr > 0.9, flux_points > 50"


def shepard_plain(pa, pl, vals, am, lm, p=2.0, alpha=2.0, pixel_cutoff=1.0, alpha_res=1.0,
                  lambda_res=1.0, epsilon=1e-6, device=None, rows=512):
    """Float64 plain Shepard: every sample for every grid row, on `device`,
    from the float32 inputs the port's version reads."""
    import numpy as np
    import torch

    def f(a):
        return torch.as_tensor(np.asarray(a, np.float32).ravel()).to(device, torch.float64)

    pa, pl, vals, ga, gl = f(pa), f(pl), f(vals), f(am), f(lm)
    out = torch.empty_like(ga)
    for i in range(0, ga.numel(), rows):
        da = (pa[None] - ga[i : i + rows, None]) / alpha_res
        dl = (pl[None] - gl[i : i + rows, None]) / lambda_res
        dist = torch.sqrt(da * da + dl * dl) + epsilon
        w = torch.where(dist <= pixel_cutoff, torch.exp(-alpha * dist**p), 0.0)
        den = w.sum(1)
        out[i : i + rows] = torch.where(den != 0, (w @ vals) / torch.where(den != 0, den, 1.0), 0.0)
    return out.reshape(np.shape(am))


def run_pipeline_phase(dev, card: str, cuda_ms, gen) -> dict:
    """12. The real-data path at full width through the port's CLI; returns
    the row-gather launches of the rehearsal and the phase's numbers."""
    import contextlib
    import io

    import numpy as np
    import torch

    from surfh_tpu_torch import cli as tcli
    from surfh_tpu_torch import pipeline as tpl
    from surfh_tpu_torch.core import fft
    from surfh_tpu_torch.core import gather_rows as gr
    from surfh_tpu_torch.preprocessing import distortion
    from surfh_tpu_torch.solvers.criterion import QuadCriterion_MRS

    def sync():
        torch.cuda.synchronize(dev)

    def run_cli(argv, tag):
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = tcli.main(argv)
        lines = out.getvalue().strip().splitlines()
        for line in lines[:-1]:
            log(f"[pipeline] {tag}: {line}")
        check(rc == 0 and bool(lines), f"{tag}: exit code {rc}")
        log(f"[pipeline] {tag}: {lines[-1]} ({time.perf_counter() - t0:.2f} s)")
        return json.loads(lines[-1])

    work = tempfile.mkdtemp(prefix="surfh_rehearse_")
    res = {}
    shepard = distortion.exponential_modified_shepard
    try:
        # 1. the rehearsal through the port's CLI, Shepard timed, gathers counted
        shep = {"calls": 0, "s": 0.0, "first": None}

        def timed_shepard(*a, **k):
            t0 = time.perf_counter()
            out = shepard(*a, **k)  # a host array: the card has finished
            shep["s"] += time.perf_counter() - t0
            shep["calls"] += 1
            if shep["first"] is None:
                shep["first"] = (a, k, out)
            return out

        distortion.exponential_modified_shepard = timed_shepard
        torch.cuda.reset_peak_memory_stats(dev)
        gr.reset_launches()
        try:
            rep = run_cli(["rehearse", "-w", work, "--band", REHEARSE_BAND, "--pointings", "4",
                           "-np", str(REHEARSE_NPIX), "--step", str(REHEARSE_STEP),
                           "--lambda-subsample", "1", "-hp", str(REHEARSE_MU), "-ni", str(REHEARSE_NITER)],
                          "rehearse")
        finally:
            distortion.exponential_modified_shepard = shepard
        sync()
        res["launches"] = gr.launches
        n_it = rep["n_iterations"] - 1
        # µ·Hᵗy, the initial residual, one normal per iteration, the final forward: 8 a normal
        expect = 4 + 8 * (n_it + 1) + 4
        log(f"[pipeline] {card}: rehearse band {rep['band']}, {rep['n_pointings']} pointings, "
            f"npix {rep['npix']}: stage-2 {rep['t_stage2_s']} s, correction {rep['t_correct_s']} s "
            f"(Shepard {shep['calls']} slits, {1e3 * shep['s']:.1f} ms in all), fusion "
            f"{rep['t_fusion_s']} s ({n_it} iterations); residual_rel {rep['residual_rel']:.4e}, "
            f"flux_ratio_median {rep['flux_ratio_median']:.4f}, flux_shape_corr "
            f"{rep['flux_shape_corr']:.4f}, flux_points {rep['flux_points']} (bars: {REHEARSE_BARS}); "
            f"gather_rows launches {res['launches']} (expected {expect}); peak "
            f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")
        check(rep["band"] == REHEARSE_BAND and rep["npix"] == REHEARSE_NPIX and n_it == REHEARSE_NITER,
              "rehearse configuration")
        check(rep["residual_rel"] < 0.10 and 0.9 < rep["flux_ratio_median"] < 1.1
              and rep["flux_shape_corr"] > 0.9 and rep["flux_points"] > 50,
              f"rehearse quality bars ({REHEARSE_BARS}): {rep}")
        check(res["launches"] == expect, "rehearse gather_rows launches")
        os.remove(os.path.join(work, "out", "res_cube.npy"))
        # [tools] corrects and filters the rehearsal's stage-2 frames again
        res["stage2_dir"] = tempfile.mkdtemp(prefix="surfh_stage2_")
        atexit.register(shutil.rmtree, res["stage2_dir"], True)
        for d in ("raw", "Filtered_slices"):
            shutil.copytree(os.path.join(work, d), os.path.join(res["stage2_dir"], d))
        shutil.copy(os.path.join(work, "Templates", "wavel_axis.npy"), res["stage2_dir"])

        # 2. Shepard on the card against the dense float64 version, one slit of pointing 0
        a, k, got = shep["first"]
        t0 = time.perf_counter()
        want = shepard_plain(*a, **{**k, "device": dev}).cpu().numpy()
        err = float(np.abs(got - want).max() / np.abs(want).max())
        log(f"[pipeline] Shepard, slit 1 of pointing 0: grid {np.shape(a[3])} x {np.size(a[0])} samples: "
            f"card f32 vs dense f64 max rel {err:.3e} (bound 1e-5), zero cells {int((got == 0).sum())} / "
            f"{int((want == 0).sum())} ({time.perf_counter() - t0:.2f} s for the f64 version)")
        check(err <= 1e-5, "Shepard vs float64")
        res["shepard_ms"] = 1e3 * shep["s"]

        # 3. the fusion model rebuilt from the corrected slices
        step = REHEARSE_STEP / 3600.0
        t0 = time.perf_counter()
        templates = np.load(os.path.join(work, "Templates", "templates.npy"))
        wavel = np.load(os.path.join(work, "Templates", "wavel_axis.npy"))
        spsf = tpl.crop_psf_stack(np.load(os.path.join(work, "PSF", "psf.npy")), REHEARSE_NPIX)
        alpha = np.arange(REHEARSE_NPIX) * step
        alpha -= alpha.mean()
        torch.cuda.reset_peak_memory_stats(dev)
        sotf = fft.ir2fr_device(spsf, (REHEARSE_NPIX, REHEARSE_NPIX), dev)
        dd = tpl.load_corrected_data(os.path.join(work, "Filtered_slices"), [REHEARSE_BAND])
        pm = tpl.create_model(sotf, templates, alpha, alpha.copy(), wavel,
                              tpl.create_instruments(dd, [REHEARSE_BAND]), step, dd, device=dev)
        y = pm.real_data_janskySR_to_jansky(tpl.assemble_data_vector(pm, dd, [REHEARSE_BAND]))
        sync()
        chan = pm.channels[0]
        log(f"[pipeline] model from Filtered_slices in {time.perf_counter() - t0:.2f} s: cube "
            f"{pm.cube_shape}, maps {pm.ishape}, y {pm.oshape[0]}, oshape {chan.oshape}, W "
            f"{chan.n_wslice}, bbox {chan.tbbox}, box offset {chan.box_offset}")
        x = torch.rand(pm.ishape, generator=gen, device=dev)
        n_k, n_p = pm.normal(x), pm.normal(x, plain=True)
        sync()
        nrm = float((n_k - n_p).abs().max() / n_p.abs().max())
        gr.reset_launches()
        pm.normal(x)
        sync()
        per_app = gr.launches
        xr = torch.rand(pm.ishape, generator=gen, device=dev)
        yr = torch.rand(pm.oshape, generator=gen, device=dev)
        lhs = float(torch.dot(pm.forward(xr).double(), yr.double()))
        rhs = float(torch.dot(xr.reshape(-1).double(), pm.adjoint(yr).reshape(-1).double()))
        dot = abs(lhs - rhs) / abs(lhs)
        log(f"[pipeline] normal, kernels vs plain gathers: max rel {nrm:.3e} (bound 1e-5); gather_rows "
            f"launches per normal {per_app} (expected 8: 4 pointings x 2 directions); dense-blur dot "
            f"test (f64 sums) <Hx,y>={lhs:.9e} <x,H'y>={rhs:.9e} rel {dot:.3e} (bound 1e-5)")
        check(bool(torch.isfinite(n_k).all()) and nrm <= 1e-5, "pipeline normal kernels vs plain")
        check(per_app == 8, "pipeline gather_rows launches per normal")
        check(dot <= 1e-5, "pipeline dense dot test")
        del n_k, n_p, xr, yr
        res["normal_ms"] = cuda_ms(lambda: pm.normal(x), REPS)
        crit = QuadCriterion_MRS(1.0, y, pm, REHEARSE_MU)
        crit.b
        sync()
        t0 = time.perf_counter()
        cres = crit.run_method("lcg", maximum_iterations=10)
        sync()
        res["cg_s_it"] = (time.perf_counter() - t0) / cres.n_iter
        res["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30
        vox = float(np.prod(pm.cube_shape))
        log(f"[pipeline] {card}: normal {res['normal_ms']:.3f} ms/app ({2 * vox / (res['normal_ms'] * 1e-3) / 1e9:.2f} "
            f"GVox/s, 2 x {int(vox)} voxels), CG {res['cg_s_it']:.4f} s/iteration (10 iterations, host "
            f"clock), peak {res['peak_gib']:.2f} GiB (model, OTF, CG)")
        check(cres.n_iter == 10 and bool(np.isfinite(cres.grad_norm).all()), "pipeline CG")
        del pm, crit, cres, sotf, x, y
        torch.cuda.empty_cache()

        # 4. fusion --fusion-data: uninterrupted, and stopped after 20 then resumed
        base = ["fusion", "--fusion-data", work, "-np", str(REHEARSE_NPIX), "-hp", str(REHEARSE_MU), "-sd",
                "--checkpoint-every", str(FUSION_SEGMENT)]
        out_a, out_b = os.path.join(work, "fused_a"), os.path.join(work, "fused_b")
        n, seg = str(FUSION_NITER), str(FUSION_SEGMENT)
        ra = run_cli(base + ["-ni", n, "-o", out_a], f"fusion, {n} iterations")
        os.remove(os.path.join(out_a, "res_cube.npy"))
        rb = run_cli(base + ["-ni", seg, "-o", out_b], f"fusion, stopped after {seg}")
        rb = run_cli(base + ["-ni", n, "-o", out_b], f"fusion, resumed to {n}")
        xa = np.load(os.path.join(out_a, "res_x.npy"))
        xb = np.load(os.path.join(out_b, "res_x.npy"))
        same = np.array_equal(xa, xb)
        log(f"[pipeline] resumed fusion bit for bit the uninterrupted one: {same} (max abs diff "
            f"{float(np.abs(xa - xb).max()):.3e}); final grad norm {ra['final_grad_norm']:.6e} / "
            f"{rb['final_grad_norm']:.6e}")
        check(ra["niter"] == rb["niter"] == FUSION_NITER and same,
              "checkpointed fusion resumed vs uninterrupted")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return res


WLOCAL_FREQ_RTOL, WLOCAL_NITER = 1e-6, 20


def run_wlocal_phase(dev, card: str, cuda_ms, gen, bound, model, setup, wmodel, wsetup, truth,
                     mu_reg: float) -> dict:
    """10. The dense window-local flagship (PSF stamps, conv_freq_rtol 1e-6,
    conv_rank_rtol 0) over the rank model's channels, then its OTF-window
    variant from the W-plane setup's sotf, held against the rank `model`
    and the W-plane `wmodel` (its dense blur).  The truncation bounds are
    checked in float64 on the card (each model's f32 tables, plain
    gathers): in float32 the rounding of the three pipelines, ~1e-5 each,
    lies above them, as the reference notes of its own f32 runs.  Returns
    the row-gather launches of its main path and the phase's numbers."""
    import copy

    import numpy as np
    import torch

    from surfh_tpu_torch.core import gather_rows as gr
    from surfh_tpu_torch.core import window_spectrum as ws
    from surfh_tpu_torch.simulation.flagship import make_flagship_model
    from surfh_tpu_torch.solvers.criterion import QuadCriterion_MRS

    def sync():
        torch.cuda.synchronize(dev)

    def rel(a, b) -> float:
        return float((a - b).abs().max() / b.abs().max())

    def dot_rel(m):
        xr = torch.rand(m.ishape, generator=gen, device=dev)
        yr = torch.rand(m.oshape, generator=gen, device=dev)
        lhs = float(torch.dot(m.forward(xr).double(), yr.double()))
        rhs = float(torch.dot(xr.reshape(-1).double(), m.adjoint(yr).reshape(-1).double()))
        return abs(lhs - rhs) / abs(lhs), lhs, rhs

    truth64 = truth.double()

    def forward64(m, **attrs):
        """`m`'s forward of the truth in float64 on the card (a copy of the
        model, its own f64 device tables, the plain gathers)."""
        c = copy.copy(m)
        c.__dict__.update(attrs)
        out = c.to(dev, torch.float64).forward(truth64, plain=True)
        del c
        return out

    res = {}
    n_pt = sum(c.oshape[0] for c in model.channels)
    y_rank, y_wplane = forward64(model), forward64(wmodel, wblur_impl="dense")
    wmodel.wblur_impl = "dense"
    y32_rank, y32_wplane = model.forward(truth), wmodel.forward(truth)
    wmodel.wblur_impl = "banded"
    t0 = time.perf_counter()
    dm, _ = make_flagship_model(setup, dtype=np.float32, conv_freq_rtol=WLOCAL_FREQ_RTOL,
                                conv_rank_rtol=0.0, channels=model.channels, workers=WORKERS)
    t_host = time.perf_counter() - t0
    check(all("psf" in t and "cu" not in t for t in dm.host_tables()["chan"]),
          "dense stamp tables on every band")
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    t0 = time.perf_counter()
    dm.to(dev, torch.float32)
    sync()
    res["otf_s"] = time.perf_counter() - t0
    otf_gib = sum(2 * t["otf"][0].numel() * 4 for t in dm.tables["chan"]) / 2**30
    log(f"[wlocal] dense window-local model (stamps, conv_freq_rtol {WLOCAL_FREQ_RTOL:g}, "
        f"conv_rank_rtol 0) over the rank model's channels: host tables {t_host:.2f} s ({WORKERS} "
        f"workers); upload and the OTF windows evaluated on the card {res['otf_s']:.3f} s "
        f"({otf_gib:.3f} GiB of windows, {(torch.cuda.memory_allocated(dev) - base) / 2**30:.3f} GiB "
        f"of tables in all)")
    macs = 0.0
    for chan, sup, t in zip(dm.channels, dm.conv_supports, dm.tables["chan"]):
        w, ka, kb = t["otf"][0].shape
        ha, wb = chan.tbbox[2], chan.tbbox[3]
        mac = 3.0 * w * ha * ka * kb + 2.0 * w * ha * kb * wb
        macs += mac
        log(f"[wlocal]   {chan.instr.name}: W {w}, Ka' {ka}, Kb' {kb} (ka_max {sup['ka_max']}, "
            f"keep {sup['keep_frac']:.4f}, dropped_rel {sup['dropped_rel']:.3e}), bbox {ha} x {wb}: "
            f"inverse stages {mac / 1e9:.3f} G multiply-adds a direction")
    res["gflop"] = 2 * 2 * macs / 1e9  # two directions, two flops a multiply-add
    res["bound_ms"] = bound(0.0, 2 * 2 * macs)[0]
    tail = max(s.get("rank_tail", 0.0) for s in model.conv_supports)
    dropped = max(s["dropped_rel"] for s in dm.conv_supports)

    n_k = dm.normal(truth)
    n_p = dm.normal(truth, plain=True)
    n_c = dm.adjoint(dm.forward(truth))
    sync()
    nrm, fused = rel(n_k, n_p), rel(n_k, n_c)
    del n_p, n_c
    d_rel, lhs, rhs = dot_rel(dm)
    y_d = forward64(dm)
    e_rank, e_wplane = rel(y_d, y_rank), rel(y_d, y_wplane)
    y32 = dm.forward(truth)
    e32_rank, e32_wplane = rel(y32, y32_rank), rel(y32, y32_wplane)
    b_rank, b_wplane = max(10 * tail, 1e-5), 1e-5 + 10 * dropped
    log(f"[wlocal] normal, kernels vs plain gathers: max rel {nrm:.3e} (bound 1e-5); fused normal vs "
        f"adjoint(forward) {fused:.3e} (bound 1e-5); dot test (f64 sums) <Hx,y>={lhs:.9e} "
        f"<x,H'y>={rhs:.9e} rel {d_rel:.3e} (bound 1e-5); in float64 on the card, forward vs the rank "
        f"model {e_rank:.3e} (bound max(10 x rank tail {tail:.3e}, 1e-5) = {b_rank:.3e}), vs the W-plane "
        f"FFT model (dense blur) {e_wplane:.3e} (bound 1e-5 + 10 x dropped_rel {dropped:.3e} = "
        f"{b_wplane:.3e}); the same in float32: {e32_rank:.3e}, {e32_wplane:.3e}")
    check(bool(torch.isfinite(n_k).all()) and nrm <= 1e-5, "wlocal normal kernels vs plain")
    check(fused <= 1e-5, "wlocal fused normal vs adjoint(forward)")
    check(d_rel <= 1e-5, "wlocal dot test")
    check(e_rank <= b_rank, "wlocal forward vs the rank model (float64)")
    check(e_wplane <= b_wplane, "wlocal forward vs the W-plane model (float64)")
    del n_k, y_d, y32, y32_rank, y32_wplane, y_rank
    res.update(err_rank=e_rank, err_wplane=e_wplane, dot=d_rel, normal_err=nrm)

    gr.reset_launches()
    ws.reset_launches()
    dm.normal(truth)
    sync()
    per_app, n_b = gr.launches, len(dm.channels)
    res["spectrum_per_normal"] = (ws.launches, ws.launches_sum)
    check(per_app == 2 * n_pt, f"wlocal gather_rows launches per normal {per_app}")
    check(ws.launches == 2 * n_b, f"wlocal window_spectrum launches per normal {ws.launches}")
    ws.reset_launches()
    model.normal(truth)
    wmodel.normal(truth)
    sync()
    log(f"[wlocal] window_spectrum (#9) per dense normal: {res['spectrum_per_normal'][0]} launches "
        f"(expected {2 * n_b}: one a band a direction) and {res['spectrum_per_normal'][1]} partial-sum "
        f"passes; on a rank normal and a W-plane normal: {ws.launches}")
    check(ws.launches == 0, f"window_spectrum launches on the rank and W-plane models {ws.launches}")
    res["normal_ms"] = cuda_ms(lambda: dm.normal(truth), REPS)
    vox = float(np.prod(dm.cube_shape))
    log(f"[wlocal] {card}: normal {res['normal_ms']:.3f} ms/app ({2 * vox / (res['normal_ms'] * 1e-3) / 1e9:.2f} "
        f"GVox/s, 2 x {int(vox)} voxels); the inverse-stage GEMMs {res['gflop']:.1f} GFLOP an application, "
        f"their FP32 bound {res['bound_ms']:.3f} ms; gather_rows launches per normal {per_app} (expected "
        f"{2 * n_pt})")

    # the main path, counted: y, b = µ·Hᵗy, 20 lcg iterations
    gr.reset_launches()
    ws.reset_launches()
    y = dm.forward(truth)
    crit = QuadCriterion_MRS(1.0, y, dm, mu_reg)
    crit.b
    sync()
    t0 = time.perf_counter()
    r = crit.run_method("lcg", maximum_iterations=WLOCAL_NITER)
    sync()
    res["cg_s_it"] = (time.perf_counter() - t0) / r.n_iter
    res["launches"] = gr.launches
    res["spectrum_launches"] = (ws.launches, ws.launches_sum)
    expect = 2 * n_pt + 2 * n_pt * (r.n_iter + 1)
    expect_ws = 2 * n_b + 2 * n_b * (r.n_iter + 1)
    res["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30
    gn = r.grad_norm
    log(f"[wlocal] {card}: lcg {res['cg_s_it']:.4f} s/iteration ({r.n_iter} iterations, host clock); "
        f"grad norm {gn[0]:.4e} -> {gn[-1]:.4e}; gather_rows launches on the main path {res['launches']} "
        f"(expected {expect}); window_spectrum {res['spectrum_launches'][0]} (expected {expect_ws}) "
        f"and {res['spectrum_launches'][1]} partial-sum passes; peak {res['peak_gib']:.2f} GiB (every "
        f"model on the card)")
    check(r.n_iter == WLOCAL_NITER and bool(np.isfinite(gn).all()) and gn[-1] < gn[0], "wlocal CG")
    check(res["launches"] == expect, "wlocal main-path launches")
    check(res["spectrum_launches"][0] == expect_ws, "wlocal main-path window_spectrum launches")
    del dm, crit, r, y
    torch.cuda.empty_cache()

    # the OTF-window variant (SURFH_PSF_STAMPS=0): each band's window cut from the sotf
    os.environ["SURFH_PSF_STAMPS"] = "0"
    try:
        t0 = time.perf_counter()
        om, _ = make_flagship_model(wsetup, dtype=np.float32, conv_freq_rtol=WLOCAL_FREQ_RTOL,
                                    conv_rank_rtol=0.0, channels=model.channels)
        sync()
        t_host = time.perf_counter() - t0
    finally:
        del os.environ["SURFH_PSF_STAMPS"]
    check(om.psf_stack is None and all("sotf_w" in t for t in om.host_tables()["chan"]),
          "OTF-window tables on every band")
    om.to(dev, torch.float32)
    d_rel, lhs, rhs = dot_rel(om)
    e_wplane = rel(forward64(om), y_wplane)
    dropped = max(s["dropped_rel"] for s in om.conv_supports)
    res["otf_window_ms"] = cuda_ms(lambda: om.normal(truth), 3)
    log(f"[wlocal] {card}: OTF-window variant (each band's window of the W-plane setup's sotf, cut "
        f"on the card to its support at {WLOCAL_FREQ_RTOL:g}: host {t_host:.2f} s): normal "
        f"{res['otf_window_ms']:.3f} ms/app; dot test rel {d_rel:.3e} (bound 1e-5); in float64, forward vs "
        f"the W-plane FFT model {e_wplane:.3e} (bound {1e-5 + 10 * dropped:.3e})")
    check(d_rel <= 1e-5, "OTF-window dot test")
    check(e_wplane <= 1e-5 + 10 * dropped, "OTF-window forward vs the W-plane model")
    del om
    torch.cuda.empty_cache()
    return res


ALLBAND_NPIX, ALLBAND_NITER, ALLBAND_NMF_ITER, ALLBAND_MU = 501, 50, 300, 5e3
# BASELINE config 5 at full width: all 12 bands, 4 pointings, 501² at 0.025″,
# the 2412-λ PCE grids, 4 templates, the W-plane model with the dense blur
ALLBAND_ARGV = ["allband", "-np", str(ALLBAND_NPIX), "--pointings", "4", "-nt", "4",
                "-hp", str(ALLBAND_MU), "-ni", str(ALLBAND_NITER), "--nmf-iter", str(ALLBAND_NMF_ITER),
                "--lambda-subsample", "1", "-m", "lcg"]
MMMG_GAP = 0.02  # (J_mm − J_cg) / (J₀ − J_cg): the reference's bar (tests/test_reconstruction_quality.py)


def run_allband_phase(dev, card: str, cuda_ms, gen, bound, window_local: bool = False) -> dict:
    """13. The all-band path (NMF templates learned on the card, then the
    12-band fusion) at full width through the port's CLI; then checks on
    the learned-template model it solved with, and `mmmg` against `lcg`.
    With `window_local` (14.), ``allband --window-local``: the window-local
    model over each band's OTF window (views of the setup's sotf), the same
    checks but `mmmg`'s.  Returns the row-gather launches of the CLI run
    and the phase's numbers."""
    import contextlib
    import io

    import numpy as np
    import torch

    from surfh_tpu_torch import cli as tcli
    from surfh_tpu_torch.core import gather_rows as gr
    from surfh_tpu_torch.core import lmm
    from surfh_tpu_torch.learning import decomposition
    from surfh_tpu_torch.simulation.flagship import make_allband_setup
    from surfh_tpu_torch.solvers import criterion
    from surfh_tpu_torch.utils import metrics

    def sync():
        torch.cuda.synchronize(dev)

    seen = {}
    learn, nmf_run, crit_cls = decomposition.learn_templates_nmf, decomposition._nmf_run, criterion.QuadCriterion_MRS

    def kept_learn(*a, **k):
        out = learn(*a, **k)
        seen["templates"] = out[0].detach().clone()  # before the pipeline normalizes the rows
        return out

    def timed_nmf_run(X, W, H, n_iter):
        sync()
        t0 = time.perf_counter()
        out = nmf_run(X, W, H, n_iter)
        sync()
        seen.update(nmf_loop_s=time.perf_counter() - t0, nmf_shape=tuple(X.shape), nmf_iter=n_iter)
        return out

    class KeptCriterion(crit_cls):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            seen["crit"] = self

    tag = "[allband-wl]" if window_local else "[allband]"
    argv = ALLBAND_ARGV + (["--window-local"] if window_local else [])
    work = tempfile.mkdtemp(prefix="surfh_allband_")
    res = {}
    decomposition.learn_templates_nmf, decomposition._nmf_run = kept_learn, timed_nmf_run
    criterion.QuadCriterion_MRS = KeptCriterion
    try:
        out = io.StringIO()
        torch.cuda.reset_peak_memory_stats(dev)
        gr.reset_launches()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = tcli.main(argv + ["-o", work])
        sync()
        wall = time.perf_counter() - t0
        res["launches"] = gr.launches
        res["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30
        lines = out.getvalue().strip().splitlines()
        check(rc == 0 and bool(lines), f"allband: exit code {rc}")
        rep = json.loads(lines[-1])
    finally:
        decomposition.learn_templates_nmf, decomposition._nmf_run = learn, nmf_run
        criterion.QuadCriterion_MRS = crit_cls
    try:
        log(f"{tag} {' '.join(argv)}: {lines[-1]} ({wall:.2f} s)")
        crit = seen["crit"]
        model = crit.model
        n_pt = sum(c.oshape[0] for c in model.channels)
        if window_local:
            base = model.sotf.untyped_storage().data_ptr()
            views = all(t["otf"][0].untyped_storage().data_ptr() == base for t in model.tables["chan"])
            log(f"{tag} the solved model: window-local {model.window_local}, conv {model.conv_impl}, "
                f"each band's OTF window a view of the setup's sotf on the card: {views}")
            check(model.window_local and model.conv_impl == "matmul" and views,
                  "allband --window-local: the OTF-window model over views of the sotf")
        # the data (forward), b = µ·Hᵗy (adjoint), the initial residual and one normal an iteration
        expect = n_pt + n_pt + 2 * n_pt * (ALLBAND_NITER + 1)
        t = rep["timings_s"]
        n, L = seen["nmf_shape"]
        nmf_bytes = 2.0 * 4 * n * L  # X (f32) read twice an iteration: WᵀX and XHᵀ
        nmf_bound_s = bound(nmf_bytes * seen["nmf_iter"])[0] / 1e3
        log(f"{tag} {card}: {len(rep['bands'])} bands, cube ({rep['n_lambda']}, {rep['npix']}, "
            f"{rep['npix']}), y {model.oshape[0]}; stages (s): build {t['build_s']}, simulate "
            f"{t['simulate_s']}, co-add {t['coadd_s']}, NMF {t['nmf_s']}, solve {t['solve_s']} "
            f"({rep['niter']} lcg iterations, {rep['iters_per_s']:.3f} it/s); NMF loop {seen['nmf_iter']} "
            f"iterations on X [{n} x {L}] f32 in {seen['nmf_loop_s']:.3f} s against a byte bound of "
            f"{nmf_bound_s:.3f} s (X read twice an iteration, {nmf_bytes / 1e9:.3f} GB; "
            f"{100 * nmf_bound_s / seen['nmf_loop_s']:.1f} % of it); gather_rows launches "
            f"{res['launches']} (expected {expect}); peak {res['peak_gib']:.2f} GiB")
        check(len(rep["bands"]) == len(model.channels) == 12 and rep["npix"] == ALLBAND_NPIX
              and rep["n_lambda"] == 2412 and rep["niter"] == ALLBAND_NITER, "allband configuration")
        nums = [rep["iters_per_s"], rep["nmf_recon_err"], rep["psnr_cube"], rep["relative_cube_error_pct"]]
        check(all(np.isfinite(v) for v in nums + list(t.values())), f"allband report finite: {rep}")
        tpl = seen["templates"]
        check(bool(torch.isfinite(tpl).all()) and float(tpl.min()) >= 0.0,
              f"NMF templates finite and nonnegative (min {float(tpl.min()):.3e})")
        check(res["launches"] == expect, "allband gather_rows launches")
        res.update(nmf_loop_s=seen["nmf_loop_s"], nmf_bound_s=nmf_bound_s, timings=t, report=rep)

        # the learned-template model: kernels, launches, dot test, times
        x = torch.rand(model.ishape, generator=gen, device=dev)
        n_k, n_p = model.normal(x), model.normal(x, plain=True)
        sync()
        nrm = float((n_k - n_p).abs().max() / n_p.abs().max())
        gr.reset_launches()
        model.normal(x)
        sync()
        per_app = gr.launches
        xr = torch.rand(model.ishape, generator=gen, device=dev)
        yr = torch.rand(model.oshape, generator=gen, device=dev)
        lhs = float(torch.dot(model.forward(xr).double(), yr.double()))
        rhs = float(torch.dot(xr.reshape(-1).double(), model.adjoint(yr).reshape(-1).double()))
        dot = abs(lhs - rhs) / abs(lhs)
        log(f"{tag} learned-template model: normal, kernels vs plain gathers max rel {nrm:.3e} "
            f"(bound 1e-5); gather_rows launches per normal {per_app} (expected {2 * n_pt}); dense-blur "
            f"dot test (f64 sums) <Hx,y>={lhs:.9e} <x,H'y>={rhs:.9e} rel {dot:.3e} (bound 1e-5)")
        check(bool(torch.isfinite(n_k).all()) and nrm <= 1e-5, "allband normal kernels vs plain")
        check(per_app == 2 * n_pt, "allband gather_rows launches per normal")
        check(dot <= 1e-5, "allband dense dot test")
        del n_k, n_p, xr, yr
        res["normal_ms"] = cuda_ms(lambda: model.normal(x), REPS)
        vox = float(np.prod(model.cube_shape))
        log(f"{tag} {card}: normal {res['normal_ms']:.3f} ms/app ({2 * vox / (res['normal_ms'] * 1e-3) / 1e9:.2f} "
            f"GVox/s, 2 x {int(vox)} voxels)")
        del x

        # the solve improves on its start: the cube error of the 0.5 initial maps
        setup = make_allband_setup(npix=ALLBAND_NPIX, build_sotf=False)
        truth = lmm.lmm_maps2cube(torch.as_tensor(np.asarray(setup["maps"], np.float32), device=dev),
                                  torch.as_tensor(np.asarray(setup["templates"], np.float32), device=dev))
        init = torch.full(model.ishape, 0.5, device=dev)
        err0 = metrics.relative_error(truth.cpu().numpy(), model.mapsToCube(init).cpu().numpy())
        del truth
        log(f"{tag} relative cube error {rep['relative_cube_error_pct']:.4f} % after {rep['niter']} "
            f"iterations, {err0:.4f} % at the 0.5 initial maps; PSNR {rep['psnr_cube']:.3f} dB; NMF "
            f"reconstruction error {rep['nmf_recon_err']:.6e}")
        check(rep["relative_cube_error_pct"] < err0, "allband solve improves on its start")
        if window_local:
            res.update(timings=t, report=rep)
            return res

        # mmmg against lcg from the same start, 50 iterations each; both loops of mmmg
        crit.b
        sync()
        runs = {}
        for method, loop in (("lcg", "graph"), ("mmmg", "graph"), ("mmmg", "dispatch")):
            gr.reset_launches()
            t0 = time.perf_counter()
            r = crit.run_method(method, maximum_iterations=ALLBAND_NITER, solver_loop=loop)
            sync()
            runs[(method, loop)] = (r, (time.perf_counter() - t0) / r.n_iter, gr.launches)
        j0 = crit.get_crit_val(init)
        (rc_, s_cg, l_cg), (rm, s_mm, l_mm), (rd, _, _) = runs.values()
        j_cg, j_mm = crit.get_crit_val(rc_.x), crit.get_crit_val(rm.x)
        gap = (j_mm - j_cg) / (j0 - j_cg)
        same = torch.equal(rd.x, rm.x) and rd.n_iter == rm.n_iter
        log(f"{tag} {card}: lcg {s_cg:.4f} s/iteration, mmmg {s_mm:.4f} s/iteration ({ALLBAND_NITER} "
            f"iterations each from the 0.5 maps, host clock); J0 {j0:.9e}, J_cg {j_cg:.9e}, J_mm {j_mm:.9e}: "
            f"gap (J_mm - J_cg) / (J0 - J_cg) {gap:.3e} (bound {MMMG_GAP}); mmmg gather_rows launches "
            f"{l_mm} (expected {2 * n_pt * (ALLBAND_NITER + 1)}); mmmg dispatch loop bit for bit the graph "
            f"loop's iterate: {same}")
        check(rc_.n_iter == rm.n_iter == ALLBAND_NITER and np.isfinite([j0, j_cg, j_mm]).all(), "allband solves")
        check(gap < MMMG_GAP, f"mmmg vs lcg gap {gap:.3e}")
        check(l_mm == l_cg == 2 * n_pt * (ALLBAND_NITER + 1), "allband solver launches")
        check(same, "mmmg dispatch loop against the graph loop")
        res.update(lcg_s_it=s_cg, mmmg_s_it=s_mm, gap=gap)
        del seen, crit, model, runs, rc_, rm, rd, init
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return res


PSF_SAMPLES = 5  # λ planes of each gen-psf stack held against the host stack


def run_psf_phase(dev, card: str, cuda_ms, gen, channels, bands) -> dict:
    """15. `gen-psf` at its defaults through the port's CLI (band 1c's 1400
    detector λ, 501², n_pupil 256), plain and with the commissioning OPD,
    `PSF_SAMPLES` planes of each against the host NumPy stack; then the
    flagship under ``SURFH_SIM_PSF=diffraction`` (the stamps built on the
    card) and its rank model over the given channels: per-band rank and
    tail, one normal, the dot test."""
    import contextlib
    import io

    import numpy as np
    import torch

    from surfh_tpu_torch import cli as tcli
    from surfh_tpu_torch.instrument.wavelength_mrs import get_mrs_wavelength
    from surfh_tpu_torch.simulation.flagship import make_flagship_model, make_flagship_setup
    from surfh_tpu_torch.utils import jwst_psf

    res = {}
    work = tempfile.mkdtemp(prefix="surfh_psf_")
    try:
        wavels = get_mrs_wavelength("1c")
        idx = np.linspace(0, len(wavels) - 1, PSF_SAMPLES).astype(int)
        opd_file = os.path.join(os.path.dirname(os.path.abspath(jwst_psf.__file__)), os.pardir,
                                "instrument", "data", "jwst_opd_commissioning.json")
        for label, extra in (("plain", []), ("commissioning OPD", ["--opd", "commissioning"])):
            path = os.path.join(work, "psf.npy")
            out = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(out):
                rc = tcli.main(["gen-psf", "-o", path] + extra)
            wall = time.perf_counter() - t0
            rep = json.loads(out.getvalue().strip().splitlines()[-1])
            stack = np.load(path, mmap_mode="r")
            check(rc == 0 and stack.shape == (len(wavels), 501, 501) and stack.dtype == np.float32,
                  f"gen-psf {label}: {rep}")
            got = np.asarray(stack[idx])
            opd = jwst_psf.recorded_opd(opd_file, 256) if extra else None
            t0 = time.perf_counter()
            want = jwst_psf.psf_stack(wavels[idx], 0.025, npix=501, n_pupil=256, opd=opd)
            t_host = time.perf_counter() - t0
            err = float(np.abs(got - want).max() / np.abs(want).max())
            res[label] = rep["seconds"]
            log(f"[psf] {card}: gen-psf {label} (band 1c, {len(wavels)} λ, 501², n_pupil 256): {rep} "
                f"({wall:.2f} s with the .npy written); {PSF_SAMPLES} planes vs the host NumPy stack "
                f"(its {PSF_SAMPLES} planes in {t_host:.2f} s): max {err:.3e} of the peak (bound 1e-5), "
                f"{int((got != want).sum())} of {got.size} values differ; "
                f"energy in the field {float(got.sum(axis=(1, 2)).min()):.4f}-{float(got.sum(axis=(1, 2)).max()):.4f}")
            check(bool(np.isfinite(got).all()) and err <= 1e-5, f"gen-psf {label} vs the host stack")
            del stack, got
            os.remove(path)
    finally:
        shutil.rmtree(work, ignore_errors=True)

    os.environ["SURFH_SIM_PSF"] = "diffraction"
    try:
        t0 = time.perf_counter()
        setup = make_flagship_setup(bands=bands, device=dev)
        res["stack_s"] = time.perf_counter() - t0
    finally:
        del os.environ["SURFH_SIM_PSF"]
    ps = setup["psf_stack"]
    check(ps.shape[1:] == (40, 40) and bool(np.isfinite(ps).all()), "diffraction stamps")
    t0 = time.perf_counter()
    model, _ = make_flagship_model(setup, dtype=np.float32, channels=channels, workers=WORKERS)
    t_host = time.perf_counter() - t0
    ranks = [s.get("rank") for s in model.conv_supports]
    tails = [s.get("rank_tail", 0.0) for s in model.conv_supports]
    log(f"[psf] SURFH_SIM_PSF=diffraction: {ps.shape} stamps on the card in {res['stack_s']:.2f} s (setup "
        f"included); rank model over the given channels, host tables {t_host:.2f} s ({WORKERS} workers); "
        f"the rank gate open on {sum(r is not None for r in ranks)} of {len(ranks)} bands; per band "
        f"(W, R, tail; R None: the gate declined, the dense conv): " + ", ".join(
            f"{c.instr.name} ({c.n_wslice}, {r}, {tl:.2e})" for c, r, tl in zip(model.channels, ranks, tails)))
    model.to(dev, torch.float32)
    truth = torch.as_tensor(setup["maps"], dtype=torch.float32, device=dev)
    xr = torch.rand(model.ishape, generator=gen, device=dev)
    yr = torch.rand(model.oshape, generator=gen, device=dev)
    lhs = float(torch.dot(model.forward(xr).double(), yr.double()))
    rhs = float(torch.dot(xr.reshape(-1).double(), model.adjoint(yr).reshape(-1).double()))
    d_rel = abs(lhs - rhs) / abs(lhs)
    res["normal_ms"] = cuda_ms(lambda: model.normal(truth), REPS)
    log(f"[psf] {card}: diffraction rank model: normal {res['normal_ms']:.3f} ms/app; dot test (f64 sums) "
        f"<Hx,y>={lhs:.9e} <x,H'y>={rhs:.9e} rel {d_rel:.3e} (bound 1e-5)")
    check(d_rel <= 1e-5, "diffraction rank model dot test")
    res.update(ranks=ranks, tails=tails)
    del model, truth, xr, yr
    torch.cuda.empty_cache()
    return res


def host_plan(plan):
    """A device CSR plan's host copy (the library yardstick's operand)."""
    from surfh_tpu_torch.core.gather_rows import RowGatherPlan

    return RowGatherPlan(*(getattr(plan, f).cpu().numpy() for f in ("row_ptr", "idx", "w", "dst")),
                         plan.n_src)


def gather_row_stats(dev, proto, cuda_ms, gen, bound, plan, q: int, what: str, tol: float) -> dict:
    """Kernel #1 on `plan` (on the card) at row width `q`: against its plain
    version (max rel error, checked ≤ `tol`) and torch.sparse.mm, with the
    three times and the byte bound; logs one `[kernel]` line."""
    import numpy as np
    import torch

    from surfh_tpu_torch.core import gather_rows as gr

    hp = host_plan(plan)
    spm = proto.library_csr(hp, dev)
    src = torch.rand((plan.n_src, q), generator=gen, device=dev)
    out_k, out_p, out_l = gr.gather_rows_cuda(src, plan), gr.gather_rows_reference(src, plan), \
        torch.sparse.mm(spm, src)
    torch.cuda.synchronize(dev)
    scale = float(out_p.abs().max())
    err = float((out_k - out_p).abs().max()) / scale
    err_l = float((out_l - out_p).abs().max()) / scale
    ms_k = cuda_ms(lambda: gr.gather_rows_cuda(src, plan), 50)
    ms_p = cuda_ms(lambda: gr.gather_rows_reference(src, plan), 20)
    ms_l = cuda_ms(lambda: torch.sparse.mm(spm, src), 50)
    n_read = np.unique(hp.idx).size
    b_ms, _ = bound(proto.gather_bytes(plan.n_rows, n_read, q, plan.nnz))
    shape = gr.gather_launch_shape(q, src.data_ptr() % 16 == 0, plan.nnz / max(plan.n_rows, 1))
    log(f"[kernel] {what}: rows {plan.n_rows} x Q {q}, n_src {plan.n_src} ({n_read} read), nnz "
        f"{plan.nnz}, launch shape (vec, cols, taps, group) {shape}: max rel err {err:.3e} "
        f"(bound {tol:g}); kernel {ms_k:.4f} ms, plain {ms_p:.4f} ms, torch.sparse.mm {ms_l:.4f} ms "
        f"(max rel {err_l:.3e}), byte bound {b_ms:.4f} ms ({100 * b_ms / ms_k:.1f} %)")
    check(err <= tol and err_l <= tol, f"kernel vs plain, {what}: {err:.3e}, library {err_l:.3e}")
    return {"err": float((out_k - out_p).abs().max()), "ms": ms_k, "plain_ms": ms_p,
            "library_ms": ms_l, "bound_ms": b_ms}


CUBE_SHAPE = (3879, 501, 501)  # the voxel cube: 12 bands' λ grid x the 501² sky


def run_normal_prior_phase(dev, card: str, cuda_ms, bound, shape=CUBE_SHAPE) -> dict:
    """The criterion's fused normal µ_s·h + µ_r·DᵀD x (`core.normal_prior`)
    on `shape` against the eager chain `QuadCriterion_MRS.normal_op` spelled
    before it (four rolls, eight elementwise passes): bit for bit, kernel
    and plain ms, the byte bound (x and h read, out written once); logs one
    `[kernel]` line."""
    import torch

    from surfh_tpu_torch.core import normal_prior as fused
    from surfh_tpu_torch.solvers.criterion import dtd_separated

    gen = torch.Generator(device=dev).manual_seed(23)
    x, h = torch.rand(shape, generator=gen, device=dev), torch.rand(shape, generator=gen, device=dev)
    mu_s, mu_r = torch.tensor(1.0, device=dev), torch.tensor(5e3, device=dev)  # the cube cell's µ's

    def plain():
        return mu_s * h + mu_r * dtd_separated(x)

    fused.reset_launches()
    same = torch.equal(fused.normal_prior_cuda(x, h, mu_s, mu_r), plain())
    check(same and fused.launches == 1, f"normal_prior kernel vs the eager chain on {list(shape)}: "
          f"bit for bit {same}, launches {fused.launches}")
    ms_k = cuda_ms(lambda: fused.normal_prior_cuda(x, h, mu_s, mu_r), 50)
    ms_p = cuda_ms(plain, 10)
    nbytes = 3 * x.numel() * x.element_size()
    b_ms, by = bound(nbytes)
    rows = fused.launch_rows(*shape[1:])
    log(f"[kernel] {card}: normal_prior {list(shape)} ({rows} rows a block): bit for bit the eager "
        f"chain; kernel {ms_k:.4f} ms, plain (12 kernels) {ms_p:.4f} ms, bound {b_ms:.4f} ms "
        f"({by}: {nbytes / 1e9:.3f} GB) ({100 * b_ms / ms_k:.1f} %)")
    del x, h
    torch.cuda.empty_cache()
    return {"ms": ms_k, "plain_ms": ms_p, "bound_ms": b_ms, "rows": rows}


def run_fft_conv_phase(dev, card: str, cuda_ms, bound, planes: int = 256, n: int = 501,
                       maps: int = 4) -> dict:
    """Kernel #8 (`core.fft_conv`) on one λ-chunk of the flagship's planes
    [planes, n, n] (the conv pair's chunk): each pass, the column pass in
    each mode the pair runs (cube mode fwd·OTF·inv on the chunk; maps mode
    fwd·conj(OTF) and OTF·inv on the chunk, fwd and inv alone on the
    [maps, n, n // 2 + 1] maps' spectra) and the whole cube-mode conv
    direction, against its plain version (the same algorithm in torch) and
    cuFFT's spelling (`library_ms`); the f32 error against float64 cuFFT,
    kernel ms, the bound (bytes over the memory rate or 5·N·log2 N
    operations a transform, `fft_conv.fft_flops`, over the FP32 rate, the
    larger), and beside it the kernels' own operations (`line_flops`) at
    their issue rate; logs one `[kernel]` line each."""
    import numpy as np
    import torch

    from surfh_tpu_torch.core import fft
    from surfh_tpu_torch.core import fft_conv as fc

    def rel(a, b) -> float:
        return float((a.to(b.dtype) - b).abs().max() / b.abs().max())

    gen = torch.Generator(device=dev).manual_seed(29)
    kb, rows = n // 2 + 1, planes * n
    x = torch.rand((planes, n, n), generator=gen, device=dev)
    stamps = np.random.default_rng(29).random((planes, min(40, n), min(40, n)))
    otf = fft.ir2fr_device(stamps / stamps.sum(axis=(1, 2), keepdims=True), (n, n), device=dev)
    spec = fc.rows_r2c(x)
    spec_m = fc.rows_r2c(x[:maps])
    scale = 1.0 / (n * n)
    real_b, half_b, half_m = x.numel() * 4, spec.numel() * 8, spec_m.numel() * 8
    row_lines, col_lines, col_m = (rows + 1) // 2, planes * kb, maps * kb
    x64, otf64 = x[:8].double(), otf[:8].to(torch.complex128)
    spec0, spec_m0 = spec.clone(), spec_m.clone()

    def col_case(s0, o, conj, fwd, inv, sc):
        """(kernel, checked call, plain, library) of one column mode on `s0`;
        the kernel is timed in place on a copy whose values are not read."""
        buf = s0.clone()
        kern = lambda: fc.columns_(buf, o, forward=fwd, inverse=inv, conj=conj, scale=sc)
        chk = lambda: fc.columns_(s0.clone(), o, forward=fwd, inverse=inv, conj=conj, scale=sc)
        plain = lambda: fc.columns_plain(s0.clone(), o, forward=fwd, inverse=inv, conj=conj, scale=sc)

        def lib():
            z = torch.fft.fft(s0, dim=1) if fwd else s0
            if o is not None:
                z = z * (o.conj() if conj else o) * sc
            return torch.fft.ifft(z, dim=1, norm="forward") if inv else z
        return kern, chk, plain, lib

    cases = {  # name: kernel, the call checked (None: the kernel's own), plain, library, float64
        #         reference of the first 8 planes, bytes, transforms, OTF products
        "rows_r2c": (lambda: fc.rows_r2c(x, out=spec), None, lambda: fc.rows_r2c_plain(x),
                     lambda: torch.fft.rfft(x), torch.fft.rfft(x64), real_b + half_b, row_lines, 0),
        "cols fwd*otf*inv": col_case(spec0, otf, False, True, True, 1.0 / n)
        + (None, 3 * half_b, 2 * col_lines, col_lines * n),
        "cols fwd*conj(otf)": col_case(spec0, otf, True, True, False, 1.0)
        + (None, 3 * half_b, col_lines, col_lines * n),
        "cols otf*inv": col_case(spec0, otf, False, False, True, 1.0)
        + (None, 3 * half_b, col_lines, col_lines * n),
        "cols fwd (maps)": col_case(spec_m0, None, False, True, False, 1.0)
        + (None, 2 * half_m, col_m, 0),
        "cols inv (maps)": col_case(spec_m0, None, False, False, True, 1.0)
        + (None, 2 * half_m, col_m, 0),
        "rows_c2r": (lambda: fc.rows_c2r(spec0, n), None, lambda: fc.rows_c2r_plain(spec0, n),
                     lambda: torch.fft.irfft(spec0, n=n), None, real_b + half_b, row_lines, 0),
        "cube direction": (
            lambda: fft.conv_otf_chunks(x, otf)[0], None,
            lambda: fc.rows_c2r_plain(fc.columns_plain(fc.rows_r2c_plain(x), otf, forward=True,
                                                       inverse=True, scale=scale), n),
            lambda: fft.idft(fft.dft(x) * otf, (n, n)),
            torch.fft.irfft2(torch.fft.rfft2(x64) * otf64, s=(n, n)),
            2 * real_b + 5 * half_b, 2 * row_lines + 2 * col_lines, col_lines * n),
    }
    out = {}
    for name, (kern, checked, plain, lib, ref64, nbytes, lines, prods) in cases.items():
        fc.reset_launches()
        got = (checked or kern)()
        want = plain()
        torch.cuda.synchronize(dev)
        err = rel(got, want)
        err64 = rel(got[:8], ref64) if ref64 is not None else float("nan")
        lib64 = rel(lib()[:8], ref64) if ref64 is not None else float("nan")
        launches = fc.launches
        ms_k, ms_p, ms_l = cuda_ms(kern, 20), cuda_ms(plain, 3), cuda_ms(lib, 20)
        flops = lines * fc.fft_flops(n) + 6 * prods
        own = lines * fc.line_flops(n) + 6 * prods
        b_ms, by = bound(nbytes, flops)
        shape = f"[{maps if '(maps)' in name else planes} x {n} x {kb if 'cols' in name else n}]"
        log(f"[kernel] {card}: fft_conv {name} {shape} ({launches} launches): max rel "
            f"err vs plain {err:.2e}, vs float64 {err64:.2e} (cuFFT {lib64:.2e}); kernel {ms_k:.4f} ms, "
            f"plain {ms_p:.4f} ms, library (cuFFT) {ms_l:.4f} ms; bound {b_ms:.4f} ms by {by} "
            f"({nbytes / 1e9:.3f} GB, {flops / 1e9:.2f} GFLOP at 5 N log2 N) ({100 * b_ms / ms_k:.1f} %); "
            f"the kernels' own {own / 1e9:.2f} GFLOP at {own / (ms_k * 1e-3) / 1e12:.1f} TFLOP/s")
        check(err <= 1e-5 and (ref64 is None or err64 <= 2e-6), f"fft_conv {name}: {err:.3e} / {err64:.3e}")
        out[name] = {"err": err, "err64": err64, "ms": ms_k, "plain_ms": ms_p, "library_ms": ms_l,
                     "bound_ms": b_ms, "bound_by": by, "own_gflop": own / 1e9, "launches": launches}
    whole = out["cube direction"]["ms"] * 3879 / planes
    log(f"[kernel] {card}: fft_conv a cube-mode direction on the whole [3879, {n}, {n}] cube ≈ "
        f"{whole:.2f} ms (cuFFT's spelling ≈ {out['cube direction']['library_ms'] * 3879 / planes:.2f} ms)")
    del x, spec, spec0, spec_m, spec_m0, otf, cases
    torch.cuda.empty_cache()
    return out


WINDOW_SPECTRUM_BANDS = {"1b": (564, 431, 216), "3c": (399, 501, 251)}  # (W, Ka', Kb'), 12-band flagship


def run_window_spectrum_phase(dev, card: str, cuda_ms, bound, n_map: int = 4) -> dict:
    """Kernel #9 (`core.window_spectrum`) at two bands' shapes of the
    dense window-local flagship, `n_map` templates: each direction against
    its plain spelling (the eager chain, the mix by cuBLAS) in float32 and
    in float64, kernel and plain ms, the byte floor (each input read once,
    each output written once: 5 spectrum volumes a direction and the maps'
    M-row terms), its share; logs one `[kernel]` line a direction and band."""
    import torch

    from surfh_tpu_torch.core import window_spectrum as ws

    def rel(a, b) -> float:
        return float((a.to(b.dtype) - b).abs().max() / b.abs().max())

    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    out = {}
    for band, (w, ka, kb) in WINDOW_SPECTRUM_BANDS.items():
        gen = torch.Generator(device=dev).manual_seed(31 + w)
        z = torch.randn((2, n_map, ka, kb), generator=gen, device=dev).unbind(0)
        k = torch.randn((3, w, ka, kb), generator=gen, device=dev).unbind(0)
        o = torch.randn((2, w, ka, kb), generator=gen, device=dev).unbind(0)
        tpl = torch.rand((n_map, w), generator=gen, device=dev)
        f64 = lambda ts: [t.double() for t in ts]  # noqa: E731
        nbins, s_vol = ka * kb, w * ka * kb
        maps_b = 4 * (2 * n_map * nbins + n_map * w)
        cases = {
            "forward": (lambda: ws.spectrum_cuda(*z, *o, tpl), lambda: ws.spectrum_plain(*z, *o, tpl),
                        lambda: ws.spectrum_plain(*f64(z), *f64(o), tpl.double()), 4 * 5 * s_vol + maps_b),
            "transpose": (lambda: ws.spectrum_t_cuda(*k, *o, tpl), lambda: ws.spectrum_t_plain(*k, *o, tpl),
                          lambda: ws.spectrum_t_plain(*f64(k), *f64(o), tpl.double()),
                          4 * 5 * s_vol + maps_b),
        }
        for name, (kern, plain, ref64, nbytes) in cases.items():
            ws.reset_launches()
            got, want, want64 = kern(), plain(), ref64()
            torch.cuda.synchronize(dev)
            err = max(rel(a, b) for a, b in zip(got, want))
            err64 = max(rel(a, b) for a, b in zip(got, want64))
            launches, sums = ws.launches, ws.launches_sum
            again = kern()
            same = all(torch.equal(a, b) for a, b in zip(got, again))
            del got, want, want64, again
            ms_k, ms_p = cuda_ms(kern, 20), cuda_ms(plain, 3)
            b_ms, by = bound(nbytes)
            split = ws.launch_split(w, nbins, n_sm)
            log(f"[kernel] {card}: window_spectrum {name} band {band} [W {w}, Ka' {ka}, Kb' {kb}], "
                f"{n_map} maps, split {split} ({launches} launch, {sums} sum pass): max rel err vs plain "
                f"{err:.2e}, vs float64 {err64:.2e}, run to run bit for bit {same}; kernel {ms_k:.4f} ms, "
                f"plain {ms_p:.4f} ms; bound {b_ms:.4f} ms by {by} ({nbytes / 1e9:.4f} GB) "
                f"({100 * b_ms / ms_k:.1f} %)")
            check(err <= 1e-5 and err64 <= 1e-5 and same and launches == 1,
                  f"window_spectrum {name} band {band}: {err:.3e} / {err64:.3e}, same {same}, "
                  f"launches {launches}")
            out[f"{name} {band}"] = {"err": err, "err64": err64, "ms": ms_k, "plain_ms": ms_p,
                                     "bound_ms": b_ms, "bound_by": by, "split": split}
        del z, k, o, tpl
        torch.cuda.empty_cache()
    return out


def check_prior_route(crit, x, tag: str) -> None:
    """`crit.normal_op(x)` on the card against its eager spelling
    µ_s·h + µ_r·DᵀD x at this path's shape, h = HᵗH x computed once for
    both: bit for bit, one launch of the fused normal; logs one line."""
    import torch

    from surfh_tpu_torch.core import normal_prior as fused

    h = crit._hess(x)
    hess, crit._hess = crit._hess, lambda _: h
    try:
        fused.reset_launches()
        got = crit.normal_op(x, crit.mu_spectro, crit.mu_reg)
        n = fused.launches
    finally:
        crit._hess = hess
    same = torch.equal(got, crit.mu_spectro * h + crit.mu_reg * crit._dtd(x))
    log(f"{tag} criterion normal_op on {list(x.shape)}: the fused normal bit for bit the eager "
        f"chain {same}, launches {n}")
    check(same and n == 1, f"{tag} fused normal vs the eager chain: bit for bit {same}, launches {n}")


DECONV_ARGV = {  # BASELINE configs 1 and 2 at the reference's full size
    "deconv2d": ["deconv2d", "-np", "301", "-ni", "200", "-hp", "500"],
    "deconv-cube": ["deconv-cube", "-np", "301", "-nl", "100", "--pointings", "2", "-ni", "100",
                    "-hp", "5"],
}
DECONV_KEYS = {"deconv2d": ["niter", "seconds", "psnr"],
               "deconv-cube": ["n_lambda", "niter", "seconds", "iters_per_s", "psnr"]}
CRIT_FALL = 1e-2  # J(x̂) / J(0.5): the reference's bar (tests/test_solvers.py::test_criterion_decreases)
DECONV_STEADY_IT = 50  # lcg iterations timed again after the CLI's run, its one-time set-up paid


def run_deconv_phase(dev, card: str, cuda_ms, gen, bound, proto, name: str) -> dict:
    """BASELINE config 1 (`deconv2d`) or 2 (`deconv-cube`) through
    the port's CLI at full size, `--rectangle` then `--rotated`: the
    report, iterations/s, the row-gather launches (none on the rectangle
    crop), the criterion's fall; on the model the CLI solved with: f32
    forward / adjoint against the same model in float64 on the card, the
    float64 dot test, kernels against plain gathers, launches and ms per
    normal, lcg s/iteration again once the run's one-time set-up is paid;
    `deconv-cube` also the stack forward against the 2-D forward on three
    planes.  Returns the launches and the kernel rows of #1 at this
    path's width (Q = 1 or Q = W) on the rotated pointing-0 plan."""
    import contextlib
    import io

    import numpy as np
    import torch

    from surfh_tpu_torch import cli as tcli
    from surfh_tpu_torch.core import gather_rows as gr
    from surfh_tpu_torch.core import normal_prior as fused
    from surfh_tpu_torch.models import blind2d
    from surfh_tpu_torch.solvers import criterion

    def sync():
        torch.cuda.synchronize(dev)

    def rel(a, b) -> float:
        return float((a - b).abs().max() / b.abs().max())

    tag = f"[{name}]"
    cube = name == "deconv-cube"
    crit_name = "QuadCriterion_MRS" if cube else "QuadCriterion_MRS_2D"
    crit_cls = getattr(criterion, crit_name)
    seen = {}

    class KeptCriterion(crit_cls):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            seen["crit"] = self

    res = {"launches": 0, "prior_launches": 0, "kernel": {}}
    for geometry in ("--rectangle", "--rotated"):
        rotated = geometry == "--rotated"
        argv = DECONV_ARGV[name] + [geometry]
        work = tempfile.mkdtemp(prefix="surfh_deconv_")
        setattr(criterion, crit_name, KeptCriterion)
        try:
            out = io.StringIO()
            gr.reset_launches()
            fused.reset_launches()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(out):
                rc = tcli.main(argv + ["-o", work])
            sync()
            wall = time.perf_counter() - t0
            launches, prior_launches = gr.launches, fused.launches
            lines = out.getvalue().strip().splitlines()
            check(rc == 0 and bool(lines), f"{name} {geometry}: exit code {rc}")
            rep = json.loads(lines[-1])
            x_hat = np.load(os.path.join(work, "deconv_cube_x.npy" if cube else "deconv2d_x.npy"))
        finally:
            setattr(criterion, crit_name, crit_cls)
            shutil.rmtree(work, ignore_errors=True)
        crit = seen.pop("crit")
        model = crit.model
        base = model.base if cube else model
        n_pt, n_it = len(base.pointings), rep["niter"]
        # y, the adjoint's one forward at a zero primal, b, then a normal
        # (forward and its transpose) per lcg application
        expect = 3 * n_pt + 2 * n_pt * (n_it + 1) if rotated else 0
        res["launches"] += launches
        res["prior_launches"] += prior_launches
        log(f"{tag} {' '.join(argv)}: {lines[-1]} ({wall:.2f} s with the model's build); "
            f"{n_it / rep['seconds']:.2f} iterations/s; {card}; gather_rows launches {launches} "
            f"(expected {expect}); fused normal launches {prior_launches} (expected {n_it + 1})")
        check(list(rep) == DECONV_KEYS[name] and n_it > 0 and np.isfinite(rep["psnr"]),
              f"{name} {geometry} report {rep}")
        check(launches == expect, f"{name} {geometry} launches {launches} != {expect}")
        check(prior_launches == n_it + 1, f"{name} {geometry} fused normal launches {prior_launches}")
        check(x_hat.shape == model.ishape and bool(np.isfinite(x_hat).all()), f"{name} x finite, shape")
        j0 = crit.get_crit_val(np.full(model.ishape, 0.5, np.float32))
        j1 = crit.get_crit_val(x_hat)
        log(f"{tag} {geometry}: criterion {j0:.6e} at x = 0.5 -> {j1:.6e} after {n_it} it "
            f"(ratio {j1 / j0:.3e}, bound {CRIT_FALL:g})")
        check(j1 < CRIT_FALL * j0, f"{name} {geometry}: the criterion fell to {j1 / j0:.3e}")

        # the same model in float64 on the card (the plain gather: #1 is f32)
        base64 = type(base)(base.sotf, base.alpha_axis, base.beta_axis, base.instr,
                            base.step_degree, base.pointings, dtype=np.float64, device=dev)
        m64 = blind2d.DeconvCube(base64, model.sotf_stack) if cube else base64
        xr = torch.rand(model.ishape, generator=gen, device=dev)
        yr = torch.rand(model.oshape, generator=gen, device=dev)
        f32, a32 = model.forward(xr), model.adjoint(yr)
        f64, a64 = m64.forward(xr.double(), plain=True), m64.adjoint(yr.double(), plain=True)
        e_f, e_a = rel(f32.double(), f64), rel(a32.double(), a64)
        lhs = float(torch.dot(f64, yr.double()))
        rhs = float(torch.dot(xr.double().reshape(-1), a64.reshape(-1)))
        dot = abs(lhs - rhs) / abs(lhs)
        n_k, n_p = model.normal(xr), model.normal(xr, plain=True)
        e_n = rel(n_k, n_p)
        check_prior_route(crit, xr, f"{tag} {geometry}:")
        log(f"{tag} {geometry}: card f32 vs card f64: forward {e_f:.3e}, adjoint {e_a:.3e} (bound "
            f"1e-5); f64 dot test <Hx,y>={lhs:.12e} <x,H'y>={rhs:.12e} rel {dot:.3e} (bound 1e-10); "
            f"normal, kernels vs plain gathers {e_n:.3e} (bound 1e-5)")
        check(e_f <= 1e-5 and e_a <= 1e-5, f"{name} {geometry}: f32 vs f64 {e_f:.3e} {e_a:.3e}")
        check(dot <= 1e-10, f"{name} {geometry}: f64 dot test {dot:.3e}")
        check(e_n <= 1e-5, f"{name} {geometry}: kernels vs plain {e_n:.3e}")
        del base64, m64, f64, a64
        if cube:
            full = model.forward_fn(xr)
            W = model.n_lambda
            e_s = max(rel(base._forward_fn(xr[w], model._stack_t[w]), full[w]) for w in (0, W // 2, W - 1))
            log(f"{tag} {geometry}: the stack forward vs the 2-D forward on planes 0, {W // 2}, {W - 1}: "
                f"max rel {e_s:.3e} (bound 1e-5)")
            check(e_s <= 1e-5, f"{name} {geometry}: stack vs 2-D forward {e_s:.3e}")
        gr.reset_launches()
        model.normal(xr)
        sync()
        per_normal = gr.launches
        check(per_normal == (2 * n_pt if rotated else 0), f"{name} {geometry}: {per_normal} launches per normal")
        ms_f = cuda_ms(lambda: model.forward(xr), REPS)
        ms_a = cuda_ms(lambda: model.adjoint(yr), REPS)
        ms_n = cuda_ms(lambda: model.normal(xr), REPS)
        t0 = time.perf_counter()
        again = crit.run_method("lcg", maximum_iterations=DECONV_STEADY_IT)
        sync()
        s_it = (time.perf_counter() - t0) / again.n_iter
        log(f"{tag} {card}: {geometry}: forward {ms_f:.3f} ms, derived adjoint {ms_a:.3f} ms, normal "
            f"{ms_n:.3f} ms; gather_rows launches per normal {per_normal}; CG {rep['seconds'] / n_it:.4f} "
            f"s/iteration in the CLI's run (its set-up included), {s_it:.4f} s/iteration over "
            f"{again.n_iter} more on its criterion (host clock)")
        res[geometry] = {"ms_normal": ms_n, "s_per_it": s_it, "psnr": rep["psnr"],
                         "launches": launches, "per_normal": per_normal}
        if rotated:
            q = model.n_lambda if cube else 1
            for direction, plan in (("forward", base.row_plans[0]), ("transpose", base.row_plans[0].t)):
                res["kernel"][direction] = gather_row_stats(
                    dev, proto, cuda_ms, gen, bound, plan, q,
                    f"{name} --rotated pointing-0 {direction} gather at Q = {q}", 1e-5)
        del crit, model, base, xr, yr
        torch.cuda.empty_cache()
    return res


NN_NITER = 20


def run_nn_phase(dev, card: str, cuda_ms, gen, bound, proto, channels, wsetup, truth, mu_reg) -> dict:
    """The flagship with nearest-neighbour gridding (the reference's
    `MCMO_SigRLSCT_NN`) in the W-plane banded mode at full width, over the
    rank model's bands regridded (their spectral tables shared) and the
    W-plane setup's OTF: the normal through the kernels against the plain
    versions, the forward against the plain-gather version, launches and
    ms per normal, the main path (y, b, 20 lcg iterations) counted; #1 on
    the biggest band's pointing-0 NN plans at Q = W."""
    import numpy as np
    import torch

    from surfh_tpu_torch.core import gather_rows as gr
    from surfh_tpu_torch.core import wblur_banded as wb
    from surfh_tpu_torch.models.spectro import SpectroSigRLSCT
    from surfh_tpu_torch.solvers.criterion import QuadCriterion_MRS

    def sync():
        torch.cuda.synchronize(dev)

    def rel(a, b) -> float:
        return float((a - b).abs().max() / b.abs().max())

    t0 = time.perf_counter()
    chans = [c.regrid("nn") for c in channels]
    s = wsetup
    nmodel = SpectroSigRLSCT(s["sotf"], s["templates"], s["alpha_axis"], s["beta_axis"],
                             s["wavelength_axis"], s["instrs"], s["step_degree"], s["pointings"],
                             dtype=np.float32, gridding="nn", wblur_impl="banded",
                             wblur_band_rtol=BAND_RTOL, window_local=False, channels=chans)
    t_host = time.perf_counter() - t0
    t0 = time.perf_counter()
    nmodel.to(dev, torch.float32)
    sync()
    n_pt = sum(c.oshape[0] for c in nmodel.channels)
    log(f"[nn] the NN-gridding W-plane model ({len(chans)} bands, banded blur at rtol {BAND_RTOL:g}, "
        f"the W-plane setup's OTF): host {t_host:.2f} s (NN plans and composed plans; wpsf and band "
        f"plans shared), upload {time.perf_counter() - t0:.2f} s")
    y = nmodel.forward(truth)
    y_p = nmodel.forward(truth, plain=True)
    n_k, n_p = nmodel.normal(truth), nmodel.normal(truth, plain=True)
    sync()
    e_y, e_n = rel(y, y_p), rel(n_k, n_p)
    log(f"[nn] forward vs the plain-gather version: max rel {e_y:.3e}; normal, kernels vs plain "
        f"versions: {e_n:.3e} (bound 1e-5)")
    check(bool(torch.isfinite(y).all()) and e_y <= 1e-5 and e_n <= 1e-5, "NN model vs plain versions")
    del y_p, n_k, n_p
    gr.reset_launches()
    wb.reset_launches()
    nmodel.normal(truth)
    sync()
    per_app = (gr.launches, wb.launches, wb.launches_t)
    check(per_app == (2 * n_pt, n_pt, n_pt), f"NN launches per normal {per_app}")
    ms_n = cuda_ms(lambda: nmodel.normal(truth), REPS)
    log(f"[nn] {card}: normal {ms_n:.3f} ms/app; launches per normal gather_rows / wblur_banded / "
        f"wblur_banded_t {per_app} (expected {2 * n_pt}, {n_pt}, {n_pt})")
    gr.reset_launches()
    t0 = time.perf_counter()
    y = nmodel.forward(truth)
    crit = QuadCriterion_MRS(1.0, y, nmodel, mu_reg)
    res = crit.run_method("lcg", maximum_iterations=NN_NITER)
    sync()
    t_main = time.perf_counter() - t0
    launches = gr.launches
    expect = 2 * n_pt + 2 * n_pt * (res.n_iter + 1)
    gn = res.grad_norm
    log(f"[nn] main path (y, b, {res.n_iter} lcg it, mu_reg={mu_reg:g}) in {t_main:.3f} s "
        f"({t_main / res.n_iter:.4f} s/iteration, host clock); gather_rows launches {launches} "
        f"(expected {expect}); grad norm {gn[0]:.4e} -> {gn[-1]:.4e}")
    check(launches == expect and res.n_iter == NN_NITER, "NN main-path launches")
    check(bool(torch.isfinite(res.x).all()) and bool(np.isfinite(gn).all()) and gn[-1] < gn[0],
          "NN grad norms finite, falling")
    c_big = max(range(len(chans)), key=lambda c: nmodel.tables["chan"][c]["gather_fwd"][0].nnz)
    t = nmodel.tables["chan"][c_big]
    w_q = nmodel.channels[c_big].n_wslice
    kern = {d: gather_row_stats(dev, proto, cuda_ms, gen, bound, t[k][0], w_q,
                                f"NN {nmodel.channels[c_big].instr.name} pointing-0 {d} at Q = W", 1e-5)
            for d, k in (("forward", "gather_fwd"), ("transpose", "gather_t"))}
    del nmodel, crit, res, y
    torch.cuda.empty_cache()
    return {"launches": launches, "ms_normal": ms_n, "s_per_it": t_main / NN_NITER, "kernel": kern}


def run_staged_phase(dev, card: str, cuda_ms, gen, bound, proto, chan) -> dict:
    """One band's channel three ways on the card in f32: composed, staged
    (SURFH_COMPOSED_GRIDDING=0: the gather onto the local grid and the direct
    box-sum) and the FFT box-sum (the staged channel with no box offset):
    forward and adjoint against the composed one, launches and ms per
    direction; #1 on the staged pointing-0 plans at Q = W."""
    import torch

    from surfh_tpu_torch.core import gather_rows as gr

    def sync():
        torch.cuda.synchronize(dev)

    def rel(a, b) -> float:
        return float((a - b).abs().max() / b.abs().max())

    saved = os.environ.get("SURFH_COMPOSED_GRIDDING")
    try:
        os.environ["SURFH_COMPOSED_GRIDDING"] = "1"
        composed = chan.regrid(chan.gridding)
        os.environ["SURFH_COMPOSED_GRIDDING"] = "0"
        staged = chan.regrid(chan.gridding)
        fftbox = chan.regrid(chan.gridding)
    finally:
        if saved is None:
            os.environ.pop("SURFH_COMPOSED_GRIDDING", None)
        else:
            os.environ["SURFH_COMPOSED_GRIDDING"] = saved
    fftbox.box_offset = None
    check(not composed.staged and staged.staged and staged.box_offset is not None,
          "staged channel construction")
    W = chan.n_wslice
    xw = torch.rand((W,) + chan.imshape, generator=gen, device=dev)
    y = torch.rand(chan.oshape, generator=gen, device=dev)
    outs, res = {}, {"launches": 0}
    for what, c in (("composed", composed), ("staged", staged), ("fft box-sum", fftbox)):
        c.to(dev, torch.float32)
        rows = c.bbox_rows(xw)
        gr.reset_launches()
        hx, hty = c.forward_rows(rows, c.tables), c.adjoint_windowed(y)
        sync()
        launches = gr.launches
        ms_f = cuda_ms(lambda: c.forward_rows(rows, c.tables), REPS)
        ms_a = cuda_ms(lambda: c.adjoint_windowed(y), REPS)
        outs[what] = (hx, hty)
        if what != "composed":
            res["launches"] += launches
        log(f"[staged] {card}: band {chan.instr.name} {what}: forward {ms_f:.3f} ms, adjoint {ms_a:.3f} ms; "
            f"gather_rows launches per forward + adjoint {launches} (expected {2 * chan.oshape[0]})")
        check(launches == 2 * chan.oshape[0], f"staged {what} launches")
        res[what] = {"ms_forward": ms_f, "ms_adjoint": ms_a}
    for what in ("staged", "fft box-sum"):
        e_f = rel(outs[what][0], outs["composed"][0])
        e_a = rel(outs[what][1], outs["composed"][1])
        log(f"[staged] {what} vs composed: forward {e_f:.3e}, adjoint {e_a:.3e} (bound 1e-5, f32)")
        check(e_f <= 1e-5 and e_a <= 1e-5, f"{what} vs composed: {e_f:.3e} {e_a:.3e}")
    t = staged.tables
    res["kernel"] = {d: gather_row_stats(dev, proto, cuda_ms, gen, bound, t[k][0], W,
                                         f"staged {chan.instr.name} pointing-0 {d} at Q = W", 1e-5)
                     for d, k in (("forward", "gather_fwd"), ("transpose", "gather_t"))}
    del composed, staged, fftbox, outs, xw, y
    torch.cuda.empty_cache()
    return res


CHANNEL_BANDED_BAND = "2c"  # [channel-banded]'s band: PERF.md's shape for #2 at BAND_RTOL


def run_channel_banded_phase(dev, card: str, cuda_ms, gen, model) -> dict:
    """`Channel(..., wblur_impl="banded", wblur_band_rtol=BAND_RTOL)` on cubes
    at full width (band 2c of the flagship setup, its 4 pointings, the whole
    λ axis, f32), built with the reference's constructor arguments: its
    forward through #2 against its plain version, against the same band
    built dense in this process, the adjoint bit for bit the dense
    channel's, the dense pair's dot test, #2's launches per forward
    and none of #3 per adjoint, ms per direction."""
    import numpy as np
    import torch

    from surfh_tpu_torch.core import gather_rows as gr
    from surfh_tpu_torch.core import wblur_banded as wb
    from surfh_tpu_torch.instrument.geometry import CoordList
    from surfh_tpu_torch.models.channel import Channel

    def sync():
        torch.cuda.synchronize(dev)

    def rel(a, b) -> float:
        return float((a - b).abs().max() / b.abs().max())

    c = next((i for i, ch in enumerate(model.channels)
              if ch.instr.name.lower().startswith(CHANNEL_BANDED_BAND)), 0)
    args = (model.instrs[c], model.alpha_axis, model.beta_axis, model.wavelength_axis, model.srfs[c],
            CoordList(model.pointings[c]), model.step_degree, np.float32, "bilinear")
    t0 = time.perf_counter()
    chan = Channel(*args, "banded", BAND_RTOL)  # the reference's positional order
    chan.to(dev, torch.float32)
    sync()
    t_host = time.perf_counter() - t0
    dense = Channel(*args).to(dev, torch.float32)
    P, S, K, A = chan.oshape
    plan = chan.band_plan()
    log(f"[channel-banded] band {chan.instr.name}: Channel(..., 'bilinear', 'banded', {BAND_RTOL:g}) "
        f"built and uploaded in {t_host:.2f} s (wpsf, plans, band tables); #2 on "
        f"[{S * A} x {plan.B * plan.W}] -> [{S * A} x {K}], LB = {plan.LB} of W = {plan.W}, "
        f"{P} pointings; pointing_scan {chan.pointing_scan}, slit_unroll {chan.slit_unroll}")
    cube = torch.rand(chan.ishape, generator=gen, device=dev)
    y = torch.rand(chan.oshape, generator=gen, device=dev)

    gr.reset_launches()
    wb.reset_launches()
    hx = chan.forward(cube)
    sync()
    launches = (gr.launches, wb.launches, wb.launches_t, wb.launches_sum)
    log(f"[channel-banded] launches per forward: gather_rows {launches[0]}, wblur_banded "
        f"{launches[1]}, wblur_banded_t {launches[2]} (expected {P}, {P}, 0); add-the-parts passes "
        f"{launches[3]}")
    check(launches[:3] == (P, P, 0), "channel-banded launches per forward")
    check(tuple(hx.shape) == chan.oshape and bool(torch.isfinite(hx).all()),
          "channel-banded forward finite, shape")
    hx_p = chan.forward(cube, plain=True)
    hx_d = dense.forward(cube)
    e_plain, e_dense = rel(hx, hx_p), rel(hx, hx_d)
    log(f"[channel-banded] forward through #2 vs plain=True: max rel {e_plain:.3e} (bound 1e-5); "
        f"banded vs the band built dense: max rel {e_dense:.3e} (bound 5e-2, [wplane]'s: the "
        f"truncated response mass)")
    check(e_plain <= 1e-5, f"channel-banded forward vs plain: {e_plain:.3e}")
    check(e_dense <= 5e-2, f"channel-banded vs dense forward: {e_dense:.3e}")

    gr.reset_launches()
    wb.reset_launches()
    hty = chan.adjoint(y)
    sync()
    adj_launches = (gr.launches, wb.launches, wb.launches_t)
    same = torch.equal(hty, dense.adjoint(y))
    log(f"[channel-banded] adjoint: launches gather_rows / wblur_banded / wblur_banded_t "
        f"{adj_launches} (expected ({P}, 0, 0): the dense transpose), bit for bit the dense "
        f"channel's {same}")
    check(adj_launches == (P, 0, 0), "channel-banded adjoint launches")
    check(same, "channel-banded adjoint vs the dense channel's")

    lhs = float(torch.dot(hx_d.reshape(-1).double(), y.reshape(-1).double()))
    rhs = float(torch.dot(cube.reshape(-1).double(), hty.reshape(-1).double()))
    d_rel = abs(lhs - rhs) / abs(lhs)
    b_lhs = float(torch.dot(hx.reshape(-1).double(), y.reshape(-1).double()))
    log(f"[channel-banded] dense pair dot test (f64 sums): <Hx,y>={lhs:.9e} <x,H'y>={rhs:.9e} "
        f"rel {d_rel:.3e} (bound 1e-5); the banded forward against the dense adjoint "
        f"(not a transpose pair at rtol > 0): rel {abs(b_lhs - rhs) / abs(b_lhs):.3e}")
    check(d_rel <= 1e-5, "channel-banded dense pair dot test")

    ms_f = cuda_ms(lambda: chan.forward(cube), REPS)
    ms_fd = cuda_ms(lambda: dense.forward(cube), REPS)
    ms_a = cuda_ms(lambda: chan.adjoint(y), REPS)
    log(f"[channel-banded] {card}: band {chan.instr.name} forward {ms_f:.3f} ms (banded), "
        f"{ms_fd:.3f} ms (dense), adjoint {ms_a:.3f} ms")
    res = {"launches": launches, "ms_forward": ms_f, "ms_forward_dense": ms_fd, "ms_adjoint": ms_a,
           "err_plain": e_plain, "err_dense": e_dense}
    del chan, dense, cube, y, hx, hx_p, hx_d, hty
    torch.cuda.empty_cache()
    return res


FAMILY_BAND = "1c"  # the band of the family and mixing phases: its flagship setup, nothing cut
# row gathers in one forward of each operator of the family on that setup (4 pointings)
FAMILY_GATHERS = {"T": 0, "C": 0, "CT": 0, "R": 0, "MO_ST": 4, "SigRLSCT": 1, "SigRLSCT_NN": 1,
                  "MO_SigRLSCT": 4, "MO_SigRLSCT_shiftConv": 1, "MCMO_SigRLSCT": 4,
                  "MCMO_SigRLSCT_NN": 4}
FAMILY_SOLVE_ARGV = ["--op", "SigRLSCT", "--flagship-band", FAMILY_BAND, "--solve"]


def load_script(name: str):
    """A script of scripts/ as a module (they are not a package)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        name, os.path.join(os.path.dirname(os.path.abspath(__file__)), "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_family_phase(dev, card: str, cuda_ms, gen, bound, proto, model) -> dict:
    """The single-stage operator family at the band's full flagship width
    (501², 4 pointings, the band's whole λ axis, its OTF built on the card),
    f32, every operator of `torch_operator_demo.OPS`: shapes, an
    f64-accumulated dot test, the forward against the same operator in
    float64 on the card (plain gather), ms per forward and per derived
    adjoint, #1 launches per forward and per normal; #1 at the family's
    cube-gather shape (Q = L) both ways; then the entry point as a user runs
    it (`torch_operator_demo.py --op SigRLSCT --flagship-band 1c --solve`),
    counted; and the rank flagship's `adjoint_auto` (the derived transpose
    through `GatherRows`) against its hand-written adjoint."""
    import torch

    from surfh_tpu_torch.core import gather_rows as gr
    from surfh_tpu_torch.simulation.flagship import make_flagship_setup

    def sync():
        torch.cuda.synchronize(dev)

    def rel(a, b) -> float:
        return float((a - b).abs().max() / b.abs().max())

    demo = load_script("torch_operator_demo")
    t0 = time.perf_counter()
    fx = make_flagship_setup(bands=[FAMILY_BAND], build_sotf=True, device=dev)
    sync()
    L, sotf = len(fx["wavelength_axis"]), fx["sotf"]
    log(f"[family] band {FAMILY_BAND} flagship setup in {time.perf_counter() - t0:.2f} s: "
        f"{fx['im_shape'][0]}² at 0.025\", {len(fx['pointings'][0])} pointings, M = "
        f"{fx['templates'].shape[0]}, L = {L}, lambda_det = {len(fx['instrs'][0].wavel_axis)}; "
        f"sotf {tuple(sotf.shape)} {sotf.dtype} on the card, "
        f"{sotf.numel() * sotf.element_size() / 2**30:.3f} GiB (read by C, CT, SCT, SigRLCT and "
        f"the channel operators)")
    tol_dot, tol_f64 = 1e-5, 1e-5
    res = {"ops": {}}
    for name in demo.OPS:
        t0 = time.perf_counter()
        op = demo.build(name, fx, torch.float32, dev)
        op64 = demo.build(name, fx, torch.float64, dev)
        sync()
        t_build = time.perf_counter() - t0
        x = torch.rand(op.ishape, generator=gen, device=dev)
        y = torch.rand(op.oshape, generator=gen, device=dev)
        gr.reset_launches()
        hx = op.forward(x)
        sync()
        n_fwd = gr.launches
        hty = op.adjoint(y)  # the first call derives the transpose (a forward at a zero primal)
        e64 = rel(hx.double(), op64.forward(x.double(), plain=True))
        lhs = float(torch.dot(hx.double().reshape(-1), y.double().reshape(-1)))
        rhs = float(torch.dot(x.double().reshape(-1), hty.double().reshape(-1)))
        d_rel = abs(lhs - rhs) / abs(lhs)
        gr.reset_launches()
        op.normal(x)
        sync()
        n_normal = gr.launches
        ms_f = cuda_ms(lambda: op.forward(x), REPS)
        ms_a = cuda_ms(lambda: op.adjoint(y), REPS)
        want = FAMILY_GATHERS.get(name, 1)
        extra = ""
        if name == "R":
            extra = f"; full-image wpsf {tuple(op._wpsf.shape)} f32 {op._wpsf.numel() * 4 / 2**30:.3f} GiB"
        log(f"[family] {card}: {name}: {tuple(op.ishape)} -> {tuple(op.oshape)}, L = {L}; built in "
            f"{t_build:.2f} s (f32 and f64); dot test (f64 sums) rel {d_rel:.3e} (bound {tol_dot:g}); "
            f"forward vs float64 on the card {e64:.3e} (bound {tol_f64:g}); forward {ms_f:.3f} ms, "
            f"derived adjoint {ms_a:.3f} ms; #1 launches per forward {n_fwd} (expected {want}), per "
            f"normal {n_normal} (expected {2 * want}){extra}")
        check(bool(torch.isfinite(hx).all()) and bool(torch.isfinite(hty).all()), f"family {name} finite")
        check(d_rel <= tol_dot and e64 <= tol_f64, f"family {name}: dot {d_rel:.3e}, f64 {e64:.3e}")
        check(n_fwd == want and n_normal == 2 * want, f"family {name} launches {n_fwd}, {n_normal}")
        res["ops"][name] = {"ms_forward": ms_f, "ms_adjoint": ms_a, "launches_normal": n_normal}
        if name == "ST":  # #1 at the family's cube-gather shape: [Na·Nb, L] rows, both ways
            res["kernel"] = {d: gather_row_stats(dev, proto, cuda_ms, gen, bound, p, L,
                                                 f"family ST {d} at Q = L", 1e-5)
                             for d, p in (("forward", op._plan), ("transpose", op._plan.t))}
        del op, op64, x, y, hx, hty
        torch.cuda.empty_cache()
    del fx, sotf
    torch.cuda.empty_cache()

    # the entry point as a user runs it, counted
    gr.reset_launches()
    t0 = time.perf_counter()
    rep = demo.run(FAMILY_SOLVE_ARGV)
    sync()
    res["launches"] = gr.launches
    log(f"[family] torch_operator_demo.py {' '.join(FAMILY_SOLVE_ARGV)}: {json.dumps(rep)} in "
        f"{time.perf_counter() - t0:.2f} s (setup included); gather_rows launches {res['launches']}")
    check(rep["dottest"] and 0.0 < rep["solve_grad_drop"] < 1.0 and res["launches"] > 0,
          "operator demo entry point")

    # the rank flagship's derived transpose through GatherRows
    y = torch.rand(model.oshape, generator=gen, device=dev)
    want = model.adjoint(y)
    got = model.adjoint_auto(y)  # the first call: a forward at a zero primal, then the transpose
    sync()
    gr.reset_launches()
    got = model.adjoint_auto(y)
    sync()
    n_auto = gr.launches
    e_auto = rel(got, want)
    ms_auto = cuda_ms(lambda: model.adjoint_auto(y), REPS)
    ms_adj = cuda_ms(lambda: model.adjoint(y), REPS)
    n_pt = sum(c.oshape[0] for c in model.channels)
    log(f"[family] {card}: rank flagship ({len(model.channels)} bands) adjoint_auto vs the hand-written "
        f"adjoint: max rel {e_auto:.3e} (bound 1e-5); #1 launches per adjoint_auto {n_auto} "
        f"(expected {n_pt}); adjoint_auto {ms_auto:.3f} ms, adjoint {ms_adj:.3f} ms; peak "
        f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")
    check(e_auto <= 1e-5 and n_auto == n_pt and bool(torch.isfinite(got).all()),
          f"adjoint_auto vs adjoint {e_auto:.3e}, launches {n_auto}")
    model._auto_vjp = None  # drop the kept transpose's graph
    del y, want, got
    torch.cuda.empty_cache()
    return res


MIXING_MU = 1e-4  # the reference suite's expsol weight (tests/test_mixing.py)
MIXING_NITER = 20
MIXING_LCG_TOL = 1e-3  # lcg with and without use_fwadj: two f32 spellings of HᵗH, 20 CG iterations
HUBER_REG, HUBER_TH = 1e-3, 0.1  # the reference suite's lmm_reconstruction weights


def run_mixing_phase(dev, card: str, cuda_ms, gen) -> dict:
    """`Model_WCT` at the band's full flagship width (501², the flagship's M
    = 4 templates as spectra, the band's λ planes, its 40 × 40 PSF stamps,
    di = dj = 1), f32 on the card: the build, `fwadj` against
    adjoint∘forward, the dot test, `run_expsol` against the normal
    equations (residual in float64 on the card), 20 lcg iterations with
    `use_fwadj` against 20 without, 20 iterations of `lmm_reconstruction`
    with its criterion falling; seconds for the build, the closed-form
    solve and an iteration.  The path runs no kernel of this repository
    (FFTs, einsums and batched inverses): its launch counts are read and
    logged."""
    import numpy as np
    import torch

    from surfh_tpu_torch.core import gather_rows as gr
    from surfh_tpu_torch.core import gather_fixed as gf
    from surfh_tpu_torch.core import wblur_banded as wb
    from surfh_tpu_torch.models.mixing import Model_WCT
    from surfh_tpu_torch.simulation.flagship import make_flagship_setup
    from surfh_tpu_torch.solvers.criterion import QuadCriterion_MRS, dtd_separated
    from surfh_tpu_torch.solvers.expsol import QuadCriterion3
    from surfh_tpu_torch.solvers.huber import diff_axis, huber_value, lmm_reconstruction

    def sync():
        torch.cuda.synchronize(dev)

    def rel(a, b) -> float:
        return float((a - b).abs().max() / b.abs().max())

    fx = make_flagship_setup(bands=[FAMILY_BAND])
    psfs, tpl = fx["psf_stack"], fx["templates"]
    shape = fx["im_shape"]
    for counter in (gr, wb, gf):
        counter.reset_launches()
    t0 = time.perf_counter()
    model = Model_WCT(psfs, tpl, shape, dtype=torch.float32, device=dev)
    sync()
    t_build = time.perf_counter() - t0
    log(f"[mixing] {card}: Model_WCT {tuple(model.ishape)} -> {tuple(model.oshape)} (PSF stamps "
        f"{psfs.shape}, di = dj = 1) built on the card in {t_build:.2f} s (transfer functions "
        f"{tuple(model._g.shape)}, block Hessian {tuple(model.hess_spec_freq.shape)} complex128); "
        f"{torch.cuda.memory_allocated(dev) / 2**30:.2f} GiB on the card")
    maps = torch.as_tensor(fx["maps"], dtype=torch.float32, device=dev)
    y = model.forward(maps)
    e_fw = rel(model.fwadj(maps), model.adjoint(y))
    xr = torch.rand(model.ishape, generator=gen, device=dev)
    yr = torch.rand(model.oshape, generator=gen, device=dev)
    lhs = float(torch.dot(model.forward(xr).double().reshape(-1), yr.double().reshape(-1)))
    rhs = float(torch.dot(xr.double().reshape(-1), model.adjoint(yr).double().reshape(-1)))
    d_rel = abs(lhs - rhs) / abs(lhs)
    ms_f = cuda_ms(lambda: model.forward(maps), REPS)
    ms_a = cuda_ms(lambda: model.adjoint(y), REPS)
    ms_h = cuda_ms(lambda: model.fwadj(maps), REPS)
    log(f"[mixing] {card}: fwadj vs adjoint∘forward max rel {e_fw:.3e} (bound 1e-5); dot test (f64 "
        f"sums) rel {d_rel:.3e} (bound 1e-5); forward {ms_f:.3f} ms, derived adjoint {ms_a:.3f} ms, "
        f"fwadj (block Hessian) {ms_h:.3f} ms")
    check(e_fw <= 1e-5 and d_rel <= 1e-5 and bool(torch.isfinite(y).all()), "Model_WCT fwadj, dot test")

    t0 = time.perf_counter()
    x_hat = QuadCriterion3(y, model, MIXING_MU).run_expsol()
    sync()
    t_exp = time.perf_counter() - t0
    m64 = Model_WCT(psfs, tpl, shape, dtype=torch.float64, device=dev)
    x64, y64 = x_hat.double(), y.double()
    b64 = m64.adjoint(y64)
    e_ne = rel(m64.fwadj(x64) + MIXING_MU * dtd_separated(x64), b64)
    del m64, x64, y64, b64
    torch.cuda.empty_cache()
    log(f"[mixing] {card}: run_expsol (mu {MIXING_MU:g}, separated prior) in {t_exp:.3f} s (the "
        f"regularized Hessian's {shape[0] * shape[1]} 4x4 blocks inverted in complex128 on the card); "
        f"normal equations' residual in float64 {e_ne:.3e} of H'y (the reference's bar 1e-5)")
    check(bool(torch.isfinite(x_hat).all()) and e_ne <= 1e-5, f"expsol normal equations {e_ne:.3e}")

    crit = dict(mu_spectro=1.0, y_spectro=y, model_spectro=model, mu_reg=MIXING_MU)
    t0 = time.perf_counter()
    a = QuadCriterion_MRS(**crit, use_fwadj=True).run_method("lcg", MIXING_NITER)
    sync()
    s_it = (time.perf_counter() - t0) / MIXING_NITER
    b = QuadCriterion_MRS(**crit).run_method("lcg", MIXING_NITER)
    sync()
    e_lcg = rel(a.x, b.x)
    log(f"[mixing] {card}: lcg {MIXING_NITER} it with use_fwadj {s_it:.4f} s/iteration (host clock); "
        f"iterate vs {MIXING_NITER} it through adjoint∘forward max rel {e_lcg:.3e} (bound "
        f"{MIXING_LCG_TOL:g}); grad norm {a.grad_norm[0]:.4e} -> {a.grad_norm[-1]:.4e}")
    check(e_lcg <= MIXING_LCG_TOL and a.grad_norm[-1] < a.grad_norm[0], f"use_fwadj lcg {e_lcg:.3e}")

    def huber_crit(x):
        data = 0.5 * float(((model.forward(x) - y).double() ** 2).sum())
        return data + HUBER_REG * sum(float(huber_value(diff_axis(x, ax), HUBER_TH).double().sum())
                                      for ax in (1, 2))

    x0 = model.adjoint(y)
    t0 = time.perf_counter()
    h = lmm_reconstruction(y, model, spat_reg=HUBER_REG, spat_th=HUBER_TH, init=x0,
                           max_iter=MIXING_NITER)
    sync()
    s_hit = (time.perf_counter() - t0) / MIXING_NITER
    j0, j1 = huber_crit(x0), huber_crit(h.x)
    counts = (gr.launches, wb.launches, wb.launches_t, gf.launches_k1, gf.launches_k2, gf.launches_k3)
    log(f"[mixing] {card}: lmm_reconstruction {MIXING_NITER} it {s_hit:.4f} s/iteration (host clock); "
        f"criterion {j0:.6e} -> {j1:.6e}, grad norm {h.grad_norm[0]:.4e} -> {h.grad_norm[-1]:.4e}; "
        f"this repository's kernels launched on the mixing path (gather_rows, wblur_banded, "
        f"wblur_banded_t, K1, K2, K3): {counts}; peak {torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")
    check(j1 < j0 and bool(np.isfinite(h.grad_norm).all()) and h.grad_norm[-1] < h.grad_norm[0],
          "lmm_reconstruction criterion falling")
    del model, maps, y, x_hat, a, b, h, x0, xr, yr
    torch.cuda.empty_cache()
    return {"s_build": t_build, "s_expsol": t_exp, "s_lcg_it": s_it, "s_huber_it": s_hit}


SHARDED_NITER = 10  # solve iterations of the sharded phases (as [slice]'s lcg)
TOL_SHARD = 1e-5  # f32: another sum order (a window's FFT conv, a gloo reduction) than the reference's
TOL_DOT64 = 1e-12  # a float64 transpose pair (the reference's operator bar)


def lambda_bands(model, lam_band: str, world: int) -> list:
    """Band `lam_band`'s channel index, then that of the band whose λ window
    the first rank's block boundary (ceil(L / world)) cuts, where another."""
    lp = -(-model.cube_shape[0] // world)
    out = [next(c for c, ch in enumerate(model.channels) if ch.instr.name.lower().startswith(lam_band))]
    cut = next((c for c, ch in enumerate(model.channels) if ch.wslice.start < lp < ch.wslice.stop), None)
    return out + ([cut] if cut is not None and cut not in out else [])


def lambda_dot_test(chan, dev, seed: int, mesh) -> float:
    """The λ-sharded pair's dot test in float64 (the plain gathers: kernel #1
    is f32), summed over the ranks of `mesh`; leaves the channel in
    float32."""
    import torch
    import torch.distributed as dist

    from surfh_tpu_torch.parallel import LambdaShardedChannel

    chan.to(dev, torch.float64)
    try:
        # an axis that ends past the window by as many planes as precede it,
        # so that two ranks split the window in its middle
        L = chan.wslice.start + chan.wslice.stop
        lam = LambdaShardedChannel(chan, L, mesh)
        g = torch.Generator(device=dev).manual_seed(seed + 1)
        y = torch.rand(chan.oshape, generator=g, device=dev, dtype=torch.float64)  # the same on every rank
        g.manual_seed(seed + 2 + lam.rank)  # each rank's own block of the cube
        shard = torch.rand((lam.Lp,) + chan.imshape, generator=g, device=dev, dtype=torch.float64)
        lhs = float(torch.dot(lam.forward(shard, plain=True).reshape(-1), y.reshape(-1)))
        part = torch.dot(shard.reshape(-1), lam.adjoint(y, plain=True).reshape(-1)).reshape(1)
        dist.all_reduce(part, group=lam.group)
        return abs(lhs - float(part)) / abs(lhs)
    finally:
        chan.to(dev, torch.float32)


def sharded_rank_worker(rank: int, world: int, bands, cache_dir: str, mu_reg: float, lam_band: str,
                        seed: int) -> dict:
    """One of two processes on the one card over gloo (spawned by
    `parallel.fusion.spawn_world`): the rank flagship from the table cache
    that [host] filled, `ShardedSpectro(shard_tables=True)` (its normal, its
    table bytes, SHARDED_NITER solve iterations), the λ-sharded band
    `lam_band` at world 2, and `ShardedSpectro2D` on the meshes (2, 1) and
    (1, 2).  Returns host arrays and numbers for the parent's checks."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from surfh_tpu_torch.core import gather_rows as gr
    from surfh_tpu_torch.parallel import (LambdaShardedChannel, ShardedSpectro, ShardedSpectro2D,
                                          make_mesh, make_mesh_2d)
    from surfh_tpu_torch.simulation.flagship import make_flagship_model, make_flagship_setup

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    os.environ["SURFH_TABLE_CACHE"] = cache_dir
    out = {"backend": dist.get_backend()}
    t0 = time.perf_counter()
    setup = make_flagship_setup(bands=bands)
    own, _ = make_flagship_model(setup, dtype=np.float32)
    out["cache_hit"] = own.table_cache_hit
    sh = ShardedSpectro(own, make_mesh(device_type="cuda"), shard_tables=True)
    torch.cuda.synchronize(dev)
    out["t_setup_s"] = time.perf_counter() - t0
    out["mine"], out["bytes"] = sh.mine, sh.table_hbm_bytes()
    out["mem_gib"] = torch.cuda.memory_allocated(dev) / 2**30
    truth = torch.as_tensor(setup["maps"], dtype=torch.float32, device=dev)
    gr.reset_launches()
    out["normal"] = sh.normal(truth).cpu().numpy()
    torch.cuda.synchronize(dev)
    out["normal_launches"] = gr.launches
    t0 = time.perf_counter()
    for _ in range(3):
        sh.normal(truth)
    torch.cuda.synchronize(dev)
    out["normal_ms_host"] = (time.perf_counter() - t0) / 3 * 1e3
    acc = torch.zeros(own.ishape, device=dev)
    t0 = time.perf_counter()
    for _ in range(5):
        dist.all_reduce(acc, group=sh.group)
    torch.cuda.synchronize(dev)
    out["all_reduce_ms_host"] = (time.perf_counter() - t0) / 5 * 1e3
    y = sh.unpack(sh.gather_packed(sh.forward(truth)))  # the data, from the owners' blocks
    gr.reset_launches()
    res = sh.solve(y, mu_reg=mu_reg, max_iter=SHARDED_NITER, tol=0.0)
    torch.cuda.synchronize(dev)
    out["solve_launches"] = gr.launches
    out["x"], out["grad_norm"] = res.x.cpu().numpy(), res.grad_norm
    del sh, own

    # λ-sharded at world 2: band `lam_band`, and the band whose window the
    # two ranks' blocks split
    full, _ = make_flagship_model(setup, dtype=np.float32)
    L = full.cube_shape[0]
    lam_mesh = make_mesh(axis_name="lam", device_type="cuda")
    out["lam"] = {}
    for c in lambda_bands(full, lam_band, 2):
        chan = full.channels[c].to(dev, torch.float32)
        lam = LambdaShardedChannel(chan, L, lam_mesh)
        g = torch.Generator(device=dev).manual_seed(seed)
        cube = torch.rand(full.cube_shape, generator=g, device=dev)
        yc = torch.rand(chan.oshape, generator=g, device=dev)
        shard = lam.shard_cube(cube)
        gr.reset_launches()
        fwd = lam.forward(shard)
        lam.adjoint(yc)
        torch.cuda.synchronize(dev)
        q = {"launches": gr.launches, "span": lam.span, "P": chan.oshape[0]}
        want = chan.forward(cube)
        q["err"] = float((fwd - want).abs().max() / want.abs().max())
        del cube, shard, fwd, want, lam
        q["dot"] = lambda_dot_test(chan, dev, seed, lam_mesh)
        out["lam"][chan.instr.name] = q
        del chan

    # 2-D meshes over the two processes, every table on each
    full.to(dev, torch.float32)
    for shape in ((2, 1), (1, 2)):
        s2 = ShardedSpectro2D(full, make_mesh_2d(*shape, device_type="cuda"))
        counted = {"n": 0}
        orig = dist.all_reduce

        def counting(*a, **k):
            counted["n"] += 1
            return orig(*a, **k)

        gr.reset_launches()
        dist.all_reduce = counting
        try:
            n2 = s2.normal(truth)
        finally:
            dist.all_reduce = orig
        torch.cuda.synchronize(dev)
        key = f"{shape[0]}x{shape[1]}"
        out[f"mesh2d_{key}_reductions"] = counted["n"]
        out[f"mesh2d_{key}_launches"] = gr.launches
        out[f"mesh2d_{key}_normal"] = n2.cpu().numpy()
        t0 = time.perf_counter()
        for _ in range(3):
            s2.normal(truth)
        torch.cuda.synchronize(dev)
        out[f"mesh2d_{key}_ms_host"] = (time.perf_counter() - t0) / 3 * 1e3
    return out


def run_sharded_phase(dev, card: str, cuda_ms, gen, model, wmodel, setup, truth, mu_reg, bands,
                      cache_dir: str) -> dict:
    """[sharded], [lambda], [mesh2d]: the channel-expert sharding at world 1
    over NCCL on the rank flagship (bit for bit `model.normal`, against the
    plain gathers, launches, ms per normal and per all_reduce, the solve
    against the unsharded lcg) and the W-plane banded flagship (against its
    normal, launches of #1–#3, ms); the λ-sharded band 1c at world 1; then
    two processes on the card over gloo (`sharded_rank_worker`)."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from surfh_tpu_torch.core import gather_rows as gr
    from surfh_tpu_torch.core import wblur_banded as wb
    from surfh_tpu_torch.parallel import LambdaShardedChannel, ShardedSpectro, make_mesh
    from surfh_tpu_torch.parallel.fusion import spawn_world
    from surfh_tpu_torch.solvers.cg import lcg
    from surfh_tpu_torch.solvers.criterion import dtd_separated

    def sync():
        torch.cuda.synchronize(dev)

    def rel(a, b) -> float:
        return float((a - b).abs().max() / b.abs().max())

    res = {}
    n_pt = sum(c.oshape[0] for c in model.channels)
    mesh = make_mesh()
    check(dist.get_backend() == "nccl" and dist.get_world_size() == 1, "world 1 over NCCL")
    sh = ShardedSpectro(model, mesh)
    n_m, n_s, n_p = model.normal(truth), sh.normal(truth), sh.normal(truth, plain=True)
    sync()
    same, e_p = torch.equal(n_s, n_m), rel(n_s, n_p)
    log(f"[sharded] world 1 (NCCL), rank flagship: sharded normal bit for bit model.normal {same}; "
        f"against the plain gathers {e_p:.3e} (bound {TOL_SHARD:g})")
    check(same and e_p <= TOL_SHARD, "sharded rank normal")
    gr.reset_launches()
    sh.normal(truth)
    sync()
    per_normal = gr.launches
    check(per_normal == 2 * n_pt, f"sharded normal launches {per_normal}")
    ms_s = cuda_ms(lambda: sh.normal(truth), REPS)
    ms_m = cuda_ms(lambda: model.normal(truth), REPS)
    acc = torch.zeros(model.ishape, device=dev)
    ms_ar = cuda_ms(lambda: dist.all_reduce(acc), 20)
    log(f"[sharded] {card}: sharded normal {ms_s:.3f} ms (model.normal {ms_m:.3f} ms), its all_reduce "
        f"of {acc.numel() * 4 / 1e6:.2f} MB {ms_ar:.4f} ms; gather_rows launches per normal "
        f"{per_normal} (expected {2 * n_pt}); tables {sh.table_hbm_bytes()['per_device'] / 2**30:.3f} GiB")
    res.update(rank_ms=ms_s, model_ms=ms_m, all_reduce_ms=ms_ar)

    y = model.forward(truth)
    gr.reset_launches()
    t0 = time.perf_counter()
    sres = sh.solve(y, mu_reg=mu_reg, max_iter=SHARDED_NITER, tol=0.0)
    sync()
    t_solve = time.perf_counter() - t0
    res["launches"] = gr.launches
    expect = n_pt + 2 * n_pt * (SHARDED_NITER + 1)
    b = 1.0 * model.adjoint(y)
    ures = lcg(lambda x: 1.0 * model.normal(x) + mu_reg * dtd_separated(x), b, torch.zeros_like(b),
               max_iter=SHARDED_NITER, tol=0.0)
    sync()
    e_x = rel(sres.x, ures.x)
    log(f"[sharded] main path (b, {sres.n_iter} solve iterations, mu_reg={mu_reg:g}) in {t_solve:.3f} s; "
        f"gather_rows launches {res['launches']} (expected {expect}); iterate against the unsharded "
        f"lcg: {e_x:.3e}, bit for bit {torch.equal(sres.x, ures.x)}; grad norms "
        f"{sres.grad_norm[0]:.4e} -> {sres.grad_norm[-1]:.4e}")
    check(res["launches"] == expect and e_x <= TOL_SHARD and sres.grad_norm[-1] < sres.grad_norm[0],
          "sharded solve")
    del sres, ures, b, n_m, n_s, n_p

    shw = ShardedSpectro(wmodel, mesh)
    w_ref = wmodel.normal(truth)
    w_s = shw.normal(truth)
    w_p = shw.normal(truth, plain=True)
    sync()
    e_w, e_wp = rel(w_s, w_ref), rel(w_s, w_p)
    gr.reset_launches()
    wb.reset_launches()
    shw.normal(truth)
    sync()
    w_launch = (gr.launches, wb.launches, wb.launches_t)
    ms_w = cuda_ms(lambda: shw.normal(truth), 3)
    ms_wm = cuda_ms(lambda: wmodel.normal(truth), 3)
    n_w = sum(c.n_wslice for c in wmodel.channels)
    log(f"[sharded] {card}: W-plane banded flagship at world 1: each band's own λ window "
        f"(ΣW = {n_w} planes, against the model's {wmodel.cube_shape[0]}): against wmodel.normal "
        f"{e_w:.3e}, against the plain versions {e_wp:.3e} (bound {TOL_SHARD:g}); launches per normal "
        f"gather_rows / wblur_banded / wblur_banded_t {w_launch} (expected {(2 * n_pt, n_pt, n_pt)}); "
        f"{ms_w:.3f} ms per normal (wmodel.normal {ms_wm:.3f} ms)")
    check(e_w <= TOL_SHARD and e_wp <= TOL_SHARD and w_launch == (2 * n_pt, n_pt, n_pt),
          "sharded W-plane normal")
    res.update(wplane_launches=w_launch, wplane_ms=ms_w, wplane_model_ms=ms_wm)
    del shw, w_ref, w_s, w_p
    torch.cuda.empty_cache()

    # [lambda] band 1c's channel, world 1
    lam_band = "1c"
    c = next((i for i, ch in enumerate(model.channels) if ch.instr.name.lower().startswith(lam_band)), 0)
    chan = model.channels[c].to(dev, torch.float32)
    L = model.cube_shape[0]
    lam = LambdaShardedChannel(chan, L, make_mesh(axis_name="lam"))
    seed = 7
    g = torch.Generator(device=dev).manual_seed(seed)
    cube = torch.rand(model.cube_shape, generator=g, device=dev)
    yc = torch.rand(chan.oshape, generator=g, device=dev)
    shard = lam.shard_cube(cube)
    gr.reset_launches()
    fwd = lam.forward(shard)
    lam.adjoint(yc)
    sync()
    res["lambda_launches"] = gr.launches
    e_l = rel(fwd, chan.forward(cube))
    e_lp = rel(fwd, lam.forward(shard, plain=True))
    ms_lf = cuda_ms(lambda: lam.forward(shard), REPS)
    ms_la = cuda_ms(lambda: lam.adjoint(yc), REPS)
    del cube, shard, fwd
    d_l = lambda_dot_test(chan, dev, seed, make_mesh(axis_name="lam"))
    log(f"[lambda] {card}: band {chan.instr.name} λ-sharded at world 1 (W = {chan.n_wslice} of L = {L}): "
        f"forward against the channel's {e_l:.3e}, against the plain gathers {e_lp:.3e} (bound "
        f"{TOL_SHARD:g}); the float64 pair's dot test {d_l:.3e} (bound {TOL_DOT64:g}); gather_rows "
        f"launches forward + adjoint {res['lambda_launches']} (expected {2 * chan.oshape[0]}); forward "
        f"{ms_lf:.3f} ms, adjoint {ms_la:.3f} ms")
    check(e_l <= TOL_SHARD and e_lp <= TOL_SHARD and d_l <= TOL_DOT64
          and res["lambda_launches"] == 2 * chan.oshape[0], "λ-sharded world 1")
    del lam
    torch.cuda.empty_cache()

    # two processes on the one card over gloo
    t0 = time.perf_counter()
    ranks = spawn_world(sharded_rank_worker, 2, (bands, cache_dir, mu_reg, lam_band, seed),
                        backend="gloo", timeout=600.0)
    t_two = time.perf_counter() - t0
    r0, r1 = ranks
    x_same = np.array_equal(r0["x"], r1["x"])
    n1 = sh.normal(truth).cpu().numpy()
    e_n = [float(np.abs(r["normal"] - n1).max() / np.abs(n1).max()) for r in ranks]
    log(f"[sharded] {card}: two processes on the one card over {r0['backend']} (shard_tables, the "
        f"tables from [host]'s cache: hit {r0['cache_hit']}, {r1['cache_hit']}) in {t_two:.1f} s: ranks own "
        f"{r0['mine']} / {r1['mine']}; table bytes per rank {r0['bytes']['per_device'] / 2**30:.3f} / "
        f"{r1['bytes']['per_device'] / 2**30:.3f} GiB of {r0['bytes']['replicated_would_be'] / 2**30:.3f} "
        f"replicated; normal against world 1 {max(e_n):.3e} (bound {TOL_SHARD:g}); {SHARDED_NITER} solve "
        f"iterations, iterates bit for bit across the ranks {x_same}; gather_rows launches per normal "
        f"{r0['normal_launches']} + {r1['normal_launches']}, on the solve {r0['solve_launches']} + "
        f"{r1['solve_launches']}; host ms per normal {r0['normal_ms_host']:.2f} / {r1['normal_ms_host']:.2f}, "
        f"per gloo all_reduce {r0['all_reduce_ms_host']:.2f} / {r1['all_reduce_ms_host']:.2f}")
    check(r0["cache_hit"] and r1["cache_hit"] and x_same and max(e_n) <= TOL_SHARD
          and r0["backend"] == "gloo" and sorted(r0["mine"] + r1["mine"]) == list(range(len(model.channels)))
          and r0["normal_launches"] + r1["normal_launches"] == 2 * n_pt, "two-rank sharded run")
    res["two_rank_launches"] = r0["solve_launches"] + r1["solve_launches"]
    res["two_rank_ms_host"] = max(r0["normal_ms_host"], r1["normal_ms_host"])
    res["gloo_all_reduce_ms_host"] = max(r0["all_reduce_ms_host"], r1["all_reduce_ms_host"])
    for name, q0 in r0["lam"].items():
        q1 = r1["lam"][name]
        log(f"[lambda] {card}: band {name} at world 2 over gloo: the ranks' spans (start, planes, window "
            f"column) {q0['span']} / {q1['span']}; forward against the channel's {q0['err']:.3e} / "
            f"{q1['err']:.3e} (bound {TOL_SHARD:g}); the float64 pair's dot test, the window split "
            f"between the ranks, {q0['dot']:.3e} (bound {TOL_DOT64:g}); gather_rows launches "
            f"{q0['launches']} + {q1['launches']} (expected 2 x {q0['P']} on each rank whose block meets "
            f"the window)")
        busy = sum(q["span"] is not None for q in (q0, q1))  # ranks whose block meets the window
        check(max(q0["err"], q1["err"]) <= TOL_SHARD and q0["dot"] <= TOL_DOT64
              and q0["launches"] + q1["launches"] == 2 * q0["P"] * busy, f"λ-sharded world 2, band {name}")
        res["lambda_launches"] += q0["launches"] + q1["launches"]
    check(any(q["span"] is not None and r1["lam"][n]["span"] is not None for n, q in r0["lam"].items()),
          "a band split over the two ranks")
    m_ref = model.normal(truth).cpu().numpy()
    res["mesh2d_launches"] = 0
    for key in ("2x1", "1x2"):
        errs = [float(np.abs(r[f"mesh2d_{key}_normal"] - m_ref).max() / np.abs(m_ref).max()) for r in ranks]
        nred = (r0[f"mesh2d_{key}_reductions"], r1[f"mesh2d_{key}_reductions"])
        nl = (r0[f"mesh2d_{key}_launches"], r1[f"mesh2d_{key}_launches"])
        log(f"[mesh2d] {card}: mesh {key} (chan x lam) over gloo, rank flagship: normal against "
            f"model.normal {max(errs):.3e} (bound {TOL_SHARD:g}); all_reduces per normal {nred} "
            f"(expected 2 each); gather_rows launches per normal {nl}; host ms per normal "
            f"{r0[f'mesh2d_{key}_ms_host']:.2f} / {r1[f'mesh2d_{key}_ms_host']:.2f}")
        check(max(errs) <= TOL_SHARD and nred == (2, 2) and min(nl) > 0, f"mesh2d {key}")
        res["mesh2d_launches"] += sum(nl)
    res["mesh2d_ms_host"] = {k: max(r0[f"mesh2d_{k}_ms_host"], r1[f"mesh2d_{k}_ms_host"])
                             for k in ("2x1", "1x2")}
    res["bytes"] = [r0["bytes"], r1["bytes"]]
    del sh
    dist.destroy_process_group()
    torch.cuda.empty_cache()
    return res


CONFIG4_ARGV = ["fusion", "--simulated", "-nc", "3", "--pointings", "4", "-np", "501", "-nt", "4",
                "-ni", "50", "-hp", "5e3"]
# λ samples of BASELINE config 4's simulated run: the synthetic 7.51–8.75 µm axis sampled at
# about the gratings' resolution element (λ/R ≈ 2.6e-3 µm at R ≈ 3050)
CONFIG4_NLAMBDA = 480
CONFIG4_J_FALL = 1e-4  # J(x̂) / J(0) after 50 iterations, both solves
# |J(sharded) − J(unsharded lcg)| / J(unsharded), both from 0: f32 CG in another sum
# order; measured 8e-6 (1.133890e10 against 1.133881e10), so ~10× headroom
CONFIG4_J_AGREE = 1e-4


def run_config4_phase(dev, card: str, cuda_ms) -> dict:
    """[config4]: BASELINE config 4 through the port's CLI, sharded under
    torchrun (world 1, NCCL) and unsharded with the same arguments: the
    reports and the criterion's fall; the sharded command's maps bit for
    bit an in-process `ShardedSpectro.solve` of the same model (the command
    is the library's path); the sharded normal against the model's within
    f32 rounding; ms per normal and per iteration of both after their
    one-time set-up (NCCL's communicator, cuFFT plans); the objective J of
    the sharded solve and of the unsharded lcg from the same zero start (the reference's sharded start; the
    unsharded command starts at 0.5).  50 CG iterations amplify an operator
    rounding difference far past it (PERF.md), so the iterates are compared
    on the record, not against a rounding bound."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from surfh_tpu_torch.core import gather_rows as gr
    from surfh_tpu_torch.parallel import ShardedSpectro, make_mesh
    from surfh_tpu_torch.simulation.synthetic import make_model
    from surfh_tpu_torch.solvers.cg import lcg
    from surfh_tpu_torch.solvers.criterion import dtd_separated

    argv = CONFIG4_ARGV + ["--n-lambda", str(CONFIG4_NLAMBDA)]
    mu, niter = float(argv[argv.index("-hp") + 1]), int(argv[argv.index("-ni") + 1])
    work = tempfile.mkdtemp(prefix="surfh_config4_")
    env = dict(os.environ, PYTHONPATH=os.path.dirname(os.path.abspath(__file__)))
    try:
        runs = {}
        for name, pre in (("sharded", [sys.executable, "-m", "torch.distributed.run", "--standalone",
                                       "--nproc-per-node", "1", "-m", "surfh_tpu_torch.cli"]),
                          ("unsharded", [sys.executable, "-m", "surfh_tpu_torch.cli"])):
            out = os.path.join(work, name)
            extra = ["--sharded"] if name == "sharded" else []
            t0 = time.perf_counter()
            proc = subprocess.run(pre + argv + extra + ["-o", out], env=env, capture_output=True,
                                  text=True, timeout=600)
            wall = time.perf_counter() - t0
            if proc.returncode != 0:
                log(proc.stderr[-4000:])
            check(proc.returncode == 0, f"config4 {name} run")
            rep = json.loads([ln for ln in proc.stdout.splitlines() if ln.startswith("{")][-1])
            runs[name] = (rep, np.load(os.path.join(out, "res_x.npy")),
                          np.load(os.path.join(out, "criterion.npy")))
            log(f"[config4] {card}: `{' '.join(argv + extra)}`{' under torchrun (1 process)' if extra else ''}: "
                f"{json.dumps(rep)}; wall {wall:.1f} s (process start and model build included)")
            gn = runs[name][2]
            check(set(rep) == {"method", "niter", "seconds", "iters_per_s", "psnr_maps",
                               "relative_error_pct"} and rep["niter"] == niter, f"config4 {name} report")
            check(bool(np.isfinite(gn).all()) and gn[-1] < 1e-2 * gn[0], f"config4 {name} criterion falls")

        model, setup = make_model(dtype=np.float32, window_local=False, im_size=501,
                                  n_lambda=CONFIG4_NLAMBDA, n_tpl=4, n_channels=3, n_pointings=4)
        model.to(dev, torch.float32)
        truth = torch.as_tensor(setup["maps"], dtype=torch.float32, device=dev)
        y = model.forward(truth)
        sh = ShardedSpectro(model, make_mesh())
        b = 1.0 * model.adjoint(y)

        def unsharded(n):
            return lcg(lambda x: 1.0 * model.normal(x) + mu * dtd_separated(x), b, torch.zeros_like(b),
                       max_iter=n)

        try:
            t0 = time.perf_counter()
            e_n = float((sh.normal(truth) - model.normal(truth)).abs().max() / model.normal(truth).abs().max())
            torch.cuda.synchronize(dev)
            t_first = time.perf_counter() - t0
            gr.reset_launches()
            xs = sh.solve(y.cpu().numpy(), mu_reg=mu, max_iter=niter).x
            torch.cuda.synchronize(dev)
            launches = gr.launches
            ms = {"sharded": cuda_ms(lambda: sh.normal(truth), REPS),
                  "unsharded": cuda_ms(lambda: model.normal(truth), REPS)}
            its = {}
            for name, run in (("sharded", lambda: sh.solve(y, mu_reg=mu, max_iter=REPS)),
                              ("unsharded", lambda: unsharded(REPS))):
                t0 = time.perf_counter()
                run()
                torch.cuda.synchronize(dev)
                its[name] = (time.perf_counter() - t0) / REPS
        finally:
            dist.destroy_process_group()
        same = np.array_equal(xs.cpu().numpy(), runs["sharded"][1])
        xu = unsharded(niter).x
        log(f"[config4] {card}: normal {ms['sharded']:.3f} ms sharded (each band's window: ΣW = "
            f"{sum(c.n_wslice for c in model.channels)} planes) against {ms['unsharded']:.3f} ms unsharded "
            f"(L = {model.cube_shape[0]}); a CG iteration after the set-up {its['sharded'] * 1e3:.2f} ms "
            f"sharded, {its['unsharded'] * 1e3:.2f} ms unsharded (host clock, {REPS} iterations); the first "
            f"sharded normal (NCCL's communicator made) {t_first * 1e3:.1f} ms")

        def J(x):
            r = (y - model.forward(x)).double()
            return float(0.5 * (r * r).sum() + 0.5 * mu * (x.double() * dtd_separated(x).double()).sum())

        j0, js, ju = J(torch.zeros_like(b)), J(xs), J(xu)
        e_x = float((xs - xu).abs().max() / xu.abs().max())
        xc = torch.as_tensor(runs["unsharded"][1], device=dev)
        log(f"[config4] {card}: bands W = {[c.n_wslice for c in model.channels]}, y {model.oshape[0]}; the "
            f"command's sharded maps bit for bit the in-process ShardedSpectro.solve {same} (gather_rows "
            f"launches {launches}); sharded normal against model.normal {e_n:.3e} (bound {TOL_SHARD:g}); "
            f"J(0) {j0:.6e}, J(sharded) {js:.6e}, J(unsharded lcg from 0) {ju:.6e}, J(unsharded command, "
            f"from 0.5) {J(xc):.6e} (bounds J/J(0) <= {CONFIG4_J_FALL:g}, |J(sharded) - J(unsharded)| / "
            f"J(unsharded) {abs(js - ju) / ju:.3e} <= {CONFIG4_J_AGREE:g}); maps sharded vs unsharded "
            f"from 0: {e_x:.3e} of the max")
        check(same and e_n <= TOL_SHARD and launches > 0 and max(js, ju) <= CONFIG4_J_FALL * j0
              and abs(js - ju) <= CONFIG4_J_AGREE * ju, "config4 against the library and the unsharded solve")
        del model, sh, xs, xu, xc, b, y
        torch.cuda.empty_cache()
        return {"report": runs["sharded"][0], "unsharded": runs["unsharded"][0], "launches": launches,
                "J": (j0, js, ju), "err_x": e_x, "ms": ms, "it_s": its}
    finally:
        shutil.rmtree(work, ignore_errors=True)


WARMUP_ARGV = ["warmup", "--bands", "1c,2a", "--programs", "fwd,adj,normal"]


def run_warmup_phase(card: str) -> dict:
    """[warmup]: `warmup --bands 1c,2a --programs fwd,adj,normal` into a
    fresh table-cache directory, then again: the second finds its tables
    in the cache."""
    cache = tempfile.mkdtemp(prefix="surfh_warmup_cache_")
    env = dict(os.environ, PYTHONPATH=os.path.dirname(os.path.abspath(__file__)))
    reps = []
    try:
        for i in range(2):
            proc = subprocess.run([sys.executable, "-m", "surfh_tpu_torch.cli"] + WARMUP_ARGV
                                  + ["--cache-dir", cache], env=env, capture_output=True, text=True,
                                  timeout=600)
            if proc.returncode != 0:
                log(proc.stderr[-4000:])
            check(proc.returncode == 0, f"warmup run {i + 1}")
            rep = json.loads(proc.stdout.strip().splitlines()[-1])
            reps.append(rep)
            log(f"[warmup] {card}: run {i + 1}: {json.dumps(rep)}")
        check(reps[0]["backend"] == "cuda" and not reps[0]["table_cache_hit"] and reps[1]["table_cache_hit"]
              and all(f"t_first_{p}_s" in reps[1] for p in ("fwd", "adj", "normal")), "warmup report")
        return {"cold": reps[0], "hit": reps[1]}
    finally:
        shutil.rmtree(cache, ignore_errors=True)


ROOT = os.path.dirname(os.path.abspath(__file__))
BENCH_KEYS = {
    "metric", "value", "unit", "vs_baseline", "preset", "t_app_s", "t_compile_s",
    "compile_breakdown", "flops_per_app", "tflops", "mfu_est", "mfu_note", "cube_shape",
    "n_channels", "n_pointings", "baseline_s", "baseline_config", "device_ms_per_app",
    "dispatch_ms_per_app", "device_busy_frac", "t_total_s", "mode", "device",
}
BENCH_RUNS = (  # (tag, environment, the mode it runs in)
    ("flagship", {"SURFH_BENCH_PRESET": "flagship"}, "dispatch"),
    ("flagship-loop", {"SURFH_BENCH_PRESET": "flagship", "SURFH_BENCH_MODE": "loop"}, "loop"),
    ("medium", {"SURFH_BENCH_PRESET": "medium"}, "loop"),
    ("medium-banded", {"SURFH_BENCH_PRESET": "medium", "SURFH_WBLUR_IMPL": "banded"}, "loop"),
)
BENCH_CHECK_CHAIN = 3  # dependent applications of the in-process checks
FLAGSHIP_CG_NITER = 50
QUALITY_ARGV = ["--scenes", "orion", "--noise", "0.01", "--mus", "5e3", "--niter", "50"]
AUDIT_BANDS = "1c,2a"  # the audit's depth cut: two bands of the twelve


def run_script(name: str, argv, tag: str) -> list:
    """`scripts/<name>.py`'s `main(argv)` in this process, as a user runs it
    (its launches land in this process's counts): its stdout lines go to the
    log; returns its JSON lines.  A non-zero return fails the check."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = load_script(name).main(argv)
    lines = buf.getvalue().splitlines()
    for line in lines:
        log(f"[{tag}] {line}")
    check(rc == 0, f"{name} {' '.join(argv)}: exit code {rc}")
    return [json.loads(line) for line in lines if line.startswith("{")]


def run_bench_phase(dev, card: str, model, truth, cache_dir: str, normal_ms: float) -> dict:
    """[bench]: `bench_torch.py` as a user runs it, four times (flagship in
    dispatch and in loop mode, medium in loop mode: the CUDA graph, medium
    with the banded blur), each result line checked and its wrappers' launches read
    from its log; before them, in this process on [host]'s flagship model,
    the timed chain through the kernels against the plain versions and its
    CUDA-graph replay against the eager chain.  Returns the launches."""
    import numpy as np
    import torch

    import bench_torch
    from surfh_tpu_torch.core import gather_rows as gr

    rel = bench_torch.rel_gap
    n_pt = sum(c.oshape[0] for c in model.channels)
    gr.reset_launches()
    g_k = bench_torch.apply_chain(model, truth, BENCH_CHECK_CHAIN)
    torch.cuda.synchronize(dev)
    n_k = gr.launches
    g_p = bench_torch.apply_chain(model, truth, BENCH_CHECK_CHAIN, plain=True)
    err = rel(g_k, g_p)
    graph, g_gr, _ = bench_torch.capture_chain(model, truth, BENCH_CHECK_CHAIN)
    graph.replay()
    gap = rel(g_gr, bench_torch.apply_chain(model, truth, BENCH_CHECK_CHAIN))
    del graph, g_gr, g_k, g_p
    log(f"[bench] flagship chain of {BENCH_CHECK_CHAIN} (g = H'(H x), x = x0 + 1e-30 g) in this "
        f"process: kernels vs plain versions max rel {err:.3e} (bound 1e-5), gather_rows launches "
        f"{n_k} (expected {2 * n_pt * BENCH_CHECK_CHAIN}); CUDA-graph replay vs eager chain {gap:.3e} "
        f"(bound 1e-6)")
    check(err <= 1e-5, "bench chain kernels vs plain")
    check(n_k == 2 * n_pt * BENCH_CHECK_CHAIN, "bench chain launches")
    check(gap <= 1e-6, "bench chain CUDA graph vs eager")

    # the medium preset in this process, both blurs: the chain through the
    # kernels (#1, and #2 / #3 banded) against their plain versions
    from surfh_tpu_torch.core import wblur_banded as wb

    for impl in ("dense", "banded"):
        mmodel, msetup, _ = bench_torch.build_model("medium", dev, impl)
        mmodel.to(dev, torch.float32)
        x0 = torch.as_tensor(np.asarray(msetup["maps"]), dtype=torch.float32, device=dev)
        m_pt = sum(c.oshape[0] for c in mmodel.channels)
        gr.reset_launches()
        wb.reset_launches()
        g_k = bench_torch.apply_chain(mmodel, x0, BENCH_CHECK_CHAIN)
        torch.cuda.synchronize(dev)
        got = (gr.launches, wb.launches, wb.launches_t)
        k = BENCH_CHECK_CHAIN * m_pt
        want = (2 * k, k, k) if impl == "banded" else (2 * k, 0, 0)
        err = rel(g_k, bench_torch.apply_chain(mmodel, x0, BENCH_CHECK_CHAIN, plain=True))
        log(f"[bench] medium chain of {BENCH_CHECK_CHAIN}, {impl} blur, in this process: kernels vs "
            f"plain versions max rel {err:.3e} (bound 1e-5); launches gather_rows / wblur_banded / "
            f"wblur_banded_t {got} (expected {want})")
        check(err <= 1e-5 and got == want, f"bench medium {impl} chain kernels vs plain, launches")
        del mmodel, g_k, x0
    torch.cuda.empty_cache()

    out = {}
    for tag, extra, mode in BENCH_RUNS:
        env = {k: v for k, v in os.environ.items() if not k.startswith(("SURFH_BENCH", "SURFH_WBLUR"))}
        env.update(SURFH_TABLE_CACHE=cache_dir, **extra)
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "bench_torch.py"], cwd=ROOT, env=env,
                              capture_output=True, text=True, timeout=600)
        for line in proc.stderr.splitlines():
            if line.startswith("[bench"):
                log(f"[bench] {tag}: {line}")
        if proc.returncode != 0:
            log(proc.stderr[-4000:])
        check(proc.returncode == 0, f"bench_torch.py {tag}: exit code {proc.returncode}")
        lines = proc.stdout.strip().splitlines()
        res = json.loads(lines[-1])
        log(f"[bench] {tag}: {lines[-1]}")
        m = re.search(r"gather_rows (\d+), wblur_banded (\d+), wblur_banded_t (\d+)", proc.stderr)
        launches = tuple(int(v) for v in m.groups()) if m else (0, 0, 0)
        missing = sorted(BENCH_KEYS - set(res))
        check(len(lines) == 1 and not missing, f"bench {tag}: one line, keys missing {missing}")
        check(res["mode"] == mode and res["device"] == card and res["value"] > 0
              and res["device_ms_per_app"] is not None and res["device_busy_frac"] is not None,
              f"bench {tag}: mode, device, value, device time")
        check(launches[0] > 0, f"bench {tag}: gather_rows launched")
        if "BANDED" in json.dumps(extra).upper():
            check(min(launches[1:]) > 0, f"bench {tag}: both banded kernels launched")
        if mode == "loop":
            g = re.search(r"max rel gap (\S+)", proc.stderr)
            check(g is not None and float(g.group(1)) <= 1e-6,
                  f"bench {tag}: CUDA-graph replay vs eager chain {g and g.group(1)} (bound 1e-6)")
        cb = res["compile_breakdown"]
        log(f"[bench] {card}: {tag} ({mode}): {res['t_app_s'] * 1e3:.3f} ms/app, {res['value']:.3f} "
            f"GVox/s, device {res['device_ms_per_app']:.3f} ms/app (busy {res['device_busy_frac']:.3f}, "
            f"host-paced {res['dispatch_ms_per_app']:.3f} ms), analytic TFLOP/s {res['tflops']}, "
            f"host build {cb['host_build_s']:.2f} s (table cache {cb['table_cache']}), upload "
            f"{cb['upload_mb']:.1f} MB in {cb['tables_dispatch_s']:.3f} s; launches gather_rows / "
            f"wblur_banded / wblur_banded_t {launches}; {time.perf_counter() - t0:.2f} s in all")
        out[tag] = {"result": res, "launches": launches}
    log(f"[bench] {card}: flagship t_app dispatch {out['flagship']['result']['t_app_s'] * 1e3:.3f} ms, "
        f"loop {out['flagship-loop']['result']['t_app_s'] * 1e3:.3f} ms (fwd then adjoint, host "
        f"clock) beside [slice]'s eager fused normal {normal_ms:.3f} ms (CUDA events)")
    return out


def run_measure_scripts_phase(dev, card: str, model, bands, cache_dir: str) -> dict:
    """[flagship-cg], [quality], [audit]: the headline-measurement scripts
    in this process, as a user runs them, the flagship's tables from
    [host]'s cache, their row-gather launches counted."""
    import numpy as np

    from surfh_tpu_torch.core import gather_rows as gr

    n_pt = sum(c.oshape[0] for c in model.channels)
    band_args = ["--bands", ",".join(bands)] if bands else []
    out = {}
    os.environ["SURFH_TABLE_CACHE"] = cache_dir
    try:
        t0 = time.perf_counter()
        gr.reset_launches()
        rep = run_script("torch_flagship_cg", ["--niter", str(FLAGSHIP_CG_NITER)] + band_args,
                         "flagship-cg")[-1]
        out["flagship_cg"] = gr.launches
        # y, b, the warm-up's r0 and 2 iterations, the solve's r0 and iterations: 2 a normal
        expect = 2 * n_pt + 2 * n_pt * 3 + 2 * n_pt * (1 + FLAGSHIP_CG_NITER)
        log(f"[flagship-cg] {card}: {rep['niter']} lcg iterations (graph loop) at "
            f"{rep['iters_per_s']:.2f} it/s ({rep['solve_s']:.3f} s), build {rep['build_s']:.2f} s, "
            f"grad norm {rep['grad_norm_marks']} reduction {rep['grad_reduction']:.4e}, relative error "
            f"{rep['relative_error_pct']:.4f} %, gather_rows launches {out['flagship_cg']} (expected "
            f"{expect}); phase {time.perf_counter() - t0:.2f} s")
        check(rep["niter"] == FLAGSHIP_CG_NITER and rep["grad_reduction"] > 1
              and np.isfinite(rep["relative_error_pct"]) and rep["device"] == card, "flagship-cg report")
        check(out["flagship_cg"] == expect, "flagship-cg launches")

        t0 = time.perf_counter()
        gr.reset_launches()
        rows = run_script("torch_quality_surface", QUALITY_ARGV + band_args, "quality")
        out["quality"] = gr.launches
        row = rows[0]
        # the coverage mask's Hᵗ1, y, b, r0 and 50 iterations
        expect = 3 * n_pt + 2 * n_pt * (1 + row["niter"])
        log(f"[quality] {card}: {json.dumps(row)}; gather_rows launches {out['quality']} (expected "
            f"{expect}); phase {time.perf_counter() - t0:.2f} s")
        check(len(rows) == 2 and all(np.isfinite(row[k]) for k in ("rel_err_pct", "psnr", "grad_norm_final")),
              "quality row")
        check(out["quality"] == expect, "quality launches")
    finally:
        os.environ["SURFH_TABLE_CACHE"] = "0"

    t0 = time.perf_counter()
    work = tempfile.mkdtemp(prefix="surfh_audit_")
    try:
        gr.reset_launches()
        rec = run_script("torch_rank_fidelity_audit",
                         ["--phase", "deviation", "--bands", AUDIT_BANDS, "--out-dir", work], "audit")[-1]
        out["audit"] = gr.launches
    finally:
        shutil.rmtree(work, ignore_errors=True)
    n_pt2 = 4 * len(AUDIT_BANDS.split(","))
    log(f"[audit] {card}: bands {AUDIT_BANDS} of the twelve (a cut in depth), 501², 4 pointings: ranks "
        f"{rec['ranks']}, tails {rec['svd_tails']}; forward max rel {rec['fwd_max_rel']:.3e}, adjoint "
        f"{rec['adj_max_rel']:.3e} (bound {rec['bound']:.3e}); gather_rows launches {out['audit']} "
        f"(expected {4 * n_pt2}: two models, forward and adjoint); phase {time.perf_counter() - t0:.2f} s")
    check(rec["within_bound"] and rec["device"] == card, "audit deviations within the bound")
    check(out["audit"] == 4 * n_pt2, "audit launches")
    return out


def run_tools_phase(dev, card: str, stage2_dir: str) -> dict:
    """[tools]: the user tools in this process, as a user runs them:
    `torch_learn_templates.py --demo` with NMF and N-FINDR on the card,
    `torch_correct_mrs_data.py` then `torch_filter_slices.py` on
    [pipeline]'s stage-2 frames against the rehearsal's own filtered
    slices, and `torch_run_fusion_simulated.py` at its defaults with its
    row-gather launches counted."""
    import numpy as np

    from surfh_tpu_torch.core import gather_rows as gr
    from surfh_tpu_torch.preprocessing.fits_io import fits_open

    out = {}
    work = tempfile.mkdtemp(prefix="surfh_tools_")
    try:
        for method in ("nmf", "nfindr"):
            t0 = time.perf_counter()
            o = os.path.join(work, method)
            rep = run_script("torch_learn_templates", ["--demo", "--method", method, "-o", o], "tools")[-1]
            tpl = np.load(os.path.join(o, "templates.npy"))
            ok = tpl.shape == (4, 300) and bool(np.isfinite(tpl).all()) and rep["device"] == card
            if method == "nmf":
                ab = np.load(os.path.join(o, "abundances.npy"))
                ok = ok and np.isfinite(rep["error"]) and bool((tpl >= 0).all()) and ab.shape == (4, 100, 100)
                what = f"error {rep['error']:.6e}"
            else:
                ab = np.load(os.path.join(o, "abundances_flat.npy"))
                sums = float(np.abs(ab.sum(axis=1) - 1).max())
                ok = ok and len(set(rep["endmember_indices"])) == 4 and sums <= 1e-4 and bool((ab >= 0).all())
                what = f"endmembers {rep['endmember_indices']}, |Σ abundances − 1| ≤ {sums:.2e}"
            log(f"[tools] {card}: learn_templates --demo --method {method}: {what}; "
                f"{time.perf_counter() - t0:.2f} s")
            check(ok, f"learn_templates {method}")

        t0 = time.perf_counter()
        corr, filt = os.path.join(work, "corrected"), os.path.join(work, "filtered")
        run_script("torch_correct_mrs_data", ["--raw-dir", os.path.join(stage2_dir, "raw"), "--out-dir", corr,
                                              "--npix", str(REHEARSE_NPIX), "--wavel-cube",
                                              os.path.join(stage2_dir, "wavel_axis.npy")],
                   "tools")
        run_script("torch_filter_slices", ["--in-dir", corr, "--out-dir", filt], "tools")
        got = sorted(os.listdir(filt))
        want = sorted(os.listdir(os.path.join(stage2_dir, "Filtered_slices")))
        check(len(got) == len(want) == 4, f"filtered slices {got} against the rehearsal's {want}")
        errs, same = [], True
        for g, w in zip(got, want):
            a = np.asarray(fits_open(os.path.join(filt, g))[0].data)
            b = np.asarray(fits_open(os.path.join(stage2_dir, "Filtered_slices", w))[0].data)
            check(a.shape == b.shape and bool(np.isfinite(a).all()), f"{g} shape")
            errs.append(float(np.abs(a - b).max() / np.abs(b).max()))
            same = same and np.array_equal(a, b)
        # the same f32 Shepard regrid and median filter as the rehearsal's: [pipeline]'s Shepard bar
        log(f"[tools] {card}: correct_mrs_data + filter_slices on [pipeline]'s 4 stage-2 frames (band "
            f"{REHEARSE_BAND}, {REHEARSE_NPIX}²) against the rehearsal's filtered slices: max rel "
            f"{max(errs):.3e} (bound 1e-5), bit for bit {same}; {time.perf_counter() - t0:.2f} s")
        check(max(errs) <= 1e-5, "tools correct + filter against the rehearsal")

        t0 = time.perf_counter()
        gr.reset_launches()
        rep = run_script("torch_run_fusion_simulated", ["--output-dir", os.path.join(work, "fusion")],
                         "tools")[-1]
        out["run_fusion_simulated"] = gr.launches
        n_pt = 4 * 4  # its defaults: 4 bands, 4 pointings
        expect = n_pt + n_pt + 2 * n_pt * (1 + rep["niter"])  # y, b, r0, one normal an iteration
        log(f"[tools] {card}: run_fusion_simulated at its defaults: {json.dumps(rep)}; gather_rows "
            f"launches {out['run_fusion_simulated']} (expected {expect}); {time.perf_counter() - t0:.2f} s")
        check(rep["niter"] == 50 and np.isfinite(rep["relative_error_pct"]) and rep["device"] == card,
              "run_fusion_simulated report")
        check(out["run_fusion_simulated"] == expect, "run_fusion_simulated launches")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--bands", default=None, help="comma-separated MIRI bands (default: all 12)")
    args = ap.parse_args(argv)

    import torch

    from surfh_tpu_torch.core.precision import require_cuda

    dev = require_cuda()

    import numpy as np

    from concurrent.futures import ThreadPoolExecutor

    from surfh_tpu_torch.core import _build, fft
    from surfh_tpu_torch.core import fft_conv as fc
    from surfh_tpu_torch.core import gather_fixed as gf
    from surfh_tpu_torch.core import gather_rows as gr
    from surfh_tpu_torch.core import normal_prior as fused
    from surfh_tpu_torch.core import wblur_banded as wb
    from surfh_tpu_torch.core import window_spectrum as ws
    from surfh_tpu_torch.simulation.flagship import make_flagship_model, make_flagship_setup
    from surfh_tpu_torch.simulation.synthetic import make_model
    from surfh_tpu_torch.solvers.criterion import QuadCriterion_MRS
    from surfh_tpu_torch.utils.profiling import FP32_FLOPS_PER_S, HBM_BYTES_PER_S, card_name

    def sync():
        torch.cuda.synchronize(dev)

    def rel(a, b) -> float:
        return float((a - b).abs().max() / b.abs().max())

    def bound(nbytes: float, flops: float = 0.0):
        """The least time the card could take: bytes over the memory rate or
        operations over the FP32 rate, whichever is larger (ms, which)."""
        t_b, t_f = nbytes / HBM_BYTES_PER_S * 1e3, flops / FP32_FLOPS_PER_S * 1e3
        return (t_b, "bytes") if t_b >= t_f else (t_f, "operations")

    proto = load_script("torch_scatter_proto")
    cuda_ms = proto.event_ms  # mean device ms per call, CUDA events around `reps` calls

    # 1. device --------------------------------------------------------
    card = card_name(dev)
    log(card)
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(dev)} x{torch.cuda.device_count()}, "
        f"tf32 matmul={torch.backends.cuda.matmul.allow_tf32} cudnn={torch.backends.cudnn.allow_tf32}")

    # 2. build ---------------------------------------------------------
    t0 = time.perf_counter()
    with ThreadPoolExecutor(4) as ex:  # one nvcc per source, all at once
        for f in [ex.submit(gr.load_kernel), ex.submit(wb.load_kernels),
                  ex.submit(gf.load_kernels), ex.submit(fused.load_kernel), ex.submit(fc.load_kernels),
                  ex.submit(ws.load_kernels)]:
            f.result()
    log(f"[build] gather_rows.cu, wblur_banded.cu, gather_fixed.cu, normal_prior.cu, fft_conv.cu, "
        f"window_spectrum.cu -> {_build.BUILD_DIR} in {time.perf_counter() - t0:.2f} s")
    for name in ("gather_rows", "wblur_banded", "normal_prior", "fft_conv", "window_spectrum"):
        for line in _build.build_logs.get(name, "").splitlines():
            if "Compiling entry" in line or "registers" in line or "spill" in line:
                log(f"[build] ptxas {name}: {line.strip()}")
    # gather_fixed.cu (K1, K2, K3, each a narrow kernel and lane-group
    # instances): one line per kernel, its registers and spills
    name, spill = None, ""
    for line in _build.build_logs.get("gather_fixed", "").splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name, spill = m.group(1), ""
        elif "spill" in line:
            spill = line.strip()
        elif name and "registers" in line:
            used = re.search(r"Used \d+ registers", line).group(0)
            log(f"[build] ptxas gather_fixed: {name}: {used}; {spill}")

    # the criterion's fused normal on the voxel cube's shape, before anything else holds the card
    prior = run_normal_prior_phase(dev, card, cuda_ms, bound)
    fconv = run_fft_conv_phase(dev, card, cuda_ms, bound)
    conv_paths = {"fft_conv_phase": sum(r["launches"] for r in fconv.values())}
    wspec = run_window_spectrum_phase(dev, card, cuda_ms, bound)

    # 3. host tables: cold into a fresh cache directory, then a cache hit --
    bands = args.bands.split(",") if args.bands else None
    cache_dir = tempfile.mkdtemp(prefix="surfh_table_cache_")  # read again by [sharded]'s two ranks
    atexit.register(shutil.rmtree, cache_dir, True)
    os.environ["SURFH_TABLE_CACHE"] = cache_dir
    try:
        t0 = time.perf_counter()
        setup = make_flagship_setup(bands=bands)
        model, _ = make_flagship_model(setup, dtype=np.float32, workers=WORKERS)
        t_host = time.perf_counter() - t0
        t0 = time.perf_counter()
        hit, _ = make_flagship_model(setup, dtype=np.float32, workers=WORKERS)
        t_hit = time.perf_counter() - t0
        cache_file = model.table_cache_path()
        cache_gb = os.path.getsize(cache_file) / 1e9
        same = tables_equal(hit.host_tables(), model.host_tables()) and hit.conv_supports == model.conv_supports
        check(not model.table_cache_hit and hit.table_cache_hit and same,
              f"host-table cache: cold {model.table_cache_hit}, hit {hit.table_cache_hit}, bit-equal {same}")
        del hit
    finally:
        os.environ["SURFH_TABLE_CACHE"] = "0"  # the later models neither read nor write one
    n_pt = sum(c.oshape[0] for c in model.channels)
    log(f"[host] {len(model.channels)} bands {setup['bands']}, cube {model.cube_shape}, "
        f"maps {model.ishape}, y {model.oshape[0]}: host tables in {t_host:.2f} s "
        f"({WORKERS} workers, cold, written to a fresh cache directory: {cache_gb:.3f} GB); "
        f"again as a cache hit in {t_hit:.2f} s, tables and supports bit for bit the cold build's")
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
        st = gather_row_stats(dev, proto, cuda_ms, gen, bound, tb[name][0].to(dev, torch.float32), q,
                              f"{model.channels[c_big].instr.name} {name}", tol_kernel)
        kern["err"] = max(kern["err"], st["err"])
        for k in ("ms", "plain_ms", "library_ms", "bound_ms"):
            kern[k] += st[k]

    # the W-plane path's shapes: every band's pointing-0 gather and transpose at Q = W
    log(f"[kernel] {card}: gather_rows at Q = W, pointing 0 of every band (ms; share = byte bound / kernel)")
    for chan, tc in zip(model.channels, host["chan"]):
        for name in ("gather_fwd", "gather_t"):
            gather_row_stats(dev, proto, cuda_ms, gen, bound, tc[name][0].to(dev, torch.float32),
                             chan.n_wslice, f"  {chan.instr.name} {name} at Q = W", tol_kernel)
    # base pointers one float into their storage: no 16-byte alignment to lean on
    plan = tb["gather_t"][0].to(dev, torch.float32)
    w_q = 4 * (model.channels[c_big].n_wslice // 4)
    src = torch.rand(plan.n_src * w_q + 1, generator=gen, device=dev)[1:].view(plan.n_src, w_q)
    check(src.data_ptr() % 16 == 4 and src.is_contiguous(), "misaligned source view")
    err = rel(gr.gather_rows_cuda(src, plan), gr.gather_rows_reference(src, plan))
    ms_k = cuda_ms(lambda: gr.gather_rows_cuda(src, plan), 50)
    src_a = src.clone()  # the same rows from an aligned base: float4 columns
    ms_a = cuda_ms(lambda: gr.gather_rows_cuda(src_a, plan), 50)
    log(f"[kernel] {model.channels[c_big].instr.name} gather_t at Q = {w_q} from a base one float into "
        f"its storage, launch shape {gr.gather_launch_shape(w_q, False, plan.nnz / plan.n_rows)}: max rel err "
        f"{err:.3e}; kernel {ms_k:.4f} ms (from an aligned base, "
        f"{gr.gather_launch_shape(w_q, True, plan.nnz / plan.n_rows)}: {ms_a:.4f} ms)")
    check(err <= tol_kernel, f"kernel vs plain on a misaligned base: {err:.3e}")
    del src, src_a, plan

    # 5. the prototype entry point as a user runs it, counted; every band ---
    # its defaults: band 1c alone, one pointing, 501², Q = W = 466 (float2 in K1 / K3)
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

    # a NaN in src[0]: K1 and K3 sum every tap, so it reaches the rows with
    # a padded tap (fewer than L taps) and those whose taps name row 0, as in
    # the plain versions; K2 reads no padded tap
    ngen = torch.Generator(device=dev).manual_seed(1)  # leaves `gen`'s draws for the later phases as they were
    for chan, band in zip(model.channels, setup["bands"]):
        csrc, cw, cdst, P, n_out, W = proto.transpose_taps(chan)
        fplan = gf.build_fixed_fanin_plan(csrc, cw, cdst, P, n_out, ld=W).to(dev, torch.float32)
        src = torch.rand((n_out, W), generator=ngen, device=dev)
        src[0] = float("nan")
        names0 = np.zeros(P, bool)
        names0[cdst[csrc == 0]] = True
        padded = (fplan.cnt[:P] < fplan.L).cpu().numpy()
        seen = {}
        for k, kfn, pfn, want in (
                ("K1", gf.gather_fixed_k1_cuda, gf.gather_fixed_k1_reference, padded | names0),
                ("K2", gf.gather_fixed_k2_cuda, gf.gather_fixed_k2_reference, names0),
                ("K3", gf.gather_fixed_k3_cuda, gf.gather_fixed_k3_reference, padded | names0)):
            got, ref = kfn(src, fplan), pfn(src, fplan)
            nan_rows = torch.isnan(got).any(1).cpu().numpy()
            same = torch.equal(torch.isnan(got), torch.isnan(ref))
            seen[k] = int(nan_rows.sum())
            check(same and np.array_equal(nan_rows, want) and bool(torch.isnan(got[torch.as_tensor(want, device=dev)]).all()),
                  f"{band} {k}: NaN in src[0] reaches {seen[k]} rows, expected {int(want.sum())} "
                  f"(as the plain version: {same})")
        log(f"[proto] {band}: NaN in src[0] reaches rows K1 {seen['K1']}, K2 {seen['K2']}, K3 {seen['K3']} of "
            f"{P} ({int(padded.sum())} with a padded tap, {int(names0.sum())} naming row 0), as the plain "
            f"versions")
        del src, fplan

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
    fused.reset_launches()
    t0 = time.perf_counter()
    y = model.forward(truth)
    crit = QuadCriterion_MRS(1.0, y, model, mu_reg)
    b = crit.b
    res = crit.run_method("lcg", maximum_iterations=10, return_state=True)
    sync()
    t_main = time.perf_counter() - t0
    main_launches, prior_paths = gr.launches, {"rank": fused.launches}
    expect = 2 * n_pt + 2 * n_pt * (res.n_iter + 1)
    gn = res.grad_norm
    log(f"[slice] main path (y, b, {res.n_iter} lcg it, mu_reg={mu_reg:g}) in {t_main:.3f} s; "
        f"gather_rows launches {main_launches} (expected {expect}); fused normal launches "
        f"{prior_paths['rank']} (expected {res.n_iter + 1}); grad norms {gn.tolist()}")
    check(main_launches == expect and main_launches > 0, "main-path launches")
    check(prior_paths["rank"] == res.n_iter + 1, "main-path fused normal launches")
    check_prior_route(crit, truth, "[slice]")
    check(bool(torch.isfinite(b).all()) and bool(torch.isfinite(res.x).all()), "b, x finite")
    check(res.n_iter == 10 and bool(np.isfinite(gn).all()) and gn[-1] < gn[0], "grad norms finite, falling")
    # the reference's dispatch loop: ‖r‖ read at the end only, the same iterates
    dres = crit.run_method("lcg", maximum_iterations=10, solver_loop="dispatch")
    sync()
    same_x = torch.equal(dres.x, res.x)
    log(f"[slice] lcg dispatch loop: {dres.n_iter} it, iterate bit for bit the graph loop's {same_x}, "
        f"grad norms equal {np.array_equal(dres.grad_norm, gn)}")
    check(same_x and dres.n_iter == res.n_iter and np.array_equal(dres.grad_norm, gn),
          "lcg dispatch loop against the graph loop")
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

    # 8. both banded kernels against their plain versions, every band ------
    wt = wmodel.tables["chan"]
    c_w = max(range(len(wt)), key=lambda c: wt[c]["band"].plan.K * wt[c]["band"].plan.LB
              * wt[c]["band"].plan.B * wmodel.channels[c].oshape[1] * wmodel.channels[c].oshape[3])
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    bkern = {}
    for c, chan in enumerate(wmodel.channels):
        bt = wt[c]["band"]
        _, S_, K_, A_ = chan.oshape
        win = torch.rand((S_ * A_, bt.plan.B * bt.plan.W), generator=gen, device=dev)
        y2d = torch.rand((S_ * A_, K_), generator=gen, device=dev)
        shape = wb.forward_launch_shape(S_ * A_, bt.plan, n_sm)
        tshape = wb.transpose_launch_shape(S_ * A_, bt.plan_t, n_sm)
        for name, kfn, pfn, arg, table, starts, lib in (
                ("wblur_banded", wb.wblur_banded_cuda, wb.wblur_banded_reference, win, bt.blocks,
                 bt.starts, lambda: torch.matmul(win, bt.rows.T)),
                ("wblur_banded_t", wb.wblur_banded_t_cuda, wb.wblur_banded_t_reference, y2d,
                 bt.blocks_t, bt.starts_t, lambda: torch.matmul(y2d, bt.rows_t))):
            out_k, out_p = kfn(arg, bt), pfn(arg, bt)
            same = torch.equal(out_k, kfn(arg, bt))
            sync()
            err = rel(out_k, out_p)
            ms_k = cuda_ms(lambda: kfn(arg, bt), 50)
            ms_p = cuda_ms(lambda: pfn(arg, bt), 50)
            ms_l = cuda_ms(lib, 50)  # one cuBLAS call on the masked dense table
            terms = bt.plan.B * bt.plan.LB if name == "wblur_banded" else bt.plan_t.KB
            flops = 2.0 * arg.shape[0] * out_k.shape[1] * terms
            nbytes = 4.0 * (arg.numel() + table.numel() + starts.numel() + out_k.numel())
            b_ms, b_by = bound(nbytes, flops)
            cut = (f"split {shape.split} of B = {bt.plan.B}, {shape.blocks} blocks on {n_sm} SMs, "
                   f"{shape.scratch * 4 / 1e6:.2f} MB of partial sums; " if name == "wblur_banded" else
                   f"row tile {tshape.bm}, {tshape.cg} column groups ({8 * tshape.cg} columns for "
                   f"n = {bt.plan_t.B * bt.plan_t.TL}{'' if tshape.vec else ', general instance'}), "
                   f"{tshape.blocks} blocks of {tshape.threads} threads on {n_sm} SMs; ")
            log(f"[kernel] {chan.instr.name} {name}: [{arg.shape[0]} x {arg.shape[1]}] -> "
                f"[{out_k.shape[0]} x {out_k.shape[1]}], {terms} terms per output: {cut}max rel err {err:.3e} "
                f"(bound {tol_kernel:g}, f32 sums in another order), repeat bit-identical {same}; kernel "
                f"{ms_k:.4f} ms ({flops / (ms_k * 1e-3) / 1e12:.2f} TFLOP/s of banded work), plain (cuBLAS "
                f"on the masked table) {ms_p:.4f} ms, library torch.matmul on the masked table {ms_l:.4f} ms; "
                f"bound {b_ms:.4f} ms by {b_by} ({flops / 1e9:.3f} GFLOP, {nbytes / 1e6:.2f} MB; "
                f"{100 * b_ms / ms_k:.1f} % of the kernel's time)")
            check(err <= tol_kernel, f"kernel vs plain {chan.instr.name} {name}: {err:.3e} > {tol_kernel:g}")
            check(same, f"{chan.instr.name} {name}: two launches on one input differ")
            if c == c_w:
                bkern[name] = {"err": float((out_k - out_p).abs().max()), "ms": ms_k, "plain_ms": ms_p,
                               "library_ms": ms_l, "bound_ms": b_ms, "bound_by": b_by}
        del win, y2d, out_k, out_p

    # 9. the W-plane path at full width ------------------------------------
    torch.cuda.reset_peak_memory_stats(dev)
    cube = wmodel.mapsToCube(truth)
    t_lmm = cuda_ms(lambda: wmodel.mapsToCube(truth), 5)
    chunks = fft.conv_otf_chunks(cube, sotf)
    t_fft = cuda_ms(lambda: fft.conv_otf_chunks(cube, sotf), 5)
    n_c = len(wmodel.channels)
    rows = [wmodel.patch_rows(chunks, c) for c in range(n_c)]
    t_rel = cuda_ms(lambda: [wmodel.patch_rows(chunks, c) for c in range(n_c)], 5)
    t_rel_t = cuda_ms(lambda: [wmodel.add_patch_rows_(cube, rows[c], c) for c in range(n_c)], 5)
    log(f"[wplane] {card}: T (maps -> cube {tuple(cube.shape)}) {t_lmm:.3f} ms; FFT stage "
        f"(kernel #8: rows r2c, columns x sotf, rows c2r, {fft.CONV_OTF_CHUNK}-plane chunks out, the cube "
        f"read) {t_fft:.3f} ms per "
        f"direction; bbox relayout [W, ha, wb] -> [ha*wb, W] {t_rel:.3f} ms, back (add into "
        f"the cube) {t_rel_t:.3f} ms, all {n_c} bands; peak {torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")
    del cube, chunks, rows

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
        f"band and pointing and direction); the forward's add-the-parts pass, counted apart: "
        f"{wb.launches_sum}")
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
    fused.reset_launches()
    fc.reset_launches()
    t0 = time.perf_counter()
    y_w = wmodel.forward(truth)
    wcrit = QuadCriterion_MRS(1.0, y_w, wmodel, mu_reg)
    wres = wcrit.run_method("lcg", maximum_iterations=10, return_state=True)
    sync()
    t_wmain = time.perf_counter() - t0
    wmain = (gr.launches, wb.launches, wb.launches_t)
    prior_paths["wplane"] = fused.launches
    conv_paths["wplane"] = fc.launches
    n_app = wres.n_iter + 1
    expect_w = (2 * n_pt + 2 * n_pt * n_app, n_pt * (1 + n_app), n_pt * (1 + n_app))
    # kernel #8 with templates: the maps' two passes and two a λ-chunk, each
    # direction; a direction for y, one for Hᵗy and two a normal
    per_dir = 2 + 2 * -(-wmodel.cube_shape[0] // fft.CONV_OTF_CHUNK)
    expect_conv = per_dir * (2 + 2 * n_app)
    wgn = wres.grad_norm
    log(f"[wplane] main path (y, b, {wres.n_iter} lcg it, mu_reg={mu_reg:g}) in {t_wmain:.3f} s; "
        f"launches gather_rows / wblur_banded / wblur_banded_t {wmain} (expected {expect_w}; "
        f"add-the-parts passes {wb.launches_sum}); fused normal launches {prior_paths['wplane']} "
        f"(expected {n_app}); fft_conv launches {conv_paths['wplane']} (expected {expect_conv}: "
        f"{per_dir} a direction); grad norms {wgn.tolist()}")
    check(wmain == expect_w and min(wmain) > 0, "W-plane main-path launches")
    check(prior_paths["wplane"] == n_app, "W-plane main-path fused normal launches")
    check(conv_paths["wplane"] == expect_conv, "W-plane main-path fft_conv launches")
    check_prior_route(wcrit, truth, "[wplane]")
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
    del wcrit, wres, wres2, y_b, y_w, xr, yr
    torch.cuda.empty_cache()

    # [sharded], [lambda], [mesh2d]: both models over torch.distributed
    t0 = time.perf_counter()
    shard = run_sharded_phase(dev, card, cuda_ms, gen, model, wmodel, setup, truth, mu_reg, bands,
                              cache_dir)
    log(f"[sharded] phases [sharded], [lambda], [mesh2d] in {time.perf_counter() - t0:.2f} s; "
        f"gather_rows launches on the sharded solve {shard['launches']}, the two ranks' "
        f"{shard['two_rank_launches']}, λ {shard['lambda_launches']}, 2-D {shard['mesh2d_launches']}")

    # 10. the dense window-local flagship and its OTF-window variant -------
    t0 = time.perf_counter()
    wl = run_wlocal_phase(dev, card, cuda_ms, gen, bound, model, setup, wmodel, wsetup, truth, mu_reg)
    log(f"[wlocal] phase in {time.perf_counter() - t0:.2f} s; gather_rows launches on its main path "
        f"{wl['launches']}")
    del wmodel, y_d
    torch.cuda.empty_cache()

    # [nn]: nearest-neighbour gridding on the W-plane flagship, the same OTF
    t0 = time.perf_counter()
    nn = run_nn_phase(dev, card, cuda_ms, gen, bound, proto, model.channels, wsetup, truth, mu_reg)
    log(f"[nn] phase in {time.perf_counter() - t0:.2f} s; gather_rows launches on its main path "
        f"{nn['launches']}")
    del wsetup, sotf
    torch.cuda.empty_cache()

    # [staged]: one band's channel composed, staged and with the FFT box-sum
    t0 = time.perf_counter()
    c_st = next((c for c in model.channels if c.instr.name.lower().startswith("1c")), model.channels[0])
    staged = run_staged_phase(dev, card, cuda_ms, gen, bound, proto, c_st)
    log(f"[staged] phase in {time.perf_counter() - t0:.2f} s")

    # [channel-banded]: band 2c's Channel with the banded blur on cubes
    t0 = time.perf_counter()
    cband = run_channel_banded_phase(dev, card, cuda_ms, gen, model)
    log(f"[channel-banded] phase in {time.perf_counter() - t0:.2f} s")

    # [family], [mixing]: the operator family and the mixing path at band 1c's full width
    t0 = time.perf_counter()
    fam = run_family_phase(dev, card, cuda_ms, gen, bound, proto, model)
    log(f"[family] phase in {time.perf_counter() - t0:.2f} s; gather_rows launches on the entry "
        f"point's run {fam['launches']}")
    t0 = time.perf_counter()
    run_mixing_phase(dev, card, cuda_ms, gen)
    log(f"[mixing] phase in {time.perf_counter() - t0:.2f} s")

    # 11. small inputs against the CPU f64 operators -----------------------
    for mode, kw in (("rank", dict(im_size=41, n_lambda=120, n_tpl=2, window_local=True, psf_stamps=True,
                                   conv_freq_rtol=1e-6, conv_rank_rtol=1e-7)),
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

    # [deconv2d], [deconv-cube]: BASELINE configs 1 and 2 through the port's CLI
    deconv = {}
    for name in DECONV_ARGV:
        t0 = time.perf_counter()
        deconv[name] = run_deconv_phase(dev, card, cuda_ms, gen, bound, proto, name)
        log(f"[{name}] phase in {time.perf_counter() - t0:.2f} s; gather_rows launches "
            f"{deconv[name]['launches']}")

    # 12. the real-data path through the port's CLI, band 1c at full width --
    t0 = time.perf_counter()
    pipe = run_pipeline_phase(dev, card, cuda_ms, gen)
    log(f"[pipeline] phase in {time.perf_counter() - t0:.2f} s; gather_rows launches on the "
        f"rehearsal {pipe['launches']}")

    # 13. the all-band path through the port's CLI at full width ----------
    t0 = time.perf_counter()
    allb = run_allband_phase(dev, card, cuda_ms, gen, bound)
    log(f"[allband] phase in {time.perf_counter() - t0:.2f} s; gather_rows launches on the "
        f"allband run {allb['launches']}")

    # 14. the same, window-local (`allband --window-local`) ----------------
    t0 = time.perf_counter()
    allb_wl = run_allband_phase(dev, card, cuda_ms, gen, bound, window_local=True)
    log(f"[allband-wl] phase in {time.perf_counter() - t0:.2f} s; gather_rows launches on the "
        f"allband --window-local run {allb_wl['launches']}")

    # 15. gen-psf and the diffraction flagship ---------------------------
    t0 = time.perf_counter()
    run_psf_phase(dev, card, cuda_ms, gen, model.channels, bands)
    log(f"[psf] phase in {time.perf_counter() - t0:.2f} s")

    # [config4], [warmup]: BASELINE config 4 sharded through torchrun; warmup
    t0 = time.perf_counter()
    run_config4_phase(dev, card, cuda_ms)
    log(f"[config4] phase in {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    run_warmup_phase(card)
    log(f"[warmup] phase in {time.perf_counter() - t0:.2f} s")

    # [bench], [flagship-cg], [quality], [audit], [tools]: the repo's entry
    # points, the flagship's tables from [host]'s cache
    t0 = time.perf_counter()
    bench = run_bench_phase(dev, card, model, truth, cache_dir, t_app)
    log(f"[bench] phase in {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    scripts = run_measure_scripts_phase(dev, card, model, bands, cache_dir)
    log(f"[flagship-cg] [quality] [audit] phases in {time.perf_counter() - t0:.2f} s")
    shutil.rmtree(cache_dir, ignore_errors=True)
    t0 = time.perf_counter()
    tools = run_tools_phase(dev, card, pipe["stage2_dir"])
    log(f"[tools] phase in {time.perf_counter() - t0:.2f} s")
    gather_paths = {"rank": main_launches, "wplane": wmain[0], "wlocal": wl["launches"],
                    "pipeline": pipe["launches"], "allband": allb["launches"],
                    "allband_wl": allb_wl["launches"], "deconv2d": deconv["deconv2d"]["launches"],
                    "deconv_cube": deconv["deconv-cube"]["launches"], "nn": nn["launches"],
                    "staged": staged["launches"], "channel_banded": cband["launches"][0],
                    "family": fam["launches"],
                    "sharded": shard["launches"], "sharded_two_rank": shard["two_rank_launches"],
                    "sharded_wplane": shard["wplane_launches"][0], "lambda": shard["lambda_launches"],
                    "mesh2d": shard["mesh2d_launches"],
                    **{f"bench_{tag}": b["launches"][0] for tag, b in bench.items()},
                    **scripts, **tools}
    check(all(gather_paths.values()), f"a path launched no row gather: {gather_paths}")
    prior_paths.update(deconv2d=deconv["deconv2d"]["prior_launches"],
                       deconv_cube=deconv["deconv-cube"]["prior_launches"])

    log(json.dumps({"kernels": [{
        "name": "gather_rows",
        "route": "cuda",
        "source": "surfh_tpu_torch/csrc/gather_rows.cu",
        "replaces": "surfh_tpu/core/scatter_pallas.py:138",
        "launches": sum(gather_paths.values()),
        "launches_by_path": gather_paths,
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
        "launches": launches + shard_launches + bench_launches + cband_launches,
        "launches_by_path": {"wplane": launches, "sharded_wplane": shard_launches,
                             "bench_medium-banded": bench_launches,
                             "channel_banded": cband_launches},
        "max_abs_err": bkern[name]["err"],
        "ms": bkern[name]["ms"],
        "plain_ms": bkern[name]["plain_ms"],
        "bound_ms": bkern[name]["bound_ms"],
        "bound_by": bkern[name]["bound_by"],
        "library_ms": bkern[name]["library_ms"],
    } for name, replaces, launches, shard_launches, bench_launches, cband_launches in (
        ("wblur_banded", "surfh_tpu/core/wblur_pallas.py:102", wmain[1], shard["wplane_launches"][1],
         bench["medium-banded"]["launches"][1], cband["launches"][1]),
        ("wblur_banded_t", "surfh_tpu/core/wblur_pallas.py:227", wmain[2],
         shard["wplane_launches"][2], bench["medium-banded"]["launches"][2],
         cband["launches"][2]))] + [{
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
        ("K3", "scripts/scatter_pallas_proto.py:185", proto_launches[2]))] + [{
        "name": "normal_prior",
        "route": "cuda",
        "source": "surfh_tpu_torch/csrc/normal_prior.cu",
        "replaces": None,  # the eager chain of QuadCriterion_MRS.normal_op; XLA fuses it on the TPU
        "launches": sum(prior_paths.values()),
        "launches_by_path": prior_paths,
        "max_abs_err": 0.0,
        "ms": prior["ms"],
        "plain_ms": prior["plain_ms"],
        "bound_ms": prior["bound_ms"],
        "bound_by": "bytes",
    }] + [{
        "name": "fft_conv",
        "route": "cuda",
        "source": "surfh_tpu_torch/csrc/fft_conv.cu",
        "replaces": None,  # cuFFT's rfft2 / irfft2 and the OTF product; XLA's FFT on the TPU
        "launches": sum(conv_paths.values()),
        "launches_by_path": conv_paths,
        "max_rel_err": fconv["cube direction"]["err"],
        "ms": fconv["cube direction"]["ms"],
        "plain_ms": fconv["cube direction"]["plain_ms"],
        "bound_ms": fconv["cube direction"]["bound_ms"],
        "bound_by": fconv["cube direction"]["bound_by"],
        "library_ms": fconv["cube direction"]["library_ms"],
    }] + [{
        "name": f"fft_conv {name}",
        "route": "cuda",
        "source": "surfh_tpu_torch/csrc/fft_conv.cu",
        "replaces": None,  # cuFFT's rfft2 / irfft2 and the OTF product; XLA's FFT on the TPU
        "launches": r["launches"],
        "max_rel_err": r["err"],
        "ms": r["ms"],
        "plain_ms": r["plain_ms"],
        "bound_ms": r["bound_ms"],
        "bound_by": r["bound_by"],
        "library_ms": r["library_ms"],
    } for name, r in fconv.items()] + [{
        "name": f"window_spectrum {name}",
        "route": "cuda",
        "source": "surfh_tpu_torch/csrc/window_spectrum.cu",
        "replaces": None,  # the dense window conv's eager mix, OTF product and Gauss-3M adds; XLA fuses them
        "launches": wl["spectrum_launches"][0],
        "launches_by_path": {"wlocal": wl["spectrum_launches"][0]},
        "max_rel_err": r["err"],
        "ms": r["ms"],
        "plain_ms": r["plain_ms"],
        "bound_ms": r["bound_ms"],
        "bound_by": r["bound_by"],
    } for name, r in wspec.items()]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
