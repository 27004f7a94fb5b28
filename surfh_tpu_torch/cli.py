"""Command-line entry points of the port (argparse; no click).

Counterpart of `surfh_tpu/cli.py`: the same subcommand names, options,
defaults and JSON last line for `fusion` (real data, or `--simulated`),
`rehearse`, `allband`, `deconv2d`, `deconv-cube`, `make-cube`,
`compare-flux`, `gen-psf`, `metadata`, `warmup` and `info`, with
``--method lcg|mmmg``.  Everything runs on the card; ``SURFH_CPU=1`` (the
reference's switch) runs it on the host CPU instead.  Without a card and
without that switch, every subcommand raises.

``fusion --simulated --sharded`` shards the bands over the processes of a
``torch.distributed`` world (`parallel.ShardedSpectro`): one process runs
it at world 1; under ``torchrun --standalone --nproc-per-node N -m
surfh_tpu_torch.cli fusion --simulated --sharded …`` each of the N ranks
drives ``cuda:LOCAL_RANK`` (the CPU under SURFH_CPU), and rank 0 alone
prints the report and writes the outputs.

Usage:
    python -m surfh_tpu_torch.cli rehearse --band 1c --pointings 4 -np 501 --step 0.025 \\
        --lambda-subsample 1
    python -m surfh_tpu_torch.cli fusion --fusion-data DIR -np 501 -m mmmg
    python -m surfh_tpu_torch.cli allband -np 501 -ni 50 --nmf-iter 300
    python -m surfh_tpu_torch.cli deconv2d -np 301 -ni 200 -hp 500 --rotated
    python -m surfh_tpu_torch.cli deconv-cube -np 301 -nl 100 --pointings 2 -ni 100 -hp 5
    python -m surfh_tpu_torch.cli gen-psf --band 1c --opd commissioning -o psf.npy
    torchrun --standalone --nproc-per-node 1 -m surfh_tpu_torch.cli fusion --simulated \
        --sharded -nc 3 --pointings 4 -np 501 -nt 4 -ni 50 -hp 5e3
    python -m surfh_tpu_torch.cli warmup --bands 1c,2a --programs fwd,adj,normal
    SURFH_CPU=1 python -m surfh_tpu_torch.cli fusion --simulated -np 31 --n-lambda 16
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys
import time
from typing import List, Optional

import numpy as np
import torch

from .core.precision import require_cuda

logger = logging.getLogger("surfh_tpu_torch")


def _device() -> torch.device:
    """The card, or the host CPU under ``SURFH_CPU`` (any non-empty value)."""
    if os.environ.get("SURFH_CPU"):
        return torch.device("cpu")
    return require_cuda()


def _emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def cmd_fusion(args, parser) -> None:
    """Multi-channel multi-observation LMM fusion (the flagship run)."""
    logging.basicConfig(level=logging.DEBUG if args.verbose else logging.INFO,
                        format="%(asctime)s %(name)s %(levelname)s %(message)s")
    if not args.simulated and args.fusion_data is None:
        parser.error("provide --fusion-data DIR or --simulated")
    if args.sharded and args.simulated:
        import torch.distributed as dist

        from .parallel.fusion import make_mesh

        own_world = not dist.is_initialized()
        mesh = make_mesh()  # joins the launcher's world (or makes one of 1), takes LOCAL_RANK's card
        try:
            _simulated_fusion(args, mesh)
        finally:
            if own_world:
                dist.destroy_process_group()
        return
    if not args.simulated:
        from .pipeline import run_real_fusion

        device = _device()
        os.makedirs(args.output_dir, exist_ok=True)
        slices = os.path.join(args.fusion_data, "Filtered_slices")
        bands = sorted({f.split("_")[0].lower() for f in os.listdir(slices) if f.endswith(".fits")})
        logger.info("real-data fusion: bands %s", bands)
        res, _model = run_real_fusion(
            args.fusion_data, bands, npix=args.npix, mu=args.hyper_parameter,
            niter=args.niter, method=args.method, scale_data=args.scale_data,
            output_dir=args.output_dir, checkpoint_every=args.checkpoint_every,
            device=device,
        )
        _emit({"method": args.method, "niter": int(res.n_iter),
               "final_grad_norm": float(res.grad_norm[-1])})
        return
    _simulated_fusion(args, None)


def _simulated_fusion(args, mesh) -> None:
    """`fusion --simulated`, unsharded (`mesh` None: the criterion's
    checkpointed solve) or sharded over `mesh` (rank 0 reports and writes)."""
    from .simulation.synthetic import make_model
    from .solvers.checkpoint import run_checkpointed
    from .solvers.criterion import QuadCriterion_MRS
    from .utils import metrics

    device = _device()
    lead = mesh is None or mesh.get_rank() == 0
    if lead:
        os.makedirs(args.output_dir, exist_ok=True)
    logger.info("building simulated model: %d² grid, %dλ, %d bands, %d pointings",
                args.npix, args.n_lambda, args.channels, args.pointings)
    model, setup = make_model(
        dtype=np.float32, window_local=False, im_size=args.npix, n_lambda=args.n_lambda,
        n_tpl=args.n_templates, n_channels=args.channels, n_pointings=args.pointings,
    )
    model.to(device, torch.float32)
    truth = np.asarray(setup["maps"], np.float32)
    t0 = time.perf_counter()
    y = model.forward(truth).cpu().numpy()
    if args.noise_snr > 0:
        rng = np.random.default_rng(0)
        sigma = np.sqrt(np.mean(y**2) / 10 ** (args.noise_snr / 10))
        y = y + rng.normal(0, sigma, y.shape).astype(y.dtype)
    logger.info("data synthesized in %.2fs (%d samples)", time.perf_counter() - t0, y.size)

    t0 = time.perf_counter()
    ckpt_path = os.path.join(args.output_dir, "solver_state.npz")
    if mesh is not None:
        from .parallel.fusion import ShardedSpectro

        res = _sharded_solve(ShardedSpectro(model, mesh), y, args, ckpt_path, lead)
    else:
        crit = QuadCriterion_MRS(1.0, y, model, args.hyper_parameter, printing=args.verbose)
        res = run_checkpointed(crit, method=args.method, niter=args.niter,
                               checkpoint_path=ckpt_path, checkpoint_every=args.checkpoint_every)
    x = res.x.cpu().numpy()
    dt = time.perf_counter() - t0
    if not lead:
        return
    logger.info("%s: %d iterations in %.2fs (%.2f it/s)", args.method, res.n_iter, dt,
                res.n_iter / max(dt, 1e-9))

    np.save(os.path.join(args.output_dir, "res_x.npy"), x)
    np.save(os.path.join(args.output_dir, "res_cube.npy"), model.mapsToCube(res.x).cpu().numpy())
    np.save(os.path.join(args.output_dir, "criterion.npy"), res.grad_norm)
    _emit({
        "method": args.method,
        "niter": int(res.n_iter),
        "seconds": dt,
        "iters_per_s": res.n_iter / max(dt, 1e-9),
        "psnr_maps": metrics.psnr(truth, x),
        "relative_error_pct": metrics.relative_error(truth, x),
    })


def _sharded_solve(sh, y, args, ckpt_path: str, lead: bool):
    """`ShardedSpectro.solve` for `fusion --sharded`: in one go, or (lcg with
    ``--checkpoint-every``) in segments that carry the solver state, rank 0
    alone writing the checkpoint, every rank resuming from it."""
    from .solvers.cg import SolverResult
    from .solvers.checkpoint import load_checkpoint, save_checkpoint

    kw = dict(mu_reg=args.hyper_parameter, method=args.method)
    if args.checkpoint_every <= 0 or args.method != "lcg":
        return sh.solve(y, max_iter=args.niter, **kw)
    done, hist, x, state = 0, [], None, None
    ck = load_checkpoint(ckpt_path)
    if ck is not None and ck["n_iter_done"] > 0:
        done, hist, x = min(ck["n_iter_done"], args.niter), list(ck["grad_norm"]), ck["x"]
        state = tuple(torch.as_tensor(np.asarray(a)).to(sh.device, sh.dtype)
                      for a in ck.get("state") or ()) or None
    res = None
    while done < args.niter:
        step = min(args.checkpoint_every, args.niter - done)
        res = sh.solve(y, max_iter=step, x0=x, state=state, return_state=True, **kw)
        x, state = res.x, res.state
        done += res.n_iter if res.n_iter > 0 else step
        hist.extend(res.grad_norm.tolist())
        if lead:
            save_checkpoint(ckpt_path, x, done, hist, state=state)
        if res.converged and res.n_iter < step:
            break
    if x is None:  # --niter 0: the solve's start
        x = torch.zeros(sh.model.ishape, device=sh.device, dtype=sh.dtype)
    return SolverResult(x=x, grad_norm=np.asarray(hist), n_iter=done,
                        converged=True if res is None else res.converged)


def _blobs(npix: int, rng) -> np.ndarray:
    """The deconvolution commands' truth image: six Gaussian blobs (the
    reference's draws, in its order, from `rng`)."""
    truth = np.zeros((npix, npix), np.float32)
    for _ in range(6):
        cx, cy = rng.integers(10, npix - 10, 2)
        s = rng.uniform(2, 6)
        yy, xx = np.mgrid[0:npix, 0:npix]
        truth += rng.uniform(0.5, 2) * np.exp(-((xx - cx) ** 2 + (yy - cy) ** 2) / (2 * s * s))
    return truth


def cmd_deconv_cube(args, parser) -> None:
    """λ-stack no-rotation cube deconvolution (BASELINE config 2): the
    rectangle-gridded (or rotated) 2-D model on every λ plane with that
    plane's PSF, all planes in one batched operator, the separated
    quadratic criterion, lcg."""
    from .core.fft import ir2fr
    from .models.blind2d import DeconvCube, MRSBlurred, MRSBlurredRectangle
    from .simulation.synthetic import make_setup
    from .solvers.criterion import QuadCriterion_MRS
    from .utils import metrics

    device = _device()
    npix, n_lambda = args.npix, args.n_lambda
    os.makedirs(args.output_dir, exist_ok=True)
    setup = make_setup(im_size=npix, n_lambda=n_lambda, n_channels=1, n_pointings=args.pointings)
    sotf_stack = np.stack([ir2fr(p, setup["im_shape"]) for p in setup["spsf"][:n_lambda]])
    cls = MRSBlurredRectangle if args.rectangle else MRSBlurred
    base = cls(sotf_stack[0], setup["alpha_axis"], setup["beta_axis"], setup["instrs"][0],
               setup["step_degree"], setup["pointings"][0], device=device)
    model = DeconvCube(base, sotf_stack)

    rng = np.random.default_rng(1)
    img = _blobs(npix, rng)
    spectra = 0.5 + rng.random(n_lambda).cumsum() / n_lambda
    truth = spectra[:, None, None].astype(np.float32) * img
    y = model.forward(truth)

    t0 = time.perf_counter()
    crit = QuadCriterion_MRS(1.0, y, model, args.hyper_parameter, gradient="separated")
    res = crit.run_method("lcg", maximum_iterations=args.niter)
    x = res.x.cpu().numpy()
    dt = time.perf_counter() - t0

    np.save(os.path.join(args.output_dir, "deconv_cube_x.npy"), x)
    _emit({
        "n_lambda": n_lambda,
        "niter": int(res.n_iter),
        "seconds": dt,
        "iters_per_s": res.n_iter / max(dt, 1e-9),
        "psnr": metrics.psnr(truth, x.reshape(model.ishape)),
    })


def cmd_deconv2d(args, parser) -> None:
    """Single-wavelength 2-D MRS deconvolution (BASELINE config 1, the
    reference's scripts/deconvolution_mrs_single_wavelength.py): the first
    PSF plane, four pointings, the 2-D quadratic criterion, lcg."""
    from .core.fft import ir2fr
    from .models.blind2d import MRSBlurred, MRSBlurredRectangle
    from .simulation.synthetic import make_setup
    from .solvers.criterion import QuadCriterion_MRS_2D
    from .utils import metrics

    device = _device()
    npix = args.npix
    os.makedirs(args.output_dir, exist_ok=True)
    setup = make_setup(im_size=npix, n_lambda=8, n_channels=1, n_pointings=4)
    sotf = ir2fr(setup["spsf"][0], setup["im_shape"])
    cls = MRSBlurredRectangle if args.rectangle else MRSBlurred
    model = cls(sotf, setup["alpha_axis"], setup["beta_axis"], setup["instrs"][0],
                setup["step_degree"], setup["pointings"][0], device=device)
    truth = _blobs(npix, np.random.default_rng(1))
    y = model.forward(truth)

    t0 = time.perf_counter()
    crit = QuadCriterion_MRS_2D(1.0, y, model, args.hyper_parameter)
    res = crit.run_method("lcg", maximum_iterations=args.niter)
    x = res.x.cpu().numpy()
    dt = time.perf_counter() - t0

    np.save(os.path.join(args.output_dir, "deconv2d_x.npy"), x)
    _emit({
        "niter": int(res.n_iter),
        "seconds": dt,
        "psnr": metrics.psnr(truth, x),
    })


def cmd_make_cube(args, parser) -> None:
    """Mix abundance maps with spectral templates into a hyperspectral cube
    (cube[λ] = Σ_m maps[m]·templates[m, λ], on the device)."""
    from .core.lmm import lmm_maps2cube

    maps = np.load(args.maps_path)
    templates = np.load(args.templates_path)
    if templates.ndim == 1:
        templates = templates[np.newaxis, ...]
    if maps.ndim == 2:
        maps = maps[np.newaxis, ...]
    if templates.ndim != 2 or maps.ndim != 3:
        parser.error(f"expected maps (m, Nα, Nβ) and templates (m, λ); got "
                     f"{maps.shape} and {templates.shape}")
    if maps.shape[0] != templates.shape[0]:
        parser.error(f"maps ({maps.shape[0]}) and templates ({templates.shape[0]}) "
                     "disagree on the number of components")
    device = _device()
    dtype = torch.float64 if np.result_type(maps, templates) == np.float64 else torch.float32
    cube = lmm_maps2cube(torch.as_tensor(maps).to(device, dtype),
                         torch.as_tensor(templates).to(device, dtype)).cpu().numpy()
    if args.output.endswith(".fits"):
        from .preprocessing import fits_write

        header = {}
        if args.wavel_path:
            wavel = np.load(args.wavel_path)
            header = {"CRVAL3": float(wavel[0]), "CRPIX3": 1.0,
                      "CDELT3": float(wavel[1] - wavel[0]) if len(wavel) > 1 else 1.0,
                      "CUNIT3": "um", "CTYPE3": "WAVE"}
        fits_write(args.output, cube.astype(np.float32), header=header)
    else:
        np.save(args.output, cube)
    _emit({"cube_shape": list(cube.shape), "output": args.output})


def cmd_compare_flux(args, parser) -> None:
    """Mean-flux comparison of a fused cube vs a real data cube, per λ-slice
    (non-zero mean per slice, optional polygon-region spectrum, λ median
    filter); host NumPy."""
    from .preprocessing import median_filter_slices
    from .utils import metrics

    fused = np.load(args.fusion_cube)
    if args.mask:
        fused = fused * np.load(args.mask)[np.newaxis, ...]
    if args.real_cube.endswith(".npy"):
        real = np.load(args.real_cube)
    else:
        from .preprocessing import fits_open

        hdus = fits_open(args.real_cube)
        real = np.asarray(next(h.data for h in hdus if h.data is not None
                               and np.ndim(h.data) == 3), np.float64)
    real = np.nan_to_num(real)
    if args.median_size:
        real = median_filter_slices(real.reshape(real.shape[0], -1),
                                    size=args.median_size).reshape(real.shape)
    out = {
        "mean_flux_fusion": metrics.nonzero_mean_per_slice(fused),
        "mean_flux_real": metrics.nonzero_mean_per_slice(real),
    }
    if args.region:
        poly = [tuple(map(float, p.split(","))) for p in args.region.split(";")]
        out["region_spectrum"] = metrics.region_mean_spectrum(fused, poly)
    if args.output:
        np.savez(args.output, **out)
    _emit({k: [float(v[0]), float(v[-1])] for k, v in out.items()}
          | {"n_lambda": int(fused.shape[0])})


def cmd_rehearse(args, parser) -> None:
    """The production real-data flow, chained end to end in one command:
    synthetic stage-2 cal.fits → distortion correction (Shepard, slit
    reorder) → median λ-filter → fusion → flux comparison."""
    from .pipeline import run_rehearsal

    device = _device()
    band = args.band
    geo = {}
    if args.header is not None:
        from .preprocessing.metadata import header_geometry

        parsed = header_geometry(args.header)
        geo = {k: parsed[k] for k in ("targ_ra", "targ_dec", "pa_v3")}
        if band is None and parsed["band"]:
            band = parsed["band"]
    for key in ("targ_ra", "targ_dec", "pa_v3"):
        if getattr(args, key) is not None:
            geo[key] = getattr(args, key)
    rep = run_rehearsal(
        args.work_dir, band=band or "4a", n_pointings=args.pointings, npix=args.npix,
        step_arcsec=args.step, lambda_subsample=args.lambda_subsample, mu=args.mu,
        niter=args.niter, method=args.method, noise_rms=args.noise_rms, device=device, **geo,
    )
    _emit(rep)


def cmd_allband(args, parser) -> None:
    """All-band fusion with NMF templates learned on the device (BASELINE
    config 5): simulate the bands' data, co-add a dirty hypercube, learn
    NMF templates, fuse all bands with them, report metrics and per-stage
    timings."""
    from .pipeline import run_allband_simulated

    report = run_allband_simulated(
        npix=args.npix,
        bands=args.bands.split(",") if args.bands else None,
        n_pointings=args.pointings,
        n_templates=args.n_templates,
        mu=args.hyper_parameter,
        niter=args.niter,
        method=args.method,
        nmf_iter=args.nmf_iter,
        output_dir=args.output_dir,
        window_local=args.window_local,
        lambda_subsample=args.lambda_subsample,
        device=_device(),
    )
    _emit(report)


def cmd_gen_psf(args, parser) -> None:
    """Generate a monochromatic JWST diffraction PSF stack [Nλ, npix, npix]
    float32 (`utils.jwst_psf`: the segmented pupil through a matrix Fourier
    transform); `--opd` adds a wavefront map as a pupil phase screen.  On
    the card `psf_stack_device`, under SURFH_CPU the host stack."""
    from .instrument.wavelength_mrs import get_mrs_wavelength
    from .utils.jwst_psf import load_opd, psf_stack, psf_stack_device, recorded_opd

    device = _device()
    wavels = np.load(args.wavel_axis) if args.wavel_axis is not None else get_mrs_wavelength(args.band)
    opd = args.opd
    if opd == "commissioning":
        opd = os.path.join(os.path.dirname(os.path.abspath(__file__)), "instrument", "data",
                           "jwst_opd_commissioning.json")
    if opd and opd.endswith(".json"):
        opd_map = recorded_opd(opd, args.n_pupil)
    elif opd:
        opd_map = load_opd(opd, args.n_pupil, unit=args.opd_unit)
    else:
        opd_map = None
    t0 = time.time()
    kw = dict(npix=args.npix, oversample=args.oversample, n_pupil=args.n_pupil, opd=opd_map)
    if device.type == "cuda":
        stack = psf_stack_device(wavels, args.pixelscale, device=device, **kw)
    else:
        stack = psf_stack(wavels, args.pixelscale, **kw)
    np.save(args.output, stack)
    _emit({
        "n_lambda": int(stack.shape[0]), "npix": args.npix,
        "pixelscale": args.pixelscale, "seconds": round(time.time() - t0, 2),
        "opd_rms_nm": (round(float(np.sqrt(np.mean(opd_map**2))) * 1e9, 3)
                       if opd_map is not None else 0.0),
        "output": args.output,
    })


def cmd_metadata(args, parser) -> None:
    """Header-metadata fix-ups of the real-data correction chain
    (targ-coords, rotation, swap-slits, rank-target), as the reference's
    `metadata` command."""
    from .preprocessing import metadata as md

    op, slice_dirs = args.operation, args.slice_dirs or []
    if op == "targ-coords":
        if not args.raw_dir or not slice_dirs:
            parser.error("targ-coords needs --raw-dir and --slice-dir")
        n = md.propagate_target_coords(args.raw_dir, list(slice_dirs), verbose=args.verbose)
        _emit({"operation": op, "files_updated": n})
    elif op == "rotation":
        if not args.raw_dir or len(slice_dirs) != 1:
            parser.error("rotation needs --raw-dir and ONE --slice-dir")
        n = md.propagate_rotation(args.raw_dir, slice_dirs[0], verbose=args.verbose)
        _emit({"operation": op, "files_updated": n})
    elif op == "swap-slits":
        if len(slice_dirs) != 1:
            parser.error("swap-slits needs ONE --slice-dir")
        n = md.swap_slit_blocks_in_files(slice_dirs[0], match=args.match, n_slit=args.n_slit,
                                         block_width=args.block_width, verbose=args.verbose)
        _emit({"operation": op, "files_updated": n})
    else:  # rank-target
        if not args.raw_dir or args.ref_ra is None or args.ref_dec is None:
            parser.error("rank-target needs --raw-dir, --ref-ra, --ref-dec")
        paths = [os.path.join(args.raw_dir, f) for f in sorted(os.listdir(args.raw_dir))
                 if f.endswith(".fits")]
        ranked = md.rank_files_by_target_distance(paths, args.ref_ra, args.ref_dec)
        _emit({"operation": op, "ranked": [{"path": p, "distance_deg": d} for p, d in ranked]})


WARMUP_PROGRAMS = ("fwd", "adj", "normal")


def cmd_warmup(args, parser) -> None:
    """Prepare an environment for the flagship programs: build the kernel
    libraries with nvcc, fill the host-table cache for --bands, and run one
    application of each named program on the card (cuBLAS / cuFFT plans
    and workspaces made).  Later processes then find the libraries built
    and the tables cached.  Prints one JSON line of per-step seconds."""
    from .models.spectro import table_cache_dir
    from .simulation.flagship import make_flagship_model

    want = [p.strip() for p in args.programs.split(",") if p.strip()]
    bad = sorted(set(want) - set(WARMUP_PROGRAMS))
    if bad:
        parser.error(f"unknown programs {bad}: choose from {','.join(WARMUP_PROGRAMS)}")
    device = _device()
    if args.cache_dir:
        os.environ["SURFH_TABLE_CACHE"] = args.cache_dir
    report = {"cache_dir": table_cache_dir(), "backend": device.type}
    if device.type == "cuda":
        from concurrent.futures import ThreadPoolExecutor

        from .core import gather_fixed, gather_rows, wblur_banded

        t0 = time.perf_counter()
        with ThreadPoolExecutor(3) as ex:  # one nvcc per source
            for f in [ex.submit(gather_rows.load_kernel), ex.submit(wblur_banded.load_kernels),
                      ex.submit(gather_fixed.load_kernels)]:
                f.result()
        report["t_kernels_s"] = round(time.perf_counter() - t0, 2)
        report["kernels"] = ["gather_rows", "wblur_banded", "gather_fixed"]
    else:
        report["kernels"] = "not built: cpu"

    t0 = time.perf_counter()
    bands = [b.strip() for b in args.bands.split(",")] if args.bands else None
    model, setup = make_flagship_model(bands=bands, workers=min(8, os.cpu_count() or 1))
    report["t_build_s"] = round(time.perf_counter() - t0, 2)
    report["table_cache_hit"] = bool(model.table_cache_hit)
    t0 = time.perf_counter()
    model.to(device, torch.float32)
    _sync(device)
    report["t_tables_s"] = round(time.perf_counter() - t0, 2)
    x = torch.as_tensor(setup["maps"], dtype=torch.float32, device=device)
    y = torch.zeros(model.oshape, dtype=torch.float32, device=device)
    run = {"fwd": lambda: model.forward(x), "adj": lambda: model.adjoint(y),
           "normal": lambda: model.normal(x)}
    for name in WARMUP_PROGRAMS:
        if name in want:
            t0 = time.perf_counter()
            run[name]()
            _sync(device)
            report[f"t_first_{name}_s"] = round(time.perf_counter() - t0, 3)
    _emit(report)


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def cmd_info(args, parser) -> None:
    """Print device information (the card's, or the CPU's under SURFH_CPU)."""
    device = _device()
    cuda = device.type == "cuda"
    _emit({
        "torch": torch.__version__,
        "backend": device.type,
        "devices": ([torch.cuda.get_device_name(i) for i in range(torch.cuda.device_count())]
                    if cuda else ["cpu"]),
    })


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m surfh_tpu_torch.cli",
        description="surfh_tpu_torch — JWST MRS super-resolution and fusion on an NVIDIA "
                    "card. Set SURFH_CPU=1 to run on the host CPU instead.")
    sub = p.add_subparsers(dest="command", required=True)

    f = sub.add_parser("fusion", help=cmd_fusion.__doc__)
    f.add_argument("--fusion-data", "-fd", default=None,
                   help="Directory with Templates/, PSF/ and Filtered_slices/ (real-data mode).")
    f.add_argument("--simulated", action="store_true", help="Run a fully simulated fusion.")
    f.add_argument("--npix", "-np", type=int, default=81, help="Spatial grid size (default 81).")
    f.add_argument("--n-lambda", type=int, default=60, help="Cube λ samples (simulated mode).")
    f.add_argument("--channels", "-nc", type=int, default=2, help="Number of bands (simulated mode).")
    f.add_argument("--pointings", type=int, default=2, help="Dither pointings (simulated mode).")
    f.add_argument("--hyper-parameter", "-hp", type=float, default=5e3, help="Regularization µ.")
    f.add_argument("--niter", "-ni", type=int, default=50)
    f.add_argument("--n-templates", "-nt", type=int, default=4)
    f.add_argument("--scale-data", "-sd", action="store_true",
                   help="Apply Jy/SR → Jy flux normalization (real data).")
    f.add_argument("--method", "-m", default="lcg", choices=["lcg", "mmmg"])
    f.add_argument("--noise-snr", type=float, default=0.0,
                   help="Add white noise at this SNR (dB) to simulated data.")
    f.add_argument("--sharded", action="store_true", help="Shard channels over devices.")
    f.add_argument("--checkpoint-every", type=int, default=0,
                   help="Checkpoint the solver state every N iterations.")
    f.add_argument("--output-dir", "-o", default="./surfh_results")
    f.add_argument("--verbose", "-v", action="store_true")
    f.set_defaults(run=cmd_fusion)

    m = sub.add_parser("make-cube", help=cmd_make_cube.__doc__)
    m.add_argument("--maps", dest="maps_path", required=True,
                   help=".npy abundance maps (m, Nα, Nβ) — e.g. a fusion res_x.npy.")
    m.add_argument("--templates", dest="templates_path", required=True,
                   help=".npy spectral templates (m, λ).")
    m.add_argument("--wavel-axis", dest="wavel_path", default=None,
                   help=".npy λ axis (for FITS WCS headers).")
    m.add_argument("--output", "-o", required=True,
                   help="Output cube path (.npy, or .fits with λ WCS when --wavel-axis is given).")
    m.set_defaults(run=cmd_make_cube)

    c = sub.add_parser("compare-flux", help=cmd_compare_flux.__doc__)
    c.add_argument("--fusion-cube", required=True, help=".npy fused cube (λ, y, x).")
    c.add_argument("--real-cube", required=True, help=".npy or FITS s3d real cube.")
    c.add_argument("--mask", default=None, help="Optional .npy binary mask applied to the fused cube.")
    c.add_argument("--median-size", type=int, default=15,
                   help="λ median filter on the real cube (0 = off).")
    c.add_argument("--region", default=None,
                   help="Polygon vertices 'r1,c1;r2,c2;...' for a region spectrum.")
    c.add_argument("--output", "-o", default=None, help="Save curves to this .npz.")
    c.set_defaults(run=cmd_compare_flux)

    r = sub.add_parser("rehearse", help=cmd_rehearse.__doc__)
    r.add_argument("--work-dir", "-w", default="./surfh_rehearsal",
                   help="Working directory (raw/, Filtered_slices/, out/ created inside).")
    r.add_argument("--band", "-b", default=None, help="MRS band (default 4a, or the --header's).")
    r.add_argument("--pointings", type=int, default=2)
    r.add_argument("--npix", "-np", type=int, default=101)
    r.add_argument("--step", type=float, default=0.1, help="Grid step (arcsec).")
    r.add_argument("--lambda-subsample", type=int, default=4)
    r.add_argument("--hyper-parameter", "-hp", dest="mu", type=float, default=1.0)
    r.add_argument("--niter", "-ni", type=int, default=60)
    r.add_argument("--method", "-m", default="lcg", choices=["lcg", "mmmg"])
    r.add_argument("--noise-rms", type=float, default=0.0,
                   help="Gaussian noise added to the synthetic detector frames.")
    r.add_argument("--header", default=None,
                   help="Seed TARG_RA/TARG_DEC/PA_V3 (and the band, unless --band is given) "
                        "from a real stage-2 FITS file or header card dump.")
    r.add_argument("--targ-ra", type=float, default=None, help="Target RA (deg); overrides --header.")
    r.add_argument("--targ-dec", type=float, default=None, help="Target Dec (deg); overrides --header.")
    r.add_argument("--pa-v3", type=float, default=None,
                   help="Telescope V3 position angle (deg); overrides --header.")
    r.set_defaults(run=cmd_rehearse)

    a = sub.add_parser("allband", help=cmd_allband.__doc__)
    a.add_argument("--npix", "-np", type=int, default=61, help="Spatial grid size (default 61).")
    a.add_argument("--bands", "-b", default=None, help="Comma-separated band subset (default: all 12).")
    a.add_argument("--pointings", type=int, default=4)
    a.add_argument("--n-templates", "-nt", type=int, default=4)
    a.add_argument("--hyper-parameter", "-hp", type=float, default=5e3)
    a.add_argument("--niter", "-ni", type=int, default=50)
    a.add_argument("--nmf-iter", type=int, default=300, help="NMF multiplicative-update iterations.")
    a.add_argument("--method", "-m", default="lcg", choices=["lcg", "mmmg"])
    a.add_argument("--window-local", action="store_true",
                   help="The window-local model (each band's OTF window, the dense matmul conv).")
    a.add_argument("--lambda-subsample", type=int, default=1)
    a.add_argument("--output-dir", "-o", default="./surfh_results")
    a.set_defaults(run=cmd_allband)

    g = sub.add_parser("gen-psf", help=cmd_gen_psf.__doc__)
    g.add_argument("--wavel-axis", "-w", default=None,
                   help="λ-axis .npy (µm). Defaults to the band's detector table.")
    g.add_argument("--band", "-b", default="1c", help="MRS band for the default λ axis (default 1c).")
    g.add_argument("--pixelscale", type=float, default=0.025, help="Arcsec/pixel (default 0.025).")
    g.add_argument("--npix", type=int, default=501, help="Output grid size (default 501).")
    g.add_argument("--oversample", type=int, default=1)
    g.add_argument("--n-pupil", type=int, default=256, help="Pupil grid samples (default 256).")
    g.add_argument("--opd", default=None,
                   help="Wavefront/OPD map as a pupil phase screen: a .fits/.npy map, a .json "
                        "recorded decomposition, or 'commissioning' for the bundled fixture.")
    g.add_argument("--opd-unit", default="m", choices=["m", "um", "nm"], help="OPD map unit.")
    g.add_argument("--output", "-o", default="psf.npy")
    g.set_defaults(run=cmd_gen_psf)

    d = sub.add_parser("deconv-cube", help=cmd_deconv_cube.__doc__)
    d.add_argument("--npix", "-np", type=int, default=81)
    d.add_argument("--n-lambda", "-nl", type=int, default=24, help="λ planes in the deconvolved stack.")
    d.add_argument("--hyper-parameter", "-hp", type=float, default=5.0)
    d.add_argument("--niter", "-ni", type=int, default=100)
    d.add_argument("--pointings", type=int, default=2,
                   help="Dither pointings (the reference run keeps [P1, P3]).")
    d.add_argument("--rectangle", dest="rectangle", action="store_true", default=True,
                   help="Rectangle (no-rotation) gridding (the default).")
    d.add_argument("--rotated", dest="rectangle", action="store_false",
                   help="Rotated-FOV bilinear gridding.")
    d.add_argument("--output-dir", "-o", default="./surfh_results")
    d.set_defaults(run=cmd_deconv_cube)

    d2 = sub.add_parser("deconv2d", help=cmd_deconv2d.__doc__)
    d2.add_argument("--npix", "-np", type=int, default=81)
    d2.add_argument("--hyper-parameter", "-hp", type=float, default=500.0)
    d2.add_argument("--niter", "-ni", type=int, default=200)
    d2.add_argument("--rectangle", dest="rectangle", action="store_true", default=True,
                    help="Rectangle (no-rotation) model (the default).")
    d2.add_argument("--rotated", dest="rectangle", action="store_false",
                    help="Rotated-FOV model (bilinear gridding).")
    d2.add_argument("--output-dir", "-o", default="./surfh_results")
    d2.set_defaults(run=cmd_deconv2d)

    md = sub.add_parser("metadata", help=cmd_metadata.__doc__)
    md.add_argument("operation", choices=["targ-coords", "rotation", "swap-slits", "rank-target"])
    md.add_argument("--raw-dir", default=None,
                    help="Raw-exposure directory (source of RA_V1/DEC_V1/PA_V3).")
    md.add_argument("--slice-dir", dest="slice_dirs", action="append", default=None,
                    help="Corrected/filtered slice directory (repeatable).")
    md.add_argument("--match", default="ch2", help="Filename substring filter (swap-slits).")
    md.add_argument("--n-slit", type=int, default=17)
    md.add_argument("--block-width", type=int, default=24)
    md.add_argument("--ref-ra", type=float, default=None, help="Target RA (rank-target).")
    md.add_argument("--ref-dec", type=float, default=None, help="Target DEC (rank-target).")
    md.add_argument("--verbose", "-v", action="store_true")
    md.set_defaults(run=cmd_metadata)

    w = sub.add_parser("warmup", help=cmd_warmup.__doc__)
    w.add_argument("--bands", "-b", default=None, help="Comma-separated band list (default: all 12).")
    w.add_argument("--cache-dir", default=None,
                   help="Host-table cache directory to fill (sets SURFH_TABLE_CACHE; default: "
                        "SURFH_TABLE_CACHE, else ~/.cache/surfh_tpu_torch).")
    w.add_argument("--programs", default="fwd,adj",
                   help="Comma-set of programs to run once: fwd,adj,normal (default fwd,adj).")
    w.set_defaults(run=cmd_warmup)

    i = sub.add_parser("info", help=cmd_info.__doc__)
    i.set_defaults(run=cmd_info)

    return p


def main(argv: Optional[List[str]] = None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    parser = build_parser()
    args = parser.parse_args(argv)
    args.run(args, parser)
    return 0


if __name__ == "__main__":
    sys.exit(main())
