#!/usr/bin/env python3
"""The north star at full scale on one NVIDIA card: CG iterations of the
12-band flagship fusion with `surfh_tpu_torch` (the counterpart of
`scripts/flagship_cg.py`).

Builds the flagship problem (12 MIRI bands × 4 dither pointings, 501² sky,
~3879-λ cube; window-local rank mode, its host tables from the table cache
where it holds them), simulates data through the forward model, computes
b = Hᵗy, warms the solver up with 2 iterations, then runs `niter`
iterations of the quadratic fusion criterion and prints one JSON report:
stage seconds (each ends in a synchronise), iterations/s, the gradient
norm at fixed iterations and its fall, and the reconstruction error
against the simulated truth.

    python3 scripts/torch_flagship_cg.py [--niter 500] [--bands 1a,1b,...] [--npix 501]
        [--method lcg|mmmg] [--solver-loop graph|dispatch] [--chain K] [--cpu]

`--chain` is `lcg`'s `solver_chain` (iterations between the dispatch
loop's reads of ‖r‖; no iterate changes).  `--solver-loop graph` (the
default) reads ‖r‖ every iteration and stops at the crossing; `dispatch`
is the loop the JAX script runs.  ``SURFH_CG_HISTORY=path.npy`` saves the
gradient-norm history.  Runs on the card unless `--cpu`; imports no JAX.
"""

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

WORKERS = min(8, os.cpu_count() or 1)  # processes for the host table build
MARKS = (0, 10, 32, 100, 200, 500, 1000, 2000)  # iterations whose gradient norm is reported


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--niter", type=int, default=500)
    ap.add_argument("--npix", type=int, default=501)
    ap.add_argument("--bands", type=str, default=None)
    ap.add_argument("--pointings", type=int, default=4)
    ap.add_argument("--mu", type=float, default=5e3)
    ap.add_argument("--method", choices=("lcg", "mmmg"), default="lcg")
    ap.add_argument("--solver-loop", choices=("graph", "dispatch"), default="graph")
    ap.add_argument("--chain", type=int, default=1,
                    help="lcg's solver_chain: iterations between two reads of ‖r‖ "
                         "in the dispatch loop")
    ap.add_argument("--cpu", action="store_true", help="run on the host CPU")
    args = ap.parse_args(argv)

    import torch

    from surfh_tpu_torch.core.precision import require_cuda
    from surfh_tpu_torch.simulation.flagship import make_flagship_model, make_flagship_setup
    from surfh_tpu_torch.solvers.criterion import QuadCriterion_MRS
    from surfh_tpu_torch.utils import metrics
    from surfh_tpu_torch.utils.profiling import card_name

    dev = torch.device("cpu") if args.cpu else require_cuda()

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    report = {}
    t0 = time.perf_counter()
    bands = args.bands.split(",") if args.bands else None
    setup = make_flagship_setup(npix=args.npix, bands=bands, n_pointings=args.pointings)
    model, _ = make_flagship_model(setup, dtype=np.float32, workers=WORKERS)
    report["build_s"] = time.perf_counter() - t0
    print(f"[{time.strftime('%H:%M:%S')}] build {report['build_s']:.2f}s "
          f"(table cache {'hit' if model.table_cache_hit else 'miss'}); cube {model.cube_shape}, "
          f"y {model.oshape[0]}, {len(model.channels)} channels", flush=True)

    truth = np.asarray(setup["maps"], np.float32)
    t0 = time.perf_counter()
    model.to(dev, torch.float32)
    y = model.forward(truth)
    sync()
    report["simulate_s"] = time.perf_counter() - t0
    print(f"[{time.strftime('%H:%M:%S')}] simulate {report['simulate_s']:.2f}s", flush=True)

    crit = QuadCriterion_MRS(1.0, y, model, args.mu)
    t0 = time.perf_counter()
    _ = crit.b
    sync()
    report["bTy_s"] = time.perf_counter() - t0

    kw = dict(solver_loop=args.solver_loop, solver_chain=args.chain)
    t0 = time.perf_counter()
    crit.run_method(args.method, maximum_iterations=2 * args.chain, **kw)
    sync()
    report["warmup_s"] = time.perf_counter() - t0
    print(f"[{time.strftime('%H:%M:%S')}] b {report['bTy_s']:.3f}s, "
          f"warm-up(2 it) {report['warmup_s']:.3f}s", flush=True)

    t0 = time.perf_counter()
    res = crit.run_method(args.method, maximum_iterations=args.niter, **kw)
    sync()
    dt = time.perf_counter() - t0
    gn = np.asarray(res.grad_norm, np.float64)
    x = res.x.cpu().numpy()
    marks = [i for i in MARKS if i < len(gn)]
    report.update(
        method=args.method,
        solver_loop=args.solver_loop,
        mu=args.mu,
        niter=int(res.n_iter),
        solve_s=dt,
        iters_per_s=res.n_iter / dt,
        grad_norm_final=float(gn[-1]),
        grad_norm_marks={str(i): float(gn[i]) for i in marks},
        grad_reduction=float(gn[0] / gn[-1]) if gn[-1] > 0 else float("inf"),
        relative_error_pct=metrics.relative_error(truth, x),
        psnr_maps=metrics.psnr(truth, x),
        n_channels=len(model.channels),
        cube_shape=list(model.cube_shape),
        device=card_name(dev),
    )
    if os.environ.get("SURFH_CG_HISTORY"):
        np.save(os.environ["SURFH_CG_HISTORY"], gn)
    print(json.dumps(report), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
