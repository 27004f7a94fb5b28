"""The real-data rehearsal's quality numbers against CG iterations and µ.

    python -m surfh_tpu_torch.utils.rehearsal_sweep [--band 1c] [--pointings 4] [-np 501]
        [--step 0.025] [--lambda-subsample 1] [--mu 1,100,5e3] [--iters 20,60,100,150,200,300,400]

Runs `pipeline.run_rehearsal` once (µ = 1, 60 iterations) to write the
corrected slices into a temporary directory, rebuilds the fusion model
from them (`create_model`, the data flux-normalized) and, for each µ, runs
`lcg` from the rehearsal's initial value in segments up to each iteration
count, printing the rehearsal's quality numbers (`rehearsal_quality`:
residual_rel, flux_ratio_median, flux_shape_corr, flux_points) and the mean
of the maps in the grid's corner.  On the card; ``SURFH_CPU=1`` runs it on
the host.  Prints the card's name and power limit first.
"""

from __future__ import annotations

import argparse
import os
import shutil
import subprocess
import tempfile
import time
from typing import List, Optional

import numpy as np
import torch


def main(argv: Optional[List[str]] = None) -> int:
    from .. import pipeline as tpl
    from ..core import fft
    from ..solvers.criterion import QuadCriterion_MRS

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--band", default="1c")
    ap.add_argument("--pointings", type=int, default=4)
    ap.add_argument("--npix", "-np", type=int, default=501)
    ap.add_argument("--step", type=float, default=0.025)
    ap.add_argument("--lambda-subsample", type=int, default=1)
    ap.add_argument("--mu", default="1,100,5e3")
    ap.add_argument("--iters", default="20,60,100,150,200,300,400")
    args = ap.parse_args(argv)
    if os.environ.get("SURFH_CPU"):
        dev = torch.device("cpu")
    else:
        from ..core.precision import require_cuda

        dev = require_cuda()
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    work = tempfile.mkdtemp(prefix="surfh_sweep_")
    try:
        t0 = time.perf_counter()
        rep = tpl.run_rehearsal(work, band=args.band, n_pointings=args.pointings, npix=args.npix,
                                step_arcsec=args.step, lambda_subsample=args.lambda_subsample,
                                mu=1.0, niter=60, device=dev)
        print(f"rehearse {rep} ({time.perf_counter() - t0:.2f} s)", flush=True)
        step = args.step / 3600.0
        tpl_dir = os.path.join(work, "Templates")
        spsf = tpl.crop_psf_stack(np.load(os.path.join(work, "PSF", "psf.npy")), args.npix)
        alpha = np.arange(args.npix) * step
        alpha -= alpha.mean()
        dd = tpl.load_corrected_data(os.path.join(work, "Filtered_slices"), [args.band])
        model = tpl.create_model(
            fft.ir2fr_device(spsf, (args.npix, args.npix), dev), np.load(os.path.join(tpl_dir, "templates.npy")),
            alpha, alpha.copy(), np.load(os.path.join(tpl_dir, "wavel_axis.npy")),
            tpl.create_instruments(dd, [args.band]), step, dd, device=dev)
        y = model.real_data_janskySR_to_jansky(tpl.assemble_data_vector(model, dd, [args.band]))
        flux_data = None
        for mu in (float(v) for v in args.mu.split(",")):
            crit = QuadCriterion_MRS(1.0, y, model, mu)
            state, done = None, 0
            for target in (int(v) for v in args.iters.split(",")):
                t0 = time.perf_counter()
                res = crit.run_method("lcg", maximum_iterations=target - done, solver_state=state,
                                      return_state=True)
                state, done = res.state, target
                q = tpl.rehearsal_quality(model, res.x, y, flux_data)
                flux_data = q["flux_data"]
                corner = res.x[:, : args.npix // 16, : args.npix // 16].mean(dim=(1, 2)).tolist()
                print(f"mu {mu:g} iterations {target}: residual_rel {q['residual_rel']:.4e} "
                      f"flux_ratio_median {q['flux_ratio_median']:.4f} flux_shape_corr "
                      f"{q['flux_shape_corr']:.6f} flux_points {q['flux_points']}; corner maps "
                      f"{[round(c, 6) for c in corner]}; grad norm {res.grad_norm[-1]:.4e} "
                      f"({time.perf_counter() - t0:.2f} s)", flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
