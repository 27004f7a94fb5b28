#!/usr/bin/env python3
"""Reconstruction-quality surface at the flagship configuration on one
NVIDIA card, with `surfh_tpu_torch` (the counterpart of
`scripts/quality_surface.py`).

Sweeps {Orion-bar, NGC 7023 stand-in} scenes × noise levels × a µ grid on
the 12-band × 4-pointing × 501² flagship (window-local rank mode), each
point solved with `lcg`'s dispatch loop from zero maps, and scores the
solution against the scene on the observed pixels (the coverage mask:
`sens > 0.05·max` of |Hᵗ1| summed over the maps).  Noise is drawn from
``np.random.default_rng(0)`` in the sweep's order, as a fraction of the
clean data's rms.  Prints one JSON row per point, then the best µ per
(scene, noise) as ``{"summary": [...]}``; `--out` writes both.

    python3 scripts/torch_quality_surface.py [--niter 300] [--npix 501] \\
        [--mus 5e2,5e3,5e5,5e7,5e8] [--noise 0,0.01,0.05] [--scenes orion,ngc7023] \\
        [--out f.json] [--cpu]

Runs on the card unless `--cpu`; imports no JAX.
"""

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

WORKERS = min(8, os.cpu_count() or 1)  # processes for the host table build


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--niter", type=int, default=300)
    ap.add_argument("--npix", type=int, default=501)
    ap.add_argument("--bands", type=str, default=None)
    ap.add_argument("--pointings", type=int, default=4)
    ap.add_argument("--mus", type=str, default="5e2,5e3,5e5,5e7,5e8")
    ap.add_argument("--noise", type=str, default="0,0.01,0.05",
                    help="noise rms as a fraction of the data rms")
    ap.add_argument("--scenes", type=str, default="orion,ngc7023")
    ap.add_argument("--out", type=str, default=None)
    ap.add_argument("--cpu", action="store_true", help="run on the host CPU")
    args = ap.parse_args(argv)

    import torch

    from surfh_tpu_torch.core.precision import require_cuda
    from surfh_tpu_torch.simulation.data import synthetic_ngc7023, synthetic_orion
    from surfh_tpu_torch.simulation.flagship import make_flagship_model, make_flagship_setup
    from surfh_tpu_torch.solvers.cg import lcg
    from surfh_tpu_torch.solvers.criterion import dtd_separated
    from surfh_tpu_torch.utils import metrics
    from surfh_tpu_torch.utils.profiling import card_name

    dev = torch.device("cpu") if args.cpu else require_cuda()

    def mark(m):
        print(f"[{time.strftime('%H:%M:%S')}] {m}", file=sys.stderr, flush=True)

    mark("build flagship model")
    bands = args.bands.split(",") if args.bands else None
    setup = make_flagship_setup(npix=args.npix, bands=bands, n_pointings=args.pointings)
    model, _ = make_flagship_model(setup, dtype=np.float32, workers=WORKERS)
    model.to(dev, torch.float32)
    n_tpl = model.templates.shape[0]
    mark(f"model ready: {len(model.channels)} channels, cube {model.cube_shape}")

    def normal_op(x, mu):
        return model.normal(x) + mu * dtd_separated(x)

    def solve(b, mu, niter):
        res = lcg(normal_op, b, torch.zeros(model.ishape, device=dev, dtype=torch.float32),
                  max_iter=niter, tol=0.0, op_args=(torch.tensor(mu, device=dev),),
                  loop="dispatch")
        return res.x.cpu().numpy(), float(res.grad_norm[-1])

    # coverage mask: spatial pixels with real sensitivity
    ones = torch.ones(model.oshape, device=dev)
    sens = model.adjoint(ones).abs().sum(dim=0).cpu().numpy()
    mask = sens > 0.05 * sens.max()
    mark(f"coverage mask: {mask.mean() * 100:.1f}% of pixels observed")

    scene_fns = {"orion": synthetic_orion, "ngc7023": synthetic_ngc7023}
    mus = [float(m) for m in args.mus.split(",")]
    noises = [float(n) for n in args.noise.split(",")]
    rng = np.random.default_rng(0)

    rows = []
    for scene in args.scenes.split(","):
        maps, _, _, _ = scene_fns[scene](n_maps=n_tpl, size=args.npix, n_wavel=16)
        truth = (maps / maps.max()).astype(np.float32)
        t0 = time.perf_counter()
        y_clean = model.forward(truth).cpu().numpy()
        y_rms = float(np.sqrt(np.mean(y_clean**2)))
        mark(f"scene {scene}: data simulated in {time.perf_counter() - t0:.1f}s "
             f"(rms {y_rms:.3g})")
        for nz in noises:
            y = y_clean + (nz * y_rms) * rng.standard_normal(y_clean.shape).astype(np.float32)
            b = model.adjoint(y)
            for mu in mus:
                t0 = time.perf_counter()
                x, gnorm = solve(b, mu, args.niter)
                dt = time.perf_counter() - t0
                row = {
                    "scene": scene, "noise_frac": nz, "mu": mu,
                    "niter": args.niter,
                    "rel_err_pct": round(float(metrics.relative_error(
                        truth[:, mask], x[:, mask])), 3),
                    "psnr": round(float(metrics.psnr(truth[:, mask], x[:, mask])), 3),
                    "grad_norm_final": gnorm,
                    "solve_s": dt,
                }
                rows.append(row)
                print(json.dumps(row), flush=True)

    # per-(scene, noise) best µ summary
    best = {}
    for r in rows:
        k = (r["scene"], r["noise_frac"])
        if k not in best or r["rel_err_pct"] < best[k]["rel_err_pct"]:
            best[k] = r
    summary = {
        "config": {"npix": args.npix, "bands": bands or "all12",
                   "pointings": args.pointings, "niter": args.niter,
                   "device": card_name(dev)},
        "best": [
            {"scene": s, "noise_frac": n, **{k: v for k, v in r.items()
                                             if k not in ("scene", "noise_frac")}}
            for (s, n), r in sorted(best.items())
        ],
        "rows": rows,
    }
    print(json.dumps({"summary": summary["best"]}), flush=True)
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(summary, fh, indent=1)
        mark(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
