#!/usr/bin/env python3
"""Fidelity audit of the λ-rank factorized conv at flagship scale on one
NVIDIA card, with `surfh_tpu_torch` (the counterpart of
`scripts/rank_fidelity_audit.py`): the forward / adjoint deviation of the
rank model from the dense window-local model (`conv_rank_rtol=0`, the same
PSF stamps and `conv_freq_rtol`), against the recorded SVD tails, and the
CG solutions of both.

    python3 scripts/torch_rank_fidelity_audit.py --phase deviation [--bands 1c,2a]
    python3 scripts/torch_rank_fidelity_audit.py --phase cg --rank-mode rank
    python3 scripts/torch_rank_fidelity_audit.py --phase cg --rank-mode dense

`deviation` checks both deviations (max |rank − dense| / max |dense|, float32)
against ``max(10 × the largest recorded tail, 2e-5)``: ten times the tail
(the pipeline amplifies it 2–7×, tests/test_window_local.py) or the float32
floor of two models, each within 1e-5 of its float64 value (the bar
chip_smoke.py holds the card's operators to), whichever is larger; it exits
1 when either is above.  Each phase merges its record into
``<out-dir>/rank_audit.json`` and prints it; the CG phases save their
solutions to ``<out-dir>/x_{rank,dense}.npy`` and, when the other mode's is
there, compare the two.  Runs on the card unless `--cpu`; imports no JAX.
"""

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

WORKERS = min(8, os.cpu_count() or 1)  # processes for the host table build
F32_FLOOR = 2e-5  # two float32 models, each within 1e-5 of its float64 value


def _record(path: str, update: dict) -> None:
    data = {}
    if os.path.exists(path):
        with open(path) as fh:
            data = json.load(fh)
    data.update(update)
    with open(path, "w") as fh:
        json.dump(data, fh, indent=1)
    print(json.dumps(update), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phase", choices=("deviation", "cg"), required=True)
    ap.add_argument("--rank-mode", choices=("rank", "dense"), default="rank")
    ap.add_argument("--npix", type=int, default=501)
    ap.add_argument("--bands", default=None)
    ap.add_argument("--pointings", type=int, default=4)
    ap.add_argument("--niter", type=int, default=500)
    ap.add_argument("--mu", type=float, default=5e3)
    ap.add_argument("--rank-rtol", type=float, default=1e-7)
    ap.add_argument("--out-dir", default=os.path.join(tempfile.gettempdir(), "surfh_torch_audit"),
                    help="where the record and the solutions go (default: surfh_torch_audit "
                         "in the temporary directory)")
    ap.add_argument("--cpu", action="store_true", help="run on the host CPU")
    args = ap.parse_args(argv)

    import torch

    from surfh_tpu_torch.core.precision import require_cuda
    from surfh_tpu_torch.simulation.flagship import make_flagship_model, make_flagship_setup
    from surfh_tpu_torch.utils.profiling import card_name

    dev = torch.device("cpu") if args.cpu else require_cuda()
    os.makedirs(args.out_dir, exist_ok=True)
    out = os.path.join(args.out_dir, "rank_audit.json")
    bands = args.bands.split(",") if args.bands else None
    t0 = time.perf_counter()
    setup = make_flagship_setup(npix=args.npix, bands=bands, n_pointings=args.pointings)
    print(f"setup {time.perf_counter() - t0:.1f}s", flush=True)

    def build(rank_rtol):
        model, _ = make_flagship_model(setup, dtype=np.float32, conv_impl="matmul",
                                       conv_rank_rtol=rank_rtol, workers=WORKERS)
        return model.to(dev, torch.float32)

    def rel_max(a, b) -> float:
        return float((a - b).abs().max() / b.abs().max())

    def rel_rms(a, b) -> float:
        return float(torch.sqrt(torch.mean((a - b) ** 2)) / torch.sqrt(torch.mean(b**2)))

    if args.phase == "deviation":
        t0 = time.perf_counter()
        dense = build(0.0)
        rank = build(args.rank_rtol)
        tails = [s.get("rank_tail", 0.0) for s in rank.conv_supports]
        ranks = [s.get("rank") for s in rank.conv_supports]
        print(f"build both {time.perf_counter() - t0:.1f}s ranks={ranks}", flush=True)

        maps = torch.as_tensor(setup["maps"], dtype=torch.float32, device=dev)
        yd, yr = dense.forward(maps), rank.forward(maps)
        rng = np.random.default_rng(0)
        yy = torch.as_tensor(rng.standard_normal(dense.oshape), dtype=torch.float32).to(dev)
        ad, ar = dense.adjoint(yy), rank.adjoint(yy)
        max_tail = float(max(tails))
        bound = max(10.0 * max_tail, F32_FLOOR)
        rec = {
            "bands": bands or "all12",
            "rank_rtol": args.rank_rtol,
            "ranks": ranks,
            "svd_tails": tails,
            "max_tail": max_tail,
            "fwd_max_rel": rel_max(yr, yd),
            "fwd_rms_rel": rel_rms(yr, yd),
            "adj_max_rel": rel_max(ar, ad),
            "adj_rms_rel": rel_rms(ar, ad),
            "fwd_dev_over_tail": rel_max(yr, yd) / max_tail if max_tail else None,
            "adj_dev_over_tail": rel_max(ar, ad) / max_tail if max_tail else None,
            "bound": bound,
            "device": card_name(dev),
        }
        rec["within_bound"] = rec["fwd_max_rel"] <= bound and rec["adj_max_rel"] <= bound
        _record(out, rec)
        return 0 if rec["within_bound"] else 1

    # --- CG phase -------------------------------------------------------
    from surfh_tpu_torch.solvers.criterion import QuadCriterion_MRS
    from surfh_tpu_torch.utils import metrics

    model = build(args.rank_rtol if args.rank_mode == "rank" else 0.0)
    truth = np.asarray(setup["maps"], np.float32)
    t0 = time.perf_counter()
    y = model.forward(truth)
    print(f"simulate {time.perf_counter() - t0:.1f}s", flush=True)
    crit = QuadCriterion_MRS(1.0, y, model, args.mu)
    crit.run_method("lcg", 2, solver_loop="dispatch")  # warm-up
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    res = crit.run_method("lcg", maximum_iterations=args.niter, solver_loop="dispatch")
    x = res.x.cpu().numpy()
    dt = time.perf_counter() - t0
    np.save(os.path.join(args.out_dir, f"x_{args.rank_mode}.npy"), x)
    upd = {
        f"cg_{args.rank_mode}": {
            "niter": int(res.n_iter),
            "solve_s": dt,
            "relative_error_pct": metrics.relative_error(truth, x),
            "psnr_maps": metrics.psnr(truth, x),
            "grad_norm_final": float(res.grad_norm[-1]),
            "device": card_name(dev),
        }
    }
    other = os.path.join(args.out_dir, f"x_{'dense' if args.rank_mode == 'rank' else 'rank'}.npy")
    if os.path.exists(other):
        xo = np.load(other)
        upd["cg_cross"] = {
            "x_rel_err_pct": metrics.relative_error(xo, x),
            "x_max_rel": float(np.abs(x - xo).max() / max(np.abs(xo).max(), 1e-30)),
        }
    _record(out, upd)
    return 0


if __name__ == "__main__":
    sys.exit(main())
