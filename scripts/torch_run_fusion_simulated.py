#!/usr/bin/env python3
"""End-to-end simulated multi-channel fusion on one NVIDIA card with
`surfh_tpu_torch` (the counterpart of `scripts/run_fusion_simulated.py`).

Synthesizes data from the synthetic problem's ground truth through the
exact materialized-OTF model (`simulation.synthetic.make_model`),
reconstructs with `QuadCriterion_MRS` (`lcg` or `mmmg`, from maps of 0.5),
writes `res_x.npy`, `res_cube.npy` and `criterion.npy` (the gradient-norm
history) and prints one JSON report.  `--quick` runs a tiny configuration.
`--sharded` shards the bands over the processes of a `torch.distributed`
world (`parallel.fusion.ShardedSpectro`, from zero maps), as `cli fusion
--sharded` does: under ``torchrun --nproc-per-node N`` each process takes
its card, alone it makes a world of 1; rank 0 writes and reports.

    python3 scripts/torch_run_fusion_simulated.py --quick [--cpu]
    python3 scripts/torch_run_fusion_simulated.py --npix 251 --channels 4 --niter 200
    torchrun --standalone --nproc-per-node 2 scripts/torch_run_fusion_simulated.py --sharded

Runs on the card unless `--cpu` (gloo on the CPU when sharded); imports no JAX.
"""

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true", help="tiny config, CPU-friendly")
    ap.add_argument("--cpu", action="store_true", help="run on the host CPU")
    ap.add_argument("--npix", type=int, default=121)
    ap.add_argument("--n-lambda", type=int, default=100)
    ap.add_argument("--channels", type=int, default=4)
    ap.add_argument("--pointings", type=int, default=4)
    ap.add_argument("--n-templates", type=int, default=4)
    ap.add_argument("--niter", type=int, default=50)
    ap.add_argument("--mu", type=float, default=100.0)
    ap.add_argument("--method", choices=["lcg", "mmmg"], default="lcg")
    ap.add_argument("--sharded", action="store_true")
    ap.add_argument("--output-dir", default="./surfh_results")
    args = ap.parse_args(argv)

    import torch

    from surfh_tpu_torch.core.precision import require_cuda
    from surfh_tpu_torch.simulation.synthetic import make_model
    from surfh_tpu_torch.solvers.criterion import QuadCriterion_MRS
    from surfh_tpu_torch.utils import metrics
    from surfh_tpu_torch.utils.profiling import card_name

    if args.quick:
        args.npix, args.n_lambda, args.channels, args.pointings = 41, 24, 2, 2
        args.niter = min(args.niter, 15)

    mesh, own_world = None, False
    if args.sharded:
        import torch.distributed as dist

        from surfh_tpu_torch.parallel.fusion import make_mesh

        own_world = not dist.is_initialized()
        # joins torchrun's world (or makes one of 1); on the card, takes LOCAL_RANK's device
        mesh = make_mesh(device_type="cpu" if args.cpu else None)
    dev = torch.device("cpu") if args.cpu else require_cuda()
    lead = mesh is None or mesh.get_rank() == 0
    try:
        print(f"device: {card_name(dev)}", flush=True)
        model, setup = make_model(
            dtype=np.float32, im_size=args.npix, n_lambda=args.n_lambda, n_tpl=args.n_templates,
            n_channels=args.channels, n_pointings=args.pointings,
        )
        model.to(dev, torch.float32)
        truth = np.asarray(setup["maps"], np.float32)
        y = model.forward(truth).cpu().numpy()
        print(f"model: ishape={model.ishape} data={y.size} samples", flush=True)

        t0 = time.perf_counter()
        if mesh is not None:
            from surfh_tpu_torch.parallel.fusion import ShardedSpectro

            res = ShardedSpectro(model, mesh).solve(y, mu_reg=args.mu, max_iter=args.niter,
                                                    method=args.method)
        else:
            crit = QuadCriterion_MRS(1.0, y, model, args.mu, printing=True)
            res = crit.run_method(args.method, maximum_iterations=args.niter)
        x = res.x.cpu().numpy()
        dt = time.perf_counter() - t0
        if not lead:
            return 0

        os.makedirs(args.output_dir, exist_ok=True)
        np.save(os.path.join(args.output_dir, "res_x.npy"), x)
        np.save(os.path.join(args.output_dir, "res_cube.npy"), model.mapsToCube(res.x).cpu().numpy())
        np.save(os.path.join(args.output_dir, "criterion.npy"), res.grad_norm)
        print(json.dumps({
            "niter": int(res.n_iter),
            "seconds": dt,
            "iters_per_s": res.n_iter / max(dt, 1e-9),
            "psnr_maps": metrics.psnr(truth, x),
            "relative_error_pct": metrics.relative_error(truth, x),
            "device": card_name(dev),
        }), flush=True)
        return 0
    finally:
        if own_world:
            dist.destroy_process_group()


if __name__ == "__main__":
    sys.exit(main())
