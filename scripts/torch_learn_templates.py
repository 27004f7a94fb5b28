#!/usr/bin/env python3
"""Learn LMM spectral templates from a reconstructed cube on one NVIDIA
card with `surfh_tpu_torch` (the counterpart of `scripts/learn_templates.py`).

Scans NMF component counts by reconstruction error, or runs PCA /
N-FINDR + FCLS (`learning.decomposition`, on the card), then saves
`templates.npy` + `wavel_axis.npy` for `cli fusion`, and the abundances.
`--demo` runs on the synthetic Orion-like cube of `simulation.data`
(100², 300 λ).  The NMF's initial factors are drawn from
``np.random.default_rng(--seed)``, the JAX script's draw at seed 0, so the
two start from the same factors.

    python3 scripts/torch_learn_templates.py --cube res_cube.npy --wavel wavel_axis.npy \\
        --method nmf --components 4 --scan 2 8 -o ./templates_out
    python3 scripts/torch_learn_templates.py --demo --method nfindr [--cpu]

Runs on the card unless `--cpu`; imports no JAX.
"""

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cube", help="reconstructed cube .npy [λ, Nα, Nβ]")
    ap.add_argument("--wavel", help="wavelength axis .npy [λ]")
    ap.add_argument("--mask", help="optional boolean spatial mask .npy [Nα, Nβ]")
    ap.add_argument("--demo", action="store_true", help="run on a synthetic Orion-like cube")
    ap.add_argument("--method", choices=["nmf", "pca", "nfindr"], default="nmf")
    ap.add_argument("--components", "-k", type=int, default=4)
    ap.add_argument("--scan", nargs=2, type=int, metavar=("KMIN", "KMAX"),
                    help="scan NMF reconstruction error over this k range")
    ap.add_argument("--n-iter", type=int, default=500)
    ap.add_argument("--seed", type=int, default=0, help="the NMF's initial factors")
    ap.add_argument("--cpu", action="store_true", help="run on the host CPU")
    ap.add_argument("--output-dir", "-o", default="./templates_out")
    args = ap.parse_args(argv)

    import torch

    from surfh_tpu_torch.core.precision import require_cuda
    from surfh_tpu_torch.learning import fcls, learn_templates_nmf, nfindr, nmf, pca
    from surfh_tpu_torch.utils.profiling import card_name

    dev = torch.device("cpu") if args.cpu else require_cuda()
    if args.demo:
        from surfh_tpu_torch.simulation.data import synthetic_orion

        maps, tpl, _, wavel = synthetic_orion(size=100, n_wavel=300)
        cube = np.tensordot(tpl.T, maps, axes=1)
        mask = None
    else:
        if not args.cube or not args.wavel:
            ap.error("--cube and --wavel required (or --demo)")
        cube = np.load(args.cube)
        wavel = np.load(args.wavel)
        mask = np.load(args.mask) if args.mask else None

    def save(name, a):
        np.save(os.path.join(args.output_dir, name), a.cpu().numpy() if torch.is_tensor(a) else a)

    os.makedirs(args.output_dir, exist_ok=True)
    L = cube.shape[0]
    pixels = cube.reshape(L, -1).T
    if mask is not None:
        pixels = pixels[np.asarray(mask).ravel()]

    report = {"method": args.method}
    if args.method == "nmf":
        if args.scan:
            errs = {}
            for k in range(args.scan[0], args.scan[1] + 1):
                _, _, err = nmf(pixels, k, n_iter=args.n_iter, seed=args.seed, device=dev)
                errs[k] = err
                print(f"k={k}: reconstruction error {err:.4e}", flush=True)
            report["scan"] = errs
        templates, maps_hat, err = learn_templates_nmf(
            cube.astype(np.float32), args.components, mask=mask, n_iter=args.n_iter,
            seed=args.seed, device=dev)
        report["error"] = err
        save("abundances.npy", maps_hat)
    elif args.method == "pca":
        templates, var, _ = pca(pixels.astype(np.float32), args.components, device=dev)
        report["explained_variance"] = var.tolist()
    else:  # nfindr + fcls
        templates, idx = nfindr(pixels, args.components, device=dev)
        report["endmember_indices"] = np.asarray(idx).tolist()
        save("abundances_flat.npy", fcls(pixels, templates, device=dev))

    save("templates.npy", templates)
    save("wavel_axis.npy", wavel)
    report["device"] = card_name(dev)
    print(json.dumps({k: v for k, v in report.items() if k != "scan"}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
