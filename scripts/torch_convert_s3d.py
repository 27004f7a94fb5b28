#!/usr/bin/env python3
"""Convert JWST s3d ChannelCube FITS products onto the fusion model grid
with `surfh_tpu_torch` (the counterpart of `scripts/convert_s3d.py`).

Reads each `*_s3d.fits`, NaNs its borders, refines the (RA, DEC) point
cloud, scattered-linear-interpolates every λ plane onto the regular (α, β)
grid (`preprocessing.s3d`), and saves `<stem>.npy` (cube), `<stem>_mask.npy`
(finite-coverage mask) and `<stem>_wavel.npy` (λ axis); one JSON line per file.

    python3 scripts/torch_convert_s3d.py --s3d ChannelCube_ch1a.fits --out-dir out \\
        [--npix 251] [--step 0.025] [--oversample 3] [--border 4] [--center RA,DEC]

Host NumPy and SciPy (the port's `preprocessing.s3d` runs nothing on a
card), so the tool needs none.  Imports no JAX.
"""

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--s3d", required=True, nargs="+", help="s3d FITS file(s)")
    ap.add_argument("--out-dir", required=True)
    ap.add_argument("--npix", type=int, default=251, help="target grid size")
    ap.add_argument("--step", type=float, default=0.025, help="grid step (arcsec)")
    ap.add_argument("--oversample", type=int, default=3, help="point-cloud refinement factor")
    ap.add_argument("--border", type=int, default=4,
                    help="NaN'd s3d border width (resampling artifacts)")
    ap.add_argument("--center", default=None,
                    help="'ra,dec' grid center in degrees (default: cloud mean)")
    args = ap.parse_args(argv)

    from surfh_tpu_torch.preprocessing.s3d import read_s3d, resample_cube_to_grid

    os.makedirs(args.out_dir, exist_ok=True)
    step_deg = args.step / 3600.0
    half = (np.arange(args.npix) - (args.npix - 1) / 2.0) * step_deg

    for path in args.s3d:
        cube, wavel, ra_map, dec_map = read_s3d(path)
        if args.center:
            ra0, dec0 = (float(v) for v in args.center.split(","))
        else:
            ra0, dec0 = float(np.nanmean(ra_map)), float(np.nanmean(dec_map))
        resampled = resample_cube_to_grid(
            cube, ra_map, dec_map, half + ra0, half + dec0,
            oversample=args.oversample, border=args.border,
        )
        stem = os.path.splitext(os.path.basename(path))[0]
        np.save(os.path.join(args.out_dir, stem + ".npy"),
                np.nan_to_num(resampled).astype(np.float32))
        np.save(os.path.join(args.out_dir, stem + "_mask.npy"),
                np.isfinite(resampled).all(axis=0))
        np.save(os.path.join(args.out_dir, stem + "_wavel.npy"), wavel)
        print(json.dumps({
            "file": stem,
            "cube_shape": list(resampled.shape),
            "coverage_frac": float(np.isfinite(resampled).mean()),
            "lambda_range": [float(wavel[0]), float(wavel[-1])],
        }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
