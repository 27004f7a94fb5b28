#!/usr/bin/env python3
"""Real-data distortion correction with `surfh_tpu_torch`: stage-2
`cal.fits` → model-aligned corrected-slice FITS files (the counterpart of
`scripts/correct_mrs_data.py`).

For each `*.fits` of `--raw-dir`, each of the (at most two) channels its
name carries (``..._ch1-2_dither3_cal.fits``): label the slits, regrid them
with the Shepard interpolation on the card
(`preprocessing.correction_driver.correct_file`), reorder the slits, and
write ``<chan>_<stem>_corrected.fits`` in the flat [n_λ, n_slit·n_α]
layout with the PA_V3 / TARG_RA / TARG_DEC / BAND headers.

The detector→world transform of a file comes from the ALPHA / BETA / LAM
maps it carries where it has them (the synthetic stage-2 files of
`simulation.stage2`, `cli rehearse`), else from the `jwst` package's
stage-2 datamodel, as the JAX script reads every file.

    python3 scripts/torch_correct_mrs_data.py --raw-dir RAW --out-dir OUT --npix 501 \\
        [--wavel-cube axis.npy] [--cpu]

Runs on the card unless `--cpu`; imports no JAX.
"""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

WCS_MAPS = {"ALPHA", "BETA", "LAM"}


def _wcs_loader(path):
    """`stage2_wcs_loader` for a file that carries its WCS maps, else None:
    `correct_file`'s default, the jwst datamodel."""
    from surfh_tpu_torch.preprocessing.fits_io import fits_open
    from surfh_tpu_torch.simulation.stage2 import stage2_wcs_loader

    names = {str(h.header.get("EXTNAME", "")).strip() for h in fits_open(path)}
    return stage2_wcs_loader if WCS_MAPS <= names else None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--raw-dir", required=True)
    ap.add_argument("--out-dir", required=True)
    ap.add_argument("--npix", type=int, default=501)
    ap.add_argument("--wavel-cube", help=".npy global cube wavelength axis")
    ap.add_argument("--cpu", action="store_true", help="run the Shepard regrid on the host CPU")
    args = ap.parse_args(argv)

    import torch

    from surfh_tpu_torch.core.precision import require_cuda
    from surfh_tpu_torch.preprocessing.correction_driver import correct_file
    from surfh_tpu_torch.preprocessing.fits_io import fits_write

    dev = torch.device("cpu") if args.cpu else require_cuda()
    wavelength_cube = (
        np.load(args.wavel_cube) if args.wavel_cube else np.linspace(4.9, 28.3, 3182)
    )
    os.makedirs(args.out_dir, exist_ok=True)
    for fname in sorted(os.listdir(args.raw_dir)):
        if not fname.endswith(".fits"):
            continue
        # filenames like "..._ch1-2_dither3_cal.fits" carry two channels
        stem = os.path.splitext(fname)[0]
        chans = [p for p in stem.replace("-", "_").split("_") if p.startswith("ch")]
        wcs_loader = _wcs_loader(os.path.join(args.raw_dir, fname))
        for mode, chan_name in enumerate(chans[:2]):
            sorted_data, ifu, targ_ra, targ_dec = correct_file(
                os.path.join(args.raw_dir, fname), chan_name, args.npix, wavelength_cube, mode,
                wcs_loader=wcs_loader, device=dev,
            )
            flat = sorted_data.transpose(1, 0, 2).reshape(
                sorted_data.shape[1], sorted_data.shape[0] * sorted_data.shape[2]
            )
            out = os.path.join(args.out_dir, f"{chan_name}_{stem}_corrected.fits")
            fits_write(
                out,
                flat.astype(np.float32),
                header={
                    "PA_V3": float(ifu.fov.angle),
                    "TARG_RA": float(targ_ra),
                    "TARG_DEC": float(targ_dec),
                    "BAND": ifu.name,
                },
            )
            print(f"wrote {out}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
