#!/usr/bin/env python3
"""Median-filter corrected slice files along λ with `surfh_tpu_torch`
(the counterpart of `scripts/filter_slices.py`): the size-11 spectral-line
filter of the reference's `filter_corrected_mrs_data.py`, keeping the
PA_V3 / TARG_RA / TARG_DEC / BAND headers.

    python3 scripts/torch_filter_slices.py --in-dir Corrected_slices --out-dir Filtered_slices \\
        [--size 11] [--match STR]

Host NumPy and SciPy (`preprocessing.median_filter_slices`, as in the
port's rehearsal): nothing here runs on a card, so the tool needs none.
Imports no JAX.  Exits 1 when no file matches.
"""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--in-dir", required=True)
    ap.add_argument("--out-dir", required=True)
    ap.add_argument("--size", type=int, default=11, help="median window along λ")
    ap.add_argument("--match", default="", help="only files containing this substring")
    args = ap.parse_args(argv)

    from surfh_tpu_torch.preprocessing import median_filter_slices
    from surfh_tpu_torch.preprocessing.fits_io import fits_open, fits_write

    os.makedirs(args.out_dir, exist_ok=True)
    n = 0
    for fname in sorted(os.listdir(args.in_dir)):
        if not fname.endswith(".fits") or args.match not in fname:
            continue
        hdus = fits_open(os.path.join(args.in_dir, fname))
        hdr = hdus[0].header
        filtered = median_filter_slices(np.asarray(hdus[0].data), size=args.size)
        out = os.path.join(args.out_dir, os.path.splitext(fname)[0] + "_filtered.fits")
        fits_write(out, filtered.astype(np.float32),
                   header={k: hdr[k] for k in ("PA_V3", "TARG_RA", "TARG_DEC", "BAND") if k in hdr})
        print(f"wrote {out}", flush=True)
        n += 1
    if n == 0:
        print("no matching .fits files found", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
