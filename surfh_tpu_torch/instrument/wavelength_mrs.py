"""Real-data MRS wavelength grids (from JWST stage-2 cube headers).

Parity with surfh's `wavelength_mrs.py:20-46`; grids are stored in the
bundled calibration npz instead of a hard-coded module.  The port's own copy
of `surfh_tpu/instrument/wavelength_mrs.py` (same code).
"""

from __future__ import annotations

import numpy as np

from .miri import BANDS, _calibration


def get_mrs_wavelength(chan_name: str) -> np.ndarray:
    name = chan_name.lower()
    if name.startswith("ch"):
        name = name[2:]
    if name not in BANDS:
        raise ValueError(f"Error reading wavelength, {chan_name!r} is not a valid band")
    return np.asarray(_calibration()[f"wavelength_{name}"])
