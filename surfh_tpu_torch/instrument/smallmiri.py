"""Scaled-down MIRI MRS test instrument: resolutions ÷ 4 for cheap tests.

The port's own copy of `surfh_tpu/instrument/smallmiri.py` (same code).

Parity with surfh/Models/smallmiri.py:60-71.
"""

from __future__ import annotations

from .miri import BANDS, build_ifu


def __getattr__(name: str):
    if name.startswith("ch") and name[2:] in BANDS:
        return build_ifu(name[2:], resolution_scale=0.25)
    if name == "all_chan":
        return [build_ifu(b, resolution_scale=0.25) for b in BANDS]
    raise AttributeError(name)
