"""NumPy reference kernel of the data re-projections.

The port's own copy of `apply_plan` from `surfh_tpu/core/numpy_ref.py`
(same code): the 4-corner bilinear gather in plain NumPy, which the
data-side methods of `models.channel` and `models.spectro` (`sliceToCube`,
`realData_*`, `plot_slice`) re-project through.  The rest of the original
module (its DFT / LMM / blur spellings and the reference-structured
channel and model pipelines) is not copied yet (ROADMAP A9).
"""

from __future__ import annotations

import numpy as np


def apply_plan(plan, cube):
    """NumPy twin of `core.bilinear.apply_plan`: 4-corner gather."""
    flat = cube.reshape(cube.shape[:-2] + (-1,))
    out = np.zeros(cube.shape[:-2] + (plan.npoints,), cube.dtype)
    for c in range(plan.idx.shape[0]):
        out += plan.w[c] * flat[..., plan.idx[c]]
    return out
