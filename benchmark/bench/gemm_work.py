"""The GEMM work of a window-local configuration whose conv runs dense (the
λ-rank gate closed), counted from the configuration's shapes.

Per band (its λ window of W planes; the FOV bbox of ha α rows × wb β
columns on the sky grid, the union over the pointings of every source
pixel of nonzero bilinear weight; its OTF support of Ka' α rows × Kb' β
columns, the rows and columns where the reference's own band OTF,
`reference.operator.Reference._band_otf`, holds a nonzero bin) and per
direction, forward or transpose, in real multiply-adds:

* the conv's inverse stage, ``3·W·ha·Ka'·Kb' + 2·W·ha·Kb'·wb``: the α
  stage takes a complex product of [ha, Ka'] by [Ka', Kb'] on each plane,
  three real products in Gauss's form; the β stage keeps only the real
  part of [wb, Kb'] by [Kb', W] on each of the ha rows, two real products.
  These are the fewest real products a matmul spelling of the exact conv
  needs.  The transpose is the same count.
* the dense spectral blur, ``P·(S·A)·(sb·W)·K``: per pointing the slit
  windows' S·A rows of sb·W samples against the response's K detector
  rows at full support (as `yardstick.work_counts` counts the banded blur,
  with every entry kept).  The transpose is the same count.

Left out: the M maps' forward DFT and its transpose, and the templates'
mix into the W planes (2·W·M·Ka'·Kb'), small beside the α stage where
M ≪ ha.  The least time is the multiply-adds × 2 over the card's FP32 rate
(`yardstick.FP32_FLOPS_PER_S`): leaving work out makes it smaller, never
larger.

The conv's count is `scripts/torch_profile.py --wlocal`'s formula (4 × the
inverse stage's multiply-adds a band, summed, there read from the
program's tables), with one difference: the program convolves onto the
footprint of the band's whole local grid, this count onto the footprint of
the samples its slit windows read, a few rows and columns fewer (12-band
flagship: 2395.8 GFLOP a normal here, 2476.8 there).  The blur is what
this count adds.  Nothing of the program is read here.
"""

from __future__ import annotations

import numpy as np
import torch

from ..reference import instrument
from ..reference.operator import Reference
from .yardstick import FP32_FLOPS_PER_S


class _Support(Reference):
    """A reference that holds only what `Reference._band_otf` reads: the
    sky grid, the unknown's shape, the device and the dtypes."""

    def __init__(self, inputs: dict, device):
        self.device = torch.device(device)
        self.dtype, self.cdtype, self.tf32 = torch.float64, torch.complex128, False
        self.n = len(inputs["alpha"])
        self.x_shape = inputs["x_shape"]


def otf_support(stamps: np.ndarray, model: dict, inputs: dict, device) -> tuple:
    """(Ka', Kb'): the α rows and β columns where the reference's OTF of a
    band's stamps holds a nonzero bin, at the configuration's truncation."""
    nz = _Support(inputs, device)._band_otf(stamps, model) != 0
    return int(nz.any(dim=2).any(dim=0).sum()), int(nz.any(dim=1).any(dim=0).sum())


def fov_bbox(g, inputs: dict) -> tuple:
    """(ha, wb): the rows and columns of the sky grid spanned by the source
    pixels of nonzero bilinear weight, over every pointing."""
    n = len(inputs["beta"])
    flat = []
    for p in inputs["pointings"]:
        idx, w = instrument.bilinear(inputs["alpha"], inputs["beta"], g.window_points(p).reshape(-1, 2))
        flat.append(idx[w != 0])
    flat = np.concatenate(flat)
    a, b = flat // n, flat % n
    return int(a.max() - a.min() + 1), int(b.max() - b.min() + 1)


def band_macs(config: dict, device=None) -> list:
    """Per band, one direction's multiply-adds: {"band", "W", "ha", "wb",
    "Ka", "Kb", "conv", "blur"}."""
    model = config["model"]
    if not model.get("window_local") or float(model.get("conv_rank_rtol", 0.0)) > 0:
        raise ValueError("the GEMM count is of a window-local configuration with the rank gate closed")
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    inp = instrument.problem_inputs(config["problem"])
    out = []
    for name in inp["bands"]:
        g = instrument.band_geometry(name, inp)
        ka, kb = otf_support(inp["stamps"][g.wslice], model, inp, device)
        ha, wb = fov_bbox(g, inp)
        w = g.n_w
        out.append({"band": name, "W": w, "ha": ha, "wb": wb, "Ka": ka, "Kb": kb,
                    "conv": 3 * w * ha * ka * kb + 2 * w * ha * kb * wb,
                    "blur": len(inp["pointings"]) * g.n_slit * g.n_a * g.n_b * w * len(g.wavel_det)})
    return out


def normal_flops(config: dict, device=None) -> float:
    """FP32 operations a normal application needs of the GEMMs: both
    directions of every band's conv and blur, 2 a multiply-add."""
    return 2.0 * 2.0 * sum(b["conv"] + b["blur"] for b in band_macs(config, device))


def least_seconds(config: dict, device=None) -> float:
    """The least time of a normal's GEMM work at the card's FP32 rate."""
    return normal_flops(config, device) / FP32_FLOPS_PER_S
