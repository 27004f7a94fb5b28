"""The reference model's tables carried across to the port.

`host_tables_from_reference` takes the `host_tables()` tree of a JAX
`surfh_tpu.models.spectro.SpectroSigRLSCT` built in the flagship
configuration (window-local, PSF stamps, λ-rank, host-materialized — all
NumPy) plus each channel's `_composed_stack` (NumPy), and returns the port's
host tree; `tables_from_reference` moves it to a device.  Both packages
then compute the same operator from the same numbers.  The port's own
`SpectroSigRLSCT.host_tables()` builds the same tree without JAX.

Nothing here imports JAX: the inputs are plain NumPy arrays.
"""

from __future__ import annotations

import numpy as np
import torch

from .models.channel import gather_plans_from_composed
from .models.spectro import device_tables


def host_tables_from_reference(host_tables: dict, composed_stacks) -> dict:
    """Reference host tables + composed stacks → the port's host tree."""
    chans = []
    for t, stack in zip(host_tables["chan"], composed_stacks):
        if "wpsf_q" not in t or "sotf_ri" not in t:
            raise ValueError("reference tables are not rank-mode host-materialized "
                             "(need 'wpsf_q' and 'sotf_ri')")
        stack = tuple(np.asarray(a) for a in stack)
        slit_w = np.asarray(t["slit_w"])
        S, A, sb = slit_w.shape
        n_patch = int(np.asarray(t["dftm"]["ifa_re"]).shape[0]
                      * np.asarray(t["dftm"]["icb_re"]).shape[0])
        fwd, adj = gather_plans_from_composed(stack, n_patch, S * A * sb)
        chans.append({
            "slit_w": slit_w,
            "gather_fwd": fwd,
            "gather_t": adj,
            "dftm": {k: np.asarray(v) for k, v in t["dftm"].items()},
            "cu": np.asarray(t["cu"]),
            "sotf_ri": np.asarray(t["sotf_ri"]),
            "wpsf_q": np.asarray(t["wpsf_q"]),
        })
    return {"chan": tuple(chans)}


def tables_from_reference(host_tables: dict, composed_stacks, device, dtype=torch.float32) -> dict:
    """Reference tables → the port's device tables (see `models.spectro.device_tables`)."""
    return device_tables(host_tables_from_reference(host_tables, composed_stacks), device, dtype)
