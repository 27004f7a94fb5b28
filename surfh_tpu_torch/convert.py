"""The reference model's tables carried across to the port.

Rank mode: `host_tables_from_reference` takes the `host_tables()` tree of a
JAX `surfh_tpu.models.spectro.SpectroSigRLSCT` built in the flagship
configuration (window-local, PSF stamps, λ-rank, host-materialized — all
NumPy) plus each channel's `_composed_stack` (NumPy), and returns the port's
host tree; `tables_from_reference` moves it to a device.

Materialized-OTF mode: `wplane_tables_from_reference` takes a
non-window-local reference model's `_sotf_dev` and `_templates_dev` and,
per channel, its `_wpsf_dev`, `slit_weights_sub`, `_composed_stack`,
`_tbbox` and (banded models) `band_plan()` / `band_plan_t()`, and returns
the port's device tables.

Both packages then compute the same operator from the same numbers; the
port's own `SpectroSigRLSCT.host_tables()` builds the same trees without
JAX.  Nothing here imports JAX: the inputs are NumPy arrays and plain
objects (a band plan is read through its attributes).
"""

from __future__ import annotations

import numpy as np
import torch

from .core.wblur_banded import BandPlan, BandPlanT
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


def wplane_tables_from_reference(sotf, templates, channels, device, dtype=torch.float32) -> dict:
    """Reference W-plane tables → the port's device tables.

    `channels`: per channel a tuple (wpsf [K, W, sb], slit_w [S, A, sb],
    composed_stack, tbbox, band_plan, band_plan_t); the plans are the
    reference's `BandPlan` / `BandPlanT` (or None for a dense model)."""
    chans = []
    for wpsf, slit_w, stack, tbbox, plan, plan_t in channels:
        slit_w = np.asarray(slit_w)
        S, A, sb = slit_w.shape
        stack = tuple(np.asarray(a) for a in stack)
        n_patch = int(tbbox[2]) * int(tbbox[3])
        fwd, adj = gather_plans_from_composed(stack, n_patch, S * A * sb)
        t = {"wpsf": np.asarray(wpsf), "slit_w": slit_w, "gather_fwd": fwd, "gather_t": adj}
        if plan is not None:
            t["band_plan"] = BandPlan(np.asarray(plan.starts), int(plan.K), int(plan.W),
                                      int(plan.B), int(plan.Bp), int(plan.LB), int(plan.TK))
            t["band_plan_t"] = BandPlanT(np.asarray(plan_t.starts), int(plan_t.K), int(plan_t.W),
                                         int(plan_t.B), int(plan_t.Bp), int(plan_t.TL),
                                         int(plan_t.KB))
        chans.append(t)
    host = {"sotf": np.asarray(sotf), "templates": np.asarray(templates), "chan": tuple(chans)}
    return device_tables(host, device, dtype)
