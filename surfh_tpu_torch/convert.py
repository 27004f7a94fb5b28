"""The reference model's tables carried across to the port.

Window-local mode: `host_tables_from_reference` takes the `host_tables()`
tree of a JAX `surfh_tpu.models.spectro.SpectroSigRLSCT` built window-local
(all NumPy) plus each channel's `_composed_stack` (NumPy), and returns the
port's host tree; `tables_from_reference` moves it to a device.  Each
channel carries its own kind of tables: λ-rank, host-materialized (`dftm`,
`cu`, `sotf_ri`, `wpsf_q`); dense stamps (`dftm`, `psf`, `stamp`, `wpsf`);
an OTF window (`sotf_ri` → the port's complex `sotf_w`, `wpsf`, and `dftm`
with the matmul conv — the FFT conv has none, so pass each channel's
`_tbbox` as `tbboxes`).

Materialized-OTF mode: `wplane_tables_from_reference` takes a
non-window-local reference model's `_sotf_dev` and `_templates_dev` and,
per channel, its `_wpsf_dev`, `slit_weights_sub`, `_composed_stack`,
`_tbbox` and (banded models) `band_plan()` / `band_plan_t()`, and returns
the port's device tables.

Both packages then compute the same operator from the same numbers; the
port's own `SpectroSigRLSCT.host_tables()` builds the same trees without
JAX.

The blind-2D models and a channel's gridding: `blind2d_tables` takes a
`MRSBlurred`, `MRSBlurredRectangle` or `DeconvCube` of either package and
returns its host tables (slit starts and weights, the box-sum OTF, the
sotf or sotf stack, the bilinear plans or the crop windows);
`channel_tables_from_reference` takes a JAX `Channel` (bilinear or
nearest-neighbour, composed or staged, dense or banded) and returns its
gridding tables under the port's `Channel` attribute names (plans, FOV
bbox, box offset, composed stack, slit tables, wpsf, the spectral blur and
a banded channel's band plans).  Nothing here imports JAX: the inputs are NumPy arrays and plain
objects (a band plan is read through its attributes).
"""

from __future__ import annotations

import numpy as np
import torch

from .core.wblur_banded import BandPlan, BandPlanT
from .models.channel import gather_plans_from_composed
from .models.spectro import device_tables


def host_tables_from_reference(host_tables: dict, composed_stacks, tbboxes=None) -> dict:
    """Reference window-local host tables + composed stacks → the port's host tree."""
    chans = []
    for c, (t, stack) in enumerate(zip(host_tables["chan"], composed_stacks)):
        stack = tuple(np.asarray(a) for a in stack)
        slit_w = np.asarray(t["slit_w"])
        S, A, sb = slit_w.shape
        if "dftm" in t:
            n_patch = int(np.asarray(t["dftm"]["ifa_re"]).shape[0]
                          * np.asarray(t["dftm"]["icb_re"]).shape[0])
        elif tbboxes is not None:
            n_patch = int(tbboxes[c][2]) * int(tbboxes[c][3])
        else:
            raise ValueError("an FFT-conv channel has no DFT tables: pass the channels' tbboxes")
        fwd, adj = gather_plans_from_composed(stack, n_patch, S * A * sb)
        out = {"slit_w": slit_w, "gather_fwd": fwd, "gather_t": adj}
        if "dftm" in t:
            out["dftm"] = {k: np.asarray(v) for k, v in t["dftm"].items()}
        if "wpsf_q" in t:
            out.update(cu=np.asarray(t["cu"]), sotf_ri=np.asarray(t["sotf_ri"]),
                       wpsf_q=np.asarray(t["wpsf_q"]))
        elif "psf" in t:
            out.update(psf=np.asarray(t["psf"]), wpsf=np.asarray(t["wpsf"]),
                       stamp={k: np.asarray(v) for k, v in t["stamp"].items()})
        elif "sotf_ri" in t:
            ri = np.asarray(t["sotf_ri"])
            out.update(sotf_w=ri[0] + 1j * ri[1], wpsf=np.asarray(t["wpsf"]))
        else:
            raise ValueError("reference tables are not window-local (need 'wpsf_q', 'psf' "
                             "or 'sotf_ri')")
        chans.append(out)
    return {"chan": tuple(chans)}


def tables_from_reference(host_tables: dict, composed_stacks, device, dtype=torch.float32,
                          tbboxes=None) -> dict:
    """Reference tables → the port's device tables (see `models.spectro.device_tables`)."""
    return device_tables(host_tables_from_reference(host_tables, composed_stacks, tbboxes),
                         device, dtype)


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
            t["band_plan"], t["band_plan_t"] = band_plans_from_reference(plan, plan_t)
        chans.append(t)
    host = {"sotf": np.asarray(sotf), "templates": None if templates is None else np.asarray(templates),
            "chan": tuple(chans)}
    return device_tables(host, device, dtype)


def band_plans_from_reference(plan, plan_t) -> tuple:
    """The reference's `BandPlan` / `BandPlanT` → the port's (its blocked
    f32 tables stay behind: the port's `banded_tables` lays out its own)."""
    return (BandPlan(np.asarray(plan.starts), int(plan.K), int(plan.W), int(plan.B),
                     int(plan.Bp), int(plan.LB), int(plan.TK)),
            BandPlanT(np.asarray(plan_t.starts), int(plan_t.K), int(plan_t.W), int(plan_t.B),
                      int(plan_t.Bp), int(plan_t.TL), int(plan_t.KB)))


def blind2d_tables(model) -> dict:
    """A blind-2D model's host tables (either package: the attribute
    names are the same), NumPy arrays keyed by the attribute they come from."""
    base = getattr(model, "base", model)
    t = {k: np.asarray(getattr(base, k)) for k in
         ("slit_a_starts", "slit_b_starts", "slit_weights_sub", "otf_combined", "sotf")}
    t["local_im_shape"] = tuple(base.local_im_shape)
    t["slices_shape"] = tuple(base.slices_shape)
    if hasattr(base, "plans"):
        t["plans"] = [(np.asarray(p.idx), np.asarray(p.w)) for p in base.plans]
    if hasattr(base, "windows"):
        t["windows"] = [(sa.start, sa.stop, sb.start, sb.stop) for sa, sb in base.windows]
    if hasattr(model, "sotf_stack"):
        t["sotf_stack"] = np.asarray(model.sotf_stack)
    return t


def channel_tables_from_reference(chan) -> dict:
    """A JAX `Channel`'s gridding and slit tables under the port's
    `models.channel.Channel` attribute names, with its spectral blur
    (`wblur_impl`, `wblur_band_rtol`) and, for a banded channel, its band
    plans as the port's `band_plan` / `band_plan_t` (`band_plans`)."""
    out = {
        "gridding": chan.gridding,
        "plans_fwd": [(np.asarray(p.idx), np.asarray(p.w)) for p in chan.plans_fwd],
        "tbbox": tuple(int(v) for v in chan._tbbox),
        "box_offset": chan._box_offset,
        "composed_stack": (None if chan._composed_stack is None
                           else tuple(np.asarray(a) for a in chan._composed_stack)),
        "slit_a_starts": np.asarray(chan.slit_a_starts),
        "slit_b_starts": np.asarray(chan.slit_b_starts),
        "slit_weights_sub": np.asarray(chan.slit_weights_sub),
        "wpsf": np.asarray(chan.wpsf),
        "wblur_impl": chan.wblur_impl,
        "wblur_band_rtol": float(chan.wblur_band_rtol),
    }
    if chan.wblur_impl == "banded":
        out["band_plans"] = band_plans_from_reference(chan.band_plan(), chan.band_plan_t())
    return out
