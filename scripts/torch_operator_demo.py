#!/usr/bin/env python3
"""Run any operator of the single-stage ladder on synthetic data, with the
PyTorch port (the counterpart of `scripts/run_operator_demo.py`).

Builds the operator, runs its forward and exact (derived) adjoint, checks
the dot test, and optionally runs 20 CG iterations on the normal
equations; prints one JSON report with the reference script's keys.  On
the card unless ``--cpu``.

    python3 scripts/torch_operator_demo.py --op SigRLCT --solve
    python3 scripts/torch_operator_demo.py --op SigRLSCT --flagship-band 1c --solve
    python3 scripts/torch_operator_demo.py --list

``--flagship-band 1c`` builds the operator from the flagship setup of that
band (`make_flagship_setup(bands=["1c"], build_sotf=True)`: 501² at
0.025″, 4 pointings, M = 4 templates, the band's instrument and λ axis,
the OTF built on the device) instead of the small synthetic `make_setup`.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

OPS = [
    "T", "C", "CT", "ST", "ST_NN", "SCT", "LT", "LST", "MO_ST", "R", "RL",
    "RLT", "SigRLT", "SigRLCT", "SigRLSCT", "SigRLSCT_NN", "MO_SigRLSCT",
    "MO_SigRLSCT_shiftConv", "MCMO_SigRLSCT", "MCMO_SigRLSCT_NN",
]


def build(op_name: str, fx: dict, dtype, device):
    """The operator `op_name` on setup `fx`, in `dtype` on `device` (the
    flagship-operator aliases moved there with `.to`)."""
    import torch

    from surfh_tpu_torch.models import family as F

    a = (fx["sotf"], fx["templates"], fx["alpha_axis"], fx["beta_axis"], fx["wavelength_axis"])
    one = fx["instrs"][0]
    sd = fx["step_degree"]
    pts = fx["pointings"][0]
    kw = dict(dtype=dtype, device=device)
    table = {
        "T": lambda: F.SpectroT(fx["maps"], fx["templates"], fx["wavelength_axis"], **kw),
        "C": lambda: F.SpectroC(fx["sotf"], fx["maps"], fx["templates"], fx["wavelength_axis"], **kw),
        "CT": lambda: F.SpectroCT(*a, **kw),
        "ST": lambda: F.SpectroST(*a, one, sd, **kw),
        "ST_NN": lambda: F.SpectroSnearestT(*a, one, sd, **kw),
        "SCT": lambda: F.SpectroSCT(*a, one, sd, **kw),
        "LT": lambda: F.SpectroLT(*a, one, sd, **kw),
        "LST": lambda: F.SpectroLST(*a, one, sd, **kw),
        "MO_ST": lambda: F.SpectroMO_ST(*a, one, sd, pts, **kw),
        "R": lambda: F.SpectroR(*a, one, sd, **kw),
        "RL": lambda: F.SpectroRL(*a, one, sd, **kw),
        "RLT": lambda: F.SpectroRLT(*a, one, sd, **kw),
        "SigRLT": lambda: F.SpectroSigRLT(*a, one, sd, **kw),
        "SigRLCT": lambda: F.SpectroSigRLCT(*a, one, sd, **kw),
        "SigRLSCT": lambda: F.SpectroSigRLSCT1C(*a, one, sd, **kw),
        "SigRLSCT_NN": lambda: F.SpectroSigRLSCT1C_NN(*a, one, sd, **kw),
        "MO_SigRLSCT": lambda: F.MO_SigRLSCT(*a, one, sd, pts, **kw),
        "MO_SigRLSCT_shiftConv": lambda: F.MO_SigRLSCT_shiftConv(*a, one, sd, pts, **kw),
        "MCMO_SigRLSCT": lambda: F.MCMO_SigRLSCT(*a, fx["instrs"], sd, fx["pointings"], dtype=dtype),
        "MCMO_SigRLSCT_NN": lambda: F.MCMO_SigRLSCT_NN(*a, fx["instrs"], sd, fx["pointings"],
                                                       dtype=dtype),
    }
    op = table[op_name]()
    if op_name.startswith("MCMO"):
        op.to(torch.device(device), dtype)
    return op


def make_fx(npix: int, n_lambda: int, channels: int, flagship_band, device) -> dict:
    """The small synthetic setup (the reference script's), or the flagship
    setup of one band with its OTF on `device`."""
    if flagship_band:
        from surfh_tpu_torch.simulation.flagship import make_flagship_setup

        return make_flagship_setup(bands=[flagship_band], build_sotf=True, device=device)
    from surfh_tpu_torch.simulation.synthetic import make_setup

    return make_setup(im_size=npix, n_lambda=n_lambda, n_tpl=3, n_channels=channels, n_pointings=2,
                      n_slit=3)


def run(argv=None) -> dict:
    """Parse `argv`, run the operator, return the report (None for --list)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--op", default="SigRLSCT", choices=OPS)
    ap.add_argument("--list", action="store_true")
    ap.add_argument("--npix", type=int, default=41)
    ap.add_argument("--n-lambda", type=int, default=30)
    ap.add_argument("--channels", type=int, default=2)
    ap.add_argument("--flagship-band", default=None,
                    help="build from the flagship setup of this MIRI band (e.g. 1c)")
    ap.add_argument("--solve", action="store_true", help="run a 20-iteration CG inverse")
    ap.add_argument("--cpu", action="store_true", help="run on the host CPU instead of the card")
    args = ap.parse_args(argv)
    if args.list:
        print("\n".join(OPS))
        return None

    import torch

    from surfh_tpu_torch.core.linop import dottest
    from surfh_tpu_torch.core.precision import pick_device

    device = pick_device("cpu" if args.cpu else None)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    fx = make_fx(args.npix, args.n_lambda, args.channels, args.flagship_band, device)
    op = build(args.op, fx, torch.float32, device)
    x = np.random.default_rng(0).random(op.ishape)
    t0 = time.perf_counter()
    y = op.forward(x)
    sync()
    t_fwd = time.perf_counter() - t0
    t0 = time.perf_counter()
    op.adjoint(y)
    sync()
    t_adj = time.perf_counter() - t0
    report = {
        "op": args.op,
        "ishape": list(op.ishape),
        "oshape": list(op.oshape),
        "fwd_s": round(t_fwd, 4),
        "adj_s": round(t_adj, 4),
        "dottest": bool(dottest(op, num=2, rtol=1e-3)),
    }
    if args.solve:
        from surfh_tpu_torch.solvers.cg import lcg

        b = op.adjoint(y)
        res = lcg(lambda v: op.adjoint(op.forward(v)), b,
                  torch.zeros(op.ishape, dtype=torch.float32, device=device), max_iter=20)
        report["solve_grad_drop"] = float(res.grad_norm[-1] / res.grad_norm[0])
    return report


def main(argv=None) -> int:
    report = run(argv)
    if report is not None:
        print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
