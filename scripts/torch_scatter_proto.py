"""The composed-transpose row gather, four spellings checked and timed: the
port's counterpart of `scripts/scatter_pallas_proto.py`.

One band's composed transpose (window rows → patch rows, pointing 0) at
Q = W, the width of the W-plane path, flagship geometry (501², one
pointing, rank-mode model):

    out[p, :] = Σ_l tw[p, l] · vals[tsrc[p, l], :]

* A  — the COO transpose `core.bilinear.apply_composed_plan_t` (plain torch,
  index_add_), the reference of the checks;
* K1 / K2 / K3 — the fixed-fan-in kernels of `core.gather_fixed`
  (``csrc/gather_fixed.cu``): all L taps, ``cnt[p]`` taps, all L taps
  from pre-scaled offsets;
* and, as yardsticks that no path of the port uses, the CSR kernel of
  `core.gather_rows` and the library call
  ``torch.sparse.mm(torch.sparse_csr_tensor(row_ptr, idx, w), vals)``
  (cuSPARSE SpMM).

Prints the header line (``P->Pp n_out W L ...``) and ``check K1/K2/K3: max
rel`` against A.  On the card (the default) it also checks K1–K3 against
their plain versions and the CSR kernel, and prints each kernel's time
(CUDA events, mean of `EVENT_REPS` launches) beside its plain version's
and the byte bound, then the chained times of the JAX script
(`utils.profiling.chained_time`: `--chain` dependent applications, median
of `--reps`, the feedback included).  ``--cpu`` runs the plain versions
only and checks them (no times), as the JAX script's interpret mode does.

    python scripts/torch_scatter_proto.py [--band 1c] [--npix 501] [--chain 10]
                                          [--reps 3] [--tp 512] [--cpu]
"""

from __future__ import annotations

import argparse
import os
import sys
import time
import warnings

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory (NVIDIA's data sheet)
SM_CYCLES_PER_S = 1.98e9  # H100 SXM boost clock: the unit of the device-side wait in event_ms
EVENT_WARMUP, EVENT_REPS = 2, 50  # untimed and timed launches per CUDA-event time
PLAIN_REPS = 20  # timed applications of a plain version


def library_csr(plan, device):
    """A host CSR plan (`core.gather_rows.RowGatherPlan`) as a torch sparse
    CSR matrix [n_rows, n_src], f32 on `device`, with its columns sorted
    within each row as the library wants: the operand of the yardstick
    ``torch.sparse.mm``, which no path of the port calls."""
    import torch

    order = np.lexsort((plan.idx, plan.dst))
    with warnings.catch_warnings():  # "sparse CSR support is in beta"
        warnings.simplefilter("ignore", UserWarning)
        return torch.sparse_csr_tensor(
            torch.as_tensor(plan.row_ptr, device=device), torch.as_tensor(plan.idx[order], device=device),
            torch.as_tensor(plan.w[order], dtype=torch.float32, device=device),
            size=(plan.n_rows, plan.n_src), check_invariants=True)


def gather_bytes(n_rows: int, n_src: int, q: int, nnz: int) -> float:
    """The least bytes of a row gather: the output [n_rows, q] written once,
    the `n_src` source rows that the taps name read once, the nnz CSR taps
    (index and weight) and the row pointers read once, f32 / int32."""
    return 4.0 * (n_rows * q + n_src * q + 2 * nnz + n_rows + 1)


def event_ms(fn, reps: int, warmup: int = EVENT_WARMUP) -> float:
    """Mean device ms per call of `fn`, CUDA events around `reps` calls
    after `warmup` untimed ones.  The timed calls are enqueued behind a
    device-side wait twice as long as the host needs to enqueue them (as
    the warm-up calls took), so the device finds them queued and runs them
    back to back: a kernel shorter than its launch on a busy host is timed
    as the kernel, not as the host."""
    import torch

    enqueue = float("inf")
    for _ in range(warmup):
        t0 = time.perf_counter()
        fn()
        enqueue = min(enqueue, time.perf_counter() - t0)
    torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(min(2.0 * enqueue * reps, 0.1) * SM_CYCLES_PER_S))
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / reps


def launches_per_run(chain: int = 10, reps: int = 3) -> int:
    """Launches of each of K1, K2, K3 in one `run_proto` on the card: the
    check, the CUDA-event time, and ``reps + 1`` chains of `chain`."""
    return 1 + EVENT_WARMUP + EVENT_REPS + (reps + 1) * chain


def transpose_taps(chan):
    """`chan`'s pointing-0 composed transpose as COO taps without zero
    weights: (source rows, weights, destination rows, P, source count, W)."""
    _idx, _w, csrc, cw, cdst = (np.asarray(a[0]) for a in chan.composed_stack)
    nz = cw != 0
    return csrc[nz], cw[nz], cdst[nz], chan.tbbox[2] * chan.tbbox[3], _idx.shape[1], chan.n_wslice


def run_proto(chan, device, tp: int = 512, chain: int = 10, reps: int = 3, band: str = "",
              log=print) -> dict:
    """Check and time the spellings on `chan`'s pointing-0 composed
    transpose at Q = W (`chan`: a port `Channel`).

    Returns the shapes and ``check`` (max rel against A of K1, K2, K3, CSR
    and the library).  On the card also: ``vs_plain`` / ``err_plain`` (K1–K3
    against their plain versions, max rel / max abs), ``vs_csr`` (against
    the CSR kernel, max rel), ``ms`` (CUDA events, mean of `EVENT_REPS`
    launches: K1, K2, K3, CSR, library), ``plain_ms`` (K1–K3's plain
    versions, mean of `PLAIN_REPS`), ``bound_ms`` / ``bound_mb`` (the byte
    bound), ``k2_shape`` / ``k13_shape`` (K2's and K1 / K3's launch shape)
    and, when `chain` > 0,
    ``chained_ms`` (`chained_time`, as the JAX script times: A, K1, K2, K3,
    CSR, library)."""
    import torch

    from surfh_tpu_torch.core import bilinear
    from surfh_tpu_torch.core import gather_fixed as gf
    from surfh_tpu_torch.core import gather_rows as gr
    from surfh_tpu_torch.utils.profiling import chained_time

    device = torch.device(device)
    csrc, cw, cdst, P, n_out, W = transpose_taps(chan)
    plan = gf.build_fixed_fanin_plan(csrc, cw, cdst, P, n_out, tp, ld=W)
    csr = gr.build_row_gather_plan(csrc, cw, cdst, P, n_out)
    out = dict(band=band, P=P, Pp=plan.n_padded, n_src=n_out, W=W, L=plan.L, nnz=csr.nnz,
               padded_over_nnz=plan.n_padded * plan.L / max(csr.nnz, 1))
    log(f"band {band}: P={P}->{plan.n_padded} n_out={n_out} W={W} L={plan.L} nnz={csr.nnz} "
        f"padded taps/nnz={out['padded_over_nnz']:.2f} vals={n_out * W * 4 / 1e6:.1f} MB "
        f"on {device}")

    f32 = torch.float32
    rng = np.random.default_rng(0)
    vals = torch.as_tensor(rng.standard_normal((W, n_out)).astype(np.float32), device=device)
    rows = vals.T.contiguous()  # [n_src, W]: the row gathers' layout
    dplan, dcsr = plan.to(device, f32), csr.to(device, f32)
    tcsrc, tcdst = (torch.as_tensor(a, device=device) for a in (csrc, cdst))
    tcw = torch.as_tensor(cw, dtype=f32, device=device)
    spm = library_csr(csr, device)

    fns = {
        "A": lambda v: bilinear.apply_composed_plan_t(tcsrc, tcw, tcdst, v, P),  # [W, P]
        "K1": lambda x: gf.gather_fixed_k1(x, dplan),
        "K2": lambda x: gf.gather_fixed_k2(x, dplan),
        "K3": lambda x: gf.gather_fixed_k3(x, dplan),
        "CSR": lambda x: gr.gather_rows(x, dcsr),
        "library": lambda x: torch.sparse.mm(spm, x),
    }
    plain = {"K1": gf.gather_fixed_k1_reference, "K2": gf.gather_fixed_k2_reference,
             "K3": gf.gather_fixed_k3_reference}
    ref = fns["A"](vals).T  # [P, W]
    scale = float(ref.abs().max().clamp_min(1e-30))
    out["check"], got = {}, {}
    for name in ("K1", "K2", "K3", "CSR", "library"):
        got[name] = fns[name](rows)
        out["check"][name] = float((got[name] - ref).abs().max()) / scale
        log(f"  check {name}: max rel {out['check'][name]:.2e}")

    if device.type != "cuda":
        log("  (CPU: plain versions, correctness only)")
        return out

    def rel(a, b) -> float:
        return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))

    # the same taps in the same order as the plain versions: only the FMA
    # contraction differs
    out["vs_plain"], out["err_plain"], out["vs_csr"], out["plain_ms"] = {}, {}, {}, {}
    for k, pfn in plain.items():
        want = pfn(rows, dplan)
        out["vs_plain"][k] = rel(got[k], want)
        out["err_plain"][k] = float((got[k] - want).abs().max())
        out["vs_csr"][k] = rel(got[k], got["CSR"])
        out["plain_ms"][k] = event_ms(lambda: pfn(rows, dplan), PLAIN_REPS)
        log(f"  {k} against its plain version: max rel {out['vs_plain'][k]:.2e}; against the CSR "
            f"kernel {out['vs_csr'][k]:.2e}")
    del got
    aligned = rows.data_ptr() % 16 == 0
    out["k2_shape"] = gr.gather_launch_shape(W, aligned, dplan.nnz / max(P, 1))
    out["k13_shape"] = gf.fixed_launch_shape(W, gf._align(rows))
    log(f"  launch shapes (vec, cols, taps, group) at W = {W}: K2 {out['k2_shape']} "
        f"({dplan.nnz / max(P, 1):.2f} taps per row), K1 / K3 {out['k13_shape']} (all L = {dplan.L} taps)")
    out["ms"] = {name: event_ms(lambda: fns[name](rows), EVENT_REPS)
                 for name in ("K1", "K2", "K3", "CSR", "library")}
    nbytes = gather_bytes(P, np.unique(csr.idx).size, W, csr.nnz)
    out["bound_mb"], out["bound_ms"] = nbytes / 1e6, nbytes / HBM_BYTES_PER_S * 1e3
    labels = {"A": "A  column scatter (plain torch)", "K1": "K1 CUDA all L taps",
              "K2": "K2 CUDA dynamic count", "K3": "K3 CUDA pre-scaled offsets",
              "CSR": "CSR kernel (gather_rows)", "library": "library torch.sparse.mm (CSR)"}
    log(f"  CUDA events, mean of {EVENT_REPS} launches; byte bound {out['bound_ms']:.4f} ms "
        f"({out['bound_mb']:.2f} MB at {HBM_BYTES_PER_S / 1e12:.2f} TB/s)")
    for name, ms in out["ms"].items():
        extra = f", plain {out['plain_ms'][name]:.4f} ms" if name in plain else ""
        if name in ("K1", "K3"):
            extra += f"; {ms / out['ms']['K2']:.2f}x K2"
        log(f"  {labels[name]:32s} {ms:8.4f} ms ({100 * out['bound_ms'] / ms:.1f} % of the "
            f"bound{extra})")
    if chain > 0:
        log(f"  chained ({chain} dependent applications, median of {reps}, the feedback's add "
            f"and sum included):")
        out["chained_ms"] = {}
        for name, fn in fns.items():
            ms = chained_time(fn, vals if name == "A" else rows, chain=chain, reps=reps) * 1e3
            out["chained_ms"][name] = ms
            log(f"  {labels[name]:32s} {ms:8.4f} ms")
    return out


def run(band: str = "1c", npix: int = 501, tp: int = 512, chain: int = 10, reps: int = 3,
        device=None, log=print) -> dict:
    """The entry point: the flagship rank-mode model of `band` alone, one
    pointing, at `npix`² (host tables on the CPU), then `run_proto` on the
    card (`device` None) or on `device`."""
    from surfh_tpu_torch.core.precision import require_cuda
    from surfh_tpu_torch.simulation.flagship import make_flagship_model, make_flagship_setup

    device = require_cuda() if device is None else device
    setup = make_flagship_setup(npix=npix, bands=[band], n_pointings=1)
    model, _ = make_flagship_model(setup)
    return run_proto(model.channels[0], device, tp=tp, chain=chain, reps=reps, band=band, log=log)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--band", default="1c")
    ap.add_argument("--npix", type=int, default=501)
    ap.add_argument("--chain", type=int, default=10)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--tp", type=int, default=512)
    ap.add_argument("--cpu", action="store_true", help="plain versions on the CPU, checks only")
    args = ap.parse_args(argv)
    run(args.band, args.npix, args.tp, args.chain, args.reps, "cpu" if args.cpu else None)
    return 0


if __name__ == "__main__":
    sys.exit(main())
