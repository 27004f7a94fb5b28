#!/usr/bin/env python3
"""Sweep the launch shapes of the redesigned kernels on one NVIDIA card.

    python3 scripts/torch_kernel_sweep.py [--reps 30]

No model is built: the shapes are the 12-band flagship's, as its plans give
them (`BANDS`: S·A rows, K, W, β width, band length, λ'-tiles at
wblur_band_rtol 1e-4; `GATHERS`: the pointing-0 composed transposes), with
random tables and taps from a seed.

* the banded forward (`core.wblur_banded`): every split 1..min(B, 16) of the
  contraction per band — checked against the run-by-run plain spelling
  (≤ 1e-5), two launches bit-identical — its time beside the split that
  `forward_launch_shape` picks, cuBLAS on the masked table and the FP32
  bound;
* the banded transpose (`core.wblur_banded`): every instance that takes the
  band's table (row tile 64 / 32 × 12 / 14 / 16 column groups, and the
  general instance) — checked against the plain version (≤ 1e-5), two
  launches bit-identical — beside the instance `transpose_launch_shape`
  picks, cuBLAS on the masked table and the FP32 bound;
* the row gather (`core.gather_rows`): the wide-row kernel's group widths
  and instances (4 / 8 / 16 / 24 floats a lane, 1 to 4 taps at a time) and,
  on rows of at most 32 columns, the narrow kernel; float4 and single-float
  columns, aligned bases and bases one float into their storage, per shape —
  checked against the plain version — each time beside the shape
  `gather_launch_shape` picks, `torch.sparse.mm` and the byte bound; the
  rank path's narrow rows (Q = 24, 40) too;
* K2 (`core.gather_fixed`), the same lane shapes on the padded ``[Pp, L]``
  table of the same kind of taps, beside the CSR kernel's pick on those taps.
  The taps are random, so a source row is as likely far as near: the real
  plans' times are chip_smoke.py's;
* K1 and K3 (`core.gather_fixed`) on every band's composed transpose at
  Q = W and at the entry point's W = 466 (`TRANSPOSES`: about one tap a
  row, L = 7 as the real plans have, sources at random), every lane
  instance (`FIXED_LANE_FLOATS`) at 16 and 32 lanes — checked against the
  plain versions (≤ 1e-6) — beside the shape `fixed_launch_shape` picks, K2
  on the same table and the byte bound.

Before the sweeps it prints each kernel's registers and spills (ptxas) and
its SASS instruction mix (cuobjdump), and first of all the card's name and
power limit.  Needs a CUDA device; imports no JAX.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import warnings

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from surfh_tpu_torch.utils.profiling import FP32_FLOPS_PER_S, HBM_BYTES_PER_S, card_name  # noqa: E402
from torch_scatter_proto import event_ms, gather_bytes  # noqa: E402  (beside this script)

# band: S·A, K, W, B, LB, λ'-tiles
BANDS = {
    "1a": (399, 1050, 425, 8, 128, 9), "1b": (399, 1213, 564, 8, 144, 10),
    "1c": (399, 1400, 613, 8, 136, 11), "2a": (408, 970, 475, 12, 160, 8),
    "2b": (408, 1124, 484, 12, 136, 9), "2c": (408, 1300, 524, 12, 128, 11),
    "3a": (400, 769, 352, 16, 144, 7), "3b": (400, 892, 364, 16, 120, 7),
    "3c": (400, 1028, 399, 16, 120, 9), "4a": (336, 542, 252, 27, 128, 5),
    "4b": (336, 632, 241, 27, 112, 5), "4c": (336, 717, 249, 27, 112, 6),
}
# shape: rows, source rows, Q, taps
GATHERS = {
    "1a t": (54560, 3192, 425, 53479), "1b t": (54560, 3192, 564, 53479),
    "1c t": (54560, 3192, 613, 53479), "2a t": (76112, 4896, 475, 81904),
    "3c t": (115500, 6400, 399, 133993), "4a t": (170544, 9072, 252, 209781),
    "4b t": (170544, 9072, 241, 209781), "proto t": (28836, 3192, 466, 53479),
    "1c fwd": (3192, 54560, 613, 53479), "4a fwd": (9072, 170544, 252, 209781),
    "4a rank t": (170544, 9072, 24, 209781), "4a rank fwd": (9072, 170544, 24, 209781),
    "1c rank t": (54560, 3192, 40, 53479), "1c rank fwd": (3192, 54560, 40, 53479),
}

# band: composed-transpose rows, source rows, taps (pointing 0 at full width; W from BANDS)
TRANSPOSES = {"1": (54560, 3192, 53479), "2": (76112, 4896, 81904), "3": (115500, 6400, 133993),
              "4": (170544, 9072, 209781)}
PADDED_L = 7  # every flagship band's transpose table


def sweep_banded(dev, reps: int) -> None:
    import torch

    from surfh_tpu_torch.core import wblur_banded as wb

    rng = np.random.default_rng(0)
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    for band, (m, K, W, B, LB, nT) in BANDS.items():
        starts = np.round(np.linspace(0, W - LB, nT)).astype(np.int32) | 1  # odd offsets
        starts = np.minimum(starts, W - LB).astype(np.int32)
        plan = wb.BandPlan(starts, K, W, B, -(-B // 8) * 8, LB, 128)
        wpsf = rng.uniform(0.5, 1.5, (K, W, B)) * plan.mask()[:, :, None]
        bt = wb.banded_tables(torch.as_tensor(wpsf, dtype=torch.float32, device=dev), plan,
                              wb.build_band_plan_t(wpsf))
        win = torch.as_tensor(rng.standard_normal((m, B * W)), dtype=torch.float32, device=dev)
        flops = 2.0 * m * K * B * LB
        picked = wb.forward_launch_shape(m, plan, n_sm)
        ms_lib = event_ms(lambda: torch.matmul(win, bt.rows.T), reps)
        cells = []
        for split in range(1, min(B, wb.FWD_MAX_SPLIT) + 1):
            shape = wb.forward_shape(m, plan, split)
            got = wb._forward_launch(win, bt, shape)
            again = wb._forward_launch(win, bt, shape)
            want = wb.wblur_banded_by_runs(win, bt, split)
            torch.cuda.synchronize()
            err = float((got - want).abs().max() / want.abs().max())
            if err > 1e-5 or not torch.equal(got, again):
                raise SystemExit(f"band {band} split {split}: rel {err:.3e}, repeat equal "
                                 f"{torch.equal(got, again)}")
            ms = event_ms(lambda: wb._forward_launch(win, bt, shape), reps)
            cells.append((ms, split, shape.blocks))
        best = min(cells)
        mine = next(c for c in cells if c[1] == picked.split)
        print(f"[banded] {band}: M={m} K={K} W={W} B={B} LB={LB} nT={nT}: "
              + " ".join(f"{s}:{ms:.4f}" for ms, s, _ in cells)
              + f" | picked split {mine[1]} ({mine[2]} blocks) {mine[0]:.4f} ms, best split {best[1]} "
              f"{best[0]:.4f} ms; cuBLAS on the masked table {ms_lib:.4f} ms; FP32 bound "
              f"{flops / FP32_FLOPS_PER_S * 1e3:.4f} ms ({flops / 1e9:.3f} GFLOP)", flush=True)


def sweep_transpose(dev, reps: int) -> None:
    import torch

    from surfh_tpu_torch.core import wblur_banded as wb

    rng = np.random.default_rng(2)
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    KB = 256  # every flagship band's slab at wblur_band_rtol 1e-4
    for band, (m, K, W, B, _LB, _nT) in BANDS.items():
        Bp = -(-B // 8) * 8
        TL = max(1, 128 // Bp)
        starts = np.round(np.linspace(0, K - KB, -(-W // TL))).astype(np.int32) | 1  # odd offsets
        plan_t = wb.BandPlanT(starts.astype(np.int32), K, W, B, Bp, TL, KB)
        wpsf = rng.uniform(0.5, 1.5, (K, W, B)) * plan_t.mask()[:, :, None]
        bt = wb.banded_tables(torch.as_tensor(wpsf, dtype=torch.float32, device=dev),
                              wb.build_band_plan(wpsf), plan_t)
        y2d = torch.as_tensor(rng.standard_normal((m, K)), dtype=torch.float32, device=dev)
        n = B * TL
        flops = 2.0 * m * B * W * KB
        picked = wb.transpose_launch_shape(m, plan_t, n_sm)
        want = wb.wblur_banded_t_reference(y2d, bt)
        ms_lib = event_ms(lambda: torch.matmul(y2d, bt.rows_t), reps)
        shapes = [wb.transpose_shape(m, plan_t, bm, cg) for bm in wb.T_BMS for cg in wb.T_CGS
                  if n % 4 == 0 and n <= 8 * cg]
        shapes.append(wb.transpose_shape(m, plan_t, *wb.T_GENERAL, vec=False))
        cells = []
        for shape in shapes:
            got = wb._transpose_launch(y2d, bt, shape)
            again = wb._transpose_launch(y2d, bt, shape)
            torch.cuda.synchronize()
            err = float((got - want).abs().max() / want.abs().max())
            if err > 1e-5 or not torch.equal(got, again):
                raise SystemExit(f"band {band} transpose {shape}: rel {err:.3e}, repeat equal "
                                 f"{torch.equal(got, again)}")
            ms = event_ms(lambda: wb._transpose_launch(y2d, bt, shape), reps)
            cells.append((ms, shape))
        best = min(cells, key=lambda c: c[0])
        mine = next(c for c in cells if c[1] == picked)
        print(f"[transpose] {band}: M={m} K={K} W={W} B={B} TL={TL} n={n} nT={plan_t.n_tiles}: "
              + " ".join(f"{sh.bm}x{8 * sh.cg}{'' if sh.vec else 'g'}({sh.blocks}):{ms:.4f}" for ms, sh in cells)
              + f" | picked {mine[1].bm}x{8 * mine[1].cg} ({mine[1].blocks} blocks of {mine[1].threads} "
              f"threads) {mine[0]:.4f} ms, best {best[1].bm}x{8 * best[1].cg} {best[0]:.4f} ms; cuBLAS on "
              f"the masked table {ms_lib:.4f} ms; FP32 bound {flops / FP32_FLOPS_PER_S * 1e3:.4f} ms "
              f"({flops / 1e9:.3f} GFLOP)", flush=True)


def sweep_gather(dev, reps: int, k2: bool = False) -> None:
    """The lane shapes of the CSR kernel or, `k2`, of K2 on the padded table
    of taps of the same kind (without the one heavy row, which would pad
    every row of the table to its count)."""
    import torch

    from surfh_tpu_torch.core import gather_fixed as gf
    from surfh_tpu_torch.core import gather_rows as gr

    rng = np.random.default_rng(1)
    for name, (n_rows, n_src, q, nnz) in GATHERS.items():
        heavy = 0 if k2 else 150
        cdst = np.sort(np.concatenate([rng.integers(0, n_rows, nnz - heavy), np.full(heavy, n_rows // 2)]))
        csrc, cw = rng.integers(0, n_src, nnz), rng.uniform(0.5, 1.5, nnz)
        plan = gr.build_row_gather_plan(csrc, cw, cdst, n_rows, n_src)
        dplan = plan.to(dev, torch.float32)
        src0 = torch.as_tensor(rng.standard_normal((n_src, q)), dtype=torch.float32, device=dev)
        store = torch.empty(n_src * q + 1, device=dev)
        ostore = torch.empty(n_rows * q + 1, device=dev)
        nbytes = 4.0 * (n_rows * q + n_src * q + 2 * plan.nnz + n_rows + 1)
        with warnings.catch_warnings():  # "sparse CSR support is in beta"
            warnings.simplefilter("ignore", UserWarning)
            spm = torch.sparse_csr_tensor(dplan.row_ptr, dplan.idx, dplan.w, size=(n_rows, n_src))
        ms_lib = event_ms(lambda: torch.sparse.mm(spm, src0), reps)
        if k2:
            fplan = gf.build_fixed_fanin_plan(csrc, cw, cdst, n_rows, n_src, 8, ld=q).to(dev, torch.float32)
            want = gf.gather_fixed_k2_reference(src0, fplan)
            tol = 1e-6  # the same taps in the same order

            def launch(src, out, *shape):
                gf._launch_k2(src, fplan, out, *shape)
        else:
            want = gr.gather_rows_reference(src0, dplan)
            tol = 1e-5

            def launch(src, out, *shape):
                gr._launch(src, dplan, out, *shape)
        cells = []
        for off in (0, 1):  # 1: both bases one float into their storage
            src = store[off:off + n_src * q].view(n_src, q).copy_(src0)
            out = ostore[off:off + n_rows * q].view(n_rows, q)
            vecs = (4, 1) if q % 4 == 0 and not off else (1,)
            shapes = [(vec, floats // vec, taps, group)
                      for vec in vecs
                      for floats, taps in (gr._MANY_TAPS_SHAPE, *gr._LANE_FLOATS.items())
                      for group in ((16, 32) if q >= 128 else (1, 2, 4, 8, 16, 32))]
            # the narrow kernel: a lane per column
            shapes += [(vec, 1, gr._NARROW_TAPS, q // vec) for vec in vecs if q // vec <= 32]
            for shape in shapes:
                out.fill_(-1.0)
                launch(src, out, *shape)
                torch.cuda.synchronize()
                err = float((out - want).abs().max() / want.abs().max())
                if err > tol:
                    raise SystemExit(f"gather {name} shape {shape} off {off} k2 {k2}: rel {err:.3e}")
                ms = event_ms(lambda: launch(src, out, *shape), reps)
                cells.append((ms, shape, off))
        picked = {off: gr.gather_launch_shape(q, not off, plan.nnz / n_rows) for off in (0, 1)}
        mine = next(ms for ms, shape, off in cells if not off and shape == picked[0])
        beside = ""
        if k2:
            out = ostore[:n_rows * q].view(n_rows, q)
            ms_csr = event_ms(lambda: gr._launch(src0, dplan, out, *picked[0]), reps)
            beside = f" (L = {fplan.L}; the CSR kernel in that shape on these taps {ms_csr:.4f} ms)"
        print(f"[{'k2' if k2 else 'gather'}] {name}: rows {n_rows} x Q {q}, n_src {n_src}, nnz {plan.nnz}: "
              + " ".join(f"v{v}c{c}t{t}g{g}{'+1' if o else ''}:{ms:.4f}" for ms, (v, c, t, g), o in cells)
              + f" | picked aligned {picked[0]} {mine:.4f} ms{beside}, misaligned {picked[1]}; best "
              f"{min(cells)[0]:.4f} ms; torch.sparse.mm {ms_lib:.4f} ms; byte bound "
              f"{nbytes / HBM_BYTES_PER_S * 1e3:.4f} ms ({nbytes / 1e6:.1f} MB)", flush=True)


def sweep_fixed(dev, reps: int) -> None:
    """K1 and K3 in every lane instance on a padded table with the
    transposes' kind of taps (Poisson counts of mean nnz / P, at most L = 7,
    some rows of 7), on every band and at the entry point's width."""
    import torch

    from surfh_tpu_torch.core import gather_fixed as gf

    rng = np.random.default_rng(3)
    cases = [(band, *TRANSPOSES[band[0]], BANDS[band][2]) for band in BANDS]
    cases.append(("proto", 28836, 3192, 53479, 466))  # band 1c's rows at the entry point's 501² sky
    for band, n_rows, n_src, nnz, W in cases:
        per = np.minimum(rng.poisson(nnz / n_rows, n_rows), PADDED_L)
        per[rng.choice(n_rows, 8, replace=False)] = PADDED_L
        cdst = np.repeat(np.arange(n_rows), per)
        csrc, cw = rng.integers(0, n_src, cdst.size), rng.uniform(0.5, 1.5, cdst.size)
        plan = gf.build_fixed_fanin_plan(csrc, cw, cdst, n_rows, n_src, 512, ld=W).to(dev, torch.float32)
        src = torch.as_tensor(rng.standard_normal((n_src, W)), dtype=torch.float32, device=dev)
        out = torch.empty((n_rows, W), device=dev)
        b_ms = gather_bytes(n_rows, np.unique(csrc).size, W, cdst.size) / HBM_BYTES_PER_S * 1e3
        ms_k2 = event_ms(lambda: gf.gather_fixed_k2_cuda(src, plan), reps)
        picked = gf.fixed_launch_shape(W, 16)
        for name, launch, plain in (("K1", gf._launch_k1, gf.gather_fixed_k1_reference),
                                    ("K3", gf._launch_k3, gf.gather_fixed_k3_reference)):
            want = plain(src, plan)
            cells = {}
            for vec in [v for v in (4, 2, 1) if W % v == 0]:
                for floats in gf.FIXED_LANE_FLOATS[vec]:
                    for group in (16, 32):
                        shape = (vec, floats // vec, 1, group)
                        out.fill_(-1.0)
                        launch(src, plan, out, *shape)
                        torch.cuda.synchronize()
                        err = float((out - want).abs().max() / want.abs().max())
                        if err > 1e-6:
                            raise SystemExit(f"{name} {band} shape {shape}: rel {err:.3e}")
                        cells[shape] = event_ms(lambda: launch(src, plan, out, *shape), reps)
            best = min((ms, shape) for shape, ms in cells.items())
            print(f"[fixed] {band} {name}: rows {n_rows} x W {W}, n_src {n_src}, nnz {cdst.size}, L {plan.L}: "
                  + " ".join(f"v{v}c{c}t{t}g{g}:{ms:.4f}" for (v, c, t, g), ms in cells.items())
                  + f" | picked {picked} {cells[picked]:.4f} ms ({cells[picked] / ms_k2:.2f}x K2 "
                  f"{ms_k2:.4f}, {100 * b_ms / cells[picked]:.1f} % of the byte bound {b_ms:.4f} ms); best "
                  f"{best[1]} {best[0]:.4f} ms", flush=True)


def instruction_mix() -> None:
    """Per kernel of both libraries, the SASS instruction counts that bound
    it (cuobjdump on the built libraries): the arithmetic, shared-memory and
    copy instructions beside the total."""
    import collections
    import re
    import shutil

    from surfh_tpu_torch.core import _build

    tool = shutil.which("cuobjdump") or os.path.join(os.path.dirname(_build.find_nvcc()), "cuobjdump")
    for so in sorted(_build.BUILD_DIR.glob("lib*.so")):
        sass = subprocess.run([tool, "-sass", str(so)], capture_output=True, text=True).stdout
        name, mix = None, collections.Counter()
        for line in sass.splitlines() + ["Function : end"]:
            m = re.search(r"Function : (\S+)", line)
            if m:
                if name:
                    keys = ("FFMA", "FADD", "LDS", "LDGSTS", "LDG", "STG", "STS", "SHFL", "BAR", "IMAD", "SEL")
                    print(f"[sass] {name[:80]}: {sum(mix.values())} instructions; "
                          + " ".join(f"{k} {mix[k]}" for k in keys if mix[k]), flush=True)
                name, mix = m.group(1), collections.Counter()
                continue
            m = re.match(r"\s+/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\d+\s+)?([A-Z0-9_]+)", line)
            if m:
                mix[m.group(1)] += 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=30)
    args = ap.parse_args(argv)

    from surfh_tpu_torch.core import _build
    from surfh_tpu_torch.core import gather_fixed as gf
    from surfh_tpu_torch.core import gather_rows as gr
    from surfh_tpu_torch.core import wblur_banded as wb
    from surfh_tpu_torch.core.precision import require_cuda

    dev = require_cuda()
    print(card_name(dev), flush=True)
    gr.load_kernel()
    wb.load_kernels()
    gf.load_kernels()
    for name in ("gather_rows", "wblur_banded", "gather_fixed"):
        for line in _build.build_logs.get(name, "").splitlines():
            if "Compiling entry" in line or "registers" in line or "spill" in line:
                print(f"[build] ptxas {name}: {line.strip()}", flush=True)
    instruction_mix()
    sweep_fixed(dev, args.reps)
    sweep_transpose(dev, args.reps)
    sweep_gather(dev, args.reps, k2=True)
    sweep_gather(dev, args.reps)
    sweep_banded(dev, args.reps)
    return 0


if __name__ == "__main__":
    sys.exit(main())
