#!/usr/bin/env python3
"""The upper readings of a cell's comparison, on the card at the cell's size:
the control and the faults, each put in the program's place and compared
with the float64 reference exactly as a run's kept answers are.

    python3 benchmark/control.py --workload <name> --seeds 1 2 3

* control: the reference in float32 with every contraction's operands
  rounded to TF32 (the step a later change might be tempted by);
* unchanged: the answer is the unit's input state (the CG's start, or the
  chain's input);
* half_bands: every other band left out and the rest counted twice;
* altered: the answer with one value, drawn from the seed, moved by the
  answer's largest magnitude.

Prints one JSON line per seed and reading.  The benchmark's own runs never
run this.
"""

from __future__ import annotations

import argparse
import json
import random
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
sys.path[:] = [str(ROOT)] + [p for p in sys.path if Path(p or ".").resolve() not in (HERE, ROOT)]


class HalfBands:
    """A reference whose forward leaves out every other band and counts the
    others twice (the transpose is the reference's own)."""

    def __init__(self, ref):
        self.ref = ref
        self.x_shape, self.dtype, self.device = ref.x_shape, ref.dtype, ref.device

    def forward(self, x):
        return [2 * y if c % 2 == 0 else 0 * y for c, y in enumerate(self.ref.forward(x))]

    def adjoint(self, ys):
        return self.ref.adjoint(ys)

    def normal(self, x):
        return self.adjoint(self.forward(x))


def readings(cell: dict, seed: int, device) -> list:
    import torch

    from benchmark.bench import check, program
    from benchmark.bench.spec import kind as load_kind
    from benchmark.reference.operator import Reference

    config, traffic = cell["config"], cell["traffic"]
    x = program.seed_unknown(config, seed, device).to(torch.float64)
    kind = load_kind(traffic["kind"], cell["bench_dir"])
    prefix = kind.ANSWER
    out = []

    def add(name, answer, ref, t0):
        g = check.gaps(answer, ref)
        out.append({"seed": seed, "reading": name, f"{prefix}_rel_l2": g["rel_l2"],
                    f"{prefix}_max_abs": g["max_abs"], "seconds": time.perf_counter() - t0})

    def solve(op):
        return kind.answer(op, x, config, traffic)

    t0 = time.perf_counter()
    ref64 = Reference(config, device, torch.float64)
    ref = solve(ref64)
    out.append({"seed": seed, "reading": "reference", "seconds": time.perf_counter() - t0})
    t0 = time.perf_counter()
    add("half_bands", solve(HalfBands(ref64)), ref, t0)
    del ref64
    t0 = time.perf_counter()
    add("unchanged", kind.start(x, traffic), ref, t0)
    altered = ref.clone().reshape(-1)
    altered[random.Random(seed).randrange(altered.numel())] += ref.abs().max()
    add("altered", altered.view_as(ref), ref, t0)
    t0 = time.perf_counter()
    add("control", solve(Reference(config, device, torch.float32, tf32=True)), ref, t0)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)

    import torch

    from benchmark.bench.spec import cell as load_cell

    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    cell = load_cell(args.workload)
    for seed in args.seeds:
        for r in readings(cell, seed, torch.device("cuda", 0)):
            print(json.dumps({"workload": args.workload, **r}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
