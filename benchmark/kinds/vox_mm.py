"""Whole voxel reconstructions back to back, each
``vox_reconstruction(y, model, spat_reg, spat_th, spec_reg, spec_th,
max_iter=maximum_iterations, loop=loop)`` as a user calls upstream's
`algorithms.vox_reconstruction`: the Huber-prior MM memory gradient on the
cube, from Hᵗy (the function's default start, the traffic's ``init``
"Hty").  y is the program's forward of the run's cube, computed in set-up;
a warm-up solve of `warmup_iterations` touches every shape.  The answers
kept are the last iterates of a sample of solves, copied into pinned host
buffers allocated in set-up (`bench.pinned`); the reference runs the
same number of plain MM steps from its own Hᵗy
(`reference.huber_mm.vox_reconstruction`).

A unit counts `maximum_iterations` iterations (the first step included, as
`mmmg_huber` counts it) and, as normals, its forward + transpose pairs:
Hᵗy, then the first step's two forwards and its gradient's transpose,
then a forward and a transpose a step, n + 1 in all.

No cell of the benchmark runs this kind yet.  From Hᵗy the float32 MM
drifts some 7 % from the float64 one in 50 steps on the 12-band operator,
and the reference run in float32 with a TF32 operator drifts as far (the
first step from a start ~5e8 times the cube's scale already loses some 11
bits, before any operator rounding counts), so no limit on the answer
could tell a lower-precision operator from the program.
"""

import torch

from benchmark.bench.pinned import PinnedSample
from benchmark.bench.traffic import _sync
from benchmark.reference import huber_mm
from benchmark.reference.operator import Reference

ANSWER = "x"
PRIORS = ("spat_reg", "spat_th", "spec_reg", "spec_th")


class VoxMM:
    unit_name = "solve"

    def __init__(self, model, x, config: dict, traffic: dict, stages, seed: int):
        from surfh_tpu_torch.solvers import vox_reconstruction

        if traffic["init"] != "Hty":
            raise ValueError(f"init {traffic['init']!r}: the reconstruction starts from Hty")
        self.traffic = traffic
        self.model = model
        self.reconstruct = vox_reconstruction
        self.y = stages("y = H(x)", model.forward, x)
        stages("warm-up solve", self._solve, int(traffic["warmup_iterations"]))
        self.sample = stages("pinned answer buffers", PinnedSample, traffic["sample"], seed, x)
        self.iterations = 0
        self.normals = 0

    def _solve(self, n_iter: int):
        t = self.traffic
        return self.reconstruct(self.y, self.model, **{k: t[k] for k in PRIORS}, max_iter=n_iter,
                                loop=t["loop"])

    def unit(self, index: int) -> None:
        res = self._solve(int(self.traffic["maximum_iterations"]))
        _sync()
        self.iterations += int(res.n_iter)
        self.normals += int(res.n_iter) + 1  # Hᵗy's transpose and the first step's extra forward
        self.sample.offer(index, res.x)

    def units(self) -> dict:
        return {"iterations": self.iterations, "normals": self.normals}

    def free(self) -> None:
        del self.y, self.model


WORK = VoxMM


def answer(op, x, config: dict, traffic: dict):
    return huber_mm.vox_reconstruction(op, op.forward(x), traffic, int(traffic["maximum_iterations"]))


def reference(config: dict, traffic: dict, x, device):
    return answer(Reference(config, device, torch.float64), x, config, traffic)


def start(x, traffic: dict):
    """The x-shaped zero.  A unit's true start is Hᵗy, which needs the
    operator; this function is not given one."""
    return torch.zeros_like(x)
