"""Whole user solves back to back, each ``QuadCriterion_MRS(mu_spectro, y,
model, mu_reg).run_method(method, maximum_iterations, tolerance,
value_init=...)`` as ``cli fusion`` runs it; y is the program's forward
of the run's unknown, b = µ_s Hᵗy is computed in set-up, and a warm-up
solve of `warmup_iterations` touches every shape.  The answers kept are
the iterates of a sample of solves; the reference runs the same number of
plain CG iterations from the same start (`reference.operator.cg_solve`).
"""

import torch

from benchmark.bench.traffic import Sample, _sync
from benchmark.reference.operator import Reference, cg_solve

ANSWER = "x"


class CgSolve:
    unit_name = "solve"

    def __init__(self, model, maps, config: dict, traffic: dict, stages, seed: int):
        from surfh_tpu_torch.solvers.criterion import QuadCriterion_MRS

        crit = config["criterion"]
        self.traffic = traffic
        self.model = model
        y = stages("y = H(maps)", model.forward, maps)
        self.crit = QuadCriterion_MRS(crit["mu_spectro"], y, model, crit["mu_reg"])
        stages("b = mu_s Ht(y)", lambda: self.crit.b)
        stages("warm-up solve", self._solve, int(traffic["warmup_iterations"]))
        self.sample = Sample(traffic["sample"], seed)
        self.iterations = 0
        self.normals = 0

    def _solve(self, n_iter: int):
        t = self.traffic
        return self.crit.run_method(t["method"], maximum_iterations=n_iter, tolerance=t["tolerance"],
                                    value_init=t["value_init"])

    def unit(self, index: int) -> None:
        res = self._solve(int(self.traffic["maximum_iterations"]))
        _sync()
        self.iterations += int(res.n_iter)
        self.normals += int(res.n_iter) + 1  # the initial residual's normal
        self.sample.offer(index, lambda: res.x.detach().to("cpu", copy=True))

    def units(self) -> dict:
        return {"iterations": self.iterations, "normals": self.normals}

    def free(self) -> None:
        del self.crit, self.model


WORK = CgSolve


def answer(op, x, config: dict, traffic: dict):
    if traffic["method"] != "lcg":
        raise ValueError(f"method {traffic['method']!r}: the reference of this kind is plain CG (lcg)")
    crit = config["criterion"]
    return cg_solve(op, op.forward(x), crit["mu_spectro"], crit["mu_reg"], traffic["value_init"],
                    int(traffic["maximum_iterations"]))


def reference(config: dict, traffic: dict, x, device):
    return answer(Reference(config, device, torch.float64), x, config, traffic)


def start(x, traffic: dict):
    return torch.full_like(x, float(traffic["value_init"]))
