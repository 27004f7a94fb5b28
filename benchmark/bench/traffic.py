"""The one generator of work: a traffic file's `kind` and parameters drive
the program through the entry that users call, in units that each end in
a synchronise.

* ``cg_solve``: whole user solves back to back, each
  ``QuadCriterion_MRS(mu_spectro, y, model, mu_reg).run_method(method,
  maximum_iterations, tolerance, value_init=...)`` as ``cli fusion`` runs
  it; y is the program's forward of the seed's maps, b = µ_s Hᵗy is
  computed in set-up, and a warm-up solve of `warmup_iterations` touches
  every shape.  The answers kept are the iterates of a sample of solves.
* ``normal_chain``: `chain` dependent fwd+adjoint applications captured
  once as a CUDA graph and replayed; the answers kept are the last
  application's output after a sample of replays.

Each kind keeps `sample` answers: the first unit's, the last's, and ones
drawn from the seed among the rest (reservoir sampling), copied off the
device path as they are produced.
"""

from __future__ import annotations

import random

import torch

from .yardstick import capture_chain


def _sync() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


class Sample:
    """`k` of a stream of answers: the first, the last, and a uniform draw
    from the seed among the others."""

    def __init__(self, k: int, seed: int):
        self.k = max(2, int(k))
        self.rng = random.Random(int(seed))
        self.first, self.last, self.middle, self.seen = None, None, [], 0

    def offer(self, index: int, take):
        """Offer answer `index`; `take()` copies it (called only when kept)."""
        if self.first is None:
            self.first = (index, take())
            return
        if self.last is not None:  # the previous last joins the draw
            self.seen += 1
            if len(self.middle) < self.k - 2:
                self.middle.append(self.last)
            else:
                j = self.rng.randrange(self.seen)
                if j < self.k - 2:
                    self.middle[j] = self.last
        self.last = (index, take())

    def answers(self) -> list:
        out = [self.first] + self.middle + ([self.last] if self.last is not None else [])
        return [a for a in out if a is not None]


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


class NormalChain:
    unit_name = "replay"

    def __init__(self, model, maps, config: dict, traffic: dict, stages, seed: int, capture=capture_chain):
        self.chain = int(traffic["chain"])
        self.model = model
        self.graph, self.g = stages("warm-up and graph capture", capture, model, maps, self.chain)
        self.sample = Sample(traffic["sample"], seed)
        self.normals = 0

    def unit(self, index: int) -> None:
        self.graph.replay()
        _sync()
        self.normals += self.chain
        self.sample.offer(index, lambda: self.g.detach().to("cpu", copy=True))

    def units(self) -> dict:
        return {"iterations": 0, "normals": self.normals}

    def free(self) -> None:
        del self.graph, self.g, self.model


KINDS = {"cg_solve": CgSolve, "normal_chain": NormalChain}


def make(model, maps, config, traffic, stages, seed, **kw):
    return KINDS[traffic["kind"]](model, maps, config, traffic, stages, seed, **kw)
