"""`cg_solve`'s whole user solves, with each kept answer copied into a
pinned host buffer allocated in set-up (`bench.pinned.PinnedSample`) rather
than a fresh pageable one: for an unknown the size of the voxel cube the
pageable copy takes ~13 % of a unit on an H100 and spreads the runs.  The reference,
the answer through any operator and the start are `cg_solve`'s.
"""

from benchmark.bench.pinned import PinnedSample
from benchmark.bench.spec import kind
from benchmark.bench.traffic import _sync

_cg = kind("cg_solve")
ANSWER, answer, reference, start = _cg.ANSWER, _cg.answer, _cg.reference, _cg.start


class CgSolvePinned(_cg.CgSolve):
    def __init__(self, model, maps, config: dict, traffic: dict, stages, seed: int):
        super().__init__(model, maps, config, traffic, stages, seed)
        self.sample = stages("pinned answer buffers", PinnedSample, traffic["sample"], seed, maps)

    def unit(self, index: int) -> None:
        res = self._solve(int(self.traffic["maximum_iterations"]))
        _sync()
        self.iterations += int(res.n_iter)
        self.normals += int(res.n_iter) + 1  # the initial residual's normal
        self.sample.offer(index, res.x)


WORK = CgSolvePinned
