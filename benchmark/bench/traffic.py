"""The generator of work: a traffic file's `kind` names the module
``kinds/<kind>.py`` (`spec.kind`) whose `WORK` drives the program through
the entry that users call, in units that each end in a synchronise, with
the traffic file's parameters.

Each kind keeps `sample` answers: the first unit's, the last's, and ones
drawn from the seed among the rest (reservoir sampling, :class:`Sample`),
copied off the device path as they are produced.
"""

from __future__ import annotations

import inspect
import random

import torch

from .spec import BENCH, kind


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


def make(model, x, config, traffic, stages, seed, bench_dir=BENCH, **kw):
    """The kind's `WORK` on the program's `model` and the run's unknown `x`;
    keyword arguments it does not take are dropped (the CPU tests hand every
    kind the graph capture's stand-in)."""
    work = kind(traffic["kind"], bench_dir).WORK
    takes = inspect.signature(work).parameters
    return work(model, x, config, traffic, stages, seed, **{k: v for k, v in kw.items() if k in takes})
