"""`chain` dependent fwd+adjoint applications captured once as a CUDA
graph and replayed (`yardstick.capture_chain`); the answers kept are the
last application's output after a sample of replays, and the reference is
one normal of the run's unknown (the chain feeds each application the
unknown plus 1e-30 of the last, which no float32 value feels).
"""

import torch

from benchmark.bench.traffic import Sample, _sync
from benchmark.bench.yardstick import capture_chain
from benchmark.reference.operator import Reference

ANSWER = "g"


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


WORK = NormalChain


def answer(op, x, config: dict, traffic: dict):
    return op.normal(x)


def reference(config: dict, traffic: dict, x, device):
    return answer(Reference(config, device, torch.float64), x, config, traffic)


def start(x, traffic: dict):
    return x
