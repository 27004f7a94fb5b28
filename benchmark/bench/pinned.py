"""The kept answers' copies to the host in buffers allocated once, in set-up.

A kind whose answer is the 3.63 GiB voxel cube spends 1.6–1.7 s a unit
copying it to pageable host memory on an H100 host (``Memcpy DtoH (Device
-> Pageable)``: a fresh allocation, its pages faulted in by the copy), and
that time moves with the host's other work.  :class:`PinnedSample` keeps the same answers as
:class:`traffic.Sample` (the same draws from the seed), each copied into one
of ``k + 1`` page-locked buffers made in set-up: a buffer returns to the
pool when the sample lets its answer go.
"""

from __future__ import annotations

import torch

from .traffic import Sample


class PinnedSample(Sample):
    """`k` of a stream of answers shaped like `like`, in pinned host buffers."""

    def __init__(self, k: int, seed: int, like: torch.Tensor):
        super().__init__(k, seed)
        pin = torch.cuda.is_available()
        self.pool = [torch.empty(like.shape, dtype=like.dtype, pin_memory=pin) for _ in range(self.k + 1)]
        self.free = list(self.pool)

    def offer(self, index: int, value: torch.Tensor):
        """Offer answer `index`, a device tensor, copied only when kept."""
        def take():
            buf = self.free.pop()
            buf.copy_(value.detach())
            return buf

        super().offer(index, take)
        held = {id(a) for _, a in self.answers()}
        self.free = [b for b in self.pool if id(b) not in held]
