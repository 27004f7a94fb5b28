"""Device-mesh sharding of the fusion pipeline over `torch.distributed`
(counterpart of `surfh_tpu.parallel`), one process per device:

* channel-expert (`fusion.ShardedSpectro`): bands → ranks, maps
  replicated, one all_reduce per adjoint and per normal;
* λ-axis (`lambda_sharded.LambdaShardedChannel`): the cube's spectral axis
  → ranks, per-plane stages local, one all_reduce in the forward;
* both composed on a 2-D mesh (`mesh2d.ShardedSpectro2D`).
"""

from .fusion import ShardedSpectro, make_mesh
from .lambda_sharded import LambdaShardedChannel
from .mesh2d import ShardedSpectro2D, make_mesh_2d

__all__ = [
    "LambdaShardedChannel",
    "ShardedSpectro",
    "ShardedSpectro2D",
    "make_mesh",
    "make_mesh_2d",
]
