"""surfh_tpu_torch — the PyTorch/CUDA port of `surfh_tpu`.

The JAX package `surfh_tpu` is the reference; this package computes the
same operators from the same numbers with PyTorch on the host and on an
NVIDIA Hopper card, and never imports JAX.  Module names follow
`surfh_tpu` so each counterpart is easy to find.

Layer map (bottom-up), first slice = the flagship rank-mode fusion solve:

``core``        host (NumPy) table construction, torch DFT-matmul conv,
                composed gather plans, the hand-written CUDA row-gather
                kernel (`core.gather_rows`, source in ``csrc/``) and its
                build (`core._build`).
``models``      Slicer, the composed-path Channel and the rank-mode
                `SpectroSigRLSCT` (forward, adjoint, fused normal).
``solvers``     `lcg` and `QuadCriterion_MRS`.
``simulation``  synthetic and flagship problem generators.
``convert``     the reference model's tables carried across.

From `surfh_tpu` only the JAX-free `surfh_tpu.instrument` modules are
imported (geometry, IFU, spectral blur, MIRI band tables).
"""

from .core import precision as _precision  # noqa: F401  (sets the FP32 policy)

__version__ = "0.1.0"
