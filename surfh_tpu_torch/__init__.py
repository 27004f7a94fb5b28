"""surfh_tpu_torch — the PyTorch/CUDA port of `surfh_tpu`.

The JAX package `surfh_tpu` is the reference; this package computes the
same operators from the same numbers with PyTorch on the host and on an
NVIDIA Hopper card, and never imports JAX.  Module names follow
`surfh_tpu` so each counterpart is easy to find.

Layer map (bottom-up), first slice = the flagship rank-mode fusion solve:

``core``        host (NumPy) table construction, torch DFT-matmul conv,
                composed gather plans, the hand-written CUDA kernels
                (sources in ``csrc/``): the CSR row gather
                (`core.gather_rows`), the banded spectral-blur pair
                (`core.wblur_banded`), the fixed-fan-in row gathers K1–K3
                of the prototype entry point (`core.gather_fixed`), and
                their build (`core._build`).
``models``      Slicer, the composed-path Channel and `SpectroSigRLSCT`
                in every conv mode (forward, adjoint, normal).
``solvers``     `lcg`, `QuadCriterion_MRS` and the checkpointed solve.
``simulation``  synthetic and flagship problem generators, synthetic
                stage-2 files.
``preprocessing`` FITS I/O, header metadata, the Shepard regrid (torch on
                a device), the distortion correction and its driver.
``pipeline``    the real-data fusion and the rehearsal chain; ``cli`` the
                command line (`python -m surfh_tpu_torch.cli`).
``convert``     the reference model's tables carried across.

``instrument``  the port's own copy of `surfh_tpu.instrument` (geometry,
                IFU, spectral blur, MIRI band and wavelength tables).
``utils``       PSF stamps, the JWST diffraction PSF, phase timers, the
                chained kernel timer and the reconstruction metrics.

Nothing of `surfh_tpu` is imported, not even its JAX-free modules.
"""

from .core import precision as _precision  # noqa: F401  (sets the FP32 policy)

__version__ = "0.1.0"
