"""FP32 contraction policy and the device guard.

Counterpart of `surfh_tpu/core/precision.py`.  The reference pins every
accuracy-relevant float32 contraction to ``precision="highest"`` (full f32
on the TPU's bf16 MXU).  On the card the same contract is full-FP32 cuBLAS:
TF32 stays off for matmuls and for cuDNN, set here once, through the
`allow_tf32` flags only.  A TF32 operand keeps ~3 decimal digits, and an
operator inconsistency of that class wrecks CG (the reference measured a
5.6e-5 forward/adjoint mismatch collapse a 500-iteration solve).
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def require_cuda() -> torch.device:
    """The CUDA device, or raise: measurement paths never fall back to the CPU."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: torch.cuda.is_available() is False "
            f"(torch {torch.__version__}, built for CUDA {torch.version.cuda})"
        )
    return torch.device("cuda", torch.cuda.current_device())


def pick_device(device=None) -> torch.device:
    """`device` as a torch device; None means the card (raise without one)."""
    return require_cuda() if device is None else torch.device(device)


def require_highest(precision: str, what: str = "precision") -> None:
    """Raise unless `precision` is "highest", the full-FP32 contract above:
    the reference's reduced-precision contractions are not ported."""
    if precision != "highest":
        raise NotImplementedError(
            f"{what}={precision!r}: not ported (ROADMAP 'Do not port': "
            "a reduced-precision conv is not safe under CG)")
