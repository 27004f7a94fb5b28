"""Linear instrument operators: the flagship fusion model and the
single-stage ladder (counterpart of `surfh_tpu.models`)."""

from .blind2d import MRSBlurred, MRSBlurredRectangle
from .channel import Channel
from .family import (
    MCMO_SigRLSCT,
    MCMO_SigRLSCT_NN,
    MO_SigRLSCT,
    MO_SigRLSCT_shiftConv,
    SpectroC,
    SpectroCT,
    SpectroLT,
    SpectroR,
    SpectroRL,
    SpectroRLT,
    SpectroSigRLCT,
    SpectroSigRLSCT1C,
    SpectroSigRLSCT1C_NN,
    SpectroSigRLT,
    SpectroSnearestT,
    SpectroST,
    SpectroT,
)
from .mixing import MixingST, Model_WCT
from .slicer import Slicer
from .spectro import SpectroSigRLSCT

__all__ = [
    "Channel",
    "MCMO_SigRLSCT",
    "MCMO_SigRLSCT_NN",
    "MO_SigRLSCT",
    "MO_SigRLSCT_shiftConv",
    "MRSBlurred",
    "MRSBlurredRectangle",
    "MixingST",
    "Model_WCT",
    "Slicer",
    "SpectroC",
    "SpectroCT",
    "SpectroLT",
    "SpectroR",
    "SpectroRL",
    "SpectroRLT",
    "SpectroSigRLCT",
    "SpectroSigRLSCT",
    "SpectroSigRLSCT1C",
    "SpectroSigRLSCT1C_NN",
    "SpectroSigRLT",
    "SpectroSnearestT",
    "SpectroST",
    "SpectroT",
]
