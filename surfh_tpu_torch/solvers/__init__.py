"""Criteria and solvers: CG and MM memory gradient, the quadratic MRS
criteria, the Huber-prior MM and the closed-form block-Fourier inverse
(counterpart of `surfh_tpu.solvers`)."""

from .cg import SolverResult, lcg, mmmg
from .criterion import (
    DifferenceOperatorJoint,
    QuadCriterion_MRS,
    QuadCriterion_MRS_2D,
    dtd_separated,
)
from .expsol import Inv_Regul_Fusion_Model, QuadCriterion3, Regul_Fusion_Model
from .huber import lmm_reconstruction, mmmg_huber, vox_reconstruction

__all__ = [
    "DifferenceOperatorJoint",
    "Inv_Regul_Fusion_Model",
    "QuadCriterion3",
    "QuadCriterion_MRS",
    "QuadCriterion_MRS_2D",
    "Regul_Fusion_Model",
    "SolverResult",
    "dtd_separated",
    "lcg",
    "lmm_reconstruction",
    "mmmg",
    "mmmg_huber",
    "vox_reconstruction",
]
