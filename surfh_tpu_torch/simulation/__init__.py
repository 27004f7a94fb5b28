"""Synthetic problem generation and simulated ground truth (counterpart
of `surfh_tpu.simulation`)."""

from .data import get_simulation_data, synthetic_ngc7023, synthetic_orion
from .synthetic import make_model, make_setup

__all__ = ["get_simulation_data", "make_model", "make_setup", "synthetic_ngc7023",
           "synthetic_orion"]
