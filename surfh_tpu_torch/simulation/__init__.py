"""Synthetic problem generation (counterpart of `surfh_tpu.simulation`;
its `data` module, `synthetic_orion` and `get_simulation_data`, is not
ported yet: ROADMAP A12)."""

from .synthetic import make_model, make_setup

__all__ = ["make_model", "make_setup"]
