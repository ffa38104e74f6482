"""Sweep drivers over the batched engine."""

from .sweep import make_sweep_specs, run_sweep

__all__ = ["make_sweep_specs", "run_sweep"]
