"""Roofline and collective-traffic analysis of dry-run records (the port
of ``repro.analysis``): :mod:`.cost` counts a step traced on the
``meta`` device, :mod:`.collectives` its collective bytes,
:mod:`.roofline` the three-term bound, :mod:`.report` the tables."""
from .collectives import collective_bytes
from .roofline import HW, Roofline, analyze, corrected_costs, model_flops

__all__ = ["collective_bytes", "HW", "Roofline", "analyze",
           "corrected_costs", "model_flops"]
