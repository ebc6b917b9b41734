"""Numerical guardrails for ALS sweeps: NaN/Inf detection and recovery
bookkeeping (the port of ``repro.resilience.guard``).

One NaN produced mid-sweep silently spoils every later factor update.
``cp_als`` / ``cp_als_stream`` with a ladder therefore check the factors
after every sweep and, on a burst, roll back to the sweep's starting
factors and replay it under a stronger ridge
(``core.cpd._als_fold_recovery``).
"""
from __future__ import annotations

import torch

from repro_torch.obs.metrics import counter as _counter
from repro_torch.obs.trace import span as _span

__all__ = ["all_finite", "record_recovery"]


def all_finite(factors, lam=None) -> bool:
    """Whether every factor (and ``lam``) is finite: one reduction a
    tensor on its device, then ONE host sync for the sweep."""
    flags = [torch.isfinite(f).all() for f in factors]
    if lam is not None:
        flags.append(torch.isfinite(lam).all())
    return bool(torch.stack(flags).all())


def record_recovery(what: str, **attrs) -> None:
    """Record one numerical recovery (e.g. ``nan_rollback``) as a
    ``resilience_recoveries`` counter label and a ``resilience.recover``
    span."""
    _counter("resilience_recoveries",
             "numerical recoveries by kind").inc(what)
    with _span("resilience.recover", what=what, **attrs):
        pass
