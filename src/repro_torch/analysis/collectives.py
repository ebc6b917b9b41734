"""Collective traffic of a traced step: the port's counterpart of
``repro.analysis.hlo``.

The reference scans its compiled (post-SPMD) HLO for all-gather /
all-reduce / reduce-scatter / all-to-all / collective-permute ops. The
port has no HLO: under ``sharding.accounting()`` each single-controller
move of ``repro_torch.sharding`` records the collective it stands for
(``sharding.CollectiveEvent``), and :func:`collective_bytes` turns those
records into per-device ring-algorithm bytes on the wire, with the
reference's formulas (R = the bytes of each device's result, n = the
group's size):

  all-gather         R * (n-1)/n     (result is the gathered buffer)
  all-reduce         R * 2(n-1)/n    (reduce-scatter + all-gather)
  reduce-scatter     R * (n-1)       (operand = n*R streamed through)
  all-to-all         R * (n-1)/n
  collective-permute R

They model the production collective, not what the single controller
happens to copy.
"""
from __future__ import annotations

from collections import defaultdict


def ring_bytes(kind: str, result_bytes: float, n: int) -> float:
    """Bytes on the wire a device of an n-group sends for one
    collective of ``kind`` whose result is ``result_bytes`` a device."""
    if kind == "all-gather":
        return result_bytes * (n - 1) / n
    if kind == "all-reduce":
        return result_bytes * 2 * (n - 1) / n
    if kind == "reduce-scatter":
        return result_bytes * (n - 1)
    if kind == "all-to-all":
        return result_bytes * (n - 1) / n
    if kind == "collective-permute":
        return result_bytes
    raise ValueError(f"unknown collective {kind!r}")


def collective_bytes(events, n_devices: int = 1) -> dict:
    """Per-device bytes on the wire by collective kind, plus ``total`` and
    ``counts`` (collectives a device takes part in), the reference's
    dict. ``events``: ``sharding.CollectiveEvent``s (kind, result bytes,
    group, devices); each stands for ``devices`` devices of a mesh of
    ``n_devices``, so a device's share is the events' sum over the
    mesh."""
    out: dict = defaultdict(float)
    counts: dict = defaultdict(float)
    for e in events:
        if e.group < 2:
            continue
        share = e.devices / n_devices
        out[e.kind] += ring_bytes(e.kind, e.result_bytes, e.group) * share
        counts[e.kind] += share
    result = dict(out)
    result["total"] = float(sum(out.values()))
    result["counts"] = {k: int(round(v)) for k, v in counts.items()}
    return result


__all__ = ["collective_bytes", "ring_bytes"]
