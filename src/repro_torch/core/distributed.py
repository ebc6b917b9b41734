"""Sharded FLYCOO planning and the deprecated stateful shim over
:mod:`repro_torch.engine.dist` (the port of ``repro.core.distributed``).

  * :func:`build_sharded_flycoo`: FLYCOO preprocessing with each mode's
    partition count rounded to a multiple of the shard count
    (:meth:`~repro_torch.engine.ExecutionConfig.kappa_for` with
    ``n_dev``), so every shard owns an equal, contiguous run of
    partitions. At the same ``rows_pp``, ``block_p``, ``schedule`` and
    ``n_dev`` the plans are the reference's bit for bit.
  * :class:`DistributedMTTKRP`: a thin stateful wrapper threading a
    ``DistState`` through ``dist_mttkrp`` / ``dist_all_modes``, from any
    resident mode, with ``reset()``.

New code should use :mod:`repro_torch.engine.dist` directly.
"""
from __future__ import annotations

import warnings
from typing import Sequence

import numpy as np
import torch

from repro_torch import engine as _engine
from repro_torch.engine import ExecutionConfig
from repro_torch.engine.dist import (DistConfig, dist_all_modes, dist_mttkrp,
                                     shard_state)

from .flycoo import FlycooTensor
from .partition import plan_mode


def build_sharded_flycoo(indices, values, dims, n_dev: int,
                         rows_pp: int = 512, block_p: int = 128,
                         schedule: str | None = None) -> FlycooTensor:
    """FLYCOO preprocessing with kappa forced to a multiple of ``n_dev``:
    ``ceil(dim / rows_pp)`` partitions (the reference's ``choose_kappa``;
    no partition floor), rounded by ``kappa_for``."""
    indices = np.asarray(indices, np.int32)
    values = np.asarray(values, np.float32)
    # host planning only: the config never places anything
    cfg = ExecutionConfig(rows_pp=rows_pp, block_p=block_p,
                          min_partitions=1, device="cpu",
                          **({} if schedule is None
                             else {"schedule": schedule}))
    n = len(dims)
    plans = [
        plan_mode(indices[:, d], int(dims[d]), d,
                  kappa=cfg.kappa_for(int(dims[d]), n, n_dev=n_dev),
                  block_p=block_p, schedule=cfg.schedule)
        for d in range(n)
    ]
    return FlycooTensor(tuple(int(x) for x in dims), indices, values, plans)


class DistributedMTTKRP:
    """DEPRECATED stateful wrapper around :mod:`repro_torch.engine.dist`.

    ``all_modes`` works from any resident mode and ``reset()`` returns to
    the start-mode layout. The exchange defaults to the permute schedule;
    ``exchange="all_gather"`` runs the baseline. ``config`` (the port's
    addition) is the engine's ``ExecutionConfig``; the default one asks
    for the card.
    """

    def __init__(self, tensor: FlycooTensor, mesh, data_axis: str = "data",
                 model_axis: str | None = None, exchange: str = "permute",
                 *, config: ExecutionConfig | None = None):
        warnings.warn(
            "DistributedMTTKRP is deprecated; use repro_torch.engine.dist "
            "(shard_state/dist_mttkrp/dist_all_modes)", DeprecationWarning,
            stacklevel=2)
        self.tensor = tensor
        self.mesh = mesh
        self.da = data_axis
        self.ma = model_axis
        self.n_dev = mesh.shape[data_axis]
        self.config = config or ExecutionConfig()
        self.dist = DistConfig(data_axis=data_axis, model_axis=model_axis,
                               exchange=exchange)
        self.reset()
        self.row_relabel = list(self._dstate.relabel[self._dstate.device])

    @property
    def state(self):
        """The underlying ``DistState`` (read-only)."""
        return self._dstate

    @property
    def current_mode(self) -> int:
        return self._dstate.mode

    @property
    def layout(self) -> dict:
        """The per-shard layout tensors (device-major numbering)."""
        return {"val": self._dstate.val, "idx": self._dstate.idx,
                "alpha": self._dstate.alpha}

    def step(self, factors: Sequence[torch.Tensor]) -> torch.Tensor:
        """MTTKRP for the current mode + cross-shard remap; rotate."""
        out, self._dstate = dist_mttkrp(self._dstate, tuple(factors))
        return out

    def all_modes(self, factors: Sequence[torch.Tensor]) -> list:
        """All-modes MTTKRP from any current mode; outputs by mode."""
        outs, self._dstate = dist_all_modes(self._dstate, tuple(factors))
        return outs

    def reset(self) -> None:
        """Return to the start-mode sharded layout."""
        self._dstate = shard_state(_engine.init(self.tensor, self.config),
                                   self.mesh, self.dist)


__all__ = ["build_sharded_flycoo", "DistributedMTTKRP"]
