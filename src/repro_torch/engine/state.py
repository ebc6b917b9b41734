"""Engine state for the port's spMTTKRP engine.

``EngineState`` is the device-resident half of a
:class:`~repro_torch.core.flycoo.FlycooTensor`, as in
``repro.engine.state``: the *current* FLYCOO layout (val/idx/alpha),
padded to the uniform slot count ``S_max = max_d S_d`` so every mode
shares one shape.

Tensor fields:
  val      (S_max,)     f32   nonzero values, 0 in pads
  idx      (S_max, N)   i32   beta — original per-mode indices, 0 in pads
  alpha    (S_max, N)   i32   alpha — slot of the element in every mode
                              layout (-1 in pads)
  relabel  N x (I_d,)   i32   old row id -> relabeled row id, per mode
  sched    N x ModeSched      per-mode block-schedule tables

Plain fields: ``mode`` (resident layout), ``dims``, ``statics``
(per-mode plan constants), ``config``.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from .config import ExecutionConfig


class ModeStatic(NamedTuple):
    """The subset of ``partition.ModePlan`` the kernels need (same fields,
    same order as the reference's ``ModeStatic``)."""

    kappa: int
    rows_pp: int
    blocks_pp: int
    block_p: int
    dim: int
    nblocks: int = -1        # total kernel blocks; -1 = rect default
    schedule: str = "rect"   # "compact" | "rect" block schedule

    @property
    def padded_nnz(self) -> int:
        if self.schedule == "compact":
            return self.nblocks * self.block_p
        return self.kappa * self.blocks_pp * self.block_p

    @property
    def relabeled_rows(self) -> int:
        return self.kappa * self.rows_pp


class ModeSched(NamedTuple):
    """Per-mode device-resident schedule tables.

      bpart   (nblocks,)       block -> partition descriptor (both schedules)
      pstart  (kappa+1,)       first block of each partition (+ nblocks):
                               a kernel called without a work table
                               derives the full-range one from it
      uidx    (N-1, S_d)       per-block unique factor rows, front-compacted
      upos    (S_d, N-1)       per-slot stage position among the uniques
      nuniq   (N-1, nblocks)   per-block unique-row counts
      work    (nchunks, 4)     the kernels' chunks: partition, first
                               block, end block, partial index (-1: a
                               whole partition, written to out_rel)
      wsum    (n_partials, 2)  per partial: (partition, partial count) at
                               a split partition's first partial, else
                               (-1, 0); ``work`` and ``wsum`` together are
                               a ``kernels.mttkrp.WorkTable``, built and
                               sealed on the host once per mode
                               (``engine.api.mode_work``): compact, each
                               partition's blocks in chunks of at most
                               ``default_cap(nblocks)``; rect, only each
                               partition's alive extent, at
                               ``default_cap`` of the alive blocks

    The dedup tables exist only for backends that consume them
    (``needs_dedup``) under the compact schedule, the work table only for
    backends whose kernels take one (``takes_work``: ``cuda`` and
    ``cuda_fused``, both schedules); ``None`` otherwise.
    """

    bpart: torch.Tensor
    pstart: torch.Tensor
    uidx: Optional[torch.Tensor] = None
    upos: Optional[torch.Tensor] = None
    nuniq: Optional[torch.Tensor] = None
    work: Optional[torch.Tensor] = None
    wsum: Optional[torch.Tensor] = None


def mode_static_from_plan(plan) -> ModeStatic:
    return ModeStatic(kappa=plan.kappa, rows_pp=plan.rows_pp,
                      blocks_pp=plan.blocks_pp, block_p=plan.block_p,
                      dim=plan.dim, nblocks=plan.nblocks,
                      schedule=plan.schedule)


@dataclasses.dataclass(frozen=True)
class EngineState:
    """Immutable engine state (see module docstring)."""

    val: torch.Tensor
    idx: torch.Tensor
    alpha: torch.Tensor
    relabel: tuple[torch.Tensor, ...]
    sched: tuple[ModeSched, ...]
    mode: int
    dims: tuple[int, ...]
    statics: tuple[ModeStatic, ...]
    config: ExecutionConfig

    @property
    def nmodes(self) -> int:
        return len(self.dims)

    @property
    def smax(self) -> int:
        """Uniform physical slot count (max over per-mode padded sizes)."""
        return max(s.padded_nnz for s in self.statics)

    def replace(self, **kw) -> "EngineState":
        return dataclasses.replace(self, **kw)


__all__ = ["EngineState", "ModeStatic", "ModeSched", "mode_static_from_plan"]
