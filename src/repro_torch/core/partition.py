"""Tensor partitioning scheme (paper Alg. 1) + row relabeling.

The port's copy of ``repro.core.partition`` (``ModePlan``, ``plan_mode``
and its helpers), kept bitwise-equal to the reference by the tests.

Per output mode d:
  1. order mode-d vertices (output factor rows) by the number of incident
     nonzeros (hyperedge degree), descending;
  2. deal vertices cyclically over ``kappa`` partitions;
  3. every nonzero joins the partition owning its mode-d vertex, so each
     output row is owned by exactly one partition (paper Observation 2).

Vertices are *relabeled* so partition ``j`` owns the contiguous row range
``[j*rows_pp, (j+1)*rows_pp)``: on the GPU one thread block owns that row
tile in shared memory.

Block schedules
---------------
``compact`` (default)
    Partition ``j`` gets exactly ``ceil(part_nnz[j] / P)`` blocks (min 1, so
    every output row tile is visited and written); blocks are laid out
    partition-major and the ``(nblocks,)`` ``block_part`` descriptor
    records each block's owning partition.
``rect``
    Every partition is padded to the max partition's block count
    (``blocks_pp = ceil(max part_nnz / P)``) — the comparison baseline.

Pad slots carry ``val = 0, lrow = -1`` in either schedule.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

DEFAULT_ROWS_PER_PARTITION = 512
DEFAULT_BLOCK_P = 128  # nonzeros per kernel block

SCHEDULES = ("compact", "rect")
DEFAULT_SCHEDULE = "compact"


@dataclasses.dataclass(frozen=True)
class ModePlan:
    """Host-side preprocessing output for one output mode ``d``.

    The *kernel layout* for mode d is ``nblocks`` blocks of ``block_p``
    slots (physical length ``nblocks * block_p``), laid out partition-major;
    ``block_part[b]`` is the partition owning block ``b``.
    """

    mode: int
    kappa: int                   # number of partitions
    rows_pp: int                 # relabeled rows per partition (row tile height)
    block_p: int                 # nonzeros per kernel block (paper's P)
    blocks_pp: int               # max blocks of any partition (rect grid width)
    dim: int                     # I_d
    schedule: str                # "compact" | "rect" block schedule
    nblocks: int                 # total kernel blocks in the layout
    row_relabel: np.ndarray      # (I_d,) int32 old row id -> relabeled row id
    slot_of_elem: np.ndarray     # (nnz,) int32 (int64 iff padded_nnz >= 2^31)
    part_nnz: np.ndarray         # (kappa,) int64 true nonzeros per partition
    block_part: np.ndarray       # (nblocks,) int32, nondecreasing
    max_degree: int              # d_max term of the OPT lower bound

    @property
    def padded_nnz(self) -> int:
        return self.nblocks * self.block_p

    @property
    def relabeled_rows(self) -> int:
        return self.kappa * self.rows_pp

    def load_balance(self) -> dict:
        """Max/mean partition load against ``OPT >= max(mean, d_max)``."""
        loads = self.part_nnz.astype(np.float64)
        mean = float(loads.mean())
        opt_lb = max(mean, float(self.max_degree))
        return {
            "max": float(loads.max()),
            "mean": mean,
            "max_degree": float(self.max_degree),
            "opt_lower_bound": opt_lb,
            "imbalance": float(loads.max() / max(opt_lb, 1e-9)),
            "imbalance_vs_mean": float(loads.max() / max(mean, 1e-9)),
        }


def choose_kappa(dim: int, rows_pp: int = DEFAULT_ROWS_PER_PARTITION) -> int:
    return max(1, math.ceil(dim / rows_pp))


def _part_dtype(kappa: int):
    """Narrowest dtype holding partition ids (radix argsort cost scales
    with key width)."""
    return np.uint16 if kappa <= 0xFFFF else np.int32


def _block_layout(part_nnz: np.ndarray, kappa: int, block_p: int,
                  schedule: str):
    """Block schedule: partition j owns part_blocks[j] consecutive blocks
    (min 1 per partition). Returns ``(blocks_pp, block_start (kappa+1,),
    nblocks, block_part)``."""
    blocks_pp = max(1, math.ceil(int(part_nnz.max(initial=0)) / block_p))
    if schedule == "rect":
        part_blocks = np.full(kappa, blocks_pp, dtype=np.int64)
    else:
        part_blocks = np.maximum(1, -(-part_nnz // block_p))
    block_start = np.concatenate([[0], np.cumsum(part_blocks)])  # (kappa+1,)
    nblocks = int(block_start[-1])
    block_part = np.repeat(np.arange(kappa), part_blocks).astype(np.int32)
    return blocks_pp, block_start, nblocks, block_part


def _slots_for(indices_d: np.ndarray, part_of_vertex: np.ndarray,
               part_nnz: np.ndarray, block_start: np.ndarray,
               block_p: int) -> np.ndarray:
    """Element -> physical slot: stable rank within the owning partition,
    then ``slot = block_start[j] * P + rank``."""
    nnz = indices_d.shape[0]
    part_of_elem = part_of_vertex[indices_d]
    order = np.argsort(part_of_elem, kind="stable")
    part_starts = np.concatenate([[0], np.cumsum(part_nnz[:-1])])
    offs = block_start[:-1] * block_p - part_starts    # (kappa,)
    padded = int(block_start[-1]) * block_p
    dtype = np.int32 if padded < 2**31 else np.int64
    slot_sorted = (np.arange(nnz, dtype=dtype)
                   + np.repeat(offs.astype(dtype), part_nnz))
    slot_of_elem = np.empty(nnz, dtype=dtype)
    slot_of_elem[order] = slot_sorted
    return slot_of_elem


def plan_mode(
    indices_d: np.ndarray,
    dim: int,
    mode: int,
    kappa: int | None = None,
    rows_pp: int | None = None,
    block_p: int = DEFAULT_BLOCK_P,
    schedule: str = DEFAULT_SCHEDULE,
    degrees: np.ndarray | None = None,
) -> ModePlan:
    """Run Alg. 1 for one mode and derive the block-scheduled kernel layout.

    Args:
      indices_d: (nnz,) mode-d index of every nonzero.
      dim: I_d.
      mode: d (bookkeeping only).
      kappa: partition count; default ``ceil(dim / rows_pp)``.
      rows_pp: rows per partition; derived from kappa when not given.
      schedule: ``"compact"`` or ``"rect"``.
      degrees: optional precomputed ``np.bincount(indices_d, minlength=dim)``.
    """
    if schedule not in SCHEDULES:
        raise ValueError(f"schedule {schedule!r} not in {SCHEDULES}")
    indices_d = np.ascontiguousarray(indices_d)
    if kappa is None:
        kappa = choose_kappa(dim, rows_pp or DEFAULT_ROWS_PER_PARTITION)
    kappa = min(kappa, dim)  # never more partitions than rows
    rows_pp = math.ceil(dim / kappa)

    # Alg. 1 step 1: vertices sorted by degree (descending, stable).
    if degrees is None:
        degrees = np.bincount(indices_d, minlength=dim)
    neg = -degrees.astype(np.int32) if degrees.max(initial=0) < 2**31 \
        else -degrees
    vsort = np.argsort(neg, kind="stable")  # (I_d,) vertex ids

    # Alg. 1 step 2: cyclic deal; vertex vsort[i] -> partition i % kappa,
    # local row i // kappa.
    rank = np.arange(dim, dtype=np.int32)
    part_of_rank = rank % kappa
    row_relabel = np.empty(dim, dtype=np.int32)
    row_relabel[vsort] = part_of_rank * rows_pp + rank // kappa
    part_of_vertex = np.empty(dim, dtype=_part_dtype(kappa))
    part_of_vertex[vsort] = part_of_rank.astype(part_of_vertex.dtype)

    # Alg. 1 step 3: partition loads are column sums of the rank-major deal.
    dsort = degrees[vsort]
    pad = (-dim) % kappa
    if pad:
        dsort = np.concatenate([dsort, np.zeros(pad, dtype=dsort.dtype)])
    part_nnz = dsort.reshape(-1, kappa).sum(axis=0, dtype=np.int64)
    blocks_pp, block_start, nblocks, block_part = _block_layout(
        part_nnz, kappa, block_p, schedule)
    slot_of_elem = _slots_for(indices_d, part_of_vertex, part_nnz,
                              block_start, block_p)

    return ModePlan(
        mode=mode,
        kappa=int(kappa),
        rows_pp=int(rows_pp),
        block_p=int(block_p),
        blocks_pp=int(blocks_pp),
        dim=int(dim),
        schedule=schedule,
        nblocks=nblocks,
        row_relabel=row_relabel,
        slot_of_elem=slot_of_elem,
        part_nnz=part_nnz,
        block_part=block_part,
        max_degree=int(degrees.max(initial=0)),
    )
