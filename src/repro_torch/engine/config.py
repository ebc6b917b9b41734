"""Execution configuration for the port's spMTTKRP engine.

``ExecutionConfig`` mirrors ``repro.engine.config.ExecutionConfig``: the
same fields and meanings, minus Pallas ``interpret`` (a CUDA kernel has no
interpret mode), plus ``device``. The streaming fields (``residency``,
``chunk_nnz``, ``device_budget_bytes``, ``stream_ring``) come with the
streaming slice; ``donate`` has no meaning in eager PyTorch.

Backends map one-to-one onto the reference's:

  ===========  ==============  ==========================================
  port         reference       what runs
  ===========  ==============  ==========================================
  cuda_fused   pallas_fused    hand-written Hopper kernels (EC + remap)
  torch        xla (default)   ``index_select`` + ``index_add_``
  ref          ref             an alias of ``torch``
  ===========  ==============  ==========================================

The reference's ``"vmem"`` kappa policy becomes ``"smem"``: one thread
block keeps its partition's ``rows_pp x R`` f32 accumulator *and* the
``(N-1) x P x R`` factor-row stage in shared memory, so ``rows_pp`` is
what the 227 KB a Hopper block may use leaves after the stage. The policy
also keeps at least ``min_partitions`` (default ``2 x 132``, twice the
H100's SM count, capped at the mode's size) partitions so a short mode
still spreads over the SMs. With ``min_partitions=1`` and the same
``rows_pp`` the plans equal the reference's.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.kernels.mttkrp import SMEM_PER_BLOCK

KAPPA_POLICIES = ("smem", "fixed")
SCHEDULES = ("compact", "rect")

H100_SMS = 132   # streaming multiprocessors of an H100 SXM


@dataclasses.dataclass(frozen=True)
class ExecutionConfig:
    """Static execution policy for the engine (frozen, hashable).

    Attributes:
      backend: ``cuda_fused`` | ``torch`` | ``ref``.
      device: where the engine state lives. ``None`` means ``"cuda"``; a
        config asking for CUDA on a machine without a card raises here
        rather than running somewhere else.
      block_p: nonzeros per kernel block (paper's P).
      kappa_policy: ``"smem"`` (derive partitions from the shared-memory
        row tile) or ``"fixed"`` (``kappa`` verbatim).
      kappa: partition count used when ``kappa_policy == "fixed"``.
      rows_pp: rows per partition for the ``"smem"`` policy (``None`` =
        derive from ``smem_budget_bytes``).
      precision: accumulation dtype name (``"float32"``).
      fuse_remap: let a fusing backend (``cuda_fused``) emit the Alg. 3
        remap inside its kernel; ``False`` forces the ``index_copy_``
        remap for any backend (the comparison baseline).
      dedup: build the in-block factor-row dedup tables for backends that
        consume them; ``False`` installs the trivial tables.
      smem_budget_bytes: shared memory per thread block the ``"smem"``
        policy sizes the row tile against.
      rank_hint: rank R used to turn the budget into rows.
      min_partitions: floor on the partition count of a mode (capped at
        its size); ``None`` = ``2 * H100_SMS``.
      schedule: block schedule when ``engine.init`` builds plans itself.
    """

    backend: str = "torch"
    device: str | None = None
    block_p: int = 128
    kappa_policy: str = "smem"
    kappa: int | None = None
    rows_pp: int | None = None
    precision: str = "float32"
    fuse_remap: bool = True
    dedup: bool = True
    smem_budget_bytes: int = SMEM_PER_BLOCK
    rank_hint: int = 32
    min_partitions: int | None = None
    schedule: str = "compact"

    def __post_init__(self):
        if self.kappa_policy not in KAPPA_POLICIES:
            raise ValueError(
                f"kappa_policy {self.kappa_policy!r} not in {KAPPA_POLICIES}")
        if self.schedule not in SCHEDULES:
            raise ValueError(
                f"schedule {self.schedule!r} not in {SCHEDULES}")
        if self.kappa_policy == "fixed" and self.kappa is None:
            raise ValueError("kappa_policy='fixed' requires kappa")
        if self.min_partitions is not None and self.min_partitions < 1:
            raise ValueError("min_partitions must be positive")
        dev = self.torch_device
        if dev.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "ExecutionConfig asks for a CUDA device but torch sees no "
                "card; pass device='cpu' to run on the CPU")

    @property
    def torch_device(self) -> torch.device:
        return torch.device(self.device or "cuda")

    def accum_dtype(self) -> torch.dtype:
        return getattr(torch, self.precision)

    def resolve_rows_pp(self, nmodes: int) -> int:
        """Rows per partition: explicit ``rows_pp`` wins; otherwise the
        rows whose ``rank_hint``-wide f32 accumulator fits in the shared
        memory left after the ``(nmodes-1) x block_p x rank_hint`` stage."""
        if self.rows_pp is not None:
            return self.rows_pp
        row = 4 * self.rank_hint
        stage = (nmodes - 1) * self.block_p * row
        rows = (self.smem_budget_bytes - stage) // row
        if rows < 1:
            raise ValueError(
                f"a {nmodes}-mode stage of {self.block_p} x {self.rank_hint} "
                f"rows ({stage} B) leaves no room for an accumulator in "
                f"{self.smem_budget_bytes} B of shared memory")
        return rows

    def kappa_for(self, dim: int, nmodes: int) -> int:
        """Partition count for a mode of size ``dim`` under this policy."""
        if self.kappa_policy == "fixed":
            return min(self.kappa, dim)
        kappa = math.ceil(dim / self.resolve_rows_pp(nmodes))
        floor = (2 * H100_SMS if self.min_partitions is None
                 else self.min_partitions)
        return min(max(kappa, floor), dim)


__all__ = ["ExecutionConfig", "KAPPA_POLICIES", "SCHEDULES",
           "SMEM_PER_BLOCK", "H100_SMS"]
