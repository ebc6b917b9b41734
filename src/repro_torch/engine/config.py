"""Execution configuration for the port's spMTTKRP engine.

``ExecutionConfig`` mirrors ``repro.engine.config.ExecutionConfig``: the
same fields and meanings, minus Pallas ``interpret`` (a CUDA kernel has no
interpret mode), plus ``device``. ``donate`` keeps the reference's
meaning for the rotation that ``engine.all_modes`` replays as one CUDA
graph on the card: the returned state takes over the graph's layout
buffers, with no second live copy, and the state passed in is consumed.
The streaming fields (``residency``, ``chunk_nnz``,
``device_budget_bytes``, ``stream_ring``) are the reference's, with its
validation.

Backends map one-to-one onto the reference's; each serves both block
schedules:

  ===========  ==============  ==========================================
  port         reference       what runs
  ===========  ==============  ==========================================
  cuda_fused   pallas_fused    hand-written Hopper kernels that gather
                               the factor rows themselves (EC + remap)
  cuda         pallas          PyTorch gathers the ``(S, N-1, R)``
                               operand, a hand-written Hopper kernel
                               reduces it (the fusion baseline)
  torch        xla (default)   ``index_select`` + ``index_add_``
  ref          ref             an alias of ``torch``
  ===========  ==============  ==========================================

The reference's ``"vmem"`` kappa policy becomes ``"smem"``: a thread
block of the ``cuda_fused`` compact kernels keeps a ``rows_pp x R`` f32
accumulator *and* its pipeline's buffers in shared memory (one
``(N-1) x P x R`` factor-row stage and two blocks of metadata,
``kernels.mttkrp.balanced_smem_bytes``), so ``rows_pp`` is what the 227 KB
a Hopper block may use leaves after those. Every other kernel needs less
for the same ``rows_pp``. The policy also keeps at least
``min_partitions`` (default ``2 x 132``, twice the H100's SM count,
capped at the mode's size) partitions so a short mode still spreads over
the SMs. With ``min_partitions=1`` and the same
``rows_pp`` the plans equal the reference's.

The reference derives its VMEM budget from the device budget
(``derive_vmem_budget``) and refuses a VMEM budget above the device
budget; the port has neither. A Hopper block's shared memory is the
card's fixed 227 KB, not a share of device memory, so
``smem_budget_bytes`` defaults to that, nothing derives it, and a device
budget below it is no contradiction.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.kernels.mttkrp import (H100_SMS, SMEM_PER_BLOCK,
                                        balanced_smem_bytes)

KAPPA_POLICIES = ("smem", "fixed")
SCHEDULES = ("compact", "rect")

# Residency tiers: "full" keeps the whole FLYCOO layout on the device;
# "stream" keeps it in pinned host memory and streams partition-aligned
# chunks through a ring of device buffers (``engine.stream``); "auto"
# lets ``factory.make_engine`` pick: stream exactly when the resident
# layout would exceed ``device_budget_bytes``.
RESIDENCIES = ("auto", "full", "stream")

# The degradation ladder's backend order (``repro_torch.resilience``): on
# a kernel build failure the engine steps one rung down, each rung more
# portable than the one above; the reference's ``pallas_fused -> pallas
# -> xla -> ref`` (``ref`` is the same function as ``torch`` here, so it
# is no rung). On the card the ladder ends at the last hand-written
# kernel backend, ``CARD_LADDER``: plain PyTorch never takes over a
# card's tensors, so a failure of both kernels raises.
CARD_LADDER = ("cuda_fused", "cuda")
BACKEND_LADDER = CARD_LADDER + ("torch",)


@dataclasses.dataclass(frozen=True)
class ExecutionConfig:
    """Static execution policy for the engine (frozen, hashable).

    Attributes:
      backend: ``cuda_fused`` | ``cuda`` | ``torch`` | ``ref``.
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
      donate: hand the rotation graph's layout buffers to the returned
        state (``engine.all_modes``: the paper's T_in/T_out swap without a
        second live copy; the state passed in is consumed, as a donated
        JAX buffer is). ``None`` = donate on the card, where the
        reference donates on a TPU or GPU; the CPU runs the eager loop,
        which never writes its input.
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
      residency: memory tier, ``"full"``, ``"stream"`` or ``"auto"`` (see
        ``RESIDENCIES``).
      chunk_nnz: target slots of a streamed chunk (whole partitions; the
        planner rounds). ``None`` = derive from ``device_budget_bytes``,
        else the library default.
      device_budget_bytes: device memory the streaming tier sizes its
        chunk ring against, and the threshold ``"auto"`` compares the
        resident layout with.
      stream_ring: device chunk buffers of the streaming ring (2: chunk
        k computes while k+1 uploads).
    """

    backend: str = "torch"
    device: str | None = None
    block_p: int = 128
    kappa_policy: str = "smem"
    kappa: int | None = None
    rows_pp: int | None = None
    precision: str = "float32"
    donate: bool | None = None
    fuse_remap: bool = True
    dedup: bool = True
    smem_budget_bytes: int = SMEM_PER_BLOCK
    rank_hint: int = 32
    min_partitions: int | None = None
    schedule: str = "compact"
    residency: str = "auto"
    chunk_nnz: int | None = None
    device_budget_bytes: int | None = None
    stream_ring: int = 2

    def __post_init__(self):
        if self.kappa_policy not in KAPPA_POLICIES:
            raise ValueError(
                f"kappa_policy {self.kappa_policy!r} not in {KAPPA_POLICIES}")
        if self.schedule not in SCHEDULES:
            raise ValueError(
                f"schedule {self.schedule!r} not in {SCHEDULES}")
        if self.residency not in RESIDENCIES:
            raise ValueError(
                f"residency {self.residency!r} not in {RESIDENCIES}")
        if self.kappa_policy == "fixed" and self.kappa is None:
            raise ValueError("kappa_policy='fixed' requires kappa")
        if self.min_partitions is not None and self.min_partitions < 1:
            raise ValueError("min_partitions must be positive")
        if self.chunk_nnz is not None and self.chunk_nnz < 1:
            raise ValueError("chunk_nnz must be positive")
        if (self.device_budget_bytes is not None
                and self.device_budget_bytes < 1):
            raise ValueError("device_budget_bytes must be positive")
        if self.stream_ring < 1:
            raise ValueError("stream_ring must be >= 1")
        dev = self.torch_device
        if dev.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "ExecutionConfig asks for a CUDA device but torch sees no "
                "card; pass device='cpu' to run on the CPU")

    @property
    def torch_device(self) -> torch.device:
        return torch.device(self.device or "cuda")

    def resolve_donate(self) -> bool:
        if self.donate is None:
            return self.torch_device.type == "cuda"
        return bool(self.donate)

    def accum_dtype(self) -> torch.dtype:
        return getattr(torch, self.precision)

    def resolve_rows_pp(self, nmodes: int) -> int:
        """Rows per partition: explicit ``rows_pp`` wins; otherwise the
        rows whose ``rank_hint``-wide f32 accumulator fits in the shared
        memory that the balanced kernel with the remap leaves after its
        buffers at ``block_p`` (``balanced_smem_bytes``, the launch check's
        own formula)."""
        if self.rows_pp is not None:
            return self.rows_pp
        row = 4 * self.rank_hint
        stage = balanced_smem_bytes(0, self.rank_hint, nmodes - 1,
                                    self.block_p, nmodes)
        rows = (self.smem_budget_bytes - stage) // row
        if rows < 1:
            raise ValueError(
                f"a {nmodes}-mode stage of {self.block_p} x {self.rank_hint} "
                f"rows ({stage} B) leaves no room for an accumulator in "
                f"{self.smem_budget_bytes} B of shared memory")
        return rows

    def kappa_for(self, dim: int, nmodes: int, *, n_dev: int = 1) -> int:
        """Partition count for a mode of size ``dim`` under this policy
        (``nmodes`` sizes the ``"smem"`` row tile), rounded, as in the
        reference, so that each of ``n_dev`` shards owns an equal,
        contiguous run of partitions: ``kappa % n_dev == 0`` and ``kappa
        <= dim``; a mode with fewer rows than shards raises."""
        if self.kappa_policy == "fixed":
            base = self.kappa
        else:
            floor = (2 * H100_SMS if self.min_partitions is None
                     else self.min_partitions)
            base = max(math.ceil(dim / self.resolve_rows_pp(nmodes)), floor)
        if n_dev <= 1:
            return min(base, dim)
        if dim < n_dev:
            raise ValueError(
                f"mode of size {dim} cannot shard over {n_dev} devices "
                "(fewer rows than devices)")
        kappa = max(n_dev, math.ceil(base / n_dev) * n_dev)
        return min(kappa, (dim // n_dev) * n_dev)


__all__ = ["ExecutionConfig", "KAPPA_POLICIES", "SCHEDULES", "RESIDENCIES",
           "BACKEND_LADDER", "CARD_LADDER", "SMEM_PER_BLOCK", "H100_SMS"]
