"""Declarative plan/backend factory: ``PlanSpec`` / ``PlanSpace`` /
``make_engine`` (the port of ``repro.engine.factory``).

``PlanSpec``
    One *point* in the plan space: every searchable knob (block size P,
    block schedule, kappa policy, shared-memory budget, dedup, fused
    remap, backend, and the distributed and streaming knobs) in one frozen
    dataclass. ``to_config()`` derives the engine's ``ExecutionConfig``.

``PlanSpace``
    A *set* of candidate values per searchable dimension (the autotuner's
    domain). ``specs()`` enumerates the cartesian product as canonical
    ``PlanSpec`` points, with settings of identical meaning (e.g. dedup
    under the ``rect`` schedule, where no dedup tables exist) collapsed.

``make_engine``
    The one entry point: COO triple or prebuilt tensor + spec -> a
    device-resident ``EngineState`` or, for the streaming tier, a
    ``StreamState`` (:mod:`.stream`), planned through the sparsity-
    signature plan cache (:mod:`repro_torch.core.plancache`).

Names follow the port's (reference in brackets): backends ``torch``
[``xla``], ``cuda`` [``pallas``], ``cuda_fused`` [``pallas_fused``];
kappa policy ``"smem"`` [``"vmem"``]; ``smem_budget_bytes``
[``vmem_budget_bytes``]. ``device`` takes the place of Pallas
``interpret``, and ``min_partitions`` is the port's partition floor
(see :mod:`.config`). The port serves the single-device tiers, resident
and streamed, with the degradation ladder's residency rung and the
resume shape guard, and the distributed tier: with a ``mesh`` the
resident state is sharded over its data axis (:mod:`.dist`).
"""
from __future__ import annotations

import dataclasses
import itertools

from repro_torch.kernels.mttkrp import SMEM_PER_BLOCK

from .config import RESIDENCIES, SCHEDULES, ExecutionConfig
from .dist import EXCHANGES, DistConfig

# Searchable spec fields, in enumeration order (PlanSpace dimensions).
SPACE_DIMS = ("backend", "schedule", "block_p", "rows_pp",
              "smem_budget_bytes", "dedup", "fuse_remap", "exchange",
              "residency", "chunk_nnz")


@dataclasses.dataclass(frozen=True)
class PlanSpec:
    """One point in the plan space (frozen, usable as a dict key).

    Engine knobs mirror :class:`~repro_torch.engine.config.ExecutionConfig`.
    ``exchange`` (distributed remap schedule) keeps the reference's
    values and meanings so the space enumerates the same points;
    ``ladder`` is ``make_engine``'s default ``ladder=``.
    """

    backend: str = "torch"
    schedule: str = "compact"
    block_p: int = 128
    kappa_policy: str = "smem"
    kappa: int | None = None
    rows_pp: int | None = None
    smem_budget_bytes: int = SMEM_PER_BLOCK
    rank_hint: int = 32
    min_partitions: int | None = None
    dedup: bool = True
    fuse_remap: bool = True
    device: str | None = None
    exchange: str = "permute"
    residency: str = "auto"
    chunk_nnz: int | None = None
    device_budget_bytes: int | None = None
    stream_ring: int = 2
    ladder: bool | None = None

    def __post_init__(self):
        if self.exchange not in EXCHANGES:
            raise ValueError(
                f"exchange {self.exchange!r} not in {EXCHANGES}")
        self.to_config()   # the engine knobs validate there

    def to_config(self) -> ExecutionConfig:
        return ExecutionConfig(
            backend=self.backend, device=self.device, block_p=self.block_p,
            kappa_policy=self.kappa_policy, kappa=self.kappa,
            rows_pp=self.rows_pp, fuse_remap=self.fuse_remap,
            dedup=self.dedup, smem_budget_bytes=self.smem_budget_bytes,
            rank_hint=self.rank_hint, min_partitions=self.min_partitions,
            schedule=self.schedule, residency=self.residency,
            chunk_nnz=self.chunk_nnz,
            device_budget_bytes=self.device_budget_bytes,
            stream_ring=self.stream_ring)

    def to_dist_config(self, data_axis: str = "data") -> DistConfig:
        return DistConfig(data_axis=data_axis, exchange=self.exchange)

    def canonical(self) -> "PlanSpec":
        """Collapse knob settings of identical meaning to one point: dedup
        exists only for ``needs_dedup`` backends under ``compact``; fused
        remap only for backends exposing ``fused_remap``; streaming knobs
        only for the streaming tier. Unlike the reference, the
        shared-memory budget is never derived from ``device_budget_bytes``
        (the port has no ``derive_vmem_budget``): a Hopper block's shared
        memory is the card's fixed 227 KB, not a share of device
        memory."""
        from .backends import get_backend

        backend = get_backend(self.backend)
        spec = self
        if self.schedule != "compact" or \
                not getattr(backend, "needs_dedup", False):
            spec = dataclasses.replace(spec, dedup=True)
        if getattr(backend, "fused_remap", None) is None:
            spec = dataclasses.replace(spec, fuse_remap=True)
        if spec.residency == "auto" and spec.device_budget_bytes is None:
            # auto without a budget can only ever resolve to full
            spec = dataclasses.replace(spec, residency="full")
        if spec.residency == "full":
            spec = dataclasses.replace(spec, chunk_nnz=None, stream_ring=2)
        return spec


@dataclasses.dataclass(frozen=True)
class PlanSpace:
    """Candidate values per searchable knob (the autotuner's domain).

    Each field lists the values that dimension may take; ``base`` carries
    the non-searched remainder (kappa policy, rank hint, device).
    """

    backend: tuple = ("cuda_fused",)
    schedule: tuple = SCHEDULES
    block_p: tuple = (64, 128, 256)
    rows_pp: tuple = (None,)
    smem_budget_bytes: tuple = (SMEM_PER_BLOCK,)
    dedup: tuple = (True, False)
    fuse_remap: tuple = (True,)
    exchange: tuple = ("permute",)
    residency: tuple = ("auto",)
    chunk_nnz: tuple = (None,)
    base: PlanSpec = dataclasses.field(default_factory=PlanSpec)

    def specs(self) -> tuple[PlanSpec, ...]:
        """The cartesian product as canonical, deduplicated PlanSpecs, in
        a deterministic order (the autotuner's tie-break)."""
        seen: dict[PlanSpec, None] = {}
        axes = [getattr(self, f) for f in SPACE_DIMS]
        for combo in itertools.product(*axes):
            spec = dataclasses.replace(
                self.base, **dict(zip(SPACE_DIMS, combo))).canonical()
            seen.setdefault(spec, None)
        return tuple(seen)

    @property
    def size(self) -> int:
        return len(self.specs())


def make_engine(tensor, spec: PlanSpec | None = None, *,
                start_mode: int = 0, cache=None, mesh=None,
                data_axis: str = "data", ladder=None, resume=None):
    """Build an engine from one declarative ``spec``.

    ``tensor`` is a raw COO triple ``(indices, values, dims)`` or a
    prebuilt :class:`~repro_torch.core.flycoo.FlycooTensor` (its plans
    win). ``cache`` is a :class:`~repro_torch.core.plancache.PlanCache`
    (``None`` uses the process-wide default; ``cache=False`` forces cold
    planning).

    The spec's ``residency`` picks the memory tier: ``"full"`` returns a
    device-resident ``EngineState``, ``"stream"`` the out-of-core
    ``StreamState`` (:mod:`.stream`), and ``"auto"`` compares the
    resident footprint (:func:`.stream.resident_bytes`) with
    ``device_budget_bytes``: a tensor that does not fit streams.

    ``ladder`` (``True`` / a :class:`~repro_torch.resilience.
    LadderPolicy`) enables the residency rung, as in the reference: if
    placing the *full* layout runs out of memory (a real
    ``torch.cuda.OutOfMemoryError`` or the ``oom_resident`` chaos fault),
    the factory records ``oom: full -> stream`` and returns the streaming
    tier instead. Before it does, it drops every reference to the partial
    state and returns the cached blocks to the card, so the stream does
    not meet the same OOM. ``ladder=None`` defers to ``spec.ladder``,
    then to the ambient ``REPRO_LADDER`` policy; without a policy the
    error propagates.

    ``resume`` (a :class:`~repro_torch.resilience.Snapshot`) is checked
    against this problem before any state is built: one factor a mode
    with matching rows (the ALS entry points also match the content
    fingerprint).

    ``mesh`` (a :class:`~repro_torch.launch.mesh.Mesh`) returns the
    resident state sharded over its ``data_axis`` (a ``DistState``, with
    the spec's ``exchange``); a
    :class:`~repro_torch.sharding.ShardingCtx` in its place gives the
    axes, ``data_axis=ctx.data_axis`` and ``model_axis=ctx.tp_axis``; a
    raw COO tensor is then planned with each mode's kappa rounded to the
    shard count (``kappa_for(n_dev=)``). The mesh tier is resident:
    ``residency="stream"`` with a mesh raises, ``"auto"`` resolves to
    ``"full"``, and an OOM has no stream rung.
    """
    from repro_torch.core.flycoo import FlycooTensor
    from repro_torch.core.plancache import DEFAULT_CACHE
    from repro_torch.obs.trace import span
    from repro_torch.resilience import chaos as _chaos
    from repro_torch.resilience.ladder import (classify, record_degradation,
                                               resolve_policy)

    from .api import as_flycoo, init
    from .stream import resident_bytes, stream_init

    from .dist import check_mesh, from_ctx, shard_state

    spec = (spec or PlanSpec()).canonical()
    n_dev = 1
    if mesh is not None:
        dist = spec.to_dist_config(data_axis)
        mesh, ctx_dist = from_ctx(mesh)
        if ctx_dist is not None:
            data_axis = ctx_dist.data_axis
            dist = dataclasses.replace(spec.to_dist_config(data_axis),
                                       model_axis=ctx_dist.model_axis)
        check_mesh(mesh, dist)
        if spec.residency == "stream":
            raise ValueError(
                "residency='stream' is a single-device tier; drop mesh "
                "or use residency='full'")
        n_dev = mesh.shape[data_axis]
    policy = resolve_policy(spec.ladder if ladder is None else ladder)
    if resume is not None:
        dims = (tensor.dims if isinstance(tensor, FlycooTensor)
                else tuple(int(d) for d in tensor[2]))
        shapes = tuple(int(f.shape[0]) for f in resume.factors)
        if shapes != tuple(dims):
            raise ValueError(
                f"snapshot {resume.path!r} does not match this problem: "
                f"factor rows {shapes} != dims {tuple(dims)}")
    if cache is None:
        cache = DEFAULT_CACHE
    elif cache is False:
        cache = None
    config = spec.to_config()
    with span("factory.make_engine", backend=spec.backend,
              schedule=spec.schedule, residency=spec.residency,
              sharded=mesh is not None) as sp:
        if mesh is not None:
            # per-mode kappa rounded to the shard count, so every shard
            # owns an equal, contiguous run of partitions
            tensor = as_flycoo(tensor, config, cache=cache, n_dev=n_dev)
        residency = spec.residency
        if residency == "auto":
            # the plans size the resident footprint: build them once
            # (through the cache) and hand the planned tensor to the tier
            tensor = as_flycoo(tensor, config, cache=cache)
            over = resident_bytes(tensor, config) > config.device_budget_bytes
            residency = "stream" if over and mesh is None else "full"
        sp.set("resolved_residency", residency)
        if residency == "full":
            try:
                cz = _chaos.active()
                if cz is not None:
                    cz.on_resident_init()
                state = init(tensor, config, start_mode, cache=cache)
                return state if mesh is None else shard_state(state, mesh,
                                                              dist)
            except Exception as exc:
                if policy is None or mesh is not None \
                        or classify(exc) != "oom":
                    raise
                record_degradation("oom", "full", "stream",
                                   site="factory.residency")
                sp.set("resolved_residency", "stream")
            # out of the except block, the traceback and its frames (the
            # partial state's last references) are gone
            _release_device(config)
        return stream_init(tensor, config, start_mode, cache=cache)


def _release_device(config) -> None:
    """After an OOM of the resident tier: collect what the failed ``init``
    left in reference cycles and return the allocator's cached blocks to
    the card."""
    if config.torch_device.type != "cuda":
        return
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()


__all__ = ["PlanSpec", "PlanSpace", "make_engine", "SPACE_DIMS",
           "EXCHANGES", "RESIDENCIES"]
