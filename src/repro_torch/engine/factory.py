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
and streamed: a mesh, the degradation ladder and resuming from a
snapshot raise ``NotImplementedError`` until their slices land.
"""
from __future__ import annotations

import dataclasses
import itertools

from repro_torch.kernels.mttkrp import SMEM_PER_BLOCK

from .config import RESIDENCIES, SCHEDULES, ExecutionConfig

# Searchable spec fields, in enumeration order (PlanSpace dimensions).
SPACE_DIMS = ("backend", "schedule", "block_p", "rows_pp",
              "smem_budget_bytes", "dedup", "fuse_remap", "exchange",
              "residency", "chunk_nnz")

EXCHANGES = ("permute", "all_gather")     # distributed remap exchanges


@dataclasses.dataclass(frozen=True)
class PlanSpec:
    """One point in the plan space (frozen, usable as a dict key).

    Engine knobs mirror :class:`~repro_torch.engine.config.ExecutionConfig`.
    ``exchange`` (distributed remap schedule) and ``ladder`` keep the
    reference's values and meanings so the space enumerates the same
    points; ``make_engine`` serves only what the port has.
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
                start_mode: int = 0, cache=None, mesh=None, ladder=None,
                resume=None):
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
    ``device_budget_bytes``: a tensor that does not fit streams. Without
    the degradation ladder an out-of-memory error of the resident tier
    propagates, as in the reference with no policy.

    Not yet ported, and refused with ``NotImplementedError`` rather than
    served by something else: ``mesh`` (the distributed tier, ROADMAP
    Queue A item 10), ``ladder`` other than ``None``/``False`` and
    ``resume`` (resilience, item 9).
    """
    from repro_torch.core.plancache import DEFAULT_CACHE
    from repro_torch.obs.trace import span

    from .api import as_flycoo, init
    from .stream import resident_bytes, stream_init

    spec = (spec or PlanSpec()).canonical()
    if mesh is not None:
        raise NotImplementedError(
            "make_engine(mesh=...): the distributed tier is ROADMAP Queue A "
            "item 10, not yet ported")
    if ladder is None:
        ladder = spec.ladder
    if ladder not in (None, False):
        raise NotImplementedError(
            "make_engine(ladder=...): the degradation ladder is ROADMAP "
            "Queue A item 9 (resilience), not yet ported")
    if resume is not None:
        raise NotImplementedError(
            "make_engine(resume=...): snapshot resume is ROADMAP Queue A "
            "item 9 (resilience), not yet ported")
    if cache is None:
        cache = DEFAULT_CACHE
    elif cache is False:
        cache = None
    config = spec.to_config()
    with span("factory.make_engine", backend=spec.backend,
              schedule=spec.schedule, residency=spec.residency) as sp:
        residency = spec.residency
        if residency == "auto":
            # the plans size the resident footprint: build them once
            # (through the cache) and hand the planned tensor to the tier
            tensor = as_flycoo(tensor, config, cache=cache)
            over = resident_bytes(tensor, config) > config.device_budget_bytes
            residency = "stream" if over else "full"
        sp.set("resolved_residency", residency)
        if residency == "full":
            return init(tensor, config, start_mode, cache=cache)
        return stream_init(tensor, config, start_mode, cache=cache)


__all__ = ["PlanSpec", "PlanSpace", "make_engine", "SPACE_DIMS",
           "EXCHANGES", "RESIDENCIES"]
