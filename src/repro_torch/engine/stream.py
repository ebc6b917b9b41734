"""Out-of-core streaming spMTTKRP engine: tensors whose FLYCOO layout does
not fit the device (the port of ``repro.engine.stream``).

The resident engine (:mod:`.api`) keeps the whole layout on the device.
This tier keeps it in pinned host memory and streams partition-aligned
*chunks* of each mode's block schedule through a ring of
``config.stream_ring`` device buffers: while chunk ``k`` runs its
elementwise computation on the compute stream, chunk ``k+1`` uploads on a
copy stream of its own.

Chunks are whole partitions (:func:`repro_torch.core.partition.
chunk_schedule`). Every output row is owned by exactly one partition
(paper Observation 2) and a partition's slots are a contiguous run of the
partition-major layout, so chunk ``c`` is the slot range ``[b0*P, b1*P)``
and writes only the relabeled rows ``[p0*rows_pp, p1*rows_pp)``, seeing
its slots in the resident engine's order.

How it runs on the card:

* **Host layout.** Two pinned layouts (``val``, ``idx``, ``alpha``,
  ``lrow``; numpy views for the host remap), the current mode's and the
  next's, used in turn. A chunk's upload reads straight from slices of
  the current one. The dedup tables the ``cuda_fused`` compact kernel
  reads are pinned once per mode at :func:`stream_init`, laid out chunk
  by chunk, so that each chunk's ``uidx (N-1, m)`` and ``nuniq (N-1,
  nb)`` are contiguous too.
* **The ring.** Each of ``stream_ring`` device slots is allocated once,
  at the largest chunk's size. An upload runs on the copy stream with
  ``non_blocking=True`` after waiting for the slot's "free" event, then
  records "uploaded"; the compute stream waits for that before the
  chunk's kernel and records "free" after it. Nothing in the chunk loop
  reads the device back. The one host wait of a mode comes before the
  host writes into the layout whose uploads fed the mode before.
* **What reaches the backend.** Each chunk at its real size: ``(b1 -
  b0)*P`` slots under a chunk-local ``ModeStatic`` (``kappa = p1 - p0``,
  ``nblocks = b1 - b0``), with a work table built at :func:`stream_init`
  at the *resident* mode's cap (:func:`.api.mode_cap`), so that a
  partition splits exactly as in the resident engine. Its ``out_rel``
  goes straight into accumulator rows ``[p0*rows_pp, p1*rows_pp)``. The
  reference's uniform chunk shape (``StreamPlan.lstatics``) is kept for
  its budget model only.
* **The remap** (Alg. 3) is host work, as in the reference: chunk ``c``'s
  alive elements are scattered into the next pinned layout through
  ``alpha[:, d+1]`` while the device computes chunk ``c``.

On the CPU (``device="cpu"``) the same path runs with plain copies, no
streams and no pinning; the kernels' plain versions then sum each row in
the resident engine's order, so a streamed run is bitwise equal to the
resident one. On the card the kernels' shared-memory atomics are not
bitwise reproducible, so there outputs are held to a tolerance and only
the host layouts bitwise.

A :class:`StreamState` is consumed by :func:`stream_mttkrp`: the state it
returns shares (and overwrites) its pinned buffers and its ring.

Public surface: :class:`StreamPlan` / :func:`plan_stream`,
:class:`StreamState` / :func:`stream_init`, :func:`stream_mttkrp`,
:func:`stream_all_modes`, :func:`cp_als_stream`, and the budget model
(:func:`resident_bytes`, :func:`resolve_chunk_slots`,
:func:`stream_transfer_model`) that ``factory.make_engine`` and
``engine.autotune`` price streaming with.

Resilience (:mod:`repro_torch.resilience`), as in the reference: with a
ladder policy an upload that fails transiently is retried with seeded
backoff; a mode that runs out of memory halves the chunk budget and
replans through the plan cache; a kernel build failure steps the backend
down the ladder (``CARD_LADDER`` on the card) and replans. A replan
re-derives the pinned tables, the chunk-local descriptors and the
per-chunk work tables at the resident mode's cap, and keeps the ring
where its slots still hold the new chunks (a slot is written only after
its "free" event). The chaos
hooks ``on_upload``, ``on_chunk_compute`` and ``on_dispatch`` fire here;
``cp_als_stream`` adds checkpoints, resume and the NaN guard.
"""
from __future__ import annotations

import dataclasses
import functools
import hashlib
import math
import time
from typing import Sequence

import numpy as np
import torch

from repro_torch.core.partition import ChunkSchedule, chunk_schedule
from repro_torch.obs.metrics import counter as _obs_counter
from repro_torch.obs.metrics import gauge as _obs_gauge
from repro_torch.obs.probe import device_peak_bytes
from repro_torch.obs.trace import span
from repro_torch.resilience import chaos as _chaos
from repro_torch.resilience.ladder import (backoff_delay, classify,
                                           next_backend, record_degradation,
                                           record_retry, resolve_policy)
from repro_torch.resilience.snapshot import as_store, fingerprint

from .api import as_flycoo, mode_cap, mode_work
from .backends import get_backend
from .config import ExecutionConfig
from .state import ModeStatic, mode_static_from_plan

#: Chunk size (kernel slots) when neither ``chunk_nnz`` nor
#: ``device_budget_bytes`` is configured.
DEFAULT_CHUNK_SLOTS = 1 << 20


def row_bytes(nmodes: int) -> int:
    """Bytes of one element row: val f32 + idx i32*N + alpha i32*N (the
    reference's ``engine.dist.row_bytes``)."""
    return 4 * (1 + 2 * nmodes)


# --------------------------------------------------------------------------
# Budget model (host-side, the reference's formulas).
# --------------------------------------------------------------------------
def _wants_tables(config: ExecutionConfig, schedule: str) -> bool:
    """Whether streamed chunks carry the in-block dedup tables: the
    condition ``engine.api._mode_sched`` uses for residency."""
    return (schedule == "compact"
            and getattr(get_backend(config), "needs_dedup", False))


def bytes_per_slot(nmodes: int, tables: bool) -> int:
    """Device bytes one streamed slot costs in the reference's model: val
    f32 + idx i32*N + lrow i32, plus the dedup tables (uidx + upos,
    i32*(N-1) each) when the backend reads them, plus 4 bytes of slack for
    the per-block descriptor and ``nuniq``."""
    b = 4 * (2 + nmodes) + 4
    if tables:
        b += 8 * (nmodes - 1)
    return b


def chunk_device_bytes(cs: ChunkSchedule, nmodes: int, tables: bool) -> int:
    """Device bytes of one uniformly padded chunk in the reference's model
    (the port uploads each chunk at its real size, without ``idx`` where
    the backend does not read it, so never more)."""
    s, nb = cs.chunk_slots, cs.chunk_blocks
    b = s * 4 * (2 + nmodes) + nb * 4
    if tables:
        b += s * 8 * (nmodes - 1) + nb * 4 * (nmodes - 1)
    return b


def stream_fixed_bytes(dims: Sequence[int], config: ExecutionConfig,
                       rank: int | None = None,
                       statics: Sequence[ModeStatic] | None = None) -> int:
    """Device bytes the streaming tier holds besides the chunk ring: the
    factor matrices, the relabel tables, the accumulator (``2 * rmax * R``
    in the reference's model; the port's accumulator and one chunk's
    ``out_rel`` fit in it) and one mode output."""
    rank = rank or config.rank_hint
    n = len(dims)
    if statics is not None:
        rmax = max(s.relabeled_rows for s in statics)
    else:
        rmax = 0
        for dim in dims:
            kappa = config.kappa_for(int(dim), n)
            rmax = max(rmax, kappa * math.ceil(int(dim) / kappa))
    acc = 2 * rmax * rank * 4
    factors = sum(int(d) for d in dims) * rank * 4
    out = max(int(d) for d in dims) * rank * 4
    relabel = sum(int(d) for d in dims) * 4
    return acc + factors + out + relabel


def resolve_chunk_slots(config: ExecutionConfig, dims: Sequence[int], *,
                        tables: bool = False,
                        statics: Sequence[ModeStatic] | None = None) -> int:
    """Target slots of a streamed chunk, the one sizing rule: explicit
    ``chunk_nnz``; else derived from ``device_budget_bytes`` so that the
    ring of ``stream_ring`` chunks plus the fixed bytes fit the budget;
    else the library default. Never below one block: a partition larger
    than the target still forms an (oversized) chunk of its own, so
    streaming always completes and may exceed an impossibly small
    budget."""
    if config.chunk_nnz is not None:
        return max(config.block_p, int(config.chunk_nnz))
    if config.device_budget_bytes is None:
        return DEFAULT_CHUNK_SLOTS
    fixed = stream_fixed_bytes(dims, config, statics=statics)
    avail = config.device_budget_bytes - fixed
    slots = avail // (config.stream_ring * bytes_per_slot(len(dims), tables))
    return int(max(config.block_p, slots))


def resident_bytes(tensor, config: ExecutionConfig,
                   rank: int | None = None) -> int:
    """Device footprint of the resident engine (``engine.init``) for
    ``tensor`` in the reference's model: the ``S_max``-padded layout, the
    per-mode schedule tables, the relabel tables, the factors and one mode
    output. ``residency="auto"`` compares it with
    ``device_budget_bytes``."""
    rank = rank or config.rank_hint
    n = tensor.nmodes
    statics = [mode_static_from_plan(p) for p in tensor.plans]
    smax = max(s.padded_nnz for s in statics)
    total = smax * 4 * (1 + 2 * n)            # val + idx + alpha
    tables = _wants_tables(config, statics[0].schedule)
    for s in statics:
        total += s.nblocks * 4                 # bpart descriptor
        if tables:
            total += s.padded_nnz * 8 * (n - 1) + s.nblocks * 4 * (n - 1)
    total += sum(int(d) for d in tensor.dims) * 4          # relabel
    total += sum(int(d) for d in tensor.dims) * rank * 4   # factors
    total += max(int(d) for d in tensor.dims) * rank * 4   # mode output
    return total


# --------------------------------------------------------------------------
# StreamPlan: per-mode chunk schedules.
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class StreamPlan:
    """Partition-aligned chunking of every mode's block schedule.

    ``chunks[d]`` slices mode ``d``'s block schedule into chunks of at
    most ``target_slots`` slots (whole partitions only); ``lstatics[d]``
    is the reference's uniform chunk-local :class:`ModeStatic` of that
    mode (the budget model's chunk shape; the port runs each chunk at its
    real size). ``tables`` records whether chunks carry the in-block
    dedup tables.
    """

    target_slots: int
    chunks: tuple[ChunkSchedule, ...]
    lstatics: tuple[ModeStatic, ...]
    tables: bool

    @property
    def total_chunks(self) -> int:
        return sum(cs.nchunks for cs in self.chunks)

    def mode_h2d_bytes(self, d: int, nmodes: int) -> int:
        """Modeled upload bytes of one pass over mode ``d``'s chunks."""
        cs = self.chunks[d]
        return cs.nchunks * chunk_device_bytes(cs, nmodes, self.tables)


def plan_stream(tensor, config: ExecutionConfig) -> StreamPlan:
    """The chunk schedules of ``tensor`` under ``config``'s budget (see
    :func:`resolve_chunk_slots`)."""
    statics = tuple(mode_static_from_plan(p) for p in tensor.plans)
    tables = _wants_tables(config, statics[0].schedule)
    target = resolve_chunk_slots(config, tensor.dims, tables=tables,
                                 statics=statics)
    chunks = tuple(chunk_schedule(p, target) for p in tensor.plans)
    lstatics = tuple(
        ModeStatic(kappa=cs.chunk_kappa, rows_pp=s.rows_pp,
                   blocks_pp=s.blocks_pp, block_p=s.block_p, dim=s.dim,
                   nblocks=cs.chunk_blocks, schedule=s.schedule)
        for s, cs in zip(statics, chunks))
    return StreamPlan(target_slots=target, chunks=chunks,
                      lstatics=lstatics, tables=tables)


def _stream_plan_key(tensor, config: ExecutionConfig) -> str:
    """Structural key of a :func:`plan_stream` result: the plan geometry
    (per-mode partition/block structure) and every config knob the chunk
    sizing reads."""
    tables = _wants_tables(
        config, mode_static_from_plan(tensor.plans[0]).schedule)
    h = hashlib.sha256()
    h.update(repr((tuple(int(d) for d in tensor.dims), int(tensor.nnz),
                   config.chunk_nnz, config.device_budget_bytes,
                   config.stream_ring, config.block_p, config.rank_hint,
                   tables)).encode())
    for p in tensor.plans:
        h.update(repr((int(p.kappa), int(p.rows_pp), int(p.block_p),
                       int(p.blocks_pp), int(p.nblocks),
                       p.schedule)).encode())
        h.update(np.ascontiguousarray(p.part_nnz).tobytes())
        h.update(np.ascontiguousarray(p.block_part).tobytes())
    return h.hexdigest()


def plan_stream_cached(tensor, config: ExecutionConfig,
                       cache=None) -> StreamPlan:
    """:func:`plan_stream` through the :class:`~repro_torch.core.plancache.
    PlanCache` structural tier: a replan under knobs seen before is a hit.
    ``cache=None`` uses the process default; ``cache=False`` plans
    cold."""
    from repro_torch.core.plancache import DEFAULT_CACHE

    if cache is None:
        cache = DEFAULT_CACHE
    elif cache is False:
        return plan_stream(tensor, config)
    return cache.get_stream_plan(_stream_plan_key(tensor, config),
                                 lambda: plan_stream(tensor, config))


def stream_transfer_model(tensor, config: ExecutionConfig) -> dict:
    """Modeled transfer traffic of one streamed rotation: per-mode chunk
    upload bytes (uniformly padded chunks) and remap-fragment bytes
    (``nnz`` element rows reassembled into the next layout per mode). The
    autotuner's streaming cost term reads this model."""
    plan = plan_stream(tensor, config)
    n = tensor.nmodes
    rb = row_bytes(n)
    per_mode = []
    for d in range(n):
        per_mode.append({
            "mode": d,
            "nchunks": plan.chunks[d].nchunks,
            "chunk_slots": plan.chunks[d].chunk_slots,
            "h2d_bytes": plan.mode_h2d_bytes(d, n),
            "fragment_bytes": tensor.nnz * rb,
        })
    return {
        "target_slots": plan.target_slots,
        "total_chunks": plan.total_chunks,
        "h2d_bytes": sum(m["h2d_bytes"] for m in per_mode),
        "fragment_bytes": sum(m["fragment_bytes"] for m in per_mode),
        "per_mode": per_mode,
    }


# --------------------------------------------------------------------------
# StreamStats.
# --------------------------------------------------------------------------
@dataclasses.dataclass
class StreamStats:
    """Transfer and residency counts, shared across rotations.

    ``host_remap_s`` is the host's time in the remap (perf_counter). When
    ``timeline`` is a list, each upload and each chunk's compute append
    ``(kind, mode, chunk, start, end)`` with CUDA timing events recorded
    on the copy and the compute stream (``kind`` "upload" or "compute");
    nothing reads them back during the rotation.
    """

    h2d_bytes: int = 0            # uploaded chunk bytes (host -> device)
    fragment_bytes: int = 0       # remap fragment bytes reassembled
    chunks_streamed: int = 0
    modes_streamed: int = 0
    uploads: int = 0
    overlapped_uploads: int = 0   # uploads issued ahead of their compute
    upload_retries: int = 0       # transient-failure upload re-attempts
    budget_halvings: int = 0      # chunk-budget ladder rungs taken (OOM)
    backend_steps: int = 0        # backend ladder rungs taken (build)
    peak_ring_bytes: int = 0      # max bytes of chunks in the ring
    peak_ring_chunks: int = 0
    host_remap_s: float = 0.0
    timeline: list | None = None

    @property
    def transfer_bytes(self) -> int:
        return self.h2d_bytes + self.fragment_bytes

    @property
    def overlap_efficiency(self) -> float:
        """Share of uploads issued while earlier chunks were still in
        flight (1.0 = every upload but each mode's first was issued
        ahead)."""
        return self.overlapped_uploads / max(self.uploads, 1)

    def as_row(self) -> dict:
        return {
            "h2d_bytes": self.h2d_bytes,
            "fragment_bytes": self.fragment_bytes,
            "transfer_bytes": self.transfer_bytes,
            "chunks_streamed": self.chunks_streamed,
            "modes_streamed": self.modes_streamed,
            "upload_retries": self.upload_retries,
            "budget_halvings": self.budget_halvings,
            "backend_steps": self.backend_steps,
            "peak_ring_bytes": self.peak_ring_bytes,
            "peak_ring_chunks": self.peak_ring_chunks,
            "overlap_efficiency": self.overlap_efficiency,
            "host_remap_s": self.host_remap_s,
            "device_peak_bytes": device_peak_bytes(),
        }


def _mirror_stats(stats: StreamStats, before: StreamStats) -> None:
    """Mirror one mode pass's :class:`StreamStats` deltas onto the
    ``repro_torch.obs`` metrics registry."""
    counts = _obs_counter("stream_counts",
                          "streamed uploads / chunks / mode passes")
    counts.inc("uploads", stats.uploads - before.uploads)
    counts.inc("overlapped_uploads",
               stats.overlapped_uploads - before.overlapped_uploads)
    counts.inc("upload_retries",
               stats.upload_retries - before.upload_retries)
    counts.inc("chunks", stats.chunks_streamed - before.chunks_streamed)
    counts.inc("modes", 1)
    nbytes = _obs_counter("stream_bytes",
                          "streamed transfer bytes by direction")
    nbytes.inc("h2d", stats.h2d_bytes - before.h2d_bytes)
    nbytes.inc("fragment", stats.fragment_bytes - before.fragment_bytes)
    peaks = _obs_gauge("stream_peaks", "chunk ring high-water marks")
    peaks.max("ring_bytes", stats.peak_ring_bytes)
    peaks.max("ring_chunks", stats.peak_ring_chunks)
    dev_peak = device_peak_bytes()
    if dev_peak is not None:
        peaks.max("device_bytes", dev_peak)


# --------------------------------------------------------------------------
# Host buffers and the device ring.
# --------------------------------------------------------------------------
def _host(shape, dtype, pin: bool) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, pin_memory=pin)


@dataclasses.dataclass(frozen=True)
class _Chunk:
    """Chunk ``c`` of a mode: its partition and block range, its
    chunk-local plan constants and its work table (on the device; ``None``
    for a backend whose kernels take none)."""

    p0: int
    p1: int
    b0: int
    b1: int
    static: ModeStatic
    work: object


class _Ring:
    """``n`` device slots of ``slots`` slots and ``blocks`` blocks each,
    with the copy stream and the events that order them (on the card)."""

    def __init__(self, device, n: int, slots: int, blocks: int, nmodes: int,
                 idx: bool, tables: bool):
        self.device = device
        self.shape = (n, slots, blocks, idx, tables)
        self.cuda = device.type == "cuda"
        nm1 = nmodes - 1

        def alloc():
            i32 = dict(dtype=torch.int32, device=device)
            slot = {"val": torch.empty(slots, dtype=torch.float32,
                                       device=device),
                    "lrow": torch.empty(slots, **i32),
                    "bpart": torch.empty(blocks, **i32)}
            if idx:
                slot["idx"] = torch.empty((slots, nmodes), **i32)
            if tables:
                slot["uidx"] = torch.empty(slots * nm1, **i32)
                slot["upos"] = torch.empty((slots, nm1), **i32)
                slot["nuniq"] = torch.empty(blocks * nm1, **i32)
            return slot

        self.slots = [alloc() for _ in range(n)]
        self.free = [None] * n          # compute done with the slot
        self.ready = [None] * n         # the slot's upload landed
        self.copy = torch.cuda.Stream(device) if self.cuda else None
        if self.cuda:
            # written on the copy stream: the allocator must wait for it
            # before it hands the memory out again
            for slot in self.slots:
                for t in slot.values():
                    t.record_stream(self.copy)

    def holds(self, n: int, slots: int, blocks: int, idx: bool,
              tables: bool) -> bool:
        """Whether this ring can serve a ring of ``n`` slots of ``slots``
        slots and ``blocks`` blocks with these fields (a replan keeps
        it then)."""
        n0, slots0, blocks0, idx0, tables0 = self.shape
        return ((n0, idx0, tables0) == (n, idx, tables)
                and slots0 >= slots and blocks0 >= blocks)


def _chunk_span(cs: ChunkSchedule, c: int) -> int:
    """First slot of chunk ``c``, where its upload reads the host
    layout."""
    return int(cs.block_start[c]) * cs.block_p


def _host_chunk(state: "StreamState", d: int, c: int) -> dict:
    """Chunk ``c`` of mode ``d`` as slices of the pinned host buffers: its
    slots of the layout (from :func:`_chunk_span`), and its blocks of the
    mode's descriptor and dedup tables."""
    nm1 = state.nmodes - 1
    ch = state.chunks[d][c]
    b0, nb = ch.b0, ch.b1 - ch.b0
    p = ch.static.block_p
    m, s0 = nb * p, _chunk_span(state.plan.chunks[d], c)
    lay = state.layouts[state.cur]
    host = {"val": lay["val"][s0:s0 + m], "lrow": lay["lrow"][s0:s0 + m],
            "bpart": state.lbpart[d][b0:b0 + nb]}
    if "idx" in state.ring.slots[0]:
        host["idx"] = lay["idx"][s0:s0 + m]
    tab = state.tables[d]
    if tab is not None:
        host["uidx"] = tab["uidx"][b0 * p * nm1:(b0 + nb) * p * nm1]
        host["upos"] = tab["upos"][b0 * p:(b0 + nb) * p]
        host["nuniq"] = tab["nuniq"][b0 * nm1:(b0 + nb) * nm1]
    return host


def _upload(state: "StreamState", d: int, c: int, policy=None) -> int:
    """Issue chunk ``c``'s upload (:func:`_issue_upload`), with bounded
    retry and seeded backoff on *transient* failures when a ladder
    ``policy`` is active (the reference's ``_upload``). Other failures
    (OOM, build) go up to the mode's ladder."""
    attempt = 0
    while True:
        try:
            cz = _chaos.active()
            if cz is not None:
                cz.on_upload(d, c, attempt)
            return _issue_upload(state, d, c)
        except Exception as exc:
            if (policy is None or classify(exc) != "transient"
                    or attempt >= policy.max_retries):
                raise
            state.stats.upload_retries += 1
            record_retry("stream.upload", attempt,
                         backoff_delay(policy, attempt,
                                       token=("upload", d, c)),
                         mode=d, chunk=c)
            attempt += 1


def _issue_upload(state: "StreamState", d: int, c: int) -> int:
    """Issue chunk ``c``'s upload into ring slot ``c % ring``; returns its
    bytes. On the card it runs on the copy stream, after the compute
    stream has freed the slot, and records the slot's ``ready`` event."""
    ring, stats = state.ring, state.stats
    i = c % len(ring.slots)
    host = _host_chunk(state, d, c)
    slot = ring.slots[i]
    timeline = stats.timeline if ring.cuda else None
    if ring.cuda:
        stream = ring.copy
        if ring.free[i] is not None:
            stream.wait_event(ring.free[i])
        with torch.cuda.stream(stream):
            if timeline is not None:
                ev0 = torch.cuda.Event(enable_timing=True)
                ev0.record(stream)
            for key, src in host.items():
                slot[key][:len(src)].copy_(src, non_blocking=True)
            ring.ready[i] = torch.cuda.Event(
                enable_timing=timeline is not None)
            ring.ready[i].record(stream)
        if timeline is not None:
            timeline.append(("upload", d, c, ev0, ring.ready[i]))
    else:
        for key, src in host.items():
            slot[key][:len(src)].copy_(src)
    return sum(src.numel() * src.element_size() for src in host.values())


def _chunk_layout(state: "StreamState", d: int, c: int) -> dict:
    """The backend ``layout`` of chunk ``c`` (mode ``d``): views of its
    ring slot at the chunk's real size, and its work table. On the card
    the compute stream first waits for the slot's upload."""
    ring = state.ring
    i = c % len(ring.slots)
    if ring.cuda:
        torch.cuda.current_stream(ring.device).wait_event(ring.ready[i])
    ch = state.chunks[d][c]
    m, nb = ch.static.padded_nnz, ch.b1 - ch.b0
    nm1 = state.nmodes - 1
    slot = ring.slots[i]
    lay = {"val": slot["val"][:m], "lrow": slot["lrow"][:m],
           "bpart": slot["bpart"][:nb]}
    if "idx" in slot:
        lay["idx"] = slot["idx"][:m]
    if "uidx" in slot:
        lay["uidx"] = slot["uidx"][:m * nm1].view(nm1, m)
        lay["upos"] = slot["upos"][:m]
        lay["nuniq"] = slot["nuniq"][:nb * nm1].view(nm1, nb)
    if ch.work is not None:
        lay["work"], lay["wsum"] = ch.work.chunks, ch.work.wsum
    return lay


# --------------------------------------------------------------------------
# StreamState and stream_init.
# --------------------------------------------------------------------------
@dataclasses.dataclass
class StreamState:
    """Host-resident engine state for the streaming tier.

    ``layouts`` are the two pinned host layouts (``val (S_max,)``, ``idx
    / alpha (S_max, N)``, ``lrow (S_max,)`` torch tensors); ``cur`` names
    the one holding the resident ``mode``'s layout in its first ``S_d``
    slots (``val``/``idx``/``alpha``/``lrow`` give numpy views of
    those). ``tables[d]`` are mode ``d``'s pinned dedup tables laid out
    chunk by chunk (``None`` when the backend reads none), ``lbpart[d]``
    its chunk-local block descriptor, ``chunks[d]`` its :class:`_Chunk`
    list, ``pads[d]`` the pad slots of its layout. The relabel tables,
    the ring and the factors live on the device. ``tensor`` is the host
    :class:`~repro_torch.core.flycoo.FlycooTensor`.
    """

    tensor: object
    plan: StreamPlan
    statics: tuple[ModeStatic, ...]
    layouts: tuple[dict, dict]
    cur: int
    tables: tuple
    lbpart: tuple
    chunks: tuple
    pads: tuple
    relabel: tuple
    ring: _Ring
    read_by: list                 # per layout: event after its uploads
    mode: int
    dims: tuple[int, ...]
    config: ExecutionConfig
    stats: StreamStats

    @property
    def nmodes(self) -> int:
        return len(self.dims)

    def _view(self, key):
        return self.layouts[self.cur][key].numpy()[
            :self.statics[self.mode].padded_nnz]

    @property
    def val(self) -> np.ndarray:
        return self._view("val")

    @property
    def idx(self) -> np.ndarray:
        return self._view("idx")

    @property
    def alpha(self) -> np.ndarray:
        return self._view("alpha")

    @property
    def lrow(self) -> np.ndarray:
        return self._view("lrow")

    def replace(self, **kw) -> "StreamState":
        return dataclasses.replace(self, **kw)


def _host_lrow(plan, idx: np.ndarray, alpha: np.ndarray,
               d: int) -> np.ndarray:
    """Host-side ``compute_lrow``: the relabeled row mod ``rows_pp`` for
    alive slots, -1 for pads."""
    alive = alpha[:, d] >= 0
    rel = plan.row_relabel[idx[:, d]]
    return np.where(alive, (rel % plan.rows_pp).astype(np.int32),
                    np.int32(-1))


def _chunk_plan(plan, cs: ChunkSchedule, c: int, slots):
    """Chunk ``c`` of ``plan`` as a plan of its own (partitions and blocks
    rebased to its first; under rect, its alive slots from the sorted
    ``slots``), for :func:`.api.mode_work`."""
    p0, p1, b0, b1 = cs.bounds(c)
    local = None
    if slots is not None:
        lo, hi = np.searchsorted(slots, [b0 * cs.block_p, b1 * cs.block_p])
        local = slots[lo:hi] - b0 * cs.block_p
    return dataclasses.replace(
        plan, kappa=p1 - p0, nblocks=b1 - b0,
        block_part=(plan.block_part[b0:b1] - p0).astype(np.int32),
        part_nnz=plan.part_nnz[p0:p1], slot_of_elem=local)


def _mode_chunks(plan, cs: ChunkSchedule, takes_work: bool, dev) -> tuple:
    """Mode ``plan``'s :class:`_Chunk` list: each chunk's local plan
    constants and, for backends whose kernels take one, its work table at
    the resident mode's cap, sealed and moved to ``dev``."""
    cap = mode_cap(plan)
    slots = (np.sort(plan.slot_of_elem)
             if takes_work and plan.schedule == "rect" else None)
    out = []
    for c in range(cs.nchunks):
        p0, p1, b0, b1 = cs.bounds(c)
        cp = _chunk_plan(plan, cs, c, slots)
        work = mode_work(cp, cap).to(dev) if takes_work else None
        out.append(_Chunk(p0, p1, b0, b1, mode_static_from_plan(cp), work))
    return tuple(out)


def _pinned_tables(tensor, d: int, cs: ChunkSchedule, config, pin: bool):
    """Mode ``d``'s dedup tables in pinned memory, chunk by chunk: chunk
    ``c``'s ``uidx (N-1, m)`` at flat offset ``s0*(N-1)``, its ``nuniq
    (N-1, nb)`` at ``b0*(N-1)``; ``upos`` as it is (rows are
    contiguous)."""
    uidx, upos, nuniq = (tensor.dedup_tables(d) if config.dedup
                         else tensor.trivial_dedup_tables(d))
    nm1 = uidx.shape[0]
    tab = {"uidx": _host(uidx.size, torch.int32, pin),
           "upos": _host(upos.shape, torch.int32, pin),
           "nuniq": _host(nuniq.size, torch.int32, pin)}
    fu, fn = tab["uidx"].numpy(), tab["nuniq"].numpy()
    tab["upos"].numpy()[:] = upos
    p = cs.block_p
    for c in range(cs.nchunks):
        _, _, b0, b1 = cs.bounds(c)
        fu[b0 * p * nm1:b1 * p * nm1].reshape(nm1, -1)[:] = \
            uidx[:, b0 * p:b1 * p]
        fn[b0 * nm1:b1 * nm1].reshape(nm1, -1)[:] = nuniq[:, b0:b1]
    return tab


def _local_bpart(plan, cs: ChunkSchedule, pin: bool) -> torch.Tensor:
    """``block_part`` rebased to each block's chunk's first partition."""
    out = _host(plan.nblocks, torch.int32, pin)
    nb = np.diff(cs.block_start)
    out.numpy()[:] = plan.block_part - np.repeat(cs.part_start[:-1], nb)
    return out


def stream_init(tensor, config: ExecutionConfig | None = None,
                start_mode: int = 0, *, cache=None) -> StreamState:
    """Build the streaming state for ``tensor``: the same input contract
    as ``engine.init`` (a prebuilt FlycooTensor or a COO triple, through
    ``cache``), the start mode's layout in pinned host memory, each
    mode's pinned dedup tables and device work tables, and the device
    ring (``config.stream_ring`` slots at the largest chunk's size)."""
    config = config or ExecutionConfig()
    dev = config.torch_device
    pin = dev.type == "cuda"
    with span("stream.init", start_mode=start_mode) as sp:
        tensor = as_flycoo(tensor, config, cache=cache)
        n = tensor.nmodes
        if not 0 <= start_mode < n:
            raise ValueError(
                f"start_mode {start_mode} out of range for {n} modes")
        statics = tuple(mode_static_from_plan(p) for p in tensor.plans)
        plan = plan_stream_cached(tensor, config, cache=cache)
        sp.set("total_chunks", plan.total_chunks)
        sp.set("target_slots", plan.target_slots)

        smax = max(s.padded_nnz for s in statics)
        layouts = tuple({"val": _host(smax, torch.float32, pin),
                         "idx": _host((smax, n), torch.int32, pin),
                         "alpha": _host((smax, n), torch.int32, pin),
                         "lrow": _host(smax, torch.int32, pin)}
                        for _ in range(2))
        base = tensor.plans[start_mode]
        s = base.padded_nnz
        val, idx, alpha, lrow = (layouts[0][k].numpy()[:s]
                                 for k in ("val", "idx", "alpha", "lrow"))
        val[:] = 0
        idx[:] = 0
        alpha[:] = -1
        val[base.slot_of_elem] = tensor.values
        idx[base.slot_of_elem] = tensor.indices
        for d in range(n):
            alpha[base.slot_of_elem, d] = \
                tensor.plans[d].slot_of_elem.astype(np.int32)
        lrow[:] = _host_lrow(base, idx, alpha, start_mode)

        pads = []
        for p in tensor.plans:
            dead = np.ones(p.padded_nnz, dtype=bool)
            dead[p.slot_of_elem] = False
            pads.append(np.flatnonzero(dead))
        return StreamState(
            tensor=tensor, statics=statics, layouts=layouts, cur=0,
            pads=tuple(pads),
            relabel=tuple(torch.from_numpy(p.row_relabel).to(dev)
                          for p in tensor.plans),
            read_by=[None, None], mode=int(start_mode), dims=tensor.dims,
            config=config, stats=StreamStats(),
            **_plan_parts(tensor, plan, config))


def _plan_parts(tensor, plan: StreamPlan, config: ExecutionConfig,
                ring: _Ring | None = None) -> dict:
    """The :class:`StreamState` fields that follow the chunk plan and the
    backend: ``plan``, each mode's pinned dedup tables (when the backend
    reads them), chunk-local block descriptor and :class:`_Chunk` list
    (work tables at the resident mode's cap, when its kernels take one),
    and the ring. A replan passes its old ``ring``, which is kept when
    its slots carry the same fields and hold the new largest chunk."""
    dev = config.torch_device
    pin = dev.type == "cuda"
    n = tensor.nmodes
    takes_work = getattr(get_backend(config), "takes_work", False)
    shape = (config.stream_ring, max(cs.chunk_slots for cs in plan.chunks),
             max(cs.chunk_blocks for cs in plan.chunks), not plan.tables,
             plan.tables)
    if ring is None or not ring.holds(*shape):
        ring = _Ring(dev, *shape[:3], n, idx=shape[3], tables=shape[4])
    return {
        "plan": plan,
        "tables": tuple(
            _pinned_tables(tensor, d, plan.chunks[d], config, pin)
            if plan.tables else None for d in range(n)),
        "lbpart": tuple(_local_bpart(p, cs, pin)
                        for p, cs in zip(tensor.plans, plan.chunks)),
        "chunks": tuple(_mode_chunks(p, cs, takes_work, dev)
                        for p, cs in zip(tensor.plans, plan.chunks)),
        "ring": ring}


def _with_config(state: StreamState,
                 config: ExecutionConfig) -> StreamState:
    """``state`` replanned under a degraded ``config`` (the reference's
    ``_with_config``), through the plan cache's stream tier. Safe in the
    middle of a rotation: a failed mode attempt wrote only the next
    layout's buffer, which the retry rewrites whole. On the card the copy
    stream is drained first, so that no pinned table a pending copy reads
    is dropped under it; a kept ring's slots are written again only after
    their "free" events, as always."""
    with span("stream.replan", mode=state.mode, backend=config.backend,
              chunk_nnz=config.chunk_nnz):
        if state.ring.cuda:
            state.ring.copy.synchronize()
        plan = plan_stream_cached(state.tensor, config)
        return state.replace(config=config, **_plan_parts(
            state.tensor, plan, config, ring=state.ring))


# --------------------------------------------------------------------------
# stream_mttkrp: one mode through the ring, the remap on the host.
# --------------------------------------------------------------------------
def stream_mttkrp(state: StreamState, factors: Sequence[torch.Tensor],
                  mode: int | None = None, *, policy=None):
    """MTTKRP for the resident mode, streamed chunk by chunk; returns
    ``(out, next_state)`` with ``out (dims[mode], R)`` (on the CPU bitwise
    the resident ``engine.mttkrp``'s). The next mode's host layout (the
    Alg. 3 remap) is reassembled chunk by chunk while the device
    computes.

    With a ``policy`` (:class:`~repro_torch.resilience.LadderPolicy`) the
    mode rides the degradation ladder, as in the reference: an OOM halves
    the chunk budget and replans (at most ``max_budget_halvings`` times;
    chunks are whole partitions and their work tables are built at the
    resident mode's cap, so any chunking sums each row as the resident
    engine does); a kernel build failure steps the backend down the
    ladder (``CARD_LADDER`` on the card, ``BACKEND_LADDER`` on the CPU)
    and replans. A sticky CUDA error is ``"fatal"`` and raises. The
    degraded config rides the returned state, so later modes inherit
    it. Every transition is a ``resilience_degradations`` counter label
    and a span.
    """
    halvings = steps = 0
    while True:
        try:
            return _stream_mode_once(state, factors, mode, policy)
        except Exception as exc:
            if policy is None:
                raise
            kind = classify(exc)
            if kind == "oom" and halvings < policy.max_budget_halvings:
                cur = state.plan.target_slots
                new = max(state.config.block_p, cur // 2)
                if new >= cur:
                    raise
                halvings += 1
                state.stats.budget_halvings += 1
                record_degradation("oom", cur, new,
                                   site="stream.chunk_budget",
                                   mode=state.mode)
                state = _with_config(
                    state, dataclasses.replace(state.config, chunk_nnz=new))
                continue
            if kind == "compile" and steps < policy.max_backend_steps:
                nb = next_backend(state.config.backend,
                                  state.config.torch_device)
                if nb is None:
                    raise
                steps += 1
                state.stats.backend_steps += 1
                record_degradation("compile", state.config.backend, nb,
                                   site="stream.backend", mode=state.mode)
                state = _with_config(
                    state, dataclasses.replace(state.config, backend=nb))
                continue
            raise


def _stream_mode_once(state: StreamState, factors, mode: int | None,
                      policy):
    if mode is not None and mode != state.mode:
        raise ValueError(
            f"state holds the mode-{state.mode} layout; cannot compute "
            f"mode {mode} without rotating (use stream_all_modes)")
    d = state.mode
    n = state.nmodes
    nxt = (d + 1) % n
    cs = state.plan.chunks[d]
    chunks = state.chunks[d]
    st = state.statics[d]
    rows_pp = st.rows_pp
    config, stats, ring = state.config, state.stats, state.ring
    backend = get_backend(config)
    factors = tuple(factors)
    rank = factors[0].shape[1]
    compute = (torch.cuda.current_stream(ring.device) if ring.cuda
               else None)
    timeline = stats.timeline if ring.cuda else None
    cz = _chaos.active()
    if cz is not None:
        cz.on_dispatch(config.backend)

    # The next layout's buffer fed the uploads of the mode before: wait
    # for them (the one host wait of the mode), then lay its pads.
    nbuf = 1 - state.cur
    if state.read_by[nbuf] is not None:
        state.read_by[nbuf].synchronize()
    snxt = state.statics[nxt].padded_nnz
    nl = {k: v.numpy()[:snxt] for k, v in state.layouts[nbuf].items()}
    pads = state.pads[nxt]
    nl["val"][pads] = 0
    nl["idx"][pads] = 0
    nl["alpha"][pads] = -1
    nl["lrow"][pads] = -1
    nplan = state.tensor.plans[nxt]
    rel_nxt, rows_nxt = nplan.row_relabel, nplan.rows_pp
    cur = {k: v.numpy() for k, v in state.layouts[state.cur].items()}

    acc = torch.empty((st.relabeled_rows, rank), dtype=config.accum_dtype(),
                      device=config.torch_device)
    before = dataclasses.replace(stats, timeline=None)
    in_ring: dict[int, int] = {}          # chunk -> bytes uploaded
    with span("stream.mode", mode=d, nchunks=cs.nchunks):
        for c in range(cs.nchunks):
            # keep chunks [c, c + ring) uploaded or uploading: chunk
            # c+1's copy overlaps chunk c's kernel
            for k in range(c, min(c + len(ring.slots), cs.nchunks)):
                if k not in in_ring:
                    with span("stream.upload", chunk=k, prefetch=k > c):
                        in_ring[k] = _upload(state, d, k, policy)
                    stats.h2d_bytes += in_ring[k]
                    stats.uploads += 1
                    if k > c:
                        stats.overlapped_uploads += 1
            stats.peak_ring_chunks = max(stats.peak_ring_chunks,
                                         len(in_ring))
            stats.peak_ring_bytes = max(stats.peak_ring_bytes,
                                        sum(in_ring.values()))
            ch = chunks[c]
            if cz is not None:
                cz.on_chunk_compute(d, c)
            with span("stream.compute", chunk=c):
                layout = _chunk_layout(state, d, c)
                if timeline is not None:
                    ev0 = torch.cuda.Event(enable_timing=True)
                    ev0.record(compute)
                out_rel = backend(layout, factors, d, plan=ch.static,
                                  config=config)
                acc[ch.p0 * rows_pp:ch.p1 * rows_pp].copy_(out_rel)
                del layout, out_rel
                i = c % len(ring.slots)
                if ring.cuda:
                    ring.free[i] = torch.cuda.Event(
                        enable_timing=timeline is not None)
                    ring.free[i].record(compute)
                    if timeline is not None:
                        timeline.append(("compute", d, c, ev0,
                                         ring.free[i]))
            del in_ring[c]

            # the remap of chunk c's alive elements, on the host while
            # the device computes
            t0 = time.perf_counter()
            with span("stream.remap", chunk=c):
                sl = slice(ch.b0 * st.block_p, ch.b1 * st.block_p)
                av = cur["alpha"][sl]
                alive = av[:, d] >= 0
                dst = av[alive, nxt]
                ix = cur["idx"][sl][alive]
                nl["val"][dst] = cur["val"][sl][alive]
                nl["idx"][dst] = ix
                nl["alpha"][dst] = av[alive]
                nl["lrow"][dst] = (rel_nxt[ix[:, nxt]]
                                   % rows_nxt).astype(np.int32)
            stats.host_remap_s += time.perf_counter() - t0
            stats.fragment_bytes += int(alive.sum()) * row_bytes(n)
            stats.chunks_streamed += 1

        if ring.cuda:
            ev = torch.cuda.Event()
            ev.record(ring.copy)
            state.read_by[state.cur] = ev
        out = acc.index_select(0, state.relabel[d])
    stats.modes_streamed += 1
    _mirror_stats(stats, before)
    return out, state.replace(cur=nbuf, mode=nxt)


def stream_all_modes(state: StreamState, factors: Sequence[torch.Tensor],
                     *, fold=None, carry=None, policy=None):
    """spMTTKRP along all N modes, streamed, from the resident mode.

    Same contract as ``engine.all_modes``: outputs indexed by mode;
    without ``fold`` returns ``(outs, next_state)``, with ``fold``
    ``(outs, next_state, factors, carry)``, the hook running right after
    each mode's output (Gauss-Seidel ALS order)."""
    n = state.nmodes
    factors = tuple(factors)
    outs: list = [None] * n
    for _ in range(n):
        d = state.mode
        out, state = stream_mttkrp(state, factors, policy=policy)
        if fold is not None:
            factors, carry = fold(d, out, factors, carry)
        outs[d] = out
    if fold is None:
        return outs, state
    return outs, state, list(factors), carry


# --------------------------------------------------------------------------
# cp_als_stream: out-of-core CPD-ALS.
# --------------------------------------------------------------------------
def cp_als_stream(tensor, rank: int, iters: int = 10,
                  generator: torch.Generator | None = None,
                  config: ExecutionConfig | None = None,
                  track_fit: bool = True, *, factors=None, cache=None,
                  start_mode: int = 0, ladder=None, checkpoint=None,
                  checkpoint_every: int = 1, resume: bool = False):
    """CPD-ALS on the streamed engine: the sweep of ``core.cpd.cp_als``
    (Gauss-Seidel fold after each mode, fit from the sparse-CPD identity)
    for tensors whose layout does not fit the device. Initial factors are
    ``factors`` when given, else drawn from ``generator``, as in
    ``cp_als``.

    Resilience, as in the reference's ``cp_als_stream``: ``ladder``
    enables the stream's rungs (backend steps, chunk-budget halving on
    OOM, upload retries) and the per-sweep NaN guard with rollback and a
    replay under the stronger ridge, which raises if the burst persists
    (the reference's stream goes on; here both entry points run one loop,
    ``core.cpd.als_sweeps``); ``checkpoint`` /
    ``checkpoint_every`` / ``resume`` snapshot and restore ``(factors,
    lam, fits)`` under the problem fingerprint (which also covers
    ``start_mode``), bitwise the uninterrupted run on the CPU."""
    from repro_torch.core.cpd import _full_fp32, _initial, als_sweeps, \
        init_key

    config = config or ExecutionConfig()
    policy = resolve_policy(ladder)
    store = as_store(checkpoint)
    _full_fp32()
    state = stream_init(tensor, config, start_mode, cache=cache)
    key = init_key(factors, generator) if store is not None else None
    fp = None if store is None else fingerprint(
        state.tensor.indices, state.tensor.values, state.dims, rank,
        config=config, key=key, start_mode=start_mode, extra="stream")
    return als_sweeps(
        functools.partial(stream_all_modes, policy=policy), state,
        _initial(factors, generator, state.dims, rank, config.torch_device),
        state.tensor.values, iters, track_fit=track_fit, policy=policy,
        store=store, fp=fp, checkpoint_every=checkpoint_every,
        resume=resume, tier="streamed")


__all__ = ["StreamPlan", "StreamState", "StreamStats", "plan_stream",
           "plan_stream_cached", "stream_init", "stream_mttkrp",
           "stream_all_modes", "cp_als_stream", "resident_bytes",
           "resolve_chunk_slots", "stream_transfer_model",
           "stream_fixed_bytes", "bytes_per_slot", "chunk_device_bytes",
           "row_bytes", "DEFAULT_CHUNK_SLOTS"]
