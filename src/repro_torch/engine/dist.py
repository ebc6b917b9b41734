"""Distributed spMTTKRP: a sharded ``EngineState`` over a mesh of shards
(the port of ``repro.engine.dist``).

The paper's Observation 2 at cluster scope: partitions, and so the
output rows they own, are dealt to the shards of the mesh's ``data``
axis, so the elementwise computation needs no cross-shard reduction;
each shard sums into rows it owns alone. The rank may also shard over a
``model`` axis. The dynamic remap (Alg. 3) becomes a static cross-shard
permutation, known from the FLYCOO plans, so it is precomputed on the
host into an :class:`ExchangeSchedule` and run round-robin: hop ``h``
copies a bounded buffer from every shard ``k`` into shard ``(k + h) %
n_dev``. The baseline gathers every shard's whole element list
(``DistConfig(exchange="all_gather")``).

Single controller, as the reference: one process drives every shard, as
``shard_map`` over a ``jax.sharding.Mesh`` does, and each shard's
tensors live on its device of the port's
:class:`~repro_torch.launch.mesh.Mesh`. A hop between cards is a peer
copy; between shards on one card, a device-to-device copy between
distinct buffers (each shard has its own receive buffers). The pack, the
scatters and the copies are plain PyTorch ops, as the reference's are
``jnp`` ops outside any Pallas kernel; each shard's elementwise
computation is the backend's plain-gather entry (``cuda_fused``:
``mttkrp_fused_gather_compact`` / ``mttkrp_fused_gather``; ``cuda``: the
pre-gathered pair) on a work table of its own, built once by
:func:`shard_state`. The reference's rotation is one jitted ``lax.scan``;
here, as in ``engine.all_modes``, it is a Python loop over modes and
shards, with no host sync inside: every buffer size comes from the
schedule.

Sharded layout numbering
------------------------
Device-major, as in the reference: shard ``k`` owns global slots ``[k *
S_loc, (k+1) * S_loc)`` with ``S_loc = max_d S_d_loc``, and within a
shard the mode-``d`` layout takes the first ``S_d_loc`` local slots, its
``kappa_d / n_dev`` partitions' blocks in the mode's block schedule.
Under ``rect`` ``S_d_loc = S_d / n_dev``; under ``compact`` it is the
largest shard's block count, and shorter shards carry trailing pad
blocks that repeat their last partition's id. A shard's work table lists
only its real blocks. Every mode's ``kappa`` must be a multiple of
``n_dev`` (:meth:`ExecutionConfig.kappa_for` with ``n_dev``,
:func:`repro_torch.core.distributed.build_sharded_flycoo`).

Public surface:

  DistConfig                            frozen mesh-axis/exchange policy
  shard_state(state, mesh[, dist])      EngineState -> DistState (host, once)
  dist_mttkrp(dstate, factors)          one mode + exchange
  dist_all_modes(dstate, factors)       a whole rotation, fold hook as in
                                        ``engine.all_modes``
  schedule_for_plans / exchange_bytes   host-side schedule + traffic model
  surviving_mesh                        the mesh after a device loss

Observability: spans ``dist.shard_state``, ``dist.renumber``,
``dist.exchange_schedule``, ``dist.device_place`` and ``engine.dispatch``
(``kind="dist_mttkrp"`` / ``"dist_all_modes"``); gauge
``dist_exchange_bytes`` (the schedule's permute bytes a shard sends per
transition); counter ``dist_copied_bytes`` (``"<exchange>:mode<d>"``,
the bytes each transition actually copied between shards, summed over
the shards: ``n_dev`` times ``exchange_bytes``).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple, Sequence

import numpy as np
import torch

from repro_torch.launch.mesh import Mesh
from repro_torch.obs.metrics import counter as _obs_counter
from repro_torch.obs.metrics import gauge as _obs_gauge
from repro_torch.obs.trace import span
from repro_torch.resilience import chaos as _chaos

from .api import (DISPATCH_COUNTS, FoldFn, layout_work, mode_sched_arrays,
                  place_sched)
from .backends import compute_lrow, get_backend
from .config import ExecutionConfig
from .state import EngineState, ModeSched, ModeStatic

EXCHANGES = ("permute", "all_gather")


@dataclasses.dataclass(frozen=True)
class DistConfig:
    """Static distribution policy (the reference's fields and checks).

    Attributes:
      data_axis: mesh axis partitions/rows/slots shard over.
      model_axis: optional mesh axis the factor rank shards over
        (incompatible with a ``fold`` hook: grams need the full rank).
      exchange: remap exchange, ``"permute"`` (the schedule's hops) or
        ``"all_gather"`` (the baseline: every shard's element list).
      pad_hop: per-hop buffer slot counts round up to this multiple.
    """

    data_axis: str = "data"
    model_axis: str | None = None
    exchange: str = "permute"
    pad_hop: int = 8

    def __post_init__(self):
        if self.exchange not in EXCHANGES:
            raise ValueError(
                f"exchange {self.exchange!r} not in {EXCHANGES}")
        if self.pad_hop < 1:
            raise ValueError("pad_hop must be >= 1")


# --------------------------------------------------------------------------
# Static exchange schedule (host-side, derived from the FLYCOO plans).
# --------------------------------------------------------------------------
class ExchangeSchedule(NamedTuple):
    """Per (mode -> next mode) transition, per round-robin hop, the padded
    slot capacity of the send buffer: ``hops[d][h-1]`` bounds how many
    elements any shard sends to its ``+h`` neighbour while remapping the
    mode-``d`` layout into mode ``d+1``."""

    n_dev: int
    hops: tuple[tuple[int, ...], ...]

    def permute_slots(self, d: int) -> int:
        """Total send-buffer slots one shard uses for transition ``d``."""
        return sum(self.hops[d])


def row_bytes(nmodes: int) -> int:
    """Bytes per element row: val f32 + idx i32*N + alpha i32*N."""
    return 4 * (1 + 2 * nmodes)


def _schedule_from_devs(devs_by_mode: Sequence[np.ndarray], n_dev: int,
                        pad_hop: int) -> ExchangeSchedule:
    """Build the schedule from each element's owning shard in every mode."""
    n = len(devs_by_mode)
    hops = []
    for d in range(n):
        src, dst = devs_by_mode[d], devs_by_mode[(d + 1) % n]
        counts = np.bincount(src * n_dev + dst,
                             minlength=n_dev * n_dev).reshape(n_dev, n_dev)
        per_hop = []
        for h in range(1, n_dev):
            cap = int(max(counts[k, (k + h) % n_dev] for k in range(n_dev)))
            if cap:
                cap = ((cap + pad_hop - 1) // pad_hop) * pad_hop
            per_hop.append(cap)
        hops.append(tuple(per_hop))
    return ExchangeSchedule(n_dev=n_dev, hops=tuple(hops))


def element_devices(plan, n_dev: int) -> np.ndarray:
    """(nnz,) owning shard per element of a ``ModePlan`` sharded over
    ``n_dev`` shards: shard ``k`` owns partitions ``[k*kappa/n_dev,
    (k+1)*kappa/n_dev)``."""
    if plan.kappa % n_dev != 0:
        raise ValueError(
            f"mode-{plan.mode} kappa {plan.kappa} not divisible by "
            f"n_dev {n_dev}; build with kappa_for / build_sharded_flycoo")
    part = plan.block_part[plan.slot_of_elem // plan.block_p]
    return (part // (plan.kappa // n_dev)).astype(np.int64)


def schedule_for_plans(plans, n_dev: int,
                       pad_hop: int = 8) -> ExchangeSchedule:
    """Exchange schedule for a tensor's ``ModePlan`` list (host only)."""
    return _schedule_from_devs([element_devices(p, n_dev) for p in plans],
                               n_dev, pad_hop)


# --------------------------------------------------------------------------
# Device-major block geometry (host-side, schedule-aware).
# --------------------------------------------------------------------------
def _block_geometry(static: ModeStatic, bpart: np.ndarray, n_dev: int):
    """``(kappa_loc, blocks_per_dev, dev_first_block, nblocks_loc)`` of
    one mode: shard ``k`` owns partitions ``[k*kappa_loc,
    (k+1)*kappa_loc)``, whose blocks start at global block
    ``dev_first_block[k]``; every shard's layout is padded to
    ``nblocks_loc = max blocks_per_dev`` blocks."""
    kappa_loc = static.kappa // n_dev
    part_blocks = np.bincount(bpart, minlength=static.kappa)
    blocks_per_dev = part_blocks.reshape(n_dev, kappa_loc).sum(axis=1)
    dev_first_block = np.concatenate([[0], np.cumsum(blocks_per_dev)])[:-1]
    return kappa_loc, blocks_per_dev, dev_first_block, int(
        blocks_per_dev.max())


def _local_static(static: ModeStatic, nblocks_loc: int,
                  n_dev: int) -> ModeStatic:
    """The per-shard ``ModeStatic`` (kappa_loc partitions, the padded
    local block count)."""
    return ModeStatic(kappa=static.kappa // n_dev, rows_pp=static.rows_pp,
                      blocks_pp=static.blocks_pp, block_p=static.block_p,
                      dim=static.dim, nblocks=nblocks_loc,
                      schedule=static.schedule)


def _local_sched(ms, static: ModeStatic, geom, n_dev: int) -> dict:
    """Device-major re-layout of one mode's schedule tables (``ms`` has
    numpy ``bpart``/``uidx``/``upos``/``nuniq``): each shard's block run
    sliced out and padded to the uniform local block count. Pad blocks
    repeat the last real partition id and carry zeroed dedup tables
    (``nuniq = 0``). Returns the global arrays (``None`` where absent),
    the reference's ``_local_sched`` bit for bit."""
    kappa_loc, blocks_per_dev, dev_first_block, nblocks_loc = geom
    p = static.block_p
    sloc = nblocks_loc * p
    bp = np.asarray(ms.bpart)
    lbp = np.empty((n_dev, nblocks_loc), dtype=np.int32)
    for k in range(n_dev):
        nb = int(blocks_per_dev[k])
        seg = bp[dev_first_block[k]:dev_first_block[k] + nb] - k * kappa_loc
        lbp[k, :nb] = seg
        lbp[k, nb:] = seg[-1] if nb else kappa_loc - 1
    out = {"bpart": lbp.reshape(-1), "uidx": None, "upos": None,
           "nuniq": None}
    if ms.uidx is not None:
        uidx = np.asarray(ms.uidx)
        upos = np.asarray(ms.upos)
        nuniq = np.asarray(ms.nuniq)
        nm1 = uidx.shape[0]
        luidx = np.zeros((nm1, n_dev * sloc), dtype=np.int32)
        lupos = np.zeros((n_dev * sloc, nm1), dtype=np.int32)
        lnuniq = np.zeros((nm1, n_dev * nblocks_loc), dtype=np.int32)
        for k in range(n_dev):
            nb = int(blocks_per_dev[k])
            g0 = int(dev_first_block[k])
            luidx[:, k * sloc:k * sloc + nb * p] = \
                uidx[:, g0 * p:(g0 + nb) * p]
            lupos[k * sloc:k * sloc + nb * p] = upos[g0 * p:(g0 + nb) * p]
            lnuniq[:, k * nblocks_loc:k * nblocks_loc + nb] = \
                nuniq[:, g0:g0 + nb]
        out.update(uidx=luidx, upos=lupos, nuniq=lnuniq)
    return out


def exchange_bytes(schedule: ExchangeSchedule, nmodes: int,
                   slocs: Sequence[int]) -> list[dict]:
    """Per-shard traffic of one full rotation, per mode transition: the
    permute schedule against the all_gather baseline, which ships each
    remote shard's mode-``d`` element list, ``(n_dev - 1) * slocs[d]``
    rows a shard."""
    rb = row_bytes(nmodes)
    out = []
    for d in range(len(schedule.hops)):
        out.append({
            "mode": d,
            "permute_bytes": schedule.permute_slots(d) * rb,
            "all_gather_bytes": (schedule.n_dev - 1) * slocs[d] * rb,
        })
    return out


# --------------------------------------------------------------------------
# DistState: the sharded EngineState.
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class DistState:
    """Immutable sharded engine state (device-major slot numbering).

    ``val``/``idx``/``alpha`` hold one tensor a data shard, ``(S_loc,)``
    and ``(S_loc, N)``, on that shard's device (``devices``); ``alpha``
    is in the device-major numbering, so a remap destination names both
    the target shard and its local slot. ``relabel`` maps each distinct
    device of the mesh to its copy of the per-mode relabel tables, and
    ``sched[d][k]`` is shard ``k``'s mode-``d`` ``ModeSched`` (its slice
    of the schedule tables, its block-start table and, for the kernel
    backends, its work table). ``lstatics`` holds each mode's per-shard
    plan constants. Along a ``model`` axis the layout's replicas are
    identical, so the port keeps one a data shard (at model index 0) and
    hands the kernels of rank slice ``m`` what they read on their device.
    """

    val: tuple[torch.Tensor, ...]
    idx: tuple[torch.Tensor, ...]
    alpha: tuple[torch.Tensor, ...]
    relabel: dict
    sched: tuple[tuple[ModeSched, ...], ...]
    mode: int
    dims: tuple[int, ...]
    statics: tuple[ModeStatic, ...]
    lstatics: tuple[ModeStatic, ...]
    config: ExecutionConfig
    dist: DistConfig
    n_dev: int
    schedule: ExchangeSchedule
    mesh: Mesh

    @property
    def nmodes(self) -> int:
        return len(self.dims)

    @property
    def slocs(self) -> tuple[int, ...]:
        """Per-mode local padded slot counts ``S_d_loc``."""
        return tuple(s.padded_nnz for s in self.lstatics)

    @property
    def smax_loc(self) -> int:
        """Per-shard slot count (max over per-mode local padded sizes)."""
        return max(self.slocs)

    @property
    def imax(self) -> int:
        return max(self.dims)

    @functools.cached_property
    def grid(self) -> np.ndarray:
        """``(n_dev, n_model)`` devices: data shard x rank slice."""
        return _grid(self.mesh, self.dist)

    @property
    def devices(self) -> tuple[torch.device, ...]:
        """Each data shard's device (the layout's home)."""
        return tuple(self.grid[:, 0])

    @property
    def device(self) -> torch.device:
        """Where outputs and folded factors live: shard 0's device."""
        return self.devices[0]

    def host_layout(self):
        """``(val, idx, alpha)`` as the reference's global numpy arrays:
        the shards concatenated in device order (copies off the card)."""
        return tuple(np.concatenate([t.cpu().numpy() for t in ts])
                     for ts in (self.val, self.idx, self.alpha))

    def replace(self, **kw) -> "DistState":
        return dataclasses.replace(self, **kw)


def _grid(mesh: Mesh, dist: DistConfig) -> np.ndarray:
    """The mesh's devices as a ``(data, model)`` grid (model size 1 with no
    model axis); any other axis is a replica and takes index 0."""
    axes = list(mesh.axis_names)
    keep = [axes.index(dist.data_axis)]
    if dist.model_axis is not None:
        keep.append(axes.index(dist.model_axis))
    rest = [i for i in range(len(axes)) if i not in keep]
    arr = np.transpose(mesh.devices, keep + rest)
    arr = arr[(slice(None),) * len(keep) + (0,) * len(rest)]
    return arr if dist.model_axis is not None else arr[:, None]


def check_mesh(mesh, dist: DistConfig) -> None:
    """Refuse anything but the port's :class:`Mesh` or a
    :class:`~repro_torch.sharding.ShardingCtx` over one (``TypeError``)
    and a mesh without the config's axes (``ValueError``)."""
    from repro_torch.sharding import ShardingCtx

    if isinstance(mesh, ShardingCtx):
        mesh = mesh.mesh
    if not isinstance(mesh, Mesh):
        raise TypeError(
            f"the distributed tier takes a repro_torch.launch.mesh.Mesh or "
            f"a repro_torch.sharding.ShardingCtx, got {type(mesh).__name__}")
    for ax in (dist.data_axis, dist.model_axis):
        if ax is not None and ax not in mesh.axis_names:
            raise ValueError(f"mesh has no axis {ax!r}: {mesh.axis_names}")


def from_ctx(mesh, dist: DistConfig | None = None, *,
             model: bool = True) -> tuple[Mesh, DistConfig | None]:
    """``(mesh, dist)`` with a sharding context unwrapped: with a
    :class:`~repro_torch.sharding.ShardingCtx` and no ``dist`` the axes
    follow the context, ``DistConfig(data_axis=ctx.data_axis,
    model_axis=ctx.tp_axis)`` (the model axis left out with ``model=False``,
    as ``cp_als`` needs the full rank on every shard). Anything else is
    returned as it is."""
    from repro_torch.sharding import ShardingCtx

    if not isinstance(mesh, ShardingCtx):
        return mesh, dist
    if dist is None:
        dist = DistConfig(data_axis=mesh.data_axis,
                          model_axis=mesh.tp_axis if model else None)
    return mesh.mesh, dist


# --------------------------------------------------------------------------
# shard_state: place an EngineState over the mesh.
# --------------------------------------------------------------------------
def shard_state(state: EngineState, mesh,
                dist: DistConfig | None = None) -> DistState:
    """Shard a single-device :class:`EngineState` over ``mesh``'s data
    axis. ``mesh`` is the port's :class:`Mesh` or a
    :class:`~repro_torch.sharding.ShardingCtx`: with a context and no
    ``dist`` the data/model axes follow its dp/tp convention
    (:func:`from_ctx`).

    Renumbers every mode layout into device-major slots, precomputes the
    permute :class:`ExchangeSchedule`, builds each shard's schedule and
    work tables and places them on its device; the relabel tables go to
    each distinct device once. Requires every mode's ``kappa`` to be a
    multiple of the data-axis size. Anything but a :class:`Mesh` or a
    context raises ``TypeError``.
    """
    mesh, dist = from_ctx(mesh, dist)
    dist = dist or DistConfig()
    check_mesh(mesh, dist)
    n_dev = mesh.shape[dist.data_axis]
    for s in state.statics:
        if s.kappa % n_dev != 0:
            raise ValueError(
                f"kappa {s.kappa} not divisible by n_dev {n_dev}; build "
                "the tensor with ExecutionConfig.kappa_for(dim, nmodes, "
                "n_dev=) (e.g. via core.distributed.build_sharded_flycoo)")

    n, m0 = state.nmodes, state.mode
    with span("dist.shard_state", n_dev=int(n_dev), nmodes=n):
        statics = state.statics
        host_sched = [ModeSched(*(None if t is None else t.cpu().numpy()
                                  for t in ms)) for ms in state.sched]
        with span("dist.renumber"):
            geoms = [_block_geometry(statics[d], host_sched[d].bpart, n_dev)
                     for d in range(n)]
            lstatics = tuple(_local_static(statics[d], geoms[d][3], n_dev)
                             for d in range(n))
            smax_loc = max(ls.padded_nnz for ls in lstatics)
            total = n_dev * smax_loc

            alpha = state.alpha.cpu().numpy()
            alive = alpha[:, m0] >= 0
            slots = alpha[alive].astype(np.int64)   # (nnz, n) per-mode slots
            # device-major renumbering: each shard's contiguous block run
            # starts at local slot 0
            dslots = np.empty_like(slots)
            devs = np.empty_like(slots)
            for d in range(n):
                _, blocks_per_dev, dev_first_block, _ = geoms[d]
                p = statics[d].block_p
                dev_of_block = np.repeat(np.arange(n_dev), blocks_per_dev)
                dev = dev_of_block[slots[:, d] // p]
                dslots[:, d] = (dev * smax_loc + slots[:, d]
                                - dev_first_block[dev] * p)
                devs[:, d] = dev
        with span("dist.exchange_schedule"):
            schedule = _schedule_from_devs([devs[:, d] for d in range(n)],
                                           n_dev, dist.pad_hop)

        pos = dslots[:, m0]
        val = np.zeros(total, dtype=np.float32)
        idx = np.zeros((total, n), dtype=np.int32)
        nalpha = np.full((total, n), -1, dtype=np.int32)
        val[pos] = state.val.cpu().numpy()[alive]
        idx[pos] = state.idx.cpu().numpy()[alive]
        nalpha[pos] = dslots.astype(np.int32)

        gsched = [_local_sched(host_sched[d], statics[d], geoms[d], n_dev)
                  for d in range(n)]
        relabel = [r.cpu().numpy() for r in state.relabel]
        return assemble(
            val, idx, nalpha, relabel, gsched, mode=m0, dims=state.dims,
            statics=statics, lstatics=lstatics,
            blocks_per_dev=[g[1] for g in geoms], config=state.config,
            dist=dist, schedule=schedule, mesh=mesh)


def assemble(val, idx, alpha, relabel, gsched, *, mode: int, dims, statics,
             lstatics, blocks_per_dev, config: ExecutionConfig,
             dist: DistConfig, schedule: ExchangeSchedule,
             mesh: Mesh) -> DistState:
    """A :class:`DistState` from the global device-major host arrays (the
    reference's ``DistState`` leaves as numpy): ``val``/``idx``/``alpha``,
    the per-mode ``relabel`` tables, ``gsched`` per mode the device-major
    ``bpart``/``uidx``/``upos``/``nuniq`` (:func:`_local_sched`) and
    ``blocks_per_dev`` per mode each shard's real block count. Builds
    each shard's block-start table and, for backends whose kernels take
    one, its work table (:func:`repro_torch.engine.api.layout_work`, over
    its real blocks and the alive slots that ``alpha`` gives), then places
    every shard's tensors on its device and the relabel tables on each
    distinct device once. Sets the ``dist_exchange_bytes`` gauge."""
    check_mesh(mesh, dist)
    n = len(dims)
    n_dev = mesh.shape[dist.data_axis]
    smax_loc = max(ls.padded_nnz for ls in lstatics)
    if n_dev * smax_loc >= 2 ** 31:
        raise ValueError(f"{n_dev} shards x {smax_loc} slots overflow the "
                         "int32 slot numbers of alpha")
    grid = _grid(mesh, dist)
    if grid.shape[0] != n_dev or len(val) != n_dev * smax_loc:
        raise ValueError(f"layout of {len(val)} slots for {n_dev} shards "
                         f"of {smax_loc}")
    wire = _obs_gauge("dist_exchange_bytes",
                      "permute wire bytes per mode transition")
    for hop in exchange_bytes(schedule, n, [ls.padded_nnz
                                            for ls in lstatics]):
        wire.set(f"mode{hop['mode']}", hop["permute_bytes"])
    takes_work = getattr(get_backend(config), "takes_work", False)
    # one host copy each, which the shards' tensors slice
    val = np.array(val, np.float32)
    idx = np.array(idx, np.int32)
    alpha = np.array(alpha, np.int32)
    with span("dist.device_place"):
        sched = []
        for d in range(n):
            ls, g = lstatics[d], gsched[d]
            nbl, p = ls.nblocks, ls.block_p
            live = alpha[:, d]
            live = live[live >= 0].astype(np.int64)
            per = []
            for k in range(n_dev):
                dedup = None
                if g["uidx"] is not None:
                    sl = slice(k * nbl * p, (k + 1) * nbl * p)
                    dedup = (g["uidx"][:, sl], g["upos"][sl],
                             g["nuniq"][:, k * nbl:(k + 1) * nbl])
                bpart = g["bpart"][k * nbl:(k + 1) * nbl]
                work = None
                if takes_work:
                    mine = live[live // smax_loc == k] - k * smax_loc
                    work = layout_work(ls, bpart, mine,
                                       int(blocks_per_dev[d][k]))
                per.append(place_sched(
                    mode_sched_arrays(bpart, ls.kappa, dedup, work),
                    grid[k, 0]))
            sched.append(tuple(per))

        def split(a):
            return tuple(torch.from_numpy(a[k * smax_loc:(k + 1) * smax_loc])
                         .to(grid[k, 0]) for k in range(n_dev))

        return DistState(
            val=split(val), idx=split(idx), alpha=split(alpha),
            relabel={dev: tuple(torch.from_numpy(
                np.array(r, np.int32)).to(dev) for r in relabel)
                for dev in mesh.distinct()},
            sched=tuple(sched), mode=int(mode),
            dims=tuple(int(x) for x in dims), statics=tuple(statics),
            lstatics=tuple(lstatics), config=config, dist=dist,
            n_dev=int(n_dev), schedule=schedule, mesh=mesh)


# --------------------------------------------------------------------------
# The exchange.
# --------------------------------------------------------------------------
def _copied():
    return _obs_counter("dist_copied_bytes",
                        "bytes copied between shards by the remap exchange "
                        "(exchange:mode), summed over the shards")


#: Rows past a scatter's buffer where the rows it does not send land,
#: row ``i`` on ``i % PARK_ROWS``: PyTorch's scatter has no "drop" (the
#: reference's ``mode="drop"``), and millions of stores to one parking row
#: would queue on one address.
PARK_ROWS = 1 << 16


def _buffers(nmodes, dev, rows):
    """Layout buffers of ``rows`` slots plus ``PARK_ROWS`` parking rows,
    in the pad pattern (val 0, idx 0, alpha -1), on ``dev``."""
    n = rows + PARK_ROWS
    return [torch.zeros(n, dtype=torch.float32, device=dev),
            torch.zeros((n, nmodes), dtype=torch.int32, device=dev),
            torch.full((n, nmodes), -1, dtype=torch.int32, device=dev)]


def _put(bufs, rows, keep, dst, v, ix, al):
    """Scatter rows ``v``/``ix``/``al`` where ``keep`` to their (unique)
    slots ``dst`` of ``bufs`` (:func:`_buffers` of ``rows`` slots); the
    others park past ``rows``."""
    park = rows + torch.arange(len(v), device=v.device) % PARK_ROWS
    dst = torch.where(keep, dst, park)
    bufs[0].index_copy_(0, dst, v)
    bufs[1].index_copy_(0, dst, ix)
    bufs[2].index_copy_(0, dst, al)


def _exchange_permute(cur, alive, *, d, nxt, hops, smax_loc, n_dev, nmodes,
                      devices):
    """The static round-robin: each shard scatters its own elements into
    its next layout, then for every hop ``h`` with a non-zero cap each
    shard ``k`` packs the elements bound for ``(k + h) % n_dev`` densely
    into a buffer of exactly ``cap`` slots (a cumsum and a scatter),
    copies it into that shard's receive buffer and scatters it there."""
    nxt_bufs, dst_dev = [], []
    for k in range(n_dev):
        v, ix, al = cur[k]
        dstg = al[:, nxt].long()
        dd = torch.div(dstg, smax_loc, rounding_mode="floor")  # dead: -1
        dst_dev.append(dd)
        bufs = _buffers(nmodes, v.device, smax_loc)
        _put(bufs, smax_loc, alive[k] & (dd == k), dstg - k * smax_loc,
             v, ix, al)
        nxt_bufs.append(bufs)
    sent = 0
    for h in range(1, n_dev):
        cap = hops[h - 1]
        if cap == 0:    # statically empty hop: no copy at all
            continue
        for k in range(n_dev):
            j = (k + h) % n_dev
            v, ix, al = cur[k]
            sel = alive[k] & (dst_dev[k] == j)
            pack = _buffers(nmodes, v.device, cap)
            _put(pack, cap, sel, torch.cumsum(sel, 0) - 1, v, ix, al)
            # shard j's own receive buffers: never an alias of k's
            recv = [torch.empty_like(b[:cap], device=devices[j])
                    for b in pack]
            for r, b in zip(recv, pack):
                r.copy_(b[:cap])
            rdst = recv[2][:, nxt].long()
            _put(nxt_bufs[j], smax_loc, rdst >= 0, rdst - j * smax_loc,
                 *recv)
            sent += cap * row_bytes(nmodes)
    _copied().inc(f"permute:mode{d}", sent)
    return [tuple(b[:smax_loc] for b in bufs) for bufs in nxt_bufs]


def _exchange_all_gather(cur, alive, *, d, nxt, smax_loc, n_dev, nmodes,
                         devices):
    """The baseline: every shard gathers every shard's whole mode-``d``
    element list and scatters the elements that land in its own slots
    (the reference scatters into the whole next layout and keeps its
    slice: the same slots). ``n_dev - 1`` remote lists a shard."""
    del alive
    sloc = cur[0][0].shape[0]
    sent = 0
    out = []
    for j in range(n_dev):
        dev = devices[j]
        vg = torch.empty(n_dev * sloc, dtype=torch.float32, device=dev)
        ig = torch.empty((n_dev * sloc, nmodes), dtype=torch.int32,
                         device=dev)
        ag = torch.empty((n_dev * sloc, nmodes), dtype=torch.int32,
                         device=dev)
        for k in range(n_dev):
            for g, t in zip((vg, ig, ag), cur[k]):
                g[k * sloc:(k + 1) * sloc].copy_(t)
            if k != j:
                sent += sloc * row_bytes(nmodes)
        dstg = ag[:, nxt].long()
        mine = (ag[:, d] >= 0) & (torch.div(dstg, smax_loc,
                                            rounding_mode="floor") == j)
        bufs = _buffers(nmodes, dev, smax_loc)
        _put(bufs, smax_loc, mine, dstg - j * smax_loc, vg, ig, ag)
        out.append(tuple(b[:smax_loc] for b in bufs))
    _copied().inc(f"all_gather:mode{d}", sent)
    return out


# --------------------------------------------------------------------------
# One mode over every shard: local EC + output gather + remap exchange.
# --------------------------------------------------------------------------
def _on(dev, layout: dict) -> dict:
    """``layout`` (a shard's backend layout) on ``dev``; the work table
    through ``WorkTable.to``, which keeps its seal."""
    from repro_torch.kernels.mttkrp import WorkTable

    out = {k: (t.to(dev) if torch.is_tensor(t) else t)
           for k, t in layout.items() if k not in ("work", "wsum")}
    if layout.get("work") is not None:
        w = WorkTable(layout["work"], layout["wsum"]).to(dev)
        out.update(work=w.chunks, wsum=w.wsum)
    return out


def _replicate(factors, devs):
    """The factors on each distinct device, one copy a device."""
    return {dev: tuple(f.to(dev) for f in factors)
            for dev in dict.fromkeys(devs)}


def shard_layout(dstate: DistState, k: int, d: int, cur=None):
    """Shard ``k``'s backend layout for mode ``d`` (its ``(val, idx,
    alpha)``, from ``cur`` or the state, cut to ``S_d_loc`` slots, the
    local rows ``lrow`` and its schedule and work tables) and its alive
    mask: what the backend's plain-gather entry takes."""
    lplan = dstate.lstatics[d]
    sloc = lplan.padded_nnz
    val, idx, alpha = (cur[k] if cur is not None else
                       (dstate.val[k], dstate.idx[k], dstate.alpha[k]))
    v, ix, al = val[:sloc], idx[:sloc], alpha[:sloc]
    alive = al[:, d] >= 0
    lrow = compute_lrow(ix[:, d], dstate.relabel[dstate.devices[k]][d],
                        lplan.rows_pp, alive)
    return ({"val": v, "idx": ix, "alpha": al, "lrow": lrow,
             **dstate.sched[d][k]._asdict()}, alive)


def _dist_mode_step(dstate: DistState, cur, facs, d: int):
    """Mode ``d`` on every shard: each shard's EC on its local layout (one
    launch a rank slice), the outputs concatenated in shard order on
    shard 0's device and un-relabelled, and the exchange into the
    mode-``d+1`` layouts. ``cur`` is the per-shard ``(val, idx, alpha)``,
    ``facs`` the factors a device (:func:`_replicate`). Returns ``(out
    (I_d, R), next cur)``."""
    n, n_dev = dstate.nmodes, dstate.n_dev
    nxt = (d + 1) % n
    lplan = dstate.lstatics[d]
    config = dstate.config
    backend = get_backend(config)
    grid = dstate.grid
    devices = tuple(grid[:, 0])
    n_model = grid.shape[1]
    rank = next(iter(facs.values()))[0].shape[1]
    if rank % n_model:
        raise ValueError(f"rank {rank} does not split over {n_model} "
                         "model shards")
    rm = rank // n_model
    dev0 = devices[0]

    local, alive, rows = [], [], []
    for k in range(n_dev):
        layout, live = shard_layout(dstate, k, d, cur)
        cols = []
        for m in range(n_model):
            dev = grid[k, m]
            fac = facs[dev]
            if n_model > 1:
                fac = tuple(f[:, m * rm:(m + 1) * rm].contiguous()
                            for f in fac)
            lay = layout if dev == devices[k] else _on(dev, layout)
            cols.append(backend(lay, fac, d, plan=lplan,
                                config=config).to(dev0))
        rows.append(cols[0] if n_model == 1 else torch.cat(cols, dim=1))
        local.append((layout["val"], layout["idx"], layout["alpha"]))
        alive.append(live)
    out_rel = rows[0] if n_dev == 1 else torch.cat(rows, dim=0)
    out = out_rel.index_select(0, dstate.relabel[dev0][d])

    kw = dict(d=d, nxt=nxt, smax_loc=dstate.smax_loc, n_dev=n_dev,
              nmodes=n, devices=devices)
    if dstate.dist.exchange == "permute":
        nl = _exchange_permute(local, alive, hops=dstate.schedule.hops[d],
                               **kw)
    else:
        nl = _exchange_all_gather(local, alive, **kw)
    return out, nl


def _check_fold(dist: DistConfig, fold) -> None:
    if fold is not None and dist.model_axis is not None:
        raise ValueError("fold needs the full rank on every device; use "
                         "model_axis=None when folding (e.g. CPD-ALS)")


# --------------------------------------------------------------------------
# Public execution API.
# --------------------------------------------------------------------------
def _gate_dispatch(dstate: DistState, policy, what: str):
    """Run the chaos hook for one dist dispatch, retrying *transient*
    failures with the policy's seeded backoff (the stream uploads'
    path). Other faults (exchange, device loss, build) propagate to the
    caller's ladder."""
    attempt = 0
    while True:
        _c = _chaos.active()
        if _c is None:
            return
        try:
            _c.on_dist_dispatch(dstate.config.backend,
                                exchange=dstate.dist.exchange,
                                n_dev=int(dstate.n_dev), attempt=attempt)
            return
        except Exception as exc:
            from repro_torch.resilience.ladder import (backoff_delay,
                                                       classify,
                                                       record_retry)
            if policy is None or classify(exc) != "transient" \
                    or attempt >= policy.max_retries:
                raise
            record_retry("dist.dispatch", attempt,
                         backoff_delay(policy, attempt,
                                       token=(what, dstate.mode)),
                         kind="dist")
            attempt += 1


def _layouts(dstate: DistState):
    return [tuple(t[k] for t in (dstate.val, dstate.idx, dstate.alpha))
            for k in range(dstate.n_dev)]


def _with_layouts(dstate: DistState, nl, **kw) -> DistState:
    return dstate.replace(val=tuple(x[0] for x in nl),
                          idx=tuple(x[1] for x in nl),
                          alpha=tuple(x[2] for x in nl), **kw)


def dist_mttkrp(dstate: DistState, factors: Sequence[torch.Tensor], *,
                policy=None):
    """MTTKRP for the resident mode + the cross-shard remap exchange;
    returns ``(out, next_dstate)`` with ``out`` of shape ``(dims[mode],
    R)`` on shard 0's device."""
    _gate_dispatch(dstate, policy, "dist_mttkrp")
    DISPATCH_COUNTS["dist_mttkrp"] += 1
    d = dstate.mode
    with span("engine.dispatch", kind="dist_mttkrp", mode=d,
              n_dev=int(dstate.n_dev)):
        out, nl = _dist_mode_step(
            dstate, _layouts(dstate),
            _replicate(tuple(factors), dstate.grid.ravel()), d)
    return out, _with_layouts(dstate, nl, mode=(d + 1) % dstate.nmodes)


def dist_all_modes(dstate: DistState, factors: Sequence[torch.Tensor], *,
                   fold: FoldFn | None = None, carry=None, policy=None):
    """Distributed spMTTKRP along all modes from the resident mode, the
    same contract as ``engine.all_modes``: without ``fold`` returns
    ``(outs, next_dstate)``; with ``fold`` ``(outs, next_dstate,
    factors, carry)``, the hook run on shard 0's device after each mode
    and its factors replicated to each distinct device once. ``policy``
    (a ``LadderPolicy``) retries transient dispatch failures in place;
    other faults propagate to the caller's ladder rungs."""
    _check_fold(dstate.dist, fold)
    _gate_dispatch(dstate, policy, "dist_all_modes")
    DISPATCH_COUNTS["dist_all_modes"] += 1
    n, m0 = dstate.nmodes, dstate.mode
    devs = dstate.grid.ravel()
    factors = tuple(factors)
    facs = _replicate(factors, devs)
    outs: list = [None] * n
    cur = _layouts(dstate)
    with span("engine.dispatch", kind="dist_all_modes", start_mode=m0,
              n_dev=int(dstate.n_dev)):
        for i in range(n):
            d = (m0 + i) % n
            outs[d], cur = _dist_mode_step(dstate, cur, facs, d)
            if fold is not None:
                factors, carry = fold(d, outs[d], factors, carry)
                facs = _replicate(factors, devs)
    next_state = _with_layouts(dstate, cur)
    if fold is None:
        return outs, next_state
    return outs, next_state, list(factors), carry


def surviving_mesh(mesh: Mesh, lost: int, kappas: Sequence[int],
                   data_axis: str = "data") -> Mesh:
    """The largest viable 1-D data mesh after ``lost`` devices die: the
    highest-ordinal positions drop, and the survivor count is rounded
    down to the largest ``n`` that divides every mode's partition count.
    Raises when nothing viable remains."""
    devices = list(np.asarray(mesh.devices).reshape(-1))
    alive = devices[:len(devices) - int(lost)]
    n = len(alive)
    while n >= 1 and any(int(k) % n for k in kappas):
        n -= 1
    if n < 1:
        raise RuntimeError(
            f"no viable mesh after losing {lost} of {len(devices)} "
            f"device(s) (kappas {tuple(int(k) for k in kappas)})")
    arr = np.empty(n, dtype=object)
    arr[:] = alive[:n]
    return Mesh(arr, (data_axis,))


__all__ = ["DistConfig", "DistState", "ExchangeSchedule", "shard_state",
           "assemble", "check_mesh", "from_ctx", "shard_layout", "dist_mttkrp",
           "dist_all_modes", "schedule_for_plans", "element_devices",
           "exchange_bytes", "row_bytes", "surviving_mesh", "EXCHANGES"]
