"""Mesh/sharding context, parameter partitioning rules, and the explicit
single-controller moves that place a tree over a mesh (the port of
``repro.sharding``).

Axis convention, as the reference's:
  dp axes  — ("pod", "data") when present: batch / fsdp shards
  tp axis  — "model": heads, d_ff, vocab shards

The reference is single-controller SPMD: models call ``shard(x, *tags)``
and GSPMD partitions from those hints. PyTorch has no such partitioner,
so here ``shard`` only checks its tags and changes no value, and
placement is explicit: :func:`place` splits each leaf of a tree onto the
positions of a :class:`~repro_torch.launch.mesh.Mesh` (as
``jax.device_put(x, NamedSharding)`` does), :func:`gather` puts the whole
tensor back together, and :func:`psum` sums one tensor a position of a
mesh axis onto every position (differentiable: ``.to`` and ``+``). One
process drives every position, as the distributed CPD tier does
(``engine.dist``); a position is a ``torch.device`` and a hop a copy
between devices.

A spec is a plain tuple with one entry per dimension: an axis name, a
tuple of axis names, or ``None``, as the reference's ``PartitionSpec``
entries are. The port keeps a stacked leaf as a list of per-layer
tensors (``training.tree``), so a per-layer tensor takes the reference's
tags without the leading ``"layer"``.

Under :func:`accounting` (the dry-run's, ``launch.dryrun``) each move
records the collective it stands for (:class:`CollectiveEvent`: the
kind, the bytes of each device's result, the group's size and how many
devices the call covers), from which ``analysis.collectives`` takes the
per-device ring-algorithm bytes of the production collective, not what
the single controller happens to copy; and it tells the accounting's
tracker (``analysis.cost``) which mesh positions own what it makes. With
no accounting open nothing is recorded and nothing changes.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import itertools
import math
from typing import Optional

import numpy as np
import torch

from .launch.mesh import Mesh


@dataclasses.dataclass(frozen=True)
class ShardingCtx:
    mesh: Mesh
    dp_axes: tuple[str, ...]      # e.g. ("data",) or ("pod", "data")
    tp_axis: Optional[str]        # "model"
    fsdp: bool = True             # shard params/opt-state over dp too

    @property
    def data_axis(self) -> str:
        """Innermost dp axis name — the axis engine.dist shards slots and
        partitions over (``"data"`` when the mesh has no dp axis)."""
        return self.dp_axes[-1] if self.dp_axes else "data"

    @property
    def tp(self) -> int:
        """The model axis's size (1 without one)."""
        return self.mesh.shape[self.tp_axis] if self.tp_axis else 1

    def resolve(self, *tags) -> tuple:
        spec = []
        for t in tags:
            if t == "dp":
                spec.append(self.dp_axes if len(self.dp_axes) > 1
                            else self.dp_axes[0] if self.dp_axes else None)
            elif t == "tp":
                spec.append(self.tp_axis)
            else:
                spec.append(None)
        return tuple(spec)


_CTX: contextvars.ContextVar[Optional[ShardingCtx]] = contextvars.ContextVar(
    "repro_torch_sharding_ctx", default=None)


def current() -> Optional[ShardingCtx]:
    return _CTX.get()


@dataclasses.dataclass(frozen=True)
class CollectiveEvent:
    """One collective as one call records it: ``kind`` (``all-gather``,
    ``all-reduce``, ``reduce-scatter``, ``all-to-all``,
    ``collective-permute``), ``result_bytes`` (R, the bytes of each
    device's result), ``group`` (n, the devices that exchange) and
    ``devices`` (how many devices this call stands for: the whole group
    for a move over a model axis, one for a position's fsdp gather)."""
    kind: str
    result_bytes: float
    group: int
    devices: int


@dataclasses.dataclass
class Accounting:
    """What :func:`accounting` collects: the :class:`CollectiveEvent`
    list, and the tracker (``analysis.cost.CostMode``) told the owners
    of what the moves make (``own(tensor, positions)``,
    ``share(outs, ins)``), or ``None``."""
    events: list
    tracker: object = None


_ACCT: contextvars.ContextVar[Optional[Accounting]] = contextvars.ContextVar(
    "repro_torch_collective_accounting", default=None)


@contextlib.contextmanager
def accounting(tracker=None):
    """Record every collective the moves of this module make while open
    (yields the :class:`Accounting`)."""
    acct = Accounting([], tracker)
    tok = _ACCT.set(acct)
    try:
        yield acct
    finally:
        _ACCT.reset(tok)


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _record(kind: str, result_bytes: float, group: int, devices: int):
    acct = _ACCT.get()
    if acct is not None and group > 1:
        acct.events.append(CollectiveEvent(kind, float(result_bytes), group,
                                           devices))


def _own(t, positions) -> None:
    """Tell the tracker, if any, that ``positions`` own ``t``."""
    acct = _ACCT.get()
    if acct is not None and acct.tracker is not None:
        acct.tracker.own(t, positions)


def _own_copy(t) -> bool:
    """Whether each position's result of a sum must be its own tensor:
    under a tracker on the ``meta`` device, which stands for every card
    (on distinct cards the results are distinct anyway)."""
    acct = _ACCT.get()
    return acct is not None and acct.tracker is not None \
        and t.device.type == "meta"


def _share(outs, ins) -> None:
    """Tell the tracker, if any, that ``outs[i]`` belongs where
    ``ins[i]`` does (outputs that are one tensor, as a sum's on a device
    that several positions share, belong to all of theirs)."""
    acct = _ACCT.get()
    if acct is not None and acct.tracker is not None:
        acct.tracker.share(outs, ins)


@contextlib.contextmanager
def use(ctx: Optional[ShardingCtx]):
    tok = _CTX.set(ctx)
    try:
        yield ctx
    finally:
        _CTX.reset(tok)


def make_ctx(mesh: Mesh, fsdp: bool = True) -> ShardingCtx:
    names = mesh.axis_names
    dp = tuple(n for n in names if n in ("pod", "data"))
    tp = "model" if "model" in names else None
    return ShardingCtx(mesh=mesh, dp_axes=dp, tp_axis=tp, fsdp=fsdp)


def _axes(entry) -> tuple:
    """A spec entry's axis names (``()`` for ``None``)."""
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def _extent(ctx: ShardingCtx, tag) -> int:
    return math.prod(ctx.mesh.shape[a] for a in _axes(ctx.resolve(tag)[0]))


def fit_tags(shape, tags, ctx: ShardingCtx) -> tuple:
    """``tags`` with every tag whose dimension its mesh extent does not
    divide dropped (replicated): the rule of the reference's ``shard``
    and of its ``param_sharding_tree``'s guard."""
    return tuple(t if t is not None and shape[d] % _extent(ctx, t) == 0
                 else None for d, t in enumerate(tags))


def shard(x, *tags):
    """The reference's sharding hint: checks the rank (``ValueError``)
    under a mesh context and returns ``x`` unchanged (placement is
    explicit here, :func:`place`). :func:`fit_tags` gives the tags it
    would keep."""
    ctx = current()
    if ctx is None:
        return x
    if len(tags) != x.dim():
        raise ValueError(f"{len(tags)} tags for rank-{x.dim()} array")
    return x


# --------------------------------------------------------------------------
# Parameter partitioning rules (path-pattern -> dim tags).
# --------------------------------------------------------------------------
def param_tags(path: tuple[str, ...], shape: tuple[int, ...],
               ctx: ShardingCtx) -> tuple:
    """The reference's rules keyed on leaf names; one tag per dim of
    ``shape``, a per-layer tensor's shape for a leaf under a
    ``stage{i}`` key (the reference's tags less the leading layer
    axis's ``None``)."""
    name = path[-1]
    body = shape
    fsdp = "dp" if ctx.fsdp else None
    if name in ("embed",):                      # (V, D)
        return ("tp", None)
    if name in ("head",):                       # (D, V)
        return (None, "tp")
    if name in ("wq", "wk", "wv"):              # (D, H, hd) or (D, KVH, hd)
        return (fsdp, "tp", None) if body[1] % ctx.tp == 0 \
            else (fsdp, None, None)
    if name == "wo":                            # (H, hd, D)
        return ("tp", None, fsdp) if body[0] % ctx.tp == 0 \
            else (None, None, fsdp)
    if name in ("w_gate", "w_up"):              # (D, F) or (E, D, F)
        if len(body) == 3:
            return ("tp", fsdp, None)           # experts over tp
        return (fsdp, "tp")
    if name == "w_down":                        # (F, D) or (E, F, D)
        if len(body) == 3:
            return ("tp", None, fsdp)
        return ("tp", fsdp)
    if name == "router":                        # (D, E)
        return (fsdp, None)
    if name in ("w_in_rec", "w_in_gate"):       # (D, W) rg-lru projections
        return (fsdp, "tp")
    if name == "w_out_rec":                     # (W, D)
        return ("tp", fsdp)
    if name in ("wr", "wk_t", "wv_t", "wg", "w_out_t"):  # rwkv (D, D)
        return (fsdp, "tp") if name != "w_out_t" else ("tp", fsdp)
    if name in ("wk_c", ):                      # rwkv channel (D, F)
        return (fsdp, "tp")
    if name in ("wv_c", ):                      # (F, D)
        return ("tp", fsdp)
    # biases, norms, gates, small tables: replicate
    return (None,) * len(body)


def param_sharding_tree(params, ctx: ShardingCtx):
    """The params tree's specs (a list of per-layer specs for a stacked
    leaf), by :func:`param_tags` and the divisibility guard."""
    def visit(path, node):
        if isinstance(node, dict):
            return {k: visit(path + (str(k),), v) for k, v in node.items()}
        if isinstance(node, list):
            return [visit(path, x) for x in node]
        shape = tuple(node.shape)
        return ctx.resolve(*fit_tags(shape, param_tags(path, shape, ctx),
                                     ctx))

    return visit((), params)


def replicated(x) -> tuple:
    """The spec of a replicated tensor of ``x``'s rank."""
    return (None,) * len(x.shape)


# --------------------------------------------------------------------------
# Sharded tensors and the single-controller moves
# --------------------------------------------------------------------------
def _coord(mesh: Mesh, pos: tuple, entry) -> tuple[int, int]:
    """(index, count) of the block a mesh position takes along one
    dimension whose spec entry is ``entry`` (row-major over its axes)."""
    idx, n = 0, 1
    for a in _axes(entry):
        k = mesh.axis_names.index(a)
        size = mesh.devices.shape[k]
        idx, n = idx * size + pos[k], n * size
    return idx, n


def block_of(mesh: Mesh, spec, pos) -> tuple:
    """The block index a mesh position holds, one entry per dim."""
    return tuple(_coord(mesh, pos, e)[0] for e in spec)


def _slices(shape, mesh: Mesh, spec, block) -> tuple:
    out = []
    for d, e in enumerate(spec):
        n = math.prod(mesh.shape[a] for a in _axes(e))
        size = shape[d] // n
        out.append(slice(block[d] * size, (block[d] + 1) * size))
    return tuple(out)


def positions(mesh: Mesh):
    """Every mesh position (a tuple of axis indices), in mesh order."""
    return list(itertools.product(*(range(s) for s in mesh.devices.shape)))


class Sharded:
    """A tensor split over a mesh by ``spec``: ``pieces`` maps (device,
    block) to the block's tensor on that device, and ``where`` each mesh
    position to its key. Positions that share a device and a block share
    one tensor (four shards on one card hold a replicated leaf once)."""

    def __init__(self, mesh: Mesh, spec: tuple, shape, dtype, pieces: dict,
                 where: dict):
        self.mesh, self.spec = mesh, tuple(spec)
        self.shape, self.dtype = torch.Size(shape), dtype
        self.pieces, self.where = pieces, where

    def dim(self) -> int:
        return len(self.shape)

    def is_floating_point(self) -> bool:
        return self.dtype.is_floating_point

    def at(self, pos) -> torch.Tensor:
        return self.pieces[self.where[tuple(pos)]]

    def keys(self) -> list:
        """The keys of the distinct pieces, in the order of the first
        position that holds each."""
        return list(dict.fromkeys(self.where.values()))

    def blocks(self) -> dict:
        """One key for each distinct block (each element once)."""
        out = {}
        for key in self.keys():
            out.setdefault(key[1], key)
        return out

    def map(self, fn, *rest) -> "Sharded":
        """``fn(piece, *other pieces at the same key)`` for each piece,
        as a :class:`Sharded` of the same layout (``None`` where ``fn``
        works in place and returns ``None``; any other result than a
        tensor raises ``TypeError``)."""
        new = {k: fn(self.pieces[k], *(r.pieces[k] for r in rest))
               for k in self.keys()}
        first = next(iter(new.values()))
        if first is None:
            return None
        if not isinstance(first, torch.Tensor):
            raise TypeError(f"Sharded.map: fn returned a "
                            f"{type(first).__name__}, not a tensor or None")
        return Sharded(self.mesh, self.spec, self.shape, first.dtype, new,
                       dict(self.where))

    def __repr__(self) -> str:
        return (f"Sharded({tuple(self.shape)}, {self.dtype}, spec="
                f"{self.spec}, {len(self.pieces)} pieces)")


def place_tensor(x: torch.Tensor, spec, mesh: Mesh) -> Sharded:
    """Split ``x`` onto ``mesh`` by ``spec`` (copies: the pieces own
    their storage)."""
    spec = tuple(spec)
    if len(spec) != x.dim():
        raise ValueError(f"spec {spec} for a rank-{x.dim()} tensor")
    for d, e in enumerate(spec):
        n = math.prod(mesh.shape[a] for a in _axes(e))
        if x.shape[d] % n:
            raise ValueError(f"dim {d} of {tuple(x.shape)} does not divide "
                             f"over {e} ({n})")
    pieces, where = {}, {}
    for pos in positions(mesh):
        dev = mesh.devices[pos]
        block = block_of(mesh, spec, pos)
        key = (dev, block)
        if key not in pieces:
            part = x.detach()[_slices(x.shape, mesh, spec, block)]
            pieces[key] = part.to(dev, copy=True).contiguous()
        where[pos] = key
    out = Sharded(mesh, spec, x.shape, x.dtype, pieces, where)
    _own_pieces(out)
    return out


def _own_pieces(s: Sharded) -> None:
    """Each piece of ``s`` owned by the positions that hold it."""
    if _ACCT.get() is None:
        return
    holders: dict = {}
    for pos, key in s.where.items():
        holders.setdefault(key, []).append(pos)
    for key, poss in holders.items():
        _own(s.pieces[key], poss)


def from_positions(mesh: Mesh, spec, shape, values: dict) -> Sharded:
    """A :class:`Sharded` of ``shape`` laid out by ``spec`` from
    ``values`` (mesh position -> its block, each on its device): the
    block of the first position that holds each (device, block) key
    (the replicas of a block are equal)."""
    spec = tuple(spec)
    pieces, where = {}, {}
    for pos in positions(mesh):
        key = (mesh.devices[pos], block_of(mesh, spec, pos))
        if key not in pieces:
            pieces[key] = values[pos]
        where[pos] = key
    first = next(iter(pieces.values()))
    out = Sharded(mesh, spec, shape, first.dtype, pieces, where)
    _own_pieces(out)
    return out


def place(tree, specs, ctx_or_mesh):
    """Each tensor of ``tree`` split by its spec in ``specs`` (a tree of
    the same structure) onto the mesh: a tree of :class:`Sharded`."""
    mesh = getattr(ctx_or_mesh, "mesh", ctx_or_mesh)
    if isinstance(tree, dict):
        return {k: place(v, specs[k], mesh) for k, v in tree.items()}
    if isinstance(tree, list):
        return [place(v, s, mesh) for v, s in zip(tree, specs)]
    if isinstance(tree, Sharded):
        tree = gather(tree)
    if not isinstance(tree, torch.Tensor):   # a cache's position counter
        return tree
    return place_tensor(tree, specs, mesh)


def gather_tensor(s: Sharded, device=None) -> torch.Tensor:
    """The whole tensor on ``device`` (default: the device of the mesh's
    first position)."""
    dev = torch.device(device) if device is not None \
        else s.mesh.devices.flat[0]
    out = torch.empty(s.shape, dtype=s.dtype, device=dev)
    for block, key in s.blocks().items():
        out[_slices(s.shape, s.mesh, s.spec, block)] = s.pieces[key]
    return out


def gather(tree, device=None):
    """A tree of :class:`Sharded` back to whole tensors; other leaves as
    they are."""
    if isinstance(tree, dict):
        return {k: gather(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [gather(v, device) for v in tree]
    if isinstance(tree, Sharded):
        return gather_tensor(tree, device)
    return tree


def is_sharded(tree) -> bool:
    """Whether the first leaf of ``tree`` is a :class:`Sharded`."""
    while isinstance(tree, (dict, list)):
        if not tree:
            return False
        tree = next(iter(tree.values())) if isinstance(tree, dict) \
            else tree[0]
    return isinstance(tree, Sharded)


def fill(s: Sharded, x: torch.Tensor) -> None:
    """Copy the whole tensor ``x`` into every piece of ``s`` (in place)."""
    for (_, block), piece in s.pieces.items():
        piece.copy_(x[_slices(s.shape, s.mesh, s.spec, block)])


def _split_entries(s: Sharded, ctx: ShardingCtx) -> list[bool]:
    """For each dim, whether the model axis (and only it) splits it;
    refuses an entry that mixes it with the dp axes (no rule makes one)."""
    out = []
    for e in s.spec:
        axes = _axes(e)
        if ctx.tp_axis in axes and len(axes) > 1:
            raise ValueError(f"spec entry {e} mixes the model axis with "
                             "others")
        out.append(ctx.tp_axis is not None and axes == (ctx.tp_axis,))
    return out


def working_copy(s: Sharded, pos, ctx: ShardingCtx,
                 dtype=None) -> torch.Tensor:
    """What position ``pos`` computes with: its model-axis slice of the
    leaf, gathered whole along the dims the dp axes split (the fsdp
    all-gather), in ``dtype``, on the position's device."""
    pos = tuple(pos)
    dev = ctx.mesh.devices[pos]
    dtype = dtype or s.dtype
    tp_dims = _split_entries(s, ctx)
    if not any(_axes(e) and not t for e, t in zip(s.spec, tp_dims)):
        out = s.at(pos).to(dev, dtype)        # nothing split over dp
        if out is not s.at(pos):
            _own(out, [pos])
        return out
    mine = block_of(ctx.mesh, s.spec, pos)
    shape = [n // _coord(ctx.mesh, pos, e)[1] if t else n
             for n, e, t in zip(s.shape, s.spec, tp_dims)]
    out = torch.empty(shape, dtype=dtype, device=dev)
    _own(out, [pos])
    for block, key in s.blocks().items():
        if any(t and b != m for b, m, t in zip(block, mine, tp_dims)):
            continue
        sl = _slices(s.shape, s.mesh, s.spec, block)
        out[tuple(slice(None) if t else x
                  for x, t in zip(sl, tp_dims))] = s.pieces[key]
    n = math.prod(_coord(ctx.mesh, pos, e)[1]
                  for e, t in zip(s.spec, tp_dims) if not t)
    _record("all-gather", _nbytes(out), n, 1)
    return out


def reduce_grads(s: Sharded, grads: dict, ctx: ShardingCtx) -> Sharded:
    """The gradient of leaf ``s`` laid out as ``s``: ``grads`` maps each
    mesh position to the gradient of its :func:`working_copy` (a partial
    sum over its batch slice). Each piece is the sum, in mesh order, of
    the partials of every position that computed with that block: those
    with the same model-axis index for a leaf the model axis splits, else
    all of them (the replicas' sum). Each device keeps only its own
    blocks (the reduce-scatter)."""
    tp_dims = _split_entries(s, ctx)
    pos_all = positions(ctx.mesh)
    _record_grad_reduce(s, ctx, tp_dims)
    pieces = {}
    for key in s.keys():
        dev, block = key
        sl = _slices(s.shape, s.mesh, s.spec, block)
        local = tuple(slice(None) if t else x for x, t in zip(sl, tp_dims))
        total = None
        for q in pos_all:
            qb = block_of(ctx.mesh, s.spec, q)
            if any(t and a != b for a, b, t in zip(qb, block, tp_dims)):
                continue
            part = grads[q][local].to(dev, torch.float32)
            total = part if total is None else total + part
        pieces[key] = total.contiguous()
    out = Sharded(s.mesh, s.spec, s.shape, torch.float32, pieces,
                  dict(s.where))
    _own_pieces(out)
    return out


def _record_grad_reduce(s: Sharded, ctx: ShardingCtx, tp_dims) -> None:
    """The production collectives of :func:`reduce_grads` for one leaf,
    float32 pieces on every device: a reduce-scatter over the dp axes
    that split the leaf and an all-reduce over its remaining replicas
    (the positions that compute with one block)."""
    if _ACCT.get() is None:
        return
    mesh = ctx.mesh
    pos0 = positions(mesh)[0]
    n_split = math.prod(_coord(mesh, pos0, e)[1]
                        for e, t in zip(s.spec, tp_dims) if not t)
    group = mesh.size // (ctx.tp if any(tp_dims) else 1)
    piece = math.prod(n // _coord(mesh, pos0, e)[1]
                      for n, e in zip(s.shape, s.spec)) * 4
    _record("reduce-scatter", piece, n_split, mesh.size)
    _record("all-reduce", piece, group // n_split, mesh.size)


def psum(parts: list) -> list:
    """The sum over one mesh axis: ``parts`` holds one tensor a position
    (each on its device); returns the total on each of their devices,
    summed in position order on the first one's (under a tracker on
    the ``meta`` device, each position's its own copy). Differentiable."""
    total = parts[0]
    for p in parts[1:]:
        total = total + p.to(total.device)
    _record("all-reduce", _nbytes(total), len(parts), len(parts))
    return _results(total, parts)


def _results(total, parts) -> list:
    """``total`` on each part's device (each position its own copy where
    :func:`_own_copy` says so), owned where its part is."""
    if len(parts) > 1 and _own_copy(total):
        outs = []
        for p in parts:
            outs.append(total.to(p.device, copy=True))
            _share(outs[-1:], [p])
        return outs
    outs = [total.to(p.device) for p in parts]
    _share(outs, parts)
    return outs


def pmax(parts: list) -> list:
    """The elementwise maximum over one mesh axis, as :func:`psum` sums
    (an all-reduce); not differentiable."""
    total = parts[0]
    for p in parts[1:]:
        total = torch.maximum(total, p.to(total.device))
    _record("all-reduce", _nbytes(total), len(parts), len(parts))
    return _results(total, parts)


def all_to_all(blocks: list) -> list:
    """The exchange over one mesh axis: ``blocks[j]`` holds position
    ``j``'s m blocks on its leading dim; position ``i`` receives block
    ``i`` of every position, stacked in position order on its device (the
    reference's untiled ``lax.all_to_all``, split and concat dim 0).
    Differentiable."""
    outs = [torch.stack([b[i].to(dst.device) for b in blocks])
            for i, dst in enumerate(blocks)]
    _record("all-to-all", _nbytes(outs[0]), len(blocks), len(blocks))
    _share(outs, blocks)
    return outs


def all_gather(parts: list, dim: int) -> list:
    """Every position's part concatenated along ``dim`` in position
    order, on each part's device. Differentiable."""
    outs = [torch.cat([p.to(dst.device) for p in parts], dim=dim)
            for dst in parts]
    _record("all-gather", _nbytes(outs[0]), len(parts), len(parts))
    _share(outs, parts)
    return outs


def gather_rows(parts: list, rows: list, devices: int) -> torch.Tensor:
    """One tensor whose batch rows ``rows[i]`` come from ``parts[i]``
    (each a whole replica in which one dp slice wrote its own rows), on
    the first part's device: the all-gather over the dp slices that keeps
    the replicas of a leaf equal (recorded over ``devices`` devices)."""
    merged = parts[0].clone()
    for p, sl in zip(parts[1:], rows[1:]):
        merged[sl] = p[sl].to(merged.device)
    r = merged.shape[0] * merged[:1, :1].numel() * merged.element_size()
    _record("all-gather", r, len(parts), devices)
    return merged


def model_rows(mesh: Mesh, tp_axis: Optional[str]) -> list[list]:
    """The mesh's positions grouped by their dp coordinates (every axis
    but ``tp_axis``), groups in row-major order of those coordinates and
    each group in model-axis order: one row of model shards a dp slice
    of the batch."""
    tp_k = mesh.axis_names.index(tp_axis) if tp_axis else None
    rows: dict = {}
    for pos in positions(mesh):
        key = tuple(c for k, c in enumerate(pos) if k != tp_k)
        rows.setdefault(key, []).append(pos)
    return list(rows.values())


__all__ = ["Accounting", "CollectiveEvent", "ShardingCtx", "Sharded",
           "accounting", "all_gather", "all_to_all", "current", "fill",
           "fit_tags", "from_positions", "gather", "gather_rows",
           "gather_tensor",
           "is_sharded", "make_ctx", "model_rows", "param_sharding_tree",
           "param_tags", "place", "place_tensor", "pmax", "positions",
           "psum", "reduce_grads", "replicated", "shard", "use",
           "working_copy"]
