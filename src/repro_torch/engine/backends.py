"""Backend registry for the spMTTKRP elementwise computation (Alg. 2/4).

The port of ``repro.engine.backends``. Every backend implements

    ec(layout, factors, mode, plan=ModeStatic, config=ExecutionConfig)
        -> out_rel  (plan.relabeled_rows, R) f32

where ``layout`` holds the mode-``mode`` kernel layout slices (``val``,
``idx``, ``lrow``, ``alpha``) plus the mode's ``ModeSched`` tables
(``bpart``, ``pstart``; for ``needs_dedup`` backends under the compact
schedule ``uidx``/``upos``/``nuniq``; for ``takes_work`` backends the
kernels' work table ``work``/``wsum``). The result lives in relabeled
row space.

A backend may expose ``fused_remap``,

    fused_remap(layout, factors, mode, plan=, config=, smax=, next_mode=)
        -> (out_rel, (nval (smax,), nidx (smax, N), nalpha (smax, N)))

doing EC and the Alg. 3 remap in one kernel pass.

Registered backends (reference name in brackets); every backend serves
both block schedules (``plan.schedule``):
  ==========  ============================================================
  torch       [xla] ``index_select`` gathers, ``index_add_`` segment sum
              over the relabeled rows (the default)
  ref         [ref] an alias of ``torch`` (eager PyTorch has no fusion
              for the two to differ in)
  cuda        [pallas] the fusion baseline (paper Fig. 7): a PyTorch
              ``index_select`` + ``stack`` materializes the ``(S, N-1, R)``
              operand in device memory, then the hand-written Hopper
              kernel ``kernels/csrc/mttkrp_pregathered.cu`` reduces it
  cuda_fused  [pallas_fused] hand-written Hopper kernels that gather their
              factor rows into shared memory themselves; ``fused_remap``
              adds the Alg. 3 scatter. Compact:
              ``kernels/csrc/mttkrp_balanced.cu``, dedup-staged unique
              rows. Rect: ``kernels/csrc/mttkrp_gather.cu``, each alive
              slot's rows
  ==========  ============================================================

Every kernel of ``cuda`` and ``cuda_fused`` gives one CTA to each chunk
of at most ``cap`` blocks of a partition (the ``work`` table, built once
per mode by ``engine.init``; under rect it lists only each partition's
alive blocks) and keeps a shared-memory accumulator; a second pass sums
a split partition's partial tiles.
"""
from __future__ import annotations

from typing import Callable, Protocol

import torch

from repro_torch.kernels import mttkrp as kmt

from .config import ExecutionConfig
from .state import ModeStatic


class ECBackend(Protocol):
    def __call__(self, layout: dict, factors: tuple, mode: int, *,
                 plan: ModeStatic, config: ExecutionConfig
                 ) -> torch.Tensor: ...


BACKENDS: dict[str, ECBackend] = {}


def register_backend(name: str) -> Callable[[ECBackend], ECBackend]:
    """Decorator: add an elementwise-computation backend to the registry."""

    def deco(fn: ECBackend) -> ECBackend:
        BACKENDS[name] = fn
        return fn

    return deco


def get_backend(config_or_name: ExecutionConfig | str) -> ECBackend:
    name = (config_or_name.backend
            if isinstance(config_or_name, ExecutionConfig)
            else config_or_name)
    try:
        return BACKENDS[name]
    except KeyError:
        raise KeyError(
            f"unknown engine backend {name!r}; registered: "
            f"{sorted(BACKENDS)}") from None


# --------------------------------------------------------------------------
# Shared pieces.
# --------------------------------------------------------------------------
def compute_lrow(idx_d, row_relabel_d, rows_pp: int, alive):
    """Local row ids in the owning partition (relabel table lookup);
    -1 where not ``alive``. Pads hold in-bounds index 0."""
    rel = row_relabel_d.index_select(0, idx_d)
    return torch.where(alive, rel % rows_pp, -1).to(torch.int32)


def _gather_partials(layout, factors, mode: int, accum_dtype):
    """ell(r) = val * prod_{w != d} Y_w[c_w, r]  (Alg. 2 lines 7-13).

    Pad slots are masked via ``lrow == -1`` rather than relying on their
    ``val`` being zero: pads carry in-bounds ``idx = 0``."""
    val, idx = layout["val"], layout["idx"]
    partials = val[:, None].to(accum_dtype)
    for w, f in enumerate(factors):
        if w == mode:
            continue
        partials = partials * f.index_select(0, idx[:, w]).to(accum_dtype)
    return torch.where((layout["lrow"] >= 0)[:, None], partials, 0)


def _segment_ids(layout, plan: ModeStatic):
    """Global relabeled row per slot; pads (lrow == -1) -> dump row 0.

    The owning partition is a fixed slot stride under ``rect`` and the
    block -> partition descriptor lookup under ``compact``."""
    slot = torch.arange(layout["val"].shape[0], device=layout["val"].device)
    if plan.schedule == "compact":
        part = layout["bpart"].index_select(0, slot // plan.block_p).long()
    else:
        part = slot // (plan.blocks_pp * plan.block_p)
    lrow = layout["lrow"].long()
    return torch.where(lrow < 0, 0, part * plan.rows_pp + lrow)


def _segment_sum(partials, gid, rows: int):
    out = torch.zeros((rows, partials.shape[1]), dtype=partials.dtype,
                      device=partials.device)
    return out.index_add_(0, gid, partials)


# --------------------------------------------------------------------------
# Backends.
# --------------------------------------------------------------------------
@register_backend("torch")
def ec_torch(layout, factors, mode: int, *, plan: ModeStatic,
             config: ExecutionConfig) -> torch.Tensor:
    """Gather-multiply, then ``index_add_`` into the relabeled rows."""
    partials = _gather_partials(layout, factors, mode, config.accum_dtype())
    return _segment_sum(partials, _segment_ids(layout, plan),
                        plan.relabeled_rows)


# The reference's ``ref`` backend differs from ``xla`` only in what XLA may
# fuse; eager PyTorch runs the same ops either way, so it is an alias.
BACKENDS["ref"] = ec_torch


def _inputs(factors, mode: int):
    return tuple(f for w, f in enumerate(factors) if w != mode)


def pregather(idx, factors, mode: int) -> torch.Tensor:
    """The ``(S, N-1, R)`` operand of the ``cuda`` backend: each slot's
    input-factor rows, gathered by PyTorch into device memory (as the
    reference gathers it in XLA). Pads gather in-bounds row 0."""
    return torch.stack([f.index_select(0, idx[:, w])
                        for w, f in enumerate(factors) if w != mode], dim=1)


@register_backend("cuda")
def ec_cuda(layout, factors, mode: int, *, plan: ModeStatic,
            config: ExecutionConfig) -> torch.Tensor:
    """The pre-gathered baseline: :func:`pregather`, then
    ``mttkrp_fused_compact`` / ``mttkrp_fused`` (rect)."""
    gathered = pregather(layout["idx"], factors, mode)
    if plan.schedule == "compact":
        return kmt.mttkrp_fused_compact(
            gathered, layout["val"], layout["lrow"], layout["bpart"],
            kappa=plan.kappa, rows_pp=plan.rows_pp, nblocks=plan.nblocks,
            block_p=plan.block_p, pstart=layout.get("pstart"),
            work=_work(layout))
    return kmt.mttkrp_fused(
        gathered, layout["val"], layout["lrow"], kappa=plan.kappa,
        rows_pp=plan.rows_pp, blocks_pp=plan.blocks_pp, block_p=plan.block_p,
        pstart=layout.get("pstart"), work=_work(layout))


# engine.init builds each mode's work table for backends whose kernels
# take one.
ec_cuda.takes_work = True


def _work(layout):
    """The mode's :class:`~repro_torch.kernels.mttkrp.WorkTable`, if the
    layout carries one (``engine.init`` builds it for ``takes_work``
    backends)."""
    if layout.get("work") is None:
        return None
    return kmt.WorkTable(layout["work"], layout["wsum"])


def fused_lidx(idx, mode: int) -> torch.Tensor:
    """``(N-1, S)`` int32 row of each input factor per slot (rect); pads
    hold in-bounds 0 and are skipped by the kernel (lrow < 0)."""
    return torch.stack([idx[:, w] for w in range(idx.shape[1])
                        if w != mode]).contiguous()


@register_backend("cuda_fused")
def ec_cuda_fused(layout, factors, mode: int, *, plan: ModeStatic,
                  config: ExecutionConfig) -> torch.Tensor:
    """The in-kernel gather EC: ``mttkrp_fused_gather_compact`` (dedup-
    staged) or ``mttkrp_fused_gather`` (rect), on the ``work`` table."""
    inputs = _inputs(factors, mode)
    if plan.schedule == "compact":
        return kmt.mttkrp_fused_gather_compact(
            layout["val"], layout["lrow"], layout["upos"], layout["bpart"],
            layout["uidx"], layout["nuniq"], inputs, kappa=plan.kappa,
            rows_pp=plan.rows_pp, nblocks=plan.nblocks,
            block_p=plan.block_p, pstart=layout.get("pstart"),
            work=_work(layout))
    return kmt.mttkrp_fused_gather(
        layout["val"], layout["lrow"], fused_lidx(layout["idx"], mode),
        inputs, kappa=plan.kappa, rows_pp=plan.rows_pp,
        blocks_pp=plan.blocks_pp, block_p=plan.block_p,
        pstart=layout.get("pstart"), work=_work(layout))


def _cuda_fused_remap(layout, factors, mode: int, *, plan: ModeStatic,
                      config: ExecutionConfig, smax: int, next_mode: int,
                      out=None):
    """EC + Alg. 3 remap in ONE kernel pass (``mttkrp_fused_remap_compact``
    or, under rect, ``mttkrp_fused_remap``); the next layout into ``out``
    when given."""
    inputs = _inputs(factors, mode)
    if plan.schedule == "compact":
        out_rel, nval, nidx, nalpha = kmt.mttkrp_fused_remap_compact(
            layout["val"], layout["idx"], layout["alpha"], layout["lrow"],
            layout["upos"], layout["bpart"], layout["uidx"], layout["nuniq"],
            inputs, kappa=plan.kappa, rows_pp=plan.rows_pp,
            nblocks=plan.nblocks, block_p=plan.block_p, smax=smax,
            next_mode=next_mode, pstart=layout.get("pstart"),
            work=_work(layout), out=out)
    else:
        out_rel, nval, nidx, nalpha = kmt.mttkrp_fused_remap(
            layout["val"], layout["idx"], layout["alpha"], layout["lrow"],
            fused_lidx(layout["idx"], mode), inputs, kappa=plan.kappa,
            rows_pp=plan.rows_pp, blocks_pp=plan.blocks_pp,
            block_p=plan.block_p, smax=smax, next_mode=next_mode,
            pstart=layout.get("pstart"), work=_work(layout), out=out)
    return out_rel, (nval, nidx, nalpha)


ec_cuda_fused.fused_remap = _cuda_fused_remap
# engine.init builds the dedup tables only for backends that consume them.
ec_cuda_fused.needs_dedup = True
ec_cuda_fused.takes_work = True


__all__ = ["BACKENDS", "register_backend", "get_backend", "compute_lrow",
           "ec_torch", "ec_cuda", "ec_cuda_fused", "pregather",
           "fused_lidx"]
