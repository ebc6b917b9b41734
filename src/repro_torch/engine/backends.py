"""Backend registry for the spMTTKRP elementwise computation (Alg. 2/4).

The port of ``repro.engine.backends``. Every backend implements

    ec(layout, factors, mode, plan=ModeStatic, config=ExecutionConfig)
        -> out_rel  (plan.relabeled_rows, R) f32

where ``layout`` holds the mode-``mode`` kernel layout slices (``val``,
``idx``, ``lrow``, ``alpha``) plus the mode's ``ModeSched`` tables
(``bpart``, ``pstart`` and, for ``needs_dedup`` backends under the
compact schedule, ``uidx``/``upos``/``nuniq``). The result lives in
relabeled row space.

A backend may expose ``fused_remap``,

    fused_remap(layout, factors, mode, plan=, config=, smax=, next_mode=)
        -> (out_rel, (nval (smax,), nidx (smax, N), nalpha (smax, N)))

doing EC and the Alg. 3 remap in one kernel pass.

Registered backends (reference name in brackets):
  ==========  ============================================================
  torch       [xla] ``index_select`` gathers, ``index_add_`` segment sum
              over the relabeled rows (the default)
  ref         [ref] an alias of ``torch`` (eager PyTorch has no fusion
              for the two to differ in)
  cuda_fused  [pallas_fused] the hand-written Hopper kernels
              (``kernels/csrc/mttkrp_compact.cu``): one CTA per
              partition, dedup-staged factor rows, shared-memory
              accumulator; ``fused_remap`` adds the Alg. 3 scatter.
              Compact schedule only.
  ==========  ============================================================
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


def _require_compact(plan: ModeStatic):
    if plan.schedule != "compact":
        raise NotImplementedError(
            "cuda_fused runs the compact schedule only; the rect-schedule "
            "kernels are ROADMAP Queue B items 4-5 (mttkrp_fused_remap, "
            "mttkrp_fused_gather), not yet ported")


def _inputs(factors, mode: int):
    return tuple(f for w, f in enumerate(factors) if w != mode)


@register_backend("cuda_fused")
def ec_cuda_fused(layout, factors, mode: int, *, plan: ModeStatic,
                  config: ExecutionConfig) -> torch.Tensor:
    """The Hopper compact EC kernel (``mttkrp_fused_gather_compact``)."""
    _require_compact(plan)
    return kmt.mttkrp_fused_gather_compact(
        layout["val"], layout["lrow"], layout["upos"], layout["bpart"],
        layout["uidx"], layout["nuniq"], _inputs(factors, mode),
        kappa=plan.kappa, rows_pp=plan.rows_pp, nblocks=plan.nblocks,
        block_p=plan.block_p, pstart=layout["pstart"])


def _cuda_fused_remap(layout, factors, mode: int, *, plan: ModeStatic,
                      config: ExecutionConfig, smax: int, next_mode: int):
    """EC + Alg. 3 remap in ONE kernel pass
    (``mttkrp_fused_remap_compact``)."""
    _require_compact(plan)
    out_rel, nval, nidx, nalpha = kmt.mttkrp_fused_remap_compact(
        layout["val"], layout["idx"], layout["alpha"], layout["lrow"],
        layout["upos"], layout["bpart"], layout["uidx"], layout["nuniq"],
        _inputs(factors, mode), kappa=plan.kappa, rows_pp=plan.rows_pp,
        nblocks=plan.nblocks, block_p=plan.block_p, smax=smax,
        next_mode=next_mode, pstart=layout["pstart"])
    return out_rel, (nval, nidx, nalpha)


ec_cuda_fused.fused_remap = _cuda_fused_remap
# engine.init builds the dedup tables only for backends that consume them.
ec_cuda_fused.needs_dedup = True


__all__ = ["BACKENDS", "register_backend", "get_backend", "compute_lrow",
           "ec_torch", "ec_cuda_fused"]
