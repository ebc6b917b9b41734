"""The port's spMTTKRP engine: ``init`` / ``mttkrp`` / ``all_modes``.

The paper's Alg. 5 as functions over an immutable
:class:`~repro_torch.engine.state.EngineState`, as in
``repro.engine.api``:

  init(tensor, config)            -> EngineState           (host, once)
  mttkrp(state, factors[, mode])  -> (out, EngineState)    (one mode + remap)
  all_modes(state, factors)       -> (outs, EngineState)   (full rotation)

The reference runs the rotation as one jitted ``lax.scan``; PyTorch runs
eagerly, so here it is a plain Python loop over the modes (a CUDA graph of
the rotation comes with a later slice). The rotation may start at any
resident mode, and the optional ``fold`` hook runs after each mode's
MTTKRP with that mode's output — how CPD-ALS updates the factors
Gauss-Seidel style inside the sweep.
"""
from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
import torch

from repro_torch.kernels.mttkrp import block_starts, remap_plain
from repro_torch.obs.metrics import REGISTRY
from repro_torch.obs.trace import span

from .backends import compute_lrow, get_backend
from .config import ExecutionConfig
from .state import EngineState, ModeSched, mode_static_from_plan

# fold(mode, out_d, factors, carry) -> (factors, carry)
FoldFn = Callable[[int, torch.Tensor, tuple, object], tuple]

DISPATCH_COUNTS = REGISTRY.counter(
    "engine_dispatches", "engine calls issued per entry point")


def reset_counters() -> None:
    DISPATCH_COUNTS.clear()


# --------------------------------------------------------------------------
# init
# --------------------------------------------------------------------------
def init(tensor, config: ExecutionConfig | None = None,
         start_mode: int = 0) -> EngineState:
    """Build the device-resident engine state for ``tensor``.

    ``tensor`` is a prebuilt :class:`~repro_torch.core.flycoo.FlycooTensor`
    (its plans govern the layout) or a raw COO triple ``(indices, values,
    dims)`` — then the plans are built here under ``config``'s kappa
    policy. The state holds the ``start_mode`` layout, padded to the
    uniform slot count ``S_max``, on ``config.torch_device``.
    """
    config = config or ExecutionConfig()
    dev = config.torch_device
    with span("engine.init", start_mode=start_mode) as sp:
        tensor = _as_flycoo(tensor, config)
        n = tensor.nmodes
        if not 0 <= start_mode < n:
            raise ValueError(
                f"start_mode {start_mode} out of range for {n} modes")
        statics = tuple(mode_static_from_plan(p) for p in tensor.plans)
        smax = max(s.padded_nnz for s in statics)
        sp.set("nmodes", n)
        sp.set("smax", smax)

        with span("engine.host_layout", mode=start_mode):
            base = tensor.plans[start_mode]
            val = np.zeros(smax, dtype=np.float32)
            idx = np.zeros((smax, n), dtype=np.int32)
            alpha = np.full((smax, n), -1, dtype=np.int32)
            val[base.slot_of_elem] = tensor.values
            idx[base.slot_of_elem] = tensor.indices
            for d in range(n):
                alpha[base.slot_of_elem, d] = \
                    tensor.plans[d].slot_of_elem.astype(np.int32)

        with span("engine.sched_tables"):
            sched = tuple(_mode_sched(tensor, d, config) for d in range(n))
        with span("engine.device_place"):
            return EngineState(
                val=torch.from_numpy(val).to(dev),
                idx=torch.from_numpy(idx).to(dev),
                alpha=torch.from_numpy(alpha).to(dev),
                relabel=tuple(torch.from_numpy(p.row_relabel).to(dev)
                              for p in tensor.plans),
                sched=tuple(ModeSched(*(None if a is None
                                        else torch.from_numpy(a).to(dev)
                                        for a in s)) for s in sched),
                mode=int(start_mode),
                dims=tensor.dims,
                statics=statics,
                config=config,
            )


def mode_sched_arrays(bpart, kappa: int, dedup=None):
    """Host ``ModeSched`` fields as numpy arrays: ``bpart``, its
    ``(kappa+1,)`` block-start table, and the dedup tables (or ``None``)."""
    bpart = np.array(bpart, dtype=np.int32)   # a writable copy
    pstart = block_starts(torch.from_numpy(bpart), kappa).numpy()
    uidx, upos, nuniq = dedup if dedup is not None else (None,) * 3
    return ModeSched(bpart=bpart, pstart=pstart, uidx=uidx, upos=upos,
                     nuniq=nuniq)


def _mode_sched(tensor, d: int, config: ExecutionConfig) -> ModeSched:
    """Per-mode schedule tables (numpy): the block -> partition descriptor
    and its block-start table always; the dedup tables only when the
    backend consumes them (``needs_dedup``) under the compact schedule;
    ``config.dedup=False`` installs the trivial tables."""
    plan = tensor.plans[d]
    dedup = None
    if plan.schedule == "compact" and \
            getattr(get_backend(config), "needs_dedup", False):
        dedup = (tensor.dedup_tables(d) if config.dedup
                 else tensor.trivial_dedup_tables(d))
    return mode_sched_arrays(plan.block_part, plan.kappa, dedup)


def _as_flycoo(tensor, config: ExecutionConfig):
    from repro_torch.core.flycoo import FlycooTensor, build_flycoo

    if isinstance(tensor, FlycooTensor):
        return tensor
    indices, values, dims = tensor
    n = len(dims)
    return build_flycoo(indices, values, dims,
                        kappa=[config.kappa_for(int(i), n) for i in dims],
                        block_p=config.block_p, schedule=config.schedule)


# --------------------------------------------------------------------------
# One mode: EC (Alg. 2/4) + dynamic remap (Alg. 3).
# --------------------------------------------------------------------------
def mode_layout(state: EngineState, layout3, d: int) -> dict:
    """The backend ``layout`` dict for mode ``d``: the resident
    ``layout3 = (val, idx, alpha)`` cut to ``S_d`` slots, the local output
    rows ``lrow`` (-1 in pads) and the mode's schedule tables."""
    plan = state.statics[d]
    sd = plan.padded_nnz
    val, idx, alpha = layout3
    v, ix, al = val[:sd], idx[:sd], alpha[:sd]
    lrow = compute_lrow(ix[:, d], state.relabel[d], plan.rows_pp,
                        al[:, d] >= 0)
    return {"val": v, "idx": ix, "alpha": al, "lrow": lrow,
            **state.sched[d]._asdict()}


def _mode_step(state: EngineState, layout3, factors, d: int):
    """EC for mode ``d`` on the resident ``layout3 = (val, idx, alpha)``
    and the remap into the mode-``d+1`` layout. Returns ``(out (I_d, R)
    in user row space, next layout3)``."""
    plan, config, smax = state.statics[d], state.config, state.smax
    nxt = (d + 1) % state.nmodes
    backend = get_backend(config)
    fused = (getattr(backend, "fused_remap", None)
             if config.fuse_remap else None)

    layout = mode_layout(state, layout3, d)
    if fused is not None:
        out_rel, nl = fused(layout, tuple(factors), d, plan=plan,
                            config=config, smax=smax, next_mode=nxt)
    else:
        out_rel = backend(layout, tuple(factors), d, plan=plan,
                          config=config)
        # Alg. 3: conflict-free copy into the mode-(d+1) layout.
        nl = remap_plain(layout["val"], layout["idx"], layout["alpha"],
                         smax=smax, next_mode=nxt)
    out = out_rel.index_select(0, state.relabel[d])  # un-relabel -> (I_d, R)
    return out, nl


# --------------------------------------------------------------------------
# mttkrp / all_modes
# --------------------------------------------------------------------------
def mttkrp(state: EngineState, factors: Sequence[torch.Tensor],
           mode: int | None = None):
    """MTTKRP for the resident mode + remap to the next; returns
    ``(out, next_state)``. ``mode`` (optional) must name the resident
    mode."""
    if mode is not None and mode != state.mode:
        raise ValueError(
            f"state holds the mode-{state.mode} layout; cannot compute "
            f"mode {mode} without rotating (use all_modes or step to it)")
    d = state.mode
    DISPATCH_COUNTS["mttkrp"] += 1
    with span("engine.dispatch", kind="mttkrp", mode=d):
        out, (nval, nidx, nalpha) = _mode_step(
            state, (state.val, state.idx, state.alpha), tuple(factors), d)
    return out, state.replace(val=nval, idx=nidx, alpha=nalpha,
                              mode=(d + 1) % state.nmodes)


def all_modes(state: EngineState, factors: Sequence[torch.Tensor], *,
              fold: FoldFn | None = None, carry=None):
    """spMTTKRP along all N modes, starting from the resident
    ``state.mode``; the alpha tables rotate the layout back to it by the
    end. ``outs[d]`` is the mode-``d`` MTTKRP of shape ``(dims[d], R)``.

    Without ``fold``: returns ``(outs, next_state)``.
    With ``fold``: returns ``(outs, next_state, factors, carry)`` — the
    hook runs right after each mode's output.
    """
    n, m0 = state.nmodes, state.mode
    DISPATCH_COUNTS["all_modes"] += 1
    factors = tuple(factors)
    outs: list = [None] * n
    layout3 = (state.val, state.idx, state.alpha)
    with span("engine.dispatch", kind="all_modes", start_mode=m0):
        for i in range(n):
            d = (m0 + i) % n
            outs[d], layout3 = _mode_step(state, layout3, factors, d)
            if fold is not None:
                factors, carry = fold(d, outs[d], factors, carry)
    nval, nidx, nalpha = layout3
    next_state = state.replace(val=nval, idx=nidx, alpha=nalpha)
    if fold is None:
        return outs, next_state
    return outs, next_state, list(factors), carry


__all__ = ["init", "mttkrp", "all_modes", "reset_counters", "mode_layout",
           "mode_sched_arrays", "DISPATCH_COUNTS", "FoldFn"]
