"""spMTTKRP oracle and the one-mode step (port of ``repro.core.mttkrp``).

  * :func:`mttkrp_ref` — the COO oracle;
  * :func:`mode_step` — one mode's EC + Alg. 3 remap on a plain layout
    dict, through the engine's backend registry (for per-mode use; the
    rotation is ``engine.all_modes``);
  * :class:`MTTKRPExecutor` — a deprecated stateful shim over the engine,
    kept with the reference's surface:

  ===============================  =====================================
  old (stateful)                   new (functional)
  ===============================  =====================================
  ``MTTKRPExecutor(t, backend=b)`` ``s = engine.init(t,
                                   ExecutionConfig(backend=b))``
  ``exe.step(factors)``            ``out, s = engine.mttkrp(s, factors)``
  ``exe.all_modes(factors)``       ``outs, s = engine.all_modes(s,
                                   factors)``
  ``exe.layout["val"]`` etc.       ``s.val`` / ``s.idx`` / ``s.alpha``
  ``exe.current_mode``             ``s.mode``
  ===============================  =====================================
"""
from __future__ import annotations

import warnings
from typing import Sequence

import torch

from .flycoo import FlycooTensor


def mttkrp_ref(indices, values, factors, mode: int, dim: int):
    """out[i_d, r] = sum_nnz val * prod_{w != d} F_w[i_w, r], in canonical
    COO order with no FLYCOO machinery (``index_select`` + ``index_add_``)."""
    partials = values[:, None].to(torch.float32)
    for w, f in enumerate(factors):
        if w == mode:
            continue
        partials = partials * f.index_select(0, indices[:, w])
    out = torch.zeros((dim, partials.shape[1]), dtype=partials.dtype,
                      device=partials.device)
    return out.index_add_(0, indices[:, mode], partials)


def mode_step(layout, factors, row_relabel_d, *, mode: int, rows_pp: int,
              blocks_pp: int, block_p: int, kappa: int, next_size: int,
              backend: str = "torch", schedule: str = "rect",
              nblocks: int = -1):
    """One iteration of Alg. 5's mode loop: EC (Alg. 2) + remap (Alg. 3).

    ``layout`` holds ``val``/``idx``/``alpha`` (and, under
    ``schedule="compact"``, the plan's ``bpart`` descriptor); the backend
    runs on the layout's device. Returns ``(out_rel, next_layout)``:
    ``out_rel`` is the mode-``mode`` MTTKRP in relabeled row space (map
    back with ``row_relabel``), ``next_layout`` the mode-(d+1) layout of
    ``next_size`` slots.
    """
    from repro_torch.engine import ExecutionConfig, get_backend
    from repro_torch.engine.backends import compute_lrow
    from repro_torch.engine.state import ModeStatic
    from repro_torch.kernels.mttkrp import remap_plain

    plan = ModeStatic(kappa=kappa, rows_pp=rows_pp, blocks_pp=blocks_pp,
                      block_p=block_p, dim=int(row_relabel_d.shape[0]),
                      nblocks=nblocks, schedule=schedule)
    s = layout["val"].shape[0]
    if s != plan.padded_nnz:
        # The usual cause: a compact-schedule layout (build_flycoo's
        # default) driven with the rect-default arguments.
        raise ValueError(
            f"layout has {s} slots but the {schedule!r} schedule expects "
            f"{plan.padded_nnz}; for compact-schedule plans pass "
            "schedule='compact', nblocks=plan.nblocks and include "
            "layout['bpart'] (= plan.block_part)")
    if schedule == "compact" and layout.get("bpart") is None:
        raise KeyError(
            "compact-schedule layout needs the 'bpart' block->partition "
            "descriptor (plan.block_part)")
    config = ExecutionConfig(backend=backend,
                             device=str(layout["val"].device))
    alive = layout["alpha"][:, mode] >= 0
    lrow = compute_lrow(layout["idx"][:, mode], row_relabel_d, rows_pp, alive)
    ec_layout = {"val": layout["val"], "idx": layout["idx"], "lrow": lrow,
                 "bpart": layout.get("bpart")}
    out_rel = get_backend(config)(ec_layout, tuple(factors), mode, plan=plan,
                                  config=config)
    nxt = (mode + 1) % layout["idx"].shape[1]
    nval, nidx, nalpha = remap_plain(layout["val"], layout["idx"],
                                     layout["alpha"], smax=next_size,
                                     next_mode=nxt)
    return out_rel, {"val": nval, "idx": nidx, "alpha": nalpha}


class MTTKRPExecutor:
    """DEPRECATED stateful wrapper around :mod:`repro_torch.engine`: it
    threads an immutable ``EngineState`` through the functional API,
    works from any resident mode, and ``reset()`` returns it to the
    mode-0 layout."""

    def __init__(self, tensor: FlycooTensor, backend: str = "torch",
                 device: str | None = None):
        from repro_torch import engine
        from repro_torch.engine import ExecutionConfig

        warnings.warn(
            "MTTKRPExecutor is deprecated; use repro_torch.engine "
            "(init/mttkrp/all_modes) — see repro_torch.core.mttkrp "
            "docstring for the migration table", DeprecationWarning,
            stacklevel=2)
        self.tensor = tensor
        self.backend = backend
        self.plans = tensor.plans
        self.config = ExecutionConfig(backend=backend, device=device)
        self._engine = engine
        self._state = engine.init(tensor, self.config)
        # out_user[v] = out_rel[row_relabel[v]] (relabel is old -> new)
        self.row_relabel = list(self._state.relabel)

    @property
    def state(self):
        """The underlying functional ``EngineState`` (read-only)."""
        return self._state

    @property
    def current_mode(self) -> int:
        return self._state.mode

    @property
    def layout(self) -> dict:
        """Resident layout sliced to the current mode's padded size (the
        engine stores it padded to the uniform S_max)."""
        sd = self.plans[self._state.mode].padded_nnz
        return {"val": self._state.val[:sd], "idx": self._state.idx[:sd],
                "alpha": self._state.alpha[:sd]}

    def step(self, factors: Sequence[torch.Tensor]) -> torch.Tensor:
        """MTTKRP for the current mode; remap to the next; rotate."""
        out, self._state = self._engine.mttkrp(self._state, tuple(factors))
        return out

    def all_modes(self, factors: Sequence[torch.Tensor]) -> list:
        """All-modes MTTKRP from any current mode; outputs indexed by
        mode."""
        outs, self._state = self._engine.all_modes(self._state,
                                                   tuple(factors))
        return outs

    def reset(self) -> None:
        """Return to the mode-0 layout (re-derives the device state from
        the host tensor)."""
        self._state = self._engine.init(self.tensor, self.config)


__all__ = ["mttkrp_ref", "mode_step", "MTTKRPExecutor"]
