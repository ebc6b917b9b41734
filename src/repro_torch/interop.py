"""Carry state across from numpy: factors and a whole engine state.

The tests hand the JAX reference's leaves (as numpy arrays) to the port,
so both engines run on exactly the same layout and factors.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from repro_torch.engine.api import mode_sched_arrays
from repro_torch.engine.config import ExecutionConfig
from repro_torch.engine.state import EngineState, ModeSched, ModeStatic


def _to(a, dtype, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=dtype)).to(device)  # a copy


def factors_from_numpy(factors: Sequence, lam=None, device="cuda"):
    """Factor matrices (and optionally ``lam``) as f32 tensors on
    ``device``; returns the list, or ``(list, lam)`` when ``lam`` is
    given."""
    fs = [_to(f, np.float32, device) for f in factors]
    if lam is None:
        return fs
    return fs, _to(lam, np.float32, device)


def state_from_numpy(val, idx, alpha, relabel, sched, *, mode: int,
                     dims: Sequence[int], statics: Sequence,
                     config: ExecutionConfig | None = None) -> EngineState:
    """The port's ``EngineState`` from a reference state's leaves.

    ``val``/``idx``/``alpha`` are the S_max-padded layout, ``relabel`` the
    per-mode relabel tables, ``sched`` per mode the reference
    ``ModeSched`` fields ``(bpart, uidx, upos, nuniq)`` (the dedup tables
    ``None`` where absent), ``statics`` per mode the ``ModeStatic`` fields
    in order. The block-start table is derived from ``bpart`` here.
    """
    config = config or ExecutionConfig()
    dev = config.torch_device
    statics = tuple(ModeStatic(*s) for s in statics)
    tables = []
    for s, st in zip(sched, statics):
        bpart, *dedup = s
        dedup = None if dedup[0] is None else tuple(np.asarray(a)
                                                    for a in dedup)
        host = mode_sched_arrays(np.asarray(bpart), st.kappa, dedup)
        tables.append(ModeSched(*(None if a is None else _to(a, np.int32, dev)
                                  for a in host)))
    return EngineState(
        val=_to(val, np.float32, dev), idx=_to(idx, np.int32, dev),
        alpha=_to(alpha, np.int32, dev),
        relabel=tuple(_to(r, np.int32, dev) for r in relabel),
        sched=tuple(tables), mode=int(mode),
        dims=tuple(int(d) for d in dims), statics=statics, config=config)


__all__ = ["factors_from_numpy", "state_from_numpy"]
