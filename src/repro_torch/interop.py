"""Carry state across from numpy: factors, a whole engine state, and a
model's parameters.

The tests hand the JAX reference's leaves (as numpy arrays) to the port,
so both sides run on exactly the same layout, factors and weights.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from repro_torch.engine.api import mode_sched_arrays, mode_work, place_sched
from repro_torch.engine.backends import get_backend
from repro_torch.engine.config import ExecutionConfig
from repro_torch.engine.state import EngineState, ModeStatic


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


def _stacked(key: str) -> bool:
    """Whether a top-level key of a reference params tree holds stacked
    layers: a decoder stage (``stage{i}``) or the encoder (``enc``)."""
    return key.startswith("stage") or key == "enc"


def model_params_from_numpy(tree, cfg, device="cuda"):
    """The port's ``Model`` from the reference's ``init_model`` pytree
    with numpy leaves: each stage's stacked blocks
    (``tree["stage{i}"]["b{j}"][name][c]``) are unstacked into the layers
    in order, and the encoder's (``tree["enc"]["b0"][name][c]``) into
    ``enc``; every other leaf is copied as it is (dtype kept): ``embed``,
    ``head``, ``ln_f``, ``enc_ln_f``, or a CPD model's
    ``embed_cpd/{A,B,C}``."""
    from repro_torch.models.common import device_of
    from repro_torch.models.transformer import Model

    dev = device_of(device)

    def conv(node, c=None):
        if isinstance(node, dict):
            return {k: conv(v, c) for k, v in node.items()}
        a = np.asarray(node) if c is None else np.asarray(node)[c]
        return torch.from_numpy(np.array(a)).to(dev)  # a copy

    layers = []
    for i, (pat, rep) in enumerate(cfg.stages()):
        for c in range(rep):
            layers.extend(conv(tree[f"stage{i}"][f"b{j}"], c)
                          for j in range(len(pat)))
    rest = {k: conv(v) for k, v in tree.items() if not _stacked(k)}
    if "enc" in tree:
        rest["enc"] = [conv(tree["enc"]["b0"], c)
                       for c in range(cfg.n_enc_layers)]
    return Model(cfg, {**rest, "layers": layers})


def train_state_from_numpy(params_tree, opt_tree, step, cfg, device="cuda"):
    """The port's train state (``training.init_state``'s layout) from a
    reference train state's ``params`` and ``opt`` trees with numpy
    leaves and its ``step``: every leaf under a ``stage{i}`` key (stacked
    over the stage's cycles) or the ``enc`` key (over the encoder's
    layers) becomes the list of its slices, as
    ``model_params_from_numpy`` unstacks the layers; AdamW's ``m``/``v``
    follow the params, and Adafactor's factored ``r``/``c`` of a stacked
    leaf of rank >= 3 are unstacked alike (a stacked rank-2 leaf's ``c``
    spans its layers and stays as it is, as does its ``r``). ``cfg``,
    where given, must have one stage for each ``stage{i}`` of the tree
    (``None`` takes any tree, e.g. an optimizer test's)."""
    from repro_torch.models.common import device_of

    dev = device_of(device)
    if cfg is not None:
        have = sorted(k for k in params_tree if k.startswith("stage"))
        want = sorted(f"stage{i}" for i in range(len(cfg.stages())))
        if have != want:
            raise ValueError(f"train_state_from_numpy: the tree has stages "
                             f"{have}, {cfg.name} has {want}")

    def tensor(a):
        return torch.from_numpy(np.array(a)).to(dev)  # a copy

    def conv(node, stacked=False):
        if isinstance(node, dict):
            return {k: conv(v, stacked or _stacked(k))
                    for k, v in node.items()}
        a = np.asarray(node)
        return [tensor(x) for x in a] if stacked else tensor(a)

    def factored(f, p, stacked=False):
        if isinstance(p, dict):
            return {k: factored(f[k], p[k], stacked or _stacked(k))
                    for k in p}
        if stacked and np.asarray(p).ndim >= 3:
            return {k: [tensor(x) for x in np.asarray(v)]
                    for k, v in f.items()}
        return {k: tensor(v) for k, v in f.items()}

    opt = {"step": torch.tensor(int(np.asarray(opt_tree["step"])),
                                dtype=torch.int32)}
    if "f" in opt_tree:
        opt["f"] = factored(opt_tree["f"], params_tree)
    else:
        opt["m"], opt["v"] = conv(opt_tree["m"]), conv(opt_tree["v"])
    return {"params": conv(params_tree), "opt": opt,
            "step": torch.tensor(int(np.asarray(step)), dtype=torch.int32)}


def state_from_numpy(val, idx, alpha, relabel, sched, *, mode: int,
                     dims: Sequence[int], statics: Sequence,
                     config: ExecutionConfig | None = None,
                     plans: Sequence | None = None) -> EngineState:
    """The port's ``EngineState`` from a reference state's leaves.

    ``val``/``idx``/``alpha`` are the S_max-padded layout, ``relabel`` the
    per-mode relabel tables, ``sched`` per mode the reference
    ``ModeSched`` fields ``(bpart, uidx, upos, nuniq)`` (the dedup tables
    ``None`` where absent), ``statics`` per mode the ``ModeStatic`` fields
    in order. The block-start table is derived from ``bpart`` here. With
    ``plans`` (the reference tensor's ``ModePlan`` list, which carries
    ``part_nnz`` and the alive slots) and a backend whose kernels take a
    work table, each mode's table is the one ``engine.init`` builds
    (``engine.api.mode_work``), under either schedule; without them, the
    dedup tables get the balanced kernels' full-range table and other
    kernels derive theirs from ``pstart`` at each call.
    """
    config = config or ExecutionConfig()
    dev = config.torch_device
    statics = tuple(ModeStatic(*s) for s in statics)
    takes_work = getattr(get_backend(config), "takes_work", False)
    tables = []
    for d, (s, st) in enumerate(zip(sched, statics)):
        bpart, *dedup = s
        dedup = None if dedup[0] is None else tuple(np.asarray(a)
                                                    for a in dedup)
        work = (mode_work(plans[d]) if plans is not None and takes_work
                else None)
        tables.append(place_sched(
            mode_sched_arrays(np.asarray(bpart), st.kappa, dedup, work),
            dev))
    return EngineState(
        val=_to(val, np.float32, dev), idx=_to(idx, np.int32, dev),
        alpha=_to(alpha, np.int32, dev),
        relabel=tuple(_to(r, np.int32, dev) for r in relabel),
        sched=tuple(tables), mode=int(mode),
        dims=tuple(int(d) for d in dims), statics=statics, config=config)


def dist_state_from_numpy(val, idx, alpha, relabel, sched, *, mode: int,
                          dims: Sequence[int], statics: Sequence,
                          lstatics: Sequence, schedule, plans: Sequence,
                          mesh, dist=None,
                          config: ExecutionConfig | None = None):
    """The port's ``DistState`` on ``mesh`` from a reference
    ``DistState``'s leaves, gathered to numpy.

    ``val``/``idx``/``alpha`` are the global device-major layout,
    ``relabel`` the per-mode relabel tables, ``sched`` per mode the
    device-major ``(bpart, uidx, upos, nuniq)``, ``statics`` and
    ``lstatics`` per mode the ``ModeStatic`` fields in order, ``schedule``
    the reference's ``ExchangeSchedule`` (or its ``(n_dev, hops)``).
    ``plans`` (the reference tensor's ``ModePlan`` list) give each
    shard's real block count (``engine.dist._block_geometry`` of the
    plan's ``block_part``), from which, with the alive slots of
    ``alpha``, each shard's work table is built as ``shard_state`` builds
    it (``engine.dist.assemble``)."""
    from repro_torch.engine.dist import (DistConfig, ExchangeSchedule,
                                         _block_geometry, assemble)

    config = config or ExecutionConfig()
    dist = dist or DistConfig()
    statics = tuple(ModeStatic(*s) for s in statics)
    lstatics = tuple(ModeStatic(*s) for s in lstatics)
    n_dev, hops = schedule
    schedule = ExchangeSchedule(
        n_dev=int(n_dev), hops=tuple(tuple(int(c) for c in h)
                                     for h in hops))
    gsched = []
    for s in sched:
        bpart, uidx, upos, nuniq = (None if a is None else np.asarray(a)
                                    for a in s)
        gsched.append({"bpart": bpart, "uidx": uidx, "upos": upos,
                       "nuniq": nuniq})
    per_dev = [_block_geometry(st, np.asarray(p.block_part), int(n_dev))[1]
               for st, p in zip(statics, plans)]
    return assemble(
        np.asarray(val), np.asarray(idx), np.asarray(alpha),
        [np.asarray(r) for r in relabel], gsched, mode=mode, dims=dims,
        statics=statics, lstatics=lstatics, blocks_per_dev=per_dev,
        config=config, dist=dist, schedule=schedule, mesh=mesh)


__all__ = ["factors_from_numpy", "model_params_from_numpy",
           "train_state_from_numpy", "state_from_numpy",
           "dist_state_from_numpy"]
