"""Optimizers (AdamW, Adafactor), global-norm clipping, LR schedules: the
reference's ``training/optimizer.py`` in PyTorch.

Own implementation, not ``torch.optim``: each update is the reference's
float32 formula. The scalars of a step (the schedule, the bias
corrections, Adafactor's beta) are computed on the host in float32, as
the reference computes them on its device, so a step needs no
host-device sync. The state is a tree of :mod:`.tree` (a list leaf is a
stacked leaf of the reference); rank rules read the stacked rank, so
norm scales and biases inside the layers take weight decay as in the
reference, and Adafactor factors a stacked 1-d leaf over its layers.

Unlike the reference's, ``update`` writes the new parameters and moments
into the tensors it is given (returning the same trees) and
``clip_by_global_norm`` scales the gradients in place: a step at full
width then holds one copy of each.

Over a mesh (leaves that are ``sharding.Sharded``) AdamW updates each
piece on its device; the global norm counts each element once (one
piece a block, replicas skipped), summed on the first piece's device;
Adafactor, whose factored statistics span the whole leaf and are
replicated, gathers a leaf at a time onto the mesh's first device,
updates it there and copies the result back into every piece.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import sharding
from .tree import each, leaves, rank, tree_map

_F32 = np.float32


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    name: str = "adamw"            # adamw | adafactor
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    state_dtype: str = "float32"   # moment dtype (bf16 for the giants)


def schedule(cfg: OptimizerConfig, step) -> float:
    """Linear warmup -> cosine decay to 10%, in float32 (the value is a
    float32 number returned as a Python float)."""
    s = _F32(int(step))
    warm = min(s / _F32(max(cfg.warmup_steps, 1)), _F32(1.0))
    frac = np.clip((s - _F32(cfg.warmup_steps))
                   / _F32(max(cfg.total_steps - cfg.warmup_steps, 1)),
                   _F32(0.0), _F32(1.0))
    cos = _F32(0.1) + _F32(0.45) * (_F32(1.0) + np.cos(_F32(np.pi) * frac))
    return float(_F32(cfg.lr) * warm * cos)


_SUMSQ_CHUNK = 1 << 24


def _sumsq(x) -> torch.Tensor:
    """Sum of squares in float32, over pieces of at most 2^24 elements in
    order, so that a large leaf needs no leaf-sized temporary
    (``torch.linalg.vector_norm`` would need none either, but on the CPU
    its float32 sum drifts by ~1e-5 over 65k elements)."""
    flat = x.reshape(-1)
    total = None
    for lo in range(0, flat.numel(), _SUMSQ_CHUNK):
        part = flat[lo:lo + _SUMSQ_CHUNK].float().square().sum()
        total = part if total is None else total + part
    return total


def _blocks(x) -> list[torch.Tensor]:
    """Each element of a leaf tensor once: the tensor, or one piece a
    block of a sharded one."""
    if isinstance(x, sharding.Sharded):
        return [x.pieces[k] for k in x.blocks().values()]
    return [x]


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves (in :func:`~.tree.leaves` order) of each
    leaf's sum of squares, float32, on the first leaf's device."""
    total = None
    for x in leaves(tree):
        for part in _blocks(x):
            sq = _sumsq(part)
            total = sq if total is None else total + sq.to(total.device)
    return total.sqrt()


def clip_by_global_norm(grads, max_norm: float):
    """Scales ``grads`` in place by ``min(1, max_norm / (norm + 1e-9))``;
    returns ``(grads, norm)``."""
    g = global_norm(grads)
    scale = torch.clamp(max_norm / (g + 1e-9), max=1.0)
    for x in leaves(grads):
        for part in (x.pieces.values() if isinstance(x, sharding.Sharded)
                     else (x,)):
            part.mul_(scale.to(part.device, part.dtype))
    return grads, g


# ------------------------------------------------------------------- adamw
def adamw_init(params, cfg: OptimizerConfig):
    dt = getattr(torch, cfg.state_dtype)

    def zeros(leaf):
        return each(lambda p: torch.zeros(p.shape, dtype=dt, device=p.device),
                    leaf)

    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32)}


def _adamw_leaf(g, m, v, p, decay, lr, bc1, bc2, cfg):
    gf = g.float()
    mf = m if m.dtype == torch.float32 else m.float()
    vf = v if v.dtype == torch.float32 else v.float()
    mf.mul_(cfg.b1).add_(gf, alpha=1 - cfg.b1)
    vf.mul_(cfg.b2).addcmul_(gf, gf, value=1 - cfg.b2)
    delta = mf / bc1
    delta.div_((vf / bc2).sqrt_().add_(cfg.eps))
    if decay:  # no decay on norms/biases/1-d tables (stacked rank)
        delta.add_(p.float(), alpha=cfg.weight_decay)
    if p.dtype == torch.float32:
        p.sub_(delta.mul_(lr))
    else:
        p.copy_(p.float().sub_(delta.mul_(lr)))
    if mf is not m:
        m.copy_(mf)
    if vf is not v:
        v.copy_(vf)


def adamw_update(grads, opt_state, params, cfg: OptimizerConfig):
    step = opt_state["step"] + 1
    lr = schedule(cfg, step)
    t = _F32(int(step))
    bc1 = float(_F32(1.0) - _F32(cfg.b1) ** t)
    bc2 = float(_F32(1.0) - _F32(cfg.b2) ** t)

    def upd(g, m, v, p):
        decay = rank(p) >= 2
        each(lambda *a: _adamw_leaf(*a, decay, lr, bc1, bc2, cfg),
             g, m, v, p)

    tree_map(upd, grads, opt_state["m"], opt_state["v"], params)
    return params, {"m": opt_state["m"], "v": opt_state["v"],
                    "step": step}, lr


# ---------------------------------------------------------------- adafactor
def _stack(leaf):
    """A stacked leaf of rank < 2 as one tensor (the reference's layout),
    else ``None``: Adafactor's factoring of such a leaf mixes its
    layers."""
    if isinstance(leaf, list) and leaf[0].dim() < 1:
        raise ValueError("a stacked 0-d leaf")
    if isinstance(leaf, list) and leaf[0].dim() == 1:
        return torch.stack(leaf)
    return None


def adafactor_init(params, cfg: OptimizerConfig):
    def state(p):
        if rank(p) >= 2:
            return {"r": torch.zeros(p.shape[:-1], dtype=torch.float32,
                                     device=p.device),
                    "c": torch.zeros(p.shape[:-2] + p.shape[-1:],
                                     dtype=torch.float32, device=p.device)}
        return {"v": torch.zeros(p.shape, dtype=torch.float32,
                                 device=p.device)}

    def rows_cols(leaf):
        stacked = _stack(leaf)
        if stacked is not None:
            return state(stacked)
        if isinstance(leaf, list):
            per = [state(p) for p in leaf]
            return {k: [s[k] for s in per] for k in per[0]}
        return state(leaf)

    return {"f": tree_map(rows_cols, params),
            "step": torch.zeros((), dtype=torch.int32)}


def _adafactor_leaf(g, f, p, lr, beta, cfg):
    """The reference's update of one (stacked) leaf ``p`` of rank >= 1:
    returns the new ``p`` and writes ``f``'s new statistics into it. The
    reference's operations in its order, each leaf-sized result written
    in place where the next one consumes it, so that a leaf of rank >= 2
    needs two leaf-sized temporaries at a time (a tied embedding of
    12.6 GB, command-r's, is updated on a card that holds little
    more)."""
    gf = g.float()
    g2 = gf * gf
    g2.add_(1e-30)
    if p.dim() >= 2:
        r = beta * f["r"] + (1 - beta) * g2.mean(-1)
        c = beta * f["c"] + (1 - beta) * g2.mean(-2)
        del g2
        denom = r[..., None] * c[..., None, :]
        denom.div_(r.mean(-1, keepdim=True)[..., None] + 1e-30).sqrt_()
        f["r"].copy_(r)
        f["c"].copy_(c)
    else:
        v = beta * f["v"] + (1 - beta) * g2
        denom = torch.sqrt(v)
        f["v"].copy_(v)
    delta = torch.div(gf, denom.add_(1e-30), out=denom)
    if p.dim() >= 2:
        decay = p.float() * cfg.weight_decay
        delta.add_(decay)
        del decay
    return torch.sub(p.float(), delta.mul_(lr), out=delta)


def adafactor_update(grads, opt_state, params, cfg: OptimizerConfig):
    step = opt_state["step"] + 1
    lr = schedule(cfg, step)
    beta = float(_F32(1.0) - (_F32(int(step)) + _F32(1.0)) ** _F32(-0.8))

    def upd(g, f, p):
        if sharding.is_sharded(p):  # a leaf at a time, whole, then back
            pw, fw = sharding.gather(p), sharding.gather(f)
            upd(sharding.gather(g), fw, pw)
            for src, dst in ((pw, p), (fw, f)):
                for a, b in zip(leaves(src), leaves(dst)):
                    sharding.fill(b, a)
            return
        stacked = _stack(p)
        if stacked is not None:
            new = _adafactor_leaf(torch.stack(g), f, stacked, lr, beta, cfg)
            for i, x in enumerate(p):
                x.copy_(new[i])
        elif isinstance(p, list):
            for i, x in enumerate(p):
                fi = {k: f[k][i] for k in f}
                x.copy_(_adafactor_leaf(g[i], fi, x, lr, beta, cfg))
        else:
            p.copy_(_adafactor_leaf(g, f, p, lr, beta, cfg))

    def walk(g, f, p):
        if isinstance(p, dict):
            for k in p:
                walk(g[k], f[k], p[k])
        else:
            upd(g, f, p)

    walk(grads, opt_state["f"], params)
    return params, {"f": opt_state["f"], "step": step}, lr


def init(params, cfg: OptimizerConfig):
    if cfg.name == "adafactor":
        return adafactor_init(params, cfg)
    return adamw_init(params, cfg)


def update(grads, opt_state, params, cfg: OptimizerConfig):
    if cfg.name == "adafactor":
        return adafactor_update(grads, opt_state, params, cfg)
    return adamw_update(grads, opt_state, params, cfg)


__all__ = ["OptimizerConfig", "adafactor_init", "adafactor_update",
           "adamw_init", "adamw_update", "clip_by_global_norm",
           "global_norm", "init", "schedule", "update"]
