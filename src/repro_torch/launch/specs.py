"""Sharding specs for the train state, the batch and the decode cache
(the port of ``repro.launch.specs``).

A spec is a plain tuple, one entry a dimension (``repro_torch.sharding``);
``None`` in place of a spec leaves that leaf where it is (the host-side
step counters).
"""
from __future__ import annotations

import torch

from .. import sharding as shlib
from ..models.common import ModelConfig


def _replicate(tree):
    if isinstance(tree, dict):
        return {k: _replicate(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_replicate(v) for v in tree]
    return shlib.replicated(tree)


def state_shardings(state, ctx: shlib.ShardingCtx,
                    param_shardings=None) -> dict:
    """Specs for a ``{"params", "opt", "step"}`` train state: the params
    by ``param_shardings`` (default ``sharding.param_sharding_tree``),
    AdamW's ``m`` / ``v`` mirroring them, Adafactor's factored ``f`` and
    any other extra replicated, and the step counters (host tensors)
    where they are."""
    params_sh = (param_shardings if param_shardings is not None
                 else shlib.param_sharding_tree(state["params"], ctx))
    out_opt = {}
    for k, v in state["opt"].items():
        if k == "step":
            out_opt[k] = None
        elif k in ("m", "v"):
            out_opt[k] = params_sh
        else:  # adafactor's factored stats: replicated (small)
            out_opt[k] = _replicate(v)
    return {"params": params_sh, "opt": out_opt, "step": None}


def batch_shardings(cfg: ModelConfig, batch, ctx: shlib.ShardingCtx) -> dict:
    """Each batch leaf over the dp axes on its leading (batch) dim when
    they divide it, replicated otherwise."""
    def rule(leaf):
        tags = ("dp",) + (None,) * (leaf.dim() - 1)
        return ctx.resolve(*shlib.fit_tags(leaf.shape, tags, ctx))

    return {k: rule(v) for k, v in batch.items()}


def cache_shardings(cache, ctx: shlib.ShardingCtx):
    """Specs of a decode cache (``transformer.init_cache``'s list of
    per-layer dicts), by the reference's rule leaf by leaf on the port's
    per-layer leaves: ``k`` / ``v`` (B, S, KV, hd) take the dp axes on the
    batch and the model axis on the sequence (flash-decode style), each
    only where its mesh extent divides that dimension; ``state``,
    ``conv``, ``last``, ``last_c`` and ``h`` take the dp axes on the batch
    where they divide it; every other leaf (``k_scale`` / ``v_scale`` of
    the int8 cache, the 0-d ``len`` position, as the reference's) is
    replicated, and ``kv_len`` (a Python int) gets ``None``."""
    def rule(name, leaf):
        if not isinstance(leaf, torch.Tensor):
            return None
        tags = [None] * leaf.dim()
        if name in ("k", "v") and leaf.dim() == 4:
            tags[0], tags[1] = "dp", "tp"
        elif name in ("state", "conv", "last", "last_c", "h"):
            tags[0] = "dp"
        return ctx.resolve(*shlib.fit_tags(leaf.shape, tags, ctx))

    def visit(node):
        if isinstance(node, list):
            return [visit(x) for x in node]
        return {k: visit(v) if isinstance(v, dict) else rule(k, v)
                for k, v in node.items()}

    return visit(cache)


def place_state(state, ctx: shlib.ShardingCtx, specs=None) -> dict:
    """``state`` placed over ``ctx``'s mesh by ``specs`` (default
    :func:`state_shardings`), the step counters kept as they are."""
    specs = specs or state_shardings(state, ctx)

    def go(node, spec):
        if spec is None:
            return node
        if isinstance(node, dict):
            return {k: go(v, spec[k]) for k, v in node.items()}
        return shlib.place(node, spec, ctx)

    return go(state, specs)


__all__ = ["batch_shardings", "cache_shardings", "place_state",
           "state_shardings"]
