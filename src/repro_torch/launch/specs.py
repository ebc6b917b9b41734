"""Sharding specs for the train state and the batch (the port of
``repro.launch.specs``'s ``state_shardings`` and ``batch_shardings``).

A spec is a plain tuple, one entry a dimension (``repro_torch.sharding``);
``None`` in place of a spec leaves that leaf where it is (the host-side
step counters).
"""
from __future__ import annotations

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


__all__ = ["batch_shardings", "place_state", "state_shardings"]
