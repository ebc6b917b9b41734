"""Trees of tensors for the train state: nested dicts whose leaves are
tensors or lists of tensors.

A list is one of the reference's stacked leaves held unstacked: the
reference stacks a stage's layers on a leading scan axis
(``stage{i}/b{j}/name`` of shape ``(rep, ...)``); the port keeps the
``rep`` tensors of that leaf as a list (``models.transformer.
stack_layers``). Rules that read a leaf's rank (weight decay, Adafactor's
factoring, the bf16 working copy) read the stacked rank, one more than
each tensor's, so that they take the reference's decisions. Under a
mesh each tensor is a :class:`~repro_torch.sharding.Sharded` (its pieces
over the mesh's positions), and :func:`each` visits every piece.
"""
from __future__ import annotations

from typing import Callable

import torch

from ..sharding import Sharded


def tree_map(fn: Callable, tree, *rest):
    """``fn(leaf, *other_leaves)`` at every leaf (a tensor or a list), the
    dict structure kept."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def each(fn: Callable, leaf, *rest):
    """``fn`` on every tensor of a leaf: one call for a tensor, one a
    layer for a list (the other leaves indexed alike), one a piece for a
    :class:`~repro_torch.sharding.Sharded` (the other leaves' pieces at
    the same key)."""
    if isinstance(leaf, list):
        return [each(fn, x, *(r[i] for r in rest))
                for i, x in enumerate(leaf)]
    if isinstance(leaf, Sharded):
        return leaf.map(fn, *rest)
    return fn(leaf, *rest)


def rank(leaf) -> int:
    """The leaf's rank in the reference's stacked layout."""
    if isinstance(leaf, list):
        return leaf[0].dim() + 1
    return leaf.dim()


def leaves(tree) -> list[torch.Tensor]:
    """Every tensor in order: dict keys sorted (``jax.tree_util``'s
    order), a list's tensors in layer order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, list):
        return list(tree)
    return [tree]


def unflatten(like, flat) -> dict:
    """A tree shaped like ``like`` over the tensors of ``flat`` (in
    :func:`leaves` order)."""
    it = iter(flat)

    def build(node):
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        if isinstance(node, list):
            return [next(it) for _ in node]
        return next(it)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("unflatten: more tensors than the tree's leaves")
    return out


__all__ = ["each", "leaves", "rank", "tree_map", "unflatten"]
