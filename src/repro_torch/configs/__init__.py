"""Configs of the ported architectures (see :mod:`.archs`) and the
reference's input shapes (:mod:`.shapes`).

:func:`input_specs` and :func:`cache_specs` give stand-ins for every
input of a (arch, shape) cell on the ``meta`` device (shapes and dtypes,
nothing allocated): the contract the dry-run (``launch.dryrun``) traces
against, as the reference's ``ShapeDtypeStruct`` stand-ins are the
contract it lowers against.
"""
from __future__ import annotations

import torch

from ..models.common import ModelConfig
from .archs import ARCHS, get_config, smoke
from .shapes import SHAPES, SUBQUADRATIC_ARCHS, ShapeSpec, applicable, cells

WHISPER_CROSS_LEN = 1500  # real whisper encoder output length (30 s audio)


def input_specs(cfg: ModelConfig, shape: ShapeSpec, device="meta") -> dict:
    """The step inputs of this (arch, shape) cell, keyed as the
    reference keys them: train / prefill a token batch (``tokens``, and
    ``targets`` to train; int32) with a ``vlm``'s stub image
    ``embeds`` or an ``audio`` model's stub frame ``enc_embeds`` in the
    compute dtype; decode one new ``token`` (B, 1) against a cache of
    ``seq_len`` (:func:`cache_specs`)."""
    b, s = shape.global_batch, shape.seq_len
    i32 = torch.int32

    def empty(dims, dtype):
        return torch.empty(dims, dtype=dtype, device=device)

    if shape.step in ("train", "prefill"):
        if cfg.kind == "vlm":
            specs = {"tokens": empty((b, s - cfg.n_img_tokens), i32),
                     "embeds": empty((b, cfg.n_img_tokens, cfg.d_model),
                                     cfg.cdtype)}
        elif cfg.kind == "audio":
            specs = {"tokens": empty((b, s), i32),
                     "enc_embeds": empty((b, s, cfg.d_model), cfg.cdtype)}
        else:
            specs = {"tokens": empty((b, s), i32)}
        if shape.step == "train":
            specs["targets"] = empty(specs["tokens"].shape, i32)
        return specs
    return {"token": empty((b, 1), i32)}


def cache_specs(cfg: ModelConfig, shape: ShapeSpec, device="meta") -> list:
    """The decode cache of this cell on ``device``
    (``transformer.init_cache`` at ``seq_len`` positions, an ``audio``
    model's cross caches at :data:`WHISPER_CROSS_LEN`): one dict a layer,
    where the reference stacks the leaves of a stage."""
    from ..models import transformer

    return transformer.init_cache(
        cfg, shape.global_batch, shape.seq_len, device=device,
        enc_len=WHISPER_CROSS_LEN if cfg.kind == "audio" else 0)


__all__ = ["ARCHS", "SHAPES", "SUBQUADRATIC_ARCHS", "WHISPER_CROSS_LEN",
           "ShapeSpec", "applicable", "cache_specs", "cells", "get_config",
           "input_specs", "smoke"]
