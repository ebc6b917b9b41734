"""Deterministic synthetic LM data (resumable): the reference's
``training/data.py``.

Every batch is a pure function of (seed, step), drawn with numpy exactly
as the reference draws it (``np.random.default_rng((seed, step))``,
Zipf 1.3 modulo the vocabulary; then a ``vlm``'s stub image embeddings or
an ``audio`` model's stub frame embeddings, standard normal, cast to the
compute dtype), so the batches are bitwise the reference's; they are
handed over as tensors on ``device``. ``get_state``/``set_state`` plug
into the checkpoint manager.
"""
from __future__ import annotations

import numpy as np
import torch

from ..models.common import ModelConfig, device_of


class SyntheticLM:
    """Zipf-ish token stream with next-token targets; a ``vlm``'s batch
    holds ``seq - n_img_tokens`` tokens and ``embeds`` (B, n_img_tokens,
    D), an ``audio`` model's ``enc_embeds`` (B, seq, D)."""

    def __init__(self, cfg: ModelConfig, batch: int, seq: int,
                 seed: int = 0, device="cuda"):
        self.cfg = cfg
        self.batch = batch
        self.seq = seq
        self.seed = seed
        self.step = 0
        self.device = device_of(device)

    def _tokens(self, rng, shape):
        raw = rng.zipf(1.3, size=shape)
        return (raw % self.cfg.vocab).astype(np.int32)

    def _normal(self, rng, n: int) -> torch.Tensor:
        x = rng.standard_normal((self.batch, n, self.cfg.d_model))
        return torch.from_numpy(x.astype(np.float32)).to(self.device,
                                                         self.cfg.cdtype)

    def next(self) -> dict:
        rng = np.random.default_rng((self.seed, self.step))
        self.step += 1
        cfg = self.cfg
        n_txt = self.seq - (cfg.n_img_tokens if cfg.kind == "vlm" else 0)
        toks = torch.from_numpy(self._tokens(rng, (self.batch, n_txt + 1)))
        out = {"tokens": toks[:, :-1].to(self.device, copy=True),
               "targets": toks[:, 1:].to(self.device, copy=True)}
        if cfg.kind == "vlm":
            out["embeds"] = self._normal(rng, cfg.n_img_tokens)
        elif cfg.kind == "audio":
            out["enc_embeds"] = self._normal(rng, self.seq)
        return out

    def get_state(self) -> dict:
        return {"step": self.step, "seed": self.seed}

    def set_state(self, state: dict):
        self.step = int(state.get("step", 0))
        self.seed = int(state.get("seed", self.seed))


__all__ = ["SyntheticLM"]
