"""Deterministic synthetic LM data (resumable): the reference's
``training/data.py``.

Every batch is a pure function of (seed, step), drawn with numpy exactly
as the reference draws it (``np.random.default_rng((seed, step))``,
Zipf 1.3 modulo the vocabulary), so the tokens are bitwise the
reference's; they are handed over as int32 tensors on ``device``.
``get_state``/``set_state`` plug into the checkpoint manager.
"""
from __future__ import annotations

import numpy as np
import torch

from ..models.common import ModelConfig, device_of

_NOT_PORTED = "ROADMAP Queue A item 12.4b (LM side: the other families)"


class SyntheticLM:
    """Zipf-ish token stream with next-token targets."""

    def __init__(self, cfg: ModelConfig, batch: int, seq: int,
                 seed: int = 0, device="cuda"):
        if cfg.kind in ("vlm", "audio"):
            raise NotImplementedError(f"{cfg.kind} batches (image or frame "
                                      f"embeddings) are {_NOT_PORTED}")
        self.cfg = cfg
        self.batch = batch
        self.seq = seq
        self.seed = seed
        self.step = 0
        self.device = device_of(device)

    def _tokens(self, rng, shape):
        raw = rng.zipf(1.3, size=shape)
        return (raw % self.cfg.vocab).astype(np.int32)

    def next(self) -> dict:
        rng = np.random.default_rng((self.seed, self.step))
        self.step += 1
        toks = torch.from_numpy(self._tokens(rng, (self.batch,
                                                    self.seq + 1)))
        return {"tokens": toks[:, :-1].to(self.device, copy=True),
                "targets": toks[:, 1:].to(self.device, copy=True)}

    def get_state(self) -> dict:
        return {"step": self.step, "seed": self.seed}

    def set_state(self, state: dict):
        self.step = int(state.get("step", 0))
        self.seed = int(state.get("seed", self.seed))


__all__ = ["SyntheticLM"]
