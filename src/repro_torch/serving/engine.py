"""Batched serving engine: prefill + decode over the per-layer cache.

Prefill teacher-forces the prompt through the same one-token
``decode_step`` as decoding, as the reference does, so one code path
fills every cache. Decoding is greedy, or sampled at a temperature from
an explicit ``torch.Generator``; a row stops (emits 0) after it emitted
``eos_id``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..models.common import ModelConfig, device_of
from ..models.transformer import decode_step, init_cache


@dataclasses.dataclass
class ServeConfig:
    batch: int
    max_len: int                # sizes KV caches; recurrent states need none
    temperature: float = 0.0    # 0 => greedy
    eos_id: int = -1            # -1 => never stop early


class Engine:
    def __init__(self, params, cfg: ModelConfig, scfg: ServeConfig,
                 device="cuda"):
        self.device = device_of(device)
        if params.embed.device != self.device:
            raise ValueError(f"params are on {params.embed.device}, the "
                             f"engine on {self.device}")
        self.params = params
        self.cfg = cfg
        self.scfg = scfg
        self.cache = init_cache(cfg, scfg.batch, scfg.max_len,
                                device=self.device)

    @torch.no_grad()
    def prefill(self, prompt: torch.Tensor) -> torch.Tensor:
        """prompt: (B, P) int. Returns logits of the last position."""
        prompt = prompt.to(self.device)
        logits = None
        for t in range(prompt.shape[1]):
            logits, self.cache = decode_step(self.params, self.cache,
                                             self.cfg, prompt[:, t:t + 1])
        return logits

    def _sample(self, logits, generator):
        lf = logits[:, -1, :self.cfg.vocab].float()
        if self.scfg.temperature <= 0.0:
            return lf.argmax(-1)
        probs = torch.softmax(lf / self.scfg.temperature, -1)
        return torch.multinomial(probs, 1, generator=generator)[:, 0]

    @torch.no_grad()
    def generate(self, prompt: torch.Tensor, max_new: int,
                 generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Greedy/temperature decode; returns (B, max_new) int64 tokens."""
        if generator is None and self.scfg.temperature > 0.0:
            generator = torch.Generator(device=self.device).manual_seed(0)
        logits = self.prefill(prompt)
        outs = []
        done = torch.zeros((prompt.shape[0],), dtype=torch.bool,
                           device=self.device)
        for _ in range(max_new):
            nxt = self._sample(logits, generator)
            nxt = torch.where(done, 0, nxt)
            outs.append(nxt)
            done = done | (nxt == self.scfg.eos_id)
            logits, self.cache = decode_step(self.params, self.cache,
                                             self.cfg, nxt[:, None])
        return torch.stack(outs, dim=1)
