"""Batched serving engine: prefill + decode over the per-layer cache.

Prefill teacher-forces the prompt through the same one-token
``decode_step`` as decoding, as the reference does, so one code path
fills every cache. An encoder-decoder (whisper) first runs its encoder
once over the request's ``enc_embeds`` and fills every decoder layer's
cross cache (``build_cross_caches``). Decoding is greedy, or sampled at a temperature from
an explicit ``torch.Generator``; a row stops (emits 0) after it emitted
``eos_id``. A request that would run past a causal layer's KV cache
(``max_len`` positions) is refused before any work; the reference's
cache write clamps to its last slot instead.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..models.common import ModelConfig, device_of
from ..models.transformer import (build_cross_caches, decode_step,
                                  init_cache, layer_kinds)


@dataclasses.dataclass
class ServeConfig:
    batch: int
    max_len: int                # sizes KV caches; recurrent states need none
    temperature: float = 0.0    # 0 => greedy
    eos_id: int = -1            # -1 => never stop early


class Engine:
    def __init__(self, params, cfg: ModelConfig, scfg: ServeConfig,
                 device="cuda", enc_embeds: Optional[torch.Tensor] = None):
        self.device = device_of(device)
        where = next(params.parameters()).device
        if where != self.device:
            raise ValueError(f"params are on {where}, the engine on "
                             f"{self.device}")
        self.params = params
        self.cfg = cfg
        self.scfg = scfg
        self.cache = init_cache(
            cfg, scfg.batch, scfg.max_len, device=self.device,
            enc_len=0 if enc_embeds is None else enc_embeds.shape[1])
        if cfg.n_enc_layers:
            if enc_embeds is None:
                raise ValueError(f"{cfg.name}: an encoder-decoder engine "
                                 "needs enc_embeds")
            with torch.no_grad():
                self.cache = build_cross_caches(
                    params, cfg, enc_embeds.to(self.device), self.cache)

    def _check_fits(self, n: int) -> None:
        """Refuse ``n`` more positions where a causal layer's KV cache
        cannot hold them (windowed and recurrent caches never fill; a
        ``dec`` layer's self-attention cache does)."""
        for c, kind in zip(self.cache, layer_kinds(self.cfg)):
            if kind not in ("local", "rwkv", "rec"):
                c = c["self"] if kind == "dec" else c
                if c["len"] + n > c["k"].shape[1]:
                    raise ValueError(
                        f"Engine: {n} more positions after {c['len']} do "
                        f"not fit the causal KV cache of max_len "
                        f"{c['k'].shape[1]}")
                return

    @torch.no_grad()
    def prefill(self, prompt: torch.Tensor) -> torch.Tensor:
        """prompt: (B, P) int. Returns logits of the last position."""
        self._check_fits(prompt.shape[1])
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
        """Greedy/temperature decode; returns (B, max_new) int64 tokens.
        The prompt and the ``max_new`` steps take ``P + max_new`` cache
        positions."""
        self._check_fits(prompt.shape[1] + max_new)
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
