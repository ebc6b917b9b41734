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

On the card the engine is the counterpart of the reference's jitted
step (``self._step = jax.jit(...)``): it keeps a bf16 working copy of
every weight the step casts at use (``transformer.decode_working_copies``:
the tokens and logits stay bitwise the masters'), a static cache and
token buffer, and captures ``decode_step`` into one
``torch.cuda.CUDAGraph`` after its first step, which it runs eagerly;
every later step is one replay. Each replay ends by copying the step's
new recurrent states and positions into the static cache (the KV caches
are written in place), so the cache always holds the engine's state. A
failed capture raises; the engine never falls back to eager steps. The
graph's memory pool is freed with the engine. On the CPU the engine runs
the eager step on the masters.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..cuda_graphs import capture
from ..models.common import ModelConfig, device_of
from ..models.transformer import (build_cross_caches, decode_step,
                                  decode_working_copies, init_cache,
                                  layer_kinds)

#: Decode steps captured into a CUDA graph, over all engines (a second
#: ``generate`` on one engine replays without a new capture).
CAPTURES = {"decode_step": 0}


@dataclasses.dataclass
class ServeConfig:
    batch: int
    max_len: int                # sizes KV caches; recurrent states need none
    temperature: float = 0.0    # 0 => greedy
    eos_id: int = -1            # -1 => never stop early


def _copy_into(static, new) -> None:
    """Copy each tensor of the new cache ``new`` into the tensor at the
    same place in ``static`` (one that the step wrote in place is the
    same tensor and is skipped); other leaves (``kv_len``) stay."""
    for key, leaf in (static.items() if isinstance(static, dict)
                      else enumerate(static)):
        if isinstance(leaf, (dict, list)):
            _copy_into(leaf, new[key])
        elif torch.is_tensor(leaf) and new[key] is not leaf:
            leaf.copy_(new[key])


class Engine:
    """``graph`` (default: on a CUDA device) replays the captured step;
    ``working_copies`` (default: on a CUDA device) runs it on the bf16
    working copies. Either may be turned off on the card to time or check
    the eager step; a graph on the CPU raises."""

    def __init__(self, params, cfg: ModelConfig, scfg: ServeConfig,
                 device="cuda", enc_embeds: Optional[torch.Tensor] = None,
                 graph: Optional[bool] = None,
                 working_copies: Optional[bool] = None):
        self.device = device_of(device)
        where = next(params.parameters()).device
        if where != self.device:
            raise ValueError(f"params are on {where}, the engine on "
                             f"{self.device}")
        on_card = self.device.type == "cuda"
        self.graph = on_card if graph is None else bool(graph)
        if self.graph and not on_card:
            raise ValueError("Engine: CUDA graphs need a CUDA device")
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
        if on_card if working_copies is None else working_copies:
            self.step_params = decode_working_copies(params, cfg)
        else:
            self.step_params = params
        self.pos = 0              # positions taken: the host's mirror
        self.last_logits = None   # the logits after generate's last token
        self._graph = None
        self._token = torch.zeros((scfg.batch, 1), dtype=torch.int64,
                                  device=self.device)
        self._logits = None

    def _check_fits(self, n: int) -> None:
        """Refuse ``n`` more positions where a causal layer's KV cache
        cannot hold them (windowed and recurrent caches never fill; a
        ``dec`` layer's self-attention cache does), from the host's
        count of positions taken: a replay cannot read the device's."""
        for c, kind in zip(self.cache, layer_kinds(self.cfg)):
            if kind not in ("local", "rwkv", "rec"):
                c = c["self"] if kind == "dec" else c
                if self.pos + n > c["k"].shape[1]:
                    raise ValueError(
                        f"Engine: {n} more positions after {self.pos} do "
                        f"not fit the causal KV cache of max_len "
                        f"{c['k'].shape[1]}")
                return

    def _step(self, token: torch.Tensor) -> torch.Tensor:
        """One decode step of ``token`` (B, 1) on the engine's cache;
        returns the logits (on the graph path the static buffer that the
        next step overwrites)."""
        self.pos += 1
        if self._graph is not None:
            self._token.copy_(token)
            self._graph.replay()
            return self._logits
        logits, new = decode_step(self.step_params, self.cache, self.cfg,
                                  token)
        if not self.graph:
            self.cache = new
            return logits
        _copy_into(self.cache, new)        # the static cache keeps the state
        self._capture()
        return logits

    def _capture(self) -> None:
        """Capture one step on the static token and cache (the eager
        first step has loaded and warmed every library it calls)."""
        g = torch.cuda.CUDAGraph()
        with capture(g, self.device):
            logits, new = decode_step(self.step_params, self.cache,
                                      self.cfg, self._token)
            _copy_into(self.cache, new)
        self._graph, self._logits = g, logits
        CAPTURES["decode_step"] += 1

    def _prefill(self, prompt):
        self._check_fits(prompt.shape[1])
        prompt = prompt.to(self.device)
        logits = None
        for t in range(prompt.shape[1]):
            logits = self._step(prompt[:, t:t + 1])
        return logits

    @torch.no_grad()
    def step(self, token: torch.Tensor) -> torch.Tensor:
        """One decode step of ``token`` (B, 1), refused first where a
        causal cache is full; returns the logits (on the card the graph's
        static buffer, valid until the next step)."""
        self._check_fits(1)
        return self._step(token)

    @torch.no_grad()
    def prefill(self, prompt: torch.Tensor) -> torch.Tensor:
        """prompt: (B, P) int. Returns logits of the last position."""
        logits = self._prefill(prompt)
        return logits if self._graph is None else logits.clone()

    def _sample(self, logits, generator):
        lf = logits[:, -1, :self.cfg.vocab].float()
        if self.scfg.temperature <= 0.0:
            return lf.argmax(-1)
        probs = torch.softmax(lf / self.scfg.temperature, -1)
        return torch.multinomial(probs, 1, generator=generator)[:, 0]

    @torch.no_grad()
    def generate(self, prompt: torch.Tensor, max_new: int,
                 generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Greedy/temperature decode; returns (B, max_new) int64 tokens
        and keeps the logits after the last token in ``last_logits``.
        The prompt and the ``max_new`` steps take ``P + max_new`` cache
        positions."""
        self._check_fits(prompt.shape[1] + max_new)
        if generator is None and self.scfg.temperature > 0.0:
            generator = torch.Generator(device=self.device).manual_seed(0)
        logits = self._prefill(prompt)
        outs = []
        done = torch.zeros((prompt.shape[0],), dtype=torch.bool,
                           device=self.device)
        for _ in range(max_new):
            nxt = self._sample(logits, generator)
            nxt = torch.where(done, 0, nxt)
            outs.append(nxt)
            done = done | (nxt == self.scfg.eos_id)
            logits = self._step(nxt[:, None])
        self.last_logits = logits.clone()
        return torch.stack(outs, dim=1)
