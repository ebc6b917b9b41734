"""Registry of the ten architectures, and ``smoke`` configs.

The reference's ten, all ported: the dense attention family
(tinyllama-1.1b, olmo-1b, qwen2.5-3b, and command-r-plus-104b with its
parallel block), the MoE family (olmoe-1b-7b, qwen3-moe-235b-a22b),
recurrentgemma-9b, rwkv6-3b, paligemma-3b (prefix-LM over stub image
embeddings) and whisper-large-v3 (encoder-decoder over stub frame
embeddings). ``smoke()`` returns a reduced same-family config for CPU
tests, by the reference's rules.
"""
from __future__ import annotations

import dataclasses

from ..models.common import ModelConfig
from .command_r_plus_104b import CONFIG as COMMAND_R_PLUS_104B
from .olmo_1b import CONFIG as OLMO_1B
from .olmoe_1b_7b import CONFIG as OLMOE_1B_7B
from .paligemma_3b import CONFIG as PALIGEMMA_3B
from .qwen2_5_3b import CONFIG as QWEN2_5_3B
from .qwen3_moe_235b_a22b import CONFIG as QWEN3_MOE_235B
from .recurrentgemma_9b import CONFIG as RECURRENTGEMMA_9B
from .rwkv6_3b import CONFIG as RWKV6_3B
from .tinyllama_1_1b import CONFIG as TINYLLAMA_1_1B
from .whisper_large_v3 import CONFIG as WHISPER_LARGE_V3

ARCHS: dict[str, ModelConfig] = {
    c.name: c for c in [
        COMMAND_R_PLUS_104B, OLMO_1B, QWEN2_5_3B, TINYLLAMA_1_1B,
        RECURRENTGEMMA_9B, QWEN3_MOE_235B, OLMOE_1B_7B, PALIGEMMA_3B,
        WHISPER_LARGE_V3, RWKV6_3B]}


def get_config(name: str) -> ModelConfig:
    return ARCHS[name]


def smoke(name: str) -> ModelConfig:
    """Reduced same-family config: small widths, few experts, tiny vocab."""
    cfg = get_config(name)
    pat = cfg.block_pattern
    n_layers = max(2, len(pat))
    repl = dict(
        n_layers=n_layers if len(pat) == 1 else len(pat) + min(
            len(pat), cfg.n_layers - len(pat)),
        d_model=128,
        n_heads=4,
        n_kv_heads=max(1, min(4, cfg.n_kv_heads * 4 // cfg.n_heads)),
        head_dim=32,
        d_ff=256,
        vocab=512,
        window=min(cfg.window, 16) if cfg.window else 0,
        lru_width=128 if cfg.lru_width else 0,
        n_experts=8 if cfg.n_experts else 0,
        top_k=2 if cfg.top_k else 0,
        n_enc_layers=2 if cfg.n_enc_layers else 0,
        n_img_tokens=4 if cfg.n_img_tokens else 0,
        remat="none",
    )
    if cfg.kind == "ssm":
        repl["d_model"] = 128  # 2 rwkv heads of 64
        repl["n_heads"] = 2
        repl["n_kv_heads"] = 2
        repl["head_dim"] = 0
    return dataclasses.replace(cfg, **repl)
