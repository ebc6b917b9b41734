"""RecurrentGemma 9B (the reference's ``configs/recurrentgemma_9b.py``)."""
from ..models.common import ModelConfig

# [arXiv:2402.19427; unverified] RG-LRU + local attn, 1 attn : 2 recurrent.
CONFIG = ModelConfig(
    name="recurrentgemma-9b", kind="hybrid", n_layers=38, d_model=4096,
    n_heads=16, n_kv_heads=1, head_dim=256, d_ff=12288, vocab=256000,
    norm="rmsnorm", act="geglu", tie_embeddings=True,
    block_pattern=("rec", "rec", "local"), window=2048, lru_width=4096,
)
