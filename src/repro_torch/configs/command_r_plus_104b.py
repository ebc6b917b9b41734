"""Command R+ 104B (the reference's ``configs/command_r_plus_104b.py``)."""
from ..models.common import ModelConfig

# [hf:CohereForAI/c4ai-command-r-plus; unverified] GQA kv=8, no-bias,
# parallel attention/FFN block, LayerNorm, tied embeddings.
CONFIG = ModelConfig(
    name="command-r-plus-104b", kind="dense", n_layers=64, d_model=12288,
    n_heads=96, n_kv_heads=8, d_ff=33792, vocab=256000, norm="layernorm",
    act="swiglu", parallel_block=True, tie_embeddings=True,
    rope_theta=75_000_000.0,
)
