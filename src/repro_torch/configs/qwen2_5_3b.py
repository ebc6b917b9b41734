"""Qwen2.5 3B (the reference's ``configs/qwen2_5_3b.py``)."""
from ..models.common import ModelConfig

# [hf:Qwen/Qwen2.5-3B; hf] GQA kv=2, QKV bias, tied embeddings.
CONFIG = ModelConfig(
    name="qwen2.5-3b", kind="dense", n_layers=36, d_model=2048, n_heads=16,
    n_kv_heads=2, d_ff=11008, vocab=151936, norm="rmsnorm", act="swiglu",
    qkv_bias=True, tie_embeddings=True, rope_theta=1_000_000.0,
)
