"""Qwen3-MoE 235B-A22B (the reference's ``configs/qwen3_moe_235b_a22b.py``)."""
from ..models.common import ModelConfig

# [hf:Qwen/Qwen3-235B-A22B; hf] 128 experts top-8, QK-norm, d_ff/expert 1536.
CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b", kind="moe", n_layers=94, d_model=4096,
    n_heads=64, n_kv_heads=4, head_dim=128, d_ff=1536, vocab=151936,
    norm="rmsnorm", act="swiglu", qk_norm=True, rope_theta=1_000_000.0,
    n_experts=128, top_k=8, block_pattern=("moe",),
)
