"""OLMoE 1B-7B (the reference's ``configs/olmoe_1b_7b.py``)."""
from ..models.common import ModelConfig

# [arXiv:2409.02060; hf] 64 experts top-8.
CONFIG = ModelConfig(
    name="olmoe-1b-7b", kind="moe", n_layers=16, d_model=2048, n_heads=16,
    n_kv_heads=16, d_ff=1024, vocab=50304, norm="rmsnorm", act="swiglu",
    qk_norm=True, n_experts=64, top_k=8, block_pattern=("moe",),
)
