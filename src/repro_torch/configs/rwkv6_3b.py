"""RWKV-6 "Finch" 3B (the reference's ``configs/rwkv6_3b.py``)."""
from ..models.common import ModelConfig

# [arXiv:2404.05892; hf] Finch: attn-free, data-dependent decay.
CONFIG = ModelConfig(
    name="rwkv6-3b", kind="ssm", n_layers=32, d_model=2560, n_heads=40,
    n_kv_heads=40, d_ff=8960, vocab=65536, norm="layernorm",
    block_pattern=("rwkv",),
)
