"""Whisper large-v3 (the reference's ``configs/whisper_large_v3.py``)."""
from ..models.common import ModelConfig

# [arXiv:2212.04356; unverified] enc-dec, conv frontend stubbed; sinusoidal
# positions (rope_theta=0); 32 encoder + 32 decoder layers.
CONFIG = ModelConfig(
    name="whisper-large-v3", kind="audio", n_layers=32, d_model=1280,
    n_heads=20, n_kv_heads=20, d_ff=5120, vocab=51866, norm="layernorm",
    act="gelu", qkv_bias=True, rope_theta=0.0, n_enc_layers=32,
    block_pattern=("dec",), tie_embeddings=True,
)
