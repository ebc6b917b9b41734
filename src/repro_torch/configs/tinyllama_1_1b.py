"""TinyLlama 1.1B (the reference's ``configs/tinyllama_1_1b.py``)."""
from ..models.common import ModelConfig

# [arXiv:2401.02385; hf] llama2-arch small.
CONFIG = ModelConfig(
    name="tinyllama-1.1b", kind="dense", n_layers=22, d_model=2048,
    n_heads=32, n_kv_heads=4, d_ff=5632, vocab=32000, norm="rmsnorm",
    act="swiglu",
)
