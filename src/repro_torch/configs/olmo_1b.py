"""OLMo 1B (the reference's ``configs/olmo_1b.py``)."""
from ..models.common import ModelConfig

# [arXiv:2402.00838; hf] non-parametric LN, tied embeddings, swiglu.
CONFIG = ModelConfig(
    name="olmo-1b", kind="dense", n_layers=16, d_model=2048, n_heads=16,
    n_kv_heads=16, d_ff=8192, vocab=50304, norm="layernorm_np", act="swiglu",
    tie_embeddings=True,
)
