"""PaliGemma 3B (the reference's ``configs/paligemma_3b.py``)."""
from ..models.common import ModelConfig

# [arXiv:2407.07726; hf] SigLIP (stubbed) + gemma backbone, prefix-LM.
CONFIG = ModelConfig(
    name="paligemma-3b", kind="vlm", n_layers=18, d_model=2048, n_heads=8,
    n_kv_heads=1, head_dim=256, d_ff=16384, vocab=257216, norm="rmsnorm",
    act="geglu", tie_embeddings=True, n_img_tokens=256,
)
