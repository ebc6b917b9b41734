"""Models: config, attention (causal and local) and the MLP, the RWKV-6
block, the RG-LRU block, assembly (the ``attn``, ``rwkv``, ``rec`` and
``local`` block kinds, a dense or CPD-factorized embedding)."""
from .common import ModelConfig
from .transformer import (Model, apply_block, decode_step, forward,
                          init_cache, init_model)

__all__ = ["Model", "ModelConfig", "apply_block", "decode_step", "forward",
           "init_cache", "init_model"]
