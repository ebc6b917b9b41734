"""Models: config, the RWKV-6 block, the RG-LRU block, local attention
and the MLP, assembly (the ``rwkv``, ``rec`` and ``local`` block kinds)."""
from .common import ModelConfig
from .transformer import (Model, apply_block, decode_step, forward,
                          init_cache, init_model)

__all__ = ["Model", "ModelConfig", "apply_block", "decode_step", "forward",
           "init_cache", "init_model"]
