"""Models: config, attention (causal, local, prefix, bidirectional and
cross; an int8 KV cache) and the MLP, the RWKV-6 block, the RG-LRU
block, the MoE FFN, assembly (the ``attn``, ``moe``, ``rwkv``, ``rec``,
``local``, ``enc`` and ``dec`` block kinds, the parallel block, a dense
or CPD-factorized embedding, image-prefix and encoder inputs)."""
from .common import ModelConfig
from .transformer import (Model, apply_block, decode_step, forward,
                          init_cache, init_model)

__all__ = ["Model", "ModelConfig", "apply_block", "decode_step", "forward",
           "init_cache", "init_model"]
