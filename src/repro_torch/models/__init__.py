"""Models, RWKV subset: config, RWKV-6 block, assembly."""
from .common import ModelConfig
from .transformer import (Model, apply_block, decode_step, forward,
                          init_cache, init_model)

__all__ = ["Model", "ModelConfig", "apply_block", "decode_step", "forward",
           "init_cache", "init_model"]
