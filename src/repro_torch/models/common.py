"""Model configuration and shared primitives (init, norms, dtype policy).

``ModelConfig`` keeps every field of the reference's config, so the two
compare field by field; ``cdtype``/``pdtype`` are torch dtypes here.
Parameters live in ``nn.Module``s whose attribute names are the
reference's pytree keys; the layers are plain functions of a module and
tensors.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
from torch import nn


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    kind: str                      # dense | moe | hybrid | ssm | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0              # 0 -> d_model // n_heads
    # block behaviour
    norm: str = "rmsnorm"          # rmsnorm | layernorm | layernorm_np
    act: str = "swiglu"            # swiglu | geglu | gelu
    qkv_bias: bool = False
    qk_norm: bool = False
    parallel_block: bool = False   # command-r style attn || mlp
    tie_embeddings: bool = False
    rope_theta: float = 10000.0
    # MoE
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    # hybrid (griffin) / ssm
    block_pattern: tuple[str, ...] = ("attn",)   # cycle of block kinds
    window: int = 0                # sliding window for "local" attention
    lru_width: int = 0
    conv_width: int = 4
    # enc-dec (whisper)
    n_enc_layers: int = 0
    # vlm (paligemma)
    n_img_tokens: int = 0
    # dtypes / memory
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    remat: str = "full"            # full | dots | none
    # distribution / serving knobs
    seq_shard_carry: bool = True
    kv_quant: bool = False
    # CPD-factorized embedding
    cpd_embedding: bool = False
    cpd_rank: int = 0

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def vocab_padded(self) -> int:
        return ((self.vocab + 127) // 128) * 128

    @property
    def cdtype(self) -> torch.dtype:
        return getattr(torch, self.compute_dtype)

    @property
    def pdtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    def stages(self) -> list[tuple[tuple[str, ...], int]]:
        """Split n_layers into (pattern-cycle, repeat) stages, in the
        reference's order (its scan groups; here the layer order)."""
        pat = self.block_pattern
        full, rem = divmod(self.n_layers, len(pat))
        out = []
        if full:
            out.append((pat, full))
        if rem:
            out.append((pat[:rem], 1))
        return out

    def param_count(self) -> int:
        """Analytic parameter count, the reference's formula (for
        reporting; the CPD embedding is counted as the dense table)."""
        d, hd = self.d_model, self.hd
        attn = d * (self.n_heads + 2 * self.n_kv_heads) * hd \
            + self.n_heads * hd * d
        if self.qkv_bias:
            attn += (self.n_heads + 2 * self.n_kv_heads) * hd
        gated = self.act in ("swiglu", "geglu")
        mlp = d * self.d_ff * (3 if gated else 2)
        if self.n_experts:
            mlp = self.n_experts * mlp + d * self.n_experts  # + router
        rec = 0
        if "rec" in self.block_pattern:
            w = self.lru_width or d
            # in/out proj + gates + conv
            rec = 2 * d * w + 2 * w * w // 1 + 3 * w + self.conv_width * w
        counts = {"attn": attn + mlp, "local": attn + mlp,
                  "rec": rec + mlp, "moe": attn + mlp,
                  "rwkv": 0, "enc": attn + mlp, "dec": 2 * attn + mlp}
        if self.kind == "ssm":
            # rwkv6: time-mix (r,k,v,g,w,o = 6 d^2 approx + loras) + channel
            # mix
            tm = 5 * d * d + d * d + 7 * 32 * d * 2
            cm = 2 * d * self.d_ff
            total = self.n_layers * (tm + cm)
        else:
            total = 0
            for pat, rep in self.stages():
                for kind in pat:
                    total += counts[kind] * rep
            if self.n_enc_layers:
                total += self.n_enc_layers * (attn + mlp)
        emb = self.vocab_padded * d
        total += emb if self.tie_embeddings else 2 * emb
        return int(total)

    def active_param_count(self) -> int:
        """Params touched per token (MoE: top_k experts only)."""
        if not self.n_experts:
            return self.param_count()
        d = self.d_model
        gated = self.act in ("swiglu", "geglu")
        dense_mlp = d * self.d_ff * (3 if gated else 2)
        saved = (self.n_experts - self.top_k) * dense_mlp * self.n_layers
        return self.param_count() - saved


def device_of(device) -> torch.device:
    """``torch.device(device)``; raises for a CUDA device where torch sees
    no card (entry points default to ``cuda`` and never fall back)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("asked for a CUDA device but torch sees no "
                               "card; pass device='cpu' to run on the CPU")
        if dev.index is None:      # "cuda" -> "cuda:<current>"
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def param(t: torch.Tensor) -> nn.Parameter:
    """A parameter of a served model (training runs on a :class:`Node`
    tree of the same tensors, ``training.train_loop``)."""
    return nn.Parameter(t, requires_grad=False)


class Node(dict):
    """A dict whose keys read as attributes: a parameter tree that the
    model functions take in place of a :class:`Params` module (the train
    step hands them trees of tensors that require grad)."""

    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError:
            raise AttributeError(name) from None


def as_node(tree):
    """``tree`` with every nested dict a :class:`Node` (the tensors
    shared, lists kept as lists)."""
    if isinstance(tree, dict):
        return Node({k: as_node(v) for k, v in tree.items()})
    if isinstance(tree, list):
        return [as_node(v) for v in tree]
    return tree


class Params(nn.Module):
    """A pytree node: tensors become parameters and nested dicts child
    modules, under the reference's keys."""

    def __init__(self, tree: dict):
        super().__init__()
        for name, leaf in tree.items():
            if isinstance(leaf, dict):
                self.add_module(name, Params(leaf))
            else:
                self.register_parameter(name, param(leaf))


def tree_of(module: nn.Module) -> dict:
    """The nested dict of a parameter module's tensors, under its keys:
    the inverse of :class:`Params`, sharing the tensors (no copy)."""
    tree = {name: t for name, t in module.named_parameters(recurse=False)}
    for name, child in module.named_children():
        tree[name] = tree_of(child)
    return tree


def dense_init(shape, dtype, scale: Optional[float] = None, *,
               generator: torch.Generator) -> torch.Tensor:
    """Truncated normal at +-2 in units of the standard normal, then
    scaled by ``scale`` (default ``1/sqrt(fan_in)``), drawn in f32 on the
    generator's device and cast to ``dtype``."""
    fan_in = shape[0] if len(shape) >= 2 else 1
    std = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    t = torch.empty(shape, dtype=torch.float32, device=generator.device)
    if t.device.type != "meta":
        torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0,
                                    generator=generator)
    return (t * std).to(dtype)


class ShapeOnly:
    """The stand-in for a ``torch.Generator`` on the ``meta`` device,
    which has none: the init functions place every leaf on its
    ``device`` and draw no values (a shape-only init, as the reference's
    ``jax.eval_shape`` of ``init_model``)."""

    device = torch.device("meta")


def init_norm(cfg: ModelConfig, device, with_bias: bool = False) -> dict:
    if cfg.norm == "layernorm_np":
        return {}  # OLMo: non-parametric LN
    p = {"scale": torch.ones((cfg.d_model,), dtype=cfg.pdtype,
                             device=device)}
    if cfg.norm == "layernorm" and with_bias:
        p["bias"] = torch.zeros((cfg.d_model,), dtype=cfg.pdtype,
                                device=device)
    return p


def apply_norm(params, x, cfg: ModelConfig, eps: float = 1e-6):
    """RMS norm or layer norm over the last axis, in f32, cast back."""
    xf = x.float()
    if cfg.norm == "rmsnorm":
        xf = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
    else:  # layernorm / layernorm_np
        mu = xf.mean(-1, keepdim=True)
        var = (xf - mu).square().mean(-1, keepdim=True)
        xf = (xf - mu) * torch.rsqrt(var + eps)
    scale = getattr(params, "scale", None)
    if scale is not None:
        xf = xf * scale.float()
        bias = getattr(params, "bias", None)
        if bias is not None:
            xf = xf + bias.float()
    return xf.to(x.dtype)


__all__ = ["ModelConfig", "Node", "Params", "ShapeOnly", "apply_norm",
           "as_node", "dense_init", "device_of", "init_norm", "param",
           "tree_of"]
