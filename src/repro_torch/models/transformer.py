"""Model assembly: init, the teacher-forced ``forward`` (the prefill
step) and the one-token ``decode_step`` over a per-layer cache, for the
block kinds

  attn   pre-norm GQA attention + MLP (tinyllama, olmo, qwen2.5;
         ``parallel_block``: one shared norm, attention || MLP, as
         command-r; a ``vlm`` attends with a prefix mask over its image
         tokens, as paligemma)
  moe    GQA causal attention + the top-k MoE FFN (olmoe, qwen3-moe;
         ``models.moe``)
  rwkv   RWKV-6 time-mix + channel-mix (rwkv6-3b)
  rec    RG-LRU recurrent block + MLP (griffin: recurrentgemma-9b)
  local  sliding-window attention + MLP (griffin attention layers)
  enc    bidirectional attention + MLP (whisper's encoder)
  dec    causal self-attention + cross-attention + MLP (whisper's
         decoder)

and either a dense embedding table or the CPD-factorized one
(``cfg.cpd_embedding``: ``tensorized.cpd_embed`` for the lookup, whose
backward is the spMTTKRP of the token batch, and ``cpd_logits`` for the
tied head). A ``vlm`` prepends stub image embeddings to the tokens'; an
encoder-decoder (``n_enc_layers``) runs its encoder once over stub frame
embeddings, and its decoder's cross-attention reads the result
(:func:`build_cross_caches` fills the decode caches from it). Where
``rope_theta`` is 0 the positions are absolute and sinusoidal.

The reference stacks the layers of a stage and drives them with one
``lax.scan``; here the layers are an ``nn.ModuleList`` walked in a loop,
in the same order (``ModelConfig.stages``). Where autograd records, each
cycle of a stage's pattern (the reference's scan body) is recomputed in
backward as ``cfg.remat`` says, like the reference's ``_remat``. The
model functions take a ``Model`` or a ``Node`` tree of the same keys
(:func:`unstack_layers`: the train step's trees of tensors that require
grad); :func:`stack_layers` gives a model's tree the reference's
stage layout (and the encoder's layers the reference's ``enc`` stage).
The reference's ``shard(...)`` hints are dropped.

Tensor parallelism over a mesh's model axis (:func:`forward_tp`, which
the sharded train step runs for each position of the dp axes): shard
``j`` holds its own replica of the residual stream and runs the
single-device block body on its slice of the weights
(``layers.attention_shard``; ``d_ff / tp`` columns of the MLP), and
:func:`apply_block_tp` sums the partial outputs of ``wo`` and ``w_down``
over the axis (``sum_heads``, ``sum_ff``) before it adds the residual,
once a sublayer. A vocab-split ``embed`` is a masked lookup a shard,
summed (``sum_vocab``). A ``moe`` block's FFN is expert parallel instead
(``moe.apply_moe_tp``: shard ``j`` holds E/m experts, its slice of the
sequence goes to every expert's owner and back, and the slices are
gathered into every replica). A parallel block adds its attention and
MLP partials before one sum over the axis. A ``local`` or ``enc`` block
is the ``attn`` path with its own mask; a ``dec`` block's
cross-attention reads the encoder's output on each shard (the encoder
runs over the axis first, :func:`encode_tp`) and its heads' partials of
``xattn``'s ``wo`` are summed (``sum_xattn``). An ``rwkv`` block's time
mix and a ``rec`` block's RG-LRU run their model-shard forms
(``rwkv.time_mix_tp``, ``rglru.apply_rglru_tp``: the recurrence kernels
on each shard's heads or channels), summed after ``w_out_t``
(``sum_tmix``) and ``w_out_rec`` (``sum_rec``); the channel mix's
partials of ``wv_c`` are summed by ``sum_cmix``.
"""
from __future__ import annotations

import functools
import math

import torch
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from .. import sharding
from ..tensorized import (cpd_embed, cpd_logits, dense_table,
                          init_cpd_embedding)
from . import layers, moe, rglru, rwkv
from .common import (ModelConfig, Node, Params, ShapeOnly, apply_norm,
                     as_node, dense_init, device_of, init_norm, param)

#: The block kinds (the reference's).
KINDS = ("attn", "moe", "rwkv", "rec", "local", "enc", "dec")


def layer_kinds(cfg: ModelConfig) -> list[str]:
    """Block kind of every layer, in order."""
    return [kind for pat, rep in cfg.stages() for _ in range(rep)
            for kind in pat]


def _check_cfg(cfg: ModelConfig) -> None:
    """Refuse what the reference cannot run either: an unknown block
    kind, and a parallel block with a MoE FFN (its parallel branch reads
    an ``mlp`` that a ``moe`` block lacks)."""
    kinds = set(layer_kinds(cfg))
    for kind in sorted(kinds):
        _check_kind(kind)
    if cfg.parallel_block and "moe" in kinds:
        raise ValueError(f"{cfg.name}: a parallel block has no MoE FFN")


def _layer_list(layers_):
    """A list of layer trees from a list, or from a ``ModuleList``'s tree
    (``tree_of``: keyed "0", "1", ...)."""
    if isinstance(layers_, dict):
        return [layers_[str(i)] for i in range(len(layers_))]
    return list(layers_)


class Model(nn.Module):
    """The parameters of a model, under the reference's keys, with the
    layers unstacked: ``embed`` (or, with ``cfg.cpd_embedding``,
    ``embed_cpd`` holding ``A``, ``B``, ``C``), ``layers[i]`` (the
    reference's ``stage*/b*`` slice of layer i), ``ln_f`` and ``head``
    (absent when the head is tied or CPD); with an encoder, ``enc[i]``
    (the reference's ``enc/b0`` slice of encoder layer i) and
    ``enc_ln_f``."""

    def __init__(self, cfg: ModelConfig, tree: dict):
        super().__init__()
        _check_cfg(cfg)
        self.cfg = cfg
        if cfg.cpd_embedding:
            self.embed_cpd = Params(tree["embed_cpd"])
        else:
            self.embed = param(tree["embed"])
        self.layers = nn.ModuleList(Params(b)
                                    for b in _layer_list(tree["layers"]))
        self.ln_f = Params(tree["ln_f"])
        if "head" in tree:
            self.head = param(tree["head"])
        if "enc" in tree:
            self.enc = nn.ModuleList(Params(b)
                                     for b in _layer_list(tree["enc"]))
            self.enc_ln_f = Params(tree["enc_ln_f"])


# --------------------------------------------------------------------------
# Blocks
# --------------------------------------------------------------------------
def _check_kind(kind: str) -> None:
    if kind not in KINDS:
        raise ValueError(f"unknown block kind {kind!r}; the kinds are "
                         f"{KINDS}")


def init_block(cfg: ModelConfig, kind: str, generator) -> dict:
    _check_kind(kind)
    dev = generator.device
    if kind == "rwkv":
        p = rwkv.init_rwkv_block(cfg, generator)
        p["ln1"] = init_norm(cfg, dev)
        p["ln2"] = init_norm(cfg, dev)
        return p
    if kind == "rec":
        return {"ln1": init_norm(cfg, dev),
                "rec": rglru.init_rglru(cfg, generator),
                "ln2": init_norm(cfg, dev),
                "mlp": layers.init_mlp(cfg, generator)}
    if kind == "dec":
        return {"ln1": init_norm(cfg, dev),
                "attn": layers.init_attention(cfg, generator),
                "lnx": init_norm(cfg, dev),
                "xattn": layers.init_attention(cfg, generator, cross=True),
                "ln2": init_norm(cfg, dev),
                "mlp": layers.init_mlp(cfg, generator)}
    p = {"attn": layers.init_attention(cfg, generator)}
    if cfg.parallel_block:
        p["ln"] = init_norm(cfg, dev)
    else:
        p["ln1"], p["ln2"] = init_norm(cfg, dev), init_norm(cfg, dev)
    if kind == "moe":
        p["moe"] = moe.init_moe(cfg, generator)
    else:
        p["mlp"] = layers.init_mlp(cfg, generator)
    return p


def _attn_mask_kind(cfg: ModelConfig, kind: str) -> tuple[str, int]:
    """(mask, prefix length) of a block's self-attention in the prefill:
    ``enc`` bidirectional, ``local`` within its window, a ``vlm``'s a
    prefix mask over its image tokens, causal otherwise (the
    reference's; a ``dec`` block's is causal, :func:`apply_block`)."""
    if kind == "enc":
        return "bidir", 0
    if kind == "local":
        return "window", 0
    if cfg.kind == "vlm":
        return "prefix", cfg.n_img_tokens
    return "causal", 0


def apply_block(params, x, cfg: ModelConfig, kind: str, enc_out=None):
    _check_kind(kind)
    if kind == "rwkv":
        x = x + rwkv.time_mix(params, apply_norm(params.ln1, x, cfg), cfg)
        return x + rwkv.channel_mix(params, apply_norm(params.ln2, x, cfg),
                                    cfg)
    if kind == "rec":
        x = x + rglru.apply_rglru(params.rec,
                                  apply_norm(params.ln1, x, cfg), cfg)
        return x + _mlp_part(params, x, cfg)
    if cfg.parallel_block and kind != "dec":   # command-r: attn || mlp
        return x + _attn_part(params, x, cfg, kind) + _mlp_part(params, x,
                                                                cfg)
    x = x + _attn_part(params, x, cfg, kind)
    if kind == "dec":   # cross-attention on the encoder's output, no RoPE
        x = x + layers.attention_full(params.xattn,
                                      apply_norm(params.lnx, x, cfg), cfg,
                                      mask="bidir", xkv=enc_out,
                                      use_rope=False)
    if kind == "moe":
        return x + moe.apply_moe(params.moe, apply_norm(params.ln2, x, cfg),
                                 cfg)
    return x + _mlp_part(params, x, cfg)


def _norm_in(p, x, cfg: ModelConfig, name: str):
    """A sublayer's normed input: the parallel block's shared ``ln``, or
    the block's own ``name`` (``ln1`` before attention, ``ln2`` before
    the MLP)."""
    return apply_norm(p.ln if hasattr(p, "ln") else getattr(p, name), x, cfg)


def _attn_part(p, x, cfg: ModelConfig, kind: str, j: int | None = None):
    """The self-attention sublayer's output (before the residual). Under
    tensor parallelism (model shard ``j``), where the heads are split, it
    is shard ``j``'s partial output of ``wo``; where they are not, the
    whole output."""
    attn, cj = p.attn, cfg
    if j is not None and layers.heads_split(p.attn, cfg):
        attn, cj = layers.attention_shard(p.attn, cfg, j)
    mask, prefix = (("causal", 0) if kind == "dec"
                    else _attn_mask_kind(cfg, kind))
    return layers.attention_full(attn, _norm_in(p, x, cfg, "ln1"), cj,
                                 mask=mask, prefix_len=prefix,
                                 use_rope=cfg.rope_theta > 0)


def _mlp_part(p, x, cfg: ModelConfig):
    """The MLP sublayer's output (before the residual): a partial output
    of ``w_down`` where the model axis splits ``d_ff``."""
    return layers.apply_mlp(p.mlp, _norm_in(p, x, cfg, "ln2"), cfg)


def apply_block_decode(params, x, cache, cfg: ModelConfig, kind: str):
    _check_kind(kind)
    use_rope = cfg.rope_theta > 0
    if kind == "rwkv":
        h = apply_norm(params.ln1, x, cfg)
        o, tm_cache = rwkv.time_mix_decode(params, h, cache, cfg)
        x = x + o
        h2 = apply_norm(params.ln2, x, cfg)
        x = x + rwkv.channel_mix(params, h2, cfg, last=cache["last_c"])
        return x, {**tm_cache, "last_c": h2}
    if kind == "rec":
        h = apply_norm(params.ln1, x, cfg)
        o, rec_cache = rglru.apply_rglru_decode(params.rec, h, cache, cfg)
        x = x + o
        x = x + layers.apply_mlp(params.mlp, apply_norm(params.ln2, x, cfg),
                                 cfg)
        return x, rec_cache
    if kind == "dec":
        h = apply_norm(params.ln1, x, cfg)
        o, sc = layers.attention_decode(params.attn, h, cache["self"], cfg,
                                        use_rope=use_rope)
        x = x + o
        h = apply_norm(params.lnx, x, cfg)
        o, _ = layers.attention_decode(params.xattn, h, cache["cross"], cfg,
                                       use_rope=False, cross=True)
        x = x + o
        x = x + layers.apply_mlp(params.mlp, apply_norm(params.ln2, x, cfg),
                                 cfg)
        return x, {**cache, "self": sc}
    # a vlm decodes causally, as the reference does (no prefix mask here)
    mask = "window" if kind == "local" else "causal"
    if cfg.parallel_block:
        h = apply_norm(params.ln, x, cfg)
        o, new_cache = layers.attention_decode(params.attn, h, cache, cfg,
                                               mask=mask, use_rope=use_rope)
        return x + o + layers.apply_mlp(params.mlp, h, cfg), new_cache
    h = apply_norm(params.ln1, x, cfg)
    o, new_cache = layers.attention_decode(params.attn, h, cache, cfg,
                                           mask=mask, use_rope=use_rope)
    x = x + o
    h = apply_norm(params.ln2, x, cfg)
    ffn = (moe.apply_moe(params.moe, h, cfg) if kind == "moe"
           else layers.apply_mlp(params.mlp, h, cfg))
    return x + ffn, new_cache


# The sums over the model axis, one a sublayer (module attributes, so a
# check can drop one and see the result change).
sum_heads = sharding.psum      # after wo
sum_ff = sharding.psum         # after w_down
sum_vocab = sharding.psum      # the vocab-split embedding lookup
sum_tmix = sharding.psum       # after an rwkv block's w_out_t
sum_cmix = sharding.psum       # after an rwkv block's wv_c
sum_rec = sharding.psum        # after a rec block's w_out_rec
sum_xattn = sharding.psum      # after a dec block's xattn wo


def check_tp(cfg: ModelConfig, tp: int) -> None:
    """Refuse a model axis that does not divide the experts (each model
    shard holds E / tp of them); every block kind has a model-axis
    path."""
    if "moe" in layer_kinds(cfg) and cfg.n_experts % tp:
        raise ValueError(f"{cfg.name}: {cfg.n_experts} experts do not "
                         f"divide over a model axis of {tp}")


def _xattn_part(p, x, enc_out, cfg: ModelConfig, j: int | None = None):
    """A ``dec`` block's cross-attention sublayer on the encoder's output
    ``enc_out`` (before the residual): shard ``j``'s partial output of
    ``xattn``'s ``wo`` where the model axis splits its heads, else the
    whole output."""
    attn, cj = p.xattn, cfg
    if j is not None and layers.heads_split(p.xattn, cfg):
        attn, cj = layers.attention_shard(p.xattn, cfg, j)
    return layers.attention_full(attn, apply_norm(p.lnx, x, cfg), cj,
                                 mask="bidir", xkv=enc_out, use_rope=False)


def _tmix_whole(p, x, cfg: ModelConfig):
    return rwkv.time_mix(p, apply_norm(p.ln1, x, cfg), cfg)


def _cmix_part(p, x, cfg: ModelConfig):
    """The channel mix's output (before the residual): a partial output
    of ``wv_c`` where the model axis splits d_ff."""
    return rwkv.channel_mix(p, apply_norm(p.ln2, x, cfg), cfg)


def _rec_whole(p, x, cfg: ModelConfig):
    return rglru.apply_rglru(p.rec, apply_norm(p.ln1, x, cfg), cfg)


def _residual(xs, outs):
    return [x + o for x, o in zip(xs, outs)]


def _each(fn, ps, xs, cfg: ModelConfig, *rest):
    """``fn(p, x, cfg, *rest)`` on each shard, recomputed in backward as
    ``cfg.remat`` says."""
    run = _remat(fn, cfg)
    return [run(p, x, cfg, *rest) for p, x in zip(ps, xs)]


def _mlp_tp(ps, xs, cfg: ModelConfig):
    """The MLP sublayer over the model axis, with its residual."""
    outs = _each(_mlp_part, ps, xs, cfg)
    if layers.mlp_split(ps[0].mlp, cfg):
        outs = sum_ff(outs)
    return _residual(xs, outs)


def _rwkv_tp(ps, xs, cfg: ModelConfig):
    """An ``rwkv`` block over the model axis: the time mix's partials of
    ``w_out_t`` summed (``sum_tmix``), then the channel mix's of ``wv_c``
    (``sum_cmix``); a sublayer the axis does not split runs whole on
    every shard, unsummed."""
    if rwkv.tmix_split(ps[0], cfg):
        hs = [apply_norm(p.ln1, x, cfg) for p, x in zip(ps, xs)]
        outs = sum_tmix(rwkv.time_mix_tp(ps, hs, cfg,
                                         remat=lambda fn: _remat(fn, cfg)))
    else:
        outs = _each(_tmix_whole, ps, xs, cfg)
    xs = _residual(xs, outs)
    outs = _each(_cmix_part, ps, xs, cfg)
    if rwkv.cmix_split(ps[0], cfg):
        outs = sum_cmix(outs)
    return _residual(xs, outs)


def _rec_tp(ps, xs, cfg: ModelConfig):
    """A ``rec`` block over the model axis: the RG-LRU's partials of
    ``w_out_rec`` summed (``sum_rec``; whole on every shard, unsummed,
    where the axis does not split W), then the MLP."""
    if rglru.rec_split(ps[0].rec, cfg):
        hs = [apply_norm(p.ln1, x, cfg) for p, x in zip(ps, xs)]
        outs = sum_rec(rglru.apply_rglru_tp(
            [p.rec for p in ps], hs, cfg, remat=lambda fn: _remat(fn, cfg)))
    else:
        outs = _each(_rec_whole, ps, xs, cfg)
    return _mlp_tp(ps, _residual(xs, outs), cfg)


def apply_block_tp(ps, xs, cfg: ModelConfig, kind: str, enc_outs=None):
    """One block over the model axis: ``ps`` holds each shard's layer
    params, ``xs`` its replica of the residual stream (on its device),
    ``enc_outs`` (a ``dec`` block's) its replica of the encoder's output;
    returns the new replicas. Each shard's sublayer (a ``moe`` FFN's
    dispatch, experts and combine apart; an ``rwkv`` time mix or an
    RG-LRU whose gather splits it in two, each part) is recomputed in
    backward as ``cfg.remat`` says, apart from the other shards' (a
    recompute stays on one device: the autograd engine runs each
    device's backward on its own thread), and the sums, gathers and
    exchanges over the model axis sit between them. A parallel block's
    attention and MLP both read the block's input: where both are split,
    each shard adds its two partials and one sum (``sum_heads``) takes
    both."""
    _check_kind(kind)
    if kind == "rwkv":
        return _rwkv_tp(ps, xs, cfg)
    if kind == "rec":
        return _rec_tp(ps, xs, cfg)
    attn = _remat(_attn_part, cfg)
    outs = [attn(p, x, cfg, kind, j)
            for j, (p, x) in enumerate(zip(ps, xs))]
    heads = layers.heads_split(ps[0].attn, cfg)
    if cfg.parallel_block and kind != "dec":
        ffs = _each(_mlp_part, ps, xs, cfg)
        split = layers.mlp_split(ps[0].mlp, cfg)
        if heads and split:
            outs = sum_heads([a + f for a, f in zip(outs, ffs)])
        else:
            outs = sum_heads(outs) if heads else outs
            ffs = sum_ff(ffs) if split else ffs
            outs = [a + f for a, f in zip(outs, ffs)]
        return _residual(xs, outs)
    if heads:
        outs = sum_heads(outs)
    xs = _residual(xs, outs)
    if kind == "dec":
        xattn = _remat(_xattn_part, cfg)
        outs = [xattn(p, x, e, cfg, j)
                for j, (p, x, e) in enumerate(zip(ps, xs, enc_outs))]
        if layers.heads_split(ps[0].xattn, cfg):
            outs = sum_xattn(outs)
        xs = _residual(xs, outs)
    if kind == "moe":
        hs = [apply_norm(p.ln2, x, cfg) for p, x in zip(ps, xs)]
        outs = moe.apply_moe_tp([p.moe for p in ps], hs, cfg,
                                remat=lambda fn: _remat(fn, cfg))
        return _residual(xs, outs)
    return _mlp_tp(ps, xs, cfg)


def init_block_cache(cfg: ModelConfig, kind: str, batch: int,
                     max_len: int | None, device, enc_len: int = 0) -> dict:
    """A layer's decode cache; a ``dec`` layer's holds its ``self`` KV
    cache and the ``cross`` cache of ``enc_len`` encoder positions that
    :func:`build_cross_caches` fills."""
    _check_kind(kind)
    if kind == "rwkv":
        return rwkv.make_rwkv_cache(cfg, batch, device)
    if kind == "rec":
        return rglru.make_rglru_cache(cfg, batch, device)
    if max_len is None:
        raise ValueError(f"a {kind!r} layer's KV cache needs max_len")
    if kind == "dec":
        return {"self": layers.make_attn_cache(cfg, batch, max_len, device),
                "cross": {**layers.make_attn_cache(cfg, batch, enc_len,
                                                   device), "kv_len": 0}}
    return layers.make_attn_cache(cfg, batch, max_len, device,
                                  windowed=(kind == "local"))


# --------------------------------------------------------------------------
# Whole model
# --------------------------------------------------------------------------
def init_model(cfg: ModelConfig, seed: int = 0, *, device="cuda") -> Model:
    """Random parameters on ``device``, drawn from a
    ``torch.Generator`` on that device seeded with ``seed``; on ``meta``
    the shapes and dtypes alone (``ShapeOnly``: no values, nothing
    allocated)."""
    _check_cfg(cfg)
    dev = device_of(device)
    gen = (ShapeOnly() if dev.type == "meta"
           else torch.Generator(device=dev).manual_seed(seed))
    d = cfg.d_model
    if cfg.cpd_embedding:  # the paper's technique as the embedding layer
        tree = {"embed_cpd": init_cpd_embedding(
            cfg.vocab_padded, d, cfg.cpd_rank or 64, cfg.pdtype,
            generator=gen)}
    else:
        tree = {"embed": dense_init((cfg.vocab_padded, d), cfg.pdtype, 0.02,
                                    generator=gen)}
    tree["layers"] = [init_block(cfg, kind, gen) for kind in layer_kinds(cfg)]
    tree["ln_f"] = init_norm(cfg, gen.device)
    if not cfg.tie_embeddings and not cfg.cpd_embedding:
        tree["head"] = dense_init((d, cfg.vocab_padded), cfg.pdtype,
                                  generator=gen)
    if cfg.n_enc_layers:
        tree["enc"] = [init_block(cfg, "enc", gen)
                       for _ in range(cfg.n_enc_layers)]
        tree["enc_ln_f"] = init_norm(cfg, gen.device)
    return Model(cfg, tree)


def sinusoidal_pos(seq: int, d: int, offset: int = 0, device=None):
    """(seq, d) float32 absolute positions from ``offset``: sin in the
    even columns, cos in the odd, at frequencies 10000^(-i/d) (the
    reference's)."""
    pos = offset + torch.arange(seq, device=device)[:, None].float()
    div = torch.exp(torch.arange(0, d, 2, device=device)
                    * (-math.log(10000.0) / d))
    pe = torch.zeros((seq, d), device=device)
    pe[:, 0::2] = torch.sin(pos * div)
    pe[:, 1::2] = torch.cos(pos * div)
    return pe


def embed_lookup(params, ids, cfg: ModelConfig):
    """Token embeddings in the compute dtype (rows gathered, then cast:
    the same values as casting the table first). The CPD lookup runs in
    the parameters' dtype and is cast after it; its backward is the
    spMTTKRP of the token batch."""
    if cfg.cpd_embedding:
        return cpd_embed(params.embed_cpd, ids).to(cfg.cdtype)
    return params.embed[ids].to(cfg.cdtype)


def head_matrix(params, cfg: ModelConfig):
    """(D, V) head in the compute dtype. Under the CPD embedding this
    materialises the dense table (``_logits`` does not)."""
    if cfg.cpd_embedding:
        return dense_table(params.embed_cpd).to(cfg.cdtype).T
    if cfg.tie_embeddings:
        return params.embed.to(cfg.cdtype).T
    return params.head.to(cfg.cdtype)


def vocab_split(params, cfg: ModelConfig) -> bool:
    """Whether the model axis splits this shard's head: its ``head``
    columns, or the ``embed`` rows a tied head reads."""
    if cfg.cpd_embedding:
        return False
    if "head" in params:
        return params.head.shape[1] < cfg.vocab_padded
    return params.embed.shape[0] < cfg.vocab_padded


def embed_lookup_tp(ps, ids, cfg: ModelConfig) -> list:
    """:func:`embed_lookup` over the model axis: ``ids`` one tensor a
    shard. A vocab-split table is looked up where each shard owns the
    id (rows ``j * n`` to ``(j + 1) * n``), zeros elsewhere, and summed;
    a replicated one (or the CPD factors) is looked up whole on each."""
    if len(ps) == 1 or cfg.cpd_embedding \
            or ps[0].embed.shape[0] == cfg.vocab_padded:
        return [embed_lookup(p, t, cfg) for p, t in zip(ps, ids)]
    parts = []
    for j, (p, t) in enumerate(zip(ps, ids)):
        n = p.embed.shape[0]
        local = t.long() - j * n
        own = (local >= 0) & (local < n)
        rows = p.embed[local.clamp(0, n - 1)].to(cfg.cdtype)
        parts.append(torch.where(own[..., None], rows, 0))
    return sum_vocab(parts)


def _logits(params, x, cfg: ModelConfig):
    """Logits over ``vocab_padded`` ids, or over the CPD's V1 * V2 ids."""
    x = apply_norm(params.ln_f, x, cfg)
    if cfg.cpd_embedding:  # tied CPD head, no dense table materialised
        return cpd_logits(params.embed_cpd, x)
    return x @ head_matrix(params, cfg)


# Matrix products without batch dimensions (the reference's
# ``dots_with_no_batch_dims_saveable``): what ``remat="dots"`` saves.
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(fn, cfg: ModelConfig):
    """``fn`` recomputed in backward as ``cfg.remat`` says: ``"full"``
    saves only its inputs, ``"dots"`` also the outputs of its matrix
    products (``aten.mm``; batched products, attention's, recompute),
    ``"none"`` everything. Only where autograd records."""
    if cfg.remat not in ("full", "dots", "none"):
        raise ValueError(f"remat must be full, dots or none; got "
                         f"{cfg.remat!r}")
    if cfg.remat == "none" or not torch.is_grad_enabled():
        return fn
    kw = {}
    if cfg.remat == "dots":
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _dots_policy)
    return functools.partial(checkpoint, fn, use_reentrant=False, **kw)


def _cycle(x, cfg: ModelConfig, kinds, enc_out, *cycle_layers):
    for layer, kind in zip(cycle_layers, kinds):
        x = apply_block(layer, x, cfg, kind, enc_out)
    return x


def _check_lengths(cfg: ModelConfig, tokens, embeds, enc_embeds) -> None:
    """Refuse, before any work, a sequence (image prefix included) or an
    encoder input that the attention layers' query chunks cannot take,
    and an encoder-decoder without its encoder input."""
    s = tokens.shape[1]
    if cfg.kind == "vlm" and embeds is not None:
        s += embeds.shape[1]
    if {"attn", "local", "moe", "dec", "enc"} & set(layer_kinds(cfg)):
        layers.check_q_len(s)
    if cfg.n_enc_layers:
        if enc_embeds is None:
            raise ValueError(f"{cfg.name}: the encoder needs enc_embeds")
        layers.check_q_len(enc_embeds.shape[1])


def _embed_inputs(x, cfg: ModelConfig, embeds):
    """The token embeddings ``x`` with a ``vlm``'s image embeddings
    prepended and, where ``rope_theta`` is 0, sinusoidal positions
    added."""
    if cfg.kind == "vlm" and embeds is not None:
        x = torch.cat([embeds.to(x.device, cfg.cdtype), x], dim=1)
    if cfg.rope_theta == 0:     # whisper: absolute sinusoidal positions
        x = x + sinusoidal_pos(x.shape[1], cfg.d_model,
                               device=x.device).to(cfg.cdtype)
    return x


def _enc_inputs(enc_embeds, cfg: ModelConfig):
    """The encoder's input: the frame embeddings in the compute dtype
    with sinusoidal positions added."""
    x = enc_embeds.to(cfg.cdtype)
    return x + sinusoidal_pos(x.shape[1], cfg.d_model,
                              device=x.device).to(cfg.cdtype)


def encode(params, enc_embeds, cfg: ModelConfig):
    """The encoder over (stub) frame embeddings (B, S_enc, D): sinusoidal
    positions, the ``enc`` layers, ``enc_ln_f``."""
    x = _enc_inputs(enc_embeds, cfg)
    run = _remat(_cycle, cfg)
    for layer in params.enc:
        x = run(x, cfg, ("enc",), None, layer)
    return apply_norm(params.enc_ln_f, x, cfg)


def forward(params, cfg: ModelConfig, tokens, embeds=None, enc_embeds=None,
            return_hidden: bool = False):
    """Teacher-forced forward (the prefill step): tokens (B, S) -> logits
    (B, S', Vp) in the compute dtype (Vp = V1 * V2 under the CPD
    embedding), or with ``return_hidden`` the final normed hidden state
    (B, S', D) (the chunked loss owns the head). A ``vlm``'s ``embeds``
    (B, P, D) are prepended (S' = P + S); an encoder-decoder's
    ``enc_embeds`` (B, S_enc, D) go through the encoder once, and every
    ``dec`` layer's cross-attention reads its output. Runs ``wkv6`` once
    per ``rwkv`` layer and ``lru_scan`` once per ``rec`` layer. A length
    that the attention layers' query chunks cannot take is refused
    before any work."""
    _check_lengths(cfg, tokens, embeds, enc_embeds)
    x = _embed_inputs(embed_lookup(params, tokens, cfg), cfg, embeds)
    enc_out = encode(params, enc_embeds, cfg) if cfg.n_enc_layers else None
    run = _remat(_cycle, cfg)
    i = 0
    for pat, rep in cfg.stages():
        for _ in range(rep):
            x = run(x, cfg, pat, enc_out, *params.layers[i:i + len(pat)])
            i += len(pat)
    if return_hidden:
        return apply_norm(params.ln_f, x, cfg)
    return _logits(params, x, cfg)


def encode_tp(ps, enc_embeds, cfg: ModelConfig) -> list:
    """:func:`encode` over the model axis: ``enc_embeds`` one tensor a
    shard; the ``enc`` layers through :func:`apply_block_tp`
    (bidirectional attention), then ``enc_ln_f`` on each replica."""
    xs = [_enc_inputs(e, cfg) for e in enc_embeds]
    for i in range(cfg.n_enc_layers):
        xs = apply_block_tp([p.enc[i] for p in ps], xs, cfg, "enc")
    return [apply_norm(p.enc_ln_f, x, cfg) for p, x in zip(ps, xs)]


def forward_tp(ps, cfg: ModelConfig, tokens, embeds=None, enc_embeds=None):
    """:func:`forward` with ``return_hidden`` over the model axis: ``ps``
    one params view a shard (``unstack_layers`` of its working copies),
    ``tokens`` (and a ``vlm``'s ``embeds``, an encoder-decoder's
    ``enc_embeds``) one tensor a shard; returns each shard's replica of
    the final normed hidden state (the loss owns the head). One shard is
    :func:`forward` itself. Lengths are checked as :func:`forward`
    checks them, before any work."""
    def first(t):
        return None if t is None else t[0]

    if len(ps) == 1:
        return [forward(ps[0], cfg, tokens[0], embeds=first(embeds),
                        enc_embeds=first(enc_embeds), return_hidden=True)]
    check_tp(cfg, len(ps))
    _check_lengths(cfg, tokens[0], first(embeds), first(enc_embeds))
    xs = embed_lookup_tp(ps, tokens, cfg)
    xs = [_embed_inputs(x, cfg, None if embeds is None else embeds[j])
          for j, x in enumerate(xs)]
    enc_outs = (encode_tp(ps, enc_embeds, cfg) if cfg.n_enc_layers
                else [None] * len(ps))
    for i, kind in enumerate(layer_kinds(cfg)):
        xs = apply_block_tp([p.layers[i] for p in ps], xs, cfg, kind,
                            enc_outs)
    return [apply_norm(p.ln_f, x, cfg) for p, x in zip(ps, xs)]


def _zip(trees):
    """Same-keyed trees -> one tree whose leaves are lists."""
    first = trees[0]
    return {k: (_zip([t[k] for t in trees]) if isinstance(first[k], dict)
                else [t[k] for t in trees]) for k in first}


def _pick(tree, c):
    return {k: (_pick(v, c) if isinstance(v, dict) else v[c])
            for k, v in tree.items()}


def stack_layers(cfg: ModelConfig, tree: dict) -> dict:
    """A model's tree (``tree_of(model)``: ``layers`` in order) in the
    reference's stage layout, ``stage{i}/b{j}/...``, each leaf the list of
    that block's tensors over the stage's cycles (the reference's leading
    scan axis, unstacked). The tensors are shared, not copied."""
    layer_list = _layer_list(tree["layers"])
    out = {k: v for k, v in tree.items() if k not in ("layers", "enc")}
    i = 0
    for s, (pat, rep) in enumerate(cfg.stages()):
        n = len(pat)
        out[f"stage{s}"] = {f"b{j}": _zip([layer_list[i + c * n + j]
                                           for c in range(rep)])
                            for j in range(n)}
        i += rep * n
    if "enc" in tree:
        out["enc"] = {"b0": _zip(_layer_list(tree["enc"]))}
    return out


def unstack_layers(cfg: ModelConfig, tree: dict) -> Node:
    """The inverse of :func:`stack_layers`: a :class:`Node` with
    ``layers`` in order, which the model functions take in place of a
    ``Model`` (the tensors are shared, not copied)."""
    out = as_node({k: v for k, v in tree.items()
                   if not k.startswith("stage") and k != "enc"})
    out["layers"] = [as_node(_pick(tree[f"stage{s}"][f"b{j}"], c))
                     for s, (pat, rep) in enumerate(cfg.stages())
                     for c in range(rep) for j in range(len(pat))]
    if "enc" in tree:
        out["enc"] = [as_node(_pick(tree["enc"]["b0"], c))
                      for c in range(cfg.n_enc_layers)]
    return out


def init_cache(cfg: ModelConfig, batch: int, max_len: int | None = None,
               device="cuda", enc_len: int = 0) -> list[dict]:
    """One cache per layer (the reference stacks them per stage).
    ``max_len`` sizes the attention layers' KV caches (an ``attn`` layer
    keeps ``max_len`` positions, a ``local`` one at most ``window``);
    recurrent states need none. A ``dec`` layer's cross cache holds
    ``enc_len`` encoder positions (:func:`build_cross_caches` fills
    it)."""
    dev = device_of(device)
    return [init_block_cache(cfg, kind, batch, max_len, dev, enc_len)
            for kind in layer_kinds(cfg)]


def _first_cache_len(cache) -> int:
    """The first layer's cache position (its ``self`` cache's for a
    ``dec`` layer; 0 for a cache without one, as a recurrent state), the
    reference's offset of a decode step's sinusoidal position."""
    if not cache:
        return 0
    c = cache[0]
    if "self" in c:
        return c["self"]["len"]
    return c.get("len", 0)


def decode_step(params, cache, cfg: ModelConfig, token):
    """token: (B, 1) int -> (logits (B, 1, Vp), new cache)."""
    x = embed_lookup(params, token, cfg)
    if cfg.rope_theta == 0:
        x = x + sinusoidal_pos(1, cfg.d_model, offset=_first_cache_len(cache),
                               device=x.device).to(cfg.cdtype)[None]
    new_cache = []
    for layer, c, kind in zip(params.layers, cache, layer_kinds(cfg)):
        x, c = apply_block_decode(layer, x, c, cfg, kind)
        new_cache.append(c)
    return _logits(params, x, cfg), new_cache


def apply_block_decode_tp(ps, xs, caches, cfg: ModelConfig, kind: str,
                          seq_split: bool = False, cross_split: bool = False,
                          scale_rows: slice = slice(None)):
    """:func:`apply_block_decode` over the model axis: ``ps`` each shard's
    layer params (its working copies), ``xs`` its replica of the token's
    residual stream (B, 1, D), ``caches`` its piece of the layer's cache
    (``seq_split``: the model axis splits the KV cache's sequence;
    ``cross_split``: a ``dec`` layer's cross cache's; ``scale_rows``:
    the shard's batch rows within an int8 cache's whole scales). The
    sublayers run their model-shard forms (``layers.attention_decode_tp``,
    ``rwkv.time_mix_decode_tp``, ``rglru.apply_rglru_decode_tp``,
    ``moe.apply_moe_tp``, the MLP's ``d_ff`` columns) and the partials
    are summed over the axis by the sums the sharded prefill uses
    (``sum_heads``, ``sum_ff``, ``sum_tmix``, ``sum_cmix``, ``sum_rec``,
    ``sum_xattn``). Returns (the new replicas, the new caches)."""
    _check_kind(kind)
    if kind == "rwkv":
        hs = [apply_norm(p.ln1, x, cfg) for p, x in zip(ps, xs)]
        outs, tms = rwkv.time_mix_decode_tp(ps, hs, caches, cfg)
        if rwkv.tmix_split(ps[0], cfg):
            outs = sum_tmix(outs)
        xs = _residual(xs, outs)
        h2s = [apply_norm(p.ln2, x, cfg) for p, x in zip(ps, xs)]
        outs = [rwkv.channel_mix(p, h2, cfg, last=c["last_c"])
                for p, h2, c in zip(ps, h2s, caches)]
        if rwkv.cmix_split(ps[0], cfg):
            outs = sum_cmix(outs)
        return _residual(xs, outs), [{**tm, "last_c": h2}
                                     for tm, h2 in zip(tms, h2s)]
    if kind == "rec":
        hs = [apply_norm(p.ln1, x, cfg) for p, x in zip(ps, xs)]
        outs, rcs = rglru.apply_rglru_decode_tp([p.rec for p in ps], hs,
                                                caches, cfg)
        if rglru.rec_split(ps[0].rec, cfg):
            outs = sum_rec(outs)
        return _mlp_tp(ps, _residual(xs, outs), cfg), rcs
    use_rope = cfg.rope_theta > 0
    heads = layers.heads_split(ps[0].attn, cfg)
    if kind == "dec":
        hs = [apply_norm(p.ln1, x, cfg) for p, x in zip(ps, xs)]
        outs, scs = layers.attention_decode_tp(
            [p.attn for p in ps], hs, [c["self"] for c in caches], cfg,
            use_rope=use_rope, seq_split=seq_split, scale_rows=scale_rows)
        xs = _residual(xs, sum_heads(outs) if heads else outs)
        hs = [apply_norm(p.lnx, x, cfg) for p, x in zip(ps, xs)]
        outs, _ = layers.attention_decode_tp(
            [p.xattn for p in ps], hs, [c["cross"] for c in caches], cfg,
            use_rope=False, cross=True, seq_split=cross_split)
        if layers.heads_split(ps[0].xattn, cfg):
            outs = sum_xattn(outs)
        return _mlp_tp(ps, _residual(xs, outs), cfg), [
            {**c, "self": sc} for c, sc in zip(caches, scs)]
    # a vlm decodes causally, as the reference does (no prefix mask here)
    mask = "window" if kind == "local" else "causal"
    if cfg.parallel_block:
        hs = [apply_norm(p.ln, x, cfg) for p, x in zip(ps, xs)]
        outs, new = layers.attention_decode_tp(
            [p.attn for p in ps], hs, caches, cfg, mask=mask,
            use_rope=use_rope, seq_split=seq_split, scale_rows=scale_rows)
        ffs = [layers.apply_mlp(p.mlp, h, cfg) for p, h in zip(ps, hs)]
        split = layers.mlp_split(ps[0].mlp, cfg)
        if heads and split:
            outs = sum_heads([a + f for a, f in zip(outs, ffs)])
        else:
            outs = sum_heads(outs) if heads else outs
            ffs = sum_ff(ffs) if split else ffs
            outs = [a + f for a, f in zip(outs, ffs)]
        return _residual(xs, outs), new
    hs = [apply_norm(p.ln1, x, cfg) for p, x in zip(ps, xs)]
    outs, new = layers.attention_decode_tp(
        [p.attn for p in ps], hs, caches, cfg, mask=mask,
        use_rope=use_rope, seq_split=seq_split, scale_rows=scale_rows)
    xs = _residual(xs, sum_heads(outs) if heads else outs)
    if kind == "moe":
        hs = [apply_norm(p.ln2, x, cfg) for p, x in zip(ps, xs)]
        return _residual(xs, moe.apply_moe_tp([p.moe for p in ps], hs,
                                              cfg)), new
    return _mlp_tp(ps, xs, cfg), new


#: What a decode step does not read: the encoder, and the keys and values
#: of a ``dec`` block's cross-attention (its cross cache holds them).
_NOT_DECODED = ("enc", "enc_ln_f")
_XATTN_NOT_DECODED = ("wk", "wv", "bk", "bv")


def decode_params(tree: dict) -> dict:
    """``tree`` (a params tree in either layout) without what
    :func:`decode_step` does not read (the reference's jit drops those
    from a decode step's arguments as unused)."""
    def visit(node, key=""):
        if not isinstance(node, dict):
            return node
        return {k: visit(v, k) for k, v in node.items()
                if k not in _NOT_DECODED
                and not (key == "xattn" and k in _XATTN_NOT_DECODED)}

    return visit(tree)


def _working(tree, pos, ctx):
    """Position ``pos``'s working copies (``sharding.working_copy``: its
    model-axis slice, gathered whole over the dp axes) of a tree of
    ``Sharded`` leaves, as a :class:`Node`."""
    if isinstance(tree, dict):
        return Node({k: _working(v, pos, ctx) for k, v in tree.items()})
    return sharding.working_copy(tree, pos, ctx)


def _cache_at(cache, pos):
    """Position ``pos``'s piece of a placed cache (counters as they
    are)."""
    if isinstance(cache, dict):
        return {k: _cache_at(v, pos) for k, v in cache.items()}
    return cache.at(pos) if isinstance(cache, sharding.Sharded) else cache


def _cache_from(old, new: dict, pos0, rows: dict, name: str = ""):
    """The placed cache laid out as ``old`` from ``new`` (position -> its
    piece of the new cache; counters from ``pos0``'s). An int8 cache's
    scales, whole on every position, take each dp slice's batch rows
    (``rows``: position -> its rows) from that slice's positions: the
    all-gather that keeps the replicas equal."""
    if isinstance(old, dict):
        return {k: _cache_from(v, {p: c[k] for p, c in new.items()}, pos0,
                               None if k == "cross" else rows, k)
                for k, v in old.items()}
    if not isinstance(old, sharding.Sharded):
        return new[pos0]
    if name in ("k_scale", "v_scale") and rows \
            and rows[pos0] != slice(None):
        first = {}
        for pos, sl in rows.items():
            first.setdefault((sl.start, sl.stop), pos)
        merged = sharding.gather_rows([new[p] for p in first.values()],
                                      [rows[p] for p in first.values()],
                                      old.mesh.size)
        new = {pos: merged.to(old.mesh.devices[pos]) for pos in new}
    return sharding.from_positions(old.mesh, old.spec, old.shape, new)


def _seq_split(cache) -> bool:
    return cache["k"].spec[1] is not None


def _scale_rows(cache, pos) -> slice:
    """The batch rows of ``pos``'s KV piece within the int8 cache's whole
    scales (all of them where the scales are split alike)."""
    while "k" not in cache:
        cache = cache["self"]
    k = cache["k"]
    if "k_scale" not in cache or cache["k_scale"].spec[0] == k.spec[0]:
        return slice(None)
    n = k.at(pos).shape[0]
    lo = sharding.block_of(k.mesh, k.spec, pos)[0] * n
    return slice(lo, lo + n)


def decode_step_tp(ps, caches, cfg: ModelConfig, tokens):
    """:func:`decode_step` over a mesh: ``ps`` the params placed by
    ``sharding.param_sharding_tree`` (the stage layout of
    :func:`stack_layers`, each leaf ``Sharded``; what the step does not
    read, :func:`decode_params`, may be left out), ``caches`` the cache
    placed by ``launch.specs.cache_shardings``, ``tokens`` (B, 1) (placed
    here over the dp axes where they divide B, if not placed). Each row
    of model shards (``sharding.model_rows``: one dp slice of the batch)
    runs the step: each position gathers its fsdp dims of one layer's
    params at a time (``sharding.working_copy``; freed after the layer),
    and :func:`apply_block_decode_tp` runs the layer. Returns (logits
    (B, 1, Vp) laid out over the dp axes on the batch and, where the
    head is vocab-split, the model axis on the vocab; the new cache in
    the placement of ``caches``)."""
    leaf = ps
    while isinstance(leaf, (dict, list)):
        leaf = next(iter(leaf.values())) if isinstance(leaf, dict) \
            else leaf[0]
    mesh = leaf.mesh
    ctx = sharding.make_ctx(mesh)
    check_tp(cfg, ctx.tp)
    if not isinstance(tokens, sharding.Sharded):
        tokens = sharding.place_tensor(tokens, ctx.resolve(
            *sharding.fit_tags(tokens.shape, ("dp", None), ctx)), mesh)
    node = unstack_layers(cfg, decode_params(ps))
    top = {k: v for k, v in node.items() if k != "layers"}
    kinds = layer_kinds(cfg)
    offset = _first_cache_len(caches)
    rows = sharding.model_rows(mesh, ctx.tp_axis)
    new = [{} for _ in caches]
    rows_of = [{} for _ in caches]
    logits = {}
    for row in rows:
        tops = [_working(top, pos, ctx) for pos in row]
        xs = embed_lookup_tp(tops, [tokens.at(pos) for pos in row], cfg)
        if cfg.rope_theta == 0:
            xs = [x + sinusoidal_pos(1, cfg.d_model, offset=offset,
                                     device=x.device).to(cfg.cdtype)[None]
                  for x in xs]
        for i, kind in enumerate(kinds):
            lps = [_working(node.layers[i], pos, ctx) for pos in row]
            c = caches[i]
            split = {}
            if kind == "dec":
                split = {"seq_split": _seq_split(c["self"]),
                         "cross_split": _seq_split(c["cross"])}
            elif kind not in ("rwkv", "rec"):
                split = {"seq_split": _seq_split(c)}
            if split:
                split["scale_rows"] = rows_of[i].setdefault(
                    row[0], _scale_rows(c, row[0]))
                rows_of[i].update({pos: split["scale_rows"] for pos in row})
            xs, cs = apply_block_decode_tp(
                lps, xs, [_cache_at(c, pos) for pos in row], cfg, kind,
                **split)
            del lps
            new[i].update(zip(row, cs))
        for pos, p, x in zip(row, tops, xs):
            logits[pos] = _logits(p, x, cfg)
    pos0 = rows[0][0]
    width = logits[pos0].shape[-1]
    vocab = (ctx.tp_axis if not cfg.cpd_embedding
             and width < cfg.vocab_padded else None)
    shape = (tokens.shape[0], 1, width * (ctx.tp if vocab else 1))
    out = sharding.from_positions(mesh, (tokens.spec[0], None, vocab),
                                  shape, logits)
    return out, [_cache_from(c, n, pos0, r)
                 for c, n, r in zip(caches, new, rows_of)]


def build_cross_caches(params, cfg: ModelConfig, enc_embeds, cache):
    """Run the encoder once and fill every ``dec`` layer's cross cache
    with its ``xattn`` keys and values of the encoder's output (and
    ``kv_len``, the encoder's length); returns the new cache list."""
    enc_out = encode(params, enc_embeds, cfg)
    dt = cfg.cdtype
    new_cache = list(cache)
    for i, (layer, kind) in enumerate(zip(params.layers, layer_kinds(cfg))):
        if kind != "dec":
            continue
        xp = layer.xattn
        k, v = layers._proj(enc_out, xp.wk, dt), layers._proj(enc_out,
                                                              xp.wv, dt)
        if hasattr(xp, "bk"):
            k, v = k + xp.bk.to(dt), v + xp.bv.to(dt)
        cross = {**cache[i]["cross"], "k": k, "v": v,
                 "kv_len": enc_out.shape[1]}
        new_cache[i] = {**cache[i], "cross": cross}
    return new_cache


__all__ = ["Model", "apply_block", "apply_block_decode",
           "apply_block_decode_tp", "apply_block_tp", "build_cross_caches",
           "check_tp", "decode_params", "decode_step", "decode_step_tp",
           "embed_lookup", "embed_lookup_tp", "encode", "encode_tp",
           "forward", "forward_tp",
           "head_matrix", "init_block", "init_cache", "init_model",
           "layer_kinds", "sinusoidal_pos", "stack_layers",
           "unstack_layers", "vocab_split"]
