"""Model assembly: init, the teacher-forced ``forward`` (the prefill
step) and the one-token ``decode_step`` over a per-layer cache, for the
block kinds

  attn   pre-norm GQA causal attention + MLP (tinyllama, olmo, qwen2.5)
  moe    GQA causal attention + the top-k MoE FFN (olmoe, qwen3-moe;
         ``models.moe``)
  rwkv   RWKV-6 time-mix + channel-mix (rwkv6-3b)
  rec    RG-LRU recurrent block + MLP (griffin: recurrentgemma-9b)
  local  sliding-window attention + MLP (griffin attention layers)

and either a dense embedding table or the CPD-factorized one
(``cfg.cpd_embedding``: ``tensorized.cpd_embed`` for the lookup, whose
backward is the spMTTKRP of the token batch, and ``cpd_logits`` for the
tied head).

The reference stacks the layers of a stage and drives them with one
``lax.scan``; here the layers are an ``nn.ModuleList`` walked in a loop,
in the same order (``ModelConfig.stages``). Where autograd records, each
cycle of a stage's pattern (the reference's scan body) is recomputed in
backward as ``cfg.remat`` says, like the reference's ``_remat``. The
model functions take a ``Model`` or a ``Node`` tree of the same keys
(:func:`unstack_layers`: the train step's trees of tensors that require
grad); :func:`stack_layers` gives a model's tree the reference's
stage layout. Other block kinds and model features raise
``NotImplementedError`` naming their ROADMAP item; the reference's
``shard(...)`` hints are dropped.

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
gathered into every replica). Only the ``attn`` and ``moe`` kinds have
this path; a model axis above 1 with ``rwkv``, ``rec`` or ``local``
layers raises ``NotImplementedError`` naming its ROADMAP item.
"""
from __future__ import annotations

import functools

import torch
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from .. import sharding
from ..tensorized import (cpd_embed, cpd_logits, dense_table,
                          init_cpd_embedding)
from . import layers, moe, rglru, rwkv
from .common import (ModelConfig, Node, Params, apply_norm, as_node,
                     dense_init, device_of, init_norm, param)

_NOT_PORTED = "ROADMAP Queue A item 12.4b (LM side: the other families)"
_NO_TP = ("tensor parallelism (a model axis above 1) of the rwkv, rec and "
          "local blocks is ROADMAP Queue A item 12.3b; train these on a "
          "mesh whose model axis is 1 (dp + fsdp)")
#: Block kinds the port runs.
PORTED_KINDS = ("attn", "moe", "rwkv", "rec", "local")


def layer_kinds(cfg: ModelConfig) -> list[str]:
    """Block kind of every layer, in order."""
    return [kind for pat, rep in cfg.stages() for _ in range(rep)
            for kind in pat]


def _check_ported(cfg: ModelConfig) -> None:
    other = sorted(set(layer_kinds(cfg)) - set(PORTED_KINDS))
    if other or cfg.n_enc_layers:
        raise NotImplementedError(
            f"block kinds {other or ['enc']} are {_NOT_PORTED}")
    if cfg.parallel_block:
        raise NotImplementedError(f"parallel_block (command-r) is "
                                  f"{_NOT_PORTED}")
    if cfg.kind == "vlm":
        raise NotImplementedError(f"prefix attention and image embeddings "
                                  f"(paligemma) are {_NOT_PORTED}")
    if cfg.rope_theta == 0:
        raise NotImplementedError(f"sinusoidal positions (whisper) are "
                                  f"{_NOT_PORTED}")


class Model(nn.Module):
    """The parameters of a model, under the reference's keys, with the
    layers unstacked: ``embed`` (or, with ``cfg.cpd_embedding``,
    ``embed_cpd`` holding ``A``, ``B``, ``C``), ``layers[i]`` (the
    reference's ``stage*/b*`` slice of layer i), ``ln_f`` and ``head``
    (absent when the head is tied or CPD)."""

    def __init__(self, cfg: ModelConfig, tree: dict):
        super().__init__()
        _check_ported(cfg)
        self.cfg = cfg
        if cfg.cpd_embedding:
            self.embed_cpd = Params(tree["embed_cpd"])
        else:
            self.embed = param(tree["embed"])
        self.layers = nn.ModuleList(Params(b) for b in tree["layers"])
        self.ln_f = Params(tree["ln_f"])
        if "head" in tree:
            self.head = param(tree["head"])


# --------------------------------------------------------------------------
# Blocks
# --------------------------------------------------------------------------
def _check_kind(kind: str) -> None:
    if kind not in PORTED_KINDS:
        raise NotImplementedError(f"block kind {kind!r} is {_NOT_PORTED}")


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
    p = {"attn": layers.init_attention(cfg, generator),
         "ln1": init_norm(cfg, dev), "ln2": init_norm(cfg, dev)}
    if kind == "moe":
        p["moe"] = moe.init_moe(cfg, generator)
    else:
        p["mlp"] = layers.init_mlp(cfg, generator)
    return p


def _mask_kind(kind: str) -> str:
    """A ``local`` layer attends within its window, an ``attn`` layer
    causally (the reference's ``_attn_mask_kind`` for the ported
    kinds)."""
    return "window" if kind == "local" else "causal"


def apply_block(params, x, cfg: ModelConfig, kind: str):
    _check_kind(kind)
    if kind == "rwkv":
        x = x + rwkv.time_mix(params, apply_norm(params.ln1, x, cfg), cfg)
        return x + rwkv.channel_mix(params, apply_norm(params.ln2, x, cfg),
                                    cfg)
    if kind == "rec":
        x = x + rglru.apply_rglru(params.rec,
                                  apply_norm(params.ln1, x, cfg), cfg)
        return x + _mlp_part(params, x, cfg)
    x = x + _attn_part(params, x, cfg, kind)
    if kind == "moe":
        return x + moe.apply_moe(params.moe, apply_norm(params.ln2, x, cfg),
                                 cfg)
    return x + _mlp_part(params, x, cfg)


def _attn_part(p, x, cfg: ModelConfig, kind: str, j: int | None = None):
    """The attention sublayer's output (before the residual). Under
    tensor parallelism (model shard ``j``), where the heads are split, it
    is shard ``j``'s partial output of ``wo``; where they are not, the
    whole output."""
    attn, cj = p.attn, cfg
    if j is not None and layers.heads_split(p.attn, cfg):
        attn, cj = layers.attention_shard(p.attn, cfg, j)
    return layers.attention_full(attn, apply_norm(p.ln1, x, cfg), cj,
                                 mask=_mask_kind(kind),
                                 use_rope=cfg.rope_theta > 0)


def _mlp_part(p, x, cfg: ModelConfig):
    """The MLP sublayer's output (before the residual): a partial output
    of ``w_down`` where the model axis splits ``d_ff``."""
    return layers.apply_mlp(p.mlp, apply_norm(p.ln2, x, cfg), cfg)


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
    h = apply_norm(params.ln1, x, cfg)
    o, new_cache = layers.attention_decode(params.attn, h, cache, cfg,
                                           mask=_mask_kind(kind),
                                           use_rope=use_rope)
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


def check_tp(cfg: ModelConfig, tp: int) -> None:
    """Refuse a model axis above 1 for the block kinds without a tensor
    parallel path, and one that does not divide the experts."""
    kinds = set(layer_kinds(cfg))
    other = sorted(kinds - {"attn", "moe"})
    if tp > 1 and other:
        raise NotImplementedError(f"{cfg.name}: {_NO_TP} (kinds {other})")
    if "moe" in kinds and cfg.n_experts % tp:
        raise ValueError(f"{cfg.name}: {cfg.n_experts} experts do not "
                         f"divide over a model axis of {tp}")


def apply_block_tp(ps, xs, cfg: ModelConfig, kind: str):
    """One ``attn`` or ``moe`` block over the model axis: ``ps`` holds
    each shard's layer params, ``xs`` its replica of the residual stream
    (on its device); returns the new replicas. Each shard's sublayer (a
    ``moe`` FFN's dispatch, experts and combine apart) is recomputed in
    backward as ``cfg.remat`` says, apart from the other shards' (a
    recompute stays on one device: the autograd engine runs each
    device's backward on its own thread), and the sums and exchanges
    over the model axis sit between them."""
    if kind not in ("attn", "moe"):
        raise NotImplementedError(f"block kind {kind!r}: {_NO_TP}")
    attn, mlp = _remat(_attn_part, cfg), _remat(_mlp_part, cfg)
    outs = [attn(p, x, cfg, kind, j)
            for j, (p, x) in enumerate(zip(ps, xs))]
    if layers.heads_split(ps[0].attn, cfg):
        outs = sum_heads(outs)
    xs = [x + o for x, o in zip(xs, outs)]
    if kind == "moe":
        hs = [apply_norm(p.ln2, x, cfg) for p, x in zip(ps, xs)]
        outs = moe.apply_moe_tp([p.moe for p in ps], hs, cfg,
                                remat=lambda fn: _remat(fn, cfg))
        return [x + o for x, o in zip(xs, outs)]
    outs = [mlp(p, x, cfg) for p, x in zip(ps, xs)]
    if layers.mlp_split(ps[0].mlp, cfg):
        outs = sum_ff(outs)
    return [x + o for x, o in zip(xs, outs)]


def init_block_cache(cfg: ModelConfig, kind: str, batch: int,
                     max_len: int | None, device) -> dict:
    _check_kind(kind)
    if kind == "rwkv":
        return rwkv.make_rwkv_cache(cfg, batch, device)
    if kind == "rec":
        return rglru.make_rglru_cache(cfg, batch, device)
    if max_len is None:
        raise ValueError(f"a {kind!r} layer's KV cache needs max_len")
    return layers.make_attn_cache(cfg, batch, max_len, device,
                                  windowed=(kind == "local"))


# --------------------------------------------------------------------------
# Whole model
# --------------------------------------------------------------------------
def init_model(cfg: ModelConfig, seed: int = 0, *, device="cuda") -> Model:
    """Random parameters on ``device``, drawn from a
    ``torch.Generator`` on that device seeded with ``seed``."""
    _check_ported(cfg)
    gen = torch.Generator(device=device_of(device)).manual_seed(seed)
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
    return Model(cfg, tree)


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


def _cycle(x, cfg: ModelConfig, kinds, *cycle_layers):
    for layer, kind in zip(cycle_layers, kinds):
        x = apply_block(layer, x, cfg, kind)
    return x


def forward(params, cfg: ModelConfig, tokens, return_hidden: bool = False):
    """Teacher-forced forward (the prefill step): tokens (B, S) -> logits
    (B, S, Vp) in the compute dtype (Vp = V1 * V2 under the CPD
    embedding), or with ``return_hidden`` the final normed hidden state
    (B, S, D) (the chunked loss owns the head). Runs ``wkv6`` once per
    ``rwkv`` layer and ``lru_scan`` once per ``rec`` layer. A length that
    the attention layers' query chunks cannot take is refused before any
    work."""
    if {"attn", "local", "moe"} & set(layer_kinds(cfg)):
        layers.check_q_len(tokens.shape[1])
    x = embed_lookup(params, tokens, cfg)
    run = _remat(_cycle, cfg)
    i = 0
    for pat, rep in cfg.stages():
        for _ in range(rep):
            x = run(x, cfg, pat, *params.layers[i:i + len(pat)])
            i += len(pat)
    if return_hidden:
        return apply_norm(params.ln_f, x, cfg)
    return _logits(params, x, cfg)


def forward_tp(ps, cfg: ModelConfig, tokens):
    """:func:`forward` with ``return_hidden`` over the model axis: ``ps``
    one params view a shard (``unstack_layers`` of its working copies),
    ``tokens`` one (B, S) tensor a shard; returns each shard's replica of
    the final normed hidden state (the loss owns the head). One shard is
    :func:`forward` itself."""
    if len(ps) == 1:
        return [forward(ps[0], cfg, tokens[0], return_hidden=True)]
    check_tp(cfg, len(ps))
    layers.check_q_len(tokens[0].shape[1])
    xs = embed_lookup_tp(ps, tokens, cfg)
    for i, kind in enumerate(layer_kinds(cfg)):
        xs = apply_block_tp([p.layers[i] for p in ps], xs, cfg, kind)
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
    layer_list = tree["layers"]
    if isinstance(layer_list, dict):                 # a ModuleList's tree
        layer_list = [layer_list[str(i)] for i in range(len(layer_list))]
    out = {k: v for k, v in tree.items() if k != "layers"}
    i = 0
    for s, (pat, rep) in enumerate(cfg.stages()):
        n = len(pat)
        out[f"stage{s}"] = {f"b{j}": _zip([layer_list[i + c * n + j]
                                           for c in range(rep)])
                            for j in range(n)}
        i += rep * n
    return out


def unstack_layers(cfg: ModelConfig, tree: dict) -> Node:
    """The inverse of :func:`stack_layers`: a :class:`Node` with
    ``layers`` in order, which the model functions take in place of a
    ``Model`` (the tensors are shared, not copied)."""
    out = as_node({k: v for k, v in tree.items()
                   if not k.startswith("stage")})
    out["layers"] = [as_node(_pick(tree[f"stage{s}"][f"b{j}"], c))
                     for s, (pat, rep) in enumerate(cfg.stages())
                     for c in range(rep) for j in range(len(pat))]
    return out


def init_cache(cfg: ModelConfig, batch: int, max_len: int | None = None,
               device="cuda") -> list[dict]:
    """One cache per layer (the reference stacks them per stage).
    ``max_len`` sizes the attention layers' KV caches (an ``attn`` layer
    keeps ``max_len`` positions, a ``local`` one at most ``window``);
    recurrent states need none."""
    dev = device_of(device)
    return [init_block_cache(cfg, kind, batch, max_len, dev)
            for kind in layer_kinds(cfg)]


def decode_step(params, cache, cfg: ModelConfig, token):
    """token: (B, 1) int -> (logits (B, 1, Vp), new cache)."""
    x = embed_lookup(params, token, cfg)
    new_cache = []
    for layer, c, kind in zip(params.layers, cache, layer_kinds(cfg)):
        x, c = apply_block_decode(layer, x, c, cfg, kind)
        new_cache.append(c)
    return _logits(params, x, cfg), new_cache


__all__ = ["Model", "apply_block", "apply_block_decode", "apply_block_tp",
           "check_tp", "decode_step", "embed_lookup", "embed_lookup_tp",
           "forward", "forward_tp", "head_matrix", "init_block",
           "init_cache", "init_model", "layer_kinds", "stack_layers",
           "unstack_layers", "vocab_split"]
