"""Attention (GQA/MQA, causal/sliding-window/prefix/bidirectional/cross,
prefill + decode), MLP and RoPE: the reference's ``models/layers.py``.

The prefill attention loops over query chunks in Python, as the
reference's does, and for a sliding window touches only the (window +
chunk) band of keys a chunk can see. Where autograd records, each chunk
is recomputed in backward (the reference's ``jax.checkpoint`` of a
chunk), so that one chunk's f32 logits are live at a time. Decode keeps a
windowed layer's keys and values in a ring buffer; cross-attention
(whisper's decoder) reads a cache of the encoder's keys and values that
``models.transformer.build_cross_caches`` fills once. With ``kv_quant``
the self-attention cache holds int8 rows and a float32 scale a (position,
head) (:func:`_quantize_rows`), read back as ``int8 * scale`` in the
compute dtype. The reference's ``shard(...)`` hints and ``set_cost_mode``
(an XLA cost-measurement switch) are dropped. ``p`` is a layer's
parameter module (the reference's keys as attributes).

Tensor parallelism (``models.transformer.apply_block_tp``): shard ``j`` of
the model axis runs these same functions on its slice of the weights and
a narrowed config (:func:`attention_shard`: ``n_heads / tp`` query heads
and the KV heads they read; a cross-attention's keys and values from the
shard's replica of the encoder's output); the caller sums the partial
outputs of ``wo`` and ``w_down`` over the model axis.
"""
from __future__ import annotations

import dataclasses
import functools
import math

import torch
import torch.nn.functional as F

from torch.utils.checkpoint import checkpoint

from .. import sharding
from .common import ModelConfig, Node, dense_init

_NEG = -1e30


def gelu(x):
    """``jax.nn.gelu``'s default, the tanh approximation (torch's default
    is the erf form, ~1e-3 away)."""
    return F.gelu(x, approximate="tanh")


def rms_head_norm(x, scale, eps: float = 1e-6):
    """QK-norm (per-head RMS norm over the last axis), in f32, cast
    back."""
    xf = x.float()
    xf = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
    return (xf * scale.float()).to(x.dtype)


# --------------------------------------------------------------------------
# RoPE
# --------------------------------------------------------------------------
def apply_rope(x, pos, theta: float):
    """x: (..., S, H, hd); pos: broadcastable to (..., S). The half-split
    layout (not interleaved), angles in f32."""
    half = x.shape[-1] // 2
    freqs = torch.exp(-math.log(theta) * torch.arange(
        0, half, dtype=torch.float32, device=x.device) / half)
    ang = pos[..., None].float() * freqs                  # (..., S, half)
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------------------
# Attention
# --------------------------------------------------------------------------
def init_attention(cfg: ModelConfig, generator: torch.Generator,
                   cross: bool = False) -> dict:
    """Self- or cross-attention parameters: the same leaves (``cross``
    changes nothing, as in the reference)."""
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    dev, pdt = generator.device, cfg.pdtype
    p = {"wq": dense_init((d, h, hd), pdt, generator=generator),
         "wk": dense_init((d, kv, hd), pdt, generator=generator),
         "wv": dense_init((d, kv, hd), pdt, generator=generator),
         "wo": dense_init((h, hd, d), pdt, 1.0 / math.sqrt(h * hd),
                          generator=generator)}
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((h, hd), dtype=pdt, device=dev)
        p["bk"] = torch.zeros((kv, hd), dtype=pdt, device=dev)
        p["bv"] = torch.zeros((kv, hd), dtype=pdt, device=dev)
    if cfg.qk_norm:
        p["q_scale"] = torch.ones((hd,), dtype=pdt, device=dev)
        p["k_scale"] = torch.ones((hd,), dtype=pdt, device=dev)
    return p


#: The attention leaves a decode step casts to the compute dtype at use
#: (``q_scale`` / ``k_scale`` it reads in float32).
ATTN_CAST = ("wq", "wk", "wv", "wo", "bq", "bk", "bv")
#: The MLP leaves :func:`apply_mlp` casts at use.
MLP_CAST = ("w_gate", "w_up", "w_down")


def _proj(x, w, dt):
    """einsum ``bsd,dhk->bshk`` as one matrix product."""
    b, s, _ = x.shape
    return (x @ w.to(dt).flatten(1)).view(b, s, *w.shape[1:])


def _qkv(p, xq, xkv, cfg: ModelConfig, q_pos, kv_pos, use_rope: bool):
    dt = cfg.cdtype
    q, k, v = _proj(xq, p.wq, dt), _proj(xkv, p.wk, dt), _proj(xkv, p.wv, dt)
    if hasattr(p, "bq"):
        q = q + p.bq.to(dt)
        k = k + p.bk.to(dt)
        v = v + p.bv.to(dt)
    if hasattr(p, "q_scale"):
        q = rms_head_norm(q, p.q_scale)
        k = rms_head_norm(k, p.k_scale)
    if use_rope:
        q = apply_rope(q, q_pos, cfg.rope_theta)
        k = apply_rope(k, kv_pos, cfg.rope_theta)
    return q, k, v


def _mask(kind: str, q_pos, k_pos, window: int, prefix_len: int):
    """(Q, K) boolean mask from absolute positions."""
    qp = q_pos[:, None]
    kp = k_pos[None, :]
    if kind == "bidir":
        return torch.ones((q_pos.shape[0], k_pos.shape[0]), dtype=torch.bool,
                          device=q_pos.device)
    m = kp <= qp  # causal
    if kind == "window":
        m = m & (kp > qp - window)
    elif kind == "prefix":
        m = m | (kp < prefix_len)
    return m


def check_q_len(sq: int, q_chunk: int = 512) -> None:
    """Refuse a query length the reference's chunk loop cannot take: past
    one chunk, S must be a multiple of it (the reference fails reshaping
    the stacked chunks otherwise)."""
    cq = min(q_chunk, sq)
    if sq % cq:
        raise ValueError(f"attention: S={sq} is more than one query chunk "
                         f"of {cq} and not a multiple of it")


def attention_full(p, xq, cfg: ModelConfig, *, mask: str = "causal",
                   xkv=None, q_offset: int = 0, prefix_len: int = 0,
                   use_rope: bool = True, q_chunk: int = 512):
    """Prefill attention, chunked over queries in a Python loop. The keys
    and values come from ``xkv`` (cross-attention: the encoder's output,
    of any length) or, without it, from ``xq``. For ``mask="window"``
    with more keys than window + chunk, each chunk touches only the
    (window + chunk) band of keys it can see."""
    b, sq, _ = xq.shape
    check_q_len(sq, q_chunk)
    xkv = xq if xkv is None else xkv
    skv = xkv.shape[1]
    h, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    g = h // kvh
    dev = xq.device
    q_pos_all = q_offset + torch.arange(sq, device=dev)
    kv_pos_all = torch.arange(skv, device=dev)
    q, k, v = _qkv(p, xq, xkv, cfg, q_pos_all, kv_pos_all, use_rope)
    if g > 1:  # grouped KV expanded to every head, as the reference does
        k = k.repeat_interleave(g, dim=2)
        v = v.repeat_interleave(g, dim=2)
    # (B, H, S, hd), contiguous: a band of keys is then a strided batch
    q, k, v = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    scale = 1.0 / math.sqrt(hd)

    cq = min(q_chunk, sq)
    band = cfg.window + cq
    banded = mask == "window" and skv > band

    def chunk(qc, kc, vc, q_lo, k_lo):
        """One query chunk against its keys (absolute positions from
        ``q_lo`` and ``k_lo``): (B, cq, H, hd)."""
        logits = (qc @ kc.transpose(2, 3)).float() * scale   # (B, H, cq, s)
        m = _mask(mask, q_lo + torch.arange(cq, device=dev),
                  k_lo + torch.arange(kc.shape[2], device=dev), cfg.window,
                  prefix_len)
        logits = torch.where(m, logits, _NEG)
        probs = torch.softmax(logits, dim=-1).to(cfg.cdtype)
        return (probs @ vc).transpose(1, 2)

    def keys(lo):
        if not banded:
            return k, v, 0
        start = min(max(lo + q_offset - cfg.window, 0), skv - band)
        return k[:, :, start:start + band], v[:, :, start:start + band], start

    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        outs = []
        for lo in range(0, sq, cq):
            kc, vc, k_lo = keys(lo)
            outs.append(checkpoint(chunk, q[:, :, lo:lo + cq], kc, vc,
                                   q_offset + lo, k_lo, use_reentrant=False))
        o = torch.cat(outs, dim=1)
    else:
        o = torch.empty((b, sq, h, hd), dtype=cfg.cdtype, device=dev)
        for lo in range(0, sq, cq):
            kc, vc, k_lo = keys(lo)
            o[:, lo:lo + cq] = chunk(q[:, :, lo:lo + cq], kc, vc,
                                     q_offset + lo, k_lo)
    return o.flatten(2) @ p.wo.to(cfg.cdtype).flatten(0, 1)


@functools.lru_cache(maxsize=None)
def _narrow(cfg: ModelConfig, n_heads: int, n_kv_heads: int) -> ModelConfig:
    return dataclasses.replace(cfg, n_heads=n_heads, n_kv_heads=n_kv_heads,
                               head_dim=cfg.hd)


def heads_split(p, cfg: ModelConfig) -> bool:
    """Whether the model axis splits this attention's heads (the partial
    outputs of ``wo`` are then summed over it). Where the heads do not
    divide the axis, the reference's guard replicates ``wq`` / ``wo`` and
    the whole attention runs on every shard, unsummed."""
    return p.wq.shape[1] < cfg.n_heads


def attention_shard(p, cfg: ModelConfig, j: int):
    """Shard ``j``'s attention params and narrowed config, for split
    heads (:func:`heads_split`). ``p`` holds what the shard computes with
    (``sharding.working_copy``): ``wq`` / ``wo`` with its ``n_heads /
    tp`` heads. ``wk`` / ``wv`` come split alike when the KV heads divide
    the model axis; otherwise they are whole (replicated) and the shard
    slices the KV heads its query heads read (all the shard's query
    heads in one KV group, or whole groups), or, when its heads cut a
    group, gathers one KV head a query head. Biases are replicated and
    sliced here."""
    h = p.wq.shape[1]
    g = cfg.n_heads // cfg.n_kv_heads
    q_lo = j * h
    out = Node({k: v for k, v in p.items() if k not in ("bq", "bk", "bv")})
    kv = p.wk.shape[1]
    if kv < cfg.n_kv_heads:                       # split with the queries
        kv_idx = slice(j * kv, (j + 1) * kv)
    else:
        lo, hi = q_lo // g, (q_lo + h - 1) // g + 1
        if hi - lo == 1 or (q_lo % g == 0 and h % g == 0):
            kv_idx, kv = slice(lo, hi), hi - lo
        else:                                     # a group cut: per head
            kv_idx = torch.arange(q_lo, q_lo + h,
                                  device=p.wk.device) // g
            kv = h
        out["wk"], out["wv"] = p.wk[:, kv_idx], p.wv[:, kv_idx]
    if "bq" in p:
        out["bq"] = p.bq[q_lo:q_lo + h]
        out["bk"], out["bv"] = p.bk[kv_idx], p.bv[kv_idx]
    return out, _narrow(cfg, h, kv)


def mlp_split(p, cfg: ModelConfig) -> bool:
    """Whether the model axis splits this MLP's ``d_ff`` (the partial
    outputs of ``w_down`` are then summed over it)."""
    return p.w_up.shape[-1] < cfg.d_ff


def position(cache: dict, device) -> torch.Tensor:
    """A cache's position ``len``: a 0-d int64 tensor on the cache's
    device (a Python int, as a hand-made cache may hold, becomes one on
    ``device``)."""
    pos = cache["len"]
    return pos if torch.is_tensor(pos) else torch.tensor(pos, device=device)


def check_room(pos: torch.Tensor, smax: int) -> None:
    """Refuse a write at ``pos`` past a causal cache of ``smax``
    positions. The check reads the position back (a sync on the card); a
    ``meta`` position has no value, and a CUDA graph's capture cannot
    read one, so both skip it: ``serving.Engine`` checks its host
    counter before any work instead."""
    if pos.device.type == "meta" or (
            pos.is_cuda and torch.cuda.is_current_stream_capturing()):
        return
    if int(pos) >= smax:
        raise ValueError(f"attention_decode: the causal KV cache holds "
                         f"{smax} positions and is full (position "
                         f"{int(pos)})")


def attention_decode(p, xq, cache: dict, cfg: ModelConfig, *,
                     mask: str = "causal", use_rope: bool = True,
                     cross: bool = False):
    """One-token decode. cache: {"k", "v": (B, Smax, KV, hd), "len": a
    0-d int64 tensor on the cache's device} (with ``kv_quant`` int8 ``k``
    / ``v`` and float32 ``k_scale`` / ``v_scale`` of (B, Smax, KV, 1)).
    Self-attention writes the new key and value at ``len`` (modulo Smax
    for a windowed layer: a ring buffer) in place (``index_copy_`` at a
    device slot, so a CUDA graph replays it at each step's position);
    returns (out, new cache), the new cache holding the same key and
    value tensors and ``len + 1``. The RoPE positions, the slot and the
    valid keys come from the device position. A full causal cache raises
    (:func:`check_room`; the reference clamps the write to its last
    slot). Cross-attention (``cross``) reads the encoder's keys and
    values, the first ``kv_len`` of them, and writes nothing."""
    b = xq.shape[0]
    h, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    g = h // kvh
    dt = cfg.cdtype
    smax = cache["k"].shape[1]
    q = _proj(xq, p.wq, dt)
    if hasattr(p, "bq"):
        q = q + p.bq.to(dt)
    if hasattr(p, "q_scale"):
        q = rms_head_norm(q, p.q_scale)
    if cross:
        if use_rope:
            q = apply_rope(q, position(cache, xq.device).expand(b, 1),
                           cfg.rope_theta)
        k, v = cache["k"], cache["v"]
        new_cache = cache
        valid = torch.arange(smax, device=xq.device) < cache.get("kv_len",
                                                                 smax)
    else:
        pos = position(cache, xq.device)
        if mask != "window":
            check_room(pos, smax)
        posv = pos.expand(b, 1)
        if use_rope:
            q = apply_rope(q, posv, cfg.rope_theta)
        knew, vnew = _proj(xq, p.wk, dt), _proj(xq, p.wv, dt)
        if hasattr(p, "bk"):
            knew = knew + p.bk.to(dt)
            vnew = vnew + p.bv.to(dt)
        if hasattr(p, "k_scale"):
            knew = rms_head_norm(knew, p.k_scale)
        if use_rope:
            knew = apply_rope(knew, posv, cfg.rope_theta)
        slot = pos % smax if mask == "window" else pos
        new_cache = {**cache, "len": pos + 1}
        if "k_scale" in cache:                          # int8 KV cache
            for name, row in (("k", knew), ("v", vnew)):
                rq, rs = _quantize_rows(row)
                _write(cache[name], slot, rq)
                _write(cache[f"{name}_scale"], slot, rs)
            k, v = ((cache[n].float() * cache[f"{n}_scale"]).to(dt)
                    for n in ("k", "v"))
        else:
            k = _write(cache["k"], slot, knew.to(dt))
            v = _write(cache["v"], slot, vnew.to(dt))
        # a ring's slots all hold keys once it wrapped: arange < min(pos
        # + 1, smax) is arange <= pos for both masks
        valid = torch.arange(smax, device=xq.device) <= pos

    qg = q.reshape(b, kvh, g, hd)                    # heads as (n, g)
    logits = (qg @ k.permute(0, 2, 3, 1)).float()    # (B, KV, g, Smax)
    logits = logits / math.sqrt(hd)
    logits = torch.where(valid, logits, _NEG)
    probs = torch.softmax(logits, dim=-1).to(dt)
    o = (probs @ v.transpose(1, 2)).reshape(b, 1, h * hd)
    return o @ p.wo.to(dt).flatten(0, 1), new_cache


def owns_slot(j: int, slot, s_loc: int):
    """Whether model shard ``j``'s slice of a sequence-split cache
    (``s_loc`` positions from ``j * s_loc``) holds ``slot`` (a 0-d
    tensor: the answer is one too)."""
    return slot // s_loc == j


def merge_partials(ms, ls, os_):
    """The log-sum-exp merge of each model shard's partial attention over
    its slice of the keys: ``ms`` its row maxima, ``ls`` its sums of
    exponentials and ``os_`` its exponential-weighted values (float32).
    With M the maximum over the axis (an all-reduce), every shard gets
    ``sum_j o_j e^(m_j - M) / sum_j l_j e^(m_j - M)`` (two all-reduces):
    the softmax-weighted values over every key."""
    big = sharding.pmax(ms)
    scale = [torch.exp(m - b) for m, b in zip(ms, big)]
    ls = sharding.psum([l * c for l, c in zip(ls, scale)])
    os_ = sharding.psum([o * c for o, c in zip(os_, scale)])
    return [o / l for o, l in zip(os_, ls)]


def _decode_queries(p, x, cfg: ModelConfig, j: int, split: bool, posv,
                    use_rope: bool):
    """Shard ``j``'s query heads of one token (all of them where
    ``split`` is false): its ``wq`` columns and slice of ``bq``."""
    dt = cfg.cdtype
    q = _proj(x, p.wq, dt)
    if hasattr(p, "bq"):
        n = p.wq.shape[1]
        q = q + (p.bq[j * n:(j + 1) * n] if split else p.bq).to(dt)
    if hasattr(p, "q_scale"):
        q = rms_head_norm(q, p.q_scale)
    if use_rope:
        q = apply_rope(q, posv, cfg.rope_theta)
    return q


def _decode_keys(p, x, cfg: ModelConfig, j: int, split: bool, posv,
                 use_rope: bool):
    """Shard ``j``'s new key and value heads of one token (all of them
    where ``split`` is false)."""
    dt = cfg.cdtype
    k, v = _proj(x, p.wk, dt), _proj(x, p.wv, dt)
    if hasattr(p, "bk"):
        n = p.wk.shape[1]
        sl = slice(j * n, (j + 1) * n) if split else slice(None)
        k, v = k + p.bk[sl].to(dt), v + p.bv[sl].to(dt)
    if hasattr(p, "k_scale"):
        k = rms_head_norm(k, p.k_scale)
    if use_rope:
        k = apply_rope(k, posv, cfg.rope_theta)
    return k, v


def attention_decode_tp(ps, xs, caches, cfg: ModelConfig, *,
                        mask: str = "causal", use_rope: bool = True,
                        cross: bool = False, seq_split: bool = False,
                        scale_rows: slice = slice(None)):
    """:func:`attention_decode` over the model axis: ``ps`` each shard's
    attention params (``wq`` / ``wo`` its heads where the axis splits
    them, ``wk`` / ``wv`` its KV heads where it splits those), ``xs`` its
    replica of the normed token (B, 1, D), ``caches`` its piece of the
    cache: with ``seq_split`` shard ``j`` holds positions ``j * s`` to
    ``(j + 1) * s`` of every KV head, else all of them.

    Each shard's query heads (and new key and value heads) are gathered
    over the axis where it splits them; the new key and value are
    written only into the shard that owns position ``len``
    (:func:`owns_slot`; modulo the cache for a ``"window"`` ring), into
    copies; each shard attends over its slice for every head and the
    partials meet by :func:`merge_partials` (a shard holding the whole
    sequence needs none). Each shard then takes its heads' columns of
    ``wo``. The int8 cache's scales are whole on every shard (the rule
    replicates them): each shard reads its batch rows ``scale_rows`` and
    its slice of positions, and every shard writes its rows' new scales
    (the caller merges the dp slices' rows). Returns (each shard's
    partial output of ``wo`` where the axis splits the heads, for the
    caller to sum, else the whole output; the new caches). A full causal cache raises as :func:`attention_decode`
    does; a cross-attention cache is read, never written."""
    m = len(ps)
    b = xs[0].shape[0]
    h, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    g = h // kvh
    dt = cfg.cdtype
    s_loc = caches[0]["k"].shape[1]
    smax = s_loc * m if seq_split else s_loc
    poss = [position(c, x.device) for c, x in zip(caches, xs)]
    if not cross and mask != "window":
        check_room(poss[0], smax)
    posvs = [pos.expand(b, 1) for pos in poss]
    q_split = ps[0].wq.shape[1] < h
    qs = [_decode_queries(p, x, cfg, j, q_split, posv, use_rope)
          for j, (p, x, posv) in enumerate(zip(ps, xs, posvs))]
    if q_split:
        qs = sharding.all_gather(qs, 2)                    # (B, 1, H, hd)
    if cross:
        new_caches = list(caches)
    else:
        kv_split = ps[0].wk.shape[1] < kvh
        new = [_decode_keys(p, x, cfg, j, kv_split, posv, use_rope)
               for j, (p, x, posv) in enumerate(zip(ps, xs, posvs))]
        knew, vnew = [k for k, _ in new], [v for _, v in new]
        if kv_split:
            knew, vnew = (sharding.all_gather(knew, 2),
                          sharding.all_gather(vnew, 2))
        new_caches = []
        for j, (c, pos) in enumerate(zip(caches, poss)):
            slot = pos % smax if mask == "window" else pos
            nc = {**c, "len": pos + 1}
            for name, row in (("k", knew[j]), ("v", vnew[j])):
                if "k_scale" in c:                      # int8 KV cache
                    row, rs = _quantize_rows(row)
                    nc[f"{name}_scale"] = _written(c[f"{name}_scale"],
                                                   slot, rs, scale_rows)
                row = row.to(c[name].dtype)
                if seq_split:      # the owner writes; the others keep theirs
                    local = slot % s_loc
                    mine = torch.as_tensor(owns_slot(j, slot, s_loc),
                                           device=row.device)
                    row = torch.where(mine, row, c[name].index_select(
                        1, local.reshape(1)))
                    nc[name] = _written(c[name], local, row)
                else:
                    nc[name] = _written(c[name], slot, row)
            new_caches.append(nc)
    ms, ls, os_ = [], [], []
    for j, (q, c) in enumerate(zip(qs, new_caches)):
        lo = j * s_loc if seq_split else 0
        if "k_scale" in c and not cross:
            k, v = ((c[n].float() * c[f"{n}_scale"][scale_rows,
                                                    lo:lo + s_loc]).to(dt)
                    for n in ("k", "v"))
        else:
            k, v = c["k"], c["v"]
        keys = lo + torch.arange(s_loc, device=q.device)
        valid = (keys < c.get("kv_len", smax)) if cross \
            else keys <= poss[j]
        logits = (q.reshape(b, kvh, g, hd) @ k.permute(0, 2, 3, 1)).float()
        logits = torch.where(valid, logits / math.sqrt(hd), _NEG)
        if seq_split:
            mx = logits.amax(-1, keepdim=True)
            e = torch.exp(logits - mx)
            ms.append(mx)
            ls.append(e.sum(-1, keepdim=True))
            os_.append((e.to(dt) @ v.transpose(1, 2)).float())
        else:
            probs = torch.softmax(logits, dim=-1).to(dt)
            os_.append(probs @ v.transpose(1, 2))
    if seq_split:
        os_ = [o.to(dt) for o in merge_partials(ms, ls, os_)]
    outs = []
    for j, (p, o) in enumerate(zip(ps, os_)):
        o = o.reshape(b, 1, h, hd)
        if q_split:
            n = p.wo.shape[0]
            o = o[:, :, j * n:(j + 1) * n]
        outs.append(o.flatten(2) @ p.wo.to(dt).flatten(0, 1))
    return outs, new_caches


def _write(buf, slot, row, rows: slice = slice(None)):
    """``row`` (b, 1, ...) written into ``buf`` (B, Smax, ...) at
    ``slot`` (a 0-d int64 tensor on ``buf``'s device) of its batch rows
    ``rows``, in place; returns ``buf``."""
    buf[rows].index_copy_(1, slot.reshape(1), row)
    return buf


def _written(buf, slot, row, rows: slice = slice(None)):
    """A copy of ``buf`` with ``row`` at ``slot`` (:func:`_write` on a
    clone): the sharded decode step keeps its input cache."""
    return _write(buf.clone(), slot, row, rows)


def make_attn_cache(cfg: ModelConfig, batch: int, max_len: int, device,
                    windowed: bool = False) -> dict:
    size = min(max_len, cfg.window) if windowed and cfg.window else max_len
    shape = (batch, size, cfg.n_kv_heads, cfg.hd)
    if cfg.kv_quant:  # int8 rows + per-(position, head) scales
        return {"k": torch.zeros(shape, dtype=torch.int8, device=device),
                "v": torch.zeros(shape, dtype=torch.int8, device=device),
                "k_scale": torch.zeros(shape[:3] + (1,), dtype=torch.float32,
                                       device=device),
                "v_scale": torch.zeros(shape[:3] + (1,), dtype=torch.float32,
                                       device=device),
                "len": _zero_position(device)}
    return {"k": torch.zeros(shape, dtype=cfg.cdtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.cdtype, device=device),
            "len": _zero_position(device)}


def _zero_position(device) -> torch.Tensor:
    """A fresh cache's ``len``: 0 as a 0-d int64 tensor on ``device``."""
    return torch.zeros((), dtype=torch.int64, device=device)


def _quantize_rows(x):
    """x (B, 1, KV, hd) -> int8 rows and float32 scales (B, 1, KV, 1):
    the scale is the row's largest |x| over 127 (at least 1e-8), the row
    ``x / scale`` rounded half to even and clipped to +-127."""
    xf = x.float()
    scale = torch.clamp(xf.abs().amax(-1, keepdim=True) / 127.0, min=1e-8)
    q = torch.clamp(torch.round(xf / scale), -127, 127)
    return q.to(torch.int8), scale


# --------------------------------------------------------------------------
# MLP
# --------------------------------------------------------------------------
def init_mlp(cfg: ModelConfig, generator: torch.Generator,
             d_ff: int | None = None) -> dict:
    d, f, pdt = cfg.d_model, d_ff or cfg.d_ff, cfg.pdtype

    def dense(shape):
        return dense_init(shape, pdt, generator=generator)

    if cfg.act in ("swiglu", "geglu"):
        return {"w_gate": dense((d, f)), "w_up": dense((d, f)),
                "w_down": dense((f, d))}
    return {"w_up": dense((d, f)), "w_down": dense((f, d))}


def apply_mlp(p, x, cfg: ModelConfig):
    dt = cfg.cdtype
    up = x @ p.w_up.to(dt)
    if hasattr(p, "w_gate"):
        gate = x @ p.w_gate.to(dt)
        hid = (F.silu(gate) if cfg.act == "swiglu" else gelu(gate)) * up
    else:
        hid = gelu(up)
    return hid @ p.w_down.to(dt)


__all__ = ["apply_mlp", "apply_rope", "attention_decode",
           "attention_decode_tp", "attention_full", "attention_shard",
           "check_q_len", "gelu", "heads_split", "init_attention",
           "init_mlp", "make_attn_cache", "merge_partials", "mlp_split",
           "owns_slot", "position", "check_room"]
