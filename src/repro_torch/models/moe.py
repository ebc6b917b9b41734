"""Top-k mixture of experts with the sort-based capacity dispatch, and
expert parallelism over a mesh's model axis: the reference's
``models/moe.py``.

One device (:func:`apply_moe`, the model's own path): each token's
``top_k`` experts come from a float32 router
(:func:`_route`); the (token, expert) pairs are sorted by expert, and
each expert keeps its first ``C`` of them (:func:`_capacity`, from the
static token count, so nothing waits on the host) in an (E, C, D)
buffer (:func:`_dispatch`); the experts run as three batched products
(:func:`_expert_ffn`); each kept pair's output times its weight is
added back to its token (:func:`_combine`). A pair past its expert's
capacity is dropped: its token gets nothing from that expert. Decode
routes the ``B`` tokens of one step on their own, so its capacity is
``ceil(B k / E cf)`` (1 at B 4, top-8 of 64) and it drops where a
prefill of the same tokens would not, as the reference's decode does.

Over the model axis (:func:`apply_moe_tp`, which the sharded train
step runs through ``transformer.apply_block_tp``): shard ``j``
holds experts ``j E/m`` to ``(j + 1) E/m`` and a replica of the
tokens. It takes its ``S/m`` slice of the sequence (all of it when S is
below m or m does not divide it), routes and dispatches that slice with
the capacity of its own token count (the reference's drop semantics
under a mesh), sends block ``i`` of its (m, E/m, C, D) buffer to shard
``i`` (:data:`to_experts`), runs its experts on the (E/m, m C, D) it
receives, sends each block back (:data:`from_experts`), combines, and
gathers the m slices into every shard's replica. The two exchanges are
module attributes, as ``transformer.sum_heads`` is, so that a check can
drop one.

Ties: the reference's ``lax.top_k`` takes the lower expert index among
equal probabilities, and ``jnp.argsort`` is stable. ``torch.topk``
promises no order among equal values, so :func:`_route` takes the first
``k`` of a stable descending sort (equal values keep their index order),
and :func:`_dispatch` sorts with ``stable=True``.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .. import sharding
from .common import ModelConfig, dense_init
from .layers import gelu

# The two exchanges over the model axis (module attributes, so a check
# can drop one and see the result change).
to_experts = sharding.all_to_all      # each block of the buffer to its owner
from_experts = sharding.all_to_all    # the experts' outputs back


def init_moe(cfg: ModelConfig, generator: torch.Generator) -> dict:
    """``router`` (D, E) in float32; ``w_gate`` / ``w_up`` (E, D, F) and
    ``w_down`` (E, F, D) in ``cfg.pdtype`` (the reference's
    ``dense_init``, whose fan-in is the leading dim: E)."""
    d, e, f = cfg.d_model, cfg.n_experts, cfg.d_ff

    def dense(shape, dtype, scale=None):
        return dense_init(shape, dtype, scale, generator=generator)

    return {"router": dense((d, e), torch.float32, 0.02),
            "w_gate": dense((e, d, f), cfg.pdtype),
            "w_up": dense((e, d, f), cfg.pdtype),
            "w_down": dense((e, f, d), cfg.pdtype)}


def _route(xt, router, top_k: int):
    """Token -> expert assignment: float32 scores, softmax, the top
    ``top_k`` (ties to the lower index), renormalised. Returns (weights
    (T, k) float32, expert ids (T, k) int64)."""
    probs = torch.softmax(xt.float() @ router.float(), dim=-1)
    vals, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    topv, topi = vals[:, :top_k], ids[:, :top_k]
    return topv / topv.sum(-1, keepdim=True), topi


def _dispatch(xt, eids, n_experts: int, capacity: int):
    """Sort-based capacity dispatch (dropping): the (E, C, D) buffer, and
    ``(slot, keep, st, order)`` to invert it. A dropped pair's slot is
    ``E C``, one past the buffer: it is written to a spare row that is
    cut off (the reference's ``mode="drop"``)."""
    t_tok, k = eids.shape
    tk = t_tok * k
    dev = eids.device
    flat_e = eids.reshape(tk)
    flat_t = torch.arange(t_tok, device=dev).repeat_interleave(k)
    order = torch.argsort(flat_e, stable=True)
    se, st = flat_e[order], flat_t[order]
    first = torch.searchsorted(se, torch.arange(n_experts, device=dev))
    pos_in_e = torch.arange(tk, device=dev) - first[se]
    keep = pos_in_e < capacity
    slot = torch.where(keep, se * capacity + pos_in_e, n_experts * capacity)
    rows = torch.where(keep[:, None], xt[st], 0)
    buf = xt.new_zeros((n_experts * capacity + 1, xt.shape[-1]))
    buf = buf.index_copy(0, slot, rows)[:-1]
    return buf.reshape(n_experts, capacity, -1), (slot, keep, st, order)


def _combine(out_buf, dispatch_info, weights, t_tok: int):
    """Each kept pair's expert output times its weight, added to its
    token in the buffer's dtype (bf16 in a bf16 prefill, as the
    reference's scatter-add). Every token has exactly ``k`` pairs, so a
    stable sort of the pairs by token lays them out as (T, k) (a
    token's pairs by expert id, the order of the sorted pairs) and the
    ``k`` terms are added one after another: a fixed order with no
    atomics, so the forward repeats bitwise on the card."""
    slot, keep, st, order = dispatch_info
    e, c, d = out_buf.shape
    rows = out_buf.reshape(e * c, d)
    by_tok = torch.argsort(st, stable=True)
    vals = torch.where(keep[by_tok, None],
                       rows[slot[by_tok].clamp(max=e * c - 1)], 0)
    w = weights.reshape(-1)[order[by_tok]]
    terms = (vals * w[:, None].to(out_buf.dtype)).reshape(t_tok, -1,
                                                           d).unbind(1)
    out = terms[0]
    for term in terms[1:]:
        out = out + term
    return out


def _activate(h_gate, h_up, act: str):
    if act == "swiglu":
        return F.silu(h_gate) * h_up
    if act == "geglu":
        return gelu(h_gate) * h_up
    raise ValueError(act)


def _expert_ffn(buf, w_gate, w_up, w_down, cfg: ModelConfig):
    """Each expert's gated MLP on its rows: (E, C, D) -> (E, C, D), the
    weights cast to the buffer's dtype at use."""
    dt = buf.dtype
    gate = torch.bmm(buf, w_gate.to(dt))
    up = torch.bmm(buf, w_up.to(dt))
    h = _activate(gate, up, cfg.act if cfg.act != "gelu" else "swiglu")
    return torch.bmm(h, w_down.to(dt))


def _capacity(t_tok: int, k: int, e: int, cf: float) -> int:
    return max(1, int(math.ceil(t_tok * k / e * cf)))


def _apply_local(params, x, cfg: ModelConfig):
    b, s, d = x.shape
    t_tok = b * s
    xt = x.reshape(t_tok, d)
    weights, eids = _route(xt, params.router, cfg.top_k)
    cap = _capacity(t_tok, cfg.top_k, cfg.n_experts, cfg.capacity_factor)
    buf, info = _dispatch(xt, eids, cfg.n_experts, cap)
    out_buf = _expert_ffn(buf, params.w_gate, params.w_up, params.w_down,
                          cfg)
    return _combine(out_buf, info, weights, t_tok).reshape(b, s, d)


def _slice_dispatch(p, h, cfg: ModelConfig, lo: int, n: int, m: int):
    """A shard's slice of the tokens (positions ``lo`` to ``lo + n``),
    routed and dispatched: its buffer as (m, E/m, C, D) blocks, the
    routing weights and the dispatch tables."""
    d = h.shape[-1]
    h = h[:, lo:lo + n]
    t_tok = h.shape[0] * n
    xt = h.reshape(t_tok, d)
    weights, eids = _route(xt, p.router, cfg.top_k)
    e = cfg.n_experts
    cap = _capacity(t_tok, cfg.top_k, e, cfg.capacity_factor)
    buf, (slot, keep, st, order) = _dispatch(xt, eids, e, cap)
    return buf.reshape(m, e // m, cap, d), weights, slot, keep, st, order


def _local_experts(p, blocks, cfg: ModelConfig):
    """One shard's experts on the blocks every shard sent it: (m, E/m, C,
    D) -> the outputs in the same layout."""
    m, e_loc, cap, d = blocks.shape
    rows = blocks.transpose(0, 1).reshape(e_loc, m * cap, d)
    out = _expert_ffn(rows, p.w_gate, p.w_up, p.w_down, cfg)
    return out.reshape(e_loc, m, cap, d).transpose(0, 1)


def _slice_combine(blocks, weights, slot, keep, st, order, shape):
    """The returned (m, E/m, C, D) outputs combined into the shard's
    token slice of ``shape`` (B, S_j, D)."""
    m, e_loc, cap, d = blocks.shape
    out_buf = blocks.reshape(m * e_loc, cap, d)
    t_tok = shape[0] * shape[1]
    return _combine(out_buf, (slot, keep, st, order), weights,
                    t_tok).reshape(shape)


def apply_moe_tp(ps, hs, cfg: ModelConfig, remat=None) -> list:
    """The MoE sublayer over the model axis: ``ps`` one params view a
    shard (``router`` whole; ``w_gate`` / ``w_up`` / ``w_down`` its
    E/m experts), ``hs`` each shard's replica of the normed input (B,
    S, D) on its device; returns each shard's replica of the output.
    ``remat`` (``fn -> fn``) wraps each shard's dispatch, experts and
    combine, which the sharded train step recomputes in backward on
    their own device."""
    m = len(ps)
    e = cfg.n_experts
    if e % m:
        raise ValueError(f"{e} experts do not divide over a model axis of "
                         f"{m}")
    wrap = remat or (lambda fn: fn)
    b, s, d = hs[0].shape
    split = s % m == 0 and s >= m
    n = s // m if split else s
    shape = (b, n, d)
    routed = [wrap(_slice_dispatch)(p, h, cfg, j * n if split else 0, n, m)
              for j, (p, h) in enumerate(zip(ps, hs))]
    recv = to_experts([r[0] for r in routed])
    outs = from_experts([wrap(_local_experts)(p, r, cfg)
                         for p, r in zip(ps, recv)])
    ys = [wrap(_slice_combine)(o, *r[1:], shape)
          for o, r in zip(outs, routed)]
    return sharding.all_gather(ys, dim=1) if split else ys


def apply_moe(params, x, cfg: ModelConfig):
    """x: (B, S, D) -> (B, S, D) on one device."""
    return _apply_local(params, x, cfg)


__all__ = ["apply_moe", "apply_moe_tp", "from_experts", "init_moe",
           "to_experts"]
