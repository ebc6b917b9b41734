"""Griffin / RecurrentGemma recurrent block (RG-LRU, arXiv:2402.19427).

Branches: gate = gelu(x W_gate); rec = RG-LRU(conv1d(x W_rec)); out =
(gate * rec) W_out. The RG-LRU recurrence

    r_t = sigmoid(u_t W_a + b_a);  i_t = sigmoid(u_t W_x + b_x)
    a_t = exp(-c * softplus(Lambda) * r_t)            (c = 8)
    h_t = a_t h_{t-1} + sqrt(1 - a_t^2) * (i_t * u_t)

runs in the ``lru_scan`` kernel over the full sequence (prefill), once a
layer; the reference evaluates the same recurrence with
``lax.associative_scan`` there (log depth; the kernel steps through t, so
the two differ by float32 rounding only). Decode takes one fused step of
plain tensor ops, as in the reference. ``p`` is a block's ``rec``
parameter module (the reference's keys as attributes).

Tensor parallelism (``models.transformer.apply_block_tp``): the model
axis splits the W columns of ``w_in_rec`` and ``w_in_gate`` and the rows
of ``w_out_rec``; ``conv_w``, ``conv_b``, ``w_a``, ``b_a``, ``w_x``,
``b_x`` and ``lam`` are whole on every shard and sliced to its columns
here. The gates of a shard's columns read the whole of u, so
:func:`apply_rglru_tp` gathers u over the axis between the conv and the
gates; each shard then scans its W / tp channels and returns its partial
output of ``w_out_rec``, for the caller to sum.
"""
from __future__ import annotations

import torch

from .. import sharding
from ..kernels.lru_scan import lru_scan
from .common import ModelConfig, Node, dense_init
from .layers import gelu

_C = 8.0


def init_rglru(cfg: ModelConfig, generator: torch.Generator) -> dict:
    d = cfg.d_model
    w = cfg.lru_width or d
    dev, pdt = generator.device, cfg.pdtype

    def dense(shape):
        return dense_init(shape, pdt, generator=generator)

    return {
        "w_in_rec": dense((d, w)),
        "w_in_gate": dense((d, w)),
        "conv_w": dense((cfg.conv_width, w)),
        "conv_b": torch.zeros((w,), dtype=pdt, device=dev),
        "w_a": dense((w, w)),
        "b_a": torch.zeros((w,), dtype=pdt, device=dev),
        "w_x": dense((w, w)),
        "b_x": torch.zeros((w,), dtype=pdt, device=dev),
        # Lambda parameterized so a in ~(0.9, 0.999) at init
        "lam": _uniform(w, 0.9, 0.999, generator),
        "w_out_rec": dense((w, d)),
    }


def _uniform(n: int, lo: float, hi: float, generator):
    t = torch.empty((n,), dtype=torch.float32, device=generator.device)
    return t if t.device.type == "meta" else t.uniform_(lo, hi,
                                                         generator=generator)


def _gates(p, u, cfg: ModelConfig, own=None):
    """``(a, b)`` f32 of the recurrence h_t = a_t h_{t-1} + b_t; the gate
    products run in the compute dtype, as in the reference. ``own``: the
    columns of u whose gates ``p`` holds (``w_a`` / ``w_x`` columns, a
    model shard's), where u is wider (whole)."""
    dt = cfg.cdtype
    r = torch.sigmoid(u @ p.w_a.to(dt) + p.b_a.to(dt)).float()
    i = torch.sigmoid(u @ p.w_x.to(dt) + p.b_x.to(dt)).float()
    log_lam = torch.log(p.lam.float())                    # < 0
    a = torch.exp(_C * log_lam * r)       # softplus folded into lam param
    u = u if own is None else own
    b = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * i * u.float()
    return a, b


def _conv1d(p, u, cfg: ModelConfig, state=None):
    """Causal depthwise conv along time in u's dtype; state: the last
    (width-1) inputs. Returns (out, new state)."""
    wt = p.conv_w.to(u.dtype)
    width = wt.shape[0]
    if state is None:
        pads = torch.zeros((u.shape[0], width - 1, u.shape[2]),
                           dtype=u.dtype, device=u.device)
    else:
        pads = state.to(u.dtype)
    xp = torch.cat([pads, u], dim=1)
    s = u.shape[1]
    # Python's sum, 0 + t0 + t1 + ..., the reference's order of additions
    out = sum(xp[:, i:i + s] * wt[i] for i in range(width))
    return out + p.conv_b.to(u.dtype), xp[:, -(width - 1):]


def scan_inputs(p, x, cfg: ModelConfig):
    """The projections of :func:`apply_rglru`: ``(a, b, gate)``, with a, b
    (B, S, W) f32, the arguments of ``lru_scan``, and the gate (B, S, W) in
    the compute dtype."""
    dt = cfg.cdtype
    gate = gelu(x @ p.w_in_gate.to(dt))
    u = x @ p.w_in_rec.to(dt)
    u, _ = _conv1d(p, u, cfg)
    a, b = _gates(p, u, cfg)
    return a, b, gate


def apply_rglru(p, x, cfg: ModelConfig):
    """Full-sequence path; x: (B, S, D). Runs ``lru_scan`` once."""
    a, b, gate = scan_inputs(p, x, cfg)
    h = lru_scan(a, b).to(cfg.cdtype)
    return (h * gate) @ p.w_out_rec.to(cfg.cdtype)


def rec_split(p, cfg: ModelConfig) -> bool:
    """Whether the model axis splits this shard's block (``w_in_rec``'s W
    columns; the reference splits ``w_in_gate`` and ``w_out_rec``
    alike)."""
    return p.w_in_rec.shape[1] < (cfg.lru_width or cfg.d_model)


def _columns(p, j: int) -> Node:
    """Model shard ``j``'s pieces with the per-channel leaves sliced to
    its n columns of W (n = its ``w_in_rec``'s width)."""
    n = p.w_in_rec.shape[1]
    c = slice(j * n, (j + 1) * n)
    return Node(p, conv_w=p.conv_w[:, c], conv_b=p.conv_b[c],
                w_a=p.w_a[:, c], b_a=p.b_a[c], w_x=p.w_x[:, c],
                b_x=p.b_x[c], lam=p.lam[c])


def _rec_in(p, x, cfg: ModelConfig, j: int):
    """Model shard ``j``'s conv output u and gate (B, S, n)."""
    dt = cfg.cdtype
    q = _columns(p, j)
    gate = gelu(x @ q.w_in_gate.to(dt))
    u, _ = _conv1d(q, x @ q.w_in_rec.to(dt), cfg)
    return u, gate


def _rec_out(p, u_all, gate, cfg: ModelConfig, j: int):
    """Model shard ``j``'s partial output of ``w_out_rec``: its columns'
    gates from the whole of u, its channels scanned."""
    q = _columns(p, j)
    n = gate.shape[-1]
    a, b = _gates(q, u_all, cfg, own=u_all[..., j * n:(j + 1) * n])
    h = lru_scan(a.contiguous(), b.contiguous()).to(cfg.cdtype)
    return (h * gate) @ q.w_out_rec.to(cfg.cdtype)


def apply_rglru_tp(ps, xs, cfg: ModelConfig, remat=lambda fn: fn):
    """:func:`apply_rglru` over the model axis where it splits the block
    (:func:`rec_split`): ``ps`` holds each shard's ``rec`` params, ``xs``
    its normed input (B, S, D); returns each shard's partial output of
    ``w_out_rec``, for the caller to sum. Each shard's projections and
    conv are one ``remat``-ed function; u is gathered over the axis; its
    gates, ``lru_scan`` on (B, S, W / tp) and the output are the
    second."""
    proj = remat(_rec_in)
    parts = [proj(p, x, cfg, j) for j, (p, x) in enumerate(zip(ps, xs))]
    whole = sharding.all_gather([u for u, _ in parts], -1)
    out = remat(_rec_out)
    return [out(p, whole[j], parts[j][1], cfg, j) for j, p in enumerate(ps)]


def apply_rglru_decode(p, x, cache: dict, cfg: ModelConfig):
    """Single-token step; cache: {"h": (B, W) f32, "conv": (B, width-1,
    W)}. Returns (out, new cache)."""
    dt = cfg.cdtype
    gate = gelu(x @ p.w_in_gate.to(dt))                   # (B, 1, W)
    u = x @ p.w_in_rec.to(dt)
    u, conv_state = _conv1d(p, u, cfg, state=cache["conv"])
    a, b = _gates(p, u, cfg)                              # (B, 1, W) f32
    h = a[:, 0] * cache["h"] + b[:, 0]
    out = (h[:, None, :].to(dt) * gate) @ p.w_out_rec.to(dt)
    return out, {"h": h, "conv": conv_state}


def apply_rglru_decode_tp(ps, xs, caches, cfg: ModelConfig):
    """:func:`apply_rglru_decode` over the model axis: ``ps`` each
    shard's ``rec`` params, ``xs`` its normed input (B, 1, D),
    ``caches`` its cache (``h`` and ``conv`` whole on every shard: the
    rule replicates them over the model axis). Where the axis splits the
    block (:func:`rec_split`), each shard's columns of u are gathered
    over the axis before the conv, every shard runs the conv, the gates
    (whole on every shard) and the step on all W channels (the replicas
    stay equal) and returns its partial output of ``w_out_rec`` from its
    columns of h and its gate, for the caller to sum; otherwise each
    shard runs :func:`apply_rglru_decode` whole. Returns (outputs, new
    caches)."""
    if not rec_split(ps[0], cfg):
        res = [apply_rglru_decode(p, x, c, cfg)
               for p, x, c in zip(ps, xs, caches)]
        return [o for o, _ in res], [c for _, c in res]
    dt = cfg.cdtype
    whole = sharding.all_gather([x @ p.w_in_rec.to(dt)
                                 for p, x in zip(ps, xs)], -1)
    outs, new = [], []
    for j, (p, x, c, u) in enumerate(zip(ps, xs, caches, whole)):
        n = p.w_in_rec.shape[1]
        gate = gelu(x @ p.w_in_gate.to(dt))               # (B, 1, n)
        u, conv_state = _conv1d(p, u, cfg, state=c["conv"])
        a, b = _gates(p, u, cfg)                          # (B, 1, W) f32
        h = a[:, 0] * c["h"] + b[:, 0]
        outs.append((h[:, None, j * n:(j + 1) * n].to(dt) * gate)
                    @ p.w_out_rec.to(dt))
        new.append({"h": h, "conv": conv_state})
    return outs, new


def make_rglru_cache(cfg: ModelConfig, batch: int, device) -> dict:
    w = cfg.lru_width or cfg.d_model
    return {"h": torch.zeros((batch, w), dtype=torch.float32, device=device),
            "conv": torch.zeros((batch, cfg.conv_width - 1, w),
                                dtype=cfg.cdtype, device=device)}


__all__ = ["apply_rglru", "apply_rglru_decode", "apply_rglru_decode_tp",
           "apply_rglru_tp",
           "init_rglru", "make_rglru_cache", "rec_split", "scan_inputs"]
