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
"""
from __future__ import annotations

import torch

from ..kernels.lru_scan import lru_scan
from .common import ModelConfig, dense_init
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
        "lam": torch.empty((w,), dtype=torch.float32, device=dev).uniform_(
            0.9, 0.999, generator=generator),
        "w_out_rec": dense((w, d)),
    }


def _gates(p, u, cfg: ModelConfig):
    """``(a, b)`` f32 of the recurrence h_t = a_t h_{t-1} + b_t; the gate
    products run in the compute dtype, as in the reference."""
    dt = cfg.cdtype
    r = torch.sigmoid(u @ p.w_a.to(dt) + p.b_a.to(dt)).float()
    i = torch.sigmoid(u @ p.w_x.to(dt) + p.b_x.to(dt)).float()
    log_lam = torch.log(p.lam.float())                    # < 0
    a = torch.exp(_C * log_lam * r)       # softplus folded into lam param
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


def make_rglru_cache(cfg: ModelConfig, batch: int, device) -> dict:
    w = cfg.lru_width or cfg.d_model
    return {"h": torch.zeros((batch, w), dtype=torch.float32, device=device),
            "conv": torch.zeros((batch, cfg.conv_width - 1, w),
                                dtype=cfg.cdtype, device=device)}


__all__ = ["apply_rglru", "apply_rglru_decode", "init_rglru",
           "make_rglru_cache", "scan_inputs"]
