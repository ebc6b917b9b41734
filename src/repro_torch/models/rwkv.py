"""RWKV-6 "Finch" block (arXiv:2404.05892): data-dependent-decay time-mix
and squared-ReLU channel-mix.

The full-sequence ``time_mix`` (prefill) runs the exact WKV recurrence in
the ``wkv6`` kernel, on ``(B*H, S, 64)`` rows; the reference computes the
same recurrence in chunked form (an XLA device, not ported). Decode runs
the one-token recurrence as plain tensor ops with the ``(hd, hd)`` state
cached, as in the reference. ``p`` is a block's parameter module (the
reference's keys as attributes).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kernels.wkv6 import wkv6
from .common import ModelConfig, dense_init

HEAD_DIM = 64
LORA_DIM = 64


def n_heads(cfg: ModelConfig) -> int:
    return cfg.d_model // HEAD_DIM


def init_rwkv_block(cfg: ModelConfig, generator: torch.Generator) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    h = n_heads(cfg)
    dev, pdt = generator.device, cfg.pdtype

    def dense(shape, dtype=pdt, scale=None):
        return dense_init(shape, dtype, scale, generator=generator)

    return {
        # time-mix
        "mu": torch.full((5, d), 0.5, dtype=pdt, device=dev),  # r,k,v,g,w
        "wr": dense((d, d)),
        "wk_t": dense((d, d)),
        "wv_t": dense((d, d)),
        "wg": dense((d, d)),
        "w0": torch.full((d,), -5.0, dtype=torch.float32, device=dev),
        "wa_lora": dense((d, LORA_DIM)),
        "wb_lora": torch.zeros((LORA_DIM, d), dtype=pdt, device=dev),
        "u": dense((h, HEAD_DIM), torch.float32, scale=0.5),
        "ln_x": torch.ones((d,), dtype=pdt, device=dev),     # per-head norm
        "w_out_t": dense((d, d)),
        # channel-mix
        "mu_c": torch.full((2, d), 0.5, dtype=pdt, device=dev),  # k, r
        "wk_c": dense((d, f)),
        "wv_c": dense((f, d)),
        "wr_c": dense((d, d)),
    }


def _shift(x, last=None):
    """Token shift: x_{t-1} (zeros / cached last token at t=0)."""
    if last is None:
        last = torch.zeros_like(x[:, :1])
    return torch.cat([last, x[:, :-1]], dim=1)


def _mix(x, xs, mu_row):
    return x + mu_row.to(x.dtype) * (xs - x)


def _decay(p, xw, cfg: ModelConfig):
    """log w_t = -exp(w0 + tanh(x W_a) W_b)  (negative, data-dependent)."""
    dt = cfg.cdtype
    lora = torch.tanh(xw @ p.wa_lora.to(dt)) @ p.wb_lora.to(dt)
    return -torch.exp(p.w0.float() + lora.float())


def _heads(x, h):
    b, s, _ = x.shape
    return x.reshape(b, s, h, HEAD_DIM).transpose(1, 2)  # (B, H, S, hd)


def _headnorm(y, scale, h):
    """Per-head RMS norm over hd (stand-in for RWKV's GroupNorm)."""
    b, hh, s, hd = y.shape
    yf = y.float()
    yf = yf * torch.rsqrt((yf * yf).mean(-1, keepdim=True) + 1e-6)
    yf = yf.transpose(1, 2).reshape(b, s, hh * hd)
    return yf * scale.float()


def wkv_inputs(p, x, cfg: ModelConfig):
    """The projections of ``time_mix``: ``(r, k, w, v, u, g)``, with r, k,
    w, v as ``(B*H, S, hd)`` f32 rows and ``u (B*H, hd)``, the arguments
    of ``wkv6``; ``g (B, S, D)`` in the compute dtype."""
    b, s, _ = x.shape
    h = n_heads(cfg)
    dt = cfg.cdtype
    xs = _shift(x)
    r = _mix(x, xs, p.mu[0]) @ p.wr.to(dt)
    k = _mix(x, xs, p.mu[1]) @ p.wk_t.to(dt)
    v = _mix(x, xs, p.mu[2]) @ p.wv_t.to(dt)
    g = _mix(x, xs, p.mu[3]) @ p.wg.to(dt)
    lw = _decay(p, _mix(x, xs, p.mu[4]), cfg)               # (B, S, D) f32

    def rows(t):
        return _heads(t, h).float().reshape(b * h, s, HEAD_DIM).contiguous()

    u = p.u.float().repeat(b, 1)                            # (B*H, hd)
    return rows(r), rows(k), torch.exp(rows(lw)), rows(v), u, g


def time_mix(p, x, cfg: ModelConfig, chunk: int | None = None):
    """Full-sequence WKV6; x: (B, S, D). ``chunk`` only checks S as the
    reference does (its chunked algebra needs ``S % min(chunk, S) == 0``):
    the kernel itself takes any S."""
    b, s, _ = x.shape
    if chunk is None:
        chunk = 32 if s <= 512 else 256
    c = min(chunk, s)
    if s % c:
        raise ValueError(f"time_mix: S={s} is not a multiple of the chunk "
                         f"{c}")
    h = n_heads(cfg)
    r, k, w, v, u, g = wkv_inputs(p, x, cfg)
    y = wkv6(r, k, w, v, u).reshape(b, h, s, HEAD_DIM)
    y = _headnorm(y, p.ln_x, h).to(cfg.cdtype)
    return (y * F.silu(g)) @ p.w_out_t.to(cfg.cdtype)


def time_mix_decode(p, x, cache, cfg: ModelConfig):
    """x: (B, 1, D); cache: {"state": (B,H,hd,hd), "last": (B,1,D)}."""
    b = x.shape[0]
    h = n_heads(cfg)
    dt = cfg.cdtype
    xs = cache["last"].to(x.dtype)
    r = _mix(x, xs, p.mu[0]) @ p.wr.to(dt)
    k = _mix(x, xs, p.mu[1]) @ p.wk_t.to(dt)
    v = _mix(x, xs, p.mu[2]) @ p.wv_t.to(dt)
    g = _mix(x, xs, p.mu[3]) @ p.wg.to(dt)
    lw = _decay(p, _mix(x, xs, p.mu[4]), cfg)

    rh = r.reshape(b, h, HEAD_DIM).float()
    kh = k.reshape(b, h, HEAD_DIM).float()
    vh = v.reshape(b, h, HEAD_DIM).float()
    wh = torch.exp(lw.reshape(b, h, HEAD_DIM))
    u = p.u.float()
    s0 = cache["state"]
    kv = kh[..., :, None] * vh[..., None, :]                 # (B,H,hd,hd)
    y = torch.einsum("bhk,bhkv->bhv", rh * u[None], kv) \
        + torch.einsum("bhk,bhkv->bhv", rh, s0)
    state = wh[..., :, None] * s0 + kv
    y = _headnorm(y[:, :, None, :], p.ln_x, h).to(dt)
    out = (y * F.silu(g)) @ p.w_out_t.to(dt)
    return out, {"state": state, "last": x}


def channel_mix(p, x, cfg: ModelConfig, last=None):
    dt = cfg.cdtype
    xs = _shift(x, last)
    xk = _mix(x, xs, p.mu_c[0])
    xr = _mix(x, xs, p.mu_c[1])
    kk = torch.square(torch.relu(xk @ p.wk_c.to(dt)))
    return torch.sigmoid(xr @ p.wr_c.to(dt)) * (kk @ p.wv_c.to(dt))


def make_rwkv_cache(cfg: ModelConfig, batch: int, device) -> dict:
    h = n_heads(cfg)
    return {
        "state": torch.zeros((batch, h, HEAD_DIM, HEAD_DIM),
                             dtype=torch.float32, device=device),
        "last": torch.zeros((batch, 1, cfg.d_model), dtype=cfg.cdtype,
                            device=device),
        "last_c": torch.zeros((batch, 1, cfg.d_model), dtype=cfg.cdtype,
                              device=device),
    }


__all__ = ["HEAD_DIM", "LORA_DIM", "n_heads", "init_rwkv_block",
           "wkv_inputs", "time_mix", "time_mix_decode", "channel_mix",
           "make_rwkv_cache"]
