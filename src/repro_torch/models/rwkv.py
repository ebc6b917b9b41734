"""RWKV-6 "Finch" block (arXiv:2404.05892): data-dependent-decay time-mix
and squared-ReLU channel-mix.

The full-sequence ``time_mix`` (prefill) runs the exact WKV recurrence in
the ``wkv6`` kernel, on ``(B*H, S, 64)`` rows; the reference computes the
same recurrence in chunked form (an XLA device, not ported). Decode runs
the one-token recurrence as plain tensor ops with the ``(hd, hd)`` state
cached, as in the reference. ``p`` is a block's parameter module (the
reference's keys as attributes).

Tensor parallelism (``models.transformer.apply_block_tp``): the model
axis splits the D columns of ``wr``, ``wk_t``, ``wv_t`` and ``wg``, the
rows of ``w_out_t``, ``wk_c``'s d_ff columns and ``wv_c``'s rows;
``mu``, ``wa_lora``, ``wb_lora``, ``w0``, ``u``, ``ln_x``, ``mu_c`` and
``wr_c`` are whole on every shard and sliced to its columns here.
:func:`time_mix_tp` gives each shard's partial output of ``w_out_t``, and
:func:`channel_mix` on a shard's pieces its partial of ``wv_c``; the
caller sums each over the axis. A shard whose columns cut a head
(``D / tp`` not a multiple of 64) gathers r, k, v and the decay over the
axis and runs every head, then keeps its columns.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import sharding
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


def _decay(p, xw, cfg: ModelConfig, cols: slice | None = None):
    """log w_t = -exp(w0 + tanh(x W_a) W_b)  (negative, data-dependent);
    of the columns ``cols`` of D (all without them)."""
    dt = cfg.cdtype
    wb, w0 = (p.wb_lora, p.w0) if cols is None \
        else (p.wb_lora[:, cols], p.w0[cols])
    lora = torch.tanh(xw @ p.wa_lora.to(dt)) @ wb.to(dt)
    return -torch.exp(w0.float() + lora.float())


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


def _projections(p, x, cfg: ModelConfig, cols: slice | None = None):
    """``(r, k, v, g, lw)`` of the n columns that ``p``'s ``wr``,
    ``wk_t``, ``wv_t`` and ``wg`` hold (``cols`` of D: all without it):
    (B, S, n) each, r, k, v, g in the compute dtype, the log decay lw in
    f32."""
    dt = cfg.cdtype
    xs = _shift(x)
    r = _mix(x, xs, p.mu[0]) @ p.wr.to(dt)
    k = _mix(x, xs, p.mu[1]) @ p.wk_t.to(dt)
    v = _mix(x, xs, p.mu[2]) @ p.wv_t.to(dt)
    g = _mix(x, xs, p.mu[3]) @ p.wg.to(dt)
    lw = _decay(p, _mix(x, xs, p.mu[4]), cfg, cols)           # f32
    return r, k, v, g, lw


def _rows(t, h):
    """(B, S, h hd) -> the kernel's (B*h, S, hd) f32 rows."""
    b, s, _ = t.shape
    return _heads(t, h).float().reshape(b * h, s, HEAD_DIM).contiguous()


def wkv_inputs(p, x, cfg: ModelConfig):
    """The projections of ``time_mix``: ``(r, k, w, v, u, g)``, with r, k,
    w, v as ``(B*H, S, hd)`` f32 rows and ``u (B*H, hd)``, the arguments
    of ``wkv6``; ``g (B, S, D)`` in the compute dtype."""
    h = n_heads(cfg)
    r, k, v, g, lw = _projections(p, x, cfg)
    u = p.u.float().repeat(x.shape[0], 1)                   # (B*H, hd)
    return _rows(r, h), _rows(k, h), torch.exp(_rows(lw, h)), _rows(v, h), \
        u, g


def _wkv_normed(p, r, k, v, lw, cfg: ModelConfig, head0: int = 0):
    """``wkv6`` over the heads of r, k, v, lw (B, S, n), the first of
    them head ``head0`` of the layer (its rows of ``u`` and its columns
    of ``ln_x``), then the per-head norm: (B, S, n) in the compute
    dtype."""
    b, s, n = r.shape
    h = n // HEAD_DIM
    u = p.u[head0:head0 + h].float().repeat(b, 1)
    y = wkv6(_rows(r, h), _rows(k, h), torch.exp(_rows(lw, h)), _rows(v, h),
             u).reshape(b, h, s, HEAD_DIM)
    lo = head0 * HEAD_DIM
    return _headnorm(y, p.ln_x[lo:lo + n], h).to(cfg.cdtype)


def _check_seq(s: int, chunk: int | None) -> None:
    """Refuse S as the reference does (its chunked algebra needs ``S %
    min(chunk, S) == 0``): the kernel itself takes any S."""
    if chunk is None:
        chunk = 32 if s <= 512 else 256
    c = min(chunk, s)
    if s % c:
        raise ValueError(f"time_mix: S={s} is not a multiple of the chunk "
                         f"{c}")


def time_mix(p, x, cfg: ModelConfig, chunk: int | None = None):
    """Full-sequence WKV6; x: (B, S, D). ``chunk`` only checks S
    (:func:`_check_seq`)."""
    _check_seq(x.shape[1], chunk)
    r, k, v, g, lw = _projections(p, x, cfg)
    y = _wkv_normed(p, r, k, v, lw, cfg)
    return (y * F.silu(g)) @ p.w_out_t.to(cfg.cdtype)


def tmix_split(p, cfg: ModelConfig) -> bool:
    """Whether the model axis splits this shard's time mix (``wr``'s D
    columns; the reference splits the five projections alike)."""
    return p.wr.shape[1] < cfg.d_model


def cmix_split(p, cfg: ModelConfig) -> bool:
    """Whether the model axis splits this shard's channel mix (``wk_c``'s
    d_ff columns and ``wv_c``'s rows): :func:`channel_mix` on its pieces
    is then a partial output of ``wv_c``."""
    return p.wk_c.shape[1] < cfg.d_ff


def _tmix_in(p, x, cfg: ModelConfig, j: int):
    """Model shard ``j``'s ``(r, k, v, lw, g)``: its n columns of each."""
    n = p.wr.shape[1]
    r, k, v, g, lw = _projections(p, x, cfg, slice(j * n, (j + 1) * n))
    return r, k, v, lw, g


def _tmix_out(p, r, k, v, lw, g, cfg: ModelConfig, j: int):
    """Model shard ``j``'s partial output of ``w_out_t`` from ``g`` (its
    n columns) and r, k, v, lw of its own whole heads (n columns too) or
    of all D columns (gathered over the axis: every head runs, and the
    shard keeps its columns of the normed output)."""
    n = g.shape[-1]
    if r.shape[-1] == n:
        y = _wkv_normed(p, r, k, v, lw, cfg, head0=j * n // HEAD_DIM)
    else:
        y = _wkv_normed(p, r, k, v, lw, cfg)[..., j * n:(j + 1) * n]
    return (y * F.silu(g)) @ p.w_out_t.to(cfg.cdtype)


def _tmix_shard(p, x, cfg: ModelConfig, j: int):
    return _tmix_out(p, *_tmix_in(p, x, cfg, j), cfg, j)


def time_mix_tp(ps, xs, cfg: ModelConfig, remat=lambda fn: fn):
    """:func:`time_mix` over the model axis where it splits the time mix
    (:func:`tmix_split`): ``ps`` holds each shard's block params, ``xs``
    its normed input (B, S, D); returns each shard's partial output of
    ``w_out_t``, for the caller to sum. Where each shard's columns are
    whole heads it runs ``wkv6`` on its heads alone, one ``remat``-ed
    function a shard; where they cut a head, the projections (one
    ``remat``-ed function) are followed by an all-gather of r, k, v and
    the decay, and every head runs on every shard (the second
    ``remat``-ed function)."""
    _check_seq(xs[0].shape[1], None)
    if ps[0].wr.shape[1] % HEAD_DIM == 0:
        run = remat(_tmix_shard)
        return [run(p, x, cfg, j) for j, (p, x) in enumerate(zip(ps, xs))]
    proj = remat(_tmix_in)
    parts = [proj(p, x, cfg, j) for j, (p, x) in enumerate(zip(ps, xs))]
    whole = [sharding.all_gather([q[i] for q in parts], -1)
             for i in range(4)]                               # r, k, v, lw
    out = remat(_tmix_out)
    return [out(p, *(w[j] for w in whole), parts[j][4], cfg, j)
            for j, p in enumerate(ps)]


def _decode_inputs(p, x, last, cfg: ModelConfig, cols: slice | None = None):
    """A decode step's ``(r, k, v, g, lw)`` (B, 1, n) of the n columns
    ``p``'s projections hold (``cols`` of D; all without it)."""
    dt = cfg.cdtype
    xs = last.to(x.dtype)
    r = _mix(x, xs, p.mu[0]) @ p.wr.to(dt)
    k = _mix(x, xs, p.mu[1]) @ p.wk_t.to(dt)
    v = _mix(x, xs, p.mu[2]) @ p.wv_t.to(dt)
    g = _mix(x, xs, p.mu[3]) @ p.wg.to(dt)
    lw = _decay(p, _mix(x, xs, p.mu[4]), cfg, cols)
    return r, k, v, g, lw


def _decode_readout(p, r, k, v, lw, s0, cfg: ModelConfig):
    """One step of the recurrence over every head: the normed readout
    (B, 1, D) in the compute dtype and the new state."""
    b = r.shape[0]
    h = n_heads(cfg)
    rh = r.reshape(b, h, HEAD_DIM).float()
    kh = k.reshape(b, h, HEAD_DIM).float()
    vh = v.reshape(b, h, HEAD_DIM).float()
    wh = torch.exp(lw.reshape(b, h, HEAD_DIM))
    u = p.u.float()
    kv = kh[..., :, None] * vh[..., None, :]                 # (B,H,hd,hd)
    y = torch.einsum("bhk,bhkv->bhv", rh * u[None], kv) \
        + torch.einsum("bhk,bhkv->bhv", rh, s0)
    state = wh[..., :, None] * s0 + kv
    return _headnorm(y[:, :, None, :], p.ln_x, h).to(cfg.cdtype), state


def time_mix_decode(p, x, cache, cfg: ModelConfig):
    """x: (B, 1, D); cache: {"state": (B,H,hd,hd), "last": (B,1,D)}."""
    r, k, v, g, lw = _decode_inputs(p, x, cache["last"], cfg)
    y, state = _decode_readout(p, r, k, v, lw, cache["state"], cfg)
    out = (y * F.silu(g)) @ p.w_out_t.to(cfg.cdtype)
    return out, {"state": state, "last": x}


def time_mix_decode_tp(ps, xs, caches, cfg: ModelConfig):
    """:func:`time_mix_decode` over the model axis: ``ps`` each shard's
    block params, ``xs`` its normed input (B, 1, D), ``caches`` its
    cache (the state whole on every shard: the rule replicates it over
    the model axis). Where the axis splits the time mix
    (:func:`tmix_split`), each shard's columns of r, k, v and the decay
    are gathered over the axis, every shard steps the whole state (the
    replicas stay equal) and returns its partial output of ``w_out_t``
    from its columns of the readout, for the caller to sum; otherwise
    each shard runs :func:`time_mix_decode` whole. Returns (outputs, new
    caches)."""
    if not tmix_split(ps[0], cfg):
        res = [time_mix_decode(p, x, c, cfg)
               for p, x, c in zip(ps, xs, caches)]
        return [o for o, _ in res], [c for _, c in res]
    parts = []
    for j, (p, x, c) in enumerate(zip(ps, xs, caches)):
        n = p.wr.shape[1]
        parts.append(_decode_inputs(p, x, c["last"], cfg,
                                    slice(j * n, (j + 1) * n)))
    whole = [sharding.all_gather([q[i] for q in parts], -1)
             for i in (0, 1, 2, 4)]                          # r, k, v, lw
    outs, new = [], []
    for j, (p, x, c) in enumerate(zip(ps, xs, caches)):
        g = parts[j][3]
        n = g.shape[-1]
        y, state = _decode_readout(p, *(w[j] for w in whole), c["state"],
                                   cfg)
        outs.append((y[..., j * n:(j + 1) * n] * F.silu(g))
                    @ p.w_out_t.to(cfg.cdtype))
        new.append({"state": state, "last": x})
    return outs, new


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


__all__ = ["HEAD_DIM", "LORA_DIM", "channel_mix", "cmix_split",
           "init_rwkv_block", "make_rwkv_cache", "n_heads", "time_mix",
           "time_mix_decode", "time_mix_decode_tp", "time_mix_tp",
           "tmix_split", "wkv_inputs"]
