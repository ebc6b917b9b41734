"""RWKV-6 WKV recurrence: the wrapper of ``csrc/wkv6.cu`` and its plain
PyTorch version.

Per row bh of the (batch x heads) axis::

    y_t = (r_t . u) (k_t v_t^T) + r_t^T S_{t-1}
    S_t = diag(w_t) S_{t-1} + k_t v_t^T,        S_0 = 0

``r, k, w (BH, T, K)``, ``v (BH, T, V)``, ``u (BH, K)``, all cast to f32;
returns ``y (BH, T, V)`` f32: the contract of the reference's Pallas
``wkv6`` (``repro.kernels.ops.wkv6``), without its ``chunk`` argument (the
CUDA kernel stages its own chunks of steps and takes any T).

On a CUDA tensor :func:`wkv6` launches the kernel or raises; the plain
version serves CPU tensors only, and is what ``chip_smoke.py`` holds the
kernel against on the card. ``LAUNCHES["wkv6"]`` counts kernel launches;
the wrapper adds one where it launches the kernel and nowhere else.
"""
from __future__ import annotations

import torch

LAUNCHES = {"wkv6": 0}
#: Key and value widths the kernel is compiled for (``csrc/wkv6.cu``).
KERNEL_DIMS = (8, 16, 32, 64)
_MAX_ROWS = 65535   # grid.y limit: one row of CTAs per bh


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _shapes(r, k, w, v, u):
    """``(BH, T, K, V)`` of a consistent argument list; raises otherwise."""
    if r.dim() != 3 or v.dim() != 3 or u.dim() != 2:
        raise ValueError(f"wkv6 takes r, k, w (BH, T, K), v (BH, T, V), "
                         f"u (BH, K); got r {tuple(r.shape)}, v "
                         f"{tuple(v.shape)}, u {tuple(u.shape)}")
    bh, t, kd = r.shape
    vd = v.shape[-1]
    for name, x, shape in (("k", k, (bh, t, kd)), ("w", w, (bh, t, kd)),
                           ("v", v, (bh, t, vd)), ("u", u, (bh, kd))):
        if tuple(x.shape) != shape:
            raise ValueError(f"wkv6: {name} has shape {tuple(x.shape)}, "
                             f"expected {shape}")
    return bh, t, kd, vd


# --------------------------------------------------------------------------
# Plain PyTorch version.
# --------------------------------------------------------------------------
def wkv6_scan(r, k, w, v, u):
    """The recurrence, one step at a time, in the dtype of the inputs (the
    reference's ``ref.wkv6_ref``). Products are written out as
    multiply-and-sum, so no matrix unit (and no TF32) is involved."""
    bh, t, kd, vd = _shapes(r, k, w, v, u)
    s = torch.zeros((bh, kd, vd), dtype=r.dtype, device=r.device)
    y = torch.empty((bh, t, vd), dtype=r.dtype, device=r.device)
    for i in range(t):
        kv = k[:, i, :, None] * v[:, i, None, :]                # (BH, K, V)
        ri = r[:, i, :, None]
        y[:, i] = ((ri * u[:, :, None]) * kv).sum(1) + (ri * s).sum(1)
        s = w[:, i, :, None] * s + kv
    return y


def wkv6_plain(r, k, w, v, u):
    """Plain version of :func:`wkv6`: :func:`wkv6_scan` in f32."""
    f32 = torch.float32
    return wkv6_scan(*(x.to(f32) for x in (r, k, w, v, u)))


# --------------------------------------------------------------------------
# CUDA launch.
# --------------------------------------------------------------------------
def _launch(r, k, w, v, u):
    """Check every argument, then launch ``csrc/wkv6.cu``; raises on a
    shape, type, layout or device the kernel does not take, before any
    launch."""
    bh, t, kd, vd = _shapes(r, k, w, v, u)
    if kd not in KERNEL_DIMS or vd not in KERNEL_DIMS:
        raise ValueError(f"wkv6 kernel takes K and V in {KERNEL_DIMS}; got "
                         f"K={kd}, V={vd}")
    if not 1 <= bh <= _MAX_ROWS or t < 1:
        raise ValueError(f"wkv6 kernel takes 1 <= BH <= {_MAX_ROWS} and "
                         f"T >= 1; got BH={bh}, T={t}")
    device = r.device
    for name, x in (("r", r), ("k", k), ("w", w), ("v", v), ("u", u)):
        if x.device != device:
            raise ValueError(f"wkv6: {name} is on {x.device}, r on {device}")
        if x.dtype != torch.float32:
            raise TypeError(f"wkv6: {name} has dtype {x.dtype}, the kernel "
                            "takes float32")
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"wkv6: {name} must be contiguous and 16-byte "
                             "aligned")
        if x.requires_grad and torch.is_grad_enabled():
            raise RuntimeError("wkv6: the CUDA kernel has no backward; call "
                               "it under torch.no_grad()")
    if device.type != "cuda":
        raise ValueError(f"the CUDA kernel takes CUDA tensors, got {device}")
    from repro_torch.kernels import build

    y = torch.empty((bh, t, vd), dtype=torch.float32, device=device)
    err = build.load("wkv6").wkv6_launch(
        r.data_ptr(), k.data_ptr(), w.data_ptr(), v.data_ptr(), u.data_ptr(),
        y.data_ptr(), bh, t, kd, vd,
        torch.cuda.current_stream(device).cuda_stream)
    if err:
        raise RuntimeError(f"wkv6 launch failed: cudaError {err}")
    LAUNCHES["wkv6"] += 1
    return y


def wkv6(r, k, w, v, u):
    """``y (BH, T, V)`` f32 of the WKV recurrence: the CUDA kernel for
    tensors on a card (inputs cast to f32 first), the plain version for
    tensors on the CPU."""
    if r.device.type == "cpu":
        return wkv6_plain(r, k, w, v, u)
    f32 = torch.float32
    return _launch(*(x.to(f32).contiguous() for x in (r, k, w, v, u)))


__all__ = ["wkv6", "wkv6_plain", "wkv6_scan", "LAUNCHES", "KERNEL_DIMS",
           "reset_launch_counts"]
