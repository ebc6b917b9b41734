"""RG-LRU linear recurrence: the wrapper of ``csrc/lru_scan.cu`` and its
plain PyTorch version.

Per channel (b, d)::

    h_t = a_t h_{t-1} + x_t,        h_{-1} = 0

``a, x (B, T, D)``, both cast to f32; returns ``h (B, T, D)`` f32: the
contract of the reference's Pallas ``lru_scan``
(``repro.kernels.ops.lru_scan``), without its ``chunk`` argument (the CUDA
kernel reads its own chunks of steps and takes any T and D).

On a CUDA tensor :func:`lru_scan` launches the kernel or raises; the plain
version serves CPU tensors only, and is what ``chip_smoke.py`` holds the
kernel against on the card. ``LAUNCHES["lru_scan"]`` counts kernel
launches; the wrapper adds one where it launches the kernel and nowhere
else.
"""
from __future__ import annotations

import torch

LAUNCHES = {"lru_scan": 0}
#: Steps the kernel reads into one register buffer (``kSteps`` in
#: ``csrc/lru_scan.cu``): a carry dropped at a multiple of it is the
#: kernel's likeliest fault.
STEPS = 32
_MAX_ROWS = 65535   # grid.y limit: one row of CTAs per b


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _shapes(a, x):
    """``(B, T, D)`` of a consistent argument pair; raises otherwise."""
    if a.dim() != 3 or tuple(a.shape) != tuple(x.shape):
        raise ValueError(f"lru_scan takes a, x (B, T, D) of one shape; got "
                         f"a {tuple(a.shape)}, x {tuple(x.shape)}")
    return tuple(a.shape)


# --------------------------------------------------------------------------
# Plain PyTorch version.
# --------------------------------------------------------------------------
def lru_scan_steps(a, x):
    """The recurrence, one step at a time, in the dtype of the inputs (the
    reference's ``ref.lru_scan_ref``)."""
    b, t, d = _shapes(a, x)
    h = torch.zeros((b, d), dtype=a.dtype, device=a.device)
    out = torch.empty((b, t, d), dtype=a.dtype, device=a.device)
    for i in range(t):
        h = a[:, i] * h + x[:, i]
        out[:, i] = h
    return out


def lru_scan_plain(a, x):
    """Plain version of :func:`lru_scan`: :func:`lru_scan_steps` in f32."""
    return lru_scan_steps(a.to(torch.float32), x.to(torch.float32))


# --------------------------------------------------------------------------
# CUDA launch.
# --------------------------------------------------------------------------
def _launch(a, x):
    """Check both arguments, then launch ``csrc/lru_scan.cu``; raises on a
    shape, type, layout or device the kernel does not take, before any
    launch."""
    b, t, d = _shapes(a, x)
    if not 1 <= b <= _MAX_ROWS or t < 1 or d < 1:
        raise ValueError(f"lru_scan kernel takes 1 <= B <= {_MAX_ROWS}, "
                         f"T >= 1 and D >= 1; got {(b, t, d)}")
    device = a.device
    for name, v in (("a", a), ("x", x)):
        if v.device != device:
            raise ValueError(f"lru_scan: {name} is on {v.device}, a on "
                             f"{device}")
        if v.dtype != torch.float32:
            raise TypeError(f"lru_scan: {name} has dtype {v.dtype}, the "
                            "kernel takes float32")
        if not v.is_contiguous():
            raise ValueError(f"lru_scan: {name} must be contiguous")
        if v.requires_grad and torch.is_grad_enabled():
            raise RuntimeError("lru_scan: the CUDA kernel has no backward; "
                               "call it under torch.no_grad()")
    if device.type != "cuda":
        raise ValueError(f"the CUDA kernel takes CUDA tensors, got {device}")
    from repro_torch.kernels import build

    h = torch.empty((b, t, d), dtype=torch.float32, device=device)
    err = build.load("lru_scan").lru_scan_launch(
        a.data_ptr(), x.data_ptr(), h.data_ptr(), b, t, d,
        torch.cuda.current_stream(device).cuda_stream)
    if err:
        raise RuntimeError(f"lru_scan launch failed: cudaError {err}")
    LAUNCHES["lru_scan"] += 1
    return h


def lru_scan(a, x):
    """``h (B, T, D)`` f32 of the recurrence: the CUDA kernel for tensors
    on a card (inputs cast to f32 first), the plain version for tensors on
    the CPU."""
    if a.device.type == "cpu" and x.device.type == "cpu":
        return lru_scan_plain(a, x)
    f32 = torch.float32
    return _launch(a.to(f32).contiguous(), x.to(f32).contiguous())


__all__ = ["lru_scan", "lru_scan_plain", "lru_scan_steps", "LAUNCHES",
           "STEPS", "reset_launch_counts"]
