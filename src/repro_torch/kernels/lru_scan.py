"""RG-LRU linear recurrence: the wrapper of ``csrc/lru_scan.cu`` and its
plain PyTorch version.

Per channel (b, d)::

    h_t = a_t h_{t-1} + x_t,        h_{-1} = 0

``a, x (B, T, D)``, both cast to f32; returns ``h (B, T, D)`` f32: the
contract of the reference's Pallas ``lru_scan``
(``repro.kernels.ops.lru_scan``), without its ``chunk`` argument (the CUDA
kernel reads its own chunks of steps and takes any T and D).

On a CUDA tensor :func:`lru_scan` launches the kernel or raises; on a
``meta`` tensor it launches nothing and charges the kernel's work
(:func:`lru_scan_cost`, ``kernels.charge``); the plain version serves
CPU tensors only, and is what ``chip_smoke.py`` holds the
kernel against on the card. ``LAUNCHES["lru_scan"]`` counts kernel
launches; the wrapper adds one where it launches the kernel and nowhere
else.

Gradients go through :class:`LRUScanFn`, whose backward is a reverse
linear scan, the kernel ``lru_scan_bwd_launch`` in the same source (the
JAX package trains the RG-LRU through ``lax.associative_scan`` and has no
backward Pallas kernel); with ``G_t = dL/dh_t``::

    G_t = dh_t + a_{t+1} G_{t+1},   dx_t = G_t,   da_t = G_t h_{t-1}

:func:`lru_scan_backward_plain` computes the same step by step and serves
CPU tensors; on a CUDA tensor the backward launches the kernel
(``LAUNCHES["lru_scan_bwd"]``) or raises.
"""
from __future__ import annotations

import torch

LAUNCHES = {"lru_scan": 0, "lru_scan_bwd": 0}
#: Steps the kernel reads into one register buffer (``kSteps`` in
#: ``csrc/lru_scan.cu``): a carry dropped at a multiple of it is the
#: kernel's likeliest fault.
STEPS = 32
_MAX_ROWS = 65535   # grid.y limit: one row of CTAs per b


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def lru_scan_cost(b: int, t: int, d: int) -> tuple[int, int]:
    """``(bytes, flops)`` of the scan: a and x read, h written (f32), a
    multiply and an add an element."""
    n = b * t * d
    return 12 * n, 2 * n


def lru_scan_bwd_cost(b: int, t: int, d: int) -> tuple[int, int]:
    """``(bytes, flops)`` of the reverse scan: a, h and dh read, da and dx
    written (f32), three flops an element."""
    n = b * t * d
    return 20 * n, 3 * n


def _meta(a, x):
    """The kernel's output on the ``meta`` device, its work charged."""
    from repro_torch import kernels

    h = torch.empty_like(a)
    kernels.charge("lru_scan", *lru_scan_cost(*_shapes(a, x)))
    return h


def _meta_bwd(a, h, dh):
    """The backward kernel's outputs on the ``meta`` device, its work
    charged."""
    from repro_torch import kernels

    shape = _shapes(a, h)
    _shapes(a, dh)
    da, dx = torch.empty_like(a), torch.empty_like(a)
    kernels.charge("lru_scan_bwd", *lru_scan_bwd_cost(*shape))
    return da, dx


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


def lru_scan_backward_plain(a, h, dh):
    """Plain version of the backward: ``(da, dx)`` in the dtype of the
    inputs, the reverse scan step by step (``h`` the forward's output)."""
    b, t, d = _shapes(a, h)
    _shapes(a, dh)
    g = torch.zeros((b, d), dtype=a.dtype, device=a.device)
    da, dx = torch.empty_like(a), torch.empty_like(a)
    for i in reversed(range(t)):
        g = dh[:, i] + (a[:, i + 1] * g if i + 1 < t else 0)
        dx[:, i] = g
        da[:, i] = g * h[:, i - 1] if i else 0
    return da, dx


# --------------------------------------------------------------------------
# CUDA launch.
# --------------------------------------------------------------------------
def _check(b, t, d, device, named):
    """Raise on a shape, type, layout or device the kernels do not take."""
    if not 1 <= b <= _MAX_ROWS or t < 1 or d < 1:
        raise ValueError(f"lru_scan kernel takes 1 <= B <= {_MAX_ROWS}, "
                         f"T >= 1 and D >= 1; got {(b, t, d)}")
    for name, v in named:
        if v.device != device:
            raise ValueError(f"lru_scan: {name} is on {v.device}, a on "
                             f"{device}")
        if v.dtype != torch.float32:
            raise TypeError(f"lru_scan: {name} has dtype {v.dtype}, the "
                            "kernel takes float32")
        if not v.is_contiguous():
            raise ValueError(f"lru_scan: {name} must be contiguous")
    if device.type != "cuda":
        raise ValueError(f"the CUDA kernel takes CUDA tensors, got {device}")


def _launch(a, x):
    """Check both arguments, then launch ``csrc/lru_scan.cu``; raises on a
    shape, type, layout or device the kernel does not take, before any
    launch."""
    b, t, d = _shapes(a, x)
    device = a.device
    _check(b, t, d, device, (("a", a), ("x", x)))
    from repro_torch.kernels import build

    h = torch.empty((b, t, d), dtype=torch.float32, device=device)
    err = build.load("lru_scan").lru_scan_launch(
        a.data_ptr(), x.data_ptr(), h.data_ptr(), b, t, d,
        torch.cuda.current_stream(device).cuda_stream)
    if err:
        raise RuntimeError(f"lru_scan launch failed: cudaError {err}")
    LAUNCHES["lru_scan"] += 1
    return h


def _launch_bwd(a, h, dh):
    """Check every argument, then launch the backward kernel; raises
    before any launch on what it does not take."""
    b, t, d = _shapes(a, h)
    _shapes(a, dh)
    device = a.device
    _check(b, t, d, device, (("a", a), ("h", h), ("dh", dh)))
    from repro_torch.kernels import build

    da, dx = torch.empty_like(a), torch.empty_like(a)
    err = build.load("lru_scan").lru_scan_bwd_launch(
        a.data_ptr(), h.data_ptr(), dh.data_ptr(), da.data_ptr(),
        dx.data_ptr(), b, t, d,
        torch.cuda.current_stream(device).cuda_stream)
    if err:
        raise RuntimeError(f"lru_scan backward launch failed: cudaError "
                           f"{err}")
    LAUNCHES["lru_scan_bwd"] += 1
    return da, dx


def lru_scan_backward(a, h, dh):
    """``(da, dx)`` f32: the CUDA kernel for tensors on a card (``dh`` cast
    to f32 and made contiguous first), the plain version on the CPU."""
    if a.device.type == "cpu":
        return lru_scan_backward_plain(a, h, dh.to(a.dtype))
    if a.device.type == "meta":
        return _meta_bwd(a, h, dh.to(torch.float32).contiguous())
    return _launch_bwd(a, h, dh.to(torch.float32).contiguous())


class LRUScanFn(torch.autograd.Function):
    """``h = lru_scan(a, x)`` with the backward kernel: the forward keeps
    ``a`` and its output ``h``."""

    @staticmethod
    def forward(ctx, a, x):
        h = (lru_scan_plain(a, x) if a.device.type == "cpu"
             else _meta(a, x) if a.device.type == "meta" else _launch(a, x))
        ctx.save_for_backward(a, h)
        return h

    @staticmethod
    def backward(ctx, dh):
        return lru_scan_backward(*ctx.saved_tensors, dh)


def lru_scan(a, x):
    """``h (B, T, D)`` f32 of the recurrence: the CUDA kernel for tensors
    on a card (inputs cast to f32 first), the plain version for tensors on
    the CPU; where autograd records, through :class:`LRUScanFn`."""
    f32 = torch.float32
    a, x = a.to(f32).contiguous(), x.to(f32).contiguous()
    if torch.is_grad_enabled() and (a.requires_grad or x.requires_grad):
        return LRUScanFn.apply(a, x)
    if a.device.type == "cpu" and x.device.type == "cpu":
        return lru_scan_plain(a, x)
    if a.device.type == "meta":
        return _meta(a, x)
    return _launch(a, x)


__all__ = ["lru_scan", "lru_scan_plain", "lru_scan_steps",
           "lru_scan_backward", "lru_scan_backward_plain", "LRUScanFn",
           "lru_scan_cost", "lru_scan_bwd_cost",
           "LAUNCHES", "STEPS", "reset_launch_counts"]
