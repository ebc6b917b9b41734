"""RWKV-6 WKV recurrence: the wrapper of ``csrc/wkv6.cu``, its plain
PyTorch version, and a CPU twin of the kernel's order of sums.

Per row bh of the (batch x heads) axis::

    y_t = (r_t . u) (k_t v_t^T) + r_t^T S_{t-1}
    S_t = diag(w_t) S_{t-1} + k_t v_t^T,        S_0 = 0

``r, k, w (BH, T, K)``, ``v (BH, T, V)``, ``u (BH, K)``, all cast to f32;
returns ``y (BH, T, V)`` f32: the contract of the reference's Pallas
``wkv6`` (``repro.kernels.ops.wkv6``), without its ``chunk`` argument (the
CUDA kernel stages its own chunks of steps and takes any T).

The kernel scans t on CUDA cores: one CTA per (bh, tile of up to 16
columns of V); each column's K rows are cut into :func:`kernel_groups`
slices, one to each quarter-warp, and a lane scans two columns, keeping
its slice of them of S in registers. A chunk's partial readouts are
summed across the quarters by shuffles and across the warps through
shared memory, in a fixed order; the bonus ``b_t = r_t . (u o k_t)`` is
computed once a step, so ``y_t = b_t v_t + r_t^T S_{t-1}``.
:func:`wkv6_grouped` computes the recurrence in that order on any device;
the tests hold it against the reference, and the kernel against it.

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
#: Slices the kernel cuts a column's K into (``kGroups`` in
#: ``csrc/wkv6.cu``), at most K / 4: see :func:`kernel_groups`.
GROUPS = 8


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


def kernel_groups(kd: int) -> int:
    """Slices the kernel cuts a column's ``kd`` rows of K into."""
    return min(GROUPS, kd // 4)


def slices(kd: int, groups: int) -> torch.Tensor:
    """The slice that each of the ``kd`` rows of K falls to: quads of rows
    (fewer rows where ``kd / groups < 4``) dealt round-robin to the
    ``groups`` slices, as the kernel's float4 reads deal them."""
    q = min(4, kd // groups)
    return (torch.arange(kd) // q) % groups


def _warp_sums(x, groups):
    """Partial sums of ``x (BH, K, N)`` over K in the kernel's order, one
    for each warp's ``min(4, groups)`` slices: each slice's rows
    (:func:`slices`) summed as two sums, of the even and of the odd
    positions of its quads, then added; then a warp's slices in the tree
    of its shuffles (for four slices ``(s0 + s2) + (s1 + s3)``). Returns a
    list of ``(BH, N)`` tensors, warp 0 first."""
    bh, kd, n = x.shape
    q = min(4, kd // groups)
    part = x.reshape(bh, kd // (q * groups), groups, q, n)
    if q > 1:
        part = part.reshape(bh, -1, groups, q // 2, 2, n).sum((1, 3))
        lanes = list((part[:, :, 0] + part[:, :, 1]).unbind(1))
    else:
        lanes = list(part.sum(1)[:, :, 0].unbind(1))
    per_warp = min(4, groups)
    warps = []
    for w0 in range(0, groups, per_warp):
        tree = lanes[w0:w0 + per_warp]
        off = per_warp // 2
        while off:
            tree = [tree[i] + tree[i ^ off] for i in range(per_warp)]
            off //= 2
        warps.append(tree[0])
    return warps


def wkv6_grouped(r, k, w, v, u, groups):
    """The recurrence in the CUDA kernel's order, in f32: K cut into
    ``groups`` slices (:func:`slices`), four slices to a warp, and the
    partial sums taken as :func:`_warp_sums` takes them; ``b_t = r_t .
    (u o k_t)`` once a step, its warps' sums added in warp order; ``y_t``
    is warp 0's readout plus ``b_t v_t``, then each further warp's
    readout in warp order. Used by the tests only; the kernel's own
    ``groups`` is :func:`kernel_groups`."""
    bh, t, kd, vd = _shapes(r, k, w, v, u)
    if groups not in (1, 2, 4, 8) or groups > kd:
        raise ValueError(f"wkv6_grouped takes groups in (1, 2, 4, 8), at "
                         f"most K = {kd}; got {groups}")
    f32 = torch.float32
    r, k, w, v, u = (x.to(f32) for x in (r, k, w, v, u))
    s = torch.zeros((bh, kd, vd), dtype=f32, device=r.device)
    y = torch.empty((bh, t, vd), dtype=f32, device=r.device)
    for i in range(t):
        ri = r[:, i, :, None]
        bonus = _warp_sums(ri * (u * k[:, i])[:, :, None], groups)
        b = bonus[0]
        for part in bonus[1:]:
            b = b + part                                      # (BH, 1)
        read = _warp_sums(ri * s, groups)
        yi = b * v[:, i] + read[0]
        for part in read[1:]:
            yi = yi + part
        y[:, i] = yi
        s = w[:, i, :, None] * s + k[:, i, :, None] * v[:, i, None, :]
    return y


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


__all__ = ["wkv6", "wkv6_plain", "wkv6_scan", "wkv6_grouped",
           "kernel_groups", "slices", "LAUNCHES", "KERNEL_DIMS", "GROUPS",
           "reset_launch_counts"]
