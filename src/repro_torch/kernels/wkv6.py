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

On a CUDA tensor :func:`wkv6` launches the kernel or raises; on a
``meta`` tensor it launches nothing and charges the kernel's work
(:func:`wkv6_cost`, ``kernels.charge``); the plain version serves CPU
tensors only, and is what ``chip_smoke.py`` holds the
kernel against on the card. ``LAUNCHES["wkv6"]`` counts kernel launches;
the wrapper adds one where it launches the kernel and nowhere else.

Gradients go through :class:`WKV6Fn`, whose backward is the port's own
kernel ``csrc/wkv6_bwd.cu`` (the JAX package trains RWKV-6 through its
chunked ``jnp`` algebra and has no backward Pallas kernel); with ``G_t =
dL/dS_t``, ``G_{T-1} = 0``, ``G_{t-1} = diag(w_t) G_t + r_t dy_t^T``::

    dr_t = S_{t-1} dy_t + (u o k_t)(v_t . dy_t)
    dk_t = G_t v_t + (u o r_t)(v_t . dy_t)
    dv_t = G_t^T k_t + (r_t . (u o k_t)) dy_t
    dw_t[i] = sum_j S_{t-1}[i, j] G_t[i, j]
    du = sum_t (r_t o k_t)(v_t . dy_t)

:func:`wkv6_backward_plain` computes the same step by step, and serves
CPU tensors; on a CUDA tensor the backward launches the kernel
(``LAUNCHES["wkv6_bwd"]``) or raises, at K = V = 64 only.
"""
from __future__ import annotations

import torch

LAUNCHES = {"wkv6": 0, "wkv6_bwd": 0}
#: Key and value widths the kernel is compiled for (``csrc/wkv6.cu``).
KERNEL_DIMS = (8, 16, 32, 64)
_MAX_ROWS = 65535   # grid.y limit: one row of CTAs per bh
#: Slices the kernel cuts a column's K into (``kGroups`` in
#: ``csrc/wkv6.cu``), at most K / 4: see :func:`kernel_groups`.
GROUPS = 8
#: The backward kernel's key and value width (``kDim`` in
#: ``csrc/wkv6_bwd.cu``) and the steps between the states it saves
#: (``kChunk``): the wrapper sizes the kernel's scratch, one 64 x 64 state
#: a chunk of a row, from them.
BWD_DIM = 64
BWD_CHUNK = 16


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def wkv6_cost(bh: int, t: int, kd: int, vd: int) -> tuple[int, int]:
    """``(bytes, flops)`` the WKV function must move and do: r, k, w, v,
    u read once, y written once (f32); 5 K V flops a step (readout 2,
    decay 1, outer product 1, update 1)."""
    return 4 * (bh * t * (3 * kd + 2 * vd) + bh * kd), 5 * kd * vd * t * bh


def wkv6_bwd_cost(bh: int, t: int, kd: int, vd: int) -> tuple[int, int]:
    """``(bytes, flops)`` the WKV backward must move and do: r, k, w, v,
    u and dy read once, dr, dk, dw, dv and du written once (f32); 14
    flops an element of S a step (the state recomputed 3, its gradient
    updated 3, four products summed 8)."""
    return 4 * (bh * t * (4 * kd + 5 * vd) + 2 * bh * kd), \
        14 * kd * vd * t * bh


def _meta(r, k, w, v, u):
    """The kernel's output on the ``meta`` device, its work charged."""
    from repro_torch import kernels

    shape = _shapes(r, k, w, v, u)
    y = torch.empty_like(v, dtype=torch.float32)
    kernels.charge("wkv6", *wkv6_cost(*shape))
    return y


def _meta_bwd(r, k, w, v, u, dy):
    """The backward kernel's outputs (and its scratch of saved states,
    as :func:`_launch_bwd` allocates it) on the ``meta`` device, its
    work charged."""
    from repro_torch import kernels

    bh, t, kd, vd = _shapes(r, k, w, v, u)
    _check_bwd_shape(kd, vd)
    states = torch.empty((bh * -(-t // BWD_CHUNK) * BWD_DIM * BWD_DIM,),
                         dtype=torch.float32, device=r.device)
    dr, dk, dw = (torch.empty_like(r) for _ in range(3))
    dv, du = torch.empty_like(v), torch.empty_like(u)
    del states
    kernels.charge("wkv6_bwd", *wkv6_bwd_cost(bh, t, kd, vd))
    return dr, dk, dw, dv, du


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


# --------------------------------------------------------------------------
# Backward.
# --------------------------------------------------------------------------
def wkv6_backward_plain(r, k, w, v, u, dy):
    """Plain version of the backward: ``(dr, dk, dw, dv, du)`` in the dtype
    of the inputs, step by step. A forward walk keeps the state at the
    start of every ``BWD_CHUNK`` steps, as the kernel does; the backward
    walk recomputes a chunk's states from there and walks its steps down
    with ``G`` (module docstring). Products are written out as
    multiply-and-sum."""
    chunk = BWD_CHUNK
    bh, t, kd, vd = _shapes(r, k, w, v, u)
    if tuple(dy.shape) != (bh, t, vd):
        raise ValueError(f"wkv6 backward: dy has shape {tuple(dy.shape)}, "
                         f"expected {(bh, t, vd)}")
    dt, dev = r.dtype, r.device
    s = torch.zeros((bh, kd, vd), dtype=dt, device=dev)
    starts = []
    for i in range(t):
        if i % chunk == 0:
            starts.append(s)
        s = w[:, i, :, None] * s + k[:, i, :, None] * v[:, i, None, :]
    vdy = (v * dy).sum(-1)                                  # (BH, T)
    b = (r * (u[:, None] * k)).sum(-1)                      # (BH, T)
    dr, dk, dw = (torch.empty_like(r) for _ in range(3))
    dv = torch.empty_like(v)
    g = torch.zeros((bh, kd, vd), dtype=dt, device=dev)
    for c in reversed(range(len(starts))):
        lo, hi = c * chunk, min(t, (c + 1) * chunk)
        hist, s = [], starts[c]
        for i in range(lo, hi):
            hist.append(s)
            s = w[:, i, :, None] * s + k[:, i, :, None] * v[:, i, None, :]
        for i in reversed(range(lo, hi)):
            sp = hist[i - lo]
            bonus = vdy[:, i, None]
            dr[:, i] = (sp * dy[:, i, None, :]).sum(-1) + u * k[:, i] * bonus
            dk[:, i] = (g * v[:, i, None, :]).sum(-1) + u * r[:, i] * bonus
            dv[:, i] = (g * k[:, i, :, None]).sum(1) + b[:, i, None] * dy[:, i]
            dw[:, i] = (sp * g).sum(-1)
            g = w[:, i, :, None] * g + r[:, i, :, None] * dy[:, i, None, :]
    du = (r * k * vdy[..., None]).sum(1)
    return dr, dk, dw, dv, du


def _check_bwd_shape(kd: int, vd: int) -> None:
    if kd != BWD_DIM or vd != BWD_DIM:
        raise ValueError(f"the wkv6 backward kernel takes K = V = "
                         f"{BWD_DIM}; got K={kd}, V={vd}")


def _launch_bwd(r, k, w, v, u, dy):
    """Check every argument, then launch ``csrc/wkv6_bwd.cu``; raises on a
    shape, type, layout or device the kernel does not take, before any
    launch."""
    bh, t, kd, vd = _shapes(r, k, w, v, u)
    _check_bwd_shape(kd, vd)
    if tuple(dy.shape) != (bh, t, vd):
        raise ValueError(f"wkv6 backward: dy has shape {tuple(dy.shape)}, "
                         f"expected {(bh, t, vd)}")
    if not 1 <= bh <= _MAX_ROWS:
        raise ValueError(f"the wkv6 backward kernel takes 1 <= BH <= "
                         f"{_MAX_ROWS}; got BH={bh}")
    device = r.device
    for name, x in (("r", r), ("k", k), ("w", w), ("v", v), ("u", u),
                    ("dy", dy)):
        if x.device != device:
            raise ValueError(f"wkv6 backward: {name} is on {x.device}, r on "
                             f"{device}")
        if x.dtype != torch.float32:
            raise TypeError(f"wkv6 backward: {name} has dtype {x.dtype}, "
                            "the kernel takes float32")
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"wkv6 backward: {name} must be contiguous and "
                             "16-byte aligned")
    if device.type != "cuda":
        raise ValueError(f"the CUDA kernel takes CUDA tensors, got {device}")
    from repro_torch.kernels import build

    f32 = torch.float32
    n_chunks = -(-t // BWD_CHUNK)
    states = torch.empty((bh * n_chunks * BWD_DIM * BWD_DIM,), dtype=f32,
                         device=device)
    dr, dk, dw, dv = (torch.empty((bh, t, kd), dtype=f32, device=device)
                      for _ in range(4))
    du = torch.empty((bh, kd), dtype=f32, device=device)
    err = build.load("wkv6_bwd").wkv6_bwd_launch(
        r.data_ptr(), k.data_ptr(), w.data_ptr(), v.data_ptr(), u.data_ptr(),
        dy.data_ptr(), states.data_ptr(), dr.data_ptr(), dk.data_ptr(),
        dw.data_ptr(), dv.data_ptr(), du.data_ptr(), bh, t,
        torch.cuda.current_stream(device).cuda_stream)
    if err:
        raise RuntimeError(f"wkv6 backward launch failed: cudaError {err}")
    LAUNCHES["wkv6_bwd"] += 1
    return dr, dk, dw, dv, du


def wkv6_backward(r, k, w, v, u, dy):
    """``(dr, dk, dw, dv, du)`` f32: the CUDA kernel for tensors on a card
    (``dy`` cast to f32 and made contiguous first), the plain version for
    tensors on the CPU."""
    if r.device.type == "cpu":
        return wkv6_backward_plain(r, k, w, v, u, dy.to(r.dtype))
    if r.device.type == "meta":
        return _meta_bwd(r, k, w, v, u, dy.to(torch.float32).contiguous())
    return _launch_bwd(r, k, w, v, u, dy.to(torch.float32).contiguous())


class WKV6Fn(torch.autograd.Function):
    """``y = wkv6(r, k, w, v, u)`` with the backward kernel: the forward
    keeps its five f32 inputs for the backward."""

    @staticmethod
    def forward(ctx, r, k, w, v, u):
        ctx.save_for_backward(r, k, w, v, u)
        if r.device.type == "cpu":
            return wkv6_plain(r, k, w, v, u)
        if r.device.type == "meta":
            return _meta(r, k, w, v, u)
        return _launch(r, k, w, v, u)

    @staticmethod
    def backward(ctx, dy):
        return wkv6_backward(*ctx.saved_tensors, dy)


def wkv6(r, k, w, v, u):
    """``y (BH, T, V)`` f32 of the WKV recurrence: the CUDA kernel for
    tensors on a card (inputs cast to f32 first), the plain version for
    tensors on the CPU. Where autograd records, through :class:`WKV6Fn`
    (on a card, K = V = 64 only: refused before any launch otherwise)."""
    f32 = torch.float32
    args = [x.to(f32).contiguous() for x in (r, k, w, v, u)]
    if torch.is_grad_enabled() and any(x.requires_grad for x in args):
        if r.device.type != "cpu":
            _check_bwd_shape(r.shape[-1], v.shape[-1])
        return WKV6Fn.apply(*args)
    if r.device.type == "cpu":
        return wkv6_plain(*args)
    if r.device.type == "meta":
        return _meta(*args)
    return _launch(*args)


__all__ = ["wkv6", "wkv6_plain", "wkv6_scan", "wkv6_grouped",
           "wkv6_backward", "wkv6_backward_plain", "WKV6Fn",
           "kernel_groups", "slices", "wkv6_cost", "wkv6_bwd_cost",
           "LAUNCHES", "KERNEL_DIMS", "GROUPS",
           "BWD_DIM", "reset_launch_counts"]
