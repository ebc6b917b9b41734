"""RG-LRU linear recurrence: the wrapper of ``csrc/lru_scan.cu`` and its
plain PyTorch version.

Per channel (b, d)::

    h_t = a_t h_{t-1} + x_t,        h_{-1} = 0

``a, x (B, T, D)``, both cast to f32; returns ``h (B, T, D)`` f32: the
contract of the reference's Pallas ``lru_scan``
(``repro.kernels.ops.lru_scan``), without its ``chunk`` argument (the CUDA
kernel reads its own chunks of steps and takes any T and D).

The kernel splits the time axis into spans (:func:`split_bounds`): each
CTA scans its span of 32 channels from a zero state, folds the earlier
spans' aggregates (the product of their a, their end state) in order into
its carry, and scans its span again from that carry.
:func:`lru_scan_split_plain` is that order of operations in plain PyTorch,
for the tests.

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
(``LAUNCHES["lru_scan_bwd"]``) or raises. The backward kernel is the same
split scan with time reversed (:func:`lru_scan_backward_split_plain`).
"""
from __future__ import annotations

import torch

LAUNCHES = {"lru_scan": 0, "lru_scan_bwd": 0}
_MAX_ROWS = 65535   # the kernels' limit on B
#: Channels a CTA (``kC`` in ``csrc/lru_scan.cu``): one warp, a lane each.
CHANNELS = 32
#: Steps a stage of the kernels' shared-memory ring (``kG``) and the
#: stages it holds (``kSlots``): a span of at most ``RESIDENT`` steps stays
#: in shared memory and is read once; a longer one is read twice.
STAGE, SLOTS = 16, 8
RESIDENT = STAGE * SLOTS
#: Most spans of one channel tile: the kernel folds at most this many
#: aggregates into a carry.
MAX_SPLITS = 64
#: One span where ``B * ceil(D / CHANNELS)`` CTAs are at least ``FILL`` an
#: SM; else spans enough for ``WAVES`` CTAs an SM, each at most
#: ``RESIDENT`` steps (unless that passes ``MAX_SPLITS``).
FILL, WAVES = 1.5, 8
H100_SMS = 132
_SMS: dict[int, int] = {}


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
# The split over time.
# --------------------------------------------------------------------------
def split_span(b: int, t: int, d: int, sms: int = H100_SMS) -> int:
    """Steps of the kernels' spans at (B, T, D) on a card of ``sms`` SMs
    (the last span takes what is left); ``t`` for one span."""
    tiles = b * -(-d // CHANNELS)
    if tiles >= FILL * sms or t <= STAGE:
        return t
    span = min(-(-t // -(-WAVES * sms // tiles)), RESIDENT)
    span = max(span, -(-t // MAX_SPLITS))
    return min(t, -(-span // STAGE) * STAGE)


def span_bounds(t: int, span: int) -> list[tuple[int, int]]:
    """``[start, stop)`` of spans of ``span`` steps over ``[0, t)``."""
    return [(i, min(t, i + span)) for i in range(0, t, span)]


def split_bounds(b: int, t: int, d: int,
                 sms: int = H100_SMS) -> list[tuple[int, int]]:
    """The spans, ``[start, stop)``, that the kernels split ``[0, T)``
    into at (B, T, D) on a card of ``sms`` SMs (:func:`device_sms`)."""
    return span_bounds(t, split_span(b, t, d, sms))


def device_sms(device) -> int:
    """SMs of a CUDA ``device``."""
    idx = torch.device(device).index
    idx = torch.cuda.current_device() if idx is None else idx
    if idx not in _SMS:
        _SMS[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _SMS[idx]


def _check_bounds(t, bounds):
    if not bounds or bounds[0][0] != 0 or bounds[-1][1] != t or any(
            lo >= hi for lo, hi in bounds) or any(
            p[1] != q[0] for p, q in zip(bounds, bounds[1:])):
        raise ValueError(f"spans {bounds} do not cover [0, {t}) in order")


def _full(a, value):
    """A (B, D) state of ``value`` beside ``a``."""
    return torch.full((a.shape[0], a.shape[2]), value, dtype=a.dtype,
                      device=a.device)


def lru_scan_split_plain(a, x, bounds):
    """The forward kernel's order of operations in the inputs' dtype: each
    span's aggregate from a zero state (the product P of its a, its end
    state L), the carries folded in order (``carry = P_j carry + L_j``),
    each span scanned again from its carry. For the tests: the CPU path is
    :func:`lru_scan_plain`."""
    _check_bounds(_shapes(a, x)[1], bounds)

    def walk(lo, hi, y, out=None):
        p = _full(a, 1)
        for i in range(lo, hi):
            y = a[:, i] * y + x[:, i]
            p = p * a[:, i]
            if out is not None:
                out[:, i] = y
        return p, y

    aggs = [walk(lo, hi, _full(a, 0)) for lo, hi in bounds]
    h, carry = torch.empty_like(a), _full(a, 0)
    for (lo, hi), (p, last) in zip(bounds, aggs):
        walk(lo, hi, carry, h)
        carry = p * carry + last
    return h


def lru_scan_backward_split_plain(a, h, dh, bounds):
    """The backward kernel's order of operations: the same split with time
    reversed. A span ``[lo, hi)`` takes ``c = a_hi G_hi`` from the later
    spans and gives ``a_lo G_lo = P c + L`` to the one before (P the
    product of its a, L that value from c = 0), folded last span first."""
    _check_bounds(_shapes(a, h)[1], bounds)
    _shapes(a, dh)

    def walk(lo, hi, g, out=None):
        p, an = _full(a, 1), _full(a, 1)
        for i in reversed(range(lo, hi)):
            g = an * g + dh[:, i]
            p = p * a[:, i]
            an = a[:, i]
            if out is not None:
                out[1][:, i] = g
                out[0][:, i] = g * h[:, i - 1] if i else 0
        return p, an * g

    aggs = [walk(lo, hi, _full(a, 0)) for lo, hi in bounds]
    da, dx = torch.empty_like(a), torch.empty_like(a)
    carry = _full(a, 0)
    for (lo, hi), (p, last) in zip(reversed(bounds), reversed(aggs)):
        walk(lo, hi, carry, (da, dx))
        carry = p * carry + last
    return da, dx


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


def _split_args(b, t, d, device, span):
    """``(S, L, buf, sync, agg)`` of a launch: S spans of L steps (``span``
    steps, by default :func:`split_span` on this card) and, for several
    spans, ``buf``, one zeroed int32 buffer holding the ticket, a flag a
    CTA and (from an 8-byte boundary) room for the aggregates; ``sync`` and
    ``agg`` are its address and the aggregates' (all ``None`` for one
    span). The caller keeps ``buf`` until the launch is queued."""
    if span is None:
        span = split_span(b, t, d, device_sms(device))
    if span < 1 or -(-t // span) > MAX_SPLITS:
        raise ValueError(f"lru_scan takes 1 to {MAX_SPLITS} spans of at "
                         f"least one step; got spans of {span} for T {t}")
    n = -(-t // span)
    if n == 1:
        return 1, t, None, None, None
    ctas = n * b * -(-d // CHANNELS)
    at = 2 + ctas - ctas % 2           # agg's first word, 8-byte aligned
    buf = torch.zeros(at + 2 * CHANNELS * ctas, dtype=torch.int32,
                      device=device)
    return n, span, buf, buf.data_ptr(), buf.data_ptr() + 4 * at


def _launch(a, x, span=None):
    """Check both arguments, then launch ``csrc/lru_scan.cu`` (spans of
    ``span`` steps where given, for measurements); raises on a shape, type,
    layout or device the kernel does not take, before any launch."""
    b, t, d = _shapes(a, x)
    device = a.device
    _check(b, t, d, device, (("a", a), ("x", x)))
    from repro_torch.kernels import build

    h = torch.empty((b, t, d), dtype=torch.float32, device=device)
    n, span, _buf, sync, agg = _split_args(b, t, d, device, span)
    err = build.load("lru_scan").lru_scan_launch(
        a.data_ptr(), x.data_ptr(), h.data_ptr(), b, t, d, n, span, sync,
        agg, torch.cuda.current_stream(device).cuda_stream)
    if err:
        raise RuntimeError(f"lru_scan launch failed: cudaError {err}")
    LAUNCHES["lru_scan"] += 1
    return h


def _launch_bwd(a, h, dh, span=None):
    """Check every argument, then launch the backward kernel (spans as
    :func:`_launch`'s); raises before any launch on what it does not
    take."""
    b, t, d = _shapes(a, h)
    _shapes(a, dh)
    device = a.device
    _check(b, t, d, device, (("a", a), ("h", h), ("dh", dh)))
    from repro_torch.kernels import build

    da, dx = torch.empty_like(a), torch.empty_like(a)
    n, span, _buf, sync, agg = _split_args(b, t, d, device, span)
    err = build.load("lru_scan").lru_scan_bwd_launch(
        a.data_ptr(), h.data_ptr(), dh.data_ptr(), da.data_ptr(),
        dx.data_ptr(), b, t, d, n, span, sync, agg,
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
           "lru_scan_split_plain", "lru_scan_backward_split_plain",
           "split_bounds", "split_span", "span_bounds", "device_sms",
           "lru_scan_cost", "lru_scan_bwd_cost",
           "LAUNCHES", "reset_launch_counts"]
