"""Wrappers of the compact-schedule spMTTKRP kernels, and their plain
PyTorch versions.

``mttkrp_fused_gather_compact`` and ``mttkrp_fused_remap_compact`` take the
argument lists of the reference's Pallas wrappers
(``repro.kernels.ops``) and return the same values. Both run the one CUDA
template in ``csrc/mttkrp_compact.cu``. On a CUDA tensor a wrapper launches
the kernel or raises; the plain version serves CPU tensors only, and is
what ``chip_smoke.py`` holds the kernel against on the card.

``LAUNCHES`` counts kernel launches per wrapper: each wrapper adds one
where it launches its kernel and nowhere else.

The plain versions multiply the factor rows in input-mode order and then
by ``val``, as the kernel does, so per-slot products agree bitwise; the
sums are taken in another order (``index_add_`` against shared-memory
atomics), so ``out_rel`` agrees to rounding. The remap outputs are copies
and agree bitwise.
"""
from __future__ import annotations

import ctypes

import torch

# Shared memory one thread block may use on an H100 (227 KB, only as
# dynamic shared memory after cudaFuncSetAttribute).
SMEM_PER_BLOCK = 232_448

LAUNCHES = {"mttkrp_fused_remap_compact": 0,
            "mttkrp_fused_gather_compact": 0}

_MAX_INPUTS = 8   # kMaxInputs in csrc/mttkrp_compact.cu


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def block_starts(bpart: torch.Tensor, kappa: int) -> torch.Tensor:
    """``(kappa+1,)`` int32 first block of every partition, from the
    nondecreasing ``bpart`` descriptor (last entry = ``nblocks``)."""
    parts = torch.arange(kappa + 1, dtype=bpart.dtype, device=bpart.device)
    return torch.searchsorted(bpart, parts, out_int32=True)


# --------------------------------------------------------------------------
# Plain PyTorch versions.
# --------------------------------------------------------------------------
def _plain_ec(val, lrow, upos, bpart, uidx, factors, *, kappa, rows_pp,
              block_p):
    """Pads (lrow < 0) add an exact 0 to row 0: masked with ``where``,
    not dropped, so no shape depends on the data (no host sync)."""
    s = val.shape[0]
    slot = torch.arange(s, device=val.device)
    base = slot - slot % block_p
    prod = None
    for w, f in enumerate(factors):
        rows = uidx[w].index_select(0, base + upos[:, w])
        g = f.index_select(0, rows)
        prod = g if prod is None else prod * g
    alive = lrow >= 0
    gid = torch.where(alive, bpart.index_select(0, slot // block_p).long()
                      * rows_pp + lrow.long(), 0)
    contrib = torch.where(alive[:, None], prod * val[:, None], 0)
    out = torch.zeros((kappa * rows_pp, factors[0].shape[1]),
                      dtype=torch.float32, device=val.device)
    return out.index_add_(0, gid, contrib)


def remap_plain(val, idx, alpha, *, smax, next_mode):
    """Alg. 3 as ``index_copy_``: each alive slot's (val, idx, alpha) to
    row ``alpha[i, next_mode]`` of a pad-pattern next layout; pads
    (destination < 0) are parked on an extra row past ``smax`` that is
    then dropped. Returns ``(nval (smax,), nidx, nalpha (smax, N))``."""
    n = idx.shape[1]
    dst = alpha[:, next_mode].long()
    dst = torch.where(dst >= 0, dst, smax)
    nval = torch.zeros(smax + 1, dtype=val.dtype, device=val.device)
    nidx = torch.zeros((smax + 1, n), dtype=idx.dtype, device=idx.device)
    nalpha = torch.full((smax + 1, n), -1, dtype=alpha.dtype,
                        device=alpha.device)
    return (nval.index_copy_(0, dst, val)[:smax],
            nidx.index_copy_(0, dst, idx)[:smax],
            nalpha.index_copy_(0, dst, alpha)[:smax])


def mttkrp_fused_gather_compact_plain(val, lrow, upos, bpart, uidx, nuniq,
                                      factors, *, kappa, rows_pp, nblocks,
                                      block_p):
    """Plain version of :func:`mttkrp_fused_gather_compact`."""
    del nuniq, nblocks  # the plain gather reads uidx at upos directly
    return _plain_ec(val, lrow, upos, bpart, uidx, tuple(factors),
                     kappa=kappa, rows_pp=rows_pp, block_p=block_p)


def mttkrp_fused_remap_compact_plain(val, idx, alpha, lrow, upos, bpart,
                                     uidx, nuniq, factors, *, kappa, rows_pp,
                                     nblocks, block_p, smax, next_mode):
    """Plain version of :func:`mttkrp_fused_remap_compact`."""
    del nuniq, nblocks
    out = _plain_ec(val, lrow, upos, bpart, uidx, tuple(factors),
                    kappa=kappa, rows_pp=rows_pp, block_p=block_p)
    return (out, *remap_plain(val, idx, alpha, smax=smax,
                              next_mode=next_mode))


# --------------------------------------------------------------------------
# CUDA launches.
# --------------------------------------------------------------------------
def _check(name, t, dtype, shape, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, kernel takes {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _launch(val, lrow, upos, bpart, uidx, nuniq, factors, *, kappa, rows_pp,
            nblocks, block_p, pstart, remap=None):
    """Validate, allocate and launch; ``remap`` is ``(idx, alpha, smax,
    next_mode)`` for the remap variant. Returns the output tensors."""
    device = val.device
    factors = tuple(factors)
    nm1 = len(factors)
    if not 1 <= nm1 <= _MAX_INPUTS:
        raise ValueError(f"{nm1} input factors; the kernel takes 1.."
                         f"{_MAX_INPUTS} (nmodes <= {_MAX_INPUTS + 1})")
    rank = factors[0].shape[1]
    s = nblocks * block_p
    smem = 4 * rank * (rows_pp + nm1 * block_p)
    if smem > SMEM_PER_BLOCK:
        raise ValueError(
            f"plan tile does not fit in shared memory: rows_pp={rows_pp}, "
            f"R={rank}, {nm1} x {block_p} stage rows need {smem} B > "
            f"{SMEM_PER_BLOCK} B; plan with a smaller rows_pp")
    if device.type != "cuda":
        raise ValueError(f"the CUDA kernel takes CUDA tensors, got {device}")
    if pstart is None:
        pstart = block_starts(bpart, kappa)
    i32 = torch.int32
    _check("val", val, torch.float32, (s,), device)
    _check("lrow", lrow, i32, (s,), device)
    _check("upos", upos, i32, (s, nm1), device)
    _check("pstart", pstart, i32, (kappa + 1,), device)
    _check("uidx", uidx, i32, (nm1, s), device)
    _check("nuniq", nuniq, i32, (nm1, nblocks), device)
    for w, f in enumerate(factors):
        _check(f"factors[{w}]", f, torch.float32, (f.shape[0], rank), device)
    out = torch.empty((kappa * rows_pp, rank), dtype=torch.float32,
                      device=device)
    if remap is None:
        rest = (None, None, 0, 0, None, None, None)
        outs = (out,)
    else:
        idx, alpha, smax, next_mode = remap
        n = idx.shape[1]
        if not (s <= smax and 0 <= next_mode < n and n == nm1 + 1):
            raise ValueError(f"remap: S={s}, smax={smax}, next_mode="
                             f"{next_mode}, nmodes={n}, inputs={nm1}")
        _check("idx", idx, i32, (s, n), device)
        _check("alpha", alpha, i32, (s, n), device)
        # The next layout starts as the pad pattern; the kernel writes the
        # alive slots (a permutation) over it.
        nval = torch.zeros(smax, dtype=torch.float32, device=device)
        nidx = torch.zeros((smax, n), dtype=i32, device=device)
        nalpha = torch.full((smax, n), -1, dtype=i32, device=device)
        rest = (idx.data_ptr(), alpha.data_ptr(), n, next_mode,
                nval.data_ptr(), nidx.data_ptr(), nalpha.data_ptr())
        outs = (out, nval, nidx, nalpha)
    from .build import load

    lib = load("mttkrp_compact")
    ptrs = (ctypes.c_void_p * nm1)(*[f.data_ptr() for f in factors])
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        err = lib.mttkrp_compact_launch(
            val.data_ptr(), lrow.data_ptr(), upos.data_ptr(),
            pstart.data_ptr(), uidx.data_ptr(), nuniq.data_ptr(),
            ctypes.cast(ptrs, ctypes.c_void_p), nm1, kappa, rows_pp,
            block_p, rank, nblocks, out.data_ptr(), *rest, stream)
    if err != 0:
        raise RuntimeError(f"mttkrp_compact launch failed: cudaError {err}")
    return outs


# --------------------------------------------------------------------------
# Wrappers (the reference's argument lists).
# --------------------------------------------------------------------------
def mttkrp_fused_gather_compact(val, lrow, upos, bpart, uidx, nuniq, factors,
                                *, kappa, rows_pp, nblocks, block_p,
                                pstart=None):
    """Compact EC with in-block row dedup; returns ``out_rel
    (kappa*rows_pp, R)``. ``pstart`` is the ``(kappa+1,)`` block-start
    table (derived from ``bpart`` when not given)."""
    if val.device.type == "cpu":
        return mttkrp_fused_gather_compact_plain(
            val, lrow, upos, bpart, uidx, nuniq, factors, kappa=kappa,
            rows_pp=rows_pp, nblocks=nblocks, block_p=block_p)
    (out,) = _launch(val, lrow, upos, bpart, uidx, nuniq, factors,
                     kappa=kappa, rows_pp=rows_pp, nblocks=nblocks,
                     block_p=block_p, pstart=pstart)
    LAUNCHES["mttkrp_fused_gather_compact"] += 1
    return out


def mttkrp_fused_remap_compact(val, idx, alpha, lrow, upos, bpart, uidx,
                               nuniq, factors, *, kappa, rows_pp, nblocks,
                               block_p, smax, next_mode, pstart=None):
    """Compact EC + Alg. 3 remap in one pass; returns ``(out_rel, nval
    (smax,), nidx (smax, N), nalpha (smax, N))``."""
    if val.device.type == "cpu":
        return mttkrp_fused_remap_compact_plain(
            val, idx, alpha, lrow, upos, bpart, uidx, nuniq, factors,
            kappa=kappa, rows_pp=rows_pp, nblocks=nblocks, block_p=block_p,
            smax=smax, next_mode=next_mode)
    outs = _launch(val, lrow, upos, bpart, uidx, nuniq, factors, kappa=kappa,
                   rows_pp=rows_pp, nblocks=nblocks, block_p=block_p,
                   pstart=pstart, remap=(idx, alpha, smax, next_mode))
    LAUNCHES["mttkrp_fused_remap_compact"] += 1
    return outs


__all__ = ["mttkrp_fused_gather_compact", "mttkrp_fused_remap_compact",
           "mttkrp_fused_gather_compact_plain",
           "mttkrp_fused_remap_compact_plain", "remap_plain", "block_starts",
           "LAUNCHES",
           "reset_launch_counts"]
