"""Wrappers of the spMTTKRP kernels, and their plain PyTorch versions.

Each wrapper takes the argument list of the reference's Pallas wrapper of
the same name (``repro.kernels.ops``) and returns the same values:

  ==============================  ====================================
  wrapper                         CUDA source (``csrc/``)
  ==============================  ====================================
  ``mttkrp_fused``                ``mttkrp_pregathered.cu`` (rect)
  ``mttkrp_fused_compact``        ``mttkrp_pregathered.cu`` (compact)
  ``mttkrp_fused_gather``         ``mttkrp_gather.cu`` (rect)
  ``mttkrp_fused_remap``          ``mttkrp_gather.cu`` (rect, remap)
  ``mttkrp_fused_gather_compact`` ``mttkrp_gather.cu`` (compact, dedup)
  ``mttkrp_fused_remap_compact``  ``mttkrp_gather.cu`` (compact, dedup,
                                  remap)
  ==============================  ====================================

On a CUDA tensor a wrapper launches the kernel or raises; the plain
version (``<name>_plain``) serves CPU tensors only, and is what
``chip_smoke.py`` holds the kernel against on the card. Every wrapper
also takes ``pstart``, the ``(kappa+1,)`` block-start table the kernels
walk (derived from ``bpart``, or from ``blocks_pp`` under rect, when not
given).

``LAUNCHES`` counts kernel launches per wrapper: each wrapper adds one
where it launches its kernel and nowhere else.

The plain versions multiply the factor rows in input-mode order and then
by ``val``, as the kernels do, so per-slot products agree bitwise; the
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

LAUNCHES = {"mttkrp_fused": 0,
            "mttkrp_fused_compact": 0,
            "mttkrp_fused_gather": 0,
            "mttkrp_fused_remap": 0,
            "mttkrp_fused_remap_compact": 0,
            "mttkrp_fused_gather_compact": 0}

_MAX_INPUTS = 8   # kMaxInputs in csrc/mttkrp_gather.cu


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def block_starts(bpart: torch.Tensor, kappa: int) -> torch.Tensor:
    """``(kappa+1,)`` int32 first block of every partition, from the
    nondecreasing ``bpart`` descriptor (last entry = ``nblocks``)."""
    parts = torch.arange(kappa + 1, dtype=bpart.dtype, device=bpart.device)
    return torch.searchsorted(bpart, parts, out_int32=True)


def rect_block_starts(kappa: int, blocks_pp: int, device) -> torch.Tensor:
    """The rect schedule's block-start table: ``pstart[j] = j*blocks_pp``."""
    return torch.arange(kappa + 1, dtype=torch.int32,
                        device=device) * blocks_pp


# --------------------------------------------------------------------------
# Plain PyTorch versions.
# --------------------------------------------------------------------------
def _hadamard(parts):
    prod = parts[0]
    for p in parts[1:]:
        prod = prod * p
    return prod


def _plain_sum(prod, val, lrow, part, *, kappa, rows_pp):
    """``out_rel[part*rows_pp + lrow] += prod * val`` over the slots. Pads
    (lrow < 0) add an exact 0 to row 0: masked with ``where``, not
    dropped, so no shape depends on the data (no host sync)."""
    alive = lrow >= 0
    gid = torch.where(alive, part.long() * rows_pp + lrow.long(), 0)
    contrib = torch.where(alive[:, None], prod * val[:, None], 0)
    out = torch.zeros((kappa * rows_pp, prod.shape[1]), dtype=torch.float32,
                      device=val.device)
    return out.index_add_(0, gid, contrib)


def _slots(val):
    return torch.arange(val.shape[0], device=val.device)


def _rect_part(val, blocks_pp, block_p):
    return _slots(val) // (blocks_pp * block_p)


def _compact_part(val, bpart, block_p):
    return bpart.index_select(0, _slots(val) // block_p)


def _dedup_rows(val, upos, uidx, factors, block_p):
    """Each slot's factor rows, read through the dedup tables."""
    slot = _slots(val)
    base = slot - slot % block_p
    return [f.index_select(0, uidx[w].index_select(0, base + upos[:, w]))
            for w, f in enumerate(factors)]


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


def mttkrp_fused_plain(gathered, val, lrow, *, kappa, rows_pp, blocks_pp,
                       block_p):
    """Plain version of :func:`mttkrp_fused`."""
    prod = _hadamard([gathered[:, w] for w in range(gathered.shape[1])])
    return _plain_sum(prod, val, lrow, _rect_part(val, blocks_pp, block_p),
                      kappa=kappa, rows_pp=rows_pp)


def mttkrp_fused_compact_plain(gathered, val, lrow, bpart, *, kappa,
                               rows_pp, nblocks, block_p):
    """Plain version of :func:`mttkrp_fused_compact`."""
    del nblocks
    prod = _hadamard([gathered[:, w] for w in range(gathered.shape[1])])
    return _plain_sum(prod, val, lrow, _compact_part(val, bpart, block_p),
                      kappa=kappa, rows_pp=rows_pp)


def mttkrp_fused_gather_plain(val, lrow, lidx, factors, *, kappa, rows_pp,
                              blocks_pp, block_p):
    """Plain version of :func:`mttkrp_fused_gather`."""
    prod = _hadamard([f.index_select(0, lidx[w])
                      for w, f in enumerate(factors)])
    return _plain_sum(prod, val, lrow, _rect_part(val, blocks_pp, block_p),
                      kappa=kappa, rows_pp=rows_pp)


def mttkrp_fused_remap_plain(val, idx, alpha, lrow, lidx, factors, *, kappa,
                             rows_pp, blocks_pp, block_p, smax, next_mode):
    """Plain version of :func:`mttkrp_fused_remap`."""
    out = mttkrp_fused_gather_plain(val, lrow, lidx, factors, kappa=kappa,
                                    rows_pp=rows_pp, blocks_pp=blocks_pp,
                                    block_p=block_p)
    return (out, *remap_plain(val, idx, alpha, smax=smax,
                              next_mode=next_mode))


def mttkrp_fused_gather_compact_plain(val, lrow, upos, bpart, uidx, nuniq,
                                      factors, *, kappa, rows_pp, nblocks,
                                      block_p):
    """Plain version of :func:`mttkrp_fused_gather_compact`."""
    del nuniq, nblocks  # the plain gather reads uidx at upos directly
    prod = _hadamard(_dedup_rows(val, upos, uidx, tuple(factors), block_p))
    return _plain_sum(prod, val, lrow, _compact_part(val, bpart, block_p),
                      kappa=kappa, rows_pp=rows_pp)


def mttkrp_fused_remap_compact_plain(val, idx, alpha, lrow, upos, bpart,
                                     uidx, nuniq, factors, *, kappa, rows_pp,
                                     nblocks, block_p, smax, next_mode):
    """Plain version of :func:`mttkrp_fused_remap_compact`."""
    out = mttkrp_fused_gather_compact_plain(
        val, lrow, upos, bpart, uidx, nuniq, factors, kappa=kappa,
        rows_pp=rows_pp, nblocks=nblocks, block_p=block_p)
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


def _check_launch(device, *, rows_pp, rank, stage_rows):
    """Refuse a tile that does not fit in shared memory (accumulator plus
    ``stage_rows`` staged factor rows), then a tensor not on a card."""
    smem = 4 * rank * (rows_pp + stage_rows)
    if smem > SMEM_PER_BLOCK:
        raise ValueError(
            f"plan tile does not fit in shared memory: rows_pp={rows_pp}, "
            f"R={rank}, {stage_rows} stage rows need {smem} B > "
            f"{SMEM_PER_BLOCK} B; plan with a smaller rows_pp")
    if device.type != "cuda":
        raise ValueError(f"the CUDA kernel takes CUDA tensors, got {device}")


def _stream(device):
    return torch.cuda.current_stream(device).cuda_stream


def _launch_gather(val, lrow, rows, factors, *, kappa, rows_pp, nblocks,
                   block_p, pstart, upos=None, nuniq=None, remap=None):
    """Validate, allocate and launch ``csrc/mttkrp_gather.cu``. ``rows``
    is ``uidx`` with ``upos``/``nuniq`` given (the dedup stage), else
    ``lidx``; ``remap`` is ``(idx, alpha, smax, next_mode)`` for the remap
    variant. Returns the output tensors."""
    device = val.device
    factors = tuple(factors)
    nm1 = len(factors)
    if not 1 <= nm1 <= _MAX_INPUTS:
        raise ValueError(f"{nm1} input factors; the kernel takes 1.."
                         f"{_MAX_INPUTS} (nmodes <= {_MAX_INPUTS + 1})")
    rank = factors[0].shape[1]
    s = nblocks * block_p
    _check_launch(device, rows_pp=rows_pp, rank=rank,
                  stage_rows=nm1 * block_p)
    i32 = torch.int32
    dedup = upos is not None
    _check("val", val, torch.float32, (s,), device)
    _check("lrow", lrow, i32, (s,), device)
    _check("pstart", pstart, i32, (kappa + 1,), device)
    _check("uidx" if dedup else "lidx", rows, i32, (nm1, s), device)
    if dedup:
        _check("upos", upos, i32, (s, nm1), device)
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

    lib = load("mttkrp_gather")
    ptrs = (ctypes.c_void_p * nm1)(*[f.data_ptr() for f in factors])
    with torch.cuda.device(device):
        err = lib.mttkrp_gather_launch(
            val.data_ptr(), lrow.data_ptr(),
            upos.data_ptr() if dedup else None, pstart.data_ptr(),
            rows.data_ptr(), nuniq.data_ptr() if dedup else None,
            ctypes.cast(ptrs, ctypes.c_void_p), nm1, int(dedup), kappa,
            rows_pp, block_p, rank, nblocks, out.data_ptr(), *rest,
            _stream(device))
    if err != 0:
        raise RuntimeError(f"mttkrp_gather launch failed: cudaError {err}")
    return outs


def _launch_pregathered(gathered, val, lrow, *, kappa, rows_pp, nblocks,
                        block_p, pstart):
    """Validate, allocate and launch ``csrc/mttkrp_pregathered.cu``."""
    device = val.device
    s = nblocks * block_p
    if gathered.dim() != 3:
        raise ValueError(f"gathered has shape {tuple(gathered.shape)}, "
                         "expected (S, N-1, R)")
    nm1, rank = gathered.shape[1], gathered.shape[2]
    _check_launch(device, rows_pp=rows_pp, rank=rank, stage_rows=0)
    i32 = torch.int32
    _check("gathered", gathered, torch.float32, (s, nm1, rank), device)
    _check("val", val, torch.float32, (s,), device)
    _check("lrow", lrow, i32, (s,), device)
    _check("pstart", pstart, i32, (kappa + 1,), device)
    out = torch.empty((kappa * rows_pp, rank), dtype=torch.float32,
                      device=device)
    from .build import load

    lib = load("mttkrp_pregathered")
    with torch.cuda.device(device):
        err = lib.mttkrp_pregathered_launch(
            gathered.data_ptr(), val.data_ptr(), lrow.data_ptr(),
            pstart.data_ptr(), nm1, kappa, rows_pp, block_p, rank,
            out.data_ptr(), _stream(device))
    if err != 0:
        raise RuntimeError(
            f"mttkrp_pregathered launch failed: cudaError {err}")
    return out


# --------------------------------------------------------------------------
# Wrappers (the reference's argument lists).
# --------------------------------------------------------------------------
def mttkrp_fused(gathered, val, lrow, *, kappa, rows_pp, blocks_pp, block_p,
                 pstart=None):
    """Rect EC over a pre-gathered ``(S, N-1, R)`` operand; returns
    ``out_rel (kappa*rows_pp, R)``."""
    if val.device.type == "cpu":
        return mttkrp_fused_plain(gathered, val, lrow, kappa=kappa,
                                  rows_pp=rows_pp, blocks_pp=blocks_pp,
                                  block_p=block_p)
    if pstart is None:
        pstart = rect_block_starts(kappa, blocks_pp, val.device)
    out = _launch_pregathered(gathered, val, lrow, kappa=kappa,
                              rows_pp=rows_pp, nblocks=kappa * blocks_pp,
                              block_p=block_p, pstart=pstart)
    LAUNCHES["mttkrp_fused"] += 1
    return out


def mttkrp_fused_compact(gathered, val, lrow, bpart, *, kappa, rows_pp,
                         nblocks, block_p, pstart=None):
    """Compact EC over a pre-gathered ``(S, N-1, R)`` operand; returns
    ``out_rel (kappa*rows_pp, R)``."""
    if val.device.type == "cpu":
        return mttkrp_fused_compact_plain(gathered, val, lrow, bpart,
                                          kappa=kappa, rows_pp=rows_pp,
                                          nblocks=nblocks, block_p=block_p)
    if pstart is None:
        pstart = block_starts(bpart, kappa)
    out = _launch_pregathered(gathered, val, lrow, kappa=kappa,
                              rows_pp=rows_pp, nblocks=nblocks,
                              block_p=block_p, pstart=pstart)
    LAUNCHES["mttkrp_fused_compact"] += 1
    return out


def mttkrp_fused_gather(val, lrow, lidx, factors, *, kappa, rows_pp,
                        blocks_pp, block_p, pstart=None):
    """Rect EC with each slot's factor rows (``lidx (N-1, S)``) gathered
    in the kernel; returns ``out_rel (kappa*rows_pp, R)``."""
    if val.device.type == "cpu":
        return mttkrp_fused_gather_plain(val, lrow, lidx, factors,
                                         kappa=kappa, rows_pp=rows_pp,
                                         blocks_pp=blocks_pp,
                                         block_p=block_p)
    if pstart is None:
        pstart = rect_block_starts(kappa, blocks_pp, val.device)
    (out,) = _launch_gather(val, lrow, lidx, factors, kappa=kappa,
                            rows_pp=rows_pp, nblocks=kappa * blocks_pp,
                            block_p=block_p, pstart=pstart)
    LAUNCHES["mttkrp_fused_gather"] += 1
    return out


def mttkrp_fused_remap(val, idx, alpha, lrow, lidx, factors, *, kappa,
                       rows_pp, blocks_pp, block_p, smax, next_mode,
                       pstart=None):
    """Rect EC + Alg. 3 remap in one pass; returns ``(out_rel, nval
    (smax,), nidx (smax, N), nalpha (smax, N))``."""
    if val.device.type == "cpu":
        return mttkrp_fused_remap_plain(
            val, idx, alpha, lrow, lidx, factors, kappa=kappa,
            rows_pp=rows_pp, blocks_pp=blocks_pp, block_p=block_p,
            smax=smax, next_mode=next_mode)
    if pstart is None:
        pstart = rect_block_starts(kappa, blocks_pp, val.device)
    outs = _launch_gather(val, lrow, lidx, factors, kappa=kappa,
                          rows_pp=rows_pp, nblocks=kappa * blocks_pp,
                          block_p=block_p, pstart=pstart,
                          remap=(idx, alpha, smax, next_mode))
    LAUNCHES["mttkrp_fused_remap"] += 1
    return outs


def mttkrp_fused_gather_compact(val, lrow, upos, bpart, uidx, nuniq, factors,
                                *, kappa, rows_pp, nblocks, block_p,
                                pstart=None):
    """Compact EC with in-block row dedup; returns ``out_rel
    (kappa*rows_pp, R)``."""
    if val.device.type == "cpu":
        return mttkrp_fused_gather_compact_plain(
            val, lrow, upos, bpart, uidx, nuniq, factors, kappa=kappa,
            rows_pp=rows_pp, nblocks=nblocks, block_p=block_p)
    if pstart is None:
        pstart = block_starts(bpart, kappa)
    (out,) = _launch_gather(val, lrow, uidx, factors, kappa=kappa,
                            rows_pp=rows_pp, nblocks=nblocks,
                            block_p=block_p, pstart=pstart, upos=upos,
                            nuniq=nuniq)
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
    if pstart is None:
        pstart = block_starts(bpart, kappa)
    outs = _launch_gather(val, lrow, uidx, factors, kappa=kappa,
                          rows_pp=rows_pp, nblocks=nblocks, block_p=block_p,
                          pstart=pstart, upos=upos, nuniq=nuniq,
                          remap=(idx, alpha, smax, next_mode))
    LAUNCHES["mttkrp_fused_remap_compact"] += 1
    return outs


__all__ = ["mttkrp_fused", "mttkrp_fused_compact", "mttkrp_fused_gather",
           "mttkrp_fused_remap", "mttkrp_fused_gather_compact",
           "mttkrp_fused_remap_compact", "mttkrp_fused_plain",
           "mttkrp_fused_compact_plain", "mttkrp_fused_gather_plain",
           "mttkrp_fused_remap_plain", "mttkrp_fused_gather_compact_plain",
           "mttkrp_fused_remap_compact_plain", "remap_plain", "block_starts",
           "rect_block_starts", "LAUNCHES", "reset_launch_counts"]
