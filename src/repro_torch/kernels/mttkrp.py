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
  ``mttkrp_fused_gather_compact`` ``mttkrp_balanced.cu`` (compact,
                                  dedup, balanced)
  ``mttkrp_fused_remap_compact``  ``mttkrp_balanced.cu`` (compact,
                                  dedup, balanced, remap)
  ==============================  ====================================

On a CUDA tensor a wrapper launches the kernel or raises; the plain
version (``<name>_plain``) serves CPU tensors only, and is what
``chip_smoke.py`` holds the kernel against on the card.

Every kernel runs on a :class:`WorkTable` (``work=``): chunks of at most
``cap`` consecutive blocks of one partition, one CTA each, largest first;
a split partition's chunks write partial tiles that a second pass sums in
chunk order (``mttkrp_balanced_reduce_launch`` in
``csrc/mttkrp_balanced.cu``, shared by all three sources).
:func:`work_chunks` builds the table from the block-start table
``pstart``; under rect, :func:`rect_work` builds one that lists only
each partition's alive extent (its pad blocks are never walked). Only a
table that :func:`check_work` passed reaches a kernel: the functions
that build a table seal what they check, and the wrappers refuse any
other. Called without a table, a wrapper derives the full-range one
from ``pstart`` (derived from ``bpart``, or from ``blocks_pp`` under
rect, when not given) at :func:`default_cap`. :func:`chunked_plain`,
:func:`chunked_plain_pregathered` and :func:`chunked_plain_gather` are
the plain versions of the schedule.

``LAUNCHES`` counts kernel launches per wrapper: each wrapper adds one
where it launches its kernel and nowhere else; the second pass counts
under ``mttkrp_balanced_reduce``.

The plain versions multiply the factor rows in input-mode order and then
by ``val``, as the kernels do, so per-slot products agree bitwise; the
sums are taken in another order (``index_add_`` against shared-memory
atomics), so ``out_rel`` agrees to rounding. The remap outputs are copies
and agree bitwise.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch
from torch.utils.weak import WeakIdKeyDictionary

# Shared memory one thread block may use on an H100 (227 KB, only as
# dynamic shared memory after cudaFuncSetAttribute).
SMEM_PER_BLOCK = 232_448
H100_SMS = 132   # streaming multiprocessors of an H100 SXM

LAUNCHES = {"mttkrp_fused": 0,
            "mttkrp_fused_compact": 0,
            "mttkrp_fused_gather": 0,
            "mttkrp_fused_remap": 0,
            "mttkrp_fused_remap_compact": 0,
            "mttkrp_fused_gather_compact": 0,
            "mttkrp_balanced_reduce": 0}

_MAX_INPUTS = 8   # kMaxInputs in csrc/chunk_walk.cuh


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


def _a4(x: int) -> int:
    return (x + 3) // 4 * 4


def balanced_smem_bytes(rows_pp: int, rank: int, nm1: int, block_p: int,
                        nmodes: int) -> int:
    """Shared memory one CTA of ``csrc/mttkrp_balanced.cu`` takes: two
    buffers of a block's metadata (lrow, val, upos, uidx, nuniq, and
    idx/alpha when ``nmodes`` > 0, i.e. with the remap), one stage of
    ``nm1 x block_p x rank`` factor-row floats, and the ``rows_pp x rank``
    accumulator; 4-byte words, each piece rounded up to 16 bytes. The
    kernel's own ``smem_bytes`` refuses a launch whose count differs."""
    meta = (2 * _a4(block_p) + _a4(block_p * nm1) + nm1 * _a4(block_p)
            + _a4(nm1) + (2 * _a4(block_p * nmodes) if nmodes else 0))
    return 4 * (2 * meta + _a4(nm1 * block_p * rank) + rows_pp * rank)


def gather_smem_bytes(rows_pp: int, rank: int, nm1: int, block_p: int,
                      nmodes: int) -> int:
    """Shared memory one CTA of ``csrc/mttkrp_gather.cu`` takes: two
    buffers of a block's metadata (lrow, val, the ``nm1`` lidx rows, and
    idx/alpha when ``nmodes`` > 0), one ``nm1 x block_p x rank`` stage and
    the accumulator, as :func:`balanced_smem_bytes` counts them (and never
    more than it)."""
    meta = ((2 + nm1) * _a4(block_p)
            + (2 * _a4(block_p * nmodes) if nmodes else 0))
    return 4 * (2 * meta + _a4(nm1 * block_p * rank) + rows_pp * rank)


def pregathered_smem_bytes(rows_pp: int, rank: int, nm1: int,
                           block_p: int) -> int:
    """Shared memory one CTA of ``csrc/mttkrp_pregathered.cu`` takes: two
    buffers of a block's lrow and val, one stage of the block's
    ``block_p x nm1 x rank`` operand floats and the accumulator, as
    :func:`balanced_smem_bytes` counts them (and never more than it)."""
    return 4 * (4 * _a4(block_p) + _a4(nm1 * block_p * rank)
                + rows_pp * rank)


# --------------------------------------------------------------------------
# The work table.
# --------------------------------------------------------------------------
class WorkTable(NamedTuple):
    """What the kernels' CTAs do, as two int32 tables:

      chunks  (nchunks, 4)     partition, first block, end block (exclusive),
                               partial index (-1: the chunk is its whole
                               partition and writes ``out_rel`` itself)
      wsum    (n_partials, 2)  for the first partial of each split
                               partition (partition, its partial count);
                               (-1, 0) for the others. A split partition's
                               partials are consecutive, in chunk order.

    CTA ``i`` of the main kernel takes ``chunks[i]``; the second pass sums
    each split partition's partials in that order. Build one with
    :func:`work_chunks`, :func:`rect_work` or :func:`work_from_chunks`,
    which check it (:func:`check_work`) and seal it: the wrappers read the
    table only on the card, so they refuse a table that was not sealed
    for their plan, or that changed in place since (a table that leaves a
    partition out would leave its rows of ``out_rel`` unwritten). A copy
    made by :meth:`to` keeps the seal.
    """

    chunks: torch.Tensor
    wsum: torch.Tensor

    @property
    def n_partials(self) -> int:
        return int(self.wsum.shape[0])

    def to(self, device) -> "WorkTable":
        out = WorkTable(self.chunks.to(device), self.wsum.to(device))
        plan = checked_for(self)
        if plan is not None:
            _seal(out, *plan)
        return out


# chunks tensor -> (wsum tensor, kappa, nblocks, their version counters)
# for every table that check_work passed, and its copies.
_CHECKED = WeakIdKeyDictionary()


def _versions(work):
    return tuple(-1 if t.is_inference() else t._version for t in work)


def _seal(work: WorkTable, kappa: int, nblocks: int) -> None:
    _CHECKED[work.chunks] = (work.wsum, kappa, nblocks, _versions(work))


def checked_for(work: WorkTable):
    """``(kappa, nblocks)`` of the plan that :func:`check_work` passed
    ``work`` for, or ``None`` if it never did (a table built by hand) or
    a tensor of it changed in place since."""
    seal = _CHECKED.get(work.chunks)
    if seal is None or seal[0] is not work.wsum or \
            seal[3] != _versions(work):
        return None
    return seal[1], seal[2]


def default_cap(nblocks: int, sms: int = H100_SMS) -> int:
    """Blocks a chunk may hold: about half of one SM's fair share,
    ``ceil(nblocks / (2 sms))``, so that no CTA's walk outlasts the rest of
    the grid by much."""
    return max(1, -(-int(nblocks) // (2 * sms)))


def split_ranges(begin, end, cap: int) -> np.ndarray:
    """``(nchunks, 3)`` int64 rows (partition, first block, end block):
    partition ``j``'s blocks ``[begin[j], end[j])`` cut into
    ``ceil(blocks / cap)`` consecutive chunks of near-equal size (the
    larger first), an empty range kept as one empty chunk at
    ``begin[j]``, in partition order."""
    if cap < 1:
        raise ValueError(f"cap must be positive, got {cap}")
    b = np.asarray(begin, dtype=np.int64)
    nb = np.asarray(end, dtype=np.int64) - b
    if (nb < 0).any():
        raise ValueError("every range must end at or after its begin")
    k = np.maximum(1, -(-nb // cap))
    part = np.repeat(np.arange(nb.size), k)
    j = np.arange(int(k.sum())) - np.repeat(np.cumsum(k) - k, k)
    q, r = (np.repeat(x, k) for x in np.divmod(nb, k))
    b0 = b[part] + j * q + np.minimum(j, r)
    return np.stack([part, b0, b0 + q + (j < r)], axis=1)


def split_partitions(pstart, cap: int) -> np.ndarray:
    """:func:`split_ranges` over each partition's whole run of blocks
    ``[pstart[j], pstart[j+1])``."""
    ps = np.asarray(pstart, dtype=np.int64)
    if (np.diff(ps) < 0).any():
        raise ValueError("pstart must be nondecreasing")
    return split_ranges(ps[:-1], ps[1:], cap)


def _partials(part):
    """For chunk rows sorted by partition: each row's partial index (-1 for
    a partition listed once, else dense and consecutive in row order), and
    the ``wsum`` rows those indices imply."""
    first = np.r_[True, part[1:] != part[:-1]]
    grp = np.cumsum(first) - 1
    count = np.bincount(grp)[grp]
    split = count > 1
    partial = np.where(split, np.cumsum(split) - 1, -1)
    wsum = np.tile(np.array([-1, 0], dtype=np.int64), (int(split.sum()), 1))
    heads = split & first
    wsum[partial[heads]] = np.stack([part[heads], count[heads]], axis=1)
    return partial, wsum


def check_work(work: WorkTable, pstart) -> None:
    """Raise ``ValueError`` unless ``work`` (host tensors) is a table the
    kernels can run for the block-start table ``pstart``: every chunk
    names a partition in ``[0, kappa)`` and blocks ``b_begin <= b_end``
    inside that partition's ``[pstart[j], pstart[j+1]]``; every partition
    has a chunk (else its rows of ``out_rel`` stay unwritten); a partition
    with one chunk takes partial -1 and the chunks of one with more take
    consecutive partial indices in block order, numbered densely from 0;
    and ``wsum`` is what those indices imply. A block that no chunk
    lists, or that two do, passes: the table is the kernels' input, and a
    check against the plain version catches it (under rect,
    :func:`rect_work` also checks that no alive slot is left out)."""
    ps = np.asarray(pstart, dtype=np.int64)
    c = np.asarray(work.chunks, dtype=np.int64)
    w = np.asarray(work.wsum, dtype=np.int64)
    kappa = ps.size - 1
    if c.ndim != 2 or c.shape[1] != 4 or not len(c):
        raise ValueError(f"work.chunks has shape {c.shape}, expected "
                         "(nchunks >= 1, 4)")
    if w.ndim != 2 or w.shape[1] != 2:
        raise ValueError(f"work.wsum has shape {w.shape}, expected "
                         "(n_partials, 2)")
    part, b0, b1, pq = c.T
    bad = np.flatnonzero((part < 0) | (part >= kappa))
    if bad.size:
        raise ValueError(f"chunk {bad[0]} names partition {part[bad[0]]}, "
                         f"outside [0, {kappa})")
    bad = np.flatnonzero((b0 < ps[part]) | (b1 < b0) | (b1 > ps[part + 1]))
    if bad.size:
        i = bad[0]
        raise ValueError(f"chunk {i} holds blocks [{b0[i]}, {b1[i]}), "
                         f"outside partition {part[i]}'s "
                         f"[{ps[part[i]]}, {ps[part[i] + 1]})")
    missing = np.flatnonzero(np.bincount(part, minlength=kappa) == 0)
    if missing.size:
        raise ValueError(f"partition {missing[0]} has no chunk: its rows of "
                         "out_rel would not be written")
    order = np.lexsort((pq, b0, part))
    partial, wsum = _partials(part[order])
    if not np.array_equal(pq[order], partial):
        raise ValueError("partial indices must be -1 for a partition of "
                         "one chunk, and number a split partition's chunks "
                         "consecutively in block order, densely from 0")
    if not np.array_equal(w, wsum):
        raise ValueError("work.wsum disagrees with the chunks' partial "
                         "indices")


def work_from_chunks(chunks, pstart) -> WorkTable:
    """The :class:`WorkTable` of a list of ``(partition, first block, end
    block)`` chunks, checked against the block-start table ``pstart``
    (:func:`check_work`) and sealed for its plan (``kappa``, ``nblocks =
    pstart[-1]``). A partition listed more than once is split: its chunks
    (in block order) get consecutive partial indices. The rows are then
    sorted largest chunk first (stable). Takes any list whose chunks lie
    inside their partitions, so a test can drop or repeat a chunk of a
    split partition and see the result change."""
    c = np.asarray(chunks, dtype=np.int64).reshape(-1, 3)
    if not len(c):
        raise ValueError("a work table needs at least one chunk")
    c = c[np.lexsort((c[:, 1], c[:, 0]))]          # partition, block order
    partial, wsum = _partials(c[:, 0])
    table = np.concatenate([c, partial[:, None]], axis=1)
    table = table[np.argsort(c[:, 1] - c[:, 2], kind="stable")]
    work = WorkTable(torch.from_numpy(table.astype(np.int32)),
                     torch.from_numpy(wsum.astype(np.int32)))
    check_work(work, pstart)
    ps = np.asarray(pstart, dtype=np.int64)
    _seal(work, ps.size - 1, int(ps[-1]))
    return work


def work_chunks(pstart, cap: int) -> WorkTable:
    """The work table for the block-start table ``pstart`` (numpy or CPU
    torch), each partition's whole run of blocks in chunks of at most
    ``cap`` (see :class:`WorkTable`, :func:`default_cap`)."""
    if torch.is_tensor(pstart):
        pstart = pstart.numpy()
    return work_from_chunks(split_partitions(pstart, cap), pstart)


def rect_cap(part_nnz, block_p: int) -> int:
    """:func:`default_cap` of a rect plan's alive blocks (of all ``kappa *
    blocks_pp`` blocks the cap would be ``blocks_pp``, and nothing would
    split)."""
    nnz = np.asarray(part_nnz, dtype=np.int64)
    return default_cap(int((-(-nnz // block_p)).sum()))


def rect_work(part_nnz, blocks_pp: int, block_p: int, slots,
              cap: int | None = None) -> WorkTable:
    """The work table of a rect plan: each partition's chunks cover only
    its alive extent, ``ceil(part_nnz[j] / block_p)`` blocks from its
    first block ``j * blocks_pp`` (a rect plan lays a partition's alive
    slots first), a partition with no nonzeros one empty chunk (its tile
    is still written), in chunks of at most ``cap`` blocks (default
    :func:`rect_cap`). The alive-first order is the plan's invariant,
    not a layout's, so the table is also checked against the plan's alive
    slots ``slots`` (``ModePlan.slot_of_elem``): every one must lie in a
    listed block (:func:`check_covers`)."""
    nnz = np.asarray(part_nnz, dtype=np.int64)
    kappa = nnz.size
    alive = -(-nnz // block_p)
    if (alive > blocks_pp).any():
        raise ValueError(f"a partition of {int(nnz.max())} nonzeros does not "
                         f"fit {blocks_pp} blocks of {block_p}")
    begin = np.arange(kappa, dtype=np.int64) * blocks_pp
    if cap is None:
        cap = rect_cap(nnz, block_p)
    work = work_from_chunks(split_ranges(begin, begin + alive, cap),
                            np.append(begin, kappa * blocks_pp))
    check_covers(work, slots, block_p)
    return work


def check_covers(work: WorkTable, slots, block_p: int) -> None:
    """Raise ``ValueError`` unless every slot of ``slots`` lies in a block
    that a chunk of ``work`` (host tensors) lists."""
    c = np.asarray(work.chunks, dtype=np.int64)
    blk = np.asarray(slots, dtype=np.int64) // block_p
    n = max(int(c[:, 2].max()), int(blk.max(initial=-1)) + 1) + 1
    listed = np.cumsum(np.bincount(c[:, 1], minlength=n)
                       - np.bincount(c[:, 2], minlength=n)) > 0
    bad = np.flatnonzero(~listed[blk])
    if bad.size:
        i = bad[0]
        raise ValueError(f"alive slot {int(np.asarray(slots)[i])} lies in "
                         f"block {blk[i]}, which no chunk lists")


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


def _dedup_rows_at(slot, upos, uidx, factors, block_p):
    """The factor rows of the slots ``slot``, read through the dedup
    tables."""
    base = slot - slot % block_p
    up = upos.index_select(0, slot)
    return [f.index_select(0, uidx[w].index_select(0, base + up[:, w]))
            for w, f in enumerate(factors)]


def _gathered_at(slot, gathered):
    g = gathered.index_select(0, slot)
    return [g[:, w] for w in range(g.shape[1])]


def _lidx_rows_at(slot, lidx, factors):
    return [f.index_select(0, lidx[w].index_select(0, slot))
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
    prod = _hadamard(_gathered_at(_slots(val), gathered))
    return _plain_sum(prod, val, lrow, _rect_part(val, blocks_pp, block_p),
                      kappa=kappa, rows_pp=rows_pp)


def mttkrp_fused_compact_plain(gathered, val, lrow, bpart, *, kappa,
                               rows_pp, nblocks, block_p):
    """Plain version of :func:`mttkrp_fused_compact`."""
    del nblocks
    prod = _hadamard(_gathered_at(_slots(val), gathered))
    return _plain_sum(prod, val, lrow, _compact_part(val, bpart, block_p),
                      kappa=kappa, rows_pp=rows_pp)


def mttkrp_fused_gather_plain(val, lrow, lidx, factors, *, kappa, rows_pp,
                              blocks_pp, block_p):
    """Plain version of :func:`mttkrp_fused_gather`."""
    prod = _hadamard(_lidx_rows_at(_slots(val), lidx, factors))
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
    prod = _hadamard(_dedup_rows_at(_slots(val), upos, uidx, tuple(factors),
                                    block_p))
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


def _chunked(rows_at, val, lrow, *, kappa, rows_pp, block_p, work, remap):
    """The schedule's plain sum: each chunk of ``work`` sums the plain
    products of its blocks' slots (``rows_at(slots)``: their factor rows)
    into its own ``rows_pp x R`` tile; a whole-partition chunk's tile is
    its rows of ``out_rel``, and a split partition's rows are the sum of
    its chunks' tiles in chunk order. With ``remap = (idx, alpha, smax,
    next_mode)`` the chunks' slots are also remapped
    (:func:`remap_plain`)."""
    dev = val.device
    ch = work.chunks.to("cpu").long()
    wsum = work.wsum.to("cpu").tolist()
    part, b0, b1, pq = ch.unbind(1)
    lens = (b1 - b0) * block_p
    cid = torch.repeat_interleave(torch.arange(len(ch)), lens)
    start = torch.repeat_interleave(b0 * block_p - (torch.cumsum(lens, 0)
                                                    - lens), lens)
    slot = (torch.arange(int(lens.sum())) + start).to(dev)
    cid = cid.to(dev)
    prod = _hadamard(rows_at(slot))
    lr = lrow.index_select(0, slot)
    alive = lr >= 0
    gid = torch.where(alive, cid * rows_pp + lr.long(), 0)
    contrib = torch.where(alive[:, None],
                          prod * val.index_select(0, slot)[:, None], 0)
    rank = prod.shape[1]
    tiles = torch.zeros((len(ch) * rows_pp, rank), dtype=torch.float32,
                        device=dev).index_add_(0, gid, contrib)
    tiles = tiles.view(len(ch), rows_pp, rank)
    out = torch.zeros((kappa, rows_pp, rank), dtype=torch.float32,
                      device=dev)
    whole = (pq < 0).to(dev)
    out[part.to(dev)[whole]] = tiles[whole]
    partials = torch.zeros((work.n_partials, rows_pp, rank),
                           dtype=torch.float32, device=dev)
    partials[pq.to(dev)[~whole]] = tiles[~whole]
    for q, (p, count) in enumerate(wsum):
        if count > 0:
            acc = partials[q].clone()
            for k in range(1, count):
                acc += partials[q + k]
            out[p] = acc
    out = out.view(kappa * rows_pp, rank)
    if remap is None:
        return out
    idx, alpha, smax, next_mode = remap
    return (out, *remap_plain(val.index_select(0, slot),
                              idx.index_select(0, slot),
                              alpha.index_select(0, slot), smax=smax,
                              next_mode=next_mode))


def chunked_plain(val, lrow, upos, bpart, uidx, nuniq, factors, *, kappa,
                  rows_pp, nblocks, block_p, work, remap=None):
    """Plain version of the balanced kernels' schedule (the dedup
    operand): :func:`_chunked`. With ``remap`` the result is ``(out_rel,
    nval, nidx, nalpha)``. A block no chunk lists adds nothing; a block
    listed twice adds twice. For tests and ``chip_smoke.py`` (it reads the
    table on the host), not the main path."""
    del bpart, nuniq, nblocks
    factors = tuple(factors)
    return _chunked(lambda s: _dedup_rows_at(s, upos, uidx, factors, block_p),
                    val, lrow, kappa=kappa, rows_pp=rows_pp, block_p=block_p,
                    work=work, remap=remap)


def chunked_plain_pregathered(gathered, val, lrow, *, kappa, rows_pp,
                              block_p, work):
    """:func:`chunked_plain` over a pre-gathered ``(S, N-1, R)`` operand:
    the schedule of :func:`mttkrp_fused` and :func:`mttkrp_fused_compact`
    (``csrc/mttkrp_pregathered.cu``)."""
    return _chunked(lambda s: _gathered_at(s, gathered), val, lrow,
                    kappa=kappa, rows_pp=rows_pp, block_p=block_p, work=work,
                    remap=None)


def chunked_plain_gather(val, lrow, lidx, factors, *, kappa, rows_pp,
                         block_p, work, remap=None):
    """:func:`chunked_plain` with each slot's rows read through ``lidx
    (N-1, S)``: the schedule of :func:`mttkrp_fused_gather` and, with
    ``remap``, :func:`mttkrp_fused_remap` (``csrc/mttkrp_gather.cu``)."""
    factors = tuple(factors)
    return _chunked(lambda s: _lidx_rows_at(s, lidx, factors), val, lrow,
                    kappa=kappa, rows_pp=rows_pp, block_p=block_p, work=work,
                    remap=remap)


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


def _check_smem(*, rows_pp, rank, smem, what):
    """Refuse a tile that does not fit in shared memory."""
    if smem > SMEM_PER_BLOCK:
        raise ValueError(
            f"plan tile does not fit in shared memory: rows_pp={rows_pp}, "
            f"R={rank}, {what} need {smem} B > {SMEM_PER_BLOCK} B; plan "
            "with a smaller rows_pp")


def _check_cuda(device):
    if device.type != "cuda":
        raise ValueError(f"the CUDA kernel takes CUDA tensors, got {device}")


def _stream(device):
    return torch.cuda.current_stream(device).cuda_stream


def _remap_outputs(s, remap, nm1, device):
    """Check the remap arguments; return them with the next layout filled
    with the pad pattern (the kernel writes the alive slots, a
    permutation, over it)."""
    idx, alpha, smax, next_mode = remap
    n = idx.shape[1]
    if not (s <= smax and 0 <= next_mode < n and n == nm1 + 1):
        raise ValueError(f"remap: S={s}, smax={smax}, next_mode="
                         f"{next_mode}, nmodes={n}, inputs={nm1}")
    i32 = torch.int32
    _check("idx", idx, i32, (s, n), device)
    _check("alpha", alpha, i32, (s, n), device)
    nval = torch.zeros(smax, dtype=torch.float32, device=device)
    nidx = torch.zeros((smax, n), dtype=i32, device=device)
    nalpha = torch.full((smax, n), -1, dtype=i32, device=device)
    return idx, alpha, n, next_mode, nval, nidx, nalpha


def _inputs(factors):
    factors = tuple(factors)
    nm1 = len(factors)
    if not 1 <= nm1 <= _MAX_INPUTS:
        raise ValueError(f"{nm1} input factors; the kernel takes 1.."
                         f"{_MAX_INPUTS} (nmodes <= {_MAX_INPUTS + 1})")
    return factors, nm1, factors[0].shape[1]


def _check_work(work, kappa, nblocks, device):
    """What the wrapper can check of a table on the card without reading it
    back (a sync): its kind, dtypes, shapes, device, one chunk at least for
    every partition, and that :func:`check_work` passed it for this plan
    (``kappa``, ``nblocks``) and it did not change since
    (:func:`checked_for`)."""
    if not isinstance(work, WorkTable):
        raise TypeError(f"work is a {type(work).__name__}, expected a "
                        "WorkTable (work_chunks)")
    nchunks = work.chunks.shape[0] if work.chunks.dim() == 2 else -1
    _check("work.chunks", work.chunks, torch.int32, (max(nchunks, 0), 4),
           device)
    _check("work.wsum", work.wsum, torch.int32, (work.n_partials, 2),
           device)
    if nchunks < kappa:
        raise ValueError(f"work lists {nchunks} chunks for {kappa} "
                         "partitions; every partition needs one")
    plan = checked_for(work)
    if plan != (kappa, nblocks):
        raise ValueError(
            "work was not built by work_chunks, rect_work or "
            f"work_from_chunks for this plan (kappa {kappa}, nblocks "
            f"{nblocks}; sealed for {plan}), or changed since: only a "
            "table that check_work passed reaches a kernel")


def _table(work, *, kappa, nblocks, device, pstart=None, bpart=None):
    """``work`` as given (checked beforehand), or the full-range table
    derived from ``pstart`` (or ``bpart``) at :func:`default_cap`, with
    one device-to-host copy."""
    if work is not None:
        return work
    if pstart is None:
        pstart = block_starts(bpart, kappa)
    return work_chunks(pstart.cpu(), default_cap(nblocks)).to(device)


def _passes(name, ptrs, *, work, nm1, kappa, rows_pp, block_p, rank,
            nblocks, vec, smem, device, remap=None, remap_args=True):
    """Allocate ``out_rel`` (and the partials of split partitions) for
    ``csrc/<name>.cu`` and return ``(outs, main, second)``: the output
    tensors and the two passes as callables that launch on the current
    stream, raising on a non-zero ``cudaError``; ``second`` (the chunk-order
    sum of ``csrc/mttkrp_balanced.cu``) is ``None`` when no partition is
    split. ``ptrs`` are the launch's leading pointer arguments; ``remap``
    the checked remap outputs (:func:`_remap_outputs`); ``remap_args``
    says whether the launch takes the remap arguments at all."""
    from .build import load

    out = torch.empty((kappa * rows_pp, rank), dtype=torch.float32,
                      device=device)
    npart = work.n_partials
    partials = (torch.empty((npart, rows_pp, rank), dtype=torch.float32,
                            device=device) if npart else None)
    outs = (out,)
    rest = ()
    if remap is not None:
        idx, alpha, n, next_mode, nval, nidx, nalpha = remap
        rest = (idx.data_ptr(), alpha.data_ptr(), n, next_mode,
                nval.data_ptr(), nidx.data_ptr(), nalpha.data_ptr())
        outs = (out, nval, nidx, nalpha)
    elif remap_args:
        rest = (None, None, 0, 0, None, None, None)
    lib = load(name)
    launch = getattr(lib, f"{name}_launch")

    def main():
        with torch.cuda.device(device):
            err = launch(*ptrs, nm1, work.chunks.shape[0], kappa, rows_pp,
                         block_p, rank, nblocks, npart, int(vec), smem,
                         out.data_ptr(),
                         partials.data_ptr() if npart else None, *rest,
                         _stream(device))
        if err != 0:
            raise RuntimeError(f"{name} launch failed: cudaError {err}")

    if not npart:
        return outs, main, None
    reduce = load("mttkrp_balanced").mttkrp_balanced_reduce_launch

    def second():
        with torch.cuda.device(device):
            err = reduce(partials.data_ptr(), work.wsum.data_ptr(), npart,
                         kappa, rows_pp, rank, out.data_ptr(),
                         _stream(device))
        if err != 0:
            raise RuntimeError("second pass launch failed: cudaError "
                               f"{err}")

    return outs, main, second


def _factor_ptrs(factors):
    ptrs = (ctypes.c_void_p * len(factors))(*[f.data_ptr() for f in factors])
    return ctypes.cast(ptrs, ctypes.c_void_p)   # keeps ``ptrs`` alive


def _vec(rank, factors):
    return rank % 4 == 0 and all(f.data_ptr() % 16 == 0 for f in factors)


def balanced_passes(val, lrow, upos, bpart, uidx, nuniq, factors, *, kappa,
                    rows_pp, nblocks, block_p, pstart=None, work=None,
                    remap=None):
    """Validate and allocate for ``csrc/mttkrp_balanced.cu``; returns
    ``(outs, main, second)`` as :func:`_passes` does. The main kernel
    fills ``out_rel`` (and the next layout) except a split partition's
    rows, which the second pass writes. Without ``work`` the table is
    derived from ``pstart`` (or ``bpart``) with one device-to-host copy.
    The wrappers run both passes; ``chip_smoke.py`` times them apart."""
    device = val.device
    factors, nm1, rank = _inputs(factors)
    s = nblocks * block_p
    nmodes = remap[0].shape[1] if remap is not None else 0
    smem = balanced_smem_bytes(rows_pp, rank, nm1, block_p, nmodes)
    _check_smem(rows_pp=rows_pp, rank=rank, smem=smem,
                what=f"the balanced kernel's buffers (P={block_p}, "
                     f"{nm1} inputs)")
    i32 = torch.int32
    _check("val", val, torch.float32, (s,), device)
    _check("lrow", lrow, i32, (s,), device)
    _check("upos", upos, i32, (s, nm1), device)
    _check("uidx", uidx, i32, (nm1, s), device)
    _check("nuniq", nuniq, i32, (nm1, nblocks), device)
    for w, f in enumerate(factors):
        _check(f"factors[{w}]", f, torch.float32, (f.shape[0], rank), device)
    if pstart is not None:
        _check("pstart", pstart, i32, (kappa + 1,), device)
    if work is not None:
        _check_work(work, kappa, nblocks, device)
    remap = remap and _remap_outputs(s, remap, nm1, device)
    _check_cuda(device)
    work = _table(work, kappa=kappa, nblocks=nblocks, device=device,
                  pstart=pstart, bpart=bpart)
    ptrs = (val.data_ptr(), lrow.data_ptr(), upos.data_ptr(),
            uidx.data_ptr(), nuniq.data_ptr(), work.chunks.data_ptr(),
            _factor_ptrs(factors))
    return _passes("mttkrp_balanced", ptrs, work=work, nm1=nm1, kappa=kappa,
                   rows_pp=rows_pp, block_p=block_p, rank=rank,
                   nblocks=nblocks, vec=_vec(rank, factors), smem=smem,
                   device=device, remap=remap)


def gather_passes(val, lrow, lidx, factors, *, kappa, rows_pp, nblocks,
                  block_p, pstart=None, work=None, remap=None):
    """Validate and allocate for ``csrc/mttkrp_gather.cu`` (rect, each
    slot's rows read through ``lidx``); ``(outs, main, second)`` as
    :func:`balanced_passes`, the table derived from ``pstart`` when not
    given."""
    device = val.device
    factors, nm1, rank = _inputs(factors)
    s = nblocks * block_p
    nmodes = remap[0].shape[1] if remap is not None else 0
    smem = gather_smem_bytes(rows_pp, rank, nm1, block_p, nmodes)
    _check_smem(rows_pp=rows_pp, rank=rank, smem=smem,
                what=f"the gather kernel's buffers (P={block_p}, {nm1} "
                     "inputs)")
    i32 = torch.int32
    _check("val", val, torch.float32, (s,), device)
    _check("lrow", lrow, i32, (s,), device)
    _check("lidx", lidx, i32, (nm1, s), device)
    for w, f in enumerate(factors):
        _check(f"factors[{w}]", f, torch.float32, (f.shape[0], rank), device)
    if pstart is not None:
        _check("pstart", pstart, i32, (kappa + 1,), device)
    if work is not None:
        _check_work(work, kappa, nblocks, device)
    remap = remap and _remap_outputs(s, remap, nm1, device)
    _check_cuda(device)
    work = _table(work, kappa=kappa, nblocks=nblocks, device=device,
                  pstart=pstart)
    ptrs = (val.data_ptr(), lrow.data_ptr(), lidx.data_ptr(),
            work.chunks.data_ptr(), _factor_ptrs(factors))
    return _passes("mttkrp_gather", ptrs, work=work, nm1=nm1, kappa=kappa,
                   rows_pp=rows_pp, block_p=block_p, rank=rank,
                   nblocks=nblocks, vec=_vec(rank, factors), smem=smem,
                   device=device, remap=remap)


def pregathered_passes(gathered, val, lrow, *, kappa, rows_pp, nblocks,
                       block_p, pstart=None, bpart=None, work=None):
    """Validate and allocate for ``csrc/mttkrp_pregathered.cu`` (either
    schedule: the table says which partition owns a block); ``(outs,
    main, second)`` as :func:`balanced_passes`, the table derived from
    ``pstart`` (or ``bpart``) when not given."""
    device = val.device
    s = nblocks * block_p
    if gathered.dim() != 3:
        raise ValueError(f"gathered has shape {tuple(gathered.shape)}, "
                         "expected (S, N-1, R)")
    nm1, rank = gathered.shape[1], gathered.shape[2]
    smem = pregathered_smem_bytes(rows_pp, rank, nm1, block_p)
    _check_smem(rows_pp=rows_pp, rank=rank, smem=smem,
                what=f"the pre-gathered kernel's buffers (P={block_p}, "
                     f"{nm1} inputs)")
    i32 = torch.int32
    _check("gathered", gathered, torch.float32, (s, nm1, rank), device)
    _check("val", val, torch.float32, (s,), device)
    _check("lrow", lrow, i32, (s,), device)
    if pstart is not None:
        _check("pstart", pstart, i32, (kappa + 1,), device)
    if work is not None:
        _check_work(work, kappa, nblocks, device)
    _check_cuda(device)
    work = _table(work, kappa=kappa, nblocks=nblocks, device=device,
                  pstart=pstart, bpart=bpart)
    vec = nm1 * rank % 4 == 0 and gathered.data_ptr() % 16 == 0
    ptrs = (gathered.data_ptr(), val.data_ptr(), lrow.data_ptr(),
            work.chunks.data_ptr())
    return _passes("mttkrp_pregathered", ptrs, work=work, nm1=nm1,
                   kappa=kappa, rows_pp=rows_pp, block_p=block_p, rank=rank,
                   nblocks=nblocks, vec=vec, smem=smem, device=device,
                   remap_args=False)


def _run(outs, main, second):
    """Both passes; the second counts under ``mttkrp_balanced_reduce``.
    Returns the output tensors."""
    main()
    if second is not None:
        second()
        LAUNCHES["mttkrp_balanced_reduce"] += 1
    return outs


# --------------------------------------------------------------------------
# Wrappers (the reference's argument lists, plus ``pstart`` and ``work``).
# --------------------------------------------------------------------------
def mttkrp_fused(gathered, val, lrow, *, kappa, rows_pp, blocks_pp, block_p,
                 pstart=None, work=None):
    """Rect EC over a pre-gathered ``(S, N-1, R)`` operand; returns
    ``out_rel (kappa*rows_pp, R)``. On the card it runs on ``work`` (a
    :class:`WorkTable` on the same device, :func:`rect_work` for a rect
    plan); called without one, it derives the full-range table from
    ``pstart`` (``j * blocks_pp`` when not given), with one sync."""
    if val.device.type == "cpu":
        return mttkrp_fused_plain(gathered, val, lrow, kappa=kappa,
                                  rows_pp=rows_pp, blocks_pp=blocks_pp,
                                  block_p=block_p)
    if pstart is None and work is None:
        pstart = rect_block_starts(kappa, blocks_pp, val.device)
    (out,) = _run(*pregathered_passes(
        gathered, val, lrow, kappa=kappa, rows_pp=rows_pp,
        nblocks=kappa * blocks_pp, block_p=block_p, pstart=pstart,
        work=work))
    LAUNCHES["mttkrp_fused"] += 1
    return out


def mttkrp_fused_compact(gathered, val, lrow, bpart, *, kappa, rows_pp,
                         nblocks, block_p, pstart=None, work=None):
    """Compact EC over a pre-gathered ``(S, N-1, R)`` operand; returns
    ``out_rel (kappa*rows_pp, R)``. ``work`` as in
    :func:`mttkrp_fused_gather_compact` (derived from ``pstart`` or
    ``bpart``, with one sync, when not given)."""
    if val.device.type == "cpu":
        return mttkrp_fused_compact_plain(gathered, val, lrow, bpart,
                                          kappa=kappa, rows_pp=rows_pp,
                                          nblocks=nblocks, block_p=block_p)
    (out,) = _run(*pregathered_passes(
        gathered, val, lrow, kappa=kappa, rows_pp=rows_pp, nblocks=nblocks,
        block_p=block_p, pstart=pstart, bpart=bpart, work=work))
    LAUNCHES["mttkrp_fused_compact"] += 1
    return out


def mttkrp_fused_gather(val, lrow, lidx, factors, *, kappa, rows_pp,
                        blocks_pp, block_p, pstart=None, work=None):
    """Rect EC with each slot's factor rows (``lidx (N-1, S)``) gathered
    in the kernel; returns ``out_rel (kappa*rows_pp, R)``. ``work`` as in
    :func:`mttkrp_fused`."""
    if val.device.type == "cpu":
        return mttkrp_fused_gather_plain(val, lrow, lidx, factors,
                                         kappa=kappa, rows_pp=rows_pp,
                                         blocks_pp=blocks_pp,
                                         block_p=block_p)
    if pstart is None and work is None:
        pstart = rect_block_starts(kappa, blocks_pp, val.device)
    (out,) = _run(*gather_passes(
        val, lrow, lidx, factors, kappa=kappa, rows_pp=rows_pp,
        nblocks=kappa * blocks_pp, block_p=block_p, pstart=pstart,
        work=work))
    LAUNCHES["mttkrp_fused_gather"] += 1
    return out


def mttkrp_fused_remap(val, idx, alpha, lrow, lidx, factors, *, kappa,
                       rows_pp, blocks_pp, block_p, smax, next_mode,
                       pstart=None, work=None):
    """Rect EC + Alg. 3 remap in one pass; returns ``(out_rel, nval
    (smax,), nidx (smax, N), nalpha (smax, N))``. ``work`` as in
    :func:`mttkrp_fused`: a skipped block holds only pads, which the
    remap leaves in the pad-filled next layout."""
    if val.device.type == "cpu":
        return mttkrp_fused_remap_plain(
            val, idx, alpha, lrow, lidx, factors, kappa=kappa,
            rows_pp=rows_pp, blocks_pp=blocks_pp, block_p=block_p,
            smax=smax, next_mode=next_mode)
    if pstart is None and work is None:
        pstart = rect_block_starts(kappa, blocks_pp, val.device)
    outs = _run(*gather_passes(
        val, lrow, lidx, factors, kappa=kappa, rows_pp=rows_pp,
        nblocks=kappa * blocks_pp, block_p=block_p, pstart=pstart,
        work=work, remap=(idx, alpha, smax, next_mode)))
    LAUNCHES["mttkrp_fused_remap"] += 1
    return outs


def mttkrp_fused_gather_compact(val, lrow, upos, bpart, uidx, nuniq, factors,
                                *, kappa, rows_pp, nblocks, block_p,
                                pstart=None, work=None):
    """Compact EC with in-block row dedup; returns ``out_rel
    (kappa*rows_pp, R)``. On the card it runs the balanced kernels on
    ``work`` (a :class:`WorkTable` on the same device); called without
    one, it derives the table from ``pstart`` (or ``bpart``) with
    :func:`work_chunks` at :func:`default_cap`, which copies ``pstart``
    to the host once (a sync). ``engine.init`` builds the table once per
    mode, so the engine's path never syncs here."""
    if val.device.type == "cpu":
        return mttkrp_fused_gather_compact_plain(
            val, lrow, upos, bpart, uidx, nuniq, factors, kappa=kappa,
            rows_pp=rows_pp, nblocks=nblocks, block_p=block_p)
    (out,) = _run(*balanced_passes(
        val, lrow, upos, bpart, uidx, nuniq, factors, kappa=kappa,
        rows_pp=rows_pp, nblocks=nblocks, block_p=block_p, pstart=pstart,
        work=work))
    LAUNCHES["mttkrp_fused_gather_compact"] += 1
    return out


def mttkrp_fused_remap_compact(val, idx, alpha, lrow, upos, bpart, uidx,
                               nuniq, factors, *, kappa, rows_pp, nblocks,
                               block_p, smax, next_mode, pstart=None,
                               work=None):
    """Compact EC + Alg. 3 remap in one pass; returns ``(out_rel, nval
    (smax,), nidx (smax, N), nalpha (smax, N))``. ``work`` as in
    :func:`mttkrp_fused_gather_compact` (derived, with one sync, when not
    given)."""
    if val.device.type == "cpu":
        return mttkrp_fused_remap_compact_plain(
            val, idx, alpha, lrow, upos, bpart, uidx, nuniq, factors,
            kappa=kappa, rows_pp=rows_pp, nblocks=nblocks, block_p=block_p,
            smax=smax, next_mode=next_mode)
    outs = _run(*balanced_passes(
        val, lrow, upos, bpart, uidx, nuniq, factors, kappa=kappa,
        rows_pp=rows_pp, nblocks=nblocks, block_p=block_p, pstart=pstart,
        work=work, remap=(idx, alpha, smax, next_mode)))
    LAUNCHES["mttkrp_fused_remap_compact"] += 1
    return outs


__all__ = ["mttkrp_fused", "mttkrp_fused_compact", "mttkrp_fused_gather",
           "mttkrp_fused_remap", "mttkrp_fused_gather_compact",
           "mttkrp_fused_remap_compact", "mttkrp_fused_plain",
           "mttkrp_fused_compact_plain", "mttkrp_fused_gather_plain",
           "mttkrp_fused_remap_plain", "mttkrp_fused_gather_compact_plain",
           "mttkrp_fused_remap_compact_plain", "remap_plain", "block_starts",
           "rect_block_starts", "LAUNCHES", "reset_launch_counts",
           "WorkTable", "work_chunks", "work_from_chunks", "rect_work",
           "rect_cap",
           "check_work", "check_covers", "checked_for", "split_ranges",
           "split_partitions", "default_cap", "chunked_plain",
           "chunked_plain_pregathered", "chunked_plain_gather",
           "balanced_smem_bytes", "gather_smem_bytes",
           "pregathered_smem_bytes", "balanced_passes", "gather_passes",
           "pregathered_passes", "SMEM_PER_BLOCK", "H100_SMS"]
